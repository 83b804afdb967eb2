"""Training over a device mesh: replicas, one backward, summed gradients.

The JAX package jitted a train step with its batch sharded over "data" and
let XLA partition it: one global program, so every BatchNorm normalized
with the whole batch's statistics, the loss was the whole batch's, and the
gradients of replicated parameters were psum'd. Here each coordinate of the
mesh holds a replica of the train state and runs the family's own step on
its piece of the batch, inside ``collectives.run_spmd``:

- the BatchNorms reduce their sums over "data" (``models.layers.
  global_batch``), forward and backward;
- the replica's net gathers its outputs whole over "data"
  (``gather_outputs``, differentiable), and the step computes the loss on
  them and on the whole batch's targets: every coordinate holds the global
  loss, whatever normalizers it has;
- ``spmd_backward`` takes one backward of the mean of those losses over
  the mesh: across processes each rank backs its own, through the
  collectives' gradients; within a process one thread backs the sum of
  its shards' losses, which are joined through the exchanged tensors;
- ``reduce_grads`` sums each parameter's gradient over the coordinates
  that hold a copy of it, and every replica takes the same update.

A family step routes its backward through ``train.detection.
optimizer_step``, which calls the two functions above when it runs inside
a shard; ``data_parallel_step`` wraps any such step.
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Callable, Dict, Sequence

import torch
from torch import nn

from ..models.layers import global_batch
from . import collectives as C
from .mesh import Axes, Coord, Mesh, same_device
from .sharding import batch_sharding, put_global, replicate_to_mesh

_gather = threading.local()


def spmd_backward(loss: torch.Tensor) -> None:
    """Inside a shard: backward of the mean over the whole mesh of every
    coordinate's ``loss`` (each holds the same global loss, so the mean's
    gradient at each replica is that replica's share of the true one)."""
    s = C.current()
    mesh = s.mesh
    if s.exchange is None:
        (loss / mesh.size).backward()
        return
    losses = s.exchange.swap(s.coord, loss)
    coords = mesh.local_coords()
    if s.coord == coords[0]:
        total = C.sum_across([losses[c] for c in coords], loss.device)
        (total / mesh.size).backward()
    s.exchange.barrier.wait()  # the others wait for the one backward


@torch.no_grad()
def reduce_grads(params: Sequence[torch.Tensor], axes: Axes) -> None:
    """Inside a shard: each parameter's gradient becomes the sum, in group
    order, of its copies' gradients over ``axes`` (a missing gradient
    counts as zero), one flat exchange for all of them."""
    params = [p for p in params if p.requires_grad]
    if not params or C.current().mesh.axis_size(axes) == 1:
        return
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1) for p in params])
    total = C.all_reduce(flat, axes)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = total[offset:offset + n].view_as(p).clone()
        offset += n


def _gather_hook(module, inputs, output):
    """Forward hook: inside a shard of ``data_parallel_step``, the net's
    outputs (dim 0 the batch) are gathered whole over "data"."""
    if getattr(_gather, "on", False) and C.in_spmd():
        return C.gather_batch(output, "data")
    return output


def gather_outputs(net: nn.Module) -> nn.Module:
    """Hook ``net`` so that inside ``data_parallel_step`` its forward
    returns the whole batch's outputs (once a net; outside a step the hook
    passes the outputs as they are)."""
    if not getattr(net, "_gathers_outputs", False):
        net.register_forward_hook(_gather_hook)
        net._gathers_outputs = True
    return net


def replica_optimizer(opt: torch.optim.Optimizer,
                      names: Dict[int, str],
                      params: Dict[str, torch.Tensor],
                      device: torch.device) -> torch.optim.Optimizer:
    """``opt`` rebuilt over a replica's parameters, matched by name
    (``names``: id of an old parameter -> its name; ``params``: name -> the
    replica's parameter): the same class, groups and hyperparameters, its
    per-parameter state (momentum) copied to ``device``."""
    groups = [{**g, "params": [params[names[id(p)]] for p in g["params"]]}
              for g in opt.param_groups]
    new = type(opt)(groups, **opt.defaults)
    for g in opt.param_groups:
        for p in g["params"]:
            st = opt.state.get(p)
            if st:
                new.state[params[names[id(p)]]] = {
                    k: v.detach().clone().to(device)
                    if isinstance(v, torch.Tensor) else copy.deepcopy(v)
                    for k, v in st.items()}
    return new


def replicate_state(state: Dict[str, Any], mesh: Mesh
                    ) -> Dict[Coord, Dict[str, Any]]:
    """A family train state (``train.detection.new_state``'s dict) on every
    coordinate this process holds: the first takes ``state`` itself when
    it is on that device (it trains in place); the others a copy of the
    net, the EMA copy and the counters on their device, and the optimizer
    rebuilt over the copy (``replica_optimizer``). Every net is hooked by
    ``gather_outputs``."""
    coords = mesh.local_coords()
    names = {id(p): n for n, p in state["net"].named_parameters()}
    out = {}
    for i, coord in enumerate(coords):
        dev = mesh.device(coord)
        if i == 0 and same_device(dev, state["device"]):
            rep = state
        else:
            rep = {k: (v.detach().clone().to(dev)
                       if isinstance(v, torch.Tensor) else v)
                   for k, v in state.items()}
            rep["net"] = copy.deepcopy(state["net"]).to(dev)
            if state.get("ema") is not None:
                rep["ema"] = copy.deepcopy(state["ema"]).to(dev)
            rep["device"] = dev
            rep["opt"] = replica_optimizer(
                state["opt"], names, dict(rep["net"].named_parameters()),
                dev)
        gather_outputs(rep["net"])
        out[coord] = rep
    return out


def data_parallel_step(state: Dict[str, Any],
                       make_step: Callable[[Dict[str, Any]], Callable],
                       mesh: Mesh):
    """A family step made data-parallel over ``mesh``: returns ``(step,
    replicas)``. ``make_step(replica)`` is the family's step on one
    replica (``train.detection.make_det_train_step``, ``make_det_train_
    step_ema``, the SSD / BlazeFace / res10 steps); ``step(images, targets,
    valid)`` takes the whole batch (B divides the "data" axis), splits the
    images over "data", gives every coordinate the whole targets, runs the
    replicas' steps in lockstep, and returns the first coordinate's (loss,
    metrics) on its device: the whole batch's, equal on every coordinate.
    ``step.replicas`` are the replicas, ``state`` (trained in place) the
    first when it is on that device."""
    from ..train.detection import train_precision

    replicas = replicate_state(state, mesh)
    steps = {c: make_step(rep) for c, rep in replicas.items()}
    first = mesh.local_coords()[0]
    shards = mesh.shape["data"]

    def step(images, targets, valid):
        x = put_global(images, batch_sharding(mesh))
        tv = replicate_to_mesh((targets, valid), mesh)

        def shard(coord):
            _gather.on = True
            try:
                with global_batch(C.reduce_batch("data"), shards):
                    return steps[coord](x[coord], *tv[coord])
            finally:
                _gather.on = False

        with train_precision(mesh.device(first)):
            return C.run_spmd(mesh, shard)[first]

    step.replicas = replicas
    return step, replicas

