"""ArcFace training for the embedders, in PyTorch.

The counterpart of ``train/arcface.py`` in the JAX package (the reference
defines the ArcFace head, ``modules/mobile_facenet/mobile_facenet.py:160-201``,
but never trains it). An embedder slot (``mobile_facenet``, ``facenet``,
``facenet-512`` or ``reid-mnv2``) trains in train mode, its BatchNorms in
flax's form, under a class kernel [D, C] drawn uniform(-1, 1): the loss is
the softmax cross-entropy of ``models.mobile_facenet.arcface_logits``, plus,
with ``center_gain`` > 0, the mean squared distance of each embedding from
its class's batch mean (the means carry no gradient).

The optimizer is ``torch.optim.SGD`` (momentum, dampening 0) over two
groups, as optax's ``add_decayed_weights(mask=decay_mask)`` + ``sgd`` split
the flax tree by its leaf names: convolution and Dense kernels and the
class kernel decay; biases, BatchNorm scales and shifts and PReLU's slopes
do not. The step runs in ``train.detection.train_precision`` (f32, TF32
off on the card).

A train state is a dict: ``net`` (train mode), ``arcface_kernel`` (a
parameter on the device), ``opt``, ``cfg`` and ``device``.

Over a device mesh (``shard_train_state``, ``sharded_train_step``) the
embedder is data-parallel over "data" and the class kernel is split by
classes over "model": each coordinate holds a replica of the net and its
class shard [D, C / S] with its momentum. The step is the JAX package's
global step: the BatchNorms normalize with the whole batch's statistics,
every coordinate gathers the whole batch's embeddings, the softmax over
classes takes its max and sum of exponentials across the class shards and
the label's logit from the shard that holds it, and the gradients flow
back through those reductions (``parallel.collectives``) before each
replicated tensor's gradient is summed over its copies
(``parallel.training``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.mobile_facenet import arcface_logits
from ..ops.platform import resolve_device
from .detection import decay_groups, flax_init_, train_precision

KERNEL = "arcface_kernel"  # the class kernel's name in a state and its copies


@dataclasses.dataclass
class ArcFaceTrainConfig:
    num_classes: int = 512
    embedding_size: int = 512
    s: float = 64.0
    m: float = 0.5
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # "mobile_facenet" (112 px), "facenet" / "facenet-512"
    # (InceptionResNetV1, 160 px) or "reid-mnv2" (128 px)
    embedder: str = "mobile_facenet"
    # center-loss weight: pulls embeddings toward their batch class mean,
    # the statistic the similar-face filter thresholds
    center_gain: float = 0.0


def build_embedder(cfg: ArcFaceTrainConfig) -> nn.Module:
    """The slot's net at ``cfg.embedding_size``: 112 px MobileFaceNet,
    160 px InceptionResNetV1 or 128 px MobileNetV2."""
    if cfg.embedder in ("facenet", "facenet-512"):
        from ..models.facenet import InceptionResNetV1

        return InceptionResNetV1(cfg.embedding_size)
    if cfg.embedder == "reid-mnv2":
        from ..models.embedders import MobileNetV2Embedder

        return MobileNetV2Embedder(cfg.embedding_size)
    from ..models.mobile_facenet import MobileFaceNet

    return MobileFaceNet(cfg.embedding_size)


def create_train_state(cfg: ArcFaceTrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, Any]:
    """The net with flax's initialization and the class kernel, both drawn
    from ``generator`` (seed 0 by default), on ``device`` (the card unless
    the caller passes the CPU), and SGD with the masked decay."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    net = build_embedder(cfg)
    flax_init_(net, gen)
    kernel = torch.rand((cfg.embedding_size, cfg.num_classes),
                        generator=gen) * 2.0 - 1.0
    net = net.to(device=device, memory_format=torch.channels_last).train()
    kernel = nn.Parameter(kernel.to(device))
    groups = decay_groups(net, cfg.weight_decay)
    groups[0]["params"].append(kernel)
    opt = torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                          dampening=0.0)
    return {"net": net, "arcface_kernel": kernel, "opt": opt, "cfg": cfg,
            "device": device}


def arcface_loss(state: Dict[str, Any], images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """The mean ArcFace cross-entropy of a batch (normalized NHWC crops,
    integer labels), plus the center term; moves the BatchNorm
    statistics (the net is in train mode)."""
    cfg: ArcFaceTrainConfig = state["cfg"]
    emb = state["net"](images)
    logits = arcface_logits(emb, labels, state["arcface_kernel"], s=cfg.s,
                            m=cfg.m)
    loss = F.cross_entropy(logits, labels.long())
    return loss + center_term(cfg, emb, labels, logits.dtype)


def center_term(cfg: ArcFaceTrainConfig, emb: torch.Tensor,
                labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``center_gain`` times the mean squared distance of each embedding
    from its class's batch mean (the means carry no gradient); 0 without
    the term."""
    if cfg.center_gain <= 0.0:
        return torch.zeros((), dtype=dtype, device=emb.device)
    emb = emb.to(dtype)
    onehot = F.one_hot(labels.long(), cfg.num_classes).to(emb.dtype)
    counts = torch.clamp(onehot.sum(0), min=1.0)
    centers = ((onehot.T @ emb) / counts[:, None]).detach()
    d2 = torch.sum((emb - centers[labels.long()]) ** 2, -1)
    return cfg.center_gain * d2.mean()


def make_train_step(state: Dict[str, Any]):
    """``step(images, labels) -> loss``: one SGD update of the net and the
    class kernel in place, in ``train_precision``; the loss stays on the
    device."""
    opt = state["opt"]

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with train_precision(state["device"]):
            loss = arcface_loss(state, images, labels)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return loss.detach()

    return step


def shard_train_state(state: Dict[str, Any], mesh
                      ) -> Dict[Any, Dict[str, Any]]:
    """DP + TP placement over ``mesh`` (axes "data" and "model"): ``{coord:
    replica}`` for the coordinates this process holds. A replica holds the
    net (replicated: the first coordinate takes ``state["net"]`` itself
    when it is on that device, the others a copy), its class shard of the
    kernel, ``[D, C / S]`` for its place on "model" (C must divide S), an
    SGD over both with ``state["opt"]``'s groups and hyperparameters, and
    the momentum: each parameter's copied, matched by name (the kernel by
    its place in the state, not by shape, so a square embedder weight that
    shares the kernel's shape stays whole), the kernel's split by classes
    like the kernel."""
    from ..parallel.mesh import same_device
    from ..parallel.training import replica_optimizer

    kernel = state[KERNEL]
    d, c = kernel.shape
    s = mesh.shape.get("model", 1)
    if c % s:
        raise ValueError(f"{c} classes do not split over {s} model shards")
    cs = c // s
    names = {id(p): n for n, p in state["net"].named_parameters()}
    names[id(kernel)] = KERNEL
    out = {}
    for i, coord in enumerate(mesh.local_coords()):
        dev = mesh.device(coord)
        j = mesh.index(coord, "model") if "model" in mesh.shape else 0
        net = state["net"] if i == 0 and same_device(
            dev, state["device"]) else copy.deepcopy(state["net"]).to(dev)
        shard = nn.Parameter(kernel.detach()[:, j * cs:(j + 1) * cs]
                             .clone().to(dev))
        params = dict(net.named_parameters())
        params[KERNEL] = shard
        opt = replica_optimizer(state["opt"], names, params, dev)
        mom = opt.state.get(shard, {}).get("momentum_buffer")
        if mom is not None:
            opt.state[shard]["momentum_buffer"] = \
                mom[:, j * cs:(j + 1) * cs].clone()
        out[coord] = {"net": net, KERNEL: shard, "opt": opt,
                      "cfg": state["cfg"], "device": dev, "col0": j * cs}
    return out


def sharded_loss(rep: Dict[str, Any], images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Inside a shard of ``sharded_train_step``: the whole batch's ArcFace
    loss from one coordinate's piece of the images (``labels``: the whole
    batch's). The embeddings are gathered over "data"; the log-softmax's
    max (no gradient) and sum of exponentials are reduced over "model",
    and the label's logit comes from the shard that holds its class."""
    from ..parallel import collectives as C

    cfg: ArcFaceTrainConfig = rep["cfg"]
    emb = C.all_gather_cat(rep["net"](images), "data")
    kernel = rep[KERNEL]
    logits = arcface_logits(emb, labels, kernel, s=cfg.s, m=cfg.m,
                            col0=rep["col0"])
    top = C.all_reduce(logits.detach().amax(1), "model", "max")
    sumexp = C.all_reduce(torch.exp(logits - top[:, None]).sum(1), "model")
    cols = torch.arange(rep["col0"], rep["col0"] + kernel.shape[1],
                        device=logits.device)
    own = (labels.long()[:, None] == cols).to(logits.dtype)
    label_logit = C.all_reduce((logits * own).sum(1), "model")
    loss = (torch.log(sumexp) + top - label_logit).mean()
    return loss + center_term(cfg, emb, labels, logits.dtype)


def sharded_train_step(state: Dict[str, Any], mesh):
    """``(step, replicas)``: the DP + TP step over ``mesh`` and the
    placement of ``shard_train_state``. ``step(images, labels) -> loss``
    takes the whole batch (B divides the "data" axis; host arrays or
    tensors), splits the images over "data", runs every replica in
    lockstep and updates each in place: the net's gradient summed over
    the whole mesh, a kernel shard's over "data". The loss (the whole
    batch's) is the first coordinate's, on its device."""
    from ..models.layers import global_batch
    from ..parallel import collectives as C
    from ..parallel.sharding import (batch_sharding, put_global,
                                     replicate_to_mesh)
    from ..parallel.training import reduce_grads, spmd_backward

    replicas = shard_train_state(state, mesh)
    first = mesh.local_coords()[0]
    shards = mesh.shape["data"]
    axes = mesh.axis_names

    def shard(coord, x, y):
        rep = replicas[coord]
        rep["opt"].zero_grad(set_to_none=True)
        with global_batch(C.reduce_batch("data"), shards):
            loss = sharded_loss(rep, x[coord], y[coord])
        spmd_backward(loss)
        reduce_grads(list(rep["net"].parameters()), axes)
        reduce_grads([rep[KERNEL]], "data")
        rep["opt"].step()
        return loss.detach()

    def step(images, labels) -> torch.Tensor:
        x = put_global(torch.as_tensor(images), batch_sharding(mesh))
        y = replicate_to_mesh(torch.as_tensor(labels), mesh)
        with train_precision(mesh.device(first)):
            return C.run_spmd(mesh, lambda c: shard(c, x, y))[first]

    return step, replicas


def gather_train_state(replicas: Dict[Any, Dict[str, Any]], mesh
                       ) -> Dict[str, torch.Tensor]:
    """The whole state of a sharded run, on the first coordinate's device:
    ``net`` (the first replica's state dict), ``arcface_kernel`` [D, C]
    and ``kernel_momentum`` (None before the first step), the shards
    joined over "model"."""
    from ..parallel import collectives as C

    first = mesh.local_coords()[0]

    def join(coord):
        rep = replicas[coord]
        with torch.no_grad():
            kernel = torch.cat(C.all_gather(rep[KERNEL].detach(), "model"),
                               1)
            mom = rep["opt"].state.get(rep[KERNEL], {}).get(
                "momentum_buffer")
            if mom is not None:
                mom = torch.cat(C.all_gather(mom, "model"), 1)
        return kernel, mom

    kernel, mom = C.run_spmd(mesh, join)[first]
    return {"net": replicas[first]["net"].state_dict(), KERNEL: kernel,
            "kernel_momentum": mom}
