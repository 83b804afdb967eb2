"""SPMD runs over a mesh and the collectives inside them.

``run_spmd(mesh, fn)`` calls ``fn(coord)`` for each coordinate the process
holds: on a multi-process mesh its rank's one, in the calling thread; on a
single-process mesh every coordinate, each in a thread of its own, so that
the shards meet at each collective as the devices of one XLA program do.
Inside ``fn``, ``all_gather`` / ``all_reduce`` over a set of axes exchange
tensors with the other members of the coordinate's group:

- across processes through ``torch.distributed`` (differentiable, via
  ``torch.distributed.nn``, when the tensor carries a gradient);
- across the threads of one process through a barrier: each thread gets
  the others' tensors themselves, so autograd follows them, and one
  backward over the shards' losses takes every cross-shard path (a
  backward running per thread would meet the shared nodes twice).

Every reduction is a gather followed by the same ordered reduction on every
member, so a replicated result is the same bits everywhere.

Each shard runs with its coordinate's card as the thread's current CUDA
device (the runtime keeps the current device per thread, and the
hand-written kernels launch on the current device's streams) and with the
caller's count of intra-op CPU threads (OpenMP keeps that count per
thread too, and a thread made earlier would keep the count of its day).
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Axes, Coord, Mesh

_state = threading.local()

# seconds a shard waits at a collective for the others before the run fails
BARRIER_TIMEOUT_S = 1800.0


class _Exchange:
    """The meeting point of one process's shard threads: at each
    collective every thread leaves its tensor in ``slots`` and waits for
    all; a second wait keeps the slots until every thread has read them."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=BARRIER_TIMEOUT_S)
        self.slots: Dict[Coord, Any] = {}

    def swap(self, coord: Coord, value: Any) -> Dict[Coord, Any]:
        self.slots[coord] = value
        self.barrier.wait()
        snapshot = dict(self.slots)
        self.barrier.wait()
        return snapshot


class _Shard:
    def __init__(self, mesh: Mesh, coord: Coord,
                 exchange: Optional[_Exchange]):
        self.mesh, self.coord, self.exchange = mesh, coord, exchange


def current() -> _Shard:
    """The shard the calling thread runs; outside ``run_spmd`` raises."""
    shard = getattr(_state, "shard", None)
    if shard is None:
        raise RuntimeError("a collective outside run_spmd")
    return shard


def in_spmd() -> bool:
    return getattr(_state, "shard", None) is not None


class _Workers:
    """Long-lived threads, one a coordinate index, that run the shards of
    every ``run_spmd`` call over that many local coordinates: a shard
    always runs in the same thread, so per-thread state (PyTorch's cuDNN
    handles and plans) is built once, not at every call."""

    def __init__(self, n: int):
        self.lock = threading.Lock()  # one call at a time holds the workers
        self.queues = [queue.SimpleQueue() for _ in range(n)]
        for i, q in enumerate(self.queues):
            threading.Thread(target=self._loop, args=(q,), daemon=True,
                             name=f"spmd-worker-{i}").start()

    @staticmethod
    def _loop(q):
        while True:
            job, done = q.get()
            job()
            done.set()

    def run(self, jobs: Sequence[Callable[[], None]]) -> None:
        events = [threading.Event() for _ in jobs]
        with self.lock:
            for q, job, ev in zip(self.queues, jobs, events):
                q.put((job, ev))
            for ev in events:
                ev.wait()


_workers: Dict[int, _Workers] = {}
_workers_lock = threading.Lock()


def device_guard(device: torch.device):
    """``device`` as the calling thread's current CUDA device for the
    block (nothing for a CPU device)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def run_spmd(mesh: Mesh, fn: Callable[[Coord], Any]) -> Dict[Coord, Any]:
    """``{coord: fn(coord)}`` over the process's coordinates, as above. An
    exception in one shard breaks the others' waits and is raised here.
    Several local coordinates run on long-lived worker threads (a nested
    call, from inside a shard, on threads of its own)."""
    coords = mesh.local_coords()
    exchange = _Exchange(len(coords)) if len(coords) > 1 else None
    out: Dict[Coord, Any] = {}
    errors: List[BaseException] = []
    cpu_threads = torch.get_num_threads()

    def shard(coord):
        prev = getattr(_state, "shard", None)
        _state.shard = _Shard(mesh, coord, exchange)
        if torch.get_num_threads() != cpu_threads:
            torch.set_num_threads(cpu_threads)
        try:
            with device_guard(mesh.device(coord)):
                out[coord] = fn(coord)
        except BaseException as e:  # noqa: B902 - re-raised by the caller
            errors.append(e)
            if exchange is not None:
                exchange.barrier.abort()
        finally:
            _state.shard = prev

    if exchange is None:
        shard(coords[0])
    elif in_spmd():
        threads = [threading.Thread(target=shard, args=(c,))
                   for c in coords]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        with _workers_lock:
            workers = _workers.setdefault(len(coords),
                                          _Workers(len(coords)))
        workers.run([lambda c=c: shard(c) for c in coords])
    if errors:
        # the first real fault, not a broken barrier it caused elsewhere
        errors.sort(key=lambda e: isinstance(e, threading.BrokenBarrierError))
        raise errors[0]
    return out


def axis_index(axes: Axes) -> int:
    """The calling shard's position along ``axes``."""
    s = current()
    return s.mesh.index(s.coord, axes)


def axis_size(axes: Axes) -> int:
    return current().mesh.axis_size(axes)


def all_gather(t: torch.Tensor, axes: Axes) -> List[torch.Tensor]:
    """The group's tensors over ``axes``, in group order, each on ``t``'s
    device; same shapes on every member. Differentiable."""
    s = current()
    mesh = s.mesh
    members = mesh.group_coords(s.coord, axes)
    if len(members) == 1:
        return [t]
    if mesh.distributed:
        group = mesh.group(axes)
        if torch.is_grad_enabled() and t.requires_grad:
            from torch.distributed.nn import functional as dfn

            return list(dfn.all_gather(t, group=group))
        if t.dtype == torch.bool:  # not every backend carries bool
            return [p.bool() for p in all_gather(t.to(torch.uint8), axes)]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in members]
        dist.all_gather(out, t, group=group)
        return out
    slots = s.exchange.swap(s.coord, t)
    return [slots[c].to(t.device) for c in members]


def all_reduce(t: torch.Tensor, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (``op="sum"``) or max (``"max"``) of the group's tensors over
    ``axes``, reduced in group order on every member. Differentiable."""
    parts = all_gather(t, axes)
    if len(parts) == 1:
        return t
    stacked = torch.stack(parts)
    if op == "sum":
        return stacked.sum(0)
    if op == "max":
        return stacked.amax(0)
    raise ValueError(f"all_reduce: op {op!r} is not 'sum' or 'max'")


def all_gather_cat(t: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The group's tensors over ``axes`` concatenated along dim 0: a
    batch split over ``axes`` made whole on every member."""
    parts = all_gather(t, axes)
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` on every tensor of a tree of dataclasses, tuples, lists and
    dicts; other leaves (None, numbers) pass as they are."""
    import dataclasses

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def gather_batch(tree: Any, axes: Axes = "data") -> Any:
    """Every tensor of ``tree`` (dim 0 a shard of the batch) made whole
    over ``axes``: ``all_gather_cat`` leaf by leaf."""
    return tree_map(lambda t: all_gather_cat(t, axes), tree)


def reduce_batch(axes: Axes = "data") -> Callable[[torch.Tensor, str],
                                                  torch.Tensor]:
    """``(t, op) -> all_reduce(t, axes, op)``: the reduction that the
    layers' global-batch hook (``models.layers.global_batch``) takes."""
    return lambda t, op: all_reduce(t, axes, op)


def sum_across(tensors: Sequence[torch.Tensor], device: torch.device
               ) -> torch.Tensor:
    """The ordered sum of tensors from several shards, on ``device``."""
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total
