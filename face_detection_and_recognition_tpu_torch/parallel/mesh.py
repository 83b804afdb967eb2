"""Device meshes: a grid of torch devices with named axes.

The counterpart of ``parallel/mesh.py`` in the JAX package, where a mesh was
a ``jax.sharding.Mesh`` over TPU chips: the "data" axis carries frames,
crops or examples, an optional "model" axis the class-sharded ArcFace
kernel and the row-sharded gallery.

A port mesh is one of two kinds:

- single-process: every entry is a device of this process. A device may
  repeat, and the repetition is the caller's, written out in ``devices=``:
  eight ``"cpu"`` entries stand where the JAX tests had eight virtual CPU
  devices, and two or four ``"cuda:0"`` entries run the shard-and-merge
  code, kernels included, on one card. The shards of a step run in one
  thread each, in lockstep at each collective (``parallel.collectives``);
- multi-process: one device per rank, over a ``torch.distributed`` process
  group (``init_distributed``: NCCL between cards, gloo on the CPU). Each
  rank holds its own entry; a process group for each set of axes carries
  the collectives.

JAX's ``local_cpu_devices`` (several virtual devices in each process of a
multi-process mesh) has no torch counterpart: a rank owns one device.
"""
from __future__ import annotations

import datetime
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.platform import resolve_device

Coord = Tuple[int, ...]
Axes = Union[str, Sequence[str]]

# the device init_distributed gave this process's rank
_RANK_DEVICE: Dict[str, torch.device] = {}


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    return canonical_device(a) == canonical_device(b)


class Mesh:
    """Devices on a grid with named axes.

    devices: object array of ``torch.device`` whose shape is the axis
    sizes; axis_names: one name an axis; groups: for a multi-process mesh,
    the process group of each set of axes (keyed by the sorted tuple of
    their names) that holds this rank; rank: this process's rank, None on
    a single-process mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 rank: Optional[int] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        # {axis: size}, as jax's Mesh.shape
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._groups = groups or {}
        self.rank = rank

    def __repr__(self) -> str:
        kind = "single-process" if self.rank is None else f"rank {self.rank}"
        return f"Mesh({self.shape}, {kind})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    def axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple in the mesh's axis order; unknown names
        raise ``KeyError``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r}: {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def local_coords(self) -> List[Coord]:
        """The coordinates this process runs: all of them on a
        single-process mesh, its rank's on a multi-process one."""
        shape = self.devices.shape
        if self.rank is None:
            return [tuple(int(i) for i in c) for c in np.ndindex(*shape)]
        return [tuple(int(i) for i in np.unravel_index(self.rank, shape))]

    def device(self, coord: Coord) -> torch.device:
        return self.devices[coord]

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(axes)]))

    def group_coords(self, coord: Coord, axes: Axes) -> List[Coord]:
        """The coordinates that share ``coord``'s place on every other
        axis, in row-major order over ``axes``: the members of a collective
        over ``axes``."""
        names = self.axes(axes)
        ranges = [range(self.shape[a]) if a in names else (coord[i],)
                  for i, a in enumerate(self.axis_names)]
        return [tuple(c) for c in itertools.product(*ranges)]

    def index(self, coord: Coord, axes: Axes) -> int:
        """``coord``'s position in its group over ``axes``."""
        return self.group_coords(coord, axes).index(tuple(coord))

    def group(self, axes: Axes):
        """The process group of ``axes`` that holds this rank."""
        return self._groups[self.axes(axes)]


def _axis_subsets(axes: Sequence[str]) -> Iterable[Tuple[str, ...]]:
    for r in range(1, len(axes) + 1):
        yield from itertools.combinations(axes, r)


def _process_groups(shape: Tuple[int, ...], axes: Tuple[str, ...],
                    rank: int) -> Dict[Tuple[str, ...], object]:
    """A process group for every set of axes and every place on the other
    axes. ``new_group`` is collective: every rank makes every group, in
    the same order, and keeps those that hold it."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    mine = {}
    for subset in _axis_subsets(axes):
        moved = [axes.index(a) for a in subset]
        rest = [i for i in range(len(axes)) if i not in moved]
        blocks = np.transpose(ranks, rest + moved).reshape(
            -1, int(np.prod([shape[i] for i in moved])))
        for block in blocks:
            g = dist.new_group([int(r) for r in block])
            if rank in block:
                mine[subset] = g
    return mine


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh over ``devices``.

    axes: axis names, e.g. ("data",) or ("data", "model"); shape: the axis
    sizes (default: every device on the first axis, 1 on the rest);
    devices: the mesh's entries in row-major order. Without
    ``torch.distributed`` running, the default is every CUDA card (none
    raises: a CPU mesh is asked for by name, ``["cpu"] * n``), and an
    entry may repeat. With it running (``init_distributed``), the mesh
    spans the ranks, one device each: the default is the rank's device,
    and ``devices``, when given, holds one entry a rank. A shape whose
    product is not the device count raises ``ValueError``."""
    axes = tuple(axes)
    multi = dist.is_available() and dist.is_initialized()
    if multi:
        world = dist.get_world_size()
        own = _RANK_DEVICE.get("device")
        if devices is None:
            if own is None:
                raise RuntimeError("torch.distributed was not started by "
                                   "init_distributed: pass devices=")
            devices = [own] * world
        if len(devices) != world:
            raise ValueError(f"a mesh over processes takes one device a "
                             f"rank: {len(devices)} devices, world size "
                             f"{world}")
    elif devices is None:
        resolve_device(None)  # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    for d in devices:
        resolve_device(d)
    devices = [canonical_device(d) for d in devices]
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    arr = arr.reshape(shape)
    if not multi:
        return Mesh(arr, axes)
    rank = dist.get_rank()
    return Mesh(arr, axes, _process_groups(shape, axes, rank), rank)


def mesh_devices(device: Optional[Union[str, torch.device]] = None
                 ) -> List[torch.device]:
    """The entries of a CLI's ``--mesh``, the JAX ``jax.devices()``: every
    card (``device`` None or "cuda"), or the one ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_cpu_devices: Optional[int] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     timeout_s: float = 600.0) -> Optional[torch.device]:
    """Join a multi-process job: ``torch.distributed`` over
    ``tcp://coordinator`` (``host:port``) with ``num_processes`` ranks,
    this one ``process_id``. No-op (returns None) when ``num_processes`` is
    None; one process still forms a group of one, whose collectives run
    as a larger group's would.

    device: the rank's device, the card unless ``"cpu"``; a card rank
    takes card ``process_id % count`` and NCCL, a CPU rank gloo. Returns
    the device. ``local_cpu_devices`` above 1 raises ``ValueError``: JAX's
    virtual CPU devices have no torch counterpart (a single-process mesh
    of repeated ``"cpu"`` entries stands in for them)."""
    if local_cpu_devices is not None and local_cpu_devices > 1:
        raise ValueError("local_cpu_devices > 1: a rank owns one device; "
                         "use a single-process mesh of repeated 'cpu' "
                         "entries for several devices in one process")
    if num_processes is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator or 'localhost:29500'}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE["device"] = dev
    return dev


def shutdown_distributed() -> None:
    """Leave the job ``init_distributed`` joined (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE.clear()
