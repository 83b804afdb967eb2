"""Sharding rules: data-parallel inference and the sharded gallery search.

The counterpart of ``parallel/sharding.py`` in the JAX package, where
sharding annotations made XLA insert the collectives. Here the split and the
exchange are written out: a batch's dim 0 splits over the "data" axis into
one piece a coordinate (``put_global``), parameters are copied to every
device of the mesh (``replicate_to_mesh``), a reference matrix splits its
rows over "model", and ``topk_gallery_sharded`` merges per-shard top-k
lists gathered over the axis.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import collectives as C
from .mesh import Coord, Mesh, same_device


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Dim 0 split over ``axis`` of ``mesh`` (replicated over the other
    axes), or replicated everywhere when ``axis`` is None."""

    mesh: Mesh
    axis: Optional[str] = "data"

    def parts(self) -> int:
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    def index(self, coord: Coord) -> int:
        return 0 if self.axis is None else self.mesh.index(coord, self.axis)


@dataclasses.dataclass
class Sharded:
    """A global array placed on a mesh: the pieces this process holds, by
    coordinate, each on its coordinate's device."""

    shards: Dict[Coord, torch.Tensor]
    sharding: Sharding

    def __getitem__(self, coord: Coord) -> torch.Tensor:
        return self.shards[coord]


def batch_sharding(mesh: Mesh, ndim: int = None, axis: str = "data"
                   ) -> Sharding:
    """Dim 0 over ``axis``, the rest replicated (``ndim`` is the JAX
    signature's and changes nothing)."""
    return Sharding(mesh, axis)


def put_global(array: Any, sharding: Sharding) -> Sharded:
    """Place a global array: each coordinate this process holds takes its
    piece of dim 0 (the whole array when replicated) on its device. On a
    multi-process mesh every process passes the same global array and
    keeps its own piece, as JAX's ``make_array_from_callback`` feeds one.
    Dim 0 must divide the axis."""
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(array))
    n = sharding.parts()
    if t.shape[0] % n:
        raise ValueError(f"dim 0 of size {t.shape[0]} does not divide over "
                         f"{n} shards of axis {sharding.axis!r}")
    size = t.shape[0] // n
    mesh = sharding.mesh
    shards = {}
    for coord in mesh.local_coords():
        i = sharding.index(coord)
        shards[coord] = t[i * size:(i + 1) * size].to(mesh.device(coord))
    return Sharded(shards, sharding)


def replicate_to_mesh(tree: Any, mesh: Mesh) -> Dict[Coord, Any]:
    """``{coord: tree on coord's device}``, for the coordinates this
    process holds, for read-only use (inference, the search): a
    coordinate on the tree's own device takes the tree itself; elsewhere
    tensors are copied leaf by leaf (``collectives.tree_map``) and an
    ``nn.Module`` is deep-copied and moved. Training replicas are made by
    ``parallel.training.replicate_state``."""
    out = {}
    for coord in mesh.local_coords():
        dev = mesh.device(coord)
        if isinstance(tree, torch.nn.Module):
            own = next(iter(tree.parameters()), None)
            out[coord] = tree if own is None or same_device(
                own.device, dev) else copy.deepcopy(tree).to(dev)
        else:
            out[coord] = C.tree_map(
                lambda t: t if t.device == dev else t.to(dev, copy=True),
                tree)
    return out


def data_parallel(fn: Callable, mesh: Mesh, axis: str = "data"
                  ) -> Callable:
    """Wrap ``fn(variables, batch, *args)`` so that the batch splits over
    the mesh's ``axis`` and the variables are replicated; the outputs
    (dim 0 the batch) come back whole, on the first coordinate's device.
    The batch must divide the axis size."""

    def wrapped(variables, batch, *args):
        placed = replicate_to_mesh(variables, mesh)
        pieces = put_global(batch, batch_sharding(mesh, axis=axis))

        def shard(coord):
            return C.gather_batch(fn(placed[coord], pieces[coord], *args),
                                  axis)

        return C.run_spmd(mesh, shard)[mesh.local_coords()[0]]

    return wrapped


def shard_reference_matrix(refs: Any, mesh: Mesh, axis: str = "model"
                           ) -> Sharded:
    """An [M, D] reference-embedding matrix with its rows split over
    ``axis`` (M must divide it)."""
    return put_global(torch.as_tensor(np.asarray(refs, np.float32)),
                      Sharding(mesh, axis))


def _stable_topk(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, equal scores in position order."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def topk_gallery_sharded(queries: Any, gallery: Any, mesh: Mesh, k: int = 5,
                         axis: str = "model", use_pallas: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inner-product top-k of [N, D] queries over an [M, D] gallery whose
    rows split over ``axis``: each shard scores its rows, keeps a local
    top-k with global indices, the shards exchange only their [N, k']
    candidate lists (an all-gather over ``axis``), and a k-way merge
    follows. ``use_pallas`` keeps the JAX package's name: on the card each
    shard streams its rows through B4 (``ops.cuda_kernels.topk_gallery``),
    elsewhere (and without it) one matrix product and a stable top-k.

    Exactness under padding: the gallery pads with zero rows to a multiple
    of the axis size, and every shard over-fetches ``k' = min(k + pad,
    rows a shard)``. At most ``pad`` rows are padding, so after masking
    them to -inf each shard still brings its whole real top-k to the
    merge: the result is the single-device top-k (ties in index order).

    queries [N, D], gallery [M, D]: host arrays or tensors (a tensor on a
    coordinate's device is read there in place). Returns
    (scores [N, k] f32, global indices [N, k] int64), whole on the first
    coordinate's device. k > M raises ``ValueError``."""
    from ..ops.cuda_kernels import topk_gallery

    q, g = (a.float() if isinstance(a, torch.Tensor) else
            torch.as_tensor(np.asarray(a, np.float32))
            for a in (queries, gallery))
    n, d = q.shape
    m = g.shape[0]
    if k > m:
        raise ValueError(f"k={k} exceeds gallery size {m}")
    s = mesh.shape[axis]
    pad = (-m) % s
    if pad:
        g = torch.cat([g, g.new_zeros((pad, d))])
    rows = g.shape[0] // s
    kloc = min(k + pad, rows)
    q_at = replicate_to_mesh(q, mesh)
    g_at = put_global(g, Sharding(mesh, axis))

    def local_topk(coord):
        qd, gd = q_at[coord], g_at[coord]
        with torch.inference_mode():
            if use_pallas:
                sc, li = topk_gallery(qd, gd, kloc)
            else:
                sc, li = _stable_topk(qd @ gd.T, kloc)
            gi = li.long() + C.axis_index(axis) * rows      # global indices
            sc = torch.where(gi < m, sc, -torch.inf)        # mask padding
            # only the candidate lists cross: [S, N, k']
            pool_sc = torch.cat(C.all_gather(sc, axis), 1)
            pool_gi = torch.cat(C.all_gather(gi, axis), 1)
            fs, fi = _stable_topk(pool_sc, k)               # k-way merge
            return fs, torch.gather(pool_gi, 1, fi)

    with _f32_matmul():
        return C.run_spmd(mesh, local_topk)[mesh.local_coords()[0]]


def _f32_matmul():
    """Full-f32 matrix products on the card (TF32 off), as the unsharded
    search runs them."""
    from ..pipelines.similarity import _f32_matmul as f32

    return f32()
