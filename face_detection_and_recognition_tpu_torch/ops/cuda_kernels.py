"""The hand-written CUDA kernels of the port (the detect, ensemble,
similarity and BlazeFace paths, and the int8 convolution of the quantized
yolov5 nets), their plain PyTorch versions, and the build that turns
``csrc/*.cu`` into one shared library.

Each wrapper takes the plain version for tensors on the CPU (the tests) and
launches its kernel for CUDA tensors; there is no fallback between the two.
Every launch adds one to ``LAUNCHES[name]``, so a run can show that it went
through the kernel. Each entry point is also a ``torch.library`` operator of
the ``fdr`` namespace (the end of this module), which a wrapper calls while
a program is exported, so that the program carries the kernel.

Build: one ``nvcc`` a source in ``csrc/``, all started together, compiles
it for ``sm_90a``, and one more links the objects into
``build/fdr_kernels_<hash>.so`` at the repository root, on first use.
The name carries a hash of the sources and flags, so a later process finds
the library and skips the build. The sources have a plain C interface and
include no PyTorch header, so the build takes seconds; the library is bound
with ``ctypes``. ``nvcc`` is reached only inside the first launch, so
this module imports on a machine without it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .boxes import decode_boxes, xywh2xyxy

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# launches of each kernel since the last reset (chip_smoke.py reads them)
LAUNCHES = {"nms_fixpoint": 0, "rows_gather": 0, "crop_resize": 0,
            "topk_gallery": 0, "blend_nms": 0, "blaze_decode_blend": 0,
            "conv_int8": 0}

_LIB = []  # the loaded library, once built
# request threads reach the first build and bind, and count launches,
# concurrently
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def exporting() -> bool:
    """Whether a program is being exported (``torch.export``): the
    wrappers then call their ``fdr`` operator, whose fake tensors carry no
    data to launch on."""
    return torch.compiler.is_exporting()


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"fdr_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources is
    already built: one nvcc a source, all at once, then one link. Returns
    its path; ptxas's report of each kernel's registers, shared memory and
    stack frame is kept beside it (``ptxas_report``)."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj, log = (Path(tmp, src.stem + ext) for ext in (".o", ".log"))
            with open(log, "w") as f:
                jobs.append((src, obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT)))
        failed = [f"{src.name} ({p.returncode}):\n{log.read_text()}"
                  for src, _, log, p in jobs if p.wait() != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = Path(tmp, out.name)
        res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                              *(str(obj) for _, obj, _, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({res.returncode}):\n"
                               f"{res.stderr}")
        ptxas_report().write_text("".join(log.read_text()
                                          for _, _, log, _ in jobs))
        os.replace(lib, out)  # atomic: a concurrent build sees all or none
    return out


def ptxas_report() -> Path:
    """Where ``build_library`` keeps nvcc's ``-Xptxas -v`` output."""
    return library_path().with_suffix(".ptxas.txt")


def _lib():
    """The bound kernel library, built and bound once: the first caller
    builds under the lock, and every later one finds it."""
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(build_library()))
    return _LIB[0]


def _bind(path: Path):
    """Load the library at ``path`` and declare its entry points."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nms_fixpoint_launch.argtypes = [p, p, p, p, i, i, ctypes.c_float,
                                        i, i, i, p]
    lib.nms_fixpoint_launch.restype = i
    lib.candidate_decode_launch.argtypes = [p, p, p, p, p, i, p, p, p,
                                            p, i, i, i, ctypes.c_float,
                                            p]
    lib.candidate_decode_launch.restype = i
    lib.crop_resize_launch.argtypes = [p, i, p, p, p, i, i, i, i, i, i,
                                       i, i, i, i, p, p]
    lib.crop_resize_launch.restype = i
    lib.topk_gallery_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                        p]
    lib.topk_gallery_launch.restype = i
    lib.blend_nms_launch.argtypes = [p, p, p, p, i, i, i, ctypes.c_float,
                                     i, p]
    lib.blend_nms_launch.restype = i
    f = ctypes.c_float
    lib.blaze_decode_blend_launch.argtypes = [p, p, p, p, p, i, i, f, f, f,
                                              f, i, p]
    lib.blaze_decode_blend_launch.restype = i
    lib.conv_int8_launch.argtypes = [p, p, i, p, i, i, i, p, i, p]
    lib.conv_int8_launch.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


# ---------------- B1: greedy NMS keep mask ----------------


def nms_fixpoint_plain(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float, plus1: bool = False,
                       strict: bool = True, mode: str = "union"
                       ) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted boxes, as the fixpoint of the
    "suppressed by a higher kept box" relation — the arithmetic and the
    iteration of ``_nms_kernel`` (pallas_kernels.py:40-87).

    boxes: [B, K, 4] f32 xyxy, highest score first; valid: [B, K] bool.
    Returns keep [B, K] bool."""
    if mode not in ("union", "min"):
        raise ValueError(f"unknown NMS mode: {mode}")
    off = 1.0 if plus1 else 0.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    lt_x = torch.maximum(x1[..., :, None], x1[..., None, :])
    lt_y = torch.maximum(y1[..., :, None], y1[..., None, :])
    rb_x = torch.minimum(x2[..., :, None], x2[..., None, :])
    rb_y = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (rb_x - lt_x + off).clamp(min=0.0) * \
        (rb_y - lt_y + off).clamp(min=0.0)
    area = (x2 - x1 + off) * (y2 - y1 + off)
    if mode == "min":
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
        if plus1:
            denom = denom + 1e-16
    iou = inter / denom
    overlaps = (iou > iou_thres) if strict else (iou >= iou_thres)
    k = boxes.shape[-2]
    higher = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup_higher = overlaps & higher  # [.., j, i]: j ranks above i
    s = torch.zeros_like(valid)
    while True:
        keep = valid & ~s
        new_s = (sup_higher & keep[..., :, None]).any(dim=-2)
        if torch.equal(new_s, s):
            return keep
        s = new_s


def nms_fixpoint(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float,
                 plus1: bool = False, strict: bool = True,
                 mode: str = "union") -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted boxes, every image in one
    launch (``csrc/nms.cu``). The port of ``nms_fixpoint_pallas``.

    boxes: [B, K, 4] f32 xyxy, highest score first; valid: [B, K] bool.
    Returns keep [B, K] bool, equal bit for bit to ``nms_fixpoint_plain``."""
    if exporting():
        return torch.ops.fdr.nms_fixpoint(boxes, valid, float(iou_thres),
                                          bool(plus1), bool(strict), mode)
    if boxes.device.type == "cpu":
        return nms_fixpoint_plain(boxes, valid, iou_thres, plus1, strict, mode)
    if mode not in ("union", "min"):
        raise ValueError(f"unknown NMS mode: {mode}")
    _require_cuda("nms_fixpoint", boxes, valid)
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("nms_fixpoint: boxes must be float32, valid bool")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_fixpoint: boxes [B, K, 4] and valid [B, K] "
                         f"expected, got {tuple(boxes.shape)} and "
                         f"{tuple(valid.shape)}")
    b, k = valid.shape
    if k > 8192:
        raise ValueError(f"nms_fixpoint: K = {k} exceeds 8192")
    scratch = torch.empty((b, k, (k + 31) // 32), dtype=torch.int32,
                          device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    err = _lib().nms_fixpoint_launch(
        boxes.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
        keep.data_ptr(), b, k, float(iou_thres), int(plus1), int(strict),
        int(mode == "min"), _stream(boxes))
    _check(err, "nms_fixpoint")
    _count("nms_fixpoint")
    return keep


# ---------------- B2: candidate gather + decode ----------------

MAX_LEVELS, MAX_ANCHORS = 4, 3  # the largest layout candidate_decode takes


def rows_gather_plain(maps_flat: Sequence[torch.Tensor],
                      idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(concat(maps_flat, 1), idx[..., None], 1)``.

    maps_flat: per-level [B, n_l, no]; idx: [B, K] int. Returns [B, K, no]."""
    flat = torch.cat(list(maps_flat), dim=1)
    return torch.take_along_dim(flat, idx.long()[..., None], dim=1)


def _candidate_grid_params(idx: torch.Tensor,
                           anchors: Sequence[Sequence[Tuple[float, float]]],
                           strides: Sequence[int],
                           input_size: Tuple[int, int]):
    """(grid_xy, stride, anchor_wh) of flat anchor indices ``idx`` [B, K],
    by integer arithmetic over the level layout (levels concatenated, each
    row-major over [na, ny, nx], as ``decode_heads`` orders them)."""
    w, h = input_size
    gx = torch.zeros_like(idx)
    gy = torch.zeros_like(idx)
    f32 = dict(dtype=torch.float32, device=idx.device)
    stride_o = torch.zeros(idx.shape, **f32)
    aw = torch.zeros(idx.shape, **f32)
    ah = torch.zeros(idx.shape, **f32)
    offset = 0
    for anc, s in zip(anchors, strides):
        ny, nx = h // s, w // s
        block = len(anc) * ny * nx
        r = idx - offset
        in_lvl = (r >= 0) & (r < block)
        a = r // (ny * nx)
        cell = r % (ny * nx)
        gy = torch.where(in_lvl, cell // nx, gy)
        gx = torch.where(in_lvl, cell % nx, gx)
        stride_o = torch.where(in_lvl, float(s), stride_o)
        for j, (ajw, ajh) in enumerate(anc):
            hit = in_lvl & (a == j)
            aw = torch.where(hit, float(ajw), aw)
            ah = torch.where(hit, float(ajh), ah)
        offset += block
    grid = torch.stack([gx, gy], -1).float()
    return grid, stride_o[..., None], torch.stack([aw, ah], -1)


def decode_candidates_plain(cand: torch.Tensor, idx: torch.Tensor,
                            anchors: Sequence[Sequence[Tuple[float, float]]],
                            strides: Sequence[int],
                            input_size: Tuple[int, int], conf_thres: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Decode gathered raw candidate rows ``cand`` [B, K, no] f32 of flat
    row indices ``idx`` as ``decode_heads`` does (same operation order and
    dtypes): the JAX package's ``_candidate_grid_params`` and candidate
    decode. Returns what ``candidate_decode_plain`` returns."""
    b, k = idx.shape
    grid, stride, anc = _candidate_grid_params(idx, anchors, strides,
                                               input_size)
    y = torch.cat([torch.sigmoid(cand[..., :5]), cand[..., 5:15],
                   torch.sigmoid(cand[..., 15:])], -1)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (y[..., 2:4] * 2.0) ** 2 * anc
    lmk = (y[..., 5:15].reshape(b, k, 5, 2) * anc[..., None, :]
           + grid[..., None, :] * stride[..., None])
    pred = torch.cat([xy, wh, y[..., 4:5], lmk.reshape(b, k, 10),
                      y[..., 15:]], -1)
    return pred, xywh2xyxy(pred[..., :4]), pred[..., 4] >= conf_thres


def candidate_decode_plain(maps_flat: Sequence[torch.Tensor],
                           idx: torch.Tensor,
                           anchors: Sequence[Sequence[Tuple[float, float]]],
                           strides: Sequence[int],
                           input_size: Tuple[int, int], conf_thres: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Gather the candidate rows ``idx`` of the raw head maps and decode
    them: the function of ``candidate_rows_gather_pallas`` followed by the
    JAX package's ``_candidate_grid_params`` and candidate decode.

    maps_flat: per-level [B, n_l, no] f32 or bf16 raw maps; idx: [B, K]
    int flat row indices; input_size: (w, h). Returns (pred [B, K, no] f32
    rows [cx, cy, w, h, obj, lmk x10, cls...] in input pixels, boxes
    [B, K, 4] f32 xyxy, valid [B, K] bool: obj >= conf_thres)."""
    return decode_candidates_plain(rows_gather_plain(maps_flat, idx).float(),
                                   idx, anchors, strides, input_size,
                                   conf_thres)


@functools.lru_cache(maxsize=64)
def _decode_layout(anchors: Tuple, strides: Tuple, input_size: Tuple):
    """(rows per level, the kernel's constant struct, its address) of one
    level layout, built once per (anchors, strides, input size); the cache
    keeps the struct alive for the address."""
    import ctypes

    na = len(anchors[0])
    if not 1 <= len(strides) <= MAX_LEVELS or len(anchors) != len(strides) \
            or not 1 <= na <= MAX_ANCHORS \
            or any(len(a) != na for a in anchors):
        raise ValueError(f"candidate_decode: 1 to {MAX_LEVELS} levels of 1 "
                         f"to {MAX_ANCHORS} anchors each, got {anchors} for "
                         f"strides {strides}")

    class Layout(ctypes.Structure):  # csrc/rows_gather.cu DecodeLayout
        _fields_ = [("n_levels", ctypes.c_int), ("na", ctypes.c_int),
                    ("rows", ctypes.c_int * MAX_LEVELS),
                    ("nx", ctypes.c_int * MAX_LEVELS),
                    ("cells", ctypes.c_int * MAX_LEVELS),
                    ("stride", ctypes.c_float * MAX_LEVELS),
                    ("anchor", ctypes.c_float * (MAX_LEVELS * MAX_ANCHORS
                                                 * 2))]

    w, h = input_size
    lay = Layout(n_levels=len(strides), na=na)
    rows = []
    for lv, (anc, s) in enumerate(zip(anchors, strides)):
        ny, nx = h // s, w // s
        rows.append(na * ny * nx)
        lay.rows[lv], lay.nx[lv], lay.cells[lv] = rows[-1], nx, ny * nx
        lay.stride[lv] = float(s)
        for j, (aw, ah) in enumerate(anc):
            lay.anchor[(lv * MAX_ANCHORS + j) * 2] = aw
            lay.anchor[(lv * MAX_ANCHORS + j) * 2 + 1] = ah
    return tuple(rows), lay, ctypes.addressof(lay)


def candidate_decode(maps_flat: Sequence[torch.Tensor], idx: torch.Tensor,
                     anchors: Tuple, strides: Tuple, input_size: Tuple,
                     conf_thres: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather and decode the top-K candidate rows of every image in one
    launch (``csrc/rows_gather.cu``), reading the per-level maps in place.
    The port of ``candidate_rows_gather_pallas`` fused with the decode
    around it; equal bit for bit to ``candidate_decode_plain``.

    maps_flat: up to 4 per-level [B, n_l, no] maps of one dtype (f32 or
    bf16), contiguous, n_l = na * (h // s) * (w // s), no a multiple of 4
    and at least 16; idx: [B, K] int32 flat row indices. ``anchors``,
    ``strides`` and ``input_size`` (w, h) are tuples: the layout is cached
    by them. Returns (pred [B, K, no] f32, boxes [B, K, 4] f32 xyxy,
    valid [B, K] bool)."""
    if exporting():
        return torch.ops.fdr.candidate_decode(
            list(maps_flat), idx, [float(v) for level in anchors
                                   for pair in level for v in pair],
            [int(s) for s in strides], [int(v) for v in input_size],
            float(conf_thres))
    if idx.device.type == "cpu":
        return candidate_decode_plain(maps_flat, idx, anchors, strides,
                                      input_size, conf_thres)
    rows, _, layout = _decode_layout(anchors, strides, input_size)
    m0 = maps_flat[0]
    b, no, dtype, dev = m0.shape[0], m0.shape[-1], m0.dtype, idx.get_device()
    if len(maps_flat) != len(rows) or no % 4 or no < 16 \
            or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"candidate_decode: {len(rows)} f32 or bf16 levels "
                         f"of rows with a multiple of 4 (>= 16) columns "
                         f"expected, got {len(maps_flat)} of {no} {dtype}")
    for m, n in zip(maps_flat, rows):
        if m.shape != (b, n, no) or m.dtype != dtype \
                or m.get_device() != dev or not m.is_contiguous() \
                or m.data_ptr() % 16:
            raise ValueError(f"candidate_decode: level {tuple(m.shape)} "
                             f"{m.dtype} on {m.device} is not a contiguous, "
                             f"16-byte aligned [{b}, {n}, {no}] {dtype} map "
                             f"on {idx.device}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != b \
            or not idx.is_contiguous():
        raise ValueError("candidate_decode: idx must be contiguous [B, K] "
                         "int32")
    k = idx.shape[1]
    if b * k * no >= 2 ** 33:  # the kernel's thread index is an int
        raise ValueError(f"candidate_decode: B * K = {b * k} too large")
    pred = torch.empty(b, k, no, dtype=torch.float32, device=idx.device)
    boxes = torch.empty(b, k, 4, dtype=torch.float32, device=idx.device)
    valid = torch.empty(b, k, dtype=torch.bool, device=idx.device)
    ptrs = [m.data_ptr() for m in maps_flat] + [0] * (4 - len(rows))
    err = _lib().candidate_decode_launch(
        *ptrs, layout, int(dtype == torch.bfloat16), idx.data_ptr(),
        pred.data_ptr(), boxes.data_ptr(), valid.data_ptr(), b, k, no,
        conf_thres, _stream(idx))
    _check(err, "candidate_decode")
    _count("rows_gather")
    return pred, boxes, valid


# ---------------- B3: crop + bilinear resize ----------------


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as a fused
    multiply-add rounds it. The product is exact in float64; the sum is
    rounded to odd there (TwoSum gives its error), and a round-to-odd
    result with 29 spare bits rounds to float32 as the exact sum would."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    inexact = e != 0
    # truncate toward zero: step back one ulp where s rounded away from it
    away = inexact & ((e > 0) != (s > 0))
    s = torch.where(away, torch.nextafter(s, torch.zeros_like(s)), s)
    bits = s.view(torch.int64)
    return torch.where(inexact, bits | 1, bits).view(torch.float64).float()


def _crop_taps(b0: torch.Tensor, b1: torch.Tensor, n: int, n_out: int,
               clamp: bool):
    """Sample taps along one axis for boxes whose edges are ``b0``/``b1``
    [B, K], over a frame extent ``n``: (i0, i1, w, in0, in1), each
    [B, K, n_out]; i0/i1 are clipped into the frame, in0/in1 say whether the
    tap lies inside it (pad semantics read 0 outside)."""
    dev = b0.device
    if clamp:
        lo = torch.floor(b0).clamp(0.0, n - 1.0)
        hi = torch.maximum(torch.floor(b1), lo + 1.0).clamp(max=float(n))
        length = hi - lo
    else:
        lo = torch.floor(b0)
        length = (torch.floor(b1) - lo).clamp(min=1.0)
    lo, length = lo[..., None], length[..., None]
    o = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    rcp = torch.tensor(np.float32(1.0) / np.float32(n_out), device=dev)
    s = _fma_f32(o * length, rcp, lo) - 0.5
    if clamp:
        s = torch.minimum(torch.maximum(s, lo), lo + length - 1.0)
        f0 = torch.floor(s).clamp(0.0, n - 1.0)
        f1 = (f0 + 1.0).clamp(0.0, n - 1.0)
        inside = torch.ones_like(s, dtype=torch.bool)
        return f0.long(), f1.long(), s - f0, inside, inside
    f0 = torch.floor(s)
    f1 = f0 + 1.0
    in0, in1 = (f0 >= 0) & (f0 < n), (f1 >= 0) & (f1 < n)
    return (f0.clamp(0.0, n - 1.0).long(), f1.clamp(0.0, n - 1.0).long(),
            s - f0, in0, in1)


def crop_resize_plain(img: torch.Tensor, boxes: torch.Tensor,
                      valid: torch.Tensor, out_hw: Tuple[int, int],
                      clamp: bool = True, clip: bool = False,
                      mean: Optional[Sequence[float]] = None,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """The gather arithmetic of ``crop_and_resize`` (``clamp=True``) or
    ``crop_and_resize_padded`` (``clamp=False``) of the JAX package's
    ``ops/crop.py``, batched over frames and boxes. The sample coordinate
    is ``fma((o + 0.5) * len, rcp(n_out), lo) - 0.5``, the form XLA
    compiles the JAX source's ``lo + (o + 0.5) * len / n_out - 0.5`` into
    on the CPU. The epilogue follows, in this order: ``clip`` clamps every
    value to [0, 255], ``mean`` (C floats) is subtracted.

    ``out_dtype`` bfloat16 stores what the JAX bf16 engine feeds its
    age/gender heads: the clipped sample cast to bf16, then, with a mean,
    widened to f32, less the mean, cast to bf16 again (two roundings to
    nearest even).

    img: [B, H, W, C] uint8 or float; boxes: [B, K, 4] f32 xyxy pixels;
    valid: [B, K] bool. Returns [B, K, oh, ow, C] ``out_dtype``; invalid
    slots sample 0, so they come out as 0, or as ``-mean`` with a mean."""
    b, h, w, c = img.shape
    oh, ow = out_hw
    boxes = boxes.float()
    y0, y1, wy, iy0, iy1 = _crop_taps(boxes[..., 1], boxes[..., 3], h, oh,
                                      clamp)
    x0, x1, wx, ix0, ix1 = _crop_taps(boxes[..., 0], boxes[..., 2], w, ow,
                                      clamp)
    flat = img.reshape(b * h * w, c).float()
    base = (torch.arange(b, device=img.device) * h).view(b, 1, 1)

    def tap(yi, iny, xi, inx):
        idx = ((base + yi)[..., :, None] * w + xi[..., None, :])
        vals = flat[idx]                                   # [B, K, oh, ow, C]
        inb = (iny[..., :, None] & inx[..., None, :])[..., None]
        return torch.where(inb, vals, 0.0)

    wx1, wy1 = wx[..., None, :, None], wy[..., :, None, None]
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    top = tap(y0, iy0, x0, ix0) * wx0 + tap(y0, iy0, x1, ix1) * wx1
    bot = tap(y1, iy1, x0, ix0) * wx0 + tap(y1, iy1, x1, ix1) * wx1
    out = top * wy0 + bot * wy1
    out = torch.where(valid[..., None, None, None], out, 0.0)
    if clip:
        out = out.clamp(0.0, 255.0)
    if out_dtype == torch.bfloat16:
        out = out.to(torch.bfloat16)
    elif out_dtype != torch.float32:
        raise ValueError(f"crop_resize: out_dtype {out_dtype} is not float32 "
                         "or bfloat16")
    if mean is not None:
        out = (out.float() - torch.tensor(mean, dtype=torch.float32,
                                          device=out.device)).to(out_dtype)
    return out


def crop_resize(img: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                out_hw: Tuple[int, int], clamp: bool = True,
                clip: bool = False, mean: Optional[Sequence[float]] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Crop and bilinearly resize K boxes from each of B frames in one
    launch (``csrc/crop_resize.cu``), with the optional clip and mean
    subtraction applied as it stores. The port of ``crop_gemm_pallas``;
    equal bit for bit to ``crop_resize_plain``.

    img: [B, H, W, C] uint8 or float32 NHWC, C <= 4; boxes: [B, K, 4]
    float32 xyxy pixels; valid: [B, K] bool; ``clamp`` picks the box
    semantics (True: clamp to the frame, False: zero pad); ``clip`` and
    ``mean`` (C floats) and ``out_dtype`` (float32, or bfloat16: the
    two-rounding store) as in ``crop_resize_plain``. Returns
    [B, K, oh, ow, C] ``out_dtype``, invalid slots 0 (``-mean`` with a
    mean)."""
    if exporting():
        return torch.ops.fdr.crop_resize(
            img, boxes, valid, [int(v) for v in out_hw], bool(clamp),
            bool(clip), None if mean is None else [float(m) for m in mean],
            out_dtype)
    if img.device.type == "cpu":
        return crop_resize_plain(img, boxes, valid, out_hw, clamp, clip, mean,
                                 out_dtype)
    _require_cuda("crop_resize", img, boxes, valid)
    if img.dim() != 4 or img.dtype not in (torch.uint8, torch.float32) \
            or not 1 <= img.shape[-1] <= 4:
        raise ValueError("crop_resize: img must be [B, H, W, C<=4] uint8 or "
                         f"float32, got {tuple(img.shape)} {img.dtype}")
    b, h, w, c = img.shape
    if boxes.dtype != torch.float32 or tuple(boxes.shape[:1]) != (b,) \
            or boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"crop_resize: boxes must be [B, K, 4] float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    k = boxes.shape[1]
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, k):
        raise ValueError("crop_resize: valid must be [B, K] bool")
    if boxes.data_ptr() % 16:
        raise ValueError("crop_resize: boxes not 16-byte aligned")
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh < 1 or not 1 <= ow <= 2048 or k > 65535 or b > 65535:
        raise ValueError(f"crop_resize: out {oh}x{ow}, B {b}, K {k} out of "
                         "range (ow <= 2048, B and K <= 65535)")
    if mean is not None and len(mean) != c:
        raise ValueError(f"crop_resize: {len(mean)} means for {c} channels")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"crop_resize: out_dtype {out_dtype} is not float32 "
                         "or bfloat16")
    out = torch.empty((b, k, oh, ow, c), dtype=out_dtype, device=img.device)
    import ctypes

    lib = _lib()
    c_mean = None if mean is None else (ctypes.c_float * c)(*mean)
    err = lib.crop_resize_launch(
        img.data_ptr(), int(img.dtype == torch.uint8), boxes.data_ptr(),
        valid.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        b, k, h, w, c, oh, ow, int(clamp), int(clip), c_mean, _stream(img))
    _check(err, "crop_resize")
    _count("crop_resize")
    return out


# ---------------- B4: streaming gallery top-k ----------------

TOPK_MAX_K = 16        # the largest k that topk_gallery takes
_TOPK_TILE = 128       # queries of a CTA, gallery rows of a tile


@functools.lru_cache(maxsize=None)
def _topk_ctas(device_index: int) -> int:
    """Launch-1 CTAs to aim for on a card: two a streaming multiprocessor,
    as many as fit at once (~100 KB of shared memory and 256 threads of at
    most 128 registers each), so that one wave covers the card."""
    return 2 * torch.cuda.get_device_properties(
        device_index).multi_processor_count


def topk_gallery_plain(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                       chunk: int = 65536
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best inner products of each query, the function of
    ``topk_gallery_pallas``: each score is the chain
    ``acc = fma(q[d], g[d], acc)`` from acc = 0 over d = 0 .. D-1, every
    step rounded once (``_fma_f32``); order (score desc, index asc); a
    score must beat the empty slot's -1e30 to enter, and an empty slot
    reads (-1e30, 0). The gallery streams through in ``chunk``-row pieces,
    each merged into the running list by a stable sort (the running list
    first, so equal scores keep the smaller index).

    queries: [N, D] f32; gallery: [M, D] f32. Returns (scores [N, k] f32,
    indices [N, k] int32)."""
    n, d = queries.shape
    dev = queries.device
    run_s = torch.full((n, k), -1e30, dtype=torch.float32, device=dev)
    run_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for m0 in range(0, gallery.shape[0], chunk):
        gt = gallery[m0:m0 + chunk].t().contiguous()         # [D, mc]
        acc = torch.zeros((n, gt.shape[1]), dtype=torch.float32, device=dev)
        for j in range(d):
            acc = _fma_f32(queries[:, j:j + 1], gt[j], acc)
        idx = torch.arange(m0, m0 + gt.shape[1], device=dev).expand_as(acc)
        s, i = torch.cat([run_s, acc], 1), torch.cat([run_i, idx], 1)
        order = torch.sort(s, dim=1, descending=True, stable=True).indices
        run_s = torch.take_along_dim(s, order[:, :k], 1)
        run_i = torch.take_along_dim(i, order[:, :k], 1)
    return run_s, run_i.clamp(min=0).to(torch.int32)


def topk_gallery(queries: torch.Tensor, gallery: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner-product search of [N, D] queries against an [M, D]
    gallery without forming the [N, M] scores (``csrc/topk_gallery.cu``,
    two launches). The port of ``topk_gallery_pallas``; equal bit for bit
    to ``topk_gallery_plain``.

    queries, gallery: f32, contiguous; 1 <= k <= ``TOPK_MAX_K``. Returns
    (scores [N, k] f32 descending, indices [N, k] int32)."""
    if not 1 <= k <= TOPK_MAX_K:
        raise ValueError(f"topk_gallery: k = {k} outside 1..{TOPK_MAX_K}")
    if exporting():
        return torch.ops.fdr.topk_gallery(queries, gallery, int(k))
    if queries.device.type == "cpu":
        return topk_gallery_plain(queries, gallery, k)
    _require_cuda("topk_gallery", queries, gallery)
    if queries.dtype != torch.float32 or gallery.dtype != torch.float32 \
            or queries.dim() != 2 or gallery.dim() != 2 \
            or queries.shape[1] != gallery.shape[1]:
        raise ValueError(f"topk_gallery: f32 [N, D] and [M, D] expected, got "
                         f"{tuple(queries.shape)} {queries.dtype} and "
                         f"{tuple(gallery.shape)} {gallery.dtype}")
    (n, d), m = queries.shape, gallery.shape[0]
    # the kernel's row offsets are int32
    if n >= 2 ** 31 - 2 ** 20 or m >= 2 ** 31 - 2 ** 20:
        raise ValueError(f"topk_gallery: N = {n} or M = {m} too large")
    # grid.x holds the query tiles, so the tiles of one gallery chunk run
    # side by side; grid.y the chunks, one CTA list a query each
    q_tiles, tiles = -(-n // _TOPK_TILE), -(-m // _TOPK_TILE)
    chunks = max(1, min(tiles, -(-_topk_ctas(queries.device.index)
                                    // q_tiles)))
    per_chunk = max(1, -(-tiles // chunks))
    n_parts = max(1, -(-tiles // per_chunk))
    part_s = torch.empty((n, n_parts, k), dtype=torch.float32,
                         device=queries.device)
    part_i = torch.empty((n, n_parts, k), dtype=torch.int32,
                         device=queries.device)
    scores = torch.empty((n, k), dtype=torch.float32, device=queries.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=queries.device)
    err = _lib().topk_gallery_launch(
        queries.data_ptr(), gallery.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), scores.data_ptr(), idx.data_ptr(), n, m, d, k,
        per_chunk, _stream(queries))
    _check(err, "topk_gallery")
    _count("topk_gallery")
    return scores, idx


# ---------------- B5: weighted-blend NMS ----------------

BLEND_MAX_ROWS = 2048  # the K cap of blend_nms, the Pallas version's


def blend_nms_plain(sdets: torch.Tensor, svalid: torch.Tensor,
                    iou_thres: float, max_out: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlazeFace's weighted-blend NMS over score-sorted rows: the fori loop
    of the JAX package's ``ops/nms.py:187-223``, every image at once.

    Slot s picks the first alive row and takes every alive row whose
    jaccard IoU with it (cols 0:4 are [ymin, xmin, ymax, xmax]) is above
    ``iou_thres``, and the row itself. With n > 1 taken rows the slot's
    coords are sum(coord * score) / sum(score) and its score
    sum(score) / n, both sums adding the taken rows one by one in score
    order; with n = 1 the row is copied. Slots past the last pick are zero
    rows with valid False.

    sdets: [B, K, D] f32 sorted by score (col D-1) descending; svalid:
    [B, K] bool. Returns (rows [B, max_out, D], valid [B, max_out])."""
    b, k, d = sdets.shape
    dev = sdets.device
    y1, x1, y2, x2 = sdets[..., :4].unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    rows = torch.arange(k, device=dev)
    alive = svalid.clone()
    taken = torch.zeros((b, max_out, k), dtype=torch.bool, device=dev)
    out_valid = torch.zeros((b, max_out), dtype=torch.bool, device=dev)
    for slot in range(min(max_out, k)):
        has = alive.any(1)
        if not bool(has.any()):
            break
        first = alive.to(torch.uint8).argmax(1, keepdim=True)  # first alive
        fx1, fy1, fx2, fy2, fa = (t.gather(1, first)
                                  for t in (x1, y1, x2, y2, area))
        iw = (torch.minimum(fx2, x2) - torch.maximum(fx1, x1)).clamp(min=0.0)
        ih = (torch.minimum(fy2, y2) - torch.maximum(fy1, y1)).clamp(min=0.0)
        inter = iw * ih
        iou = inter / ((fa + area) - inter)
        over = alive & ((iou > iou_thres) | (rows == first))
        taken[:, slot] = over
        alive &= ~over
        out_valid[:, slot] = has
    score = sdets[..., -1]
    total = torch.zeros((b, max_out), dtype=torch.float32, device=dev)
    num = torch.zeros((b, max_out, d), dtype=torch.float32, device=dev)
    # rows no slot took add +0 to every sum, which changes none of them
    for j in taken.any(1).any(0).nonzero()[:, 0].tolist():
        t = taken[:, :, j]
        w = score[:, j:j + 1]
        total = total + torch.where(t, w, 0.0)
        num = num + torch.where(t[..., None], (sdets[:, j] * w)[:, None], 0.0)
    n = taken.sum(2)
    blended = num / total[..., None]
    blended[..., -1] = total / n
    single = torch.take_along_dim(
        sdets, taken.to(torch.uint8).argmax(2)[..., None], 1)
    out = torch.where((n == 1)[..., None], single, blended)
    return torch.where(out_valid[..., None], out, 0.0), out_valid


def blend_nms(sdets: torch.Tensor, svalid: torch.Tensor, iou_thres: float,
              max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted-blend NMS of every image in one launch, one CTA an image
    (``csrc/blend_nms.cu``, the standalone entry point). The port of
    ``weighted_blend_nms_pallas``, to the function of the f32 fori loop;
    equal bit for bit to ``blend_nms_plain``.

    sdets: [B, K, D] f32 score-sorted rows (score in col D-1, D >= 5,
    K <= ``BLEND_MAX_ROWS``); svalid: [B, K] bool. Returns (rows
    [B, max_out, D] f32, valid [B, max_out] bool)."""
    if exporting():
        return torch.ops.fdr.blend_nms(sdets, svalid, float(iou_thres),
                                       int(max_out))
    if sdets.device.type == "cpu":
        return blend_nms_plain(sdets, svalid, iou_thres, max_out)
    _require_cuda("blend_nms", sdets, svalid)
    if sdets.dtype != torch.float32 or svalid.dtype != torch.bool \
            or sdets.dim() != 3 or svalid.shape != sdets.shape[:2]:
        raise ValueError(f"blend_nms: f32 [B, K, D] and bool [B, K] "
                         f"expected, got {tuple(sdets.shape)} {sdets.dtype} "
                         f"and {tuple(svalid.shape)} {svalid.dtype}")
    b, k, d = sdets.shape
    if k > BLEND_MAX_ROWS or d < 5:
        raise ValueError(f"blend_nms: K = {k} (at most {BLEND_MAX_ROWS}) or "
                         f"D = {d} (at least 5) out of range")
    out = torch.empty((b, max_out, d), dtype=torch.float32,
                      device=sdets.device)
    out_valid = torch.empty((b, max_out), dtype=torch.bool,
                            device=sdets.device)
    err = _lib().blend_nms_launch(
        sdets.data_ptr(), svalid.data_ptr(), out.data_ptr(),
        out_valid.data_ptr(), b, k, d, float(iou_thres), int(max_out),
        _stream(sdets))
    _check(err, "blend_nms")
    _count("blend_nms")
    return out, out_valid


BLAZE_MAX_ANCHORS = 1024  # the anchor cap of blaze_decode_blend


def blaze_decode_blend_plain(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                             anchors: torch.Tensor, scale: float,
                             score_clip: float, score_thres: float,
                             iou_thres: float, max_out: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlazeFace's postprocess as a chain of torch ops: the anchor decode,
    the clipped sigmoid score, the threshold, the stable sort by score, the
    weighted-blend NMS (``blend_nms_plain``) and the column reorder to
    ``[xmin, ymin, xmax, ymax, 12 kps, conf]``. The function of the JAX
    package's ``blazeface_postprocess``.

    raw_boxes: [B, N, 16] f32; raw_scores: [B, N, 1] f32; anchors: [N, 4]
    f32 rows (x, y, w, h). Returns (dets [B, max_out, 17], valid
    [B, max_out])."""
    from .nms import sort_by_score  # it imports this module

    boxes = decode_boxes(raw_boxes, anchors, scale)
    scores = torch.sigmoid(raw_scores[..., 0].clamp(-score_clip, score_clip))
    dets = torch.cat([boxes, scores[..., None]], -1)
    _, _, svalid, sdets = sort_by_score(scores, scores >= score_thres, dets)
    out, out_valid = blend_nms_plain(sdets, svalid, iou_thres, max_out)
    # [ymin, xmin, ymax, xmax, ...] -> [xmin, ymin, xmax, ymax, ...]
    return out[..., [1, 0, 3, 2] + list(range(4, 17))], out_valid


def blaze_decode_blend(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                       anchors: torch.Tensor, scale: float, score_clip: float,
                       score_thres: float, iou_thres: float, max_out: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlazeFace's whole postprocess, every frame in one launch
    (``csrc/blend_nms.cu``, the fused entry point): decode, clip and
    sigmoid, threshold, sort and weighted-blend NMS, the rows written in the
    contract's column order. The port of ``weighted_blend_nms_pallas`` with
    the decode around it; equal bit for bit to ``blaze_decode_blend_plain``.

    raw_boxes: [B, N, 16] f32 and anchors [N, 4] f32, both contiguous and
    16-byte aligned; raw_scores: [B, N, 1] f32; N <= ``BLAZE_MAX_ANCHORS``;
    ``scale`` a power of two, on every device (the kernel's division by it
    is exact only then). Returns (dets [B, max_out, 17] f32, valid
    [B, max_out] bool)."""
    if not (scale > 0 and math.frexp(scale)[0] == 0.5):
        raise ValueError(f"blaze_decode_blend: scale {scale} is not a power "
                         "of two")
    if exporting():
        return torch.ops.fdr.blaze_decode_blend(
            raw_boxes, raw_scores, anchors, float(scale), float(score_clip),
            float(score_thres), float(iou_thres), int(max_out))
    if raw_boxes.device.type == "cpu":
        return blaze_decode_blend_plain(raw_boxes, raw_scores, anchors, scale,
                                        score_clip, score_thres, iou_thres,
                                        max_out)
    _require_cuda("blaze_decode_blend", raw_boxes, raw_scores, anchors)
    b, n = raw_boxes.shape[:2]
    if any(t.dtype != torch.float32 for t in (raw_boxes, raw_scores, anchors)) \
            or raw_boxes.shape != (b, n, 16) \
            or raw_scores.shape != (b, n, 1) or anchors.shape != (n, 4):
        raise ValueError(f"blaze_decode_blend: f32 [B, N, 16], [B, N, 1] and "
                         f"[N, 4] expected, got {tuple(raw_boxes.shape)}, "
                         f"{tuple(raw_scores.shape)} and "
                         f"{tuple(anchors.shape)}")
    if n > BLAZE_MAX_ANCHORS or raw_boxes.data_ptr() % 16 \
            or anchors.data_ptr() % 16:
        raise ValueError(f"blaze_decode_blend: N = {n} (at most "
                         f"{BLAZE_MAX_ANCHORS}), or boxes or anchors not "
                         "16-byte aligned")
    out = torch.empty((b, max_out, 17), dtype=torch.float32,
                      device=raw_boxes.device)
    out_valid = torch.empty((b, max_out), dtype=torch.bool,
                            device=raw_boxes.device)
    err = _lib().blaze_decode_blend_launch(
        raw_boxes.data_ptr(), raw_scores.data_ptr(), anchors.data_ptr(),
        out.data_ptr(), out_valid.data_ptr(), b, n, float(scale),
        float(score_clip), float(score_thres), float(iou_thres), int(max_out),
        _stream(raw_boxes))
    _check(err, "blaze_decode_blend")
    _count("blaze_decode_blend")
    return out, out_valid


# ---------------- Q1: the int8 convolution of a quantized ConvBN ----------------

CONV_INT8_THREADS = 256  # csrc/conv_int8.cu's block size
CONV_INT8_KSTEP = 64     # codes of K a stage of csrc/conv_int8.cu
CONV_INT8_PARTS = 264    # the absmax pass's blocks: 2 an SM of 132


class _Q1LayerC(ctypes.Structure):
    """``struct Q1Layer`` of ``csrc/conv_int8.cu``: a layer's static
    arguments."""
    _fields_ = [("w", ctypes.c_void_p), ("wscale", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("ascale", ctypes.c_void_p),
                ("kpad", ctypes.c_int), ("C", ctypes.c_int),
                ("Cout", ctypes.c_int), ("k", ctypes.c_int),
                ("stride", ctypes.c_int), ("pad", ctypes.c_int),
                ("groups", ctypes.c_int), ("act", ctypes.c_int)]


class _Q1Layer:
    """What ``conv_int8`` checked of a layer's weights, scales and options
    for an input of C channels, kept on the packed weights
    (``wpack._q1_layer``) so that the next call with the same tensors
    checks only its input."""

    def __init__(self, c: int, wpack: torch.Tensor, wscale: torch.Tensor,
                 bias: torch.Tensor, k: int, stride: int, pad: int,
                 groups: int, act: Optional[str],
                 ascale: Optional[torch.Tensor]):
        extra = [ascale] if ascale is not None else []
        _require_cuda("conv_int8", wpack, wscale, bias, *extra)
        if wpack.dtype != torch.int8 \
                or any(t.dtype != torch.float32 for t in [wscale, bias, *extra]):
            raise ValueError("conv_int8: int8 weights and f32 scales and "
                             "bias expected")
        cout = wscale.shape[0]
        c4 = c + (-c) % 4
        if groups == 1:
            kpad = wpack.shape[1] if wpack.dim() == 2 else -1
            ok = wpack.dim() == 2 and wpack.shape[0] == cout \
                and kpad % CONV_INT8_KSTEP == 0 and kpad >= k * k * c4
        elif groups == c == cout:
            kpad = 0
            ok = tuple(wpack.shape) == (k * k, c4)
        else:
            raise ValueError(f"conv_int8: groups = {groups} with C = {c}, "
                             f"C_out = {cout}: only 1 or depthwise")
        if not ok or wscale.shape != (cout,) or bias.shape != (cout,) \
                or (ascale is not None and ascale.dim() != 0):
            raise ValueError(f"conv_int8: packed weights "
                             f"{tuple(wpack.shape)}, wscale "
                             f"{tuple(wscale.shape)}, bias "
                             f"{tuple(bias.shape)} do not fit k = {k}, C = "
                             f"{c}")
        self.key = (c, k, stride, pad, groups, act)
        self.tensors = (wscale, bias, ascale)
        self.device = wpack.device
        self.cout, self.dynamic = cout, ascale is None
        self.args = _Q1LayerC(
            wpack.data_ptr(), wscale.data_ptr(), bias.data_ptr(),
            ascale.data_ptr() if ascale is not None else None, kpad, c, cout,
            k, stride, pad, groups, 1 if act == "silu" else 0)
        self.ptr = ctypes.addressof(self.args)

    def fits(self, c, wscale, bias, k, stride, pad, groups, act, ascale):
        t = self.tensors
        return t[0] is wscale and t[1] is bias and t[2] is ascale \
            and self.key == (c, k, stride, pad, groups, act)


def _pixel_pitch(x: torch.Tensor) -> Optional[int]:
    """The pixel stride in floats of NCHW ``x`` read as NHWC, where its
    channels are adjacent and its pixels evenly spaced (channels-last, or a
    channel slice of a channels-last tensor: ``chunk`` on dim 1), so that
    Q1 reads it in place; else None."""
    b, c, h, w = x.shape
    sb, sc, sh, sw = x.stride()
    if sc == 1 and sh == w * sw and sb == h * sh \
            and (sw == c or (sw > c and sw % 4 == 0 and c % 4 == 0)):
        return sw
    return c if x.is_contiguous(memory_format=torch.channels_last) else None


def conv_int8(x: torch.Tensor, wpack: torch.Tensor, wscale: torch.Tensor,
              bias: torch.Tensor, k: int, stride: int, pad: int, groups: int,
              act: Optional[str], ascale: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """A quantized ConvBN on the int8 tensor cores (``csrc/conv_int8.cu``):
    with a static ``ascale`` one launch, the convolution quantizing its
    input as it loads it; with the dynamic scale two, the input's absmax
    first. No int8 scratch. Equal to ``ops.int8_conv.conv_int8_plain``:
    the pre-activation bit for bit, SiLU within a few ulp.

    x: [B, C, H, W] f32 on the card, read as NHWC in place when it is
    channels-last, or a channel slice of a channels-last tensor (its pixel
    stride passed to the kernel); any other layout, or a base not 16-byte
    aligned, is copied first; wpack: ``ops.int8_conv.pack_kernel_q(kernel_q,
    groups)`` of the [C_out, k, k, C / groups] int8 weights; wscale, bias:
    [C_out] f32; ascale: 0-d f32 or None; groups 1, or C == C_out
    (depthwise). The checks of everything but ``x`` are kept on ``wpack``
    for the next call with the same tensors. Returns [B, C_out, Ho, Wo] f32
    in the channels-last memory format."""
    if exporting():
        return torch.ops.fdr.conv_int8(x, wpack, wscale, bias, int(k),
                                       int(stride), int(pad), int(groups),
                                       act, ascale)
    b, c, h, w = x.shape
    layer = getattr(wpack, "_q1_layer", None)
    if layer is None or not layer.fits(c, wscale, bias, k, stride, pad,
                                       groups, act, ascale):
        layer = _Q1Layer(c, wpack, wscale, bias, k, stride, pad, groups, act,
                         ascale)
        wpack._q1_layer = layer
    if x.dtype != torch.float32 or x.device != layer.device:
        raise ValueError(f"conv_int8: an f32 input on {layer.device} "
                         f"expected, got {x.dtype} on {x.device}")
    xp = _pixel_pitch(x)
    if xp is None or x.data_ptr() % 16:
        x = x.contiguous(memory_format=torch.channels_last) \
            if xp is None else x.clone(memory_format=torch.channels_last)
        xp = c
    if b * h * w * xp >= 2 ** 31:
        raise ValueError("conv_int8: the input spans 2^31 elements or more")
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cout = layer.cout
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32,
                      device=layer.device, memory_format=torch.channels_last)
    stream = torch._C._cuda_getCurrentRawStream(layer.device.index)
    if layer.dynamic:
        nparts = max(1, min(CONV_INT8_PARTS,
                            -(-(b * h * w * c) // (CONV_INT8_THREADS * 16))))
        # the absmax partials, from the caching allocator and held until
        # both launches are queued: a buffer kept across calls would be
        # shared by host threads on one stream
        part = torch.empty(nparts, dtype=torch.float32, device=layer.device)
    else:
        nparts, part = 0, None
    err = _lib().conv_int8_launch(
        layer.ptr, x.data_ptr(), xp, out.data_ptr(), b, h, w,
        None if part is None else part.data_ptr(), nparts, stream)
    _check(err, "conv_int8")
    _count("conv_int8")
    return out


# ---------------- the operators of an exported program ----------------
#
# ``torch.export`` traces a program on fake tensors, which have no data
# pointer, so no wrapper can launch while a program is exported. Each
# kernel entry point is therefore also an operator of the ``fdr``
# namespace, which the wrapper calls instead while exporting
# (``exporting()``); outside an export the wrapper goes straight to its
# launch or plain version, with no dispatcher hop. An operator's CUDA
# implementation is the wrapper's launch (which counts in ``LAUNCHES``, and
# raises where the kernel does not build or launch), its CPU one the plain
# version, and its fake one gives the output shapes, dtypes and strides. A
# program that reloads an exported file needs this module imported, and
# nothing else of the package.


def _op(name: str):
    """Declare ``fdr::name`` from its CPU implementation, whose annotations
    give the schema."""
    return torch.library.custom_op(f"fdr::{name}", mutates_args=(),
                                   device_types="cpu")


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


@_op("nms_fixpoint")
def _nms_fixpoint_op(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thres: float, plus1: bool, strict: bool, mode: str
                     ) -> torch.Tensor:
    return nms_fixpoint_plain(boxes, valid, iou_thres, plus1, strict, mode)


_nms_fixpoint_op.register_kernel("cuda")(nms_fixpoint)
_nms_fixpoint_op.register_fake(
    lambda boxes, valid, *_: _empty(valid.shape, torch.bool, valid))


def _nested_layout(anchors: List[float], strides: List[int],
                   input_size: List[int]):
    """``candidate_decode``'s (anchors, strides, input_size) tuples from the
    operator's flat lists: anchors as (w, h) pairs, level by level."""
    per = len(anchors) // (2 * max(1, len(strides)))
    pairs = [tuple(anchors[i:i + 2]) for i in range(0, len(anchors), 2)]
    return (tuple(tuple(pairs[lv * per:(lv + 1) * per])
                  for lv in range(len(strides))),
            tuple(strides), tuple(input_size))


@_op("candidate_decode")
def _candidate_decode_op(maps_flat: List[torch.Tensor], idx: torch.Tensor,
                         anchors: List[float], strides: List[int],
                         input_size: List[int], conf_thres: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return candidate_decode_plain(
        maps_flat, idx, *_nested_layout(anchors, strides, input_size),
        conf_thres)


@_candidate_decode_op.register_kernel("cuda")
def _(maps_flat, idx, anchors, strides, input_size, conf_thres):
    return candidate_decode(maps_flat, idx,
                            *_nested_layout(anchors, strides, input_size),
                            conf_thres)


@_candidate_decode_op.register_fake
def _(maps_flat, idx, *_):
    (b, k), no = idx.shape, maps_flat[0].shape[-1]
    return (_empty((b, k, no), torch.float32, idx),
            _empty((b, k, 4), torch.float32, idx),
            _empty((b, k), torch.bool, idx))


@_op("crop_resize")
def _crop_resize_op(img: torch.Tensor, boxes: torch.Tensor,
                    valid: torch.Tensor, out_hw: List[int], clamp: bool,
                    clip: bool, mean: Optional[List[float]],
                    out_dtype: torch.dtype) -> torch.Tensor:
    return crop_resize_plain(img, boxes, valid, tuple(out_hw), clamp, clip,
                             mean, out_dtype)


@_crop_resize_op.register_kernel("cuda")
def _(img, boxes, valid, out_hw, clamp, clip, mean, out_dtype):
    return crop_resize(img, boxes, valid, tuple(out_hw), clamp, clip, mean,
                       out_dtype)


@_crop_resize_op.register_fake
def _(img, boxes, valid, out_hw, clamp, clip, mean, out_dtype):
    return _empty((*boxes.shape[:2], *out_hw, img.shape[-1]), out_dtype, img)


@_op("topk_gallery")
def _topk_gallery_op(queries: torch.Tensor, gallery: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return topk_gallery_plain(queries, gallery, k)


_topk_gallery_op.register_kernel("cuda")(topk_gallery)
_topk_gallery_op.register_fake(
    lambda q, g, k: (_empty((q.shape[0], k), torch.float32, q),
                     _empty((q.shape[0], k), torch.int32, q)))


@_op("blend_nms")
def _blend_nms_op(sdets: torch.Tensor, svalid: torch.Tensor,
                  iou_thres: float, max_out: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return blend_nms_plain(sdets, svalid, iou_thres, max_out)


_blend_nms_op.register_kernel("cuda")(blend_nms)
_blend_nms_op.register_fake(
    lambda sdets, svalid, iou_thres, max_out: (
        _empty((sdets.shape[0], max_out, sdets.shape[2]), torch.float32,
               sdets),
        _empty((sdets.shape[0], max_out), torch.bool, sdets)))


@_op("blaze_decode_blend")
def _blaze_decode_blend_op(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                           anchors: torch.Tensor, scale: float,
                           score_clip: float, score_thres: float,
                           iou_thres: float, max_out: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    return blaze_decode_blend_plain(raw_boxes, raw_scores, anchors, scale,
                                    score_clip, score_thres, iou_thres,
                                    max_out)


_blaze_decode_blend_op.register_kernel("cuda")(blaze_decode_blend)
_blaze_decode_blend_op.register_fake(
    lambda raw_boxes, *args: (
        _empty((raw_boxes.shape[0], args[-1], 17), torch.float32, raw_boxes),
        _empty((raw_boxes.shape[0], args[-1]), torch.bool, raw_boxes)))


@_op("conv_int8")
def _conv_int8_op(x: torch.Tensor, wpack: torch.Tensor, wscale: torch.Tensor,
                  bias: torch.Tensor, k: int, stride: int, pad: int,
                  groups: int, act: Optional[str],
                  ascale: Optional[torch.Tensor]) -> torch.Tensor:
    """Q1's plain version on its own arguments, in the kernel's
    channels-last layout (the values do not depend on it)."""
    from .int8_conv import conv_int8_packed_plain  # it imports this module

    return conv_int8_packed_plain(x, wpack, wscale, bias, k, stride, pad,
                                  groups, act, ascale).contiguous(
        memory_format=torch.channels_last)


_conv_int8_op.register_kernel("cuda")(conv_int8)


@_conv_int8_op.register_fake
def _(x, wpack, wscale, bias, k, stride, pad, groups, act, ascale):
    b, _, h, w = x.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    return torch.empty((b, wscale.shape[0], ho, wo), dtype=torch.float32,
                       device=x.device, memory_format=torch.channels_last)
