"""Geometry: letterbox resize, coordinate rescaling and per-image
standardization on NHWC tensors.

The counterpart of ``ops/geometry.py`` in the JAX package. Bilinear
resampling matches ``jax.image.resize(method="linear", antialias=False)``
(cv2 INTER_LINEAR semantics: half-pixel centres, no antialias): the 1-D
operator is rebuilt here in numpy float32 with the same operations, and each
axis is one matrix product with it. The JAX package cut that product into
banded row blocks for the TPU's matrix unit; the port multiplies by the
whole matrix, whose extra terms are exact zeros.

On the host, ``host_resize`` is the ``cv2.resize(img, (w, h))`` slot for
uint8 images (INTER_LINEAR in cv2's fixed point, and its exact-2x case as
INTER_AREA), and ``host_letterbox`` letterboxes with it.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

Color = Tuple[float, float, float]

GRAY_FILL: Color = (125.0, 125.0, 125.0)  # reference letterbox fill (BGR)


def make_divisible(x: int, divisor: int) -> int:
    """Round ``x`` up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def rect_letterbox_size(in_hw: Tuple[int, int], max_wh: Tuple[int, int],
                        stride: int) -> Tuple[int, int]:
    """Smallest stride-multiple (w, h) canvas that letterboxes ``in_hw`` at
    the square ``max_wh`` box's scale (rect inference): the resized interior
    is the square letterbox's, only the constant padding shrinks."""
    in_h, in_w = in_hw
    mw, mh = max_wh
    scale = min(mw / in_w, mh / in_h)
    new_w, new_h = int(in_w * scale), int(in_h * scale)
    return (min(make_divisible(new_w, stride), mw),
            min(make_divisible(new_h, stride), mh))


def letterbox_params(in_hw: Tuple[int, int], out_hw: Tuple[int, int]
                     ) -> Tuple[float, int, int, int, int]:
    """Letterbox geometry: (scale, new_h, new_w, pad_top, pad_left), with
    int() truncation of the scaled sides and floor on the top/left pad."""
    in_h, in_w = in_hw
    out_h, out_w = out_hw
    scale = min(out_w / in_w, out_h / in_h)
    new_w, new_h = int(in_w * scale), int(in_h * scale)
    d_w, d_h = max(out_w - new_w, 0), max(out_h - new_h, 0)
    return scale, new_h, new_w, d_h // 2, d_w // 2


@functools.lru_cache(maxsize=256)
def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The [n_out, n_in] float32 linear resample operator of
    ``jax.image.resize`` (``compute_weight_mat`` with a triangle kernel,
    scale n_out / n_in, no translation, no antialias), step for step."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    weights = np.maximum(f32(0.0), f32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(n_in - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0))
    return np.ascontiguousarray(weights.T.astype(f32))


@functools.lru_cache(maxsize=64)
def _resample_weights(n_in: int, n_out: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """``_resample_matrix`` on ``device``: built once per geometry, not per
    call."""
    return torch.from_numpy(_resample_matrix(n_in, n_out)).to(device=device,
                                                              dtype=dtype)


def _resample_axis(x: torch.Tensor, n_out: int, axis: int,
                   dtype=None) -> torch.Tensor:
    """Linear-resample the H or W axis of ``x`` [..., H, W, C] to ``n_out``
    samples. The input is cast to ``dtype`` (default: its own) before the
    product."""
    dtype = x.dtype if dtype is None else dtype
    n_in = x.shape[axis]
    if n_out == n_in:
        return x.to(dtype)
    w = _resample_weights(n_in, n_out, x.device, dtype)
    x = x.to(dtype)
    h, wd, c = x.shape[-3:]
    if axis == x.ndim - 3:   # out[.., o, w, c] = sum_i W[o, i] x[.., i, w, c]
        y = torch.matmul(w, x.reshape(-1, h, wd * c))
        return y.reshape(*x.shape[:-3], w.shape[0], wd, c)
    if axis == x.ndim - 2:   # out[.., h, o, c] = sum_i W[o, i] x[.., h, i, c]
        # one GEMM with (.., h, c) folded into its rows: a batch of
        # [c, W] x [W, o] products (c = 3) would run at a few % of peak
        y = x.transpose(-1, -2).reshape(-1, wd) @ w.T
        return y.reshape(*x.shape[:-2], c, w.shape[0]).transpose(-1, -2) \
            .contiguous()
    raise ValueError("resample axis must be H or W of [..., H, W, C]")


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int],
                    dtype=torch.float32) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] (uint8 or float) to ``out_hw``, with
    cv2.INTER_LINEAR semantics (no antialiasing), in ``dtype``."""
    x = _resample_axis(img, out_hw[0], img.ndim - 3, dtype)
    return _resample_axis(x, out_hw[1], x.ndim - 2, dtype)


def _linear_taps(n_in: int, n_out: int, clamp: bool):
    """cv2's INTER_LINEAR taps of one axis: (first source index, second,
    weight of the first, weight of the second), weights in 11-bit fixed
    point. The source coordinate is ``(d + 0.5) / scale - 0.5`` rounded to
    f32 and each weight is rounded on its own. Columns (``clamp``) past an
    edge take the edge pixel with the full weight; rows keep their
    fractional weights and read the edge row twice."""
    scale = 1.0 / (n_out / n_in)   # cv2's double scale_x
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        out = (s < 0) | (s >= n_in - 1)
        f[out] = 0.0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1)


def host_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` for a uint8 [H, W] or [H, W, C] image, with
    ``size`` = (width, height), equal to cv2's INTER_LINEAR bit for bit:
    11-bit weights, int32 sums across the row, then down the column cv2's
    SIMD rounding ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2 >>
    2``. An exact 2x reduction of both sides is cv2's INTER_AREA, the
    rounded mean of each 2x2 block."""
    dw, dh = int(size[0]), int(size[1])
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or dw < 1 or dh < 1:
        raise ValueError(f"host_resize takes a uint8 [H, W(, C)] image and a "
                         f"positive (w, h); got {img.dtype} {img.shape}, "
                         f"{size}")
    sh, sw = img.shape[:2]
    if (sh, sw) == (dh, dw):
        return img.copy()
    x = img.reshape(sh, sw, -1).astype(np.int32)
    if (sh, sw) == (2 * dh, 2 * dw):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        out = (s + 2) >> 2
    else:
        y0, y1, b0, b1 = _linear_taps(sh, dh, clamp=False)
        rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
        x0, x1, a0, a1 = _linear_taps(sw, dw, clamp=True)
        xr = x[rows]
        hsum = xr[:, x0] * a0[:, None] + xr[:, x1] * a1[:, None]
        s0, s1 = hsum[inv[:dh]], hsum[inv[dh:]]
        out = ((((s0 >> 4) * b0[:, None, None]) >> 16)
               + (((s1 >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (dh, dw) + img.shape[2:])


def host_letterbox(img: np.ndarray, out_hw: Tuple[int, int],
                   fill: Color = GRAY_FILL) -> np.ndarray:
    """Letterbox a BGR uint8 frame on the host into a uint8 [out_h, out_w,
    3] canvas: ``letterbox_params``' geometry, ``host_resize`` inside,
    ``fill`` around, as the JAX package's ``host_letterbox`` (with
    cv2.resize) builds its blocks."""
    out_h, out_w = out_hw
    _, sh, sw, top, left = letterbox_params(img.shape[:2], (out_h, out_w))
    canvas = np.full((out_h, out_w, 3), np.asarray(fill, np.uint8), np.uint8)
    canvas[top:top + sh, left:left + sw] = host_resize(img, (sw, sh))
    return canvas


def clip_coords(boxes: torch.Tensor, img_hw: Tuple[int, int]) -> torch.Tensor:
    """Clip the 4 box coords to image bounds; landmark columns (4 on) pass
    through unclipped."""
    h, w = img_hw
    d = boxes.shape[-1]
    nb = min(d, 4)
    hi = [float(w) if i % 2 == 0 else float(h) for i in range(nb)]
    hi += [math.inf] * (d - nb)
    lo = [0.0] * nb + [-math.inf] * (d - nb)
    kw = dict(dtype=boxes.dtype, device=boxes.device)
    return torch.clamp(boxes, torch.tensor(lo, **kw), torch.tensor(hi, **kw))


def scale_coords(model_hw: Tuple[int, int], coords: torch.Tensor,
                 orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Rescale xyxy(+landmark) coords [..., D] (alternating x/y columns) from
    letterboxed model space to the original image, undoing the padding, and
    clip the boxes to it."""
    gain = min(model_hw[0] / orig_hw[0], model_hw[1] / orig_hw[1])
    pad = ((model_hw[1] - orig_hw[1] * gain) / 2,
           (model_hw[0] - orig_hw[0] * gain) / 2)
    d = coords.shape[-1]
    shift = torch.tensor([pad[i % 2] for i in range(d)], dtype=coords.dtype,
                         device=coords.device)
    return clip_coords((coords - shift) / gain, orig_hw)


def standardize_image(img: torch.Tensor) -> torch.Tensor:
    """Per-image standardization, FaceNet's "prewhiten": (x - mean) /
    max(std, 1 / sqrt(n)) with the mean and the (population) std of each
    image over all its n pixels and channels. Takes [H, W, C] or
    [B, H, W, C]; returns float32."""
    img = img.float()
    if img.dim() not in (3, 4):
        raise ValueError("Dimension should be 3 or 4")
    dims = tuple(range(img.dim() - 3, img.dim()))
    size = img.shape[-3] * img.shape[-2] * img.shape[-1]
    mean = img.mean(dim=dims, keepdim=True)
    std = img.std(dim=dims, keepdim=True, correction=0)
    std_adj = torch.clamp(std, min=1.0 / math.sqrt(size))
    return (img - mean) / std_adj
