"""Image preprocessing from a declarative recipe, on batched NHWC tensors.

The counterpart of ``ops/preprocess.py`` in the JAX package. Frames come in
as [B, H, W, 3] BGR (uint8 or float) and leave as [B, h, w, 3] model input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .geometry import (GRAY_FILL, letterbox_params, resize_bilinear,
                       standardize_image)


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    """Declarative preprocessing recipe.

    Attributes:
        size: model input (width, height); None keeps the input resolution.
        resize: "letterbox" (aspect-preserving pad), "stretch", or "none".
        bgr_to_rgb: swap channel order before normalization.
        scale: multiplicative factor applied after mean subtraction.
        mean: per-channel mean subtracted (in the post-swap channel order).
        std: per-channel divisor (after scale), or None.
        standardize: apply per-image prewhitening instead of mean/scale.
        fill: letterbox fill color (pre-swap order, like the reference's BGR).
    """

    size: Optional[Tuple[int, int]] = None
    resize: str = "letterbox"
    bgr_to_rgb: bool = False
    scale: float = 1.0
    mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    std: Optional[Tuple[float, float, float]] = None
    standardize: bool = False
    fill: Tuple[float, float, float] = GRAY_FILL


YOLOV5_FACE = PreprocessSpec(size=(640, 640), bgr_to_rgb=True, scale=1 / 255.0)
BLAZEFACE_FRONT = PreprocessSpec(
    size=(128, 128), bgr_to_rgb=True, scale=1 / 127.5,
    mean=(127.5, 127.5, 127.5)
)
BLAZEFACE_BACK = dataclasses.replace(BLAZEFACE_FRONT, size=(256, 256))
# the OpenCV SSD's blobFromImage mean subtraction (opencv2_dnn/model.py:30-32)
# on a 300x300 letterbox, as the JAX package's recipe places it
OPENCV_SSD = PreprocessSpec(size=(300, 300), mean=(104.0, 117.0, 123.0))
# OpenVINO's detectors (OVModel.__call__, openvino/model.py:44-49): a
# letterbox to the IR's input size on raw BGR values, no mean, no scaling
OPENVINO = PreprocessSpec(size=(448, 448))
AGE_GENDER = PreprocessSpec(
    size=(227, 227),
    resize="stretch",
    mean=(78.4263377603, 87.7689143744, 114.895847746),
)
MOBILE_FACENET = PreprocessSpec(
    size=(112, 112), resize="stretch", scale=1 / 127.5,
    mean=(127.5, 127.5, 127.5)
)
FACENET = PreprocessSpec(size=(160, 160), resize="stretch", standardize=True)


def _normalize(x: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    if spec.bgr_to_rgb:
        x = x.flip(-1)
    if spec.standardize:
        return standardize_image(x)  # per image, f32
    kw = dict(dtype=x.dtype, device=x.device)
    x = (x - torch.tensor(spec.mean, **kw)) * torch.tensor(spec.scale, **kw)
    if spec.std is not None:
        x = x / torch.tensor(spec.std, **kw)
    return x


def apply_preprocess_batch(imgs: torch.Tensor, spec: PreprocessSpec,
                           dtype=torch.float32) -> torch.Tensor:
    """Preprocess [B, H, W, 3] same-sized BGR images -> [B, h, w, 3].

    The letterbox resizes the interior, places it on a canvas of the fill
    colour and normalizes the whole canvas. Mean and scale are elementwise,
    so this equals the JAX package's normalize-then-place order value for
    value; ``standardize`` takes its statistics over the whole canvas, the
    JAX package's pad-then-normalize order for that case."""
    if spec.size is not None and spec.resize == "letterbox":
        w, h = spec.size
        b, in_h, in_w = imgs.shape[:3]
        _, sc_h, sc_w, top, left = letterbox_params((in_h, in_w), (h, w))
        canvas = torch.empty((b, h, w, 3), dtype=dtype, device=imgs.device)
        canvas.copy_(torch.tensor(spec.fill, dtype=dtype, device=imgs.device))
        canvas[:, top:top + sc_h, left:left + sc_w] = \
            resize_bilinear(imgs, (sc_h, sc_w), dtype=dtype)
        return _normalize(canvas, spec)
    if spec.size is not None and spec.resize == "stretch" \
            and tuple(imgs.shape[1:3]) != (spec.size[1], spec.size[0]):
        x = resize_bilinear(imgs, (spec.size[1], spec.size[0]), dtype=dtype)
    else:
        x = imgs.to(dtype)
    return _normalize(x, spec)
