"""Batched face crop + bilinear resize on the device.

The counterpart of ``ops/crop.py`` in the JAX package: each xyxy box of a
frame becomes a fixed-size crop, sampled with half-pixel centres like
cv2.resize(INTER_LINEAR) applied to the integer-cropped region. The JAX
package picked one of three formulations per platform (gather, GEMM, Pallas
GEMM); here there is one per box semantics, ``ops.cuda_kernels.crop_resize``,
which launches the CUDA kernel for CUDA tensors and runs its plain version
for CPU tensors.

The crop functions take one frame [H, W, C] with boxes [K, 4] (and valid
[K]), or a batch [B, H, W, C] with [B, K, 4] (and [B, K]).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_kernels import crop_resize

# the reference's feature-extraction crop offsets (x1, y1, x2, y2)
EXTRACTION_OFFSETS = (-6.0, -1.0, 4.0, 5.0)


def extraction_crop_region(box, w: int, h: int):
    """Integer (x1, y1, x2, y2) crop region for saved artifacts: the
    reference's offsets clipped to the frame. Slice ends are EXCLUSIVE, so
    the clip bound is w/h, not w-1/h-1, which would drop the last pixel
    column/row of edge-touching faces."""
    x1, y1, x2, y2 = (int(v) for v in box)
    ox1, oy1, ox2, oy2 = (int(v) for v in EXTRACTION_OFFSETS)
    return (max(0, x1 + ox1), max(0, y1 + oy1),
            min(w, x2 + ox2), min(h, y2 + oy2))


def _crop(img: torch.Tensor, boxes, out_hw: Tuple[int, int],
          valid: Optional[torch.Tensor], clamp: bool, clip: bool = False,
          mean: Optional[Tuple[float, ...]] = None,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    single = img.dim() == 3
    if single:
        img = img[None]
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=img.device)
    if single:
        boxes = boxes[None]
    if valid is None:
        valid = torch.ones(boxes.shape[:2], dtype=torch.bool,
                           device=img.device)
    else:
        valid = valid.to(device=img.device, dtype=torch.bool)
        if single:
            valid = valid[None]
    if img.dtype not in (torch.uint8, torch.float32):
        img = img.float()
    out = crop_resize(img.contiguous(), boxes.contiguous(),
                      valid.contiguous(), tuple(out_hw), clamp, clip, mean,
                      out_dtype)
    return out[0] if single else out


def crop_and_resize(img: torch.Tensor, boxes, out_hw: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Crop each xyxy box from ``img`` and bilinearly resize it to
    ``out_hw`` (height, width). Boxes are floored to integers and clamped
    to the frame, like python slicing in the reference; samples stay inside
    the box. Invalid slots come back as zeros.

    img: [H, W, C] or [B, H, W, C], uint8 or float; boxes: [K, 4] or
    [B, K, 4]. Returns [K, oh, ow, C] or [B, K, oh, ow, C] float32."""
    return _crop(img, boxes, out_hw, valid, clamp=True)


def crop_and_resize_padded(img: torch.Tensor, boxes,
                           out_hw: Tuple[int, int],
                           valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Like ``crop_and_resize``, but boxes may extend beyond the frame and
    samples that fall outside it read ZERO instead of clamping: MTCNN's
    ``pad`` semantics (the out-of-bounds region is placed into a zero
    canvas before resizing)."""
    return _crop(img, boxes, out_hw, valid, clamp=False)


def crop_for_net(img: torch.Tensor, boxes, out_hw: Tuple[int, int],
                 valid: Optional[torch.Tensor] = None, clip: bool = True,
                 mean: Optional[Tuple[float, ...]] = None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``crop_and_resize`` followed by what the engine does to crops
    before a net reads them, fused into the kernel's store: ``clip`` clamps
    to [0, 255], then ``mean`` (one float a channel) is subtracted. Equal
    bit for bit to the three steps run apart; invalid slots come out as
    ``-mean`` (0 without a mean). ``out_dtype`` bfloat16 stores the bf16
    engine's age/gender input: the clipped crop cast to bf16, widened, less
    the mean, cast to bf16 again."""
    return _crop(img, boxes, out_hw, valid, clamp=True, clip=clip, mean=mean,
                 out_dtype=out_dtype)


def pad_boxes(boxes: torch.Tensor, offsets: Tuple[float, float, float, float],
              img_wh: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Apply per-corner crop offsets (e.g. EXTRACTION_OFFSETS or the
    age/gender (-5, -5, +5, +5) padding); optionally clamp to the frame."""
    kw = dict(dtype=boxes.dtype, device=boxes.device)
    out = boxes + torch.tensor(offsets, **kw)
    if img_wh is not None:
        w, h = img_wh
        out = torch.clamp(out, torch.zeros(4, **kw),
                          torch.tensor([w - 1, h - 1, w - 1, h - 1], **kw))
    return out
