"""Box arithmetic: format conversion, batched and single IoU, as
``ops/boxes.py`` of the JAX package computes them, and BlazeFace's anchor
decode, as its ``models/blazeface.py`` does (same operation order, so the
same f32 results)."""
from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] center-size -> corner format."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def box_area(boxes: torch.Tensor, plus1: bool = False) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes; ``plus1`` adds the legacy +1px convention."""
    off = 1.0 if plus1 else 0.0
    return (boxes[..., 2] - boxes[..., 0] + off) * \
        (boxes[..., 3] - boxes[..., 1] + off)


def iou_matrix(a: torch.Tensor, b: torch.Tensor, plus1: bool = False,
               eps: float = 0.0) -> torch.Tensor:
    """Pairwise IoU between xyxy boxes a [..., N, 4] and b [..., M, 4] ->
    [..., N, M]. ``plus1`` is the yolov5-face convention (+1 px on
    intersections and areas, eps 1e-16)."""
    off = 1.0 if plus1 else 0.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt + off).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, plus1)[..., :, None] + \
        box_area(b, plus1)[..., None, :] - inter
    return inter / (union + eps) if eps else inter / union


def decode_boxes(raw_boxes: torch.Tensor, anchors: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """BlazeFace's anchor decode: [..., 896, 16] rows [ymin, xmin, ymax,
    xmax, kp0x, kp0y, ... kp5x, kp5y] in normalized units."""
    ax, ay = anchors[:, 0], anchors[:, 1]
    aw, ah = anchors[:, 2], anchors[:, 3]
    x_c = raw_boxes[..., 0] / scale * aw + ax
    y_c = raw_boxes[..., 1] / scale * ah + ay
    w = raw_boxes[..., 2] / scale * aw
    h = raw_boxes[..., 3] / scale * ah
    cols = [y_c - h / 2.0, x_c - w / 2.0, y_c + h / 2.0, x_c + w / 2.0]
    for k in range(6):
        off = 4 + k * 2
        cols.append(raw_boxes[..., off] / scale * aw + ax)
        cols.append(raw_boxes[..., off + 1] / scale * ah + ay)
    return torch.stack(cols, dim=-1)


def iou_single(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Scalar IoU between two xyxy boxes with the reference's exact
    no-intersection semantics (``image.py:124-143``): 0 when either axis
    overlap is strictly negative; touching boxes intersect with zero
    area."""
    x_diff = torch.minimum(box1[2], box2[2]) - torch.maximum(box1[0], box2[0])
    y_diff = torch.minimum(box1[3], box2[3]) - torch.maximum(box1[1], box2[1])
    inter = x_diff * y_diff
    union = ((box1[2] - box1[0]) * (box1[3] - box1[1])
             + (box2[2] - box2[0]) * (box2[3] - box2[1]) - inter)
    iou = inter / union
    return torch.where((x_diff < 0) | (y_diff < 0), torch.zeros_like(iou),
                       iou)
