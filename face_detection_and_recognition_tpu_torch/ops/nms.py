"""Greedy hard NMS, its class-offset multiclass form and BlazeFace's
weighted-blend NMS over fixed-size, masked detections.

The counterpart of ``ops/nms.py`` in the JAX package. Detections stay at a
static K with a validity mask; the keep mask comes from ``nms_fixpoint`` and
the blended rows from ``blend_nms`` (the CUDA kernels for CUDA tensors, their
plain versions on the CPU). Functions take one image ([K, ...]) or a batch
([B, K, ...]).

``jnp.argsort`` is stable, and ties decide greedy NMS, so every sort here is
``stable=True``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda_kernels import blend_nms, nms_fixpoint

NEG_INF = -1e30


def _take_rows(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    idx = order.reshape(order.shape + (1,) * (a.dim() - order.dim()))
    return torch.take_along_dim(a, idx, dim=order.dim() - 1)


def sort_by_score(scores: torch.Tensor, valid: torch.Tensor,
                  *arrays: torch.Tensor, top=None):
    """Sort descending by score along the last axis of ``scores``, invalid
    entries pushed to the end, ties in input order.

    Returns (order, sorted_scores, sorted_valid, *sorted_arrays); ``top``
    keeps only the first ``top`` rows."""
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.argsort(-masked, dim=-1, stable=True)
    if top is not None:
        order = order[..., :top]
    out = tuple(_take_rows(a, order) for a in arrays)
    return (order, _take_rows(masked, order), _take_rows(valid, order)) + out


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of the last axis and their indices, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (``torch.topk`` on CUDA promises no order among ties)."""
    idx = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.take_along_dim(x, idx, -1), idx


def greedy_nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, iou_thres: float, plus1: bool = False,
                    strict: bool = True, mode: str = "union") -> torch.Tensor:
    """Greedy hard NMS keep mask, in the ORIGINAL input order.

    boxes: [(B,) K, 4] xyxy; scores, valid: [(B,) K]. ``plus1`` is the +1 px
    IoU convention; ``strict`` suppresses iou > thres (else >=); ``mode`` is
    "union" (jaccard) or "min" (inter / min(area))."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    order, _, svalid, sboxes = sort_by_score(scores, valid, boxes)
    keep_sorted = nms_fixpoint(sboxes.contiguous(), svalid.contiguous(),
                               iou_thres, plus1=plus1, strict=strict,
                               mode=mode)
    keep = torch.zeros_like(valid).scatter(-1, order, keep_sorted)
    return keep[0] if single else keep


def greedy_nms(dets: torch.Tensor, valid: torch.Tensor, iou_thres: float,
               max_out: int, score_col: int = -1, plus1: bool = False,
               strict: bool = True, mode: str = "union"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard NMS returning a fixed [(B,) max_out, D] block sorted by score.

    dets: [(B,) K, D] rows whose first 4 cols are xyxy and ``score_col`` is
    the ranking score. Returns (out, out_valid)."""
    scores = dets[..., score_col]
    keep = greedy_nms_mask(dets[..., :4], scores, valid, iou_thres,
                           plus1=plus1, strict=strict, mode=mode)
    _, _, kvalid, kdets = sort_by_score(scores, keep, dets, top=max_out)
    return kdets, kvalid


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float, max_out: int = 300,
                   agnostic: bool = False, max_wh: float = 4096.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Torchvision-style batched NMS by the class-offset trick (the
    reference's ``onnx_utils.py:266-271``): the boxes of class c are
    shifted by c * ``max_wh``, so that one class-agnostic pass (strict IoU,
    no +1 px) never suppresses across classes.

    boxes: [(B,) K, 4] xyxy; scores, valid: [(B,) K]; classes: [(B,) K]
    int. Returns (dets [(B,) max_out, 6] rows [xyxy, conf, cls] sorted by
    score, out_valid [(B,) max_out], keep [(B,) K] in input order)."""
    cls_f = classes.to(boxes.dtype)
    offset = torch.zeros_like(scores) if agnostic else cls_f * max_wh
    keep = greedy_nms_mask(boxes + offset[..., None], scores, valid,
                           iou_thres, strict=True)
    dets = torch.cat([boxes, scores[..., None], cls_f[..., None]], -1)
    _, _, kvalid, kdets = sort_by_score(scores, keep, dets, top=max_out)
    return kdets, kvalid, keep


def weighted_blend_nms(dets: torch.Tensor, valid: torch.Tensor,
                       iou_thres: float = 0.3, max_out: int = 16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BlazeFace weighted-blend NMS (the reference's ``blazeface.py:404-458``).

    Each output row is the score-weighted mean of the remaining detections
    whose IoU with the current best one exceeds ``iou_thres`` (the best one
    always included), with the mean of their scores as its confidence; a
    lone detection is kept as it is.

    dets: [(B,) K, D] f32 rows [coords..., score], score LAST, every coord
    blended, cols 0:4 a box ([ymin, xmin, ymax, xmax]); valid: [(B,) K].
    Returns (out [(B,) max_out, D], out_valid [(B,) max_out]): zero rows
    with valid False past the last pick, also when K < max_out."""
    single = dets.dim() == 2
    if single:
        dets, valid = dets[None], valid[None]
    _, _, svalid, sdets = sort_by_score(dets[..., -1], valid, dets)
    out, out_valid = blend_nms(sdets.contiguous(), svalid.contiguous(),
                               iou_thres, max_out)
    return (out[0], out_valid[0]) if single else (out, out_valid)
