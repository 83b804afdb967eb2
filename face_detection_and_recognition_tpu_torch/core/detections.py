"""The Detections contract: fixed-size, masked detection tensors.

The counterpart of ``core/detections.py`` in the JAX package: detections of
a batch are [B, K, ...] tensors plus a validity mask, and the threshold ->
area filter -> un-letterbox chain runs on them as masked tensor ops. Ragged
numpy appears only at the host boundary (``to_numpy``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..ops.geometry import scale_coords


@dataclasses.dataclass(frozen=True)
class Detections:
    """Fixed-size detections for a batch of images.

    Attributes:
        boxes: [B, K, 4] xyxy in ORIGINAL image pixels (after postprocess) or
            normalized [0, 1] model space (before).
        scores: [B, K] confidences.
        lmarks: [B, K, L] flattened landmark x/y pairs (L may be 0).
        areas: [B, K] bbox area as a fraction of the model input area.
        valid: [B, K] bool mask — True rows are real detections.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    lmarks: torch.Tensor
    areas: torch.Tensor
    valid: torch.Tensor

    @property
    def batch(self) -> int:
        return self.boxes.shape[0]

    @property
    def max_det(self) -> int:
        return self.boxes.shape[1]

    def to_numpy(self) -> List["PostProcessedDetection"]:
        """Host boundary: strip padding into per-image ragged results."""
        boxes, scores, lmarks, areas, valid = (
            t.cpu().numpy() for t in (self.boxes, self.scores, self.lmarks,
                                      self.areas, self.valid))
        out = []
        for i in range(boxes.shape[0]):
            m = valid[i]
            out.append(PostProcessedDetection(
                boxes=boxes[i][m],
                bbox_confs=scores[i][m],
                bbox_areas=areas[i][m],
                bbox_lmarks=lmarks[i][m] if lmarks.shape[-1] else None,
            ))
        return out


class PostProcessedDetection:
    """Per-image ragged result, API-compatible with the reference's
    ``PostProcessedDetection``."""

    __slots__ = ["boxes", "bbox_confs", "bbox_areas", "bbox_lmarks",
                 "bbox_labels"]

    def __init__(self, boxes: np.ndarray, bbox_confs: np.ndarray,
                 bbox_areas: np.ndarray,
                 bbox_lmarks: Optional[np.ndarray] = None,
                 bbox_labels: Optional[List[Any]] = None):
        self.boxes = boxes
        self.bbox_confs = bbox_confs
        self.bbox_areas = bbox_areas
        self.bbox_lmarks = bbox_lmarks
        self.bbox_labels = bbox_labels

    def __len__(self) -> int:
        return len(self.boxes)


def postprocess_detections(dets: torch.Tensor, valid: torch.Tensor,
                           orig_size: Tuple[int, int],
                           in_size: Tuple[int, int], det_thres: float,
                           bbox_area_thres: float, do_round: bool = True
                           ) -> Detections:
    """Threshold, area filter and un-letterbox.

    Args:
        dets: [B, K, 4+L+1] rows [xyxy, lmarks..., conf] normalized to [0, 1]
            wrt the model input size.
        valid: [B, K] bool.
        orig_size: original image (width, height).
        in_size: model input (width, height).
        det_thres: confidence threshold (strict >).
        bbox_area_thres: minimum bbox area as a PERCENT of the input area.
    Returns:
        Detections with boxes/lmarks in original-image pixels.
    """
    w, h = orig_size
    iw, ih = in_size
    ncoord = dets.shape[-1] - 1
    conf = dets[..., -1]
    coords = dets[..., :-1] * torch.tensor([iw, ih] * (ncoord // 2),
                                           dtype=torch.float32,
                                           device=dets.device)
    bbox_area = (coords[..., 2] - coords[..., 0]) * \
        (coords[..., 3] - coords[..., 1])
    area_perc = bbox_area / float(iw * ih)
    keep = valid & (conf > det_thres) & (100.0 * area_perc > bbox_area_thres)
    coords = scale_coords((ih, iw), coords, (h, w))
    if do_round:
        coords = torch.round(coords)
    return Detections(boxes=coords[..., :4], scores=conf,
                      lmarks=coords[..., 4:], areas=area_perc, valid=keep)
