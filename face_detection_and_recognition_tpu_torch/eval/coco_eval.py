"""COCO-style detection evaluation (AP / AR) of a detector on WIDER-format
annotations, without pycocotools.

The counterpart of ``eval/coco_eval.py`` in the JAX package, which replaces
the reference's pycocotools dependency (``eval/eval_face_detector.py:72-78``)
with a numpy implementation of the COCO bbox protocol: 101-point
interpolated AP over IoU thresholds .50:.05:.95, plus AR@maxdets, the
metrics the reference reports for WIDER-FACE
(``eval_face_detector.py:170-196``). The metrics are host numpy, the same
code as the JAX package's; ``evaluate_engine_on_wider`` drives the port's
``FaceEngine`` (on the card unless it was built for the CPU), decoding with
the port's image reader and letterboxing with its ``host_letterbox``.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..ops.geometry import host_letterbox
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr

logger = logging.getLogger("face_eval")

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """IoU matrix between [N,4] and [M,4] xywh boxes."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    d = dets.astype(np.float64)
    g = gts.astype(np.float64)
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix1 = np.maximum(d[:, None, 0], g[None, :, 0])
    iy1 = np.maximum(d[:, None, 1], g[None, :, 1])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = (d[:, 2] * d[:, 3])[:, None] + (g[:, 2] * g[:, 3])[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def evaluate_detections(
    gt_by_image: Dict[int, np.ndarray],
    det_by_image: Dict[int, np.ndarray],
    max_dets: int = 100,
) -> Dict[str, float]:
    """COCO bbox evaluation for a single category.

    Args:
        gt_by_image: image_id -> [M, 4] xywh ground-truth boxes.
        det_by_image: image_id -> [N, 5] xywh+score detections.
    Returns:
        {"AP": AP@[.50:.95], "AP50", "AP75", "AR": AR@max_dets}
    """
    n_thr = len(IOU_THRESHOLDS)
    all_scores: List[np.ndarray] = []
    all_matches: List[np.ndarray] = []  # [n_thr, n_det] bool per image
    total_gt = 0
    recalls_per_image = []

    image_ids = sorted(set(gt_by_image) | set(det_by_image))
    for img in image_ids:
        gts = np.asarray(gt_by_image.get(img, np.zeros((0, 4))))
        dets = np.asarray(det_by_image.get(img, np.zeros((0, 5))))
        if len(dets):
            order = np.argsort(-dets[:, 4], kind="stable")[:max_dets]
            dets = dets[order]
        total_gt += len(gts)
        iou = _iou_xywh(dets[:, :4], gts)
        matched = np.zeros((n_thr, len(dets)), bool)
        if len(dets) and len(gts):
            # greedy matcher vectorized over ALL IoU thresholds at once:
            # one [T, M] argmax per detection instead of T*N*M python
            # iterations (WIDER-val scale: minutes -> seconds)
            taken = np.zeros((n_thr, len(gts)), bool)
            t_idx = np.arange(n_thr)
            m = len(gts)
            for di in range(len(dets)):
                cand = np.where(taken, -1.0, iou[di][None, :])  # [T, M]
                # classic loop semantics pick the LAST gt among exact IoU
                # ties (its >= update); argmax picks the first, so argmax
                # the reversed row
                gi = m - 1 - np.argmax(cand[:, ::-1], axis=1)
                ok = cand[t_idx, gi] >= IOU_THRESHOLDS
                taken[ok, gi[ok]] = True
                matched[ok, di] = True
        all_scores.append(dets[:, 4] if len(dets) else np.zeros(0))
        all_matches.append(matched)

    if total_gt == 0:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR": 0.0}

    scores = np.concatenate(all_scores)
    matches = np.concatenate(all_matches, axis=1) if all_matches else \
        np.zeros((n_thr, 0), bool)
    order = np.argsort(-scores, kind="stable")
    matches = matches[:, order]

    aps = np.zeros(n_thr)
    ars = np.zeros(n_thr)
    for t in range(n_thr):
        tp = np.cumsum(matches[t])
        fp = np.cumsum(~matches[t])
        recall = tp / total_gt
        precision = tp / np.maximum(tp + fp, 1e-12)
        # COCO monotone precision envelope + 101-point interpolation
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        if len(precision) == 0:
            prec_at = np.zeros_like(RECALL_POINTS)
        else:
            idx = np.searchsorted(recall, RECALL_POINTS, side="left")
            prec_at = np.where(
                idx < len(precision),
                precision[np.minimum(idx, len(precision) - 1)],
                0.0,
            )
        aps[t] = prec_at.mean()
        ars[t] = recall[-1] if len(recall) else 0.0

    return {
        "AP": float(aps.mean()),
        "AP50": float(aps[0]),
        "AP75": float(aps[5]),
        "AR": float(ars.mean()),
    }


def parse_wider_annotations(ann_file: str) -> Dict[str, np.ndarray]:
    """Parse wider_face_val_bbx_gt.txt: path -> [M, 4] xywh
    (``eval_face_detector.py:52-69``)."""
    out: Dict[str, np.ndarray] = {}
    with open(ann_file, "rt") as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        path = lines[i]
        i += 1
        n = int(lines[i])
        i += 1
        boxes = []
        for _ in range(max(n, 1)):  # n==0 still has one placeholder row
            params = [int(v) for v in lines[i].split()[:4]]
            i += 1
            if n > 0 and params[2] > 0 and params[3] > 0:
                boxes.append(params)
        out[path] = np.asarray(boxes if boxes else np.zeros((0, 4)), np.float64)
    return out


def _read(path: str) -> Optional[np.ndarray]:
    """The image at ``path`` (JPEG, PNG or BMP), or None where it does not
    decode, as ``cv2.imread`` gives None."""
    try:
        return read_image_bgr(path, formats=IMAGE_EXTENSIONS)
    except ValueError:  # a format or variant the port does not read
        return None


def _unletterbox(boxes: np.ndarray, in_wh, orig_wh) -> np.ndarray:
    """Reference scale_coords math (``modules/utils/image.py:79-99``):
    float gain/pad removal + clip + round, numpy per-image (the batched
    eval runner detects in letterboxed model space)."""
    iw, ih = in_wh
    w, h = orig_wh
    gain = min(ih / h, iw / w)
    pad_x, pad_y = (iw - w * gain) / 2, (ih - h * gain) / 2
    out = boxes.astype(np.float64).copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - pad_x) / gain
    out[:, [1, 3]] = (out[:, [1, 3]] - pad_y) / gain
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    return out.round()


def evaluate_engine_on_wider(
    engine, ann_file: str, images_root: str, limit: int = None,
    batch_size: int = 32,
) -> Dict[str, float]:
    """Run a FaceEngine over WIDER val and compute COCO metrics.

    Images are decoded + letterboxed to the model input on host threads,
    detected in fixed [batch_size, in_h, in_w, 3] blocks (one
    ``detect_batch`` a block instead of the reference's per-image loop,
    ``eval_face_detector.py:114-151``; a short last block is padded with
    copies of its last image), and un-letterboxed per image on the host.
    Native-resolution cascades (mtcnn) keep the per-image path. An
    unreadable image keeps its ground truth: its faces count as missed."""
    gt = parse_wider_annotations(ann_file)
    paths = sorted(gt)[:limit] if limit else sorted(gt)
    gt_by_image, det_by_image = {}, {}

    n_unreadable = 0

    if engine.input_size == (-1, -1):  # native-resolution cascade
        for img_id, rel in enumerate(paths):
            # an unreadable image keeps its GT (its faces count as missed);
            # silently dropping it from gt_by_image would shrink total_gt
            # and inflate the reported AP/AR
            gt_by_image[img_id] = gt[rel]
            img = _read(os.path.join(images_root, rel))
            if img is None:
                n_unreadable += 1
                continue
            post = engine.detect_image(img)
            if len(post.boxes):
                det_by_image[img_id] = _dets_to_xywh(post)
        if n_unreadable:
            logger.warning("%d/%d images unreadable: their GT boxes count "
                           "as missed", n_unreadable, len(paths))
        return evaluate_detections(gt_by_image, det_by_image)

    iw, ih = engine.input_size

    def load(rel):
        img = _read(os.path.join(images_root, rel))
        if img is None:
            return None, None
        return (host_letterbox(img, (ih, iw), engine.spec.preprocess.fill),
                (img.shape[1], img.shape[0]))

    with ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, len(paths), batch_size):
            chunk = paths[start:start + batch_size]
            loaded = list(pool.map(load, chunk))
            # every image in the chunk keeps its GT, decodable or not —
            # unreadable ones contribute missed GT, not a smaller denominator
            for i, rel in enumerate(chunk):
                gt_by_image[start + i] = gt[rel]
            keep = [(i, c, wh) for i, (c, wh) in enumerate(loaded)
                    if c is not None]
            n_unreadable += len(chunk) - len(keep)
            if not keep:
                continue
            block = np.stack([c for _, c, _ in keep])
            pad = batch_size - len(keep)
            if pad:
                block = np.concatenate([block, np.repeat(
                    block[-1:], pad, axis=0)])
            # detect in letterboxed model space (orig == input size here);
            # conf/area thresholds see the same values as the standard path
            dets = engine.detect_batch(block)
            posts = dets.to_numpy()[:len(keep)]
            for (i, _, (ww, hh)), post in zip(keep, posts):
                img_id = start + i
                if len(post.boxes):
                    post.boxes = _unletterbox(
                        np.asarray(post.boxes, np.float64), (iw, ih), (ww, hh))
                    det_by_image[img_id] = _dets_to_xywh(post)
    if n_unreadable:
        logger.warning("%d/%d images unreadable: their GT boxes count as "
                       "missed", n_unreadable, len(paths))
    return evaluate_detections(gt_by_image, det_by_image)


def _dets_to_xywh(post) -> np.ndarray:
    xywh = np.stack([
        post.boxes[:, 0], post.boxes[:, 1],
        post.boxes[:, 2] - post.boxes[:, 0],
        post.boxes[:, 3] - post.boxes[:, 1],
    ], axis=1)
    return np.concatenate([xywh, post.bbox_confs[:, None]], axis=1)
