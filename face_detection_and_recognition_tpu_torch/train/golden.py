"""The golden accuracy loop: train a detector until it detects the
reference's golden 3-face image, then gate, checkpoint, reload and regate.

The counterpart of ``train/golden.py`` in the JAX package. The synthetic
composite datasets (golden-face crops feather-pasted onto face-free
backgrounds, with unlabeled distractor patches, or crowded frames of 16-64
rotated, overlapping faces) are built in numpy from the same
``random.Random`` draws, through the port's codec and its cv2 slots
(``ops.geometry.host_resize`` for cv2.resize, ``warp_affine`` for
cv2.warpAffine, ``utils.native.write_image_bgr`` for cv2.imwrite), so a
seed gives the JAX package's files byte for byte. Training runs through
``train/device_loop.py`` on the card; the gate is ``evaluate_golden``
through a ``FaceEngine``; checkpoints are the port's ``.pt`` files
(``FaceEngine.save_weights`` / ``load_weights``).

The golden images default to ``card_weights/`` (the copies of
``tests/data``'s that the card's machine has).
"""
from __future__ import annotations

import dataclasses
import os
import random
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..eval.card_weights import (CARD_WEIGHTS, NEG_IMAGE, POS_IMAGE,
                                 bbox_iou_xyxy, golden_pair, match_golden)
from ..ops.geometry import host_resize, rotation_matrix_2d, warp_affine
from ..utils.native import write_image_bgr
from .data import imread

# reference golden contract (tests/image_tests/test_yolov5_face.py:58-66)
GOLDEN_BOXES_3 = np.array(
    [[408, 212, 472, 301], [283, 230, 344, 309], [511, 200, 637, 366]],
    np.float32)
GOLDEN_IMG = str(CARD_WEIGHTS / POS_IMAGE)
NEGATIVE_IMG = str(CARD_WEIGHTS / NEG_IMAGE)


# --------------------------------------------------------------------------
# synthetic composite datasets
# --------------------------------------------------------------------------

def _feather_mask(h: int, w: int, border: int) -> np.ndarray:
    """[h, w, 1] float alpha ramping 0 -> 1 over ``border`` px from each
    edge, so pasted patches have no hard rectangle edge."""
    if border <= 0:
        return np.ones((h, w, 1), np.float32)
    ramp_y = np.minimum(np.arange(h) + 1, np.arange(h)[::-1] + 1)
    ramp_x = np.minimum(np.arange(w) + 1, np.arange(w)[::-1] + 1)
    m = np.minimum(ramp_y[:, None], ramp_x[None, :]).astype(np.float32)
    return np.clip(m / border, 0.0, 1.0)[..., None]


def extract_golden_faces(img_path: str = GOLDEN_IMG,
                         boxes_xyxy: np.ndarray = GOLDEN_BOXES_3,
                         margin: float = 0.35) -> List[Dict[str, np.ndarray]]:
    """Crop each golden face with context margin: dicts with the patch and
    the face box inside it (xyxy, patch coordinates)."""
    img = imread(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    H, W = img.shape[:2]
    faces = []
    for (x1, y1, x2, y2) in boxes_xyxy.astype(int):
        mx, my = int((x2 - x1) * margin), int((y2 - y1) * margin)
        px1, py1 = max(x1 - mx, 0), max(y1 - my, 0)
        px2, py2 = min(x2 + mx, W), min(y2 + my, H)
        faces.append({
            "patch": img[py1:py2, px1:px2].copy(),
            "box": np.array([x1 - px1, y1 - py1, x2 - px1, y2 - py1],
                            np.float32)})
    return faces


def _random_background(rng: random.Random, out_wh: Tuple[int, int],
                       sources: List[np.ndarray]) -> np.ndarray:
    """Face-free background: a random crop of a source image, plain noise,
    or a flat fill with a soft vertical gradient."""
    ow, oh = out_wh
    mode = rng.random()
    if mode < 0.70 and sources:
        src = sources[rng.randrange(len(sources))]
        h, w = src.shape[:2]
        cw = rng.randint(min(ow // 2, w), min(w, ow * 2))
        ch = rng.randint(min(oh // 2, h), min(h, oh * 2))
        x0 = rng.randint(0, max(w - cw, 0))
        y0 = rng.randint(0, max(h - ch, 0))
        return host_resize(np.ascontiguousarray(src[y0:y0 + ch, x0:x0 + cw]),
                           (ow, oh))
    if mode < 0.85:
        noise = np.random.RandomState(rng.randrange(1 << 31)).randint(
            0, 255, (oh, ow, 3))
        return noise.astype(np.uint8)
    base = np.array([rng.randint(0, 255) for _ in range(3)], np.float32)
    grad = np.linspace(0.6, 1.2, oh, dtype=np.float32)[:, None, None]
    fill = np.broadcast_to(base[None, None] * grad, (oh, ow, 3))
    return np.clip(fill, 0, 255).astype(np.uint8)


def _paste_feathered(canvas: np.ndarray, patch: np.ndarray, x0: int, y0: int,
                     border: int, writer: Optional[np.ndarray] = None,
                     idx: int = -1) -> None:
    """Alpha-blend ``patch`` into ``canvas`` at (x0, y0) with a feathered
    edge; ``writer`` (an occupancy map) takes ``idx`` where the patch's
    alpha dominates."""
    sh, sw = patch.shape[:2]
    alpha = _feather_mask(sh, sw, border=border)
    region = canvas[y0:y0 + sh, x0:x0 + sw].astype(np.float32)
    canvas[y0:y0 + sh, x0:x0 + sw] = (
        patch.astype(np.float32) * alpha + region * (1 - alpha)
    ).astype(np.uint8)
    if writer is not None:
        w_region = writer[y0:y0 + sh, x0:x0 + sw]
        w_region[alpha[..., 0] > 0.5] = idx


def compose_image(rng: random.Random, faces: Sequence[Dict[str, np.ndarray]],
                  sources: List[np.ndarray],
                  out_wh: Tuple[int, int] = (640, 640), max_faces: int = 4,
                  empty_prob: float = 0.15, max_distractors: int = 3,
                  face_px: Optional[Tuple[float, float]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One composite: 0..max_faces golden-face patches feather-pasted onto a
    face-free background at random scales and non-overlapping positions,
    plus unlabeled non-face distractor patches pasted the same way (which
    keep the net from learning the paste itself). Returns (img BGR u8,
    boxes [N, 4] xywh pixel GT)."""
    ow, oh = out_wh
    canvas = _random_background(rng, out_wh, sources).copy()
    boxes: List[np.ndarray] = []
    n = 0 if rng.random() < empty_prob else rng.randint(1, max_faces)
    placed: List[np.ndarray] = []
    for _ in range(n):
        f = faces[rng.randrange(len(faces))]
        patch, box = f["patch"], f["box"]
        ph, pw = patch.shape[:2]
        fw = box[2] - box[0]
        if face_px is not None:
            lo, hi = face_px
        else:
            lo = min(28.0, max(6.0, 0.05 * min(ow, oh)))
            hi = 0.55 * min(ow, oh)
        s = rng.uniform(lo, hi) / fw
        sw, sh = max(int(pw * s), 8), max(int(ph * s), 8)
        if sw >= ow or sh >= oh:
            continue
        patch_s = host_resize(patch, (sw, sh))
        for _attempt in range(10):
            x0 = rng.randint(0, ow - sw)
            y0 = rng.randint(0, oh - sh)
            fb = np.array([x0 + box[0] * s, y0 + box[1] * s,
                           x0 + box[2] * s, y0 + box[3] * s], np.float32)
            if all(bbox_iou_xyxy(fb, p) < 0.05 for p in placed):
                _paste_feathered(canvas, patch_s, x0, y0,
                                 border=max(3, int(6 * s)))
                placed.append(fb)
                boxes.append(np.array(
                    [fb[0], fb[1], fb[2] - fb[0], fb[3] - fb[1]], np.float32))
                break
    for _ in range(rng.randint(0, max_distractors)):
        if not sources:
            break
        src = sources[rng.randrange(len(sources))]
        h, w = src.shape[:2]
        cw = rng.randint(16, max(min(w, ow) // 2, 17))
        ch = rng.randint(16, max(min(h, oh) // 2, 17))
        x0s, y0s = rng.randint(0, w - cw), rng.randint(0, h - ch)
        s = rng.uniform(28, 0.55 * min(ow, oh)) / cw
        sw, sh = max(int(cw * s), 8), max(int(ch * s), 8)
        if sw >= ow or sh >= oh:
            continue
        patch_s = host_resize(np.ascontiguousarray(
            src[y0s:y0s + ch, x0s:x0s + cw]), (sw, sh))
        for _attempt in range(10):
            x0 = rng.randint(0, ow - sw)
            y0 = rng.randint(0, oh - sh)
            db = np.array([x0, y0, x0 + sw, y0 + sh], np.float32)
            if all(bbox_iou_xyxy(db, p) < 0.05 for p in placed):
                _paste_feathered(canvas, patch_s, x0, y0,
                                 border=max(3, int(6 * s)))
                break
    gt = np.stack(boxes) if boxes else np.zeros((0, 4), np.float32)
    return canvas, gt


def _sources(face_img: str, neg_img: str) -> List[np.ndarray]:
    """Background sources: the negative image and the face-free top strip
    of the golden one."""
    sources = []
    neg = imread(neg_img)
    if neg is not None:
        sources.append(neg)
    gimg = imread(face_img)
    if gimg is not None:
        sources.append(gimg[: int(GOLDEN_BOXES_3[:, 1].min()) - 10])
    return sources


def _gt_lines(rel: str, gt: np.ndarray) -> List[str]:
    lines = [f"{rel}\n{len(gt)}\n"]
    if len(gt) == 0:  # WIDER format: 0-face entries carry one dummy row
        lines.append("0 0 0 0 0 0 0 0 0 0\n")
    for b in gt:
        lines.append(f"{int(b[0])} {int(b[1])} {int(round(b[2]))} "
                     f"{int(round(b[3]))} 0 0 0 0 0 0\n")
    return lines


def _replicate(images_root: str, base: str, n: int, gt_text: str
               ) -> List[str]:
    """``n`` index entries of the image ``base``: the first is the file,
    the others hard links to it."""
    lines = []
    stem = base[:-len(".jpg")]
    for j in range(n):
        rel = base if j == 0 else f"{stem}_{j:02d}.jpg"
        if j:
            dst = os.path.join(images_root, rel)
            if not os.path.exists(dst):
                os.link(os.path.join(images_root, base), dst)
        lines.append(f"{rel}\n{gt_text}")
    return lines


def make_composite_dataset(out_dir: str, n_images: int = 384,
                           out_wh: Tuple[int, int] = (640, 640),
                           seed: int = 0, face_img: str = GOLDEN_IMG,
                           neg_img: str = NEGATIVE_IMG,
                           include_real: bool = True, n_crowded: int = 0,
                           face_px: Optional[Tuple[float, float]] = None
                           ) -> Tuple[str, str]:
    """Write a WIDER-format synthetic dataset (images + gt.txt) built from
    the golden faces; returns (ann_file, images_root). ``n_crowded`` adds
    crowded frames (``compose_crowded_image``). With ``include_real`` the
    real pair is replicated in (the golden image with its pinned boxes,
    the negative one, and the negative one stretched to the golden one's
    shape, as the gate renders it)."""
    rng = random.Random(seed)
    faces = extract_golden_faces(face_img)
    sources = _sources(face_img, neg_img)
    images_root = os.path.join(out_dir, "images")
    os.makedirs(os.path.join(images_root, "0--Golden"), exist_ok=True)
    lines = []
    for i in range(n_images + n_crowded):
        if i < n_images:
            img, gt = compose_image(rng, faces, sources, out_wh,
                                    face_px=face_px)
        else:
            img, gt = compose_crowded_image(rng, faces, sources, out_wh,
                                            n_faces=(16, 48))
        rel = f"0--Golden/c{i:04d}.jpg"
        write_image_bgr(os.path.join(images_root, rel), img,
                        rng.randint(80, 98))
        lines += _gt_lines(rel, gt)
    n_real = (max(n_images // 10, 4)) if include_real else 0
    if n_real:
        pos_rows = [f"{int(x1)} {int(y1)} {int(x2 - x1)} {int(y2 - y1)} "
                    "0 0 0 0 0 0" for (x1, y1, x2, y2) in GOLDEN_BOXES_3]
        for tag, src_path, text in (
                ("pos", face_img, f"{len(pos_rows)}\n"
                 + "\n".join(pos_rows) + "\n"),
                ("neg", neg_img, "0\n0 0 0 0 0 0 0 0 0 0\n")):
            if not os.path.isfile(src_path):
                continue
            base = f"0--Golden/real_{tag}.jpg"
            shutil.copy(src_path, os.path.join(images_root, base))
            lines += _replicate(images_root, base, n_real, text)
        if os.path.isfile(neg_img) and os.path.isfile(face_img):
            pos_im, neg_im = imread(face_img), imread(neg_img)
            if pos_im is not None and neg_im is not None:
                stretch = host_resize(neg_im, (pos_im.shape[1],
                                               pos_im.shape[0]))
                base = "0--Golden/real_neg_stretch.jpg"
                write_image_bgr(os.path.join(images_root, base), stretch, 95)
                lines += _replicate(images_root, base, n_real,
                                    "0\n0 0 0 0 0 0 0 0 0 0\n")
    ann = os.path.join(out_dir, "gt.txt")
    with open(ann, "w") as f:
        f.write("".join(lines))
    return ann, images_root


def _rotate_patch(patch: np.ndarray, box: np.ndarray, angle: float):
    """Rotate a face patch (and its box corners) about the patch center,
    expanding the canvas so nothing clips. Returns (patch, box)."""
    ph, pw = patch.shape[:2]
    m = rotation_matrix_2d((pw / 2, ph / 2), angle, 1.0)
    cos, sin = abs(m[0, 0]), abs(m[0, 1])
    nw = int(ph * sin + pw * cos)
    nh = int(ph * cos + pw * sin)
    m[0, 2] += nw / 2 - pw / 2
    m[1, 2] += nh / 2 - ph / 2
    out = warp_affine(patch, m, (nw, nh))
    corners = np.array([[box[0], box[1], 1], [box[2], box[1], 1],
                        [box[2], box[3], 1], [box[0], box[3], 1]], np.float32)
    rot = corners @ m.T
    nb = np.array([rot[:, 0].min(), rot[:, 1].min(),
                   rot[:, 0].max(), rot[:, 1].max()], np.float32)
    return out, nb


def compose_crowded_image(rng: random.Random,
                          faces: Sequence[Dict[str, np.ndarray]],
                          sources: List[np.ndarray],
                          out_wh: Tuple[int, int] = (640, 640),
                          n_faces: Tuple[int, int] = (16, 64),
                          face_px: Tuple[int, int] = (8, 300),
                          max_overlap: float = 0.3, rot_deg: float = 25.0,
                          max_distractors: int = 6, min_visible: float = 0.4
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """One crowded composite: 16-64 faces at 8-300 px (log-uniform) with
    rotation and partial overlap, plus unlabeled distractors. A position is
    rejected when its patch would cover more than ``1 - min_visible`` of a
    placed face, and a face whose alpha-owned share of its box ends below
    ``min_visible`` loses its label (its pixels stay). Returns (img BGR
    u8, boxes [N, 4] xywh pixel GT) in paste order."""
    ow, oh = out_wh
    canvas = _random_background(rng, out_wh, sources).copy()
    writer = np.full((oh, ow), -1, np.int32)
    n = rng.randint(*n_faces)
    placed: List[np.ndarray] = []
    rows: List[np.ndarray] = []
    paste_ids: List[int] = []
    next_idx = 0

    def rect_covers(x0, y0, pw, ph):
        """Max fraction of any placed face box covered by this rect."""
        worst = 0.0
        for p in placed:
            ix = max(0.0, min(x0 + pw, p[2]) - max(x0, p[0]))
            iy = max(0.0, min(y0 + ph, p[3]) - max(y0, p[1]))
            area = (p[2] - p[0]) * (p[3] - p[1])
            if area > 0:
                worst = max(worst, ix * iy / area)
        return worst

    for _ in range(n):
        f = faces[rng.randrange(len(faces))]
        patch, box = f["patch"], f["box"]
        lo, hi = face_px
        hi = min(hi, int(0.55 * min(ow, oh)))
        s = float(np.exp(rng.uniform(np.log(lo), np.log(hi)))) \
            / (box[2] - box[0])
        sw = max(int(patch.shape[1] * s), 4)
        sh = max(int(patch.shape[0] * s), 4)
        if sw >= ow or sh >= oh:
            continue
        patch_s = host_resize(patch, (sw, sh))
        box_s = box * s
        if rot_deg and rng.random() < 0.5:
            patch_s, box_s = _rotate_patch(patch_s, box_s,
                                           rng.uniform(-rot_deg, rot_deg))
            sh, sw = patch_s.shape[:2]
            if sw >= ow or sh >= oh:
                continue
        for _attempt in range(8):
            x0 = rng.randint(0, ow - sw)
            y0 = rng.randint(0, oh - sh)
            fb = np.array([x0 + box_s[0], y0 + box_s[1],
                           x0 + box_s[2], y0 + box_s[3]], np.float32)
            if (all(bbox_iou_xyxy(fb, p) <= max_overlap for p in placed)
                    and rect_covers(x0, y0, sw, sh) <= 1.0 - min_visible):
                _paste_feathered(canvas, patch_s, x0, y0,
                                 border=max(2, int(4 * s)),
                                 writer=writer, idx=next_idx)
                placed.append(fb)
                rows.append(np.array(
                    [fb[0], fb[1], fb[2] - fb[0], fb[3] - fb[1]],
                    np.float32))
                paste_ids.append(next_idx)
                next_idx += 1
                break
    for _ in range(rng.randint(0, max_distractors)):
        if not sources:
            break
        src = sources[rng.randrange(len(sources))]
        h, w = src.shape[:2]
        cw = rng.randint(16, max(min(w, ow) // 2, 17))
        ch = rng.randint(16, max(min(h, oh) // 2, 17))
        x0s, y0s = rng.randint(0, w - cw), rng.randint(0, h - ch)
        s = rng.uniform(12, 0.4 * min(ow, oh)) / cw
        sw, sh = max(int(cw * s), 4), max(int(ch * s), 4)
        if sw >= ow or sh >= oh:
            continue
        patch_s = host_resize(np.ascontiguousarray(
            src[y0s:y0s + ch, x0s:x0s + cw]), (sw, sh))
        for _attempt in range(8):
            x0 = rng.randint(0, ow - sw)
            y0 = rng.randint(0, oh - sh)
            db = np.array([x0, y0, x0 + sw, y0 + sh], np.float32)
            if (all(bbox_iou_xyxy(db, p) < 0.05 for p in placed)
                    and rect_covers(x0, y0, sw, sh) <= 1.0 - min_visible):
                _paste_feathered(canvas, patch_s, x0, y0,
                                 border=max(2, int(4 * s)),
                                 writer=writer, idx=next_idx)
                next_idx += 1
                break
    kept = []
    for row, pid in zip(rows, paste_ids):
        x1, y1 = max(int(row[0]), 0), max(int(row[1]), 0)
        x2 = min(int(np.ceil(row[0] + row[2])), ow)
        y2 = min(int(np.ceil(row[1] + row[3])), oh)
        region = writer[y1:y2, x1:x2]
        if region.size and (region == pid).mean() >= min_visible:
            kept.append(row)
    gt = np.stack(kept) if kept else np.zeros((0, 4), np.float32)
    return canvas, gt


def make_crowded_dataset(out_dir: str, n_images: int = 32,
                         out_wh: Tuple[int, int] = (640, 640), seed: int = 0,
                         face_img: str = GOLDEN_IMG,
                         neg_img: str = NEGATIVE_IMG, **compose_kw
                         ) -> Tuple[str, str]:
    """WIDER-format crowded set (images + gt.txt); returns (ann_file,
    images_root)."""
    rng = random.Random(seed)
    faces = extract_golden_faces(face_img)
    sources = _sources(face_img, neg_img)
    images_root = os.path.join(out_dir, "images")
    os.makedirs(os.path.join(images_root, "1--Crowded"), exist_ok=True)
    lines = []
    for i in range(n_images):
        img, gt = compose_crowded_image(rng, faces, sources, out_wh,
                                        **compose_kw)
        rel = f"1--Crowded/c{i:04d}.jpg"
        write_image_bgr(os.path.join(images_root, rel), img,
                        rng.randint(85, 98))
        lines += _gt_lines(rel, gt)
    ann = os.path.join(out_dir, "gt.txt")
    with open(ann, "w") as f:
        f.write("".join(lines))
    return ann, images_root


# --------------------------------------------------------------------------
# accuracy gate + training loop
# --------------------------------------------------------------------------

def evaluate_golden(engine, variables: Optional[Dict[str, torch.Tensor]]
                    = None, pos_img: str = GOLDEN_IMG,
                    neg_img: str = NEGATIVE_IMG, det_thres: float = 0.5,
                    iou_thres: float = 0.5, margin: float = 0.05
                    ) -> Dict[str, object]:
    """Run the engine on the golden pair and score against the pinned
    boxes. ``variables``, a state dict of the engine's detector, is poured
    into the engine first (``load_state_dict``; the engine keeps it).

    ``ok`` requires 3 faces at IoU >= ``iou_thres`` and none on the
    negative image at ``det_thres`` and at ``det_thres`` +- ``margin``; the
    reported counts and IoUs are the centre threshold's. With
    ``variables`` the strongest score on the golden image (at threshold
    0.01) is reported as ``top_conf``."""
    if variables is not None:
        engine.load_state_dict(variables)
    thresholds = [det_thres] + ([det_thres - margin, det_thres + margin]
                                if margin else [])

    def boxes_at(img, t):
        post = engine.detect_image(img, det_thres=t)
        return np.asarray(post.boxes, np.float32).reshape(-1, 4)

    pos, neg = golden_pair(pos_img, neg_img)
    results: Dict[str, object] = {}
    ok_all = True
    for tag, img in (("pos", pos), ("neg", neg)):
        for t in thresholds:
            pred_t = boxes_at(img, t)
            if t == det_thres:
                results[tag] = pred_t
            if tag == "pos":
                ious_t = (match_golden(pred_t, GOLDEN_BOXES_3)
                          if len(pred_t) else [0.0] * 3)
                ok_all &= (len(pred_t) == 3
                           and all(i >= iou_thres for i in ious_t))
            else:
                ok_all &= len(pred_t) == 0
        if tag == "pos" and variables is not None:
            confs = np.asarray(engine.detect_image(img, det_thres=0.01)
                               .bbox_confs, np.float32).reshape(-1)
            results["top_conf"] = float(confs.max()) if len(confs) else 0.0
    pred = results["pos"]
    ious = match_golden(pred, GOLDEN_BOXES_3) if len(pred) else [0.0] * 3
    return {"ok": bool(ok_all), "n_pos": int(len(pred)),
            "n_neg": int(len(results["neg"])), "ious": ious,
            "pred_boxes": pred, "top_conf": results.get("top_conf", 0.0)}


def evaluate_holdout_ap(engine, work_dir: str, n_images: int = 96,
                        input_size: int = 640, seed: int = 7777,
                        det_thres: float = 0.05) -> Dict[str, float]:
    """COCO metrics on a held-out composite set (a seed disjoint from the
    training seeds), through ``eval.coco_eval.evaluate_engine_on_wider``
    at a low threshold (the PR curve is swept from there)."""
    from ..eval.coco_eval import evaluate_engine_on_wider

    ann, images_root = make_composite_dataset(
        os.path.join(work_dir, "holdout_ds"), n_images=n_images,
        out_wh=(input_size, input_size), seed=seed, include_real=False)
    old = engine.cfg.det_thres
    engine.cfg.det_thres = det_thres
    try:
        return evaluate_engine_on_wider(engine, ann, images_root)
    finally:
        engine.cfg.det_thres = old


def _family_state(arch: str, input_size: int, max_targets: int, lr: float,
                  warmup: int, max_steps: int, seed: int, device):
    """(cfg, state, make_step) of ``arch``'s trainer."""
    gen = torch.Generator().manual_seed(seed)
    sched = dict(lr=lr, warmup_steps=warmup, total_steps=max_steps,
                 ema_decay=0.999, ema_tau=500.0, max_targets=max_targets)
    if arch == "res10-ssd":
        # the public deploy graph, trained through the Caffe interpreter
        from .caffe_golden import (CaffeGoldenConfig,
                                   create_res10_train_state,
                                   make_res10_train_step_ema)

        if input_size != 300:
            raise ValueError("res10-ssd runs the fixed 300x300 deploy "
                             "graph: pass --size 300")
        cfg = CaffeGoldenConfig(**sched)
        return cfg, create_res10_train_state(cfg, gen, device), \
            make_res10_train_step_ema
    if arch.startswith("ov-"):
        # the OpenVINO topologies, trained through the IR interpreter
        from .ov_golden import (OVGoldenConfig, create_ov_train_state,
                                make_ov_train_step_ema)

        cfg = OVGoldenConfig(topology=arch,
                             input_size=(input_size, input_size), **sched)
        return cfg, create_ov_train_state(cfg, gen, device), \
            make_ov_train_step_ema
    if arch.startswith("ssd"):
        from .ssd import (SSDTrainConfig, create_ssd_train_state,
                          make_ssd_train_step_ema)

        cfg = SSDTrainConfig(backbone=arch.split("-", 1)[1],
                             input_size=(input_size, input_size), **sched)
        return cfg, create_ssd_train_state(cfg, gen, device), \
            make_ssd_train_step_ema
    if arch.startswith("blazeface"):
        from .blazeface import (BlazeTrainConfig, create_blaze_train_state,
                                make_blaze_train_step_ema)

        cfg = BlazeTrainConfig(back_model=arch.endswith("back"), **sched)
        if (input_size, input_size) != cfg.input_size:
            raise ValueError(
                f"{arch} trains at its fixed native size "
                f"{cfg.input_size[0]}: pass --size {cfg.input_size[0]}")
        return cfg, create_blaze_train_state(cfg, gen, device), \
            make_blaze_train_step_ema
    from .detection import (DetTrainConfig, create_det_train_state,
                            make_det_train_step_ema)

    official = arch.endswith("-official")
    cfg = DetTrainConfig(
        arch=arch[: -len("-official")] if official else arch,
        nc=80 if official else 1, with_landmarks=not official,
        input_size=(input_size, input_size), **sched)
    return cfg, create_det_train_state(cfg, gen, device), \
        make_det_train_step_ema


def golden_engine(arch: str, input_size: int, cfg=None, device=None):
    """The FaceEngine the gate runs ``arch`` through: its input size (but
    BlazeFace's fixed one), the official head's class count."""
    from ..core.engine import EngineConfig, FaceEngine

    overrides = ({} if arch.startswith("blazeface")
                 else {"input_size": (input_size, input_size)})
    if arch.endswith("-official"):
        overrides["nc"] = cfg.nc if cfg is not None else 80
    return FaceEngine(EngineConfig(detector=arch, det_thres=0.5,
                                   detector_overrides=overrides),
                      device=device)


def train_golden(ckpt_out: str, work_dir: str, arch: str = "yolov5n",
                 input_size: int = 640, batch_size: int = 16,
                 max_steps: int = 1500, eval_every: int = 100,
                 n_images: int = 384, lr: float = 0.01, seed: int = 0,
                 resume_from: Optional[str] = None,
                 gate_det_thres: float = 0.5, gate_margin: float = 0.05,
                 gate_iou: float = 0.5, crowded: bool = False,
                 face_px: Optional[Tuple[float, float]] = None,
                 loss_overrides: Optional[Dict[str, float]] = None,
                 device=None, log=print) -> Dict[str, object]:
    """Composites -> augmented device buffer -> EMA training on the card ->
    golden gate on both weight candidates at every eval -> ``.pt``
    checkpoint (``FaceEngine.save_weights``) -> a fresh engine loading it
    -> regate.

    Families: the yolov5-face archs, their ``-official`` heads, blazeface
    front and back, the ssd-* nets, res10-ssd (the deploy graph through the
    Caffe interpreter, ``train/caffe_golden.py``) and the ov-* topologies
    (through the IR interpreter, ``train/ov_golden.py``). ``resume_from``
    (a ``.pt``) pours its weights into the live net and the EMA copy (the
    optimizer restarts cold). Returns the gate's result plus ``steps``,
    ``weights`` (the passing candidate, "ema" or "live"), ``reload_ok``,
    ``reload_ious``, ``chunk_losses``, the final ``n_updates`` and
    ``candidate``, the checkpointed state dict."""
    from ..core.engine import read_state_dict
    from .data import AugmentConfig, load_wider_index
    from .detection import load_train_weights
    from .device_loop import build_example_buffer, run_device_training

    # the SSD conventions: BGR input, no RGB swap
    is_ssd = arch.startswith(("ssd", "ov-")) or arch == "res10-ssd"
    max_targets = 48 if crowded else 8
    ann, images_root = make_composite_dataset(
        os.path.join(work_dir, "golden_ds"), n_images=n_images,
        out_wh=(input_size, input_size), seed=seed,
        n_crowded=n_images // 2 if crowded else 0, face_px=face_px)
    index = load_wider_index(ann, images_root)
    log(f"[golden] dataset: {len(index)} composites at {input_size}px")

    warmup = max(3 * len(index) // batch_size, 50)
    cfg, state, make_step = _family_state(arch, input_size, max_targets, lr,
                                          warmup, max_steps, seed, device)
    if loss_overrides:
        # loss-term knobs only: the step reads cfg from the state, the
        # optimizer's schedule was fixed at build
        cfg = dataclasses.replace(cfg, **loss_overrides)
        state["cfg"] = cfg
        log(f"[golden] loss overrides: {loss_overrides}")
    if resume_from:
        load_train_weights(state, read_state_dict(resume_from))
        log(f"[golden] resumed weights from {resume_from}")

    engine = golden_engine(arch, input_size, cfg, state["device"])
    gate = dict(iou_thres=gate_iou, det_thres=gate_det_thres,
                margin=gate_margin)
    r0 = evaluate_golden(engine, variables=state["net"].state_dict(), **gate)
    log(f"[golden] eval warmup ok (pos={r0['n_pos']} neg={r0['n_neg']})")

    # mosaic / HSV once into the device buffer; flips and brightness are
    # drawn again every step on the device. The buffer holds the JAX
    # package's max(2 x composites, 768) examples, or the run's draws
    # (max_steps x batch_size) where those are fewer
    aug = AugmentConfig(mosaic=0.5, fliplr=0.0, scale=0.3)
    data = build_example_buffer(
        index, min(max(2 * len(index), 768), max_steps * batch_size),
        (input_size, input_size), cfg.max_targets, seed=seed, augment=aug,
        to_rgb=not is_ssd)

    result: Dict[str, object] = {"ok": False}
    winner: Dict[str, dict] = {}

    def on_eval(done: int, ema_sd: dict, live_sd: dict) -> bool:
        # gate both candidates; the first that passes is checkpointed
        for tag, sd in (("ema", ema_sd), ("live", live_sd)):
            r = evaluate_golden(engine, variables=sd, **gate)
            log(f"[golden] eval@{done}/{tag}: pos={r['n_pos']} "
                f"neg={r['n_neg']} ious={['%.2f' % x for x in r['ious']]} "
                f"top_conf={r.get('top_conf', 0.0):.3f}")
            if 0 < r["n_pos"] <= 6:
                log("[golden]   pred="
                    f"{np.asarray(r['pred_boxes']).astype(int).tolist()}")
            if r["ok"]:
                result.update(r, steps=done, weights=tag)
                winner["sd"] = sd
                return True
        return False

    state = run_device_training(
        state, make_step, data, batch_size, max_steps,
        chunk_steps=min(eval_every, 100), seed=seed, flip_lr=0.5,
        brightness=0.2, on_eval=on_eval, eval_every=eval_every,
        ema_cfg=(cfg.ema_decay, cfg.ema_tau), log=log)
    cand = winner.get("sd")
    if cand is None:
        from .device_loop import weights_of

        cand = weights_of(state["ema"])
    if not result.get("ok"):
        # keep the best-effort weights for inspection
        result = evaluate_golden(engine, variables=cand, **gate)
        result["steps"] = max_steps
    engine.load_state_dict(cand)
    engine.save_weights(ckpt_out)
    log(f"[golden] checkpoint saved to {ckpt_out}")
    # the real gate: a fresh engine loading the checkpoint must still pass
    engine2 = golden_engine(arch, input_size, cfg, state["device"])
    engine2.load_weights(ckpt_out)
    reload = evaluate_golden(engine2, det_thres=gate_det_thres,
                             margin=gate_margin, iou_thres=gate_iou)
    result.update(reload_ok=reload["ok"], reload_ious=reload["ious"],
                  chunk_losses=list(state.get("chunk_losses", [])),
                  n_updates=int(state["n_updates"]), candidate=cand)
    log(f"[golden] reload gate: {reload['ok']} "
        f"ious={['%.2f' % x for x in reload['ious']]}")
    return result
