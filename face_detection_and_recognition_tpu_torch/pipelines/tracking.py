"""Face tracking by embedding distance + IoU gating, and labeled extraction.

The counterpart of ``pipelines/tracking.py`` in the JAX package, a rebuild
of ``face_extraction/extract_and_label_faces_from_dataset.py``: a face
matches an existing track when ``(dist < 1.0 and iou > 0.1) or dist <
0.72`` (``:101-116``), with L2 distance for mobile_facenet embeddings and
cosine distance for the reid embedder (``:103-106``). Tracks reset per
media (``:416``). Labels come from a ``labeler`` callback: the engine's
age/gender heads (``auto_age_gender_labeler``), or the reference's key
machine (``interactive_labeler``), which needs the caller's window
callables since the port has no window of its own.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.age_gender import AGE_BUCKETS, GENDERS
from ..ops.boxes import iou_single
from ..ops.crop import EXTRACTION_OFFSETS
from ..utils.files import write_json
from .dataset import PrefetchLoader, walk_class_tree

DIST_IOU_GATE = (1.0, 0.1)   # (dist <, iou >)
DIST_ONLY_GATE = 0.72
LABEL_AGE_BUCKETS = ("0-13", "14-24", "25-39", "40-59", "60-100")
LABEL_WINDOW = "label face: w/e=gender M/F, 1-5=age"
NO_WINDOW = ("interactive_labeler: the port has no display window; pass "
             "show(name, crop) and wait_key(delay) callables of your own")


def embedding_distance(a: np.ndarray, b: np.ndarray, metric: str = "l2") -> float:
    if metric == "l2":
        return float(np.linalg.norm(a - b))
    if metric == "cosine":
        denom = (np.linalg.norm(a) * np.linalg.norm(b)) or 1e-12
        return float(1.0 - (a @ b) / denom)
    raise ValueError(metric)


@dataclasses.dataclass
class Track:
    face_id: int
    embedding: np.ndarray
    box: np.ndarray
    age: Optional[str] = None
    gender: Optional[str] = None


class FaceTracker:
    """Greedy match-or-create tracker (reference
    ``Net.check_if_face_exists/add_face``)."""

    def __init__(self, metric: str = "l2"):
        self.metric = metric
        self.tracks: List[Track] = []
        self._next_id = 0

    def reset(self) -> None:
        """Per-video track reset (reference ``:416``)."""
        self.tracks.clear()

    def match_or_add(self, embedding: np.ndarray, box: np.ndarray) -> Tuple[Track, bool]:
        """Returns (track, is_new). Matches update the stored embedding/box
        and carry the track's age/gender labels forward (the reference reuses
        labels on re-identified faces, check_if_face_exists)."""
        for tr in self.tracks:
            dist = embedding_distance(embedding, tr.embedding, self.metric)
            iou = float(iou_single(torch.from_numpy(box.astype(np.float32)),
                                   torch.from_numpy(tr.box.astype(np.float32))))
            if (dist < DIST_IOU_GATE[0] and iou > DIST_IOU_GATE[1]) or (
                dist < DIST_ONLY_GATE
            ):
                tr.embedding = embedding
                tr.box = box
                return tr, False
        tr = Track(self._next_id, embedding, box)
        self._next_id += 1
        self.tracks.append(tr)
        return tr, True


def auto_age_gender_labeler(engine) -> Callable:
    """Labeler backed by the engine's age/gender heads, the headless
    replacement for the reference's interactive labeling: the face's
    227x227 crop with the +-5 px padding, clip and mean fused into the crop
    kernel (the engine's own age/gender crop), then both heads."""

    def label(frame: np.ndarray, box: np.ndarray) -> Tuple[str, str]:
        with torch.inference_mode():
            boxes = torch.as_tensor(np.asarray(box, np.float32)[None],
                                    device=engine.device)
            crops = engine._ag_crops(engine._frames(frame), boxes, clip=True)
            a, g = engine._classify(crops)
        return (AGE_BUCKETS[int(a[0].argmax())],
                GENDERS[int(g[0].argmax())])

    return label


def interactive_labeler(show: Optional[Callable] = None,
                        wait_key: Optional[Callable] = None) -> Callable:
    """The reference's manual labeling flow
    (``extract_and_label_faces_from_dataset.py:194-234``): the face crop is
    shown, 'w'/'e' pick gender Male/Female, '1'-'5' pick an age bucket, ESC
    skips with Unknowns. The port has no window: ``show(name, crop)`` and
    ``wait_key(delay) -> key code`` are the caller's (cv2.imshow and
    cv2.waitKey, say); without them this raises ``RuntimeError``."""
    if show is None or wait_key is None:
        raise RuntimeError(NO_WINDOW)

    def label(frame: np.ndarray, box: np.ndarray) -> Tuple[str, str]:
        x1, y1, x2, y2 = (max(0, int(v)) for v in box)
        show(LABEL_WINDOW, frame[y1:y2, x1:x2])
        gender = age = None
        while gender is None or age is None:
            key = wait_key(0) & 0xFF
            if key == ord("w"):
                gender = "Male"
            elif key == ord("e"):
                gender = "Female"
            elif ord("1") <= key <= ord("5"):
                age = LABEL_AGE_BUCKETS[key - ord("1")]
            elif key == 27:  # ESC skips
                gender = gender or "Unknown"
                age = age or "Unknown"
        return age, gender

    return label


def extract_and_label_faces(
    engine,
    data_dir: str,
    out_dir: str,
    labeler: Optional[Callable] = None,
    metric: str = "l2",
    num_workers: int = 4,
) -> Dict[str, dict]:
    """Labeled extraction: per media, detections are tracked across frames
    and annotated with face_ids (+ age/gender when a labeler is given).
    Returns the annotation dict {media: {face_ids, ages, genders, boxes}}
    (reference annot dict ``:316-355``); a media that cannot be read gets
    empty lists."""
    annotations: Dict[str, dict] = {}
    items = walk_class_tree(data_dir)
    os.makedirs(out_dir, exist_ok=True)
    for item, frames in PrefetchLoader(items, num_workers=num_workers):
        tracker = FaceTracker(metric=metric)  # reset per media
        ann = {"face_ids": [], "ages": [], "genders": [], "boxes": []}
        for _, frame in frames:
            post = engine.detect_image(frame)
            if not len(post.boxes):
                continue
            emb = engine.embed_faces(frame, post.boxes,
                                     offsets=EXTRACTION_OFFSETS)
            for box, e in zip(post.boxes, emb):
                track, is_new = tracker.match_or_add(e, np.asarray(box))
                if labeler is not None and is_new:
                    track.age, track.gender = labeler(frame, np.asarray(box))
                # one aligned entry PER detection; matched faces reuse the
                # track's labels instead of being skipped
                ann["face_ids"].append(int(track.face_id))
                ann["boxes"].append([int(v) for v in box])
                ann["ages"].append(track.age)
                ann["genders"].append(track.gender)
        key = os.path.join(item.class_name, os.path.basename(item.path))
        annotations[key] = ann
    write_json(annotations, os.path.join(out_dir, "annotations.json"))
    return annotations
