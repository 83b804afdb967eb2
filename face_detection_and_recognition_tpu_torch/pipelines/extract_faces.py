"""Batch face extraction from class-organized datasets.

The counterpart of ``pipelines/extract_faces.py`` in the JAX package, a
rebuild of ``face_extraction/extract_faces_from_dataset.py``: walks
``dataset/class_x/*`` media, detects faces, saves JPEG crops and/or a
zero-padded ``[MAX_N_FRAME_FROM_VID * MAX_N_FACES_PER_FRAME, D]`` feature
array per media (``save_extracted_faces``, ``:330-363``), with per-class
statistics logging (``:449-458``) and resume-by-existence.

Prefetch-decoded frames accumulate across media into fixed [block, H, W, 3]
blocks (per-resolution buckets, zero-padded tails), each block runs the
fused detect -> crop -> embed ensemble in ONE engine call
(``detect_embed_classify_batch``, B1/B2 or B5 and B3 on the card), and its
valid mask and embeddings come to the host once. Crop offsets (-6, -1, +4,
+5) match ``:290-291``. Crops are written through ``utils/native.py``'s
JPEG route: libjpeg's bytes on a CPU host (cv2's), nvJPEG's on the card's
machine.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.engine import FaceEngine
from ..ops.crop import EXTRACTION_OFFSETS, extraction_crop_region
from ..utils.native import write_image_bgr
from .dataset import (MAX_N_FACES_PER_FRAME, MAX_N_FRAME_FROM_VID,
                      MediaItem, PrefetchLoader, output_exists,
                      walk_class_tree)

logger = logging.getLogger("face_extraction")

NO_MESH = ("mesh=: sharding a block over several cards is not ported yet "
           "(ROADMAP A12)")


@dataclasses.dataclass
class ExtractionStats:
    """Per-class counts, the failed media, the job's wall seconds, and where
    they went (``seconds``): waiting on the decode threads, the device
    blocks (the engine call and its copies to the host), the crop JPEG
    writes and the feature ``.npy`` saves."""

    classes: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    failed: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    seconds: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "decode wait": 0.0, "blocks": 0.0, "crop writes": 0.0,
        "feature saves": 0.0})

    def add(self, cls: str, faces: int, feats: int):
        c = self.classes.setdefault(cls, {"media": 0, "faces": 0, "features": 0})
        c["media"] += 1
        c["faces"] += faces
        c["features"] += feats

    def total_faces(self) -> int:
        return sum(c["faces"] for c in self.classes.values())


def save_extracted_faces(
    out_dir: str,
    item: MediaItem,
    crops: List[np.ndarray],
    frame_features: List[Optional[np.ndarray]],
    feature_dim: int,
    save_crops: bool = True,
    save_features: bool = True,
    max_faces_per_frame: int = MAX_N_FACES_PER_FRAME,
) -> None:
    """JPEG crops under out/class/media_stem/, plus the fixed-size
    zero-padded feature array (reference ``save_extracted_faces:330-363``).

    Slot alignment matches the reference: frame i's faces occupy rows
    [i * max_faces_per_frame, (i+1) * max_faces_per_frame) with per-frame
    zero padding, so consumers can attribute features to frames."""
    stem = os.path.splitext(os.path.basename(item.path))[0]
    if save_crops:
        crop_dir = os.path.join(out_dir, item.class_name, stem)
        os.makedirs(crop_dir, exist_ok=True)
        for i, c in enumerate(crops):
            write_image_bgr(os.path.join(crop_dir, f"face_{i}.jpg"), c)
    if save_features:
        os.makedirs(os.path.join(out_dir, item.class_name), exist_ok=True)
        cap = MAX_N_FRAME_FROM_VID * MAX_N_FACES_PER_FRAME
        padded = np.zeros((cap, feature_dim), np.float32)
        for fi, feats in enumerate(frame_features[:MAX_N_FRAME_FROM_VID]):
            if feats is None or not len(feats):
                continue
            row = fi * max_faces_per_frame
            n = min(len(feats), max_faces_per_frame, cap - row)
            padded[row : row + n] = feats[:n]
        np.save(os.path.join(out_dir, item.class_name, stem + ".npy"), padded)


@dataclasses.dataclass
class _MediaState:
    """Per-media accumulator while its frames travel through device blocks."""

    item: MediaItem
    n_frames: int
    crops: List[np.ndarray] = dataclasses.field(default_factory=list)
    frame_feats: List[Optional[np.ndarray]] = dataclasses.field(
        default_factory=list)
    done: int = 0
    poisoned: bool = False  # a device block containing this media failed


def _host_crops(frame: np.ndarray, boxes: np.ndarray) -> List[np.ndarray]:
    """Variable-size JPEG crops from the original frame with the reference's
    integer offsets (saved artifacts keep native crop resolution, like the
    reference's python slices at ``:296-303``)."""
    h, w = frame.shape[:2]
    out = []
    for box in boxes:
        x1o, y1o, x2o, y2o = extraction_crop_region(box, w, h)
        crop = frame[y1o:y2o, x1o:x2o]
        if crop.size:  # degenerate boxes produce empty slices
            out.append(crop)
    return out


def extract_faces_from_dataset(
    engine: FaceEngine,
    data_dir: str,
    out_dir: str,
    save_crops: bool = True,
    save_features: bool = True,
    max_faces_per_frame: int = MAX_N_FACES_PER_FRAME,
    num_workers: int = 4,
    resume: bool = True,
    block_size: int = 16,
    mesh=None,
) -> ExtractionStats:
    """Run the full extraction job. ``engine`` must carry an embedder when
    save_features is True.

    Frames from all media are packed into fixed [block_size, H, W, 3]
    blocks per source resolution and each block runs ONE fused
    detect+crop+embed call (``engine.detect_embed_classify_batch``).
    Native-resolution detectors run staged detection and a per-frame embed
    inside the same block structure. ``mesh`` (a block sharded over several
    cards) is not ported yet and raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(NO_MESH)
    t0 = time.time()
    stats = ExtractionStats()
    items = walk_class_tree(data_dir)
    if resume:
        items = [
            it for it in items
            if not output_exists(out_dir, it.class_name, it.path, save_features)
        ]
    os.makedirs(out_dir, exist_ok=True)
    dim = engine.embed_spec.dim if engine.embed_spec else 512
    offsets = EXTRACTION_OFFSETS if save_features else None
    fused = engine.spec.input_size != (-1, -1)

    def timed(key, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        stats.seconds[key] += time.perf_counter() - t
        return out

    def finalize(st: _MediaState):
        try:
            n_feats = sum(len(f) for f in st.frame_feats if f is not None)
            for key, crops, feats in (("crop writes", save_crops, False),
                                      ("feature saves", False, save_features)):
                timed(key, save_extracted_faces, out_dir, st.item, st.crops,
                      st.frame_feats, dim, crops, feats, max_faces_per_frame)
            stats.add(st.item.class_name, len(st.crops), n_feats)
        except Exception:  # per-media failure tolerance (reference :446-448)
            logger.exception("failed on %s", st.item.path)
            stats.failed.append(st.item.path)

    def flush(entries):
        """entries: list of (state, frame_pos, frame). ONE fused call.
        A failing block marks its media failed instead of killing the job
        (the reference's per-media tolerance, :446-448, at block altitude)."""
        try:
            _flush(entries)
        except Exception:
            logger.exception("block of %d frames failed", len(entries))
            for st, _, _ in entries:
                if not st.poisoned:
                    st.poisoned = True
                    stats.failed.append(st.item.path)

    def _run_block(imgs):
        """(per-frame detections, valid mask, embeddings or None) of one
        block, on the host."""
        if not fused:  # native-resolution cascade: staged detection
            return engine.detect_batch(imgs).to_numpy(), None, None
        res = engine.detect_embed_classify_batch(
            imgs, embed_offsets=offsets, want_embed=save_features,
            want_ag=False)
        posts = res.det.to_numpy()
        if not save_features or res.embeddings is None:
            return posts, None, None
        # the block's mask and embeddings cross to the host once
        return (posts, res.det.valid.cpu().numpy(),
                res.embeddings.cpu().numpy())

    def _flush(entries):
        frames = [e[2] for e in entries]
        pad = block_size - len(frames)
        imgs = np.stack(frames + [np.zeros_like(frames[0])] * pad)
        posts, valid, embs = timed("blocks", _run_block, imgs)
        for row, (st, pos, frame) in enumerate(entries):
            boxes = posts[row].boxes[:max_faces_per_frame]
            st.crops.extend(_host_crops(frame, boxes))
            if save_features and len(boxes):
                if embs is not None:
                    emb = embs[row][valid[row]][:max_faces_per_frame]
                else:
                    emb = engine.embed_faces(frame, boxes,
                                             offsets=EXTRACTION_OFFSETS)
                st.frame_feats[pos] = np.asarray(emb)
            st.done += 1
            if st.done == st.n_frames and not st.poisoned:
                finalize(st)

    buckets: Dict[tuple, list] = {}
    loader = iter(PrefetchLoader(items, num_workers=num_workers))
    while True:
        got = timed("decode wait", next, loader, None)
        if got is None:
            break
        item, frames = got
        st = _MediaState(item, n_frames=len(frames),
                         frame_feats=[None] * len(frames))
        if not frames:
            # undecodable media is a FAILURE (reference :446-448), not a
            # zero-face success: an all-zero feature file would feed
            # fabricated embeddings downstream and make resume-by-existence
            # skip the file forever
            logger.error("no decodable frames in %s", item.path)
            stats.failed.append(item.path)
            continue
        for pos, (_, frame) in enumerate(frames):
            b = buckets.setdefault(frame.shape, [])
            b.append((st, pos, frame))
            if len(b) == block_size:
                flush(b)
                buckets[frame.shape] = []
    for b in buckets.values():
        if b:
            flush(b)

    stats.wall_s = time.time() - t0
    for cls, c in sorted(stats.classes.items()):
        logger.info("class %s: media=%d faces=%d features=%d",
                    cls, c["media"], c["faces"], c["features"])
    logger.info("total faces=%d failed=%d wall=%.1fs",
                stats.total_faces(), len(stats.failed), stats.wall_s)
    return stats
