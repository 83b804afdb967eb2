"""Per-image feature extraction from face-crop datasets.

The counterpart of ``pipelines/extract_features.py`` in the JAX package, a
rebuild of ``face_extraction/extract_features_from_face_dataset.py``: a tree
of already-cropped face images -> per-image feature ``.npy`` records with
class labels from a pickle/json map (``:126-183``). Each chunk is resized to
the embedder's input on the host (``ops.geometry.host_resize``, cv2's
INTER_LINEAR bit for bit) and embedded in one engine call.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ..ops.geometry import host_resize
from ..utils.files import read_json, read_pickle
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr


def load_class_map(path: Optional[str], data_dir: str) -> Dict[str, int]:
    if path is None:
        classes = sorted(
            os.path.basename(d)
            for d in glob.glob(os.path.join(data_dir, "*"))
            if os.path.isdir(d)
        )
        return {c: i for i, c in enumerate(classes)}
    if path.endswith((".pkl", ".pickle")):
        return read_pickle(path)
    return read_json(path)


def extract_features_from_face_dataset(
    engine,
    data_dir: str,
    out_dir: str,
    class_map_path: Optional[str] = None,
    batch_size: int = 64,
    resume: bool = True,
) -> int:
    """For each face crop image, save ``[D+1]`` array [features..., label]
    as ``out/class/stem.npy``. Returns number of records written."""
    if engine.embed_spec is None:
        raise RuntimeError("engine built without an embedder")
    class_map = load_class_map(class_map_path, data_dir)
    written = 0
    for cls, label in class_map.items():
        cls_dir = os.path.join(data_dir, cls)
        if not os.path.isdir(cls_dir):
            continue
        out_cls = os.path.join(out_dir, cls)
        os.makedirs(out_cls, exist_ok=True)
        paths = sorted(
            p for p in glob.glob(os.path.join(cls_dir, "*"))
            if os.path.splitext(p)[1].lower() in IMAGE_EXTENSIONS
        )
        if resume:
            paths = [
                p for p in paths
                if not os.path.exists(os.path.join(
                    out_cls, os.path.splitext(os.path.basename(p))[0] + ".npy"
                ))
            ]
        ew, eh = engine.embed_spec.input_size
        for i in range(0, len(paths), batch_size):
            chunk = paths[i : i + batch_size]
            imgs = [read_image_bgr(p, formats=IMAGE_EXTENSIONS)
                    for p in chunk]
            pairs = [(p, im) for p, im in zip(chunk, imgs) if im is not None]
            if not pairs:
                continue
            # the images ARE the face crops: resize on the host to the
            # embedder's input and embed the whole chunk in one call
            batch = np.stack([host_resize(im, (ew, eh)) for _, im in pairs])
            feats = engine.embed_crops(batch)
            for (p, _), f in zip(pairs, feats):
                stem = os.path.splitext(os.path.basename(p))[0]
                rec = np.concatenate([f, [float(label)]]).astype(np.float32)
                np.save(os.path.join(out_cls, stem + ".npy"), rec)
                written += 1
    return written
