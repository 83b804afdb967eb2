"""IMDB-WIKI extraction + cleaning.

The counterpart of ``pipelines/imdb_wiki.py`` in the JAX package, a rebuild
of ``face_extraction/extract_and_clean_imdb_wiki_faces.py``:

* .mat metadata parse with Matlab-datenum -> age calculation (``:46-75``),
  through scipy, imported when a file is read;
* 5-bucket age grouping (``:78-92``);
* detect -> crop -> embed -> per-image record (``:105-160``): frames are
  letterboxed on the host (``ops.geometry.host_letterbox``) into fixed
  blocks, detected on the card, and each face cut from the original pixels
  is resized on the host (``host_resize``) and embedded in one batch;
* cleaning filter (age in [0, 100], gender non-nan, exactly one face,
  det_score >= 0.8) with removal-reason counts -> data.npy (``:163-255``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.crop import extraction_crop_region
from ..ops.geometry import host_letterbox, host_resize
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr

AGE_GROUPS: Tuple[Tuple[int, int, str], ...] = (
    (0, 13, "0-13"),
    (14, 24, "14-24"),
    (25, 39, "25-39"),
    (40, 59, "40-59"),
    (60, 100, "60-100"),
)


def matlab_datenum_to_year(datenum: float) -> float:
    """Matlab serial date -> fractional year (ordinal epoch offset 366)."""
    import datetime

    days = float(datenum) - 366.0
    try:
        d = datetime.datetime.fromordinal(max(1, int(days))) + \
            datetime.timedelta(days=days % 1)
        return d.year + (d.timetuple().tm_yday - 1) / 365.25
    except (ValueError, OverflowError):
        return float("nan")


def compute_age(dob_datenum: float, photo_taken_year: float) -> float:
    """Age at photo time (reference ``:46-75``: photo_taken - birth year)."""
    birth_year = matlab_datenum_to_year(dob_datenum)
    return float(photo_taken_year) - birth_year


def age_to_group(age: float) -> Optional[str]:
    for lo, hi, name in AGE_GROUPS:
        if lo <= age <= hi:
            return name
    return None


def load_imdb_wiki_metadata(mat_path: str, db: str = "wiki") -> Dict[str, np.ndarray]:
    """Parse the dataset's .mat: full_path, dob, photo_taken, gender,
    face_score, second_face_score."""
    from scipy.io import loadmat

    mat = loadmat(mat_path)
    meta = mat[db][0, 0]
    return {
        "full_path": np.array([p[0] for p in meta["full_path"][0]]),
        "dob": meta["dob"][0].astype(np.float64),
        "photo_taken": meta["photo_taken"][0].astype(np.float64),
        "gender": meta["gender"][0].astype(np.float64),
        "face_score": meta["face_score"][0].astype(np.float64),
        "second_face_score": meta["second_face_score"][0].astype(np.float64),
    }


@dataclasses.dataclass
class CleaningReport:
    kept: int = 0
    removed: Dict[str, int] = dataclasses.field(default_factory=dict)

    def remove(self, reason: str):
        self.removed[reason] = self.removed.get(reason, 0) + 1


def clean_imdb_wiki(
    meta: Dict[str, np.ndarray],
    det_score_thres: float = 0.8,
) -> Tuple[np.ndarray, CleaningReport]:
    """Apply the reference's cleaning filter (``:163-255``). Returns the kept
    index array and a removal-reason report."""
    n = len(meta["full_path"])
    ages = np.array([
        compute_age(meta["dob"][i], meta["photo_taken"][i]) for i in range(n)
    ])
    report = CleaningReport()
    keep: List[int] = []
    for i in range(n):
        if not np.isfinite(ages[i]) or not (0 <= ages[i] <= 100):
            report.remove("bad_age")
        elif not np.isfinite(meta["gender"][i]):
            report.remove("nan_gender")
        elif not np.isfinite(meta["face_score"][i]) or \
                meta["face_score"][i] < det_score_thres:
            report.remove("low_det_score")
        elif np.isfinite(meta["second_face_score"][i]):
            report.remove("multiple_faces")
        else:
            keep.append(i)
            report.kept += 1
    return np.asarray(keep, np.int64), report


def _unletterbox(boxes: np.ndarray, in_wh, orig_wh) -> np.ndarray:
    """Letterboxed model-space boxes -> original pixels, numpy per image:
    the reference's scale_coords math (``modules/utils/image.py:79-99``),
    float gain and pad removal, clip, round. The port's copy of the JAX
    package's ``eval/coco_eval._unletterbox``, until eval is ported."""
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


def extract_imdb_wiki_faces(
    engine,
    meta: Dict[str, np.ndarray],
    keep_idx: np.ndarray,
    img_root: str,
    out_dir: str,
    limit: Optional[int] = None,
    batch_size: int = 32,
) -> int:
    """Detect + embed the kept images, saving one record per image:
    {path, age, age_group, gender, embedding} -> data.npy at the end.

    IMDB-WIKI images come in thousands of distinct resolutions, so frames
    are letterboxed to the model input on the host and detected in fixed
    [batch, in_h, in_w, 3] blocks; boxes un-letterbox per image, face crops
    are cut from the original pixels with the reference offsets and
    embedded in one batch per block."""
    os.makedirs(out_dir, exist_ok=True)
    records = []
    idxs = keep_idx[: limit if limit else len(keep_idx)]
    iw, ih = engine.input_size
    if (iw, ih) == (-1, -1):
        raise ValueError("imdb-wiki extraction needs a fixed-input detector")
    ew, eh = engine.embed_spec.input_size

    def load(i):
        img = read_image_bgr(os.path.join(img_root, str(meta["full_path"][i])),
                             formats=IMAGE_EXTENSIONS)
        if img is None:
            return None, None
        return img, host_letterbox(img, (ih, iw),
                                   engine.spec.preprocess.fill)

    for start in range(0, len(idxs), batch_size):
        chunk = idxs[start:start + batch_size]
        loaded = [load(i) for i in chunk]
        live = [(i, img, cv) for i, (img, cv) in zip(chunk, loaded)
                if img is not None]
        if not live:
            continue
        block = np.stack([cv for _, _, cv in live])
        if len(live) < batch_size:
            block = np.concatenate([block, np.repeat(
                block[-1:], batch_size - len(live), axis=0)])
        posts = engine.detect_batch(block).to_numpy()[:len(live)]

        crops, pend = [], []
        for (i, img, _), post in zip(live, posts):
            if len(post.boxes) != 1:  # exactly-one-face rule on pixels
                continue
            hh, ww = img.shape[:2]
            box = _unletterbox(np.asarray(post.boxes, np.float64),
                               (iw, ih), (ww, hh))[0]
            x1o, y1o, x2o, y2o = extraction_crop_region(box, ww, hh)
            crop = img[y1o:y2o, x1o:x2o]
            if not crop.size:
                continue
            crops.append(host_resize(crop, (ew, eh)))
            pend.append(i)
        if not crops:
            continue
        embs = engine.embed_crops(np.stack(crops))
        for i, emb in zip(pend, embs):
            age = compute_age(meta["dob"][i], meta["photo_taken"][i])
            records.append({
                "path": str(meta["full_path"][i]),
                "age": age,
                "age_group": age_to_group(age),
                "gender": float(meta["gender"][i]),
                "embedding": emb,
            })
    np.save(os.path.join(out_dir, "data.npy"),
            np.asarray(records, dtype=object), allow_pickle=True)
    return len(records)
