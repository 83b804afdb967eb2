"""Trained weights on the card: the golden checkpoints as the port's own
weight files, and the golden gate's arithmetic.

``card_weights/`` at the repository root holds the trained nets of the
JAX package's golden gates (yolov5s, the static int8 yolov5n, BlazeFace
front, MTCNN, MobileFaceNet) as ``.pt`` files the port writes
(``FaceEngine.save_weights`` for the detectors, the embedder slot's state
dict for MobileFaceNet), the golden image and the negative one, and
``expected.json``: each gate's thresholds and IoU bars as the JAX tests set
them, and what the JAX engines detect (and embed) on the CPU. The machine
with the card has no orbax and no ``tests/data``, so this folder is how a
trained net reaches it. ``tools/make_card_weights.py`` writes it;
``tests/test_torch_card_weights.py`` keeps it equal to the checkpoints.

The gate is the JAX package's ``evaluate_golden``
(``train/golden.py:550-623``): the engine's ``detect_image`` at the
gate's threshold and at the threshold less and plus its margin, on the
golden image (3 faces at IoU >= ``iou_thres`` each, greedily matched to
the pinned boxes) and on the negative one resized to the golden image's
size (no face). ``ok`` holds when every threshold passes; the IoUs, the
counts and the bars are those of the centre threshold.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import EngineConfig, FaceEngine
from ..ops.geometry import host_resize
from ..utils.native import read_image_bgr

CARD_WEIGHTS = Path(__file__).resolve().parents[2] / "card_weights"
EXPECTED = "expected.json"
POS_IMAGE, NEG_IMAGE = "test2_faces_3.jpg", "test1_faces_0.jpg"


def load_expected(root: Path = CARD_WEIGHTS) -> Dict:
    """``expected.json`` of the folder ``root``."""
    with open(Path(root) / EXPECTED) as f:
        return json.load(f)


def golden_pair(pos_path: str, neg_path: str):
    """(golden, negative) BGR uint8 frames, decoded by the port's codec
    (``cv2.imread``'s pixels); the negative one resized to the golden
    one's size by ``host_resize`` (``cv2.resize``'s), as
    ``evaluate_golden`` feeds it (one pipeline for both gate images)."""
    pos, neg = read_image_bgr(str(pos_path)), read_image_bgr(str(neg_path))
    if pos is None or neg is None:
        raise FileNotFoundError(f"{pos_path} / {neg_path}: the golden "
                                "images do not decode")
    if neg.shape != pos.shape:
        neg = host_resize(neg, (pos.shape[1], pos.shape[0]))
    return pos, neg


def golden_images(root: Path = CARD_WEIGHTS):
    """``golden_pair`` of the folder ``root``'s two images."""
    return golden_pair(Path(root) / POS_IMAGE, Path(root) / NEG_IMAGE)


def bbox_iou_xyxy(a: Sequence[float], b: Sequence[float]) -> float:
    """Plain IoU of two xyxy boxes (the reference test's metric)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return float(inter / ua) if ua > 0 else 0.0


def match_golden(pred: np.ndarray, gt: np.ndarray) -> List[float]:
    """Greedy one-to-one matching of predictions to the pinned boxes, on
    descending IoU: each pinned box's IoU after assignment (0 unmatched)."""
    ious = np.zeros((len(gt), len(pred)), np.float32)
    for i, g in enumerate(gt):
        for j, p in enumerate(pred):
            ious[i, j] = bbox_iou_xyxy(g, p)
    out = [0.0] * len(gt)
    done, used = set(), set()
    order = np.dstack(np.unravel_index(np.argsort(-ious, axis=None),
                                       ious.shape))[0]
    for gi, pj in order:
        if gi in done or pj in used:
            continue
        out[int(gi)] = float(ious[gi, pj])
        done.add(int(gi))
        used.add(int(pj))
    return out


def gate_thresholds(gate: Dict) -> List[float]:
    """The centre threshold, then less and plus the margin."""
    t, m = gate["det_thres"], gate["margin"]
    return [t, t - m, t + m] if m else [t]


def run_gate(engine: FaceEngine, pos: np.ndarray, neg: np.ndarray,
             gate: Dict, golden: np.ndarray) -> Dict:
    """``evaluate_golden`` on ``engine``: for each threshold the boxes and
    scores on both frames; ``ok``, the centre's counts and IoUs."""
    runs, ok = [], True
    for t in gate_thresholds(gate):
        run = {"thres": t}
        for tag, img in (("pos", pos), ("neg", neg)):
            post = engine.detect_image(img, det_thres=t)
            run[tag] = np.asarray(post.boxes, np.float32).reshape(-1, 4)
            run[tag + "_conf"] = np.asarray(post.bbox_confs,
                                            np.float32).reshape(-1)
        ious = (match_golden(run["pos"], golden) if len(run["pos"])
                else [0.0] * len(golden))
        ok &= (len(run["pos"]) == len(golden)
               and all(i >= gate["iou_thres"] for i in ious)
               and len(run["neg"]) == 0)
        run["ious"] = ious
        runs.append(run)
    centre = runs[0]
    return {"ok": bool(ok), "n_pos": int(len(centre["pos"])),
            "n_neg": int(len(centre["neg"])), "ious": centre["ious"],
            "runs": runs}


def gate_failures(result: Dict, gate: Dict) -> List[str]:
    """What the JAX test of the net asserts, each failure named: ``ok``
    where it asserts it, 3 faces and none on the negative image at the
    centre, and the centre's IoUs, in ascending order, at or above
    ``iou_bars``."""
    bad = []
    if gate["require_ok"] and not result["ok"]:
        bad.append("not ok across the margin")
    if result["n_pos"] != 3:
        bad.append(f"{result['n_pos']} faces on the golden image")
    if result["n_neg"] != 0:
        bad.append(f"{result['n_neg']} faces on the negative image")
    for iou, bar in zip(sorted(result["ious"]), gate["iou_bars"]):
        if iou < bar:
            bad.append(f"IoU {iou:.4f} under {bar}")
    return bad


def box_difference(got: np.ndarray, ref: np.ndarray) -> Optional[float]:
    """The largest coordinate difference between each box of ``got`` and
    its nearest box of ``ref`` (both [N, 4]); None when the counts
    differ, 0 for two empty sets."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if len(got) != len(ref):
        return None
    if len(got) == 0:
        return 0.0
    d = np.abs(got[:, None, :] - ref[None, :, :]).max(-1)
    return float(d.min(1).max())


def jax_differences(result: Dict, jax_runs: List[Dict]) -> List[Dict]:
    """For each threshold and frame, the counts of the port and of JAX and
    the largest box difference (``box_difference``)."""
    out = []
    for run, ref in zip(result["runs"], jax_runs):
        if abs(run["thres"] - ref["thres"]) > 1e-9:
            raise ValueError(f"threshold {run['thres']} against JAX's "
                             f"{ref['thres']}")
        for tag in ("pos", "neg"):
            out.append({"thres": run["thres"], "frame": tag,
                        "n": int(len(run[tag])), "jax_n": len(ref[tag]),
                        "max_px": box_difference(run[tag], ref[tag])})
    return out


def build_engine(entry: Dict, device=None,
                 root: Path = CARD_WEIGHTS) -> FaceEngine:
    """The engine an ``expected.json`` entry names (detector, dtype,
    overrides, embedder) with its weight file loaded: ``load_weights``
    for a detector (an int8 file rebuilds the net in its mode),
    ``load_embed_weights`` for an embedder."""
    cfg = EngineConfig(detector=entry["detector"], det_thres=0.5,
                       dtype=entry.get("dtype", "float32"),
                       embedder=entry.get("embedder"),
                       detector_overrides=dict(entry.get("overrides", {})))
    eng = FaceEngine(cfg, device=device)
    path = str(Path(root) / entry["file"])
    if entry.get("embedder"):
        eng.load_embed_weights(path)
    else:
        eng.load_weights(path)
    return eng


# the committed int8 file's scales were calibrated by the JAX quantizer on
# another platform: the JAX package on the CPU puts them up to 4.5 % away
COMMITTED_SCALE_RTOL = 0.05
JAX_SCALE_RTOL = 1e-4   # the port against the JAX quantizer on the CPU


def scale_differences(scales: Dict[str, float], entry: Dict,
                      root: Path = CARD_WEIGHTS) -> Dict[str, float]:
    """The largest relative difference of calibrated activation scales
    ({module path: scale}, ``utils.quantize.calibrate_activation_scales``)
    from the JAX CPU calibration stored in ``entry`` (``expected.json``'s
    ``quantize`` entry) and from the committed int8 file's ``ascale``s;
    raises ``AssertionError`` when a path is missing or either exceeds its
    tolerance (``JAX_SCALE_RTOL``, ``COMMITTED_SCALE_RTOL``)."""
    from ..core.engine import read_state_dict

    committed = {k[:-len(".ascale")]: float(v) for k, v in read_state_dict(
        str(Path(root) / entry["int8_file"])).items()
        if k.endswith(".ascale")}
    ref = entry["jax_ascale"]
    if set(scales) != set(ref) or set(ref) != set(committed):
        raise AssertionError("calibrated layers differ: "
                             f"{sorted(set(scales) ^ set(ref))}")
    out = {"jax_cpu": max(abs(scales[k] - ref[k]) / ref[k] for k in ref),
           "committed": max(abs(scales[k] - committed[k]) / committed[k]
                            for k in ref)}
    if out["jax_cpu"] > JAX_SCALE_RTOL \
            or out["committed"] > COMMITTED_SCALE_RTOL:
        raise AssertionError(f"activation scales off: {out}")
    return out


def cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity of two [N, D] arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def check_detector(name: str, entry: Dict, engine: FaceEngine,
                   pos: np.ndarray, neg: np.ndarray,
                   golden: np.ndarray) -> Dict:
    """Hold a detector's engine to its gate (where the JAX engine passes
    it) and to the JAX engine's detections in ``entry``; raises
    ``AssertionError`` naming what failed, else returns a summary: the
    gate's result and the differences from JAX."""
    gate = entry["gate"]
    with torch.inference_mode():
        res = run_gate(engine, pos, neg, gate, golden)
    diffs = jax_differences(res, entry["jax"]["runs"])
    bad = []
    if entry["jax"]["gate_passes"]:
        bad += gate_failures(res, gate)
    for d in diffs:
        if d["n"] != d["jax_n"]:
            bad.append(f"{d['n']} boxes against JAX's {d['jax_n']} at "
                       f"{d['thres']:.4g} on the {d['frame']} frame")
        elif entry["max_px"] is not None and d["max_px"] > entry["max_px"]:
            bad.append(f"boxes {d['max_px']} px from JAX's at "
                       f"{d['thres']:.4g} on the {d['frame']} frame")
    summary = {"ok": res["ok"], "n_pos": res["n_pos"], "n_neg": res["n_neg"],
               "ious": [round(i, 4) for i in res["ious"]],
               "max_px": max((d["max_px"] or 0.0) for d in diffs)}
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad)
                             + f" ({json.dumps(summary)})")
    return summary


def check_embedder(name: str, entry: Dict, engine: FaceEngine,
                   pos: np.ndarray) -> Dict:
    """The embedder's embeddings of the pinned face crops against JAX's:
    each at cosine >= ``cos_min``."""
    with torch.inference_mode():
        emb = engine.embed_faces(pos, np.asarray(entry["boxes"], np.float32))
    cos = cosines(emb, np.asarray(entry["jax"]["embeddings"], np.float32))
    if not (cos >= entry["cos_min"]).all():
        raise AssertionError(f"{name}: cosines {cos.tolist()} under "
                             f"{entry['cos_min']}")
    return {"cosines": [float(c) for c in cos]}
