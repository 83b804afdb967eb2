"""Trained weights on the card: the golden checkpoints as the port's own
weight files, the golden gate's arithmetic, and the crowded AP gates.

``card_weights/`` at the repository root holds the trained nets of every
golden gate of the JAX package's regate (``benchmarks/regate_golden.py``)
but FaceNet, FaceNet-512 and the age/gender cascade: the yolov5 family
(yolov5s, yolov5n f32 and static int8, n6, the official head, the crowded
n and s6), BlazeFace front and back, the three SSDs, res10-ssd, the
OpenVINO nets, MTCNN, MobileFaceNet and reid, as ``.pt`` files the port
writes (``FaceEngine.save_weights`` for the detectors, the embedder
slot's state dict for the embedders); the reference's own res10
``.caffemodel`` and two OpenVINO IRs (``.xml`` + ``.bin``); the golden
image and the negative one; and ``expected.json``: each gate's thresholds
and IoU bars as the JAX tests set them, what the JAX engines detect (and
embed) on the CPU, the embedders' 3-identity filter gates, and the
crowded set of ``tests/test_crowded_accuracy.py`` (its files' digests,
each net's JAX AP and floors, the max_det saturation case). The machine
with the card has no orbax and no ``tests/data``, so this folder is how a
trained net reaches it. ``tools/make_card_weights.py`` writes it;
``tests/test_torch_card_weights*.py`` and ``tests/test_torch_crowded*.py``
keep it equal to the checkpoints.

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


def engine_overrides(entry: Dict, root: Optional[Path] = None) -> Dict:
    """An entry's ``detector_overrides``, JSON's lists made tuples (an
    ``input_size``); with ``root``, an IR file (``.xml``) becomes
    openvino-ir's ``xml`` override (the file is the net)."""
    out = {k: tuple(v) if isinstance(v, list) else v
           for k, v in entry.get("overrides", {}).items()}
    if root is not None and entry["file"].endswith(".xml"):
        out["xml"] = str(Path(root) / entry["file"])
    return out


def build_engine(entry: Dict, device=None, root: Path = CARD_WEIGHTS,
                 **cfg) -> FaceEngine:
    """The engine an ``expected.json`` entry names (detector, dtype,
    overrides, embedder) with its weight file loaded: ``load_weights``
    for a detector (an int8 file rebuilds the net in its mode; a
    reference ``.caffemodel`` goes through the detector's importer),
    ``load_embed_weights`` for an embedder; an OpenVINO IR (``.xml``)
    is openvino-ir's ``xml`` override. ``cfg``: more ``EngineConfig``
    fields (det_thres 0.5 by default)."""
    eng = FaceEngine(EngineConfig(
        detector=entry["detector"], **{"det_thres": 0.5, **cfg},
        dtype=entry.get("dtype", "float32"), embedder=entry.get("embedder"),
        detector_overrides=engine_overrides(entry, root)), device=device)
    path = str(Path(root) / entry["file"])
    if entry.get("embedder"):
        eng.load_embed_weights(path)
    elif not path.endswith(".xml"):
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


# the filter gate's margin (nearest other mean less farthest own probe,
# in embedding distance) against JAX's on the CPU
FILTER_MARGIN_TOL = 0.01


def check_embedder(name: str, entry: Dict, engine: FaceEngine,
                   pos: np.ndarray) -> Dict:
    """The embedder's embeddings of the pinned face crops against JAX's,
    each at cosine >= ``cos_min``, and the 3-identity filter gate
    (``train/golden_embed.evaluate_identity_filter`` on ``embed_crops``,
    the JAX regate's ``embed_gate``): passed where JAX's passes, the same
    accuracies, the margin within ``FILTER_MARGIN_TOL`` of JAX's."""
    from ..train.golden_embed import evaluate_identity_filter

    with torch.inference_mode():
        emb = engine.embed_faces(pos, np.asarray(entry["boxes"], np.float32))
        gate = evaluate_identity_filter(engine.embed_crops,
                                        size=entry["filter_size"])
    cos = cosines(emb, np.asarray(entry["jax"]["embeddings"], np.float32))
    ref = entry["jax"]["filter"]
    bad = []
    if not (cos >= entry["cos_min"]).all():
        bad.append(f"cosines {cos.tolist()} under {entry['cos_min']}")
    if ref["ok"] and not gate["ok"]:
        bad.append("the filter gate fails")
    for key in ("same_acc", "cross_acc"):
        if gate[key] != ref[key]:
            bad.append(f"{key} {gate[key]} against JAX's {ref[key]}")
    if abs(gate["margin"] - ref["margin"]) > FILTER_MARGIN_TOL:
        bad.append(f"margin {gate['margin']:.4f} against JAX's "
                   f"{ref['margin']:.4f}")
    summary = {"cosines": [float(c) for c in cos], "filter_ok": gate["ok"],
               "same_acc": gate["same_acc"], "cross_acc": gate["cross_acc"],
               "margin": gate["margin"], "jax_margin": ref["margin"]}
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad)
                             + f" ({json.dumps(summary)})")
    return summary


# ---------------- the crowded set (tests/test_crowded_accuracy.py) -------

CROWDED_ANN = "gt.txt"


def crowded_digests(ann: str, images_root: str) -> Dict[str, str]:
    """{file: sha256 of its bytes} of a WIDER-format set: the annotation
    file (``gt.txt``) and each image by its path under ``images_root``."""
    import hashlib

    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    out = {CROWDED_ANN: digest(ann)}
    root = Path(images_root)
    for path in sorted(root.rglob("*.jpg")):
        out[path.relative_to(root).as_posix()] = digest(path)
    return out


def crowded_set(out_dir: str, entry: Dict):
    """(ann_file, images_root) of the crowded set that ``entry``
    (``expected.json``'s ``crowded``) describes, built by the port's
    ``train/golden.make_crowded_dataset``; raises ``AssertionError`` when
    a file's bytes differ from the stored digests (the JAX package's)."""
    from ..train.golden import make_crowded_dataset

    ann, images_root = make_crowded_dataset(
        out_dir, n_images=entry["n_images"], out_wh=tuple(entry["out_wh"]),
        seed=entry["seed"])
    got = crowded_digests(ann, images_root)
    bad = sorted(k for k in set(got) | set(entry["digests"])
                 if got.get(k) != entry["digests"].get(k))
    if bad:
        raise AssertionError(f"the crowded set differs from the JAX "
                             f"package's in {bad}")
    return ann, images_root


def crowded_engine(entry: Dict, net_entry: Dict, device=None,
                   root: Path = CARD_WEIGHTS) -> FaceEngine:
    """The engine of a crowded net (``net_entry``: its ``nets`` row) at
    the crowded set's thresholds (``entry``)."""
    return build_engine(net_entry, device, root,
                        det_thres=entry["det_thres"],
                        bbox_area_thres=entry["bbox_area_thres"],
                        max_det=entry["max_det"])


def check_crowded(name: str, entry: Dict, engine: FaceEngine, ann: str,
                  images_root: str) -> Dict:
    """The crowded AP gate of ``name`` (``entry``: ``expected.json``'s
    ``crowded``): the port's ``eval/coco_eval.evaluate_engine_on_wider``
    at the set's batch size, each floor held and AP50 / AP within
    ``ap_tol`` of the JAX CPU engine's. Returns the metrics."""
    from .coco_eval import evaluate_engine_on_wider

    net = entry["nets"][name]
    with torch.inference_mode():
        m = evaluate_engine_on_wider(engine, ann, images_root,
                                     batch_size=entry["batch_size"])
    bad = [f"{k} {m[k]:.4f} under its floor {v}"
           for k, v in net["floors"].items() if m[k] < v]
    bad += [f"{k} {m[k]:.4f} against JAX's {net['jax'][k]:.4f}"
            for k in ("AP50", "AP")
            if abs(m[k] - net["jax"][k]) > entry["ap_tol"]]
    out = {k: float(v) for k, v in m.items()}
    if bad:
        raise AssertionError(f"crowded {name}: " + "; ".join(bad)
                             + f" ({json.dumps(out)})")
    return out


def saturation_frame(entry: Dict, ann: str, images_root: str):
    """(frame, its ground truth as xyxy) of the saturation case: the
    most crowded image of the set (``entry``: ``crowded.saturation``)."""
    from .coco_eval import parse_wider_annotations

    gt = parse_wider_annotations(ann)
    rel = max(gt, key=lambda k: len(gt[k]))
    if rel != entry["frame"] or len(gt[rel]) < entry["min_gt"]:
        raise AssertionError(f"saturation frame {rel} with {len(gt[rel])} "
                             f"faces, JAX's {entry['frame']}")
    xywh = np.asarray(gt[rel], np.float32)[:, :4]
    img = read_image_bgr(str(Path(images_root) / rel))
    return img, np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1)


def check_saturation(entry: Dict, small: FaceEngine, big: FaceEngine,
                     img: np.ndarray, gt: np.ndarray) -> Dict:
    """max_det saturation (JAX ``tests/test_crowded_accuracy.py:151-205``):
    the ``max_det`` engine ``small`` fills every slot, the frame
    overflows them in ``big`` (``max_det_ref``), ``small``'s boxes are
    ``big``'s top ``max_det`` by confidence (IoU > ``match_iou``,
    confidences within ``conf_tol``), and each overlaps a face at IoU >=
    ``gt_iou``; the top boxes within ``max_px`` of the JAX engine's
    (``entry["jax_ref"]``)."""
    with torch.inference_mode():
        posts = [small.detect_image(img), big.detect_image(img)]
    (b8, c8), (b64, c64) = [(np.asarray(p.boxes, np.float32).reshape(-1, 4),
                             np.asarray(p.bbox_confs, np.float32))
                            for p in posts]
    k, bad = entry["max_det"], []
    if len(b8) != k:
        bad.append(f"{len(b8)} boxes at max_det {k}")
    if len(b64) <= k:
        bad.append(f"{len(b64)} boxes at max_det {entry['max_det_ref']}")
    order = np.argsort(-c64, kind="stable")[:k]
    top, used = b64[order], np.zeros(len(order), bool)
    for bb in b8:
        ious = [0.0 if used[j] else bbox_iou_xyxy(bb, top[j])
                for j in range(len(top))]
        j = int(np.argmax(ious)) if ious else 0
        if not ious or ious[j] <= entry["match_iou"]:
            bad.append(f"box {bb.tolist()} not among the top {k}")
            continue
        used[j] = True
    conf_gap = (float(np.abs(np.sort(c8) - np.sort(c64[order])).max())
                if len(c8) == len(order) and len(c8) else None)
    if conf_gap is None or conf_gap > entry["conf_tol"]:
        bad.append(f"confidences {conf_gap} from the top {k}'s")
    least = min((max(bbox_iou_xyxy(bb, g) for g in gt) for bb in b8),
                default=0.0)
    if least < entry["gt_iou"]:
        bad.append(f"a kept box overlaps no face (IoU {least:.3f})")
    jax_top = np.asarray(entry["jax_ref"]["boxes"], np.float32)
    out = {"n": len(b8), "n_ref": len(b64), "conf_gap": conf_gap,
           "least_gt_iou": float(least),
           "jax_max_px": box_difference(top, jax_top),
           "jax_conf_gap": (float(np.abs(np.sort(c64[order]) - np.sort(
               entry["jax_ref"]["confs"])).max())
               if len(order) == len(jax_top) else None)}
    if out["jax_max_px"] is None or out["jax_max_px"] > entry["max_px"]:
        bad.append(f"the top {k} {out['jax_max_px']} px from JAX's")
    if bad:
        raise AssertionError("saturation: " + "; ".join(bad)
                             + f" ({json.dumps(out)})")
    return out
