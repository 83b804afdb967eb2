"""Write ``card_weights/``: the golden checkpoints as the port's own weight
files, with what the JAX package's engines give on them.

    python tools/make_card_weights.py [--out card_weights]

Reads the orbax checkpoints under ``tests/data`` through the JAX package's
``load_variables`` (float leaves cast to f32, int8 codes kept), converts
each through the port's bridge (``utils/weights.py``) and writes:

- ``yolov5s.pt``, ``yolov5n.pt`` (the f32 net ``quantize_golden``
  quantizes), ``yolov5n_int8.pt`` (static scales included),
  ``blazeface_front.pt``, ``mtcnn.pt``: ``FaceEngine.save_weights`` of a
  CPU engine holding the bridged state dict;
- ``mobile_facenet.pt``: the embedder slot's state dict;
- the golden image and the negative one, copied;
- ``expected.json``: the pinned boxes (``GOLDEN_BOXES_3``), each net's
  engine settings, its gate (thresholds, margin and IoU bars, as the JAX
  tests set them), the JAX CPU engine's boxes and scores at each of the
  gate's thresholds on both images and whether the JAX engine passes the
  gate; yolov5s and MTCNN also through a bf16 JAX engine; MobileFaceNet's
  embeddings of the three pinned face crops (``embed_faces``); the
  static activation scales that the JAX ``quantize_golden`` calibrates for
  the golden yolov5n on this CPU (``QUANTIZE``: its composites, seed and
  count), beside which the port's quantizer is held.

Runs JAX on the CPU at the tests' matmul precision ("highest").
``tests/test_torch_card_weights.py`` holds the folder to this script's
output. The port loads the folder with ``eval/card_weights.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"

# name -> (checkpoint, port file, engine settings, gate); the gates are
# those of tests/test_golden_accuracy.py: yolov5s :280-299, yolov5n
# :26-45, int8 :397-421,
# BlazeFace front :134-165, MTCNN :432-450
YOLO_GATE = {"det_thres": 0.6, "margin": 0.15, "iou_thres": 0.5,
             "require_ok": True, "iou_bars": [0.8, 0.8, 0.8]}
NETS = {
    "yolov5s": ("golden_yolov5s_ckpt", "yolov5s.pt",
                {"detector": "yolov5s"}, YOLO_GATE, 1.0),
    "yolov5s-bf16": ("golden_yolov5s_ckpt", "yolov5s.pt",
                     {"detector": "yolov5s", "dtype": "bfloat16"},
                     YOLO_GATE, 1.0),
    "yolov5n": ("golden_yolov5n_ckpt", "yolov5n.pt",
                {"detector": "yolov5n"}, YOLO_GATE, 1.0),
    "yolov5n-int8": ("golden_yolov5n_int8_ckpt", "yolov5n_int8.pt",
                     {"detector": "yolov5n",
                      "overrides": {"quantized": "static"}},
                     {"det_thres": 0.575, "margin": 0.125, "iou_thres": 0.5,
                      "require_ok": True, "iou_bars": [0.75, 0.75, 0.75]},
                     None),
    "blazeface-front": ("golden_blaze_ckpt", "blazeface_front.pt",
                        {"detector": "blazeface-front"},
                        {"det_thres": 0.5, "margin": 0.05, "iou_thres": 0.5,
                         "require_ok": False, "iou_bars": [0.5, 0.7, 0.8]},
                        1.0),
    "mtcnn": ("golden_mtcnn_ckpt", "mtcnn.pt", {"detector": "mtcnn"},
              {"det_thres": 0.5, "margin": 0.05, "iou_thres": 0.5,
               "require_ok": False, "iou_bars": [0.8, 0.8, 0.8]}, 1.0),
    "mtcnn-bf16": ("golden_mtcnn_ckpt", "mtcnn.pt",
                   {"detector": "mtcnn", "dtype": "bfloat16"},
                   {"det_thres": 0.5, "margin": 0.05, "iou_thres": 0.5,
                    "require_ok": False, "iou_bars": [0.8, 0.8, 0.8]}, 1.0),
}
EMBEDDER = ("golden_embed_ckpt", "mobile_facenet.pt", "mobile_facenet")
# the JAX cli/quantize_golden.py calibration of the golden yolov5n
QUANTIZE = {"checkpoint": "golden_yolov5n_ckpt", "file": "yolov5n.pt",
            "int8_file": "yolov5n_int8.pt", "arch": "yolov5n", "size": 640,
            "n_calib": 32, "batch": 8, "seed": 515}
COS_MIN = 0.999


def load_f32(name: str):
    """A checkpoint's floats as f32 numpy; int8 codes stay int8."""
    import jax
    import numpy as np

    from face_detection_and_recognition_tpu.utils.checkpoint import \
        load_variables

    def cast(a):
        a = np.asarray(a)
        return a if a.dtype == np.int8 else a.astype(np.float32)

    return jax.tree_util.tree_map(cast, load_variables(str(DATA / name)))


def port_state_dict(ckpt: str):
    """The bridge's conversion of the checkpoint ``ckpt``."""
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    v = load_f32(ckpt)
    return {
        "golden_yolov5s_ckpt": lambda: W.yolov5_face_state_dict(v, "yolov5s"),
        "golden_yolov5n_ckpt": lambda: W.yolov5_face_state_dict(v, "yolov5n"),
        "golden_yolov5n_int8_ckpt":
            lambda: W.yolov5_face_state_dict(v, "yolov5n"),
        "golden_blaze_ckpt": lambda: W.blazeface_state_dict(v, False),
        "golden_mtcnn_ckpt": lambda: W.mtcnn_state_dict(v),
        "golden_embed_ckpt": lambda: W.mobile_facenet_state_dict(v),
    }[ckpt]()


def port_files():
    """{file name: the state dict written there}: each net's bridged
    state dict as ``FaceEngine.save_weights`` (a CPU engine holding it)
    and the embedder slot's state dict would write it."""
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)

    files = {}
    for name, (ckpt, file, settings, _, _) in NETS.items():
        if file in files:
            continue
        eng = FaceEngine(EngineConfig(
            detector=settings["detector"],
            detector_overrides=dict(settings.get("overrides", {}))),
            device="cpu")
        eng.load_state_dict(port_state_dict(ckpt))
        files[file] = {k: v.clone() for k, v in eng.net.state_dict().items()}
    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder=EMBEDDER[2]), device="cpu")
    eng.load_embed_state_dict(port_state_dict(EMBEDDER[0]))
    files[EMBEDDER[1]] = {k: v.clone()
                          for k, v in eng.embed_net.state_dict().items()}
    return files


def jax_engine(settings, ckpt):
    """The JAX CPU engine of ``settings`` holding the f32-cast checkpoint
    (int8 codes kept)."""
    import jax.numpy as jnp

    from face_detection_and_recognition_tpu.core.engine import (
        EngineConfig, FaceEngine)

    eng = FaceEngine(EngineConfig(
        detector=settings["detector"], det_thres=0.5,
        dtype=jnp.bfloat16 if settings.get("dtype") == "bfloat16"
        else jnp.float32,
        detector_overrides=dict(settings.get("overrides", {}))))
    eng.variables = load_f32(ckpt)
    return eng


def jax_runs(eng, gate, pos, neg):
    """The JAX engine's boxes and scores at each of the gate's thresholds
    on both frames, and whether it passes the gate (the port's gate
    arithmetic, ``evaluate_golden``'s, run on the JAX engine)."""
    from face_detection_and_recognition_tpu.train.golden import \
        GOLDEN_BOXES_3
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    res = CW.run_gate(eng, pos, neg, gate, GOLDEN_BOXES_3)
    return {"gate_passes": not CW.gate_failures(res, gate), "ok": res["ok"],
            "ious": res["ious"],
            "runs": [{k: v.tolist() if hasattr(v, "tolist") else v
                      for k, v in r.items() if k != "ious"}
                     for r in res["runs"]]}


def expected():
    """``expected.json``'s content, computed by the JAX engines."""
    import cv2
    import numpy as np

    from face_detection_and_recognition_tpu.train.golden import \
        GOLDEN_BOXES_3

    pos = cv2.imread(str(DATA / "test2_faces_3.jpg"))
    neg = cv2.imread(str(DATA / "test1_faces_0.jpg"))
    neg = cv2.resize(neg, (pos.shape[1], pos.shape[0]))
    out = {"golden_boxes": GOLDEN_BOXES_3.tolist(), "nets": {}}
    for name, (ckpt, file, settings, gate, max_px) in NETS.items():
        eng = jax_engine(settings, ckpt)
        out["nets"][name] = {"checkpoint": ckpt, "file": file, **settings,
                             "gate": gate, "max_px": max_px,
                             "jax": jax_runs(eng, gate, pos, neg)}
    out["quantize"] = {"yolov5n": {**QUANTIZE,
                                   "jax_ascale": jax_activation_scales()}}
    emb = _jax_embeddings(pos, GOLDEN_BOXES_3)
    out["embedders"] = {EMBEDDER[2]: {
        "checkpoint": EMBEDDER[0], "file": EMBEDDER[1],
        "detector": "blazeface-front", "embedder": EMBEDDER[2],
        "boxes": GOLDEN_BOXES_3.tolist(), "cos_min": COS_MIN,
        "jax": {"embeddings": np.asarray(emb, np.float32).tolist()}}}
    return out


def jax_activation_scales():
    """{the port's module path: scale} of the JAX ``quantize_checkpoint``
    on ``QUANTIZE``'s checkpoint, calibrated on the CPU."""
    import tempfile

    from face_detection_and_recognition_tpu.cli.quantize_golden import \
        quantize_checkpoint
    from face_detection_and_recognition_tpu.utils.checkpoint import \
        load_variables
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    q = QUANTIZE
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "int8")
        quantize_checkpoint(str(DATA / q["checkpoint"]), out, q["arch"],
                            q["size"], work, n_calib=q["n_calib"],
                            batch=q["batch"], seed=q["seed"],
                            log=lambda s: None)
        sd = W.yolov5_face_state_dict(load_variables(out), q["arch"])
    return {k[:-len(".ascale")]: float(v) for k, v in sorted(sd.items())
            if k.endswith(".ascale")}


def _jax_embeddings(img, boxes):
    """The JAX engine's MobileFaceNet embeddings of ``boxes`` of ``img``."""
    from face_detection_and_recognition_tpu.core.engine import (
        EngineConfig, FaceEngine)

    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder=EMBEDDER[2]))
    eng.embed_vars = load_f32(EMBEDDER[0])
    return eng.embed_faces(img, boxes)


def configure_jax():
    """JAX on the CPU at the tests' matmul precision."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "card_weights"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    configure_jax()
    import torch

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for file, sd in port_files().items():
        torch.save(sd, out / file)
    for name in ("test2_faces_3.jpg", "test1_faces_0.jpg"):
        shutil.copyfile(DATA / name, out / name)
    with open(out / "expected.json", "w") as f:
        json.dump(expected(), f, indent=1)
        f.write("\n")
    size = sum(p.stat().st_size for p in out.iterdir())
    print(f"wrote {out}: {len(list(out.iterdir()))} files, {size} bytes")


if __name__ == "__main__":
    main()
