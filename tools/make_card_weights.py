"""Write ``card_weights/``: the golden checkpoints as the port's own weight
files, with what the JAX package's engines give on them.

    python tools/make_card_weights.py [--out card_weights]

(~10 min on an 8-core host, most of it the JAX CPU engines' compiles and
the crowded set's AP.) Reads the orbax checkpoints under ``tests/data``
through the JAX package's ``load_variables`` (float leaves cast to f32,
int8 codes kept), converts each through the port's bridge
(``utils/weights.py``) and writes:

- one ``.pt`` a detector checkpoint of ``NETS`` (``FaceEngine.save_weights``
  of a CPU engine holding the bridged state dict; the int8 yolov5n with
  its static scales) and one an embedder of ``EMBEDDERS`` (the embedder
  slot's state dict, in bfloat16 as its checkpoint keeps it: the same
  values in half the bytes, which keeps the folder under 180 MB);
- the reference-format files of ``NETS`` (``golden_res10.caffemodel``, the
  two OpenVINO IRs' ``.xml`` + ``.bin``), copied byte for byte;
- the golden image and the negative one, copied;
- ``expected.json``: the pinned boxes (``GOLDEN_BOXES_3``), each net's
  engine settings, its gate (thresholds, margin and IoU bars, as the JAX
  tests set them), the JAX CPU engine's boxes and scores at each of the
  gate's thresholds on both images and whether the JAX engine passes the
  gate; each embedder's embeddings of the three pinned face crops
  (``embed_faces``) and its 3-identity filter gate
  (``evaluate_identity_filter`` on ``embed_crops``); the static
  activation scales that the JAX ``quantize_golden`` calibrates for the
  golden yolov5n on this CPU (``QUANTIZE``); the crowded set of
  ``tests/test_crowded_accuracy.py`` (``CROWDED``: the digests of its
  images and annotation file, each net's JAX AP50 / AP and floors, and
  the max_det saturation case).

Runs JAX on the CPU at the tests' matmul precision ("highest").
``tests/test_torch_card_weights.py``,
``tests/test_torch_card_weights_families.py`` and
``tests/test_torch_crowded.py`` hold the folder to this script's output.
The port loads the folder with ``eval/card_weights.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"


def band(bar):
    """The 0.45-0.75 band gate (``evaluate_golden(det_thres=0.6,
    margin=0.15)``, ``ok`` asserted) with the IoU bar ``bar`` on each box."""
    return {"det_thres": 0.6, "margin": 0.15, "iou_thres": 0.5,
            "require_ok": True, "iou_bars": [bar] * 3}


# name -> (checkpoint, port file, engine settings, gate, max_px); the gates
# are those of the nets' tests in tests/test_golden_accuracy.py and of the
# rows of benchmarks/regate_golden.py:100-165, the stricter of the two:
# yolov5s :280-299, yolov5n :26-45, int8 :397-421, BlazeFace front
# :134-165, MTCNN :432-450 (the regate's BlazeFace-front row is its band
# gate, "blazeface-front-band")
BASE_NETS = {
    "yolov5s": ("golden_yolov5s_ckpt", "yolov5s.pt",
                {"detector": "yolov5s"}, band(0.8), 1.0),
    "yolov5s-bf16": ("golden_yolov5s_ckpt", "yolov5s.pt",
                     {"detector": "yolov5s", "dtype": "bfloat16"},
                     band(0.8), 1.0),
    "yolov5n": ("golden_yolov5n_ckpt", "yolov5n.pt",
                {"detector": "yolov5n"}, band(0.8), 1.0),
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
# the other rows of the regate: n6 tests/test_golden_accuracy.py:306-326,
# official :361-388, ssd-resnet10 :106-126, ssd-mobilenetv2 :243-257,
# ssd-squeezenet :260-273, BlazeFace back :165-187; the crowded yolov5n
# and s6 tests/test_crowded_accuracy.py:121-135 and :279-293; res10
# tests/test_graphdef_ssd.py:146-171 (the regate's band row); the OpenVINO
# nets and their IRs tests/test_ov_topologies.py:85-139. A ``.caffemodel``
# or ``.xml`` file is the reference's own format, copied as it is and
# read by the engine's importer (an ``.xml`` through openvino-ir).
# max_px: 1 px, each family's CPU-test tolerance against the JAX engine
REGATE_NETS = {
    "blazeface-front-band": ("golden_blaze_ckpt", "blazeface_front.pt",
                             {"detector": "blazeface-front"}, band(0.5),
                             1.0),
    "yolov5n6": ("golden_yolov5n6_ckpt", "yolov5n6.pt",
                 {"detector": "yolov5n6"}, band(0.8), 1.0),
    "yolov5n-official": ("golden_yolov5n_official_ckpt",
                         "yolov5n_official.pt",
                         {"detector": "yolov5n-official",
                          "overrides": {"nc": 80}}, band(0.65), 1.0),
    "yolov5n-crowded": ("golden_yolov5n_crowded_ckpt", "yolov5n_crowded.pt",
                        {"detector": "yolov5n"}, band(0.5), 1.0),
    "yolov5s6-crowded": ("golden_yolov5s6_crowded_ckpt",
                         "yolov5s6_crowded.pt",
                         {"detector": "yolov5s6",
                          "overrides": {"input_size": [960, 960]}},
                         band(0.5), 1.0),
    "ssd-resnet10": ("golden_ssd_ckpt", "ssd_resnet10.pt",
                     {"detector": "ssd-resnet10",
                      "overrides": {"input_size": [300, 300]}},
                     {"det_thres": 0.5, "margin": 0.05, "iou_thres": 0.5,
                      "require_ok": False, "iou_bars": [0.8, 0.8, 0.8]},
                     1.0),
    "ssd-mobilenetv2": ("golden_ssd_mnv2_ckpt", "ssd_mobilenetv2.pt",
                        {"detector": "ssd-mobilenetv2",
                         "overrides": {"input_size": [448, 448]}},
                        band(0.7), 1.0),
    "ssd-squeezenet": ("golden_ssd_sq_ckpt", "ssd_squeezenet.pt",
                       {"detector": "ssd-squeezenet",
                        "overrides": {"input_size": [300, 300]}},
                       band(0.5), 1.0),
    "res10-ssd": ("golden_res10_ckpt", "res10_ssd.pt",
                  {"detector": "res10-ssd"}, band(0.5), 1.0),
    "res10-ssd-caffemodel": ("golden_res10.caffemodel",
                             "golden_res10.caffemodel",
                             {"detector": "res10-ssd"}, band(0.5), 1.0),
    "ov-squeezenet-light": ("golden_ov_sq_ckpt", "ov_squeezenet_light.pt",
                            {"detector": "ov-squeezenet-light"}, band(0.5),
                            1.0),
    "ov-squeezenet-light-ir": ("golden_ov_sq.xml", "golden_ov_sq.xml",
                               {"detector": "openvino-ir"}, band(0.5), 1.0),
    "ov-0204": ("golden_ov_0204_ckpt", "ov_0204.pt",
                {"detector": "ov-0204"}, band(0.5), 1.0),
    "ov-0204-ir": ("golden_ov_0204.xml", "golden_ov_0204.xml",
                   {"detector": "openvino-ir"}, band(0.5), 1.0),
    "blazeface-back": ("golden_blaze_back_ckpt", "blazeface_back.pt",
                       {"detector": "blazeface-back"}, band(0.8), 1.0),
}
NETS = {**BASE_NETS, **REGATE_NETS}
# reference-format rows -> the checkpoint row holding the same weights
SAME_WEIGHTS = {"res10-ssd-caffemodel": "res10-ssd",
                "ov-squeezenet-light-ir": "ov-squeezenet-light",
                "ov-0204-ir": "ov-0204"}
REFERENCE_FORMATS = (".caffemodel", ".xml")
# name -> (checkpoint, port file, the filter gate's crop size); the gate
# of the regate's embed_gate (benchmarks/regate_golden.py:60-73)
EMBEDDERS = {"mobile_facenet": ("golden_embed_ckpt", "mobile_facenet.pt",
                                112),
             "reid-mnv2": ("golden_reid_ckpt", "reid_mnv2.pt", 128)}
# the JAX cli/quantize_golden.py calibration of the golden yolov5n
QUANTIZE = {"checkpoint": "golden_yolov5n_ckpt", "file": "yolov5n.pt",
            "int8_file": "yolov5n_int8.pt", "arch": "yolov5n", "size": 640,
            "n_calib": 32, "batch": 8, "seed": 515}
COS_MIN = 0.999
# the seed-11 crowded set and engines of tests/test_crowded_accuracy.py
# :36-66, and its AP floors: yolov5n :69-80, yolov5s :85-93,
# ssd-resnet10 :95-104, mtcnn :107-116, yolov5n-crowded :118-135,
# yolov5s6-crowded at 960 :265-276; saturation :151-205
CROWDED = {"n_images": 16, "out_wh": [640, 640], "seed": 11,
           "det_thres": 0.02, "bbox_area_thres": 0.0, "max_det": 300,
           "batch_size": 8, "ap_tol": 0.005}
CROWDED_NETS = {
    "yolov5n": ("yolov5n", {"AP50": 0.15}),
    "yolov5s": ("yolov5s", {"AP50": 0.17}),
    "ssd-resnet10": ("ssd-resnet10", {"AP50": 0.14}),
    "mtcnn": ("mtcnn", {"AP50": 0.40}),
    "yolov5n-crowded": ("yolov5n-crowded", {"AP50": 0.75}),
    "yolov5s6-crowded": ("yolov5s6-crowded", {"AP50": 0.80, "AP": 0.50}),
}
SATURATION = {"net": "yolov5n-crowded", "det_thres": 0.25, "max_det": 8,
              "max_det_ref": 64, "min_gt": 24, "match_iou": 0.99,
              "conf_tol": 1e-3, "gt_iou": 0.4, "max_px": 1.0}


def reference_format(file: str) -> bool:
    """A ``.caffemodel`` or OpenVINO ``.xml``: copied, not converted."""
    return file.endswith(REFERENCE_FORMATS)


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
    yolo = {"golden_yolov5s_ckpt": "yolov5s", "golden_yolov5n_ckpt": "yolov5n",
            "golden_yolov5n_int8_ckpt": "yolov5n",
            "golden_yolov5n6_ckpt": "yolov5n6",
            "golden_yolov5n_official_ckpt": "yolov5n",
            "golden_yolov5n_crowded_ckpt": "yolov5n",
            "golden_yolov5s6_crowded_ckpt": "yolov5s6"}
    if ckpt in yolo:
        return W.yolov5_face_state_dict(v, yolo[ckpt])
    return {
        "golden_blaze_ckpt": lambda: W.blazeface_state_dict(v, False),
        "golden_blaze_back_ckpt": lambda: W.blazeface_state_dict(v, True),
        "golden_mtcnn_ckpt": lambda: W.mtcnn_state_dict(v),
        "golden_ssd_ckpt": lambda: W.ssd_state_dict(v, "resnet10"),
        "golden_ssd_mnv2_ckpt": lambda: W.ssd_state_dict(v, "mobilenetv2"),
        "golden_ssd_sq_ckpt": lambda: W.ssd_state_dict(v, "squeezenet"),
        "golden_res10_ckpt": lambda: W.caffe_graph_state_dict(v["params"]),
        "golden_ov_0204_ckpt": lambda: W.ov_graph_state_dict(v["params"]),
        "golden_ov_sq_ckpt": lambda: W.ov_graph_state_dict(v["params"]),
        "golden_embed_ckpt": lambda: W.mobile_facenet_state_dict(v),
        "golden_reid_ckpt": lambda: W.reid_mnv2_state_dict(v),
    }[ckpt]()


def port_files(nets=None, embedders=None):
    """{file name: the state dict written there}: each net's bridged
    state dict as ``FaceEngine.save_weights`` (a CPU engine holding it)
    and each embedder slot's state dict would write it; ``nets`` /
    ``embedders`` (names) pick some, all by default. Reference-format
    files are copies, not state dicts, and are left out."""
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    files = {}
    for name in NETS if nets is None else nets:
        ckpt, file, settings, _, _ = NETS[name]
        if file in files or reference_format(file):
            continue
        eng = FaceEngine(EngineConfig(
            detector=settings["detector"],
            detector_overrides=CW.engine_overrides(settings)), device="cpu")
        eng.load_state_dict(port_state_dict(ckpt))
        files[file] = {k: v.clone() for k, v in eng.net.state_dict().items()}
    for name in EMBEDDERS if embedders is None else embedders:
        ckpt, file, _ = EMBEDDERS[name]
        eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                      embedder=name), device="cpu")
        eng.load_embed_state_dict(port_state_dict(ckpt))
        files[file] = as_stored(ckpt, eng.embed_net.state_dict())
    return files


def as_stored(ckpt, sd):
    """``sd`` (a bridged state dict, f32) with its floating tensors in the
    checkpoint's own precision: bfloat16 where the orbax checkpoint keeps
    every float leaf in bfloat16 (the embedders), so that the file holds
    the same values in half the bytes; f32 otherwise. Raises when a value
    would not survive the cast."""
    import jax
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu.utils.checkpoint import \
        load_variables

    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        load_variables(str(DATA / ckpt)))]
    bf16 = all(str(a.dtype) == "bfloat16" for a in leaves
               if a.dtype.kind in "fV")
    out = {}
    for k, v in sd.items():
        v = v.clone()
        if bf16 and v.is_floating_point():
            b = v.to(torch.bfloat16)
            if not torch.equal(b.float(), v):
                raise ValueError(f"{ckpt}: {k} is not bfloat16-exact")
            v = b
        out[k] = v
    return out


def copied_files():
    """The reference-format files of ``NETS`` and their siblings (an
    IR's ``.bin``), copied byte for byte."""
    out = []
    for _, file, _, _, _ in NETS.values():
        if reference_format(file) and file not in out:
            out.append(file)
            if file.endswith(".xml"):
                out.append(file[:-len(".xml")] + ".bin")
    return out


def jax_engine(settings, ckpt, **cfg):
    """The JAX CPU engine of ``settings`` holding the f32-cast checkpoint
    (int8 codes kept), or the reference-format file ``ckpt`` through
    ``load_weights`` (an IR through openvino-ir's ``xml`` override);
    ``cfg``: more ``EngineConfig`` fields (det_thres 0.5 by default)."""
    import jax.numpy as jnp

    from face_detection_and_recognition_tpu.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    overrides = CW.engine_overrides(settings)
    if ckpt.endswith(".xml"):
        overrides["xml"] = str(DATA / ckpt)
    eng = FaceEngine(EngineConfig(
        detector=settings["detector"], **{"det_thres": 0.5, **cfg},
        dtype=jnp.bfloat16 if settings.get("dtype") == "bfloat16"
        else jnp.float32, detector_overrides=overrides))
    if ckpt.endswith(".caffemodel"):
        eng.load_weights(str(DATA / ckpt))
    elif not ckpt.endswith(".xml"):
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


def net_entry(name, pos, neg):
    """``expected.json``'s entry of the net ``name``."""
    ckpt, file, settings, gate, max_px = NETS[name]
    return {"checkpoint": ckpt, "file": file, **settings, "gate": gate,
            "max_px": max_px,
            "jax": jax_runs(jax_engine(settings, ckpt), gate, pos, neg)}


def expected():
    """``expected.json``'s content, computed by the JAX engines."""
    import cv2

    from face_detection_and_recognition_tpu.train.golden import \
        GOLDEN_BOXES_3

    pos = cv2.imread(str(DATA / "test2_faces_3.jpg"))
    neg = cv2.imread(str(DATA / "test1_faces_0.jpg"))
    neg = cv2.resize(neg, (pos.shape[1], pos.shape[0]))
    out = {"golden_boxes": GOLDEN_BOXES_3.tolist(),
           "nets": {name: net_entry(name, pos, neg) for name in NETS}}
    out["quantize"] = {"yolov5n": {**QUANTIZE,
                                   "jax_ascale": jax_activation_scales()}}
    out["embedders"] = {name: embedder_entry(name, pos) for name in EMBEDDERS}
    out["crowded"] = crowded_entry()
    return out


def embedder_entry(name, pos):
    """``expected.json``'s entry of the embedder ``name``: the JAX
    engine's embeddings of the pinned crops and its filter gate."""
    import numpy as np

    from face_detection_and_recognition_tpu.train.golden import \
        GOLDEN_BOXES_3

    ckpt, file, size = EMBEDDERS[name]
    eng = _jax_embed_engine(name)
    return {"checkpoint": ckpt, "file": file, "detector": "blazeface-front",
            "embedder": name, "boxes": GOLDEN_BOXES_3.tolist(),
            "cos_min": COS_MIN, "filter_size": size,
            "jax": {"embeddings": np.asarray(
                        eng.embed_faces(pos, GOLDEN_BOXES_3),
                        np.float32).tolist(),
                    "filter": jax_filter_gate(eng, size)}}


def jax_filter_gate(eng, size):
    """The JAX ``evaluate_identity_filter`` on the engine's
    ``embed_crops`` (the regate's ``embed_gate``), its numbers only."""
    from face_detection_and_recognition_tpu.train.golden_embed import \
        evaluate_identity_filter

    r = evaluate_identity_filter(eng.embed_crops, size=size)
    return {k: r[k] for k in ("ok", "same_acc", "cross_acc", "margin",
                              "thresholds")}


def jax_activation_scales():
    """{the port's module path: scale} of the JAX ``quantize_checkpoint``
    on ``QUANTIZE``'s checkpoint, calibrated on the CPU."""
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


def _jax_embed_engine(name="mobile_facenet"):
    """The JAX engine with the embedder ``name``'s f32-cast checkpoint."""
    from face_detection_and_recognition_tpu.core.engine import (
        EngineConfig, FaceEngine)

    eng = FaceEngine(EngineConfig(detector="blazeface-front", embedder=name))
    eng.embed_vars = load_f32(EMBEDDERS[name][0])
    return eng


def _jax_embeddings(img, boxes):
    """The JAX engine's MobileFaceNet embeddings of ``boxes`` of ``img``."""
    return _jax_embed_engine().embed_faces(img, boxes)


def jax_crowded_set(out_dir):
    """(ann_file, images_root) of the JAX ``make_crowded_dataset`` at
    ``CROWDED``'s size and seed."""
    from face_detection_and_recognition_tpu.train.golden import \
        make_crowded_dataset

    return make_crowded_dataset(out_dir, n_images=CROWDED["n_images"],
                                out_wh=tuple(CROWDED["out_wh"]),
                                seed=CROWDED["seed"])


def jax_crowded_engine(net):
    """The JAX CPU engine of the crowded net ``net`` (a ``NETS`` row) at
    ``CROWDED``'s thresholds."""
    ckpt, _, settings, _, _ = NETS[net]
    return jax_engine(settings, ckpt, det_thres=CROWDED["det_thres"],
                      bbox_area_thres=CROWDED["bbox_area_thres"],
                      max_det=CROWDED["max_det"])


def jax_crowded_ap(name, ann, images_root):
    """The JAX engine's COCO metrics of the crowded net ``name``."""
    from face_detection_and_recognition_tpu.eval.coco_eval import \
        evaluate_engine_on_wider

    m = evaluate_engine_on_wider(jax_crowded_engine(CROWDED_NETS[name][0]),
                                 ann, images_root,
                                 batch_size=CROWDED["batch_size"])
    return {k: float(v) for k, v in m.items()}


def jax_saturation(ann, images_root):
    """The saturation case on the JAX engines (the test's: the default
    area threshold): the most crowded frame, the ``max_det`` engine's
    boxes and confidences and the ``max_det_ref`` engine's top
    ``max_det`` by confidence."""
    import numpy as np

    from face_detection_and_recognition_tpu.eval.coco_eval import \
        parse_wider_annotations
    from face_detection_and_recognition_tpu.utils.native import \
        read_image_bgr

    s = SATURATION
    gt = parse_wider_annotations(ann)
    rel = max(gt, key=lambda k: len(gt[k]))
    img = read_image_bgr(os.path.join(images_root, rel))
    out = {"frame": rel, "n_gt": len(gt[rel])}
    ckpt, _, settings, _, _ = NETS[s["net"]]
    for key, md in (("jax", s["max_det"]), ("jax_ref", s["max_det_ref"])):
        post = jax_engine(settings, ckpt, det_thres=s["det_thres"],
                          max_det=md).detect_image(img)
        boxes = np.asarray(post.boxes, np.float32)
        confs = np.asarray(post.bbox_confs, np.float32)
        order = np.argsort(-confs, kind="stable")[:s["max_det"]]
        out[key] = {"n": len(boxes), "boxes": boxes[order].tolist(),
                    "confs": confs[order].tolist()}
    return out


def crowded_entry():
    """``expected.json``'s ``crowded`` entry: the set's digests, each
    net's JAX metrics and floors, the saturation case."""
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    with tempfile.TemporaryDirectory() as work:
        ann, images_root = jax_crowded_set(work)
        nets = {name: {"net": net, "floors": floors,
                       "jax": jax_crowded_ap(name, ann, images_root)}
                for name, (net, floors) in CROWDED_NETS.items()}
        return {**CROWDED, "digests": CW.crowded_digests(ann, images_root),
                "nets": nets,
                "saturation": {**SATURATION,
                               **jax_saturation(ann, images_root)}}


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
    for name in copied_files() + ["test2_faces_3.jpg", "test1_faces_0.jpg"]:
        shutil.copyfile(DATA / name, out / name)
    with open(out / "expected.json", "w") as f:
        json.dump(expected(), f, indent=1)
        f.write("\n")
    size = sum(p.stat().st_size for p in out.iterdir())
    print(f"wrote {out}: {len(list(out.iterdir()))} files, {size} bytes")


if __name__ == "__main__":
    main()
