"""The bfloat16 engines of the BlazeFace, SSD, MTCNN, res10 and OpenVINO
families (``EngineConfig(dtype=torch.bfloat16)``) against the JAX package's
bf16 engines on the same golden weights (CPU): their detections, the golden
gates, and the JAX package's bf16-against-f32 check of MTCNN
(``tests/test_mtcnn.py:132-150``) on the port. The layers and heads are
held to JAX's in ``tests/test_torch_bf16_families.py``, which sets out
the rounding points. The tolerances, stated at each test: the same counts
and boxes within 1 px of the JAX bf16 engine's on the golden image and the
negative one at thresholds 0.3, 0.5 and 0.7; the gates' own bars; MTCNN
bf16 against f32 within 0.05 px on the rows both keep, as JAX checks it.
The checkpoints are f32-cast, as in the f32 tests.
"""
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.eval.card_weights import \
    box_difference
from face_detection_and_recognition_tpu_torch.models import mtcnn as TM
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
BF = jnp.bfloat16
THRESHOLDS = (0.3, 0.5, 0.7)
# registry name -> (checkpoint, bridge, detector overrides)
FAMILIES = {
    "blazeface-front": ("golden_blaze_ckpt",
                        lambda v: TW.blazeface_state_dict(v, False)),
    "blazeface-back": ("golden_blaze_back_ckpt",
                       lambda v: TW.blazeface_state_dict(v, True)),
    "ssd-resnet10": ("golden_ssd_ckpt",
                     lambda v: TW.ssd_state_dict(v, "resnet10")),
    "ssd-mobilenetv2": ("golden_ssd_mnv2_ckpt",
                        lambda v: TW.ssd_state_dict(v, "mobilenetv2")),
    "ssd-squeezenet": ("golden_ssd_sq_ckpt",
                       lambda v: TW.ssd_state_dict(v, "squeezenet")),
    "mtcnn": ("golden_mtcnn_ckpt", TW.mtcnn_state_dict),
    "res10-ssd": ("golden_res10_ckpt",
                  lambda v: TW.caffe_graph_state_dict(v["params"])),
    "ov-0204": ("golden_ov_0204_ckpt",
                lambda v: TW.ov_graph_state_dict(v["params"])),
    "ov-squeezenet-light": ("golden_ov_sq_ckpt",
                            lambda v: TW.ov_graph_state_dict(v["params"])),
}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work (the tier-1 run
    puts several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _load(name):
    """A checkpoint's floats as f32 numpy."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def frames():
    """The golden image and the negative one at the golden image's size,
    as ``evaluate_golden`` feeds them."""
    pos = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    neg = cv2.imread(os.path.join(DATA, "test1_faces_0.jpg"))
    return pos, cv2.resize(neg, (pos.shape[1], pos.shape[0]))


def _port_engine(name, **kw):
    ckpt, bridge = FAMILIES[name]
    eng = FaceEngine(EngineConfig(detector=name, det_thres=0.5,
                                  dtype="bfloat16", **kw), device="cpu")
    eng.load_state_dict(bridge(_load(ckpt)))
    return eng


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    """The JAX bf16 engine of ``name`` on its golden checkpoint (the
    interpreters take the checkpoint's ``params``)."""
    eng = JFaceEngine(JEngineConfig(detector=name, det_thres=0.5, dtype=BF))
    v = _load(FAMILIES[name][0])
    eng.variables = v["params"] if name.startswith(("res10", "ov-")) else v
    return eng


@pytest.mark.parametrize("name", list(FAMILIES) + ["openvino-ir"])
def test_bf16_engine_detections_match_jax(name, frames):
    """The bf16 engines on the golden image and the negative one at three
    thresholds: the JAX bf16 engine's counts, boxes within 1 px. The port's
    openvino-ir on the golden IR keeps the engine's bf16 (the JAX one runs
    it in f32, ROADMAP.md §C): it is held to the registry-built JAX
    ov-squeezenet-light bf16 engine holding the IR's constants."""
    if name == "openvino-ir":
        eng = FaceEngine(EngineConfig(
            detector=name, det_thres=0.5, dtype="bfloat16",
            detector_overrides={"xml": os.path.join(DATA,
                                                    "golden_ov_sq.xml")}),
            device="cpu")
        jeng = _jax_engine("ov-squeezenet-light")
    else:
        eng, jeng = _port_engine(name), _jax_engine(name)
    for t in THRESHOLDS:
        for img in frames:
            got = eng.detect_image(img, det_thres=t)
            ref = jeng.detect_image(img, det_thres=t)
            d = box_difference(got.boxes, ref.boxes)
            assert d is not None and d <= 1.0, (t, len(got), len(ref), d)


@pytest.mark.parametrize("name", ["blazeface-front", "blazeface-back",
                                  "mtcnn"])
def test_bf16_golden_gates(name):
    """The golden gates of tests/test_golden_accuracy.py through the bf16
    engines, port and JAX: 3 faces and none on the negative image, the
    IoU bars of each family (BlazeFace front 0.5 / 0.7 / 0.8 sorted, back
    0.8 across its band, MTCNN 0.8)."""
    for eng in (_port_engine(name), _jax_engine(name)):
        if name == "blazeface-back":
            r = evaluate_golden(eng, det_thres=0.6, margin=0.15)
            assert r["ok"], r
        else:
            r = evaluate_golden(eng)
        assert r["n_pos"] == 3 and r["n_neg"] == 0, r
        ious = sorted(r["ious"])
        bars = {"blazeface-front": (0.5, 0.7, 0.8)}.get(name, (0.8,) * 3)
        assert all(i >= b for i, b in zip(ious, bars)), ious


def test_mtcnn_bf16_against_f32_as_jax_checks():
    """tests/test_mtcnn.py:132-150 on the port: the bf16 cascade (pyramid
    in bf16) of the same seeded weights as the f32 one, on a seeded
    144x176 frame, gives f32 detections of the contract's shape, and the
    rows both cascades keep agree within 0.05. (The bf16 cascade against
    JAX's: ``test_bf16_engine_detections_match_jax[mtcnn]`` here and
    ``tests/test_torch_card_weights.py``.)"""
    cfg = TM.MTCNNConfig(max_per_level=32, max_stage1=64, max_stage2=32,
                         max_faces=8)
    img = np.random.RandomState(42).randint(0, 255, (144, 176, 3)).astype(
        np.uint8)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        _, decode = TM.make_mtcnn(cfg, torch.Generator().manual_seed(5),
                                  torch.device("cpu"), dt)
        with torch.no_grad():
            d, valid = decode(torch.from_numpy(img)[None], img.shape[:2])
        out[dt] = (d[0].numpy(), valid[0].numpy())
    d16, v16 = out[torch.bfloat16]
    assert d16.shape == (8, 15) and d16.dtype == np.float32
    both = out[torch.float32][1] & v16
    if both.any():
        np.testing.assert_allclose(out[torch.float32][0][both, :4],
                                   d16[both, :4], atol=0.05)
