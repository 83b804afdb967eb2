"""The JAX package's config keys in the port (CPU): a file written by the
JAX ``save_config`` for each of the five dataclasses that carry a key the
port once lacked (``EngineConfig.dtype``, ``YoloV5FaceConfig.pallas_nms``,
``SSDConfig.pallas_nms``, ``MTCNNConfig.crop_method``,
``PreprocessSpec.standardize``) loads in the port with every field equal,
and back; the ``pallas_nms`` / ``crop_method`` overrides build engines
whose detections are the JAX engine's on the golden weights (at the
tolerances of ``tests/test_torch_engine.py``, ``test_torch_ssd.py`` and
``test_torch_mtcnn.py``), their stages still reaching the kernels'
wrappers, which the device alone routes; the refused cases (the kernel on
a CPU engine, the plain version on a CUDA one, bf16, BlazeFace's
``pallas_nms``) raise naming why; a ``standardize`` spec preprocesses as
JAX ``apply_preprocess_batch`` does."""
import dataclasses
import functools
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core import config as JC
from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.models.mtcnn import \
    MTCNNConfig as JMTCNNConfig
from face_detection_and_recognition_tpu.models.ssd import SSDConfig as JSSDConfig
from face_detection_and_recognition_tpu.models.yolov5_face import \
    YoloV5FaceConfig as JYoloV5FaceConfig
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core import config as TC
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.models import yolov5_face as TY
from face_detection_and_recognition_tpu_torch.models.mtcnn import MTCNNConfig
from face_detection_and_recognition_tpu_torch.models.ssd import SSDConfig
from face_detection_and_recognition_tpu_torch.models.yolov5_face import \
    YoloV5FaceConfig
from face_detection_and_recognition_tpu_torch.ops import crop as TCROP
from face_detection_and_recognition_tpu_torch.ops import nms as TNMS
from face_detection_and_recognition_tpu_torch.ops import preprocess as TP
from face_detection_and_recognition_tpu_torch.ops.platform import \
    check_kernel_choice
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
NEG = os.path.join(DATA, "test1_faces_0.jpg")

# (JAX dataclass, the port's): the five that carry a key the port lacked
PAIRS = {"engine": (JEngineConfig, EngineConfig),
         "yolov5": (JYoloV5FaceConfig, YoloV5FaceConfig),
         "ssd": (JSSDConfig, SSDConfig),
         "mtcnn": (JMTCNNConfig, MTCNNConfig),
         "preprocess": (JP.PreprocessSpec, TP.PreprocessSpec)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(v):
    """A field's value as JSON sees it; a dtype by its name."""
    if isinstance(v, (torch.dtype, type)) or "dtype" in type(v).__name__:
        return str(v).split(".")[-1].replace("'>", "")
    return json.loads(json.dumps(v))


def _same_fields(port_cfg, jax_cfg):
    names = [f.name for f in dataclasses.fields(jax_cfg)]
    assert [f.name for f in dataclasses.fields(port_cfg)] == names
    for name in names:
        got, want = getattr(port_cfg, name), getattr(jax_cfg, name)
        assert _plain(got) == _plain(want), (name, got, want)
        if isinstance(want, tuple):
            assert isinstance(got, tuple), (name, got)


@pytest.mark.parametrize("which", list(PAIRS))
def test_jax_config_loads_in_the_port_and_back(tmp_path, which):
    """Each dataclass's JAX default, written by the JAX ``save_config``,
    read by the port's ``load_config``: every field equal (tuples restored,
    the dtype a torch dtype of the same name); the port's file read back by
    the JAX ``load_config`` gives the JAX default again."""
    jcls, tcls = PAIRS[which]
    path = str(tmp_path / "jax.json")
    JC.save_config(jcls(), path)
    got = TC.load_config(tcls, path)
    _same_fields(got, jcls())
    if which == "engine":
        assert got.dtype is torch.float32
    back = str(tmp_path / "port.json")
    TC.save_config(got, back)
    assert JC.load_config(jcls, back) == jcls()


def test_engine_config_with_overrides_round_trips(tmp_path):
    """A non-default JAX EngineConfig (the chain-parity overrides of JAX
    tests/test_chain_parity_e2e.py:104-106) loads in the port as it was
    written, and the port's overrides replace fields as the JAX ones do."""
    cfg = JEngineConfig(detector="yolov5n", det_thres=0.5, rect=True,
                        seed=3, detector_overrides={"pallas_nms": False,
                                                    "input_size": [320, 320]})
    path = str(tmp_path / "e.json")
    JC.save_config(cfg, path)
    got = TC.load_config(EngineConfig, path, max_det=16)
    _same_fields(got, dataclasses.replace(cfg, max_det=16))
    for spelling in ("float32", "torch.float32", str(jnp.float32)):
        assert TC.load_config(EngineConfig, path, dtype=spelling).dtype \
            is torch.float32


# ---------------- the overrides build engines that match the JAX one ----


def _golden(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@functools.lru_cache(maxsize=None)
def _engines(detector):
    """(JAX engine, port CPU engine) on the same golden weights, both built
    with the detector's override."""
    if detector == "yolov5n":
        ov = {"pallas_nms": False}
        v = _golden("golden_yolov5n_ckpt")
        sd = TW.yolov5_face_state_dict(v, "yolov5n")
    elif detector == "ssd-squeezenet":
        ov = {"pallas_nms": False, "input_size": (300, 300)}
        v = _golden("golden_ssd_sq_ckpt")
        sd = TW.ssd_state_dict(v, "squeezenet")
    else:
        ov = {"crop_method": "gather"}
        v = _golden("golden_mtcnn_ckpt")
        sd = TW.mtcnn_state_dict(v)
    jeng = JFaceEngine(JEngineConfig(detector=detector, det_thres=0.5,
                                     detector_overrides=dict(ov)))
    jeng.variables = v
    teng = FaceEngine(EngineConfig(detector=detector, det_thres=0.5,
                                   detector_overrides=dict(ov)),
                      device="cpu")
    teng.load_state_dict(sd)
    return jeng, teng


def _spy_wrappers(monkeypatch):
    """Count the calls of every name the port reaches B1's and B3's
    wrappers by: the device, not the override, routes a stage, so a CPU
    engine asked for the plain version still calls them (each takes its
    plain version because its tensors lie on the CPU)."""
    calls = []
    for module, name in ((TY, "nms_fixpoint"), (TNMS, "nms_fixpoint"),
                         (TCROP, "crop_resize")):
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            assert args[0].device.type == "cpu"
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)
    return calls


def test_yolov5n_pallas_nms_false_matches_jax(monkeypatch):
    """yolov5n with ``{"pallas_nms": False}``: B1's wrapper on the CPU
    (its plain version), and the JAX engine's detections on the golden
    image and the negative one: boxes and landmarks within 1 px, scores
    1e-4."""
    jeng, teng = _engines("yolov5n")
    calls = _spy_wrappers(monkeypatch)
    for name in (IMG, NEG):
        img = cv2.imread(name)
        ref = jeng.detect_image(img, det_thres=0.3)
        got = teng.detect_image(img, det_thres=0.3)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got.boxes, ref.boxes, atol=1.0, rtol=0)
        np.testing.assert_allclose(got.bbox_lmarks, ref.bbox_lmarks,
                                   atol=1.0, rtol=0)
        np.testing.assert_allclose(got.bbox_confs, ref.bbox_confs,
                                   atol=1e-4, rtol=0)
    assert len(teng.detect_image(cv2.imread(IMG), det_thres=0.3)) > 0
    assert "nms_fixpoint" in calls


@pytest.mark.parametrize("detector", ["ssd-squeezenet", "mtcnn"])
def test_plain_path_overrides_match_jax(monkeypatch, detector):
    """ssd-squeezenet with ``{"pallas_nms": False}`` and mtcnn with
    ``{"crop_method": "gather"}``: B1's / B3's wrapper on the CPU (its
    plain version), and the JAX engine's raw rows on the golden image
    within 1e-4 (normalized)."""
    jeng, teng = _engines(detector)
    calls = _spy_wrappers(monkeypatch)
    img = cv2.imread(IMG)
    got, ref = teng.detect_raw(img), np.asarray(jeng.detect_raw(img))
    assert got.shape == ref.shape and len(got) > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert ("crop_resize" if detector == "mtcnn" else "nms_fixpoint") \
        in calls


def test_default_route_calls_the_wrapper():
    """``pallas_nms`` None on a CPU engine goes through B1's wrapper, which
    takes the plain version because the tensors lie on the CPU: the same
    detections as ``False``."""
    _, plain = _engines("yolov5n")
    auto = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5),
                      device="cpu")
    auto.load_state_dict(plain.net.state_dict())
    calls = []
    real = TY.nms_fixpoint

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    TY.nms_fixpoint = spy
    try:
        got = auto.detect_image(cv2.imread(IMG), det_thres=0.3)
    finally:
        TY.nms_fixpoint = real
    assert calls
    ref = plain.detect_image(cv2.imread(IMG), det_thres=0.3)
    np.testing.assert_array_equal(got.boxes, ref.boxes)


# ---------------- refused cases ----------------


@pytest.mark.parametrize("detector,override", [
    ("yolov5n", {"pallas_nms": True}),
    ("yolov5s-official", {"pallas_nms": True}),
    ("ssd-squeezenet", {"pallas_nms": True}),
    ("mtcnn", {"crop_method": "pallas"})])
def test_kernel_asked_on_a_cpu_engine_raises(detector, override):
    """True / "pallas" asks for the hand-written kernel: a CPU engine
    raises, naming the field, and never takes the plain path silently."""
    field = next(iter(override))
    with pytest.raises(ValueError, match=f"{field} asks for the "
                                         "hand-written CUDA kernel"):
        FaceEngine(EngineConfig(detector=detector,
                                detector_overrides=override), device="cpu")


@pytest.mark.parametrize("detector,override", [
    ("yolov5n", {"pallas_nms": False}),
    ("yolov5s-official", {"pallas_nms": False}),
    ("ssd-squeezenet", {"pallas_nms": False}),
    ("mtcnn", {"crop_method": "gather"}),
    ("mtcnn", {"crop_method": "gemm"})])
def test_plain_version_asked_on_a_cuda_engine_raises(detector, override):
    """False / "gather" / "gemm" asks for the plain version: a CUDA
    engine's builder raises before it touches the card, naming the field,
    and never leaves the kernel for the plain version there."""
    field = next(iter(override))
    with pytest.raises(ValueError, match=f"{field} asks for the plain "
                                         "version"):
        TR.get(detector).build(torch.Generator().manual_seed(0),
                               torch.device("cuda"), **override)


@pytest.mark.parametrize("choice", [None, True, False])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_kernel_choice_agrees_with_the_device(choice, device):
    """None agrees with either device; True only with the card; False only
    with the CPU."""
    refused = (choice is True and device == "cpu") \
        or (choice is False and device == "cuda")
    if refused:
        with pytest.raises(ValueError, match="pallas_nms asks for"):
            check_kernel_choice(choice, device, "pallas_nms")
    else:
        assert check_kernel_choice(choice, device, "pallas_nms") is None


def test_bf16_dtype_raises_naming_a8(tmp_path):
    """bfloat16 (ROADMAP.md A8): a JAX ``save_config`` file that asks for
    it loads into a bf16 yolov5s port engine, whose net runs in bf16
    (bf16 heads) and whose detections come out f32; every detector of the
    families whose bf16 path is still to port raises naming ROADMAP.md
    A8b when its engine is built, so none silently runs f32; an unknown
    dtype name raises."""
    path = str(tmp_path / "bf16.json")
    JC.save_config(JEngineConfig(dtype=jnp.bfloat16), path)
    cfg = TC.load_config(EngineConfig, path,
                         detector_overrides={"input_size": (64, 64)})
    assert cfg.detector == "yolov5s" and cfg.dtype == torch.bfloat16
    eng = FaceEngine(cfg, device="cpu")
    frames = np.random.RandomState(3).randint(0, 256, (1, 48, 64, 3),
                                              dtype=np.uint8)
    with torch.inference_mode():
        maps = eng._network(eng._preprocess(torch.from_numpy(frames)))
    assert all(m.dtype == torch.bfloat16 for m in maps)
    assert eng.detect_batch(frames, 0.0, 0.0).boxes.dtype == torch.float32
    for detector in ("blazeface-front", "blazeface-back", "ssd-resnet10",
                     "ssd-mobilenetv2", "ssd-squeezenet", "mtcnn",
                     "res10-ssd", "ov-0204", "ov-squeezenet-light",
                     "openvino-ir"):
        with pytest.raises(ValueError, match="A8b"):
            FaceEngine(EngineConfig(detector=detector, dtype="bfloat16"),
                       device="cpu")
    with pytest.raises(ValueError, match="unknown dtype"):
        EngineConfig(dtype="float64")


def test_blazeface_rejects_pallas_nms_as_jax_does():
    """Neither package's BlazeFace has ``pallas_nms`` (its NMS is the
    blend NMS): both builds refuse the key, naming it."""
    ov = {"pallas_nms": False}
    with pytest.raises(TypeError, match="pallas_nms"):
        FaceEngine(EngineConfig(detector="blazeface-front",
                                detector_overrides=ov), device="cpu")
    with pytest.raises(TypeError, match="pallas_nms"):
        JFaceEngine(JEngineConfig(detector="blazeface-front",
                                  detector_overrides=ov))


def test_unknown_crop_method_raises():
    with pytest.raises(ValueError, match="crop_method 'nearest'"):
        FaceEngine(EngineConfig(detector="mtcnn", detector_overrides={
            "crop_method": "nearest"}), device="cpu")


# ---------------- PreprocessSpec.standardize ----------------


@pytest.mark.parametrize("spec", [
    pytest.param(dict(size=(160, 160), resize="stretch", standardize=True),
                 id="facenet-stretch"),
    pytest.param(dict(size=(128, 96), bgr_to_rgb=True, standardize=True),
                 id="letterbox"),
    pytest.param(dict(size=None, resize="none", standardize=True),
                 id="none")])
def test_standardize_spec_matches_jax(spec):
    """A ``standardize`` spec against JAX ``apply_preprocess_batch`` on two
    seeded 120x150 BGR frames: per-image prewhitening instead of mean and
    scale; a letterbox takes its statistics over the padded canvas (JAX's
    pad-then-normalize order). Within 1e-5 (f32 means and deviations
    summed in another order)."""
    frames = np.random.RandomState(7).randint(0, 256, (2, 120, 150, 3),
                                              np.uint8)
    ref = np.asarray(JP.apply_preprocess_batch(jnp.asarray(frames),
                                               JP.PreprocessSpec(**spec)))
    got = TP.apply_preprocess_batch(torch.from_numpy(frames),
                                    TP.PreprocessSpec(**spec)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert abs(float(got[0].mean())) < 1e-4


def test_facenet_recipe_matches_jax():
    assert dataclasses.asdict(TP.FACENET) == dataclasses.asdict(JP.FACENET)
