"""The port's model export (``utils/export.py``) on the CPU: the ``fdr``
operators of the hand-written kernels checked by ``torch.library.opcheck``,
exported and reloaded detectors, embedder and ensembles against the port's
eager calls (bit for bit) and the JAX engine (the tolerances of
``tests/test_export.py`` and ``tests/test_torch_ensemble.py``), the JAX
module's errors, and a reloading process that imports no model code.

The kernels themselves run only on the card, where ``chip_smoke.py``'s
export phase holds the reloaded programs to the engine."""
import os
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models.yolov5_face import \
    FACE_ANCHORS
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.ops import int8_conv
from face_detection_and_recognition_tpu_torch.utils import export as X
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, blazeface_state_dict, mobile_facenet_state_dict,
    yolov5_face_state_dict)
from tests.test_torch_kernels import (_ANCHORS, _blaze_heads, _blend_case,
                                      _levels, _sorted_case)
from tests.test_torch_similarity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")


def _load(name):
    """A checkpoint as float32 numpy arrays (``tests/test_torch_ensemble.py``:
    the bf16-stored checkpoints reach both packages cast to f32)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


def _same(got, ref):
    """Equal tensors: same shape, dtype and bits."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == torch.float32:
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    assert torch.equal(got, ref)


def _op_cases():
    """(operator, arguments) at the kernels tests' shapes, on the CPU."""
    rng = np.random.RandomState(7)
    t = torch.from_numpy
    sb, sv = _sorted_case(rng, 64)[:2]
    levels = [t(m) for m in _levels(rng, 1, hw=64)]
    idx = torch.arange(0, 250, 3, dtype=torch.int32)[None]
    anchors = [float(v) for lv in FACE_ANCHORS for p in lv for v in p]
    img = t(rng.randint(0, 256, (2, 40, 50, 3)).astype(np.uint8))
    boxes = t(np.float32([[[3, 4, 30, 35], [-5, 10, 20, 45], [10, 2, 49, 39]],
                          [[0, 0, 50, 40], [20, 20, 21, 21],
                           [7, 9, 33, 31]]]))
    cvalid = torch.tensor([[True, True, False], [True, True, True]])
    q = t(rng.normal(0, 1, (3, 8)).astype(np.float32))
    g = t(rng.normal(0, 1, (50, 8)).astype(np.float32))
    sd, sdv = (t(a)[None] for a in _blend_case(rng, 32))
    raw = [t(a) for a in _blaze_heads(rng, 2, 0.65)]
    x = t(rng.normal(0, 1, (2, 8, 9, 7)).astype(np.float32))
    kq = t(rng.randint(-127, 128, (6, 3, 3, 8)).astype(np.int8))
    ops = torch.ops.fdr
    return {
        "nms_fixpoint": (ops.nms_fixpoint.default,
                         (t(sb)[None], t(sv)[None], 0.3, True, False,
                          "union")),
        "candidate_decode": (ops.candidate_decode.default,
                             (levels, idx, anchors, [8, 16, 32], [64, 64],
                              0.4)),
        "crop_resize": (ops.crop_resize.default,
                        (img, boxes, cvalid, [12, 10], True, True,
                         [1.0, 2.0, 3.0], torch.float32)),
        "crop_resize_pad_bf16": (ops.crop_resize.default,
                                 (img.float(), boxes, cvalid, [7, 9], False,
                                  False, None, torch.bfloat16)),
        "topk_gallery": (ops.topk_gallery.default, (q, g, 4)),
        "blend_nms": (ops.blend_nms.default, (sd, sdv, 0.3, 8)),
        "blaze_decode_blend": (ops.blaze_decode_blend.default,
                               (*raw, t(_ANCHORS), 256.0, 100.0, 0.65, 0.3,
                                16)),
        "conv_int8": (ops.conv_int8.default,
                      (x, int8_conv.pack_kernel_q(kq), torch.full((6,), 0.01),
                       torch.zeros(6), 3, 2, 1, 1, "silu", None)),
        "conv_int8_static": (ops.conv_int8.default,
                             (x, int8_conv.pack_kernel_q(kq),
                              torch.full((6,), 0.01), torch.zeros(6), 3, 1, 1,
                              1, None, torch.tensor(0.02))),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_operator_passes_opcheck(case):
    """Each kernel entry point is an ``fdr`` operator whose schema, fake
    implementation (shapes, dtypes, strides) and CPU implementation agree;
    the CPU implementation is the plain version, and launches nothing."""
    op, args = OP_CASES[case]
    ck.reset_launches()
    torch.library.opcheck(op, args)
    assert not any(ck.LAUNCHES.values()) and ck._LIB == []


def test_operators_are_the_plain_versions_on_the_cpu():
    """The operators' CPU implementations give the wrappers' results bit
    for bit (Q1's in the kernel's channels-last layout)."""
    c = OP_CASES
    _same(c["nms_fixpoint"][0](*c["nms_fixpoint"][1]),
          ck.nms_fixpoint(*c["nms_fixpoint"][1]))
    levels, idx, _, _, _, conf = c["candidate_decode"][1]
    for got, ref in zip(c["candidate_decode"][0](*c["candidate_decode"][1]),
                        ck.candidate_decode(levels, idx, FACE_ANCHORS,
                                            (8, 16, 32), (64, 64), conf)):
        _same(got, ref)
    img, boxes, valid, hw, *rest = c["crop_resize"][1]
    _same(c["crop_resize"][0](*c["crop_resize"][1]),
          ck.crop_resize(img, boxes, valid, tuple(hw), *rest))
    for name in ("topk_gallery", "blend_nms", "blaze_decode_blend"):
        op, args = c[name]
        for got, ref in zip(op(*args), getattr(ck, name)(*args)):
            _same(got, ref)
    op, args = c["conv_int8"]
    got = op(*args)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _same(got.contiguous(), int8_conv.conv_int8_packed_plain(*args)
          .contiguous())


# ---------------- exported programs against the port's eager calls ------

# name: (detector, EngineConfig keywords)
DETECTORS = {
    "yolov5s": ("yolov5s", {}),
    "blazeface-front": ("blazeface-front", {}),
    "ov-0204": ("ov-0204", {}),
    "yolov5n-int8": ("yolov5n", {"detector_overrides": {
        "quantized": True, "input_size": (128, 128)}}),
    "blazeface-front-bf16": ("blazeface-front", {"dtype": torch.bfloat16}),
}


def _fakes_kept(net):
    """Fake tensors an export left in the net's modules (their caches)."""
    from torch._subclasses.fake_tensor import FakeTensor

    def walk(v):
        if isinstance(v, dict):
            return sum((walk(x) for x in v.values()), [])
        if isinstance(v, (tuple, list)):
            return sum((walk(x) for x in v), [])
        return [v] if isinstance(v, FakeTensor) else []

    return sum((walk(m.__dict__) for m in net.modules()), [])


@pytest.fixture(scope="module")
def golden_det():
    return _load("golden_yolov5s_ckpt")


@pytest.fixture(scope="module")
def frame():
    return cv2.imread(IMG)


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_exported_detector_equals_eager(name, golden_det, frame, tmp_path):
    """``export_detector`` -> ``load_exported`` -> ``.call`` on the
    preprocessed golden frame equals the engine's ``_detect`` bit for bit
    (yolov5s on its golden weights, the rest seeded), and the export leaves
    the engine's eager path as it was (no fake tensor kept in a cache)."""
    det, kw = DETECTORS[name]
    eng = FaceEngine(EngineConfig(detector=det, **kw), device="cpu")
    if name == "yolov5s":
        eng.load_state_dict(yolov5_face_state_dict(golden_det, "yolov5s"))
    frames = torch.from_numpy(np.stack([frame, frame[:, ::-1]]).copy())
    with torch.no_grad():
        x = eng._preprocess(frames)
    path = str(tmp_path / f"{name}.pt2")
    ck.reset_launches()
    X.export_detector(eng, path, batch=2)
    # the program owned Q1's packed weights; the net keeps none of them,
    # and no fake tensor of the trace
    assert "wpack" not in dict(eng.net.named_buffers())
    assert not _fakes_kept(eng.net)
    got = X.load_exported(path).call(x)
    with torch.inference_mode():
        ref = eng._detect(x)
    assert len(got) == 2
    for g, r in zip(got, ref):
        _same(g, r)
    if name == "yolov5s":
        assert int(got[1].sum()) >= 6  # the golden faces, in both frames
    # the CPU programs run the plain versions: nothing built or launched
    assert not any(ck.LAUNCHES.values()) and ck._LIB == []


def test_exported_embedder_equals_eager(tmp_path):
    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="mobile_facenet"), device="cpu")
    path = str(tmp_path / "embed.pt2")
    X.export_embedder(eng, path, batch=3)
    crops = np.random.RandomState(3).uniform(0, 255, (3, 112, 112, 3)) \
        .astype(np.float32)
    (got,) = X.load_exported(path).call(crops)
    with torch.inference_mode():
        ref = eng._embed(torch.from_numpy(crops))
    _same(got, ref)


def test_exported_jitted_function_carries_its_operators(tmp_path):
    """``export_jitted`` of a function of the search and blend NMS
    operators: the graph calls ``fdr`` operators, and the reloaded program
    equals the eager function."""
    from face_detection_and_recognition_tpu_torch.ops.nms import \
        weighted_blend_nms

    def fn(q, g, d, v):
        s, i = ck.topk_gallery(q, g, 5)
        rows, ok = weighted_blend_nms(d, v, 0.3, 8)
        return s, i, rows, ok

    rng = np.random.RandomState(5)
    args = [rng.normal(0, 1, (4, 16)).astype(np.float32),
            rng.normal(0, 1, (70, 16)).astype(np.float32),
            _blend_case(rng, 40)[0][None], rng.uniform(size=(1, 40)) > 0.2]
    path = str(tmp_path / "fn.pt2")
    X.export_jitted(fn, args, path, device="cpu")
    ex = X.load_exported(path)
    called = {str(n.target) for n in ex.program.graph.nodes
              if n.op == "call_function"}
    assert {"fdr.topk_gallery.default", "fdr.blend_nms.default"} <= called
    for got, ref in zip(ex.call(*args),
                        fn(*(torch.from_numpy(np.asarray(a)) for a in args))):
        _same(got, ref)


# ---------------- exported ensembles against the JAX engine ----------------


@pytest.fixture(scope="module")
def blaze_ensemble_file(tmp_path_factory):
    """The JAX test's case (``tests/test_export.py``): blazeface-front +
    mobile_facenet at 64x64, det_thres 0.3, max_det 4; the JAX engine's
    seeded weights carried into the port's engine by ``utils/weights.py``.
    Returns (JAX engine, port engine, the exported file)."""
    kw = dict(detector="blazeface-front", det_thres=0.3, max_det=4,
              embedder="mobile_facenet")
    jeng = JFaceEngine(JEngineConfig(**kw))
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(blazeface_state_dict(jeng.variables, False))
    teng.load_embed_state_dict(mobile_facenet_state_dict(jeng.embed_vars))
    path = str(tmp_path_factory.mktemp("export") / "ensemble.pt2")
    X.export_ensemble(teng, path, batch=1, image_hw=(64, 64))
    return jeng, teng, path


def test_exported_blaze_ensemble_matches_jax(blaze_ensemble_file):
    """Reloaded, the port's ensemble gives the JAX engine's boxes and
    embeddings within ``tests/test_export.py``'s 1e-4, and the port's eager
    call's outputs bit for bit."""
    jeng, teng, path = blaze_ensemble_file
    img = np.random.RandomState(42).randint(0, 255, (1, 64, 64, 3)) \
        .astype(np.uint8)
    out = X.load_exported(path).call(img)
    assert len(out) == 5  # boxes, scores, valid, crops, embeddings
    ref = jeng.detect_embed_classify_batch(img)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref.det.boxes),
                               atol=1e-4)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref.embeddings),
                               atol=1e-4)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref.det.valid))
    r = teng.detect_embed_classify_batch(img)
    for got, want in zip(out, (r.det.boxes, r.det.scores, r.det.valid,
                               r.crops, r.embeddings)):
        _same(got, want)


def test_reloading_process_imports_no_model_code(blaze_ensemble_file):
    """A process that loads the saved ensemble and calls it imports the
    operators' module and ``utils.export``, and no module of ``models``
    (nor the engine)."""
    code = (
        "import sys, numpy as np\n"
        "from face_detection_and_recognition_tpu_torch.utils.export import "
        "load_exported\n"
        f"out = load_exported({blaze_ensemble_file[2]!r}).call("
        "np.zeros((1, 64, 64, 3), np.uint8))\n"
        "assert len(out) == 5 and tuple(out[3].shape) == (1, 4, 112, 112, 3)\n"
        "mods = sorted(m for m in sys.modules "
        "if m.startswith('face_detection_and_recognition_tpu'))\n"
        "print('MODULES', ' '.join(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    mods = res.stdout.split("MODULES ")[1].split()
    assert "face_detection_and_recognition_tpu_torch.ops.cuda_kernels" in mods
    assert not [m for m in mods
                if m.startswith("face_detection_and_recognition_tpu_torch."
                                "models")
                or m.startswith("face_detection_and_recognition_tpu_torch."
                                "core")
                or m == "face_detection_and_recognition_tpu"
                or m.startswith("face_detection_and_recognition_tpu.")], mods


def test_exported_yolov5s_ensemble_matches_jax(golden_det, frame, tmp_path):
    """yolov5s + MobileFaceNet + age/gender on the golden weights
    (``tests/test_torch_ensemble.py``'s engines), exported, reloaded and
    called on the golden frame, against the JAX engine with that file's
    tolerances: the same valid slots, boxes within 1 px, scores within
    1e-4; on the rows whose floored boxes agree (the same crop pixels),
    crops within 1e-3 and embeddings and probabilities within 2e-4;
    invalid rows zero. The program runs the nets on every slot, masked."""
    ag = _load("golden_ag_ckpt")
    embed = _load("golden_embed_ckpt")
    kw = dict(detector="yolov5s", embedder="mobile_facenet",
              with_age_gender=True, max_det=16)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables, jeng.embed_vars = golden_det, embed
    jeng.ag_vars = (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(yolov5_face_state_dict(golden_det, "yolov5s"))
    teng.load_embed_state_dict(mobile_facenet_state_dict(embed))
    teng.load_age_gender_state_dict(age_gender_state_dict(ag["age"],
                                                          ag["gender"]))
    path = str(tmp_path / "ensemble.pt2")
    X.export_ensemble(teng, path, batch=1, image_hw=frame.shape[:2],
                      det_thres=0.3)
    out = [o.numpy() for o in X.load_exported(path).call(frame[None])]
    assert len(out) == 7
    boxes, scores, valid, crops, emb, age, gender = (o[0] for o in out)
    ref = jeng.detect_embed_classify_batch(frame[None], det_thres=0.3)
    rv = np.asarray(ref.det.valid)[0]
    np.testing.assert_array_equal(valid, rv)
    assert rv.sum() >= 3
    gb, rb = boxes[rv], np.asarray(ref.det.boxes)[0][rv]
    np.testing.assert_allclose(gb, rb, atol=1.0, rtol=0)
    np.testing.assert_allclose(scores[rv], np.asarray(ref.det.scores)[0][rv],
                               atol=1e-4, rtol=0)
    same = (np.floor(gb) == np.floor(rb)).all(-1)
    assert same.sum() >= 3
    for got, name, tol in ((crops, "crops", 1e-3), (emb, "embeddings", 2e-4),
                           (age, "age_probs", 2e-4),
                           (gender, "gender_probs", 2e-4)):
        want = np.asarray(getattr(ref, name))[0][rv][same]
        np.testing.assert_allclose(got[rv][same], want, atol=tol, rtol=0)
        assert (got[~rv] == 0).all()


# ---------------- the JAX module's errors ----------------


def test_native_resolution_cascade_refuses_export_detector(tmp_path):
    eng = FaceEngine(EngineConfig(detector="mtcnn"), device="cpu")
    with pytest.raises(ValueError, match="native-resolution"):
        X.export_detector(eng, str(tmp_path / "mtcnn.pt2"))
    with pytest.raises(NotImplementedError, match="fixed-size"):
        X.export_ensemble(eng, str(tmp_path / "mtcnn_ens.pt2"))


def test_engine_without_embedder_refuses_export_embedder(tmp_path):
    eng = FaceEngine(EngineConfig(detector="blazeface-front"), device="cpu")
    with pytest.raises(ValueError, match="no embedder"):
        X.export_embedder(eng, str(tmp_path / "embed.pt2"))
    assert not os.path.exists(tmp_path / "embed.pt2")


def test_int8_layer_exports_only_with_its_packed_weights():
    """While exporting, a ``QConvBN`` hands Q1 the packed weights that
    ``export_packed`` holds as a buffer, and refuses to export without
    them."""
    from face_detection_and_recognition_tpu_torch.models.layers import (
        QConvBN, export_packed)

    layer = QConvBN(8, 16).eval()
    x = torch.randn(1, 8, 4, 4)
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="export_packed"):
            torch.export.export(layer, (x,), strict=False)
        with export_packed(layer):
            prog = torch.export.export(layer, (x,), strict=False)
        _same(prog.module()(x), layer(x))
    assert "wpack" not in dict(layer.named_buffers())
