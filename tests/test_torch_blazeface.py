"""The port's BlazeFace slice against the JAX package (CPU): the front and
back networks through the weight bridge, decode and postprocess with the
weighted-blend NMS, the registry entries, and the engine on the golden
BlazeFace checkpoints: their gates, and the JAX engine's detections."""
import dataclasses
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
from face_detection_and_recognition_tpu.models import blazeface as JB
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.ops import nms as JN
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import blazeface as TB
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.ops import nms as TN
from face_detection_and_recognition_tpu_torch.ops import preprocess as TP
from face_detection_and_recognition_tpu_torch.utils.weights import \
    blazeface_state_dict
from tests.test_nms import random_boxes
from tests.test_torch_kernels import _blaze_heads, pallas_slots
from tests.test_torch_similarity import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def rng():
    """A fresh generator a test: the state of conftest's shared one
    depends on which tests ran before on the worker."""
    return np.random.RandomState(707)
CKPTS = {"blazeface-front": "golden_blaze_ckpt",
         "blazeface-back": "golden_blaze_back_ckpt"}


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) engines per BlazeFace detector, golden weights on both,
    det_thres 0.5 as in tests/test_golden_accuracy.py."""
    out = {}
    for name, ckpt in CKPTS.items():
        variables = _load(ckpt)
        jeng = JFaceEngine(JEngineConfig(detector=name, det_thres=0.5))
        jeng.variables = variables
        teng = FaceEngine(EngineConfig(detector=name, det_thres=0.5),
                          device="cpu")
        teng.load_state_dict(blazeface_state_dict(
            variables, name == "blazeface-back"))
        out[name] = (jeng, teng)
    return out


@pytest.mark.parametrize("back", [False, True])
def test_blazeface_net_matches_flax(back):
    """Random flax weights (no normalization, so the raw outputs run into
    the hundreds or thousands) through the bridge: raw boxes and scores."""
    cfg = JB.BlazeFaceConfig(back_model=back)
    net, params, _ = JB.make_blazeface(cfg, rng=jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, params)
    port = TB.BlazeFaceNet(back)
    port.load_state_dict(blazeface_state_dict(variables, back))
    port.eval()
    h, w = cfg.input_size
    x = np.random.RandomState(5).uniform(-1, 1, (2, h, w, 3)) \
        .astype(np.float32)
    ref_boxes, ref_scores = net.apply(variables, x)
    with torch.inference_mode():
        boxes, scores = port(torch.from_numpy(x))
    assert tuple(boxes.shape) == (2, 896, 16)
    assert tuple(scores.shape) == (2, 896, 1)
    # 17 (front) or 34 (back) f32 conv layers summed in another order:
    # relative to the outputs' magnitude
    for got, ref in ((boxes, ref_boxes), (scores, ref_scores)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_anchors_config_and_registry_match_jax():
    np.testing.assert_array_equal(TB.generate_anchors(),
                                  JB.generate_anchors())
    for back in (False, True):
        t, j = TB.BlazeFaceConfig(back_model=back), \
            JB.BlazeFaceConfig(back_model=back)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.input_size, t.scale, t.min_score_thresh) == \
            (j.input_size, j.scale, j.min_score_thresh)
    for name in CKPTS:
        ts, js = TR.get(name), JR.get(name)
        assert (ts.input_size, ts.rect_stride) == \
            (js.input_size, js.rect_stride)
        assert js.n_landmark_cols == 12      # the port's: Detections.lmarks
        assert dataclasses.asdict(ts.preprocess) == \
            dataclasses.asdict(js.preprocess)
    assert TP.BLAZEFACE_FRONT.size == JP.BLAZEFACE_FRONT.size == (128, 128)
    assert TP.BLAZEFACE_BACK.size == JP.BLAZEFACE_BACK.size == (256, 256)
    with pytest.raises(ValueError, match="fixed by the architecture"):
        FaceEngine(EngineConfig(detector="blazeface-front",
                                detector_overrides={"input_size": (96, 96)}),
                   device="cpu")


def _raw_heads(rng, b, thr):
    """Raw head outputs: box offsets in input pixels, and logits spread
    around the score threshold with a few clipped at +-100."""
    raw_boxes = rng.normal(0, 6, (b, 896, 16)).astype(np.float32)
    raw_boxes[..., 2:4] = rng.uniform(10, 30, (b, 896, 2))
    raw_scores = (np.log(thr / (1 - thr))
                  + rng.normal(0, 1.5, (b, 896, 1))).astype(np.float32)
    raw_scores[:, ::97] = 150.0
    raw_scores[:, 5::101] = -150.0
    return raw_boxes, raw_scores


@pytest.mark.parametrize("back", [False, True])
def test_decode_and_postprocess_match_jax(rng, back):
    cfg = JB.BlazeFaceConfig(back_model=back)
    tcfg = TB.BlazeFaceConfig(back_model=back)
    raw_boxes, raw_scores = _raw_heads(rng, 3, cfg.min_score_thresh)
    anchors = TB.generate_anchors()
    np.testing.assert_allclose(
        TB.decode_boxes(torch.from_numpy(raw_boxes), torch.from_numpy(anchors),
                        tcfg.scale).numpy(),
        np.asarray(JB.decode_boxes(raw_boxes, anchors, cfg.scale)),
        rtol=0, atol=1e-6)
    ref, ref_v = JB.blazeface_postprocess(raw_boxes, raw_scores,
                                          jnp.asarray(anchors), cfg)
    got, got_v = TB.blazeface_postprocess(
        torch.from_numpy(raw_boxes), torch.from_numpy(raw_scores),
        torch.from_numpy(anchors), tcfg)
    assert tuple(got.shape) == (3, 16, 17) and tuple(got_v.shape) == (3, 16)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    assert got_v.sum() > 16  # the blends ran on every frame
    # blends over up to tens of rows, summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("back", [False, True])
@pytest.mark.parametrize("case", ["ties", "none", "all", "inverted"])
def test_fused_plain_matches_jax_postprocess(rng, case, back, b):
    """The fused kernel's plain version against the JAX package's
    ``blazeface_postprocess``: ``_raw_heads`` (ties at sigmoid 1.0, +-150
    logits), nothing above the threshold, every anchor above it (896 valid
    rows against 16 slots), and a frame with an inverted box at score 1.0.
    Valid masks exactly; rows to f32 rounding of blends summed in another
    order, as in ``test_decode_and_postprocess_match_jax``."""
    cfg = JB.BlazeFaceConfig(back_model=back)
    tcfg = TB.BlazeFaceConfig(back_model=back)
    if case == "ties":
        raw_boxes, raw_scores = _raw_heads(rng, b, cfg.min_score_thresh)
    else:
        raw_boxes, raw_scores = _blaze_heads(rng, b, cfg.min_score_thresh,
                                             case)
    anchors = TB.generate_anchors()
    ref, ref_v = JB.blazeface_postprocess(raw_boxes, raw_scores,
                                          jnp.asarray(anchors), cfg)
    got, got_v = ck.blaze_decode_blend_plain(
        torch.from_numpy(raw_boxes), torch.from_numpy(raw_scores),
        torch.from_numpy(anchors), tcfg.scale, tcfg.score_clipping_thresh,
        tcfg.min_score_thresh, tcfg.min_suppression_threshold,
        tcfg.max_faces)
    assert tuple(got.shape) == (b, 16, 17) and tuple(got_v.shape) == (b, 16)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    if case == "none":
        assert not got_v.any()
    else:
        assert got_v.all()
    if case == "inverted":  # every frame keeps the inverted box as a slot
        assert ((got[..., 2] < got[..., 0]) & (got[..., 3] < got[..., 1])
                ).any(1).all()


def _nms_reference_case(rng, n):
    """tests/test_nms.py's blend case: pixel boxes / 100 in yx order, 12
    keypoints, scores in [0.3, 1)."""
    boxes = random_boxes(rng, n) / 100.0
    kps = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32)
    return np.concatenate([boxes[:, [1, 0, 3, 2]], kps, scores], -1)


@pytest.mark.parametrize("case", ["reference", "padded", "empty", "batch"])
def test_weighted_blend_nms_matches_jax(rng, case):
    """The cases of tests/test_nms.py on the port's ``weighted_blend_nms``
    (one image or a batch) against the JAX fori path (picks exactly, rows
    to f32 rounding) and the Pallas kernel's keep set."""
    if case == "reference":
        images = [(_nms_reference_case(rng, 40), np.ones(40, bool), 40)]
    elif case == "padded":  # fewer candidate rows than max_out
        dets = np.zeros((4, 17), np.float32)
        dets[:, 0:2] = rng.uniform(0.1, 0.4, (4, 2))
        dets[:, 2:4] = dets[:, 0:2] + 0.2
        dets[:, 16] = [0.9, 0.8, 0.7, 0.6]
        images = [(dets, np.array([True, True, False, True]), 16)]
    elif case == "empty":
        images = [(np.zeros((8, 17), np.float32), np.zeros(8, bool), 4)]
    else:
        images = [(_nms_reference_case(rng, 64), rng.uniform(size=64) > 0.2,
                   16) for _ in range(3)]
    refs = [JN.weighted_blend_nms(jnp.asarray(d), jnp.asarray(v), 0.3, m)
            for d, v, m in images]
    if case == "batch":
        out, ov = TN.weighted_blend_nms(
            torch.from_numpy(np.stack([d for d, _, _ in images])),
            torch.from_numpy(np.stack([v for _, v, _ in images])), 0.3, 16)
        got = list(zip(out.numpy(), ov.numpy()))
    else:
        got = [tuple(t.numpy() for t in TN.weighted_blend_nms(
            torch.from_numpy(d), torch.from_numpy(v), 0.3, m))
            for d, v, m in images]
    for (out, ov), (ref, ref_v), (d, v, m) in zip(got, refs, images):
        assert out.shape == (m, 17) and ov.shape == (m,)
        np.testing.assert_array_equal(ov, np.asarray(ref_v))
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
        assert (out[~ov] == 0).all()
        _, _, sv, sd = JN.sort_by_score(jnp.asarray(d[:, -1]),
                                        jnp.asarray(v), jnp.asarray(d))
        np.testing.assert_array_equal(ov, pallas_slots(sd, sv, m)[1])
    if case == "empty":
        assert not got[0][1].any()


def test_port_blazeface_front_passes_golden_gate(engines):
    """The gate of tests/test_golden_accuracy.py for golden_blaze_ckpt,
    through the port."""
    r = evaluate_golden(engines["blazeface-front"][1])
    assert r["n_pos"] == 3, r
    assert r["n_neg"] == 0, r
    assert all(iou >= 0.5 for iou in r["ious"]), r["ious"]
    assert sorted(r["ious"])[1] >= 0.7, r["ious"]
    assert max(r["ious"]) >= 0.8, r["ious"]


def test_port_blazeface_back_passes_golden_gate(engines):
    """The gate of tests/test_golden_accuracy.py for
    golden_blaze_back_ckpt, through the port."""
    r = evaluate_golden(engines["blazeface-back"][1], det_thres=0.6,
                        margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]


@pytest.mark.parametrize("name", list(CKPTS))
@pytest.mark.parametrize("image", ["test2_faces_3.jpg", "test1_faces_0.jpg"])
def test_port_blazeface_engine_matches_jax(engines, name, image):
    jeng, teng = engines[name]
    img = cv2.imread(os.path.join(DATA, image))
    ref = jeng.detect_image(img, det_thres=0.3)
    got = teng.detect_image(img, det_thres=0.3)
    assert len(got) == len(ref)
    # rounded pixel boxes: an f32 difference can flip a .5 rounding
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.bbox_confs, ref.bbox_confs, atol=1e-4,
                               rtol=0)
    if len(got):
        assert got.bbox_lmarks.shape == (len(got), 12)
        np.testing.assert_allclose(got.bbox_lmarks, ref.bbox_lmarks,
                                   atol=1.0, rtol=0)
    raw, jraw = teng.detect_raw(img), np.asarray(jeng.detect_raw(img))
    assert raw.shape == jraw.shape and raw.shape[1] == 17
    np.testing.assert_allclose(raw, jraw, rtol=0, atol=1e-4)


def test_port_blazeface_batch_contract(engines):
    """detect_batch: the detector's 16 rows reach the [B, max_det] contract
    unpadded (max_det 64 slices nothing, 8 cuts), 12 landmark columns, and
    a frame in a batch gives what it gives alone."""
    teng = engines["blazeface-back"][1]
    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    batch = np.stack([img, np.ascontiguousarray(img[:, ::-1])])
    dets = teng.detect_batch(batch, det_thres=0.3)
    assert tuple(dets.boxes.shape) == (2, 16, 4)
    assert tuple(dets.lmarks.shape) == (2, 16, 12)
    assert tuple(dets.valid.shape) == (2, 16)
    for frame, res in zip(batch, dets.to_numpy()):
        one = teng.detect_image(np.ascontiguousarray(frame), det_thres=0.3)
        np.testing.assert_allclose(res.boxes, one.boxes, atol=1.0, rtol=0)
    small = FaceEngine(EngineConfig(detector="blazeface-back", max_det=8),
                       device="cpu")
    small.net.load_state_dict(teng.net.state_dict())
    cut = small.detect_batch(batch, det_thres=0.3)
    assert tuple(cut.boxes.shape) == (2, 8, 4)
    torch.testing.assert_close(cut.boxes, dets.boxes[:, :8], rtol=0, atol=0)


def test_seeded_blazeface_spreads_scores_around_threshold():
    """Seeded random weights: on noise frames some anchors of every frame
    pass the score threshold and some do not, so the blend NMS has work."""
    for name in CKPTS:
        eng = FaceEngine(EngineConfig(detector=name), device="cpu")
        frames = np.random.RandomState(7).randint(0, 256, (2, 96, 160, 3)) \
            .astype(np.uint8)
        x = TP.apply_preprocess_batch(torch.from_numpy(frames),
                                      eng.spec.preprocess)
        with torch.inference_mode():
            _, raw_scores = eng.net(x)
        cfg = TB.BlazeFaceConfig(back_model=name == "blazeface-back")
        above = (torch.sigmoid(raw_scores[..., 0].clamp(-100, 100))
                 >= cfg.min_score_thresh).sum(1)
        assert ((above > 0) & (above < 896)).all(), above
        dets = eng.detect_batch(frames, det_thres=0.0, bbox_area_thres=0.0)
        assert dets.valid.any(1).all()
        for t in (dets.boxes, dets.lmarks, dets.scores):
            assert torch.isfinite(t).all()
