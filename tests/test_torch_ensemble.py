"""The port's ensemble slice against the JAX package (CPU): MobileFaceNet and
the CaffeNet age/gender heads through the weight bridge, the fused
detect -> crop -> embed -> age/gender batch and its staged entry points on
the golden checkpoints, and the repo's embed and age/gender gates run
through the port."""
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
from face_detection_and_recognition_tpu.models import age_gender as JAG
from face_detection_and_recognition_tpu.models.embedders import \
    preprocess_crops as j_preprocess_crops
from face_detection_and_recognition_tpu.models.mobile_facenet import \
    MobileFaceNet as JMobileFaceNet
from face_detection_and_recognition_tpu.ops import crop as JC
from face_detection_and_recognition_tpu.train import golden_embed as GE
from face_detection_and_recognition_tpu.train.golden_ag import \
    evaluate_golden_ag
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import age_gender as TAG
from face_detection_and_recognition_tpu_torch.models.mobile_facenet import \
    MobileFaceNet
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, mobile_facenet_state_dict, yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
MAX_DET = 16


def _load(name):
    """A checkpoint as float32 numpy arrays. golden_embed_ckpt and
    golden_ag_ckpt are stored in bf16; the bridge casts them to f32, and
    the JAX modules get the same f32 arrays. (Handed bf16 arrays, flax's
    BatchNorm computes rsqrt(var + eps) * scale in bf16, which moves
    MobileFaceNet's embeddings by ~1e-3: a rounding of the stored
    checkpoint, not of the network.)"""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def golden():
    ag = _load("golden_ag_ckpt")
    return {"det": _load("golden_yolov5s_ckpt"),
            "embed": _load("golden_embed_ckpt"),
            "age": ag["age"], "gender": ag["gender"]}


@pytest.fixture(scope="module")
def port_nets(golden):
    net = MobileFaceNet().eval()
    net.load_state_dict(mobile_facenet_state_dict(golden["embed"]))
    heads = TAG.AgeGenderNet().eval()
    heads.load_state_dict(age_gender_state_dict(golden["age"],
                                                golden["gender"]))
    return net, heads


@pytest.fixture(scope="module")
def engines(golden):
    """(JAX, port) at yolov5s + mobile_facenet + age/gender, golden
    weights on both."""
    kw = dict(detector="yolov5s", embedder="mobile_facenet",
              with_age_gender=True, max_det=MAX_DET)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables = golden["det"]
    jeng.embed_vars = golden["embed"]
    jeng.ag_vars = (golden["age"], golden["gender"])
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(yolov5_face_state_dict(golden["det"], "yolov5s"))
    teng.load_embed_state_dict(mobile_facenet_state_dict(golden["embed"]))
    teng.load_age_gender_state_dict(age_gender_state_dict(golden["age"],
                                                          golden["gender"]))
    return jeng, teng


def test_mobile_facenet_bridge_equals_flax(golden, port_nets):
    x = np.random.RandomState(11).uniform(-1, 1, (4, 112, 112, 3)) \
        .astype(np.float32)
    ref = np.asarray(JMobileFaceNet().apply(golden["embed"], x))
    with torch.inference_mode():
        got = port_nets[0](torch.from_numpy(x)).numpy()
    assert got.shape == (4, 512)
    # the tolerance of tests/test_mobile_facenet.py
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_age_gender_bridge_equals_flax(golden, port_nets):
    rng = np.random.RandomState(12)
    x = (rng.uniform(0, 255, (4, 227, 227, 3)) - 100.0).astype(np.float32)
    ra = jax.nn.softmax(JAG.CaffeNetHead(8).apply(golden["age"], x), -1)
    rg = jax.nn.softmax(JAG.CaffeNetHead(2).apply(golden["gender"], x), -1)
    with torch.inference_mode():
        ga, gg = port_nets[1](torch.from_numpy(x))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=2e-4, rtol=0)
    np.testing.assert_allclose(gg.numpy(), np.asarray(rg), atol=2e-4, rtol=0)
    assert TAG.labels_from_probs(ga.numpy(), gg.numpy()) == \
        JAG.labels_from_probs(ra, rg)
    assert TAG.AGE_BUCKETS == JAG.AGE_BUCKETS and TAG.GENDERS == JAG.GENDERS
    # caffe's ceil-mode pools: 227 -> 56 -> 28 -> 14 -> 7 (fc6 reads 384x7x7)
    sizes = []
    hook = port_nets[1].age.pool.register_forward_hook(
        lambda m, i, o: sizes.append((i[0].shape[-1], o.shape[-1])))
    with torch.inference_mode():
        port_nets[1](torch.from_numpy(x[:1]))
    hook.remove()
    assert sizes == [(56, 28), (28, 14), (14, 7)]


def _ref_rows(got_boxes, ref_boxes, ref_rows, fn):
    """The JAX rows to hold the port's against. A sub-pixel box difference
    can flip floor(box) and move a whole crop by a pixel: such a row is
    compared with the JAX function applied to the port's own box."""
    out = np.array(ref_rows)
    for j in np.nonzero((np.floor(got_boxes) != np.floor(ref_boxes))
                        .any(-1))[0]:
        out[j] = fn(got_boxes[j])
    return out


def test_ensemble_matches_jax_engine(engines):
    jeng, teng = engines
    img = cv2.imread(IMG)
    h, w = img.shape[:2]
    ref = jeng.detect_embed_classify_batch(img[None], det_thres=0.3)
    got = teng.detect_embed_classify_batch(img[None], det_thres=0.3)
    valid = np.asarray(ref.det.valid)[0]
    np.testing.assert_array_equal(got.det.valid.numpy()[0], valid)
    assert valid.sum() >= 3
    gb = got.det.boxes.numpy()[0][valid]
    rb = np.asarray(ref.det.boxes)[0][valid]
    np.testing.assert_allclose(gb, rb, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.det.scores.numpy()[0][valid],
                               np.asarray(ref.det.scores)[0][valid],
                               atol=1e-4, rtol=0)
    spec = jeng.embed_spec

    def j_crop(box, hw=(112, 112)):
        return np.clip(np.asarray(JC.crop_and_resize(
            jnp.asarray(img), jnp.asarray(box[None]), hw)), 0, 255)[0]

    def j_embed(box):
        return np.asarray(jeng._embed(jeng.embed_vars, j_preprocess_crops(
            spec, j_crop(box)[None])))[0]

    def ag_box(box):
        return np.asarray(JC.pad_boxes(jnp.asarray(box), (-5, -5, 5, 5),
                                       (w, h)))

    def j_ag(padded_box):
        x = j_crop(padded_box, (227, 227)) - np.float32(
            [78.4263377603, 87.7689143744, 114.895847746])
        a, g = jeng._classify_ag(*jeng.ag_vars, x[None])
        return np.concatenate([np.asarray(a)[0], np.asarray(g)[0]])

    crops = _ref_rows(gb, rb, np.asarray(ref.crops)[0][valid], j_crop)
    np.testing.assert_allclose(got.crops.numpy()[0][valid], crops,
                               atol=1e-3, rtol=0)
    emb = _ref_rows(gb, rb, np.asarray(ref.embeddings)[0][valid], j_embed)
    np.testing.assert_allclose(got.embeddings.numpy()[0][valid], emb,
                               atol=2e-4, rtol=0)
    probs = np.concatenate([np.asarray(ref.age_probs)[0],
                            np.asarray(ref.gender_probs)[0]], -1)[valid]
    gab = np.stack([ag_box(b) for b in gb])
    rab = np.stack([ag_box(b) for b in rb])
    probs = _ref_rows(gab, rab, probs, j_ag)
    np.testing.assert_allclose(
        torch.cat([got.age_probs, got.gender_probs], -1).numpy()[0][valid],
        probs, atol=2e-4, rtol=0)
    # invalid slots: every output row exactly zero
    for t in (got.crops, got.embeddings, got.age_probs, got.gender_probs):
        assert (t.numpy()[0][~valid] == 0).all()


def test_ensemble_batch_rect_offsets_match_jax(golden):
    """B = 2 (the golden image and its mirror), rect letterbox, 64 x 48 raw
    crops and the extraction offsets: the port's fused batch against the
    JAX engine's, on golden weights."""
    kw = dict(detector="yolov5s", embedder="mobile_facenet", rect=True,
              max_det=MAX_DET)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables = golden["det"]
    jeng.embed_vars = golden["embed"]
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(yolov5_face_state_dict(golden["det"], "yolov5s"))
    teng.load_embed_state_dict(mobile_facenet_state_dict(golden["embed"]))
    img = cv2.imread(IMG)
    batch = np.stack([img, np.ascontiguousarray(img[:, ::-1])])
    call = dict(det_thres=0.3, crop_size=(64, 48),
                embed_offsets=JC.EXTRACTION_OFFSETS)
    ref = jeng.detect_embed_classify_batch(batch, **call)
    got = teng.detect_embed_classify_batch(batch, **call)
    valid = np.asarray(ref.det.valid)
    np.testing.assert_array_equal(got.det.valid.numpy(), valid)
    assert (valid.sum(1) >= 3).all()
    np.testing.assert_array_equal(got.det.boxes.numpy()[valid],
                                  np.asarray(ref.det.boxes)[valid])
    assert tuple(got.crops.shape) == (2, MAX_DET, 64, 48, 3)
    # pixel values to 255: two f32 ulps there
    np.testing.assert_allclose(got.crops.numpy(), np.asarray(ref.crops),
                               rtol=0, atol=3.1e-5)
    np.testing.assert_allclose(got.embeddings.numpy(),
                               np.asarray(ref.embeddings), rtol=0, atol=1e-5)


def test_staged_entry_points_match_jax(engines):
    jeng, teng = engines
    rng = np.random.RandomState(13)
    faces = rng.randint(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    np.testing.assert_allclose(teng.embed_crops(faces),
                               jeng.embed_crops(faces), atol=2e-4, rtol=0)
    for got, ref in zip(teng.classify_crops_age_gender(faces),
                        jeng.classify_crops_age_gender(faces)):
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    img = cv2.imread(IMG)
    boxes = np.float32([[408, 212, 472, 301], [283, 230, 344, 309]])
    np.testing.assert_allclose(
        teng.embed_faces(img, boxes, JC.EXTRACTION_OFFSETS),
        jeng.embed_faces(img, boxes, JC.EXTRACTION_OFFSETS),
        atol=2e-4, rtol=0)
    tp, te = teng.detect_and_embed(img)
    jp, je = jeng.detect_and_embed(img)
    np.testing.assert_allclose(tp.boxes, jp.boxes, atol=1.0, rtol=0)
    np.testing.assert_allclose(te, je, atol=2e-4, rtol=0)
    got, ref = teng.detect_age_gender(img), jeng.detect_age_gender(img)
    assert got.bbox_labels == ref.bbox_labels and len(got) == 3


def test_ensemble_contract_on_random_frames():
    """Seeded random weights, every NMS survivor live: shapes, unit
    embeddings, probabilities summing to 1, zero rows for invalid slots,
    and the stages a call does not want left out."""
    eng = FaceEngine(EngineConfig(detector="yolov5s",
                                  embedder="mobile_facenet",
                                  with_age_gender=True, max_det=MAX_DET),
                     device="cpu")
    frames = np.random.RandomState(14).randint(0, 256, (2, 96, 128, 3)) \
        .astype(np.uint8)
    r = eng.detect_embed_classify_batch(frames, det_thres=0.0,
                                        bbox_area_thres=0.0)
    v = r.det.valid
    assert tuple(r.crops.shape) == (2, MAX_DET, 112, 112, 3)
    assert tuple(r.embeddings.shape) == (2, MAX_DET, 512)
    assert tuple(r.age_probs.shape) == (2, MAX_DET, 8)
    assert tuple(r.gender_probs.shape) == (2, MAX_DET, 2)
    assert v.any() and not v.all()
    torch.testing.assert_close(r.embeddings[v].norm(dim=-1),
                               torch.ones(int(v.sum())), atol=1e-4, rtol=0)
    for p in (r.age_probs, r.gender_probs):
        torch.testing.assert_close(p[v].sum(-1), torch.ones(int(v.sum())),
                                   atol=1e-5, rtol=0)
    for t in (r.crops, r.embeddings, r.age_probs, r.gender_probs):
        assert torch.isfinite(t).all() and (t[~v] == 0).all()
    # crop_size and offsets: the embedder then crops its own 112 x 112
    r2 = eng.detect_embed_classify_batch(
        frames, det_thres=0.0, bbox_area_thres=0.0, crop_size=(64, 48),
        embed_offsets=(-6, -1, 4, 5), want_ag=False)
    assert tuple(r2.crops.shape) == (2, MAX_DET, 64, 48, 3)
    assert r2.age_probs is None and r2.gender_probs is None
    assert (r2.embeddings[~v] == 0).all()
    r3 = eng.detect_embed_classify_batch(frames, det_thres=0.0,
                                         bbox_area_thres=0.0,
                                         want_embed=False, want_ag=False)
    assert r3.embeddings is None and r3.age_probs is None
    torch.testing.assert_close(r3.crops, r.crops, atol=0, rtol=0)
    # no face at all: every row zero, the nets never run
    r4 = eng.detect_embed_classify_batch(frames, det_thres=1.0)
    assert not r4.det.valid.any()
    assert (r4.embeddings == 0).all() and (r4.age_probs == 0).all()


def test_port_embedder_passes_identity_filter_gate(engines):
    """The gate of tests/test_golden_embed.py, through the port."""
    r = GE.evaluate_identity_filter(engines[1].embed_crops)
    assert r["ok"], r
    assert r["same_acc"] == 1.0 and r["cross_acc"] == 1.0
    assert r["margin"] > 0


def test_port_cascade_passes_golden_age_gender_gate(golden):
    """The gate of tests/test_golden_accuracy.py for the two-stage cascade
    (yolov5n -> +-5 px crops -> CaffeNet heads), through the port."""
    eng = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5,
                                  with_age_gender=True), device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(_load("golden_yolov5n_ckpt"),
                                               "yolov5n"))
    eng.load_age_gender_state_dict(age_gender_state_dict(golden["age"],
                                                         golden["gender"]))
    r = evaluate_golden_ag(eng)
    assert r["matched"] == 3, r
    assert all(r["labels_ok"]), r
    assert r["n_neg"] == 0, r
