"""The port's four other embedder slots against the JAX package (CPU):
FaceNet (Inception-ResNet-V1, 128-d and 512-d), the MobileNetV2 reid
embedder and the 10-d demographics vector through the weight bridge on the
committed checkpoints, ``standardize_image`` ("prewhiten") and the crop
norms, the engine's entry points at each slot's own input size, and the
identity-filter and 16-identity retrieval gates of facenet, facenet-512 and
reid-mnv2 run through the port's embedders and search."""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.models import embedders as JE
from face_detection_and_recognition_tpu.models import ssd as JS
from face_detection_and_recognition_tpu.ops import geometry as JG
from face_detection_and_recognition_tpu.train import golden_embed as GE
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import embedders as TE
from face_detection_and_recognition_tpu_torch.models.facenet import \
    InceptionResNetV1
from face_detection_and_recognition_tpu_torch.models.layers import ConvBN
from face_detection_and_recognition_tpu_torch.models.ssd import \
    _MobileNetV2Backbone
from face_detection_and_recognition_tpu_torch.ops import geometry as TG
from face_detection_and_recognition_tpu_torch.pipelines import \
    similarity as TS
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, facenet_state_dict, reid_mnv2_state_dict,
    yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
# slot -> (checkpoint, crop side)
CKPTS = {"facenet": ("golden_facenet_ckpt", 160),
         "facenet-512": ("golden_facenet512_ckpt", 160),
         "reid-mnv2": ("golden_reid_ckpt", 128),
         "demographics": ("golden_ag_ckpt", 227)}
GATED = ("facenet", "reid-mnv2", "facenet-512")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, as in
    tests/test_torch_similarity.py: the tier-1 run puts several pytest
    workers on the host's cores, and torch's default pool (a thread a
    core, in every worker) then spends most of its time waiting. The
    previous count is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    """A checkpoint as float32 numpy arrays. The embedder checkpoints are
    stored in bf16; handed those arrays, flax's BatchNorm computes in bf16
    and moves the embeddings by ~1e-3, so both packages get the f32
    cast."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


def _state_dict(slot, variables):
    if slot in ("facenet", "facenet-512"):
        return facenet_state_dict(variables, TE.get_embedder(slot).dim)
    if slot == "reid-mnv2":
        return reid_mnv2_state_dict(variables)
    return age_gender_state_dict(variables["age"], variables["gender"])


@pytest.fixture(scope="module")
def golden():
    return {slot: _load(ckpt) for slot, (ckpt, _) in CKPTS.items()}


@pytest.fixture(scope="module")
def port_engines(golden):
    """A port engine a slot (blazeface-front detector, as the gates build
    it) with the slot's golden weights."""
    out = {}
    for slot in CKPTS:
        eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                      embedder=slot), device="cpu")
        eng.load_embed_state_dict(_state_dict(slot, golden[slot]))
        out[slot] = eng
    return out


# ---------------- registry, norms, blocks ----------------


def test_registry_has_the_jax_slots():
    assert TE.available_embedders() == JE.available_embedders()
    for name in JE.available_embedders():
        j, t = JE.get_embedder(name), TE.get_embedder(name)
        assert (t.dim, t.input_size, t.norm, t.rgb) == \
            (j.dim, j.input_size, j.norm, j.rgb), name


@pytest.mark.parametrize("shape", [(2, 40, 30, 3), (40, 30, 3)])
def test_standardize_image_equals_jax(shape):
    rng = np.random.RandomState(5)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    np.testing.assert_allclose(TG.standardize_image(torch.from_numpy(x))
                               .numpy(), np.asarray(JG.standardize_image(x)),
                               rtol=1e-5, atol=1e-5)
    # a flat image: std 0, so the divisor is 1 / sqrt(n)
    flat = np.full(shape, 7.0, np.float32)
    np.testing.assert_array_equal(
        TG.standardize_image(torch.from_numpy(flat)).numpy(),
        np.asarray(JG.standardize_image(flat)))
    with pytest.raises(ValueError):
        TG.standardize_image(torch.zeros(4, 4))


@pytest.mark.parametrize("slot", sorted(CKPTS) + ["mobile_facenet"])
def test_preprocess_crops_equals_jax(slot):
    """Channel order and norm of each slot, on BGR crops at its size."""
    spec = TE.get_embedder(slot)
    w, h = spec.input_size
    x = np.random.RandomState(9).uniform(0, 255, (3, h, w, 3)) \
        .astype(np.float32)
    ref = np.asarray(JE.preprocess_crops(JE.get_embedder(slot), x))
    got = TE.preprocess_crops(spec, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_convbn_options():
    """The yolov5 ``Conv`` is unchanged (SiLU, dense); ``act`` None / relu6
    and ``groups`` give MobileNetV2's blocks."""
    x = torch.randn(2, 8, 9, 9)
    for act, fn in (("silu", torch.nn.functional.silu),
                    ("relu6", torch.nn.functional.relu6),
                    (None, lambda t: t)):
        m = ConvBN(8, 8, 3, 2, groups=8 if act == "relu6" else 1,
                   act=act).eval()
        with torch.no_grad():
            ref = fn(m.bn(m.conv(x)))
            assert torch.equal(m(x), ref)
    assert isinstance(ConvBN(8, 16).act, torch.nn.SiLU)
    assert ConvBN(8, 16, 3, 1, groups=8).conv.weight.shape == (16, 1, 3, 3)


def test_mobilenetv2_backbone_maps_equal_flax(golden):
    """The SSD MobileNetV2 trunk alone: its four maps (strides 8, 16, 32,
    64) against the JAX backbone, on the reid checkpoint's trunk."""
    v = golden["reid-mnv2"]
    sub = {k: v[k]["_MobileNetV2Backbone_0"] for k in ("params",
                                                       "batch_stats")}
    x = np.random.RandomState(4).uniform(-1, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    ref = JS._MobileNetV2Backbone().apply(sub, x)
    net = TE.MobileNetV2Embedder().eval()
    net.load_state_dict(reid_mnv2_state_dict(v))
    with torch.inference_mode():
        got = net.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert isinstance(net.backbone, _MobileNetV2Backbone)
    assert [tuple(g.shape[1:]) for g in got] == \
        [(32, 16, 16), (96, 8, 8), (160, 4, 4), (256, 2, 2)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=1e-4, atol=2e-4)


# ---------------- the nets through the bridge ----------------


@pytest.mark.parametrize("slot", sorted(CKPTS))
def test_embedder_bridge_equals_flax(golden, slot):
    """Each slot's net on its golden checkpoint (f32-cast) against the JAX
    package's, on normalized crops at its input size: within 2e-4, the
    tolerance of tests/test_torch_ensemble.py."""
    spec = TE.get_embedder(slot)
    w, h = spec.input_size
    rng = np.random.RandomState(21)
    x = rng.uniform(0, 255, (4, h, w, 3)).astype(np.float32)
    x = np.array(JE.preprocess_crops(JE.get_embedder(slot), x))
    _, _, embed = JE.get_embedder(slot).build(rng=jax.random.PRNGKey(0))
    ref = np.asarray(embed(golden[slot], x))
    net = spec.build(torch.Generator().manual_seed(0), torch.device("cpu"))
    net.load_state_dict(_state_dict(slot, golden[slot]))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (4, spec.dim)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    if slot == "demographics":
        np.testing.assert_allclose(got[:, :8].sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(got[:, 8:].sum(-1), 1.0, atol=1e-5)
    else:
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)


def test_facenet_bn_has_no_scale(golden):
    """Flax's scale-free BatchNorm maps to a torch BN whose weight is one,
    present in the state dict; the SAME-padded (1, 7) / (7, 1) kernels pad
    (0, 3) / (3, 0)."""
    sd = facenet_state_dict(golden["facenet"])
    net = InceptionResNetV1(128)
    assert set(sd) == set(net.state_dict())
    bn_weights = [v for k, v in sd.items() if k.endswith("bn.weight")]
    assert len(bn_weights) > 100 and all(bool((w == 1).all())
                                         for w in bn_weights)
    b17 = net.repeat_2[0].branch1
    assert b17[1].conv.padding == (0, 3) and b17[2].conv.padding == (3, 0)
    assert net.mixed_6a.branch0.conv.padding == (0, 0)


# ---------------- the engine's entry points ----------------


@pytest.mark.parametrize("slot", sorted(CKPTS))
def test_embed_crops_equals_jax_engine(golden, port_engines, slot):
    """``embed_crops`` on crops of another size (stretched to the slot's
    own) against the JAX engine's."""
    jeng = JFaceEngine(JEngineConfig(detector="blazeface-front",
                                     embedder=slot))
    jeng.embed_vars = golden[slot]
    faces = np.random.RandomState(33).randint(0, 256, (3, 96, 80, 3),
                                              np.uint8)
    ref = jeng.embed_crops(faces)
    got = port_engines[slot].embed_crops(faces)
    assert got.shape == (3, TE.get_embedder(slot).dim)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_ensemble_with_facenet_matches_jax_engine(golden):
    """detect -> 160x160 crops -> FaceNet -> age/gender on the golden
    frame (yolov5s golden detector): the same faces, boxes within 1 px,
    FaceNet embeddings and probabilities within 2e-4 (rows whose floored
    box agrees, so the crop is the same pixels)."""
    det = _load("golden_yolov5s_ckpt")
    ag = golden["demographics"]
    kw = dict(detector="yolov5s", embedder="facenet", with_age_gender=True,
              max_det=16)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables, jeng.embed_vars = det, golden["facenet"]
    jeng.ag_vars = (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(yolov5_face_state_dict(det, "yolov5s"))
    teng.load_embed_state_dict(_state_dict("facenet", golden["facenet"]))
    teng.load_age_gender_state_dict(_state_dict("demographics", ag))
    img = cv2.imread(IMG)
    ref = jeng.detect_embed_classify_batch(img[None], det_thres=0.3)
    got = teng.detect_embed_classify_batch(img[None], det_thres=0.3)
    valid = np.asarray(ref.det.valid)[0]
    np.testing.assert_array_equal(got.det.valid.numpy()[0], valid)
    assert valid.sum() >= 3 and tuple(got.crops.shape[2:]) == (160, 160, 3)
    gb, rb = got.det.boxes.numpy()[0][valid], np.asarray(ref.det.boxes)[0][
        valid]
    np.testing.assert_allclose(gb, rb, atol=1.0, rtol=0)
    same = (np.floor(gb) == np.floor(rb)).all(-1)
    assert same.sum() >= 3
    for name in ("embeddings", "age_probs", "gender_probs"):
        g = getattr(got, name).numpy()[0][valid][same]
        r = np.asarray(getattr(ref, name))[0][valid][same]
        np.testing.assert_allclose(g, r, atol=2e-4, rtol=0)


def test_embed_faces_crops_at_each_slot_size(golden, port_engines):
    """``embed_faces`` crops the boxes at the slot's own size (B3's plain
    version here) and gives what ``embed_crops`` gives on those crops."""
    from face_detection_and_recognition_tpu_torch.ops.crop import \
        crop_and_resize

    img = cv2.imread(IMG)
    boxes = np.array([[408, 212, 472, 301], [283, 230, 344, 309]],
                     np.float32)
    for slot, eng in port_engines.items():
        w, h = TE.get_embedder(slot).input_size
        crops = crop_and_resize(torch.from_numpy(img), boxes, (h, w))
        assert tuple(crops.shape) == (2, h, w, 3)
        with torch.inference_mode():
            ref = eng._embed(crops).numpy()
        np.testing.assert_allclose(eng.embed_faces(img, boxes), ref,
                                   atol=1e-6)


# ---------------- the gates, through the port ----------------


@pytest.mark.parametrize("slot", GATED)
def test_port_slot_passes_identity_filter_gate(port_engines, slot):
    """The identity-filter gates of tests/test_golden_embed.py."""
    r = GE.evaluate_identity_filter(port_engines[slot].embed_crops,
                                    size=CKPTS[slot][1])
    assert r["ok"], r
    assert r["margin"] > 0.1, r


@pytest.fixture(scope="module")
def identity_embeddings(port_engines):
    """{slot: (gallery, probes)}: the 16-identity split of
    ``GE.evaluate_retrieval`` (32 gallery and 8 probe crops an identity),
    embedded by the port."""
    out = {}
    for slot in GATED:
        size, eng = CKPTS[slot][1], port_engines[slot]
        gal = GE.make_multi_identity_crops(303, 32, size=size,
                                           n_identities=16)
        probes = GE.make_multi_identity_crops(404, 8, size=size,
                                              n_identities=16)
        out[slot] = (np.concatenate([eng.embed_crops(np.stack(c))
                                     for c in gal]),
                     np.concatenate([eng.embed_crops(np.stack(c))
                                     for c in probes]))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("slot", GATED)
def test_port_retrieval_gate_16_identities(identity_embeddings, slot,
                                           use_pallas):
    """The bar of tests/test_retrieval_accuracy.py for each slot, with the
    port's embedder, ``topk_similar`` (both search paths) and filter math:
    rank-1 1.0, cross 1.0, same >= 0.93, a positive margin on every
    identity."""
    gal, probes = identity_embeddings[slot]
    gal_ids = np.repeat(np.arange(16), 32)
    probe_ids = np.repeat(np.arange(16), 8)
    _, idx = TS.topk_similar(probes, gal, k=1, use_pallas=use_pallas,
                             device="cpu")
    assert (gal_ids[idx[:, 0]] == probe_ids).mean() == 1.0
    refs = [TS.ClassReference(str(c), *TS.ref_mean_and_threshold(
        gal[gal_ids == c])) for c in range(16)]
    means = torch.from_numpy(np.stack([r.mean_vec for r in refs]))
    d = TS.distance_matrix(torch.from_numpy(probes), means).numpy()
    thres = np.array([r.threshold for r in refs], np.float32)
    same = d[np.arange(len(probes)), probe_ids]
    assert (same <= thres[probe_ids]).mean() >= 0.93
    cross = probe_ids[:, None] != np.arange(16)[None]
    assert (d > thres[None])[cross].mean() == 1.0
    for c in range(16):
        rows = probe_ids == c
        assert d[rows][:, np.arange(16) != c].min() - same[rows].max() > 0
