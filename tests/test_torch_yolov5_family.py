"""The rest of the port's yolov5 family against the JAX package (CPU): the
four-level P6 graphs (yolov5s6/m6/l6, yolov5n6), yolov5m and yolov5l, the
official multiclass heads (yolov5s-official, yolov5n-official) with
``multiclass_nms``, the registry entries, the engine and its consumers with
no landmark columns, and the golden gates of yolov5n6, the crowded yolov5s6
at 960 and the official yolov5n, run through the port."""
import contextlib
import io
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
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.models import yolov5_face as JY
from face_detection_and_recognition_tpu.ops import nms as JN
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu.utils.weights import \
    convert_yolov5_face
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.models import yolov5_face as TY
from face_detection_and_recognition_tpu_torch.models.layers import \
    make_divisible_torch
from face_detection_and_recognition_tpu_torch.ops import nms as TN
from face_detection_and_recognition_tpu_torch.ops.geometry import \
    rect_letterbox_size
from face_detection_and_recognition_tpu_torch.utils.weights import \
    yolov5_face_state_dict

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
N6_CKPT = "golden_yolov5n6_ckpt"
OFFICIAL_CKPT = "golden_yolov5n_official_ckpt"
S6_CROWDED_CKPT = "golden_yolov5s6_crowded_ckpt"
FAMILY = ("yolov5s", "yolov5m", "yolov5l", "yolov5n", "yolov5n-0.5",
          "yolov5s6", "yolov5m6", "yolov5l6", "yolov5n6", "yolov5s-official",
          "yolov5n-official")


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
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def golden():
    """The golden checkpoints this file reads, once: {name: variables}."""
    return {name: _load(name) for name in (N6_CKPT, OFFICIAL_CKPT)}


def _letterboxed(size):
    """The golden frame letterboxed to ``size`` by the JAX recipe."""
    import dataclasses

    img = cv2.imread(IMG)
    spec = dataclasses.replace(JP.YOLOV5_FACE, size=size)
    return np.array(JP.apply_preprocess_batch(jnp.asarray(img[None]), spec))


# ---------------- registry and graph tables ----------------


def test_registry_matches_the_jax_family():
    """Every yolov5 name of the JAX registry, with its input size, rect
    stride and landmark columns; BlazeFace's landmark columns too."""
    for name in FAMILY + ("blazeface-front", "blazeface-back"):
        j, t = JR.get(name), TR.get(name)
        assert (t.input_size, t.rect_stride, t.n_landmark_cols) == \
            (j.input_size, j.rect_stride, j.n_landmark_cols), name
    assert [n for n in TR.available() if n.startswith("yolov5")] == \
        [n for n in JR.available() if n.startswith("yolov5")]


def test_arch_tables_match_the_jax_package():
    """The graph tables, multiples, anchors and strides of all nine face
    archs, and the official anchors; the widths and depths they give, 768
    x 0.50 of yolov5s6 included."""
    assert set(TY.ARCHS) == set(JY.ARCHS)
    for arch, spec in TY.ARCHS.items():
        ref = JY.ARCHS[arch]
        assert spec["graph"] == ref["graph"], arch
        for key in ("gd", "gw", "anchors", "strides"):
            assert spec[key] == ref[key], (arch, key)
    assert TY.OFFICIAL_ANCHORS == JY.OFFICIAL_ANCHORS
    assert TY.FACE_ANCHORS_P6 == JY.FACE_ANCHORS_P6
    widths = {arch: [make_divisible_torch(c * TY.ARCHS[arch]["gw"], 8)
                     for c in (256, 512, 768, 1024)]
              for arch in ("yolov5s6", "yolov5m6", "yolov5l6")}
    assert widths == {"yolov5s6": [128, 256, 384, 512],
                      "yolov5m6": [192, 384, 576, 768],
                      "yolov5l6": [256, 512, 768, 1024]}
    assert [TY.graph_depth(n, 0.33) for n in (1, 3, 9)] == [1, 1, 3]
    assert [TY.graph_depth(n, 0.67) for n in (1, 3, 9)] == [1, 2, 6]


def test_rect_letterbox_at_stride_64():
    """A 576 x 1024 frame goes to 640 x 384 at stride 64 (and 32), and
    every P6 level's grid divides it."""
    assert rect_letterbox_size((576, 1024), (640, 640), 64) == (640, 384)
    assert rect_letterbox_size((576, 1024), (640, 640), 32) == (640, 384)
    assert rect_letterbox_size((540, 720), (640, 640), 64) == (640, 512)
    for s in TY.ARCHS["yolov5s6"]["strides"]:
        assert 640 % s == 0 and 384 % s == 0


# ---------------- raw maps through the weight bridge ----------------


def _check_maps(got, ref, scale=1.0):
    """rtol 1e-4, atol 1e-4 x ``scale``: f32 convolutions summed in another
    order through the graph leave an error that grows with the
    activations' size."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4 * scale)


def _port_net(arch, variables, nc=1, landmarks=True):
    net = TY.YoloV5FaceNet(arch, nc, with_landmarks=landmarks).eval()
    net.load_state_dict(yolov5_face_state_dict(variables, arch))
    return net.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("arch,ckpt,nc,landmarks", [
    ("yolov5n6", N6_CKPT, 1, True),
    ("yolov5n", OFFICIAL_CKPT, 80, False),
    ("yolov5s6", S6_CROWDED_CKPT, 1, True),
], ids=["n6", "n-official", "s6-crowded"])
def test_checkpoint_raw_maps_equal_flax(arch, ckpt, nc, landmarks):
    """The committed checkpoints' raw maps, the four P6 levels and the
    official head's 85 columns, at 128 x 128: flax ``apply`` against the
    bridged port net."""
    variables = _load(ckpt)
    x = _letterboxed((128, 128))
    ref = JY.YoloV5FaceNet(arch=arch, nc=nc,
                           with_landmarks=landmarks).apply(variables, x)
    with torch.inference_mode():
        got = _port_net(arch, variables, nc, landmarks)(torch.from_numpy(x))
    assert len(got) == len(TY.ARCHS[arch]["strides"])
    assert got[0].shape[-1] == nc + 5 + (10 if landmarks else 0)
    _check_maps(got, ref)


@pytest.mark.parametrize("arch", ["yolov5m", "yolov5l", "yolov5m6",
                                  "yolov5l6"])
def test_graph_raw_maps_equal_flax(arch):
    """The graphs without a committed checkpoint, at 64 x 64: the port's
    seeded weights (BN statistics drawn from a batch, so activations keep
    their scale; flax's own init fades them to ~1e-9) go to flax through
    the JAX package's torch importer, come back through the bridge
    unchanged, and give the same maps."""
    net = TY.YoloV5FaceNet(arch).init_random_(
        torch.Generator().manual_seed(5))
    sd = {k: v for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = jax.tree_util.tree_map(
        np.asarray, convert_yolov5_face({k: v.numpy() for k, v in sd.items()},
                                        arch))
    back = yolov5_face_state_dict(variables, arch)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    ref = JY.YoloV5FaceNet(arch=arch).apply(variables, x)
    with torch.inference_mode():
        got = net.to(memory_format=torch.channels_last)(torch.from_numpy(x))
    # the seeded nets' maps reach a few units, where the checkpoints' stay
    # near 1: the absolute tolerance is 1e-4 of the largest map value
    peak = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    assert peak > 0.5
    _check_maps(got, ref, scale=max(1.0, peak))


# ---------------- multiclass NMS and the official decode ----------------


def _class_rows(rng, k=192, nc=6):
    """Boxes in clusters across a few classes, scores with saturated ties
    at 1.0, invalid rows."""
    centers = rng.uniform(20, 600, (12, 2))
    c = centers[rng.randint(0, 12, k)] + rng.normal(0, 4, (k, 2))
    wh = rng.uniform(20, 60, (k, 2))
    boxes = np.concatenate([c, c + wh], -1).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, k).astype(np.float32)
    scores[::7] = 1.0
    classes = rng.randint(0, nc, k).astype(np.int32)
    classes[::11] = 79  # shifted to ~3.2e5
    valid = rng.uniform(size=k) > 0.15
    return boxes, scores, classes, valid


@pytest.mark.parametrize("agnostic", [False, True])
def test_multiclass_nms_equals_jax(agnostic):
    """Equal keep masks in input order, and the output rows within 1e-5,
    one frame and a batch of two."""
    rng = np.random.RandomState(31)
    frames = [_class_rows(rng) for _ in range(2)]
    for boxes, scores, classes, valid in frames:
        rd, rv, rk = JN.multiclass_nms(boxes, scores, classes, valid, 0.5,
                                       64, agnostic=agnostic)
        gd, gv, gk = TN.multiclass_nms(
            *(torch.from_numpy(a) for a in (boxes, scores, classes, valid)),
            0.5, 64, agnostic=agnostic)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        assert 5 < int(rv.sum()) < int(valid.sum())
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=0,
                                   atol=1e-5)
    batch = [torch.from_numpy(np.stack(a)) for a in zip(*frames)]
    bd, bv, bk = TN.multiclass_nms(*batch, 0.5, 64, agnostic=agnostic)
    for i, (boxes, scores, classes, valid) in enumerate(frames):
        _, _, rk = JN.multiclass_nms(boxes, scores, classes, valid, 0.5, 64,
                                     agnostic=agnostic)
        np.testing.assert_array_equal(bk[i].numpy(), np.asarray(rk))


def _official_maps(rng, b=2, h=128, w=192, nc=80):
    """Raw official maps [B, 3, h/s, w/s, 5 + nc]; every 5th objectness
    logit saturated (sigmoid ties at 1.0), a few class logits saturated
    too (ties in the best class)."""
    maps = []
    for s in (8, 16, 32):
        m = rng.normal(0, 2, (b, 3, h // s, w // s, 5 + nc)).astype(np.float32)
        flat = m.reshape(b, -1, 5 + nc)
        flat[:, ::5, 4] = 25.0
        flat[:, ::9, 5:8] = 30.0
        maps.append(m)
    return maps


@pytest.mark.parametrize("hw", [(128, 192), (128, 128)])
def test_official_detect_maps_equals_jax(hw):
    """The candidates-first official path against the JAX package's on the
    same raw maps: the same kept rows in the same order (ties included),
    classes equal, boxes and confidences within 1e-5 relative (pixel
    coordinates up to ~1e3 from sigmoids that may differ by an ulp)."""
    h, w = hw
    maps = _official_maps(np.random.RandomState(h + w), h=h, w=w)
    cfg = dict(nc=80, conf_thres=0.3, iou_thres=0.5, max_candidates=256,
               max_det=64, input_size=(w, h))
    rd, rv = JY.yolov5_official_detect_maps(
        maps, JY.OFFICIAL_ANCHORS, (8, 16, 32), JY.YoloV5FaceConfig(**cfg))
    gd, gv = TY.yolov5_official_detect_maps(
        [torch.from_numpy(m) for m in maps], TY.OFFICIAL_ANCHORS,
        (8, 16, 32), TY.YoloV5FaceConfig(**cfg))
    rd, rv = np.asarray(rd), np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert rv.sum() > 10
    np.testing.assert_array_equal(gd.numpy()[rv][:, 5], rd[rv][:, 5])
    np.testing.assert_allclose(gd.numpy()[rv], rd[rv], rtol=1e-5, atol=1e-5)
    # the full-grid plain reference: decode every row, then the same stage
    pred = TY.decode_heads([torch.from_numpy(m) for m in maps],
                           TY.OFFICIAL_ANCHORS, (8, 16, 32), landmarks=False)
    fd, fv = TY.yolov5_official_postprocess(pred, TY.YoloV5FaceConfig(**cfg))
    np.testing.assert_array_equal(fv.numpy(), rv)
    np.testing.assert_allclose(fd.numpy()[rv], rd[rv], rtol=1e-5, atol=1e-5)
    jpred = JY.decode_heads(maps, JY.OFFICIAL_ANCHORS, (8, 16, 32), nc=80,
                            landmarks=False)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-5,
                               atol=1e-4)


def test_p6_face_detect_maps_equals_jax():
    """The face path at four levels (stride 64, P6 anchors), rect 128 x
    256: the same kept rows and order, as for the P5 layout in
    tests/test_torch_yolov5.py."""
    rng = np.random.RandomState(64)
    maps = []
    for s in (8, 16, 32, 64):
        m = rng.normal(0, 2, (2, 3, 128 // s, 256 // s, 16)).astype(
            np.float32)
        m.reshape(2, -1, 16)[:, ::5, 4] = 25.0
        maps.append(m)
    kw = dict(max_candidates=256, max_det=64, input_size=(256, 128))
    gd, gv = TY.yolov5_face_detect_maps(
        [torch.from_numpy(m) for m in maps], TY.FACE_ANCHORS_P6,
        (8, 16, 32, 64), TY.YoloV5FaceConfig(**kw))
    rd, rv = JY.yolov5_face_detect_maps(maps, JY.FACE_ANCHORS_P6,
                                        (8, 16, 32, 64),
                                        JY.YoloV5FaceConfig(**kw))
    rd, rv = np.asarray(rd), np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert rv.sum() > 10
    np.testing.assert_allclose(gd.numpy()[rv], rd[rv], rtol=1e-5, atol=1e-3)


# ---------------- the engine, with and without landmarks ----------------


@pytest.fixture(scope="module")
def engines(golden):
    """(JAX, port) engines with the golden weights: yolov5n6 and
    yolov5n-official (nc 80), square and rect letterbox."""
    out = {}
    for det, ckpt, arch, ov in (("yolov5n6", N6_CKPT, "yolov5n6", {}),
                                ("yolov5n-official", OFFICIAL_CKPT, "yolov5n",
                                 {"nc": 80})):
        v = golden[ckpt]
        sd = yolov5_face_state_dict(v, arch)
        for rect in (False, True):
            kw = dict(detector=det, rect=rect, detector_overrides=dict(ov))
            jeng = JFaceEngine(JEngineConfig(**kw))
            jeng.variables = v
            teng = FaceEngine(EngineConfig(**kw), device="cpu")
            teng.load_state_dict(sd)
            out[det, rect] = (jeng, teng)
    return out


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("det", ["yolov5n6", "yolov5n-official"])
def test_engine_matches_jax_engine(engines, det, rect):
    """The golden frame through both engines: the same faces, boxes within
    1 px, scores within 1e-4, landmarks as the JAX engine gives them (none
    for the official head)."""
    jeng, teng = engines[det, rect]
    img = cv2.imread(IMG)
    ref = jeng.detect_image(img, det_thres=0.3)
    got = teng.detect_image(img, det_thres=0.3)
    assert len(got) == len(ref) >= 3
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.bbox_confs, ref.bbox_confs, atol=1e-4,
                               rtol=0)
    if det.endswith("official"):
        assert got.bbox_lmarks is None and ref.bbox_lmarks is None
    else:
        np.testing.assert_allclose(got.bbox_lmarks, ref.bbox_lmarks,
                                   atol=1.0, rtol=0)
    raw, jraw = teng.detect_raw(img), np.asarray(jeng.detect_raw(img))
    assert raw.shape[1] == jraw.shape[1] == 4 + teng.spec.n_landmark_cols + 1


def test_official_detections_have_no_landmark_columns(engines):
    """The 5-column contract through ``Detections``, the batch path and
    the ensemble's crops."""
    teng = engines["yolov5n-official", False][1]
    img = cv2.imread(IMG)
    det = teng.detect_batch(np.stack([img, img]), det_thres=0.3)
    assert tuple(det.lmarks.shape) == (2, teng.cfg.max_det, 0)
    res = teng.detect_embed_classify_batch(img[None], det_thres=0.3)
    assert int(res.det.valid.sum()) >= 3
    assert tuple(res.crops.shape[2:]) == (112, 112, 3)


def test_official_cli_and_service_on_cpu(golden, tmp_path):
    """The CLI and FaceService with the official head: the CLI prints the
    engine's faces and draws them without landmarks; the service answers
    the 5-column detections as boxes and confidences."""
    from face_detection_and_recognition_tpu_torch.cli.detect_face import \
        main
    from face_detection_and_recognition_tpu_torch.serving import (
        FaceService, ServiceConfig)

    ckpt = str(tmp_path / "official.pt")
    torch.save(yolov5_face_state_dict(golden[OFFICIAL_CKPT], "yolov5n"), ckpt)
    eng = FaceEngine(EngineConfig(detector="yolov5n-official", det_thres=0.5,
                                  detector_overrides={"nc": 80}),
                     device="cpu")
    eng.load_weights(ckpt)
    ref = eng.detect_image(cv2.imread(IMG))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["-i", IMG, "--md", "yolov5n-official", "-d", "cpu",
                   "--ckpt", ckpt, "--dt", "0.5", "--no-display", "-o",
                   str(tmp_path / "out.jpg")])
    assert rc == 0
    lines = out.getvalue().splitlines()
    # the CLI's engine is built without the nc override: 80 is the
    # official head's default
    assert lines[0] == f"{len(ref)} face(s)" and len(ref) == 3
    assert os.path.getsize(tmp_path / "out.jpg") > 0
    svc = FaceService(ServiceConfig(detector="yolov5n-official", ckpt=ckpt,
                                    with_embedder=False,
                                    with_age_gender=False, det_thres=0.5,
                                    device="cpu"))
    try:
        faces, bboxes, confs = svc.detect_faces(cv2.imread(IMG))
        assert faces.shape == (3, 3, 112, 112)
        np.testing.assert_allclose(np.sort(bboxes, 0), np.sort(ref.boxes, 0),
                                   atol=1.0)
        assert confs.shape == (3, 1)
    finally:
        svc.close()


# ---------------- the golden gates, through the port ----------------


def _gate(eng, **kw):
    r = evaluate_golden(eng, det_thres=0.6, margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3, f"expected 3 golden faces, got {r['n_pos']}"
    assert r["n_neg"] == 0, f"0-face image produced {r['n_neg']} detections"
    return r


def test_port_yolov5n6_passes_golden_gate(golden):
    """The gate of tests/test_golden_accuracy.py for golden_yolov5n6_ckpt."""
    eng = FaceEngine(EngineConfig(detector="yolov5n6", det_thres=0.5),
                     device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(golden[N6_CKPT], "yolov5n6"))
    r = _gate(eng)
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]


def test_port_s6_crowded_passes_plain_golden_gate():
    """The plain gate of tests/test_crowded_accuracy.py for
    golden_yolov5s6_crowded_ckpt, served at input 960."""
    eng = FaceEngine(EngineConfig(
        detector="yolov5s6", det_thres=0.5,
        detector_overrides={"input_size": (960, 960)}), device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(_load(S6_CROWDED_CKPT),
                                               "yolov5s6"))
    assert eng.input_size == (960, 960)
    _gate(eng)


def test_port_official_head_passes_golden_gate(golden):
    """The gate of tests/test_golden_accuracy.py for
    golden_yolov5n_official_ckpt, nc 80."""
    eng = FaceEngine(EngineConfig(detector="yolov5n-official", det_thres=0.5,
                                  detector_overrides={"nc": 80}),
                     device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(golden[OFFICIAL_CKPT],
                                               "yolov5n"))
    r = _gate(eng)
    assert all(iou >= 0.65 for iou in r["ious"]), r["ious"]
