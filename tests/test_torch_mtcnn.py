"""The port's MTCNN cascade against the JAX package (CPU): P/R/O-Net on the
same weights and inputs, the whole cascade on two 120x160 frames (seeded
weights with every stage full, and the golden weights; rows within 1e-4
after normalisation, equal counts), the golden gate of
``tests/test_golden_accuracy.py:432`` run through the port, a frozen
GraphDef fixture poured by ``convert_mtcnn_graphdef`` in both packages, the
empty pyramid, the staged ``FaceService.detect_faces`` against the JAX
service, and ``extract_faces`` taking its staged branch."""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models import mtcnn as JM
from face_detection_and_recognition_tpu.serving.service import \
    FaceService as JFaceService
from face_detection_and_recognition_tpu.serving.service import \
    ServiceConfig as JServiceConfig
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu.utils import weights as JW
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import mtcnn as TM
from face_detection_and_recognition_tpu_torch.serving import (FaceService,
                                                              ServiceConfig)
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
CKPT = os.path.join(DATA, "golden_mtcnn_ckpt")
TOL = 1e-4
FULL = (0.0, 0.0, 0.0)  # every stage full: 128 a level, 256, then 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_cascade():
    """One JAX cascade with every stage full, and its seeded variables as
    numpy; its compiled batch program serves any weights."""
    cascade = JM.MTCNN(JM.MTCNNConfig(thresholds=FULL),
                       rng=jax.random.PRNGKey(5))
    return cascade, jax.tree_util.tree_map(np.asarray, cascade.variables())


@pytest.fixture(scope="module")
def golden():
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(CKPT))


def _port(variables, thresholds=FULL):
    net = TM.MTCNN(TM.MTCNNConfig(thresholds=thresholds))
    net.load_state_dict(TW.mtcnn_state_dict(variables))
    return net.eval()


def _frames():
    """Two 120x160 frames: a crop of the golden image holding a face, and
    seeded noise."""
    img = cv2.imread(IMG)
    noise = np.random.RandomState(2).randint(0, 256, (120, 160, 3), np.uint8)
    return np.stack([img[195:315, 250:410], noise])


def _same_dets(got, got_valid, ref, ref_valid):
    ref, ref_valid = np.asarray(ref), np.asarray(ref_valid)
    np.testing.assert_array_equal(got_valid, ref_valid)
    np.testing.assert_allclose(got[got_valid], ref[ref_valid], rtol=0,
                               atol=TOL)


def test_nets_match_jax(jax_cascade):
    cascade, variables = jax_cascade
    port = _port(variables)
    rng = np.random.RandomState(3)
    for name, shape in (("pnet", (2, 30, 41, 3)), ("rnet", (6, 24, 24, 3)),
                        ("onet", (6, 48, 48, 3))):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        ref = jax.jit(getattr(cascade, name).apply)(variables[name],
                                                    jnp.asarray(x))
        with torch.no_grad():
            got = getattr(port, name)(torch.from_numpy(x).permute(0, 3, 1, 2))
        if name == "pnet":  # NCHW maps -> NHWC
            got = [g.permute(0, 2, 3, 1) for g in got]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("weights", ["seeded", "golden"])
def test_cascade_matches_jax(jax_cascade, golden, weights):
    """The whole cascade with every stage full (thresholds 0): 128
    proposals a level, the global NMS, R-Net's 256 crops and O-Net's 128,
    on a face crop and a noise frame."""
    cascade, seeded = jax_cascade
    variables = seeded if weights == "seeded" else golden
    frames = _frames()
    ref, ref_valid = cascade.detect_batch_fn(120, 160)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(frames))
    trace = {}
    with torch.no_grad():
        got, got_valid = _port(variables).detect(torch.from_numpy(frames),
                                                 trace)
    _same_dets(got.numpy(), got_valid.numpy(), ref, ref_valid)
    assert got_valid.numpy().sum() > 4
    # every stage's block: 256 after P-Net, 128 after R-Net
    assert trace["pnet"]["valid"].shape == (2, 256)
    assert trace["rnet"]["valid"].shape == (2, 128)


def test_golden_gate_through_the_port(golden):
    """tests/test_golden_accuracy.py:432 on the port's engine: 3 faces at
    IoU >= 0.8, none on the negative image."""
    eng = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5),
                     device="cpu")
    eng.load_state_dict(TW.mtcnn_state_dict(golden))
    r = evaluate_golden(eng)
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]
    with pytest.raises(NotImplementedError, match="native-resolution"):
        eng.detect_embed_classify_batch(np.zeros((1, 64, 64, 3), np.uint8))


def _graph_consts(variables, rng, shuffle=False):
    """The cascade's weights as a blaueck-style frozen graph's consts."""
    consts = []
    for stage in ("pnet", "rnet", "onet"):
        stage_consts = []
        for path, leaf, shape, _ in JW._walk_slots(
                variables[stage]["params"], {}):
            kind = {"kernel": "weights", "bias": "biases",
                    "alpha": "alpha"}[leaf]
            stage_consts.append(JMF.GraphConst(
                f"{stage}/{'/'.join(path)}/{kind}",
                rng.randn(*shape).astype(np.float32) * 0.1))
        if shuffle:  # serialization order unlike execution order
            stage_consts = stage_consts[::-1]
        consts += stage_consts
    return consts + [JMF.GraphConst("pnet/shape", np.arange(4, dtype=np.int32))]


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "reversed"])
def test_graphdef_pours_like_jax(jax_cascade, tmp_path, shuffle):
    """A .pb written by the JAX package's writer, read by both packages'
    readers and poured by both ``convert_mtcnn_graphdef``s: the same
    tensor in every slot; the engine's ``load_weights`` reads it too."""
    _, variables = jax_cascade
    consts = _graph_consts(variables, np.random.RandomState(4), shuffle)
    data = JMF.write_graphdef(consts)
    from face_detection_and_recognition_tpu_torch.utils import \
        model_formats as TMF

    ref = JW.convert_mtcnn_graphdef(JMF.read_tf_graphdef(data), variables)
    got = TW.convert_mtcnn_graphdef(TMF.read_tf_graphdef(data), _port(variables))
    want = TW.mtcnn_state_dict(ref)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    path = tmp_path / "mtcnn.pb"
    path.write_bytes(data)
    eng = FaceEngine(EngineConfig(detector="mtcnn"), device="cpu")
    eng.load_weights(str(path))
    for k, v in eng.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    with pytest.raises(ValueError, match="rnet"):
        TW.convert_mtcnn_graphdef([c for c in consts
                                   if c.name.startswith("pnet")],
                                  _port(variables))


def test_empty_pyramid_and_empty_stages(jax_cascade):
    """A frame too small for one 12 px window at min_size 40 has no
    pyramid level: zero rows, no error, as in the JAX package; seeded
    weights at the default thresholds leave every stage empty."""
    cascade, variables = jax_cascade
    assert TM.pyramid_scales(30, 50, 40, 0.7) == \
        JM.pyramid_scales(30, 50, 40, 0.7) == []
    small = np.zeros((2, 30, 50, 3), np.uint8)
    with torch.no_grad():
        dets, valid = _port(variables).detect(torch.from_numpy(small))
    assert dets.shape == (2, 64, 15) and not valid.any()
    eng = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.0,
                                  bbox_area_thres=0.0), device="cpu")
    eng.load_state_dict(TW.mtcnn_state_dict(variables))
    assert len(eng.detect_image(small[0]).boxes) == 0
    assert eng.detect_raw(small[0]).shape == (0, 15)
    frames = torch.from_numpy(_frames())
    with torch.no_grad():
        _, valid = _port(variables, (0.6, 0.7, 0.8)).detect(frames)
    assert not valid.any()


def test_staged_detect_faces_matches_the_jax_service(golden):
    """``FaceService.detect_faces`` with mtcnn goes staged (detect_image,
    then 112x112 crops clamped to the frame by B3) in both packages: the
    same faces, boxes and confidences; and the service's other entry
    points take the staged path too."""
    frame = _frames()[0]
    jsvc = JFaceService(JServiceConfig(detector="mtcnn", ckpt=CKPT,
                                       with_embedder=False,
                                       with_age_gender=False))
    svc = FaceService(ServiceConfig(detector="mtcnn", with_embedder=False,
                                    with_age_gender=False, device="cpu"))
    try:
        svc.engine.load_state_dict(TW.mtcnn_state_dict(golden))
        ref = jsvc.detect_faces(frame, det_thres=0.5)
        got = svc.detect_faces(frame, det_thres=0.5)
        assert got[0].shape == ref[0].shape and got[0].shape[0] >= 1
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0,
                                   atol=1e-3)
        svc.warmup(shapes=((120, 160),))
        out = svc.detect_embed_classify(frame)
        np.testing.assert_array_equal(out["bboxes"], got[1])
        assert out["labels"] == [] and out["embeddings"].shape == (
            len(got[1]), 512)
    finally:
        svc.close()


def test_extract_faces_takes_the_staged_branch(golden, tmp_path):
    """``extract_faces_from_dataset`` with mtcnn detects through
    ``detect_batch`` (no fused ensemble) and writes its crops."""
    from face_detection_and_recognition_tpu_torch.pipelines.extract_faces \
        import extract_faces_from_dataset
    from face_detection_and_recognition_tpu_torch.utils.native import \
        write_image_bgr

    src = tmp_path / "in" / "person"
    src.mkdir(parents=True)
    write_image_bgr(str(src / "a.jpg"), _frames()[0])
    eng = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5,
                                  embedder="mobile_facenet"), device="cpu")
    eng.load_state_dict(TW.mtcnn_state_dict(golden))
    calls = []
    fused = eng.detect_embed_classify_batch
    eng.detect_embed_classify_batch = lambda *a, **k: calls.append(1) or \
        fused(*a, **k)
    stats = extract_faces_from_dataset(eng, str(tmp_path / "in"),
                                       str(tmp_path / "out"), num_workers=1,
                                       block_size=2)
    assert not calls and not stats.failed
    assert list((tmp_path / "out").rglob("*.jpg"))
