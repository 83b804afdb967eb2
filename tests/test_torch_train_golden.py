"""The port's golden tooling and trainers (``train/golden.py``,
``train/blazeface.py``, ``train/ssd.py``) against the JAX package's, on the
CPU.

- ``make_composite_dataset`` and ``make_crowded_dataset`` at a small n and
  size: every file and ``gt.txt`` byte-equal to the JAX package's (same
  ``random.Random`` draws; the port's JPEG encoder, ``host_resize`` and
  ``warp_affine`` are cv2's bit for bit);
- ``evaluate_golden`` and ``evaluate_holdout_ap`` of the golden yolov5s
  (``card_weights/yolov5s.pt``, the bridge's conversion of
  ``golden_yolov5s_ckpt``) against the JAX engine's on the checkpoint: the
  same verdict and counts, the predicted boxes within a pixel (as
  ``tests/test_torch_card_weights.py`` holds them) and the IoUs those boxes
  give under JAX's ``match_golden`` within 1e-6; AP50 / AP / AR within
  0.02;
- a second weight pour changes an engine's detections and a third restores
  them, f32 and bf16 (the caches keyed on tensor versions);
- a tiny ``train_golden`` run on the CPU (two chunks): finite chunk
  losses, the counter, the written ``.pt`` reloaded into a fresh engine
  giving the in-memory candidate's raw detections bit for bit; res10-ssd and
  ``ov-*`` (their trainers are ``test_torch_train_caffe_ov.py``'s) refuse
  an input size their graphs do not take;
- one BlazeFace-front and one ssd-resnet10 step against the JAX step from
  the same weights and batch: the loss within 1e-4 relative, and each
  tensor's change from the init within 1e-3 of JAX's change's largest value
  plus 8 ulps of the tensor's largest value (at least 0.05), as
  ``tests/test_torch_train_detection.py`` holds the yolov5 steps (both
  families' changes agree to within those ulps).
"""
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.train import golden as JG
from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine, read_state_dict)
from face_detection_and_recognition_tpu_torch.eval import card_weights as CW
from face_detection_and_recognition_tpu_torch.train import golden as G
from face_detection_and_recognition_tpu_torch.utils import weights as W
from tests.test_torch_train_detection import change_gaps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_golden_constants_and_images():
    np.testing.assert_array_equal(G.GOLDEN_BOXES_3, JG.GOLDEN_BOXES_3)
    for ours, theirs in ((G.GOLDEN_IMG, JG.GOLDEN_IMG),
                         (G.NEGATIVE_IMG, JG.NEGATIVE_IMG)):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    faces, jfaces = G.extract_golden_faces(), JG.extract_golden_faces()
    for f, j in zip(faces, jfaces):
        np.testing.assert_array_equal(f["patch"], j["patch"])
        np.testing.assert_array_equal(f["box"], j["box"])


@pytest.mark.parametrize("kind", ["composite", "crowded"])
def test_datasets_are_byte_equal_to_jax(tmp_path, kind):
    if kind == "composite":
        kw = dict(n_images=8, out_wh=(96, 96), seed=3, n_crowded=2)
        ours = G.make_composite_dataset(str(tmp_path / "p"), **kw)
        theirs = JG.make_composite_dataset(str(tmp_path / "j"), **kw)
    else:
        kw = dict(n_images=3, out_wh=(160, 128), seed=4)
        ours = G.make_crowded_dataset(str(tmp_path / "p"), **kw)
        theirs = JG.make_crowded_dataset(str(tmp_path / "j"), **kw)
    a, b = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(a) == sorted(b) and len(a) >= 4
    for name in a:
        assert a[name] == b[name], name
    with open(ours[0]) as f:
        assert "0 0 0 0 0 0\n" in f.read()
    assert os.path.relpath(ours[1], tmp_path / "p") == \
        os.path.relpath(theirs[1], tmp_path / "j")


def test_rotate_patch_equals_jax():
    rng = random.Random(5)
    face = G.extract_golden_faces()[2]
    for _ in range(6):
        ang = rng.uniform(-25, 25)
        a = G._rotate_patch(face["patch"], face["box"], ang)
        b = JG._rotate_patch(face["patch"], face["box"], ang)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_margin_gate_on_a_stub_engine(tmp_path):
    """The gate holds at det_thres +- margin, not just the centre: a 4th
    box at 0.48 fails the lower bar, a 3rd face at 0.52 the upper one."""
    from face_detection_and_recognition_tpu_torch.utils.native import \
        write_image_bgr

    pos, neg = str(tmp_path / "pos.jpg"), str(tmp_path / "neg.jpg")
    write_image_bgr(pos, np.full((540, 720, 3), 255, np.uint8))
    write_image_bgr(neg, np.zeros((540, 720, 3), np.uint8))

    class Stub:
        def __init__(self, confs):
            dup = G.GOLDEN_BOXES_3[0] + np.float32([4, 4, 4, 4])
            self.boxes = np.concatenate([G.GOLDEN_BOXES_3, dup[None]], 0)
            self.confs = np.asarray(confs, np.float32)

        def detect_image(self, img, det_thres):
            keep = (self.confs >= det_thres) if img.max() > 0 else \
                np.zeros_like(self.confs, bool)
            return type("Post", (), {"boxes": self.boxes[keep],
                                     "bbox_confs": self.confs[keep]})

    kw = dict(pos_img=pos, neg_img=neg, det_thres=0.5, margin=0.05)
    assert G.evaluate_golden(Stub([0.9, 0.9, 0.9, 0.1]), **kw)["ok"]
    r = G.evaluate_golden(Stub([0.9, 0.9, 0.9, 0.48]), **kw)
    assert r["n_pos"] == 3 and not r["ok"]
    assert not G.evaluate_golden(Stub([0.9, 0.9, 0.52, 0.1]), **kw)["ok"]


@pytest.fixture(scope="module")
def golden_engines():
    """The port's CPU engine on card_weights/yolov5s.pt and the JAX engine
    on golden_yolov5s_ckpt (f32-cast), both at input 640."""
    from face_detection_and_recognition_tpu.core.engine import (
        EngineConfig as JEngineConfig, FaceEngine as JFaceEngine)
    from face_detection_and_recognition_tpu.utils.checkpoint import \
        load_variables

    port = FaceEngine(EngineConfig(detector="yolov5s", det_thres=0.5),
                      device="cpu")
    port.load_weights(str(CW.CARD_WEIGHTS / "yolov5s.pt"))
    jeng = JFaceEngine(JEngineConfig(detector="yolov5s", det_thres=0.5))
    jeng.variables = _np(load_variables(os.path.join(DATA,
                                                     "golden_yolov5s_ckpt")))
    return port, jeng


def test_evaluate_golden_equals_jax(golden_engines):
    port, jeng = golden_engines
    ours = G.evaluate_golden(port, det_thres=0.6, margin=0.15)
    theirs = JG.evaluate_golden(jeng, det_thres=0.6, margin=0.15)
    assert ours["ok"] and theirs["ok"]
    for k in ("n_pos", "n_neg"):
        assert ours[k] == theirs[k]
    np.testing.assert_allclose(ours["pred_boxes"], theirs["pred_boxes"],
                               rtol=0, atol=1.0)
    np.testing.assert_allclose(
        ours["ious"], JG.match_golden(ours["pred_boxes"], JG.GOLDEN_BOXES_3),
        rtol=0, atol=1e-6)
    assert all(i >= 0.8 for i in ours["ious"])


def test_evaluate_holdout_ap_equals_jax(golden_engines, tmp_path):
    port, jeng = golden_engines
    ours = G.evaluate_holdout_ap(port, str(tmp_path / "p"), n_images=6)
    theirs = JG.evaluate_holdout_ap(jeng, str(tmp_path / "j"), n_images=6)
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    for k in ("AP50", "AP", "AR"):
        assert ours[k] == pytest.approx(theirs[k], abs=0.02), k
    assert ours["AP50"] > 0.3
    assert port.cfg.det_thres == 0.5       # restored after the sweep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_second_pour_changes_the_detections(dtype):
    """Pour the golden yolov5n, then a seeded net of another seed, then the
    golden one again into one engine: the detections follow each pour
    (no stale cache of the BatchNorm forms or the bf16 weights)."""
    eng = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5,
                                  dtype=dtype), device="cpu")
    golden = read_state_dict(str(CW.CARD_WEIGHTS / "yolov5n.pt"))
    other = {k: v.clone() for k, v in FaceEngine(
        EngineConfig(detector="yolov5n", seed=11), device="cpu")
        .net.state_dict().items()}
    img = CW.golden_images()[0]
    first = G.evaluate_golden(eng, variables=golden, det_thres=0.6,
                              margin=0.15)
    raw1 = eng.detect_raw(img)
    second = G.evaluate_golden(eng, variables=other, det_thres=0.6,
                               margin=0.15)
    raw2 = eng.detect_raw(img)
    third = G.evaluate_golden(eng, variables=golden, det_thres=0.6,
                              margin=0.15)
    assert first["ok"] and first["n_pos"] == 3
    assert not second["ok"]
    assert raw1.shape != raw2.shape or not np.array_equal(raw1, raw2)
    np.testing.assert_array_equal(eng.detect_raw(img), raw1)
    assert third["ious"] == first["ious"]
    assert first["top_conf"] > 0.6


def test_tiny_train_golden_reloads_its_checkpoint(tmp_path):
    ckpt = str(tmp_path / "golden.pt")
    lines = []
    r = G.train_golden(ckpt, str(tmp_path / "work"), arch="yolov5n",
                       input_size=64, batch_size=2, max_steps=4,
                       eval_every=2, n_images=4, seed=1, device="cpu",
                       log=lines.append)
    assert len(r["chunk_losses"]) == 2
    assert all(np.isfinite(r["chunk_losses"]))
    assert r["n_updates"] == 4 and r["steps"] == 4
    assert any("eval@2/ema" in s for s in lines)
    assert any("eval@4/live" in s for s in lines)
    assert r["reload_ok"] == r["ok"]
    mem = G.golden_engine("yolov5n", 64, device="cpu")
    mem.load_state_dict(r["candidate"])
    disk = G.golden_engine("yolov5n", 64, device="cpu")
    disk.load_weights(ckpt)
    img = CW.golden_images()[0]
    np.testing.assert_array_equal(disk.detect_raw(img), mem.detect_raw(img))
    # the graph trainers train their fixed input sizes only
    for arch in ("res10-ssd", "ov-0204", "ov-squeezenet-light"):
        with pytest.raises(ValueError, match="pass --size"):
            G.train_golden(ckpt, str(tmp_path / "w2"), arch=arch,
                           input_size=64, n_images=2, device="cpu")


def _batch(rng, size, b=2):
    x = rng.randint(0, 255, (b, size, size, 3)).astype(np.uint8)
    t = np.zeros((b, 4, 14), np.float32)
    t[..., 4:] = -1.0
    v = np.zeros((b, 4), bool)
    t[:, 0, :4] = [size * 0.45, size * 0.5, size * 0.3, size * 0.36]
    t[1, 1, :4] = [size * 0.2, size * 0.25, size * 0.12, size * 0.14]
    v[:, 0] = True
    v[1, 1] = True
    return x, t, v


@pytest.mark.parametrize("family", ["blazeface", "ssd"])
def test_family_step_matches_jax(family):
    from face_detection_and_recognition_tpu.train import blazeface as JB
    from face_detection_and_recognition_tpu.train import ssd as JS
    from face_detection_and_recognition_tpu_torch.train import blazeface as B
    from face_detection_and_recognition_tpu_torch.train import ssd as S

    sched = dict(max_targets=4, total_steps=0, ema_decay=0.99, ema_tau=5.0)
    if family == "blazeface":
        st = JB.create_blaze_train_state(JB.BlazeTrainConfig(**sched),
                                         jax.random.PRNGKey(0))
        step = jax.jit(JB.make_blaze_train_step_ema(st))
        init = W.blazeface_state_dict(_np({"params": st["params"]}), False)
        state = B.create_blaze_train_state(B.BlazeTrainConfig(**sched),
                                           device="cpu")
        pstep = B.make_blaze_train_step_ema(state)
        size = 128

        def after(p, bs):
            return W.blazeface_state_dict(_np({"params": p}), False)
    else:
        st = JS.create_ssd_train_state(JS.SSDTrainConfig(**sched),
                                       jax.random.PRNGKey(0))
        step = jax.jit(JS.make_ssd_train_step_ema(st))
        init = W.ssd_state_dict(_np({"params": st["params"],
                                     "batch_stats": st["batch_stats"]}),
                                "resnet10")
        state = S.create_ssd_train_state(S.SSDTrainConfig(**sched),
                                         device="cpu")
        pstep = S.make_ssd_train_step_ema(state)
        size = 300

        def after(p, bs):
            return W.ssd_state_dict(_np({"params": p, "batch_stats": bs}),
                                    "resnet10")
    state["net"].load_state_dict(init)
    state["ema"].load_state_dict(init)
    x, t, v = _batch(np.random.RandomState(6), size)
    p, bs, _, _, n, loss, _ = step(st["params"], st["batch_stats"],
                                   st["opt_state"], st["ema_params"],
                                   jnp.int32(0), jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(v))
    ploss, metrics = pstep(*map(torch.from_numpy, (x, t, v)))
    assert float(ploss) == pytest.approx(float(loss), rel=1e-4)
    assert int(state["n_updates"]) == int(n) == 1
    assert float(metrics["box"]) > 0
    assert not change_gaps(state["net"].state_dict(), after(p, bs), init,
                           1e-3)
