"""The port's COCO/WIDER evaluation against the JAX package (CPU).

The cases of ``tests/test_eval.py`` through the port's
``eval/coco_eval.py``, each held to the JAX package's metrics on the same
inputs (the metrics are the same numpy on both sides: equal); the batched
WIDER runner on a detector holding the same weights in both packages; and
``cli/eval_wider.py`` with ``golden_yolov5n_ckpt`` (written as a ``.pt``)
on the 12-image composite set of
``tests/test_golden_accuracy.py:461-467``: AP50 >= 0.60, each metric
within 0.01 of the JAX CLI's on the same file.
"""
import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.eval import coco_eval as J
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.eval import coco_eval as T

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the Tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


def _same(gts, dets, **kw):
    """The port's metrics on (gts, dets), after checking that they equal
    the JAX package's."""
    got = T.evaluate_detections(gts, dets, **kw)
    assert got == J.evaluate_detections(gts, dets, **kw)
    return got


def test_perfect_detections_give_ap1():
    gts = {0: np.array([[10, 10, 20, 20], [50, 50, 30, 30]], float)}
    dets = {0: np.array([[10, 10, 20, 20, 0.9], [50, 50, 30, 30, 0.8]],
                        float)}
    m = _same(gts, dets)
    assert m["AP"] == pytest.approx(1.0, abs=1e-6)
    assert m["AP50"] == pytest.approx(1.0, abs=1e-6)
    assert m["AR"] == pytest.approx(1.0, abs=1e-6)


def test_no_detections_give_zero():
    m = _same({0: np.array([[10, 10, 20, 20]], float)}, {})
    assert m["AP"] == 0.0 and m["AR"] == 0.0


def test_false_positives_reduce_ap():
    gts = {0: np.array([[10, 10, 20, 20]], float)}
    good = {0: np.array([[10, 10, 20, 20, 0.9]], float)}
    with_fp = {0: np.array([[10, 10, 20, 20, 0.5],
                            [100, 100, 20, 20, 0.9]], float)}
    assert _same(gts, with_fp)["AP"] < _same(gts, good)["AP"]


def test_loose_boxes_pass_ap50_not_ap75():
    m = _same({0: np.array([[0, 0, 100, 100]], float)},
              {0: np.array([[0, 0, 80, 80, 0.9]], float)})  # IoU 0.64
    assert m["AP50"] > 0.9
    assert m["AP75"] == 0.0
    assert 0 < m["AP"] < m["AP50"]


def test_duplicate_detections_penalized():
    gts = {0: np.array([[10, 10, 20, 20], [100, 100, 20, 20]], float)}
    dup = {0: np.array([[10, 10, 20, 20, 0.9],
                        [11, 11, 20, 20, 0.8],
                        [100, 100, 20, 20, 0.7]], float)}
    assert 0.5 < _same(gts, dup)["AP50"] < 1.0


def test_matcher_tie_breaking_matches_classic_loop():
    g = np.array([[10, 10, 20, 20], [10, 10, 20, 20]], float)
    d = np.array([[10, 10, 20, 20, 0.9], [10, 10, 20, 20, 0.8]], float)
    out = _same({0: g}, {0: d})
    assert out["AP"] == pytest.approx(1.0, abs=1e-6)
    assert out["AR"] == pytest.approx(1.0, abs=1e-6)


def test_parse_wider_annotations(tmp_path):
    ann = tmp_path / "gt.txt"
    ann.write_text(
        "0--Parade/0_Parade_1.jpg\n2\n10 20 30 40 0 0 0 0 0 0\n"
        "50 60 70 80 0 0 0 0 0 0\n"
        "0--Parade/0_Parade_2.jpg\n0\n0 0 0 0 0 0 0 0 0 0\n")
    gt = T.parse_wider_annotations(str(ann))
    ref = J.parse_wider_annotations(str(ann))
    assert list(gt) == list(ref)
    for k in gt:
        np.testing.assert_array_equal(gt[k], ref[k])
    np.testing.assert_array_equal(gt["0--Parade/0_Parade_1.jpg"],
                                  [[10, 20, 30, 40], [50, 60, 70, 80]])
    assert gt["0--Parade/0_Parade_2.jpg"].shape == (0, 4)


@pytest.mark.parametrize("n_images", [1, 400], ids=["scene", "wider-scale"])
def test_random_scenes_match_jax(n_images):
    """Random scenes (tests/test_eval.py's matcher and WIDER-scale cases):
    detections jittered around the ground truth, scores at random; one
    image 20 times, and 400 images at once."""
    rng = np.random.RandomState(7 + n_images)
    for _ in range(20 if n_images == 1 else 1):
        gts, dets = {}, {}
        for i in range(n_images):
            m, n = rng.randint(1, 22), rng.randint(1, 50)
            g = np.concatenate([rng.uniform(0, 900, (m, 2)),
                                rng.uniform(8, 120, (m, 2))], axis=1)
            d = g[rng.randint(0, m, n)] + rng.uniform(-10, 10, (n, 4))
            d[:, 2:] = np.abs(d[:, 2:]) + 2
            gts[i] = g
            dets[i] = np.concatenate([d, rng.uniform(0, 1, (n, 1))], axis=1)
        out = _same(gts, dets)
        assert 0.0 < out["AP"] <= 1.0


def test_unletterbox_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(-20, 660, (50, 4))
    for orig in ((1024, 576), (300, 700), (640, 640)):
        np.testing.assert_array_equal(
            T._unletterbox(boxes, (640, 640), orig),
            J._unletterbox(boxes, (640, 640), orig))


def test_unreadable_images_count_as_missed_gt(tmp_path):
    d = tmp_path / "imgs" / "0--Parade"
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "ok.jpg"), np.zeros((64, 64, 3), np.uint8))
    (d / "corrupt.jpg").write_bytes(b"not an image")
    ann = tmp_path / "gt.txt"
    ann.write_text(
        "0--Parade/ok.jpg\n1\n10 10 20 20 0 0 0 0 0 0\n"
        "0--Parade/corrupt.jpg\n1\n10 10 20 20 0 0 0 0 0 0\n")

    class _Post:
        boxes = np.asarray([[10.0, 10.0, 30.0, 30.0]])
        bbox_confs = np.asarray([0.9])

    class _Eng:  # native-resolution branch: detect_image per readable image
        input_size = (-1, -1)

        def detect_image(self, img):
            return _Post()

    m = T.evaluate_engine_on_wider(_Eng(), str(ann), str(tmp_path / "imgs"))
    assert m == J.evaluate_engine_on_wider(_Eng(), str(ann),
                                           str(tmp_path / "imgs"))
    assert m["AR"] <= 0.5 + 1e-6
    assert m["AP50"] <= 0.51


def test_batched_wider_runner_matches_per_image_and_jax(tmp_path):
    """The block path (host letterbox, batched detect in blocks of 4,
    host un-letterbox) against the port's per-image path, and against the
    JAX runner, each engine holding golden_blaze_ckpt: blazeface-front on
    5 seeded frames of mixed sizes, one WIDER line each."""
    from face_detection_and_recognition_tpu.core.engine import \
        EngineConfig as JEngineConfig
    from face_detection_and_recognition_tpu.core.engine import \
        FaceEngine as JFaceEngine
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.utils.weights import \
        blazeface_state_dict

    rng = np.random.RandomState(1)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    gimg = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    lines = []
    for i in range(5):
        h, w = rng.choice([96, 128]), rng.choice([128, 160])
        img = cv2.resize(gimg, (int(w), int(h))) if i % 2 else \
            rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        cv2.imwrite(str(img_dir / f"im{i}.jpg"), img)
        lines += [f"im{i}.jpg", "1",
                  f"{rng.randint(0, 20)} {rng.randint(0, 20)} 30 30 0 0"]
    ann = tmp_path / "gt.txt"
    ann.write_text("\n".join(lines) + "\n")

    v = _load("golden_blaze_ckpt")
    kw = dict(detector="blazeface-front", det_thres=0.2, bbox_area_thres=0.0,
              max_det=8)
    eng = FaceEngine(EngineConfig(**kw), device="cpu")
    eng.load_state_dict(blazeface_state_dict(v, False))
    batched = T.evaluate_engine_on_wider(eng, str(ann), str(img_dir),
                                         batch_size=4)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables = v
    ref = J.evaluate_engine_on_wider(jeng, str(ann), str(img_dir),
                                     batch_size=4)
    for k in ref:
        assert batched[k] == pytest.approx(ref[k], abs=0.01), (batched, ref)

    gt = T.parse_wider_annotations(str(ann))
    gtb, detb = {}, {}
    for img_id, rel in enumerate(sorted(gt)):
        gtb[img_id] = gt[rel]
        post = eng.detect_image(T._read(str(img_dir / rel)))
        if len(post.boxes):
            detb[img_id] = T._dets_to_xywh(post)
    per_image = T.evaluate_detections(gtb, detb)
    assert batched["AP"] == pytest.approx(per_image["AP"], abs=0.05)
    assert batched["AR"] == pytest.approx(per_image["AR"], abs=0.05)


def test_eval_wider_cli_on_golden_composite_set(tmp_path, capsys):
    """The eval command end to end with trained weights (the gate of
    tests/test_golden_accuracy.py:452): golden_yolov5n_ckpt as a .pt, the
    12-image composite set, --dt 0.05; the port's CLI on the CPU and the
    JAX CLI on the same file."""
    from face_detection_and_recognition_tpu.cli.eval_wider import \
        main as jmain
    from face_detection_and_recognition_tpu.train.golden import \
        make_composite_dataset
    from face_detection_and_recognition_tpu_torch.cli.eval_wider import main
    from face_detection_and_recognition_tpu_torch.utils.weights import \
        yolov5_face_state_dict

    ann, images_root = make_composite_dataset(
        str(tmp_path / "ds"), n_images=12, out_wh=(640, 640), seed=7777,
        include_real=False)
    pt = str(tmp_path / "yolov5n.pt")
    torch.save(yolov5_face_state_dict(_load("golden_yolov5n_ckpt"),
                                      "yolov5n"), pt)
    args = ["--ann", ann, "--images", images_root, "--md", "yolov5n",
            "--ckpt", pt, "--dt", "0.05"]
    assert main(args + ["-d", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain(args) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["AP50"] >= 0.60, got
    assert set(got) == set(ref) == {"AP", "AP50", "AP75", "AR"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=0.01), (got, ref)
