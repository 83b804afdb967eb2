"""The crowded set of JAX ``tests/test_crowded_accuracy.py`` through the
port (CPU): the seed-11 set of 16 640x640 frames, built by the port's
``train/golden.make_crowded_dataset``, equal to the JAX package's byte for
byte (and to ``card_weights/expected.json``'s digests); the base yolov5n's
crowded AP through the port's ``evaluate_engine_on_wider`` equal to the
JAX engine's, run here (each image's boxes within 1 px, AP50 and AP
within 0.005), and within the stored tolerance of the stored JAX numbers;
and the max_det saturation case (``check_saturation``: the max_det 8
engine's boxes are the max_det 64 engine's top 8, and those are the JAX
engine's within 1 px). The other five AP gates are in
``tests/test_torch_crowded_gates.py``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu_torch.eval import card_weights as CW
from face_detection_and_recognition_tpu_torch.eval import coco_eval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = CW.load_expected()
CROWDED = EXPECTED["crowded"]
AP_TOL = 0.005       # the port against the JAX engine run here


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_card_weights", os.path.join(ROOT, "tools",
                                          "make_card_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def port_set(tmp_path_factory):
    """(ann, images_root) of the port's set, held to the stored digests."""
    return CW.crowded_set(str(tmp_path_factory.mktemp("crowded")), CROWDED)


def test_port_set_equals_the_jax_set(tool, port_set, tmp_path):
    """Every image and the annotation file, byte for byte; the set is
    crowded as the JAX test asserts (>= 12 faces a frame, one >= 24)."""
    ann, root = tool.jax_crowded_set(str(tmp_path))
    assert CW.crowded_digests(ann, root) == \
        CW.crowded_digests(*port_set) == CROWDED["digests"]
    n = [len(v) for v in coco_eval.parse_wider_annotations(
        port_set[0]).values()]
    assert len(n) == CROWDED["n_images"]
    assert sum(n) / len(n) >= 12 and max(n) >= 24, n


def test_settings_are_the_jax_tests(tool):
    assert {k: CROWDED[k] for k in tool.CROWDED} == tool.CROWDED
    for name, (net, floors) in tool.CROWDED_NETS.items():
        assert CROWDED["nets"][name]["net"] == net
        assert CROWDED["nets"][name]["floors"] == floors
        assert net in EXPECTED["nets"]


def _posts(eng, images_root, paths):
    from face_detection_and_recognition_tpu_torch.utils.native import \
        read_image_bgr

    out = []
    for rel in paths:
        post = eng.detect_image(read_image_bgr(os.path.join(images_root,
                                                            rel)))
        out.append((np.asarray(post.boxes, np.float32).reshape(-1, 4),
                    np.asarray(post.bbox_confs, np.float32)))
    return out


def test_port_yolov5n_crowded_ap_equals_the_jax_engine(tool, port_set):
    """yolov5n base (JAX ``tests/test_crowded_accuracy.py:69-80``): the
    port from ``yolov5n.pt`` and the JAX engine on the f32-cast checkpoint,
    the same boxes per image (1 px, scores 1e-4) and the same AP."""
    ann, root = port_set
    net = CROWDED["nets"]["yolov5n"]
    jeng = tool.jax_crowded_engine(net["net"])
    port = CW.crowded_engine(CROWDED, EXPECTED["nets"][net["net"]], "cpu")
    paths = sorted(coco_eval.parse_wider_annotations(ann))
    with torch.inference_mode():
        got = _posts(port, root, paths)
    ref = _posts(jeng, root, paths)
    for rel, (b, c), (jb, jc) in zip(paths, got, ref):
        assert b.shape == jb.shape, rel
        np.testing.assert_allclose(b, jb, atol=1.0, rtol=0, err_msg=rel)
        np.testing.assert_allclose(c, jc, atol=1e-4, rtol=0, err_msg=rel)
    from face_detection_and_recognition_tpu.eval.coco_eval import \
        evaluate_engine_on_wider

    jm = evaluate_engine_on_wider(jeng, ann, root,
                                  batch_size=CROWDED["batch_size"])
    m = CW.check_crowded("yolov5n", CROWDED, port, ann, root)
    for k in ("AP50", "AP"):
        assert abs(m[k] - jm[k]) <= AP_TOL, (k, m[k], jm[k])
        assert abs(jm[k] - net["jax"][k]) <= AP_TOL, (k, jm[k], net["jax"])


def test_port_saturation_keeps_the_top_confidence_subset(port_set):
    """JAX ``tests/test_crowded_accuracy.py:151-205`` through the port,
    from ``yolov5n_crowded.pt``."""
    sat = CROWDED["saturation"]
    row = EXPECTED["nets"][sat["net"]]
    small, big = (CW.build_engine(row, "cpu", det_thres=sat["det_thres"],
                                  max_det=md)
                  for md in (sat["max_det"], sat["max_det_ref"]))
    img, gt = CW.saturation_frame(sat, *port_set)
    s = CW.check_saturation(sat, small, big, img, gt)
    assert s["n"] == sat["max_det"] == sat["jax"]["n"]
    assert s["n_ref"] > sat["max_det"]
