"""The port's FaceEngine as a whole: the golden yolov5s checkpoint, read by
the JAX package and bridged, passes the golden gate through the port and
detects what the JAX engine detects (CPU)."""
import os

import cv2
import jax
import numpy as np
import pytest

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.utils.weights import \
    yolov5_face_state_dict

DATA = os.path.join(os.path.dirname(__file__), "data")
CKPT = os.path.join(DATA, "golden_yolov5s_ckpt")


@pytest.fixture(scope="module")
def engines():
    """Each engine once: (JAX, port) for square and rect letterbox."""
    variables = jax.tree_util.tree_map(np.asarray, load_variables(CKPT))
    sd = yolov5_face_state_dict(variables, "yolov5s")
    out = {}
    for rect in (False, True):
        jeng = JFaceEngine(JEngineConfig(detector="yolov5s", rect=rect))
        jeng.variables = variables
        teng = FaceEngine(EngineConfig(detector="yolov5s", rect=rect),
                          device="cpu")
        teng.load_state_dict(sd)
        out[rect] = (jeng, teng)
    return out


def test_port_engine_passes_golden_gate(engines):
    # the gate of test_golden_accuracy.py for the JAX engine, unchanged
    r = evaluate_golden(engines[False][1], det_thres=0.6, margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3, f"expected 3 golden faces, got {r['n_pos']}"
    assert r["n_neg"] == 0, f"0-face image produced {r['n_neg']} detections"
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("name", ["test2_faces_3.jpg", "test1_faces_0.jpg"])
def test_port_engine_matches_jax_engine(engines, rect, name):
    jeng, teng = engines[rect]
    img = cv2.imread(os.path.join(DATA, name))
    ref = jeng.detect_image(img, det_thres=0.3)
    got = teng.detect_image(img, det_thres=0.3)
    assert len(got) == len(ref)
    # rounded pixel boxes: an f32 difference can flip a .5 rounding, so 1 px
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.bbox_lmarks, ref.bbox_lmarks, atol=1.0,
                               rtol=0)
    # scores after ~60 f32 conv layers summed in another order
    np.testing.assert_allclose(got.bbox_confs, ref.bbox_confs, atol=1e-4,
                               rtol=0)


def test_port_detect_batch_matches_detect_image(engines):
    """A batch of frames gives each frame what it gives alone."""
    teng = engines[False][1]
    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    batch = np.stack([img, img[:, ::-1]])
    per = teng.detect_batch(batch, det_thres=0.3).to_numpy()
    for frame, res in zip(batch, per):
        one = teng.detect_image(np.ascontiguousarray(frame), det_thres=0.3)
        np.testing.assert_allclose(res.boxes, one.boxes, atol=1.0, rtol=0)
        np.testing.assert_allclose(res.bbox_confs, one.bbox_confs, atol=1e-4,
                                   rtol=0)
