"""The port's boxes, geometry, letterbox preprocess and NMS ops against the
JAX package's, on the same numpy inputs (CPU)."""
import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.ops import boxes as JB
from face_detection_and_recognition_tpu.ops import geometry as JG
from face_detection_and_recognition_tpu.ops import nms as JN
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.core.detections import \
    postprocess_detections as j_postprocess
from face_detection_and_recognition_tpu_torch.core.detections import \
    postprocess_detections as t_postprocess
from face_detection_and_recognition_tpu_torch.ops import boxes as TB
from face_detection_and_recognition_tpu_torch.ops import geometry as TG
from face_detection_and_recognition_tpu_torch.ops import nms as TN
from face_detection_and_recognition_tpu_torch.ops import preprocess as TP
from tests.test_nms import random_boxes

DATA = os.path.join(os.path.dirname(__file__), "data")
# f32 products of the same values, summed in another order (XLA's vs
# PyTorch's CPU GEMM): results agree to a few ulp of [0, 1] inputs
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n_in,n_out", [(576, 360), (1024, 640), (540, 480),
                                        (720, 640), (30, 64), (64, 64)])
def test_resample_matrix_equals_jax(n_in, n_out):
    # the operator is rebuilt step for step in numpy f32: bit-identical
    np.testing.assert_array_equal(TG._resample_matrix(n_in, n_out),
                                  JG._resample_matrix(n_in, n_out))


@pytest.mark.parametrize("in_hw", [(576, 1024), (540, 720), (480, 640),
                                   (1080, 1920), (333, 77)])
def test_letterbox_geometry_equals_jax(in_hw):
    # integer geometry: exact
    for out_hw in ((640, 640), (384, 640), (160, 160)):
        assert TG.letterbox_params(in_hw, out_hw) == \
            JG.letterbox_params(in_hw, out_hw)
    for stride in (32, 64):
        assert TG.rect_letterbox_size(in_hw, (640, 640), stride) == \
            JG.rect_letterbox_size(in_hw, (640, 640), stride)
    assert TG.make_divisible(in_hw[0], 32) == JG.make_divisible(in_hw[0], 32)


def test_boxes_equal_jax(rng):
    xywh = rng.uniform(1, 100, (3, 17, 4)).astype(np.float32)
    np.testing.assert_allclose(TB.xywh2xyxy(_t(xywh)).numpy(),
                               np.asarray(JB.xywh2xyxy(xywh)), rtol=TOL,
                               atol=TOL)
    a, b = random_boxes(rng, 12), random_boxes(rng, 9)
    for plus1 in (False, True):
        np.testing.assert_allclose(TB.box_area(_t(a), plus1).numpy(),
                                   np.asarray(JB.box_area(a, plus1)),
                                   rtol=TOL)
        eps = 1e-16 if plus1 else 0.0
        np.testing.assert_allclose(
            TB.iou_matrix(_t(a), _t(b), plus1, eps).numpy(),
            np.asarray(JB.iou_matrix(a, b, plus1, eps)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("src_hw,out_hw", [((72, 128), (45, 80)),
                                           ((30, 50), (64, 64)),
                                           ((160, 90), (71, 40))])
def test_resize_bilinear_equals_jax(rng, src_hw, out_hw):
    img = rng.randint(0, 256, (2,) + src_hw + (3,), np.uint8)
    got = TG.resize_bilinear(_t(img), out_hw).numpy()
    ref = np.asarray(JG.resize_bilinear(jnp.asarray(img), out_hw))
    # pixel values up to 255: TOL relative to the pixel range
    np.testing.assert_allclose(got / 255.0, ref / 255.0, atol=TOL)


def _preprocess_pair(imgs, size):
    spec_j = JP.YOLOV5_FACE if size is None else \
        dataclasses.replace(JP.YOLOV5_FACE, size=size)
    spec_t = TP.YOLOV5_FACE if size is None else \
        dataclasses.replace(TP.YOLOV5_FACE, size=size)
    got = TP.apply_preprocess_batch(_t(imgs), spec_t).numpy()
    ref = np.asarray(JP.apply_preprocess_batch(jnp.asarray(imgs), spec_j))
    return got, ref


@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_preprocess_random_frames(rng, rect):
    imgs = rng.randint(0, 256, (2, 72, 128, 3), np.uint8)
    size = TG.rect_letterbox_size((72, 128), (64, 64), 8) if rect \
        else (64, 64)
    got, ref = _preprocess_pair(imgs, size)
    assert got.shape == ref.shape == (2, size[1], size[0], 3)
    np.testing.assert_allclose(got, ref, atol=TOL)


@pytest.mark.parametrize("name", ["test2_faces_3.jpg", "test1_faces_0.jpg"])
@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_preprocess_golden_images(name, rect):
    img = cv2.imread(os.path.join(DATA, name))
    h, w = img.shape[:2]
    size = TG.rect_letterbox_size((h, w), (640, 640), 32) if rect else None
    got, ref = _preprocess_pair(img[None], size)
    np.testing.assert_allclose(got, ref, atol=TOL)


def test_scale_and_clip_coords_equal_jax(rng):
    coords = rng.uniform(-20, 660, (2, 5, 14)).astype(np.float32)
    for model_hw, orig_hw in (((640, 640), (540, 720)),
                              ((384, 640), (576, 1024))):
        got = TG.scale_coords(model_hw, _t(coords), orig_hw).numpy()
        ref = np.asarray(JG.scale_coords(model_hw, coords, orig_hw))
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=1e-4)
    np.testing.assert_array_equal(
        TG.clip_coords(_t(coords), (540, 720)).numpy(),
        np.asarray(JG.clip_coords(coords, (540, 720))))


def test_postprocess_detections_equals_jax(rng):
    b, k = 2, 32
    xy = rng.uniform(0, 0.8, (b, k, 2))
    wh = rng.uniform(0.01, 0.2, (b, k, 2))
    lmk = rng.uniform(0, 1, (b, k, 10))
    conf = rng.uniform(0, 1, (b, k, 1))
    dets = np.concatenate([xy, xy + wh, lmk, conf], -1).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.2
    got = t_postprocess(_t(dets), _t(valid), (720, 540), (640, 640), 0.5, 0.3)
    ref = j_postprocess(dets, valid, (720, 540), (640, 640), 0.5, 0.3)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # rounded pixel coordinates: the same integers
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(ref.boxes))
    np.testing.assert_array_equal(got.lmarks.numpy(), np.asarray(ref.lmarks))
    np.testing.assert_allclose(got.areas.numpy(), np.asarray(ref.areas),
                               rtol=TOL)
    per_t, per_j = got.to_numpy(), ref.to_numpy()
    assert [len(p) for p in per_t] == [len(p) for p in per_j]


@pytest.mark.parametrize("plus1,strict,mode", [
    (False, True, "union"), (True, False, "union"), (True, False, "min")])
def test_greedy_nms_equals_jax(rng, plus1, strict, mode):
    n = 48
    boxes = random_boxes(rng, n)
    boxes[8:12] = boxes[0:4]                      # identical boxes
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    scores[20:26] = scores[0]                     # score ties
    valid = rng.uniform(size=n) > 0.15
    dets = np.concatenate([boxes, scores[:, None]], -1)
    # a keep mask is a decision: exactly equal
    keep_t = TN.greedy_nms_mask(_t(boxes), _t(scores), _t(valid), 0.4,
                                plus1=plus1, strict=strict, mode=mode)
    keep_j = JN.greedy_nms_mask(boxes, scores, valid, 0.4, plus1=plus1,
                                strict=strict, mode=mode)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    out_t, ov_t = TN.greedy_nms(_t(dets), _t(valid), 0.4, 16, plus1=plus1,
                                strict=strict, mode=mode)
    out_j, ov_j = JN.greedy_nms(dets, valid, 0.4, 16, plus1=plus1,
                                strict=strict, mode=mode)
    np.testing.assert_array_equal(ov_t.numpy(), np.asarray(ov_j))
    np.testing.assert_array_equal(out_t.numpy()[ov_t.numpy()],
                                  np.asarray(out_j)[np.asarray(ov_j)])


def test_sort_by_score_batched_equals_jax(rng):
    scores = rng.uniform(0, 1, (3, 20)).astype(np.float32)
    scores[:, 5:9] = scores[:, :1]                # ties keep input order
    valid = rng.uniform(size=(3, 20)) > 0.3
    rows = rng.normal(size=(3, 20, 5)).astype(np.float32)
    got = TN.sort_by_score(_t(scores), _t(valid), _t(rows), top=12)
    ref = jax.vmap(lambda s, v, r: JN.sort_by_score(s, v, r, top=12))(
        scores, valid, rows)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
