"""The port's yolov5s-face network, weight bridge and candidates-first
detect against the JAX package's, on the same weights and inputs (CPU)."""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models import yolov5_face as JY
from face_detection_and_recognition_tpu.ops.boxes import xywh2xyxy as jxyxy
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.models import yolov5_face as TY
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.utils.weights import \
    yolov5_face_state_dict

DATA = os.path.join(os.path.dirname(__file__), "data")
CKPT = os.path.join(DATA, "golden_yolov5s_ckpt")


@pytest.fixture(scope="module")
def golden_variables():
    return jax.tree_util.tree_map(np.asarray, load_variables(CKPT))


@pytest.fixture(scope="module")
def golden_input():
    """The golden 3-face frame, letterboxed to 160 x 160 by the JAX recipe."""
    import dataclasses

    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    spec = dataclasses.replace(JP.YOLOV5_FACE, size=(160, 160))
    return np.array(JP.apply_preprocess_batch(jnp.asarray(img[None]), spec))


def test_bridged_net_raw_maps_equal_flax(golden_variables, golden_input):
    ref = JY.YoloV5FaceNet(arch="yolov5s").apply(golden_variables,
                                                 golden_input)
    net = TY.YoloV5FaceNet("yolov5s").eval()
    net.load_state_dict(yolov5_face_state_dict(golden_variables, "yolov5s"))
    net = net.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = net(torch.from_numpy(golden_input))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        # f32 convolutions summed in another order through ~60 layers
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def _random_maps(rng, b=2, h=256, w=256):
    """Raw head maps [B, 3, h/s, w/s, 16]; every 5th objectness logit is
    saturated so that sigmoid scores tie at 1.0."""
    maps = []
    for s in (8, 16, 32):
        m = rng.normal(0, 2, (b, 3, h // s, w // s, 16)).astype(np.float32)
        m.reshape(b, -1, 16)[:, ::5, 4] = 25.0
        maps.append(m)
    return maps


def test_decode_heads_equals_jax(rng):
    maps = _random_maps(rng)
    got = TY.decode_heads([torch.from_numpy(m) for m in maps],
                          TY.FACE_ANCHORS, (8, 16, 32)).numpy()
    ref = np.asarray(JY.decode_heads(maps, JY.FACE_ANCHORS, (8, 16, 32)))
    # pixel coordinates up to ~1e3 from f32 sigmoids that may differ by an ulp
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("hw", [(256, 256), (128, 256)])
def test_detect_maps_equals_jax(rng, hw):
    h, w = hw
    maps = _random_maps(rng, h=h, w=w)
    kw = dict(max_candidates=256, max_det=64, input_size=(w, h))
    got_d, got_v = TY.yolov5_face_detect_maps(
        [torch.from_numpy(m) for m in maps], TY.FACE_ANCHORS, (8, 16, 32),
        TY.YoloV5FaceConfig(**kw))
    ref_d, ref_v = JY.yolov5_face_detect_maps(
        maps, JY.FACE_ANCHORS, (8, 16, 32), JY.YoloV5FaceConfig(**kw))
    ref_d, ref_v = np.asarray(ref_d), np.asarray(ref_v)
    # the same kept rows in the same order (ties included) ...
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    assert ref_v.sum() > 10
    # ... with boxes, scores and landmarks to f32 decode precision
    np.testing.assert_allclose(got_d.numpy()[ref_v], ref_d[ref_v],
                               rtol=1e-5, atol=1e-3)


def _jax_candidate_decode(maps_flat, idx, anchors, strides, in_size):
    """The JAX package's candidate path: the gather,
    ``_candidate_grid_params`` and the decode of ``yolov5_face_detect_maps``
    (JAX ``models/yolov5_face.py:504-530``)."""
    b, k = idx.shape
    flat = jnp.concatenate(maps_flat, axis=1)
    cand = jnp.take_along_axis(flat, idx[..., None], axis=1)
    cand = cand.astype(jnp.float32)
    grid, stride, anc = JY._candidate_grid_params(idx, anchors, strides,
                                                  in_size)
    y = jnp.concatenate([jax.nn.sigmoid(cand[..., :5]), cand[..., 5:15],
                         jax.nn.sigmoid(cand[..., 15:])], axis=-1)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (y[..., 2:4] * 2.0) ** 2 * anc
    lmk = (y[..., 5:15].reshape(b, k, 5, 2) * anc[..., None, :]
           + grid[..., None, :] * stride[..., None])
    return jnp.concatenate(
        [xy, wh, y[..., 4:5], lmk.reshape(b, k, 10), y[..., 15:]], axis=-1)


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("hw", [(256, 256), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_candidate_decode_plain_equals_jax(levels, hw, dtype):
    """B2's plain version (gather + grid params + decode, the function the
    fused kernel computes) against the JAX package's candidate path, on
    seeded maps with saturated logits: the P5 layout (strides 8/16/32) and
    the P6 one (8/16/32/64), square and rect, f32 and bf16 maps."""
    h, w = hw
    strides = (8, 16, 32, 64)[:levels]
    anchors = JY.FACE_ANCHORS if levels == 3 else JY.FACE_ANCHORS_P6
    rng = np.random.RandomState(levels * 1000 + h)
    maps = []
    for s in strides:
        m = rng.normal(0, 3, (2, 3 * (h // s) * (w // s), 16))
        m[..., 4] -= 2.0  # about a third of the rows pass conf_thres 0.4
        m[:, ::5, 4] = 25.0  # sigmoid scores tie at 1.0
        maps.append(jnp.asarray(m.astype(np.float32), getattr(jnp, dtype)))
    obj = jnp.concatenate([m[..., 4] for m in maps], 1).astype(jnp.float32)
    # every row, ranked as the detect path ranks its candidates
    _, idx = jax.lax.top_k(jax.nn.sigmoid(obj), obj.shape[1])
    idx = np.array(idx, np.int32)
    ref = np.asarray(_jax_candidate_decode(maps, jnp.asarray(idx), anchors,
                                           strides, (w, h)))
    # bf16 values cross over through f32 exactly
    tmaps = [torch.from_numpy(np.array(m.astype(jnp.float32)))
             .to(getattr(torch, dtype)) for m in maps]
    pred, boxes, valid = ck.candidate_decode_plain(
        tmaps, torch.from_numpy(idx), anchors, strides, (w, h), 0.4)
    assert pred.dtype == torch.float32 and pred.shape == (*idx.shape, 16)
    # which rows pass the threshold: decisions, exactly
    np.testing.assert_array_equal(valid.numpy(), ref[..., 4] >= 0.4)
    assert 0 < valid.sum() < valid.numel()
    # pixels to 1e-4: XLA's and ATen's f32 sigmoids may differ by an ulp,
    # which (2 y)^2 * anchor (up to 568 px) makes a few ulps of a w or h
    # near 1,000 px, where one ulp is 6e-5: hence also 1e-6 relative
    np.testing.assert_allclose(pred.numpy(), ref, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jxyxy(ref[..., :4])),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("arch", ["yolov5n", "yolov5n-0.5"])
def test_shuffle_graph_raw_maps_equal_flax(arch, golden_input):
    """The ShuffleNetV2 graph through the bridge: golden_yolov5n_ckpt for
    yolov5n, the flax module's own seeded init for yolov5n-0.5."""
    if arch == "yolov5n":
        variables = jax.tree_util.tree_map(np.asarray, load_variables(
            os.path.join(DATA, "golden_yolov5n_ckpt")))
    else:
        variables = jax.tree_util.tree_map(np.asarray, JY.YoloV5FaceNet(
            arch=arch).init(jax.random.PRNGKey(3), golden_input))
    ref = JY.YoloV5FaceNet(arch=arch).apply(variables, golden_input)
    net = TY.YoloV5FaceNet(arch).eval()
    net.load_state_dict(yolov5_face_state_dict(variables, arch))
    net = net.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = net(torch.from_numpy(golden_input))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_port_yolov5n_passes_golden_gate():
    """The gate of tests/test_golden_accuracy.py for golden_yolov5n_ckpt,
    through the port's engine."""
    from face_detection_and_recognition_tpu.train.golden import \
        evaluate_golden
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)

    variables = jax.tree_util.tree_map(np.asarray, load_variables(
        os.path.join(DATA, "golden_yolov5n_ckpt")))
    eng = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5),
                     device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(variables, "yolov5n"))
    r = evaluate_golden(eng, det_thres=0.6, margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3, f"expected 3 golden faces, got {r['n_pos']}"
    assert r["n_neg"] == 0, f"0-face image produced {r['n_neg']} detections"
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]
