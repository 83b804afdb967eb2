"""The public helpers that the port added for API parity with the JAX
package, each against its JAX twin on the same inputs (CPU)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models import layers as JL
from face_detection_and_recognition_tpu.models import yolov5_face as JY
from face_detection_and_recognition_tpu.ops import boxes as JB
from face_detection_and_recognition_tpu.ops import geometry as JG
from face_detection_and_recognition_tpu.utils import files as JF
from face_detection_and_recognition_tpu_torch.models import layers as TL
from face_detection_and_recognition_tpu_torch.models import yolov5_face as TY
from face_detection_and_recognition_tpu_torch.ops import boxes as TB
from face_detection_and_recognition_tpu_torch.ops import geometry as TG
from face_detection_and_recognition_tpu_torch.utils import files as TF


def _xyxy2xywh(rng, tmp_path):
    b = rng.uniform(0, 600, (5, 7, 4)).astype(np.float32)
    b[..., 2:] += b[..., :2]
    np.testing.assert_array_equal(TB.xyxy2xywh(torch.from_numpy(b)).numpy(),
                                  np.asarray(JB.xyxy2xywh(jnp.asarray(b))))
    # the round trip of tests/test_geometry.py
    back = TB.xywh2xyxy(TB.xyxy2xywh(torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(back, b, rtol=0, atol=1e-4)


def _check_img_size(rng, tmp_path):
    for size in (1, 31, 32, 33, 640, 641, 1000):
        for s in (8, 32, 64, 32.0):
            assert TG.check_img_size(size, s) == JG.check_img_size(size, s)


def _batched_pad_resize(rng, tmp_path):
    imgs = rng.randint(0, 256, (2, 37, 61, 3)).astype(np.uint8)
    size, color = (40, 48), (0, 10, 255)   # a (w, h) box: pad rows
    got = TG.batched_pad_resize(torch.from_numpy(imgs), size, color)
    ref = np.asarray(JG.batched_pad_resize(jnp.asarray(imgs), size, color))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # two f32 resample passes summed in another order: ulps at 255
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    assert (got[:, 0] == torch.tensor(color, dtype=torch.float32)).all()
    one = TG.pad_resize_image(torch.from_numpy(imgs[1]), size, color)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


def _scale_coords(rng, tmp_path):
    c = rng.uniform(0, 640, (3, 6, 14)).astype(np.float32)
    for model_hw, orig_hw, ratio_pad in (
            ((640, 640), (576, 1024), None),
            ((384, 640), (576, 1024), ((0.625, 0.625), (0.0, 12.0))),
            ((640, 640), (480, 640), ((1.0,), (0.0, 80.0))),
            ((320, 256), (300, 200), ((1.28, 1.28), (0.0, 32.0)))):
        got = TG.scale_coords(model_hw, torch.from_numpy(c), orig_hw,
                              ratio_pad=ratio_pad).numpy()
        ref = np.asarray(JG.scale_coords(model_hw, jnp.asarray(c), orig_hw,
                                         ratio_pad=ratio_pad))
        np.testing.assert_array_equal(got, ref)


def _gen_class2label_from_dir(rng, tmp_path):
    root = tmp_path / "tree"
    for name in ("zeta", "alpha", "Mid", "b_2", "b_10"):
        (root / name).mkdir(parents=True)
    (root / "a_file.txt").write_text("not a class")
    got = TF.gen_class2label_from_dir(str(root), str(tmp_path / "t.json"))
    ref = JF.gen_class2label_from_dir(str(root), str(tmp_path / "j.json"))
    assert got == ref and list(got) == list(ref)
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    empty = tmp_path / "empty"
    empty.mkdir()
    assert TF.gen_class2label_from_dir(
        str(empty), os.path.join(tmp_path, "e.json")) == {}


def _fix_path_for_globbing(rng, tmp_path):
    for path in ("data", "data/", "data//", "data/*", "/abs/x", "/", "",
                 tmp_path):
        assert TF.fix_path_for_globbing(path) == \
            JF.fix_path_for_globbing(path)


def _l2_normalize(rng, tmp_path):
    x = rng.normal(0, 3, (4, 5, 6)).astype(np.float32)
    x[1, 2] = 0.0  # a zero vector: eps keeps it zero
    for axis in (0, 1, -1, 2):
        got = TL.l2_normalize(torch.from_numpy(x), axis=axis).numpy()
        ref = np.asarray(JL.l2_normalize(jnp.asarray(x), axis=axis))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        # the port's own callers name it dim
        np.testing.assert_array_equal(
            TL.l2_normalize(torch.from_numpy(x), dim=axis).numpy(), got)
    np.testing.assert_allclose(TL.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="differ"):
        TL.l2_normalize(torch.from_numpy(x), axis=0, dim=1)


def _decode_heads_nc(rng, tmp_path):
    b, h, w, nc = 2, 64, 96, 80
    maps = [rng.normal(0, 2, (b, 3, h // s, w // s, 5 + nc))
            .astype(np.float32) for s in (8, 16, 32)]
    tm = [torch.from_numpy(m) for m in maps]
    # nc positional, after the strides, as in the JAX signature
    got = TY.decode_heads(tm, TY.OFFICIAL_ANCHORS, (8, 16, 32), nc,
                          False).numpy()
    ref = np.asarray(jax.jit(lambda m: JY.decode_heads(
        m, JY.OFFICIAL_ANCHORS, (8, 16, 32), nc, False))(maps))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    # nc by keyword: the first level alone gives the first level's rows
    np.testing.assert_array_equal(
        TY.decode_heads(tm[:1], TY.OFFICIAL_ANCHORS[:1], (8,), nc=nc,
                        landmarks=False).numpy(), got[:, :tm[0][0].numel()
                                                      // (5 + nc)])


CASES = {f.__name__[1:]: f for f in (
    _xyxy2xywh, _check_img_size, _batched_pad_resize, _scale_coords,
    _gen_class2label_from_dir, _fix_path_for_globbing, _l2_normalize,
    _decode_heads_nc)}


@pytest.mark.parametrize("name", list(CASES))
def test_api_function_matches_jax_twin(name, tmp_path):
    """Each helper against its JAX twin on the same inputs: bit for bit
    where both compute the same f32 operations, else to the stated
    tolerance."""
    CASES[name](np.random.RandomState(sum(map(ord, name))), tmp_path)
