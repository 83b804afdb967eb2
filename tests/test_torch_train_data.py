"""The port's training data pipeline (``train/data.py``) against the JAX
package's and cv2, on the CPU.

The two uint8 HSV conversions exhaustively against cv2 (all 2^24 BGR
colours; all 2^24 HSV triples, in rows of 4096 pixels and in rows of 3, the
per-pixel form's), cv2's warpAffine (``ops.geometry.warp_affine``, the
crowded composer's rotation) on seeded patches, and ``augment_hsv``, flips,
``mosaic4``, ``letterbox_example``, ``make_example`` / ``augment_example``
and the first batches of ``wider_batches`` bit for bit against the JAX
package's from the same ``random.Random`` seeds. No tolerance anywhere:
every comparison is exact.
"""
import random

import cv2
import numpy as np
import pytest

from face_detection_and_recognition_tpu.train import data as JT
from face_detection_and_recognition_tpu_torch.ops.geometry import (
    rotation_matrix_2d, warp_affine)
from face_detection_and_recognition_tpu_torch.train import data as T
from face_detection_and_recognition_tpu_torch.utils.native import \
    write_image_bgr


def _all_triples() -> np.ndarray:
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255],
                    -1).astype(np.uint8)


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    img = _all_triples().reshape(4096, 4096, 3)
    np.testing.assert_array_equal(T.bgr_to_hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [4096, 3])
def test_hsv_to_bgr_equals_cv2_on_every_triple(width):
    """Rows of 4096 pixels take cv2's vector form, rows of 3 its per-pixel
    form (H up to 255, past the 180 the jitter's LUT keeps to)."""
    img = _all_triples()
    n = len(img) // width * width
    img = img[:n].reshape(-1, width, 3)
    np.testing.assert_array_equal(T.hsv_to_bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_hsv_to_bgr_ragged_rows_equal_cv2():
    """A row of 32 k + r pixels: the vector blocks, then the tail."""
    rng = np.random.RandomState(0)
    for w in (1, 31, 33, 65, 100, 127):
        img = rng.randint(0, 256, (5, w, 3)).astype(np.uint8)
        img[..., 0] %= 180
        np.testing.assert_array_equal(T.hsv_to_bgr(img),
                                      cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_warp_affine_equals_cv2_on_rotated_patches():
    rng = np.random.RandomState(1)
    for _ in range(60):
        ph, pw = rng.randint(4, 160, 2)
        patch = rng.randint(0, 256, (ph, pw, 3)).astype(np.uint8)
        ang = rng.uniform(-25, 25)
        m = cv2.getRotationMatrix2D((pw / 2, ph / 2), ang, 1.0)
        np.testing.assert_array_equal(
            rotation_matrix_2d((pw / 2, ph / 2), ang, 1.0), m)
        cos, sin = abs(m[0, 0]), abs(m[0, 1])
        nw, nh = int(ph * sin + pw * cos), int(ph * cos + pw * sin)
        m[0, 2] += nw / 2 - pw / 2
        m[1, 2] += nh / 2 - ph / 2
        np.testing.assert_array_equal(
            warp_affine(patch, m, (nw, nh)),
            cv2.warpAffine(patch, m, (nw, nh), flags=cv2.INTER_LINEAR,
                           borderMode=cv2.BORDER_REPLICATE))


@pytest.fixture(scope="module")
def photo():
    """A smooth seeded photo-like frame (gradients + noise)."""
    rng = np.random.RandomState(2)
    y, x = np.mgrid[0:180, 0:260]
    base = np.stack([x * 0.9, y * 1.2, (x + y) * 0.5], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


def _rows(rng, n, w, h):
    rows = np.full((n, 14), -1.0, np.float32)
    rows[:, 0] = rng.uniform(10, w - 10, n)
    rows[:, 1] = rng.uniform(10, h - 10, n)
    rows[:, 2:4] = rng.uniform(6, 50, (n, 2))
    rows[: n // 2, 4:14] = rng.uniform(0, min(w, h), (n // 2, 10))
    return rows


def test_augment_hsv_and_flips_equal_jax(photo):
    for seed in range(4):
        a = T.augment_hsv(photo, random.Random(seed), 0.015, 0.7, 0.4)
        b = JT.augment_hsv(photo, random.Random(seed), 0.015, 0.7, 0.4)
        np.testing.assert_array_equal(a, b)
    rows = _rows(np.random.RandomState(3), 6, 260, 180)
    np.testing.assert_array_equal(T.flip_lr_targets(rows, 260.0),
                                  JT.flip_lr_targets(rows, 260.0))
    np.testing.assert_array_equal(T.flip_ud_targets(rows, 180.0),
                                  JT.flip_ud_targets(rows, 180.0))


def test_mosaic_letterbox_and_examples_equal_jax(photo):
    rng = np.random.RandomState(4)
    items = [(np.ascontiguousarray(np.roll(photo, 37 * i, 1)[: 120 + 20 * i]),
              _rows(rng, 3, 260, 120 + 20 * i)) for i in range(4)]
    for seed in range(3):
        a = T.mosaic4(items, (96, 80), random.Random(seed), 0.5)
        b = JT.mosaic4(items, (96, 80), random.Random(seed), 0.5)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    rows = _rows(rng, 5, 260, 180)
    for size in ((128, 128), (96, 64)):
        a = T.letterbox_example(photo, rows, size)
        b = JT.letterbox_example(photo, rows, size)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    boxes = np.array([[20, 30, 40, 50], [100, 60, 12, 9]], np.float32)
    for x, y in zip(T.make_example(photo, boxes, (128, 128), 4),
                    JT.make_example(photo, boxes, (128, 128), 4)):
        np.testing.assert_array_equal(x, y)
    canvas, crow = JT.letterbox_example(photo, rows, (128, 128))
    aug = T.AugmentConfig(flipud=0.5)
    for seed in range(4):
        a = T.augment_example(canvas, crow, random.Random(seed), aug)
        b = JT.augment_example(canvas, crow, random.Random(seed),
                               JT.AugmentConfig(flipud=0.5))
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def wider_tree(tmp_path_factory, photo):
    """Six JPEGs (the port's encoder: cv2.imwrite's bytes) with WIDER
    annotations."""
    root = tmp_path_factory.mktemp("wider")
    img_dir = root / "images" / "0--Scene"
    img_dir.mkdir(parents=True)
    lines = []
    for i in range(6):
        write_image_bgr(str(img_dir / f"im{i}.jpg"),
                        np.ascontiguousarray(np.roll(photo, 29 * i, 1)))
        lines.append(f"0--Scene/im{i}.jpg\n2\n{20 + i} 30 60 70 0 0 0 0 0 0\n"
                     f"150 {40 + i} 30 45 0 0 0 0 0 0\n")
    ann = root / "gt.txt"
    ann.write_text("".join(lines))
    return str(ann), str(root / "images")


@pytest.mark.parametrize("augmented", [False, True])
def test_wider_batches_equal_jax(wider_tree, augmented):
    ann, images = wider_tree
    index = T.load_wider_index(ann, images)
    jindex = JT.load_wider_index(ann, images)
    assert [p for p, _ in index] == [p for p, _ in jindex]
    kw = dict(seed=5, epochs=3, as_uint8=True)
    ours = T.wider_batches(index, 4, (96, 96), 6,
                           augment=T.AugmentConfig() if augmented else None,
                           **kw)
    theirs = JT.wider_batches(jindex, 4, (96, 96), 6,
                              augment=JT.AugmentConfig() if augmented
                              else None, **kw)
    for _ in range(3):
        for a, b in zip(next(ours), next(theirs)):
            np.testing.assert_array_equal(a, b)


def test_prefetch_iter_keeps_order_and_raises():
    assert list(T.prefetch_iter(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise RuntimeError("source failed")

    it = T.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)
