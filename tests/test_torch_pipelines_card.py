"""The dataset slice's host image code against the cv2 of the card's machine
(marker ``cuda``: each test skips without a card). That machine has no jax
(tests/conftest.py imports it), so run:

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_pipelines_card.py

``host_resize`` is held to this machine's cv2.resize bit for bit, as on a
CPU host with cv2 5.0.0 (tests/test_torch_pipelines.py); PNG and BMP reads
to cv2.imread bit for bit. Crops written through the card's JPEG route
(nvJPEG's encoder) are not cv2.imwrite's bytes: each must decode to its
shape within a mean error of 2.0 levels of the crop (the bound chip_smoke.py
holds a frame's round trip to), and the largest difference from the same
crop written by cv2.imwrite is printed.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def test_host_resize_against_this_machines_cv2(card):
    cv2 = pytest.importorskip("cv2")
    from face_detection_and_recognition_tpu_torch.ops.geometry import \
        host_resize

    rng = np.random.RandomState(5)
    cases = [((50, 60), (112, 112)), ((128, 96), (64, 48)),
             ((540, 720), (112, 112)), ((576, 1024), (360, 640))]
    cases += [(tuple(rng.randint(1, 300, 2)), tuple(rng.randint(1, 300, 2)))
              for _ in range(120)]
    n_diff = n_all = exact = worst = 0
    for (sh, sw), (dh, dw) in cases:
        img = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        err = np.abs(host_resize(img, (dw, dh)).astype(np.int64)
                     - cv2.resize(img, (int(dw), int(dh))))
        n_diff += int((err > 0).sum())
        n_all += err.size
        exact += int(err.max() == 0)
        worst = max(worst, int(err.max()))
    print(f"{card}: host_resize vs cv2 {cv2.__version__} on {len(cases)} "
          f"shape pairs: {exact} bit-exact, max {worst} level, "
          f"{n_diff / n_all:.5%} of values differ")
    assert worst == 0


@pytest.mark.parametrize("kind", ["png bgr", "png gray", "png bgra",
                                  "png 16-bit", "bmp 24-bit", "bmp 32-bit"])
def test_png_and_bmp_reads_against_this_machines_cv2(card, tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    from face_detection_and_recognition_tpu_torch.utils import native as N

    rng = np.random.RandomState(6)
    shape = {"png gray": (57, 43), "png bgra": (57, 43, 4),
             "bmp 32-bit": (57, 43, 4)}.get(kind, (57, 43, 3))
    img = rng.randint(0, 65536 if "16" in kind else 256, shape)
    img = img.astype(np.uint16 if "16" in kind else np.uint8)
    path = str(tmp_path / f"a.{kind.split()[0]}")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(
        N.read_image_bgr(path, formats=N.IMAGE_EXTENSIONS),
        cv2.imread(path, cv2.IMREAD_COLOR))


def test_nvjpeg_crops_round_trip_within_the_jpeg_bound(card, tmp_path):
    cv2 = pytest.importorskip("cv2")
    from face_detection_and_recognition_tpu_torch.utils import native as N

    y, x = np.mgrid[0:240, 0:320].astype(np.float32)
    frame = np.clip(np.stack([128 + 60 * np.sin(0.02 * (c + 1) * x + 0.015
                                                 * y + c) for c in range(3)],
                             -1), 0, 255).astype(np.uint8)
    worst_mean = worst_vs_cv2 = 0.0
    for h, w in ((1, 1), (1, 37), (53, 1), (3, 5), (17, 31), (111, 113)):
        crop = np.ascontiguousarray(frame[10:10 + h, 20:20 + w])
        N.write_image_bgr(str(tmp_path / "port.jpg"), crop)
        cv2.imwrite(str(tmp_path / "cv2.jpg"), crop)
        a = cv2.imread(str(tmp_path / "port.jpg"))
        b = cv2.imread(str(tmp_path / "cv2.jpg"))
        assert a.shape == b.shape == crop.shape
        worst_mean = max(worst_mean, float(np.abs(a.astype(np.int64)
                                                  - crop).mean()))
        worst_vs_cv2 = max(worst_vs_cv2, int(np.abs(a.astype(np.int64)
                                                    - b).max()))
    print(f"{card}: nvJPEG-written crops: worst mean |decoded - crop| "
          f"{worst_mean:.3f}; max difference from cv2.imwrite's crops, both "
          f"decoded by cv2: {worst_vs_cv2} levels")
    assert worst_mean <= 2.0
