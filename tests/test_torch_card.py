"""Tests of the port that need the CUDA card (marker ``cuda``): each skips
without one. On the card's machine, which has no jax (tests/conftest.py
imports it):

    python -m pytest --noconftest -p no:cacheprovider -q -s \\
        tests/test_torch_card.py

The nvjpeg JPEG route (the card's: that machine has no libjpeg) against
cv2's libjpeg decode of the same bytes: nvJPEG's YUV planes, upsampled and
converted by libjpeg's arithmetic (csrc/jpeg_ycc.h), differ from libjpeg's
pixels only by nvJPEG's IDCT. Bounds: max 3 levels (one level of Y, and
one of Cb or Cr times 1.772) and a mean under 0.1.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SAMPLINGS = ("420", "422", "440", "444", "411")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def _frames():
    rng = np.random.RandomState(21)
    y, x = np.mgrid[0:301, 0:397].astype(np.float32)
    smooth = np.stack([128 + 60 * np.sin(2 * np.pi * (0.004 * (c + 1) * x
                                                      + 0.003 * y + c))
                       for c in range(3)], -1)
    return {"noise 97x131": rng.randint(0, 256, (97, 131, 3), np.uint8),
            "smooth 301x397": np.clip(smooth, 0, 255).astype(np.uint8)}


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_nvjpeg_route_decodes_libjpegs_pixels(card, sampling):
    cv2 = pytest.importorskip("cv2")
    from face_detection_and_recognition_tpu_torch.utils import native as N

    assert N.io_route() == "nvjpeg"
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for name, img in _frames().items():
        ok, data = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        assert ok
        ref = cv2.imdecode(data, cv2.IMREAD_COLOR)
        got = N.decode_jpeg_bgr(data.tobytes())
        err = np.abs(got.astype(np.int64) - ref)
        print(f"{card} nvjpeg vs libjpeg, {sampling} {name}: max "
              f"{err.max()}, mean {err.mean():.4f}, equal "
              f"{(err == 0).mean():.4f}")
        assert got.shape == ref.shape
        assert err.max() <= 3 and err.mean() < 0.1


def test_nvjpeg_route_gray_and_garbage(card):
    cv2 = pytest.importorskip("cv2")
    from face_detection_and_recognition_tpu_torch.utils import native as N

    gray = _frames()["smooth 301x397"][..., 1].copy()
    ok, data = cv2.imencode(".jpg", gray)
    got = N.decode_jpeg_bgr(data.tobytes())
    assert got.shape == gray.shape + (3,)
    assert (got[..., 0] == got[..., 2]).all()
    assert np.abs(got.astype(int) - cv2.imdecode(data, 1)).max() <= 1
    assert N.decode_jpeg_bgr(b"") is None
    assert N.decode_jpeg_bgr(b"not a jpeg") is None
