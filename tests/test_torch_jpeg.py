"""The port's JPEG codec (``csrc/jpeg_codec.cpp`` through
``utils/native.py``) against this host's cv2, which decodes and encodes with
libjpeg-turbo: decoded pixels equal bit for bit in every sampling, gray and
progressive, with restart markers, on noise and smooth frames of odd sizes
down to 1x1; encoded bytes equal to ``cv2.imencode``'s at qualities 50-95,
gray and colour, 1x1 to 577x1023. The variants the codec does not read raise
``ValueError`` naming them; truncated and corrupt bytes give None. Frames
whose Huffman tables are left out (Motion-JPEG's) decode with the standard
ones, as cv2's do. The one
route builds once, and a missing compiler raises naming it.
"""
import os
import threading

import cv2
import numpy as np
import pytest

from face_detection_and_recognition_tpu_torch.utils import native as N

SAMPLINGS = ("420", "422", "440", "444", "411")
SIZES = ((1, 1), (1, 9), (7, 1), (3, 5), (17, 23), (33, 65), (97, 131))


def smooth_frame(h, w, seed=0):
    """A seeded BGR frame of sinusoids (JPEG's easy case)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.uniform(0.002, 0.05, 2)
            img[..., c] += 40 * np.sin(2 * np.pi * (fx * x + fy * y)
                                       + rng.uniform(0, 6.28))
    return np.clip(img, 0, 255).astype(np.uint8)


def frames():
    rng = np.random.RandomState(13)
    for h, w in SIZES:
        yield f"noise {h}x{w}", rng.randint(0, 256, (h, w, 3), np.uint8)
        yield f"smooth {h}x{w}", smooth_frame(h, w, seed=h * w)


def cv2_bytes(img, *params):
    ok, data = cv2.imencode(".jpg", img, list(params))
    assert ok
    return data.tobytes()


def assert_decodes_as_cv2(data, what):
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = N.decode_jpeg_bgr(data)
    assert got is not None, what
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline",
                                                     "progressive"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_decode_equals_cv2_in_every_sampling(sampling, progressive):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for name, img in frames():
        data = cv2_bytes(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                         cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                         cv2.IMWRITE_JPEG_QUALITY, 90)
        assert_decodes_as_cv2(data, f"{sampling} {name}")


@pytest.mark.parametrize("progressive", [0, 1], ids=["baseline",
                                                     "progressive"])
def test_decode_gray_equals_cv2(progressive):
    for name, img in frames():
        data = cv2_bytes(np.ascontiguousarray(img[..., 1]),
                         cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        got = N.decode_jpeg_bgr(data)
        assert (got[..., 0] == got[..., 2]).all()
        assert_decodes_as_cv2(data, f"gray {name}")


@pytest.mark.parametrize("interval", [1, 3, 7])
def test_decode_with_restart_markers_equals_cv2(interval):
    for name, img in frames():
        for progressive in (0, 1):
            data = cv2_bytes(img, cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                             cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
            if interval == 1 and img.shape[0] * img.shape[1] > 256:
                assert b"\xff\xd1" in data  # the file really has them
            assert_decodes_as_cv2(data, f"rst {interval} {name}")


def strip_huffman_tables(data):
    """The JPEG with its DHT segments removed, as Motion-JPEG cameras write
    frames: the scans then use the standard tables of T.81 Annex K.3."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:  # markers up to the first scan
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    assert len(out) < i
    return bytes(out + data[i:])


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_decode_without_huffman_tables_equals_cv2(sampling):
    """cv2 (libjpeg-turbo) decodes a frame whose DHTs are left out with the
    standard tables; so does the port. A progressive file without them is
    refused by both."""
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for name, img in frames():
        for params in ((), (cv2.IMWRITE_JPEG_RST_INTERVAL, 2)):
            data = strip_huffman_tables(cv2_bytes(
                img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor, *params))
            assert_decodes_as_cv2(data, f"no DHT {sampling} {name}")
    gray = strip_huffman_tables(cv2_bytes(smooth_frame(33, 65)[..., 0]))
    assert_decodes_as_cv2(gray, "no DHT gray")
    prog = strip_huffman_tables(cv2_bytes(
        smooth_frame(33, 65), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    assert cv2.imdecode(np.frombuffer(prog, np.uint8), cv2.IMREAD_COLOR) \
        is None
    assert N.decode_jpeg_bgr(prog) is None


def test_decode_golden_frames_and_a_full_size_frame():
    for name in ("test2_faces_3.jpg", "test1_faces_0.jpg"):
        path = os.path.join(os.path.dirname(__file__), "data", name)
        np.testing.assert_array_equal(N.read_image_bgr(path),
                                      cv2.imread(path))
    img = smooth_frame(576, 1024, seed=3)
    img[::7] = np.random.RandomState(1).randint(0, 256, img[::7].shape)
    assert_decodes_as_cv2(cv2_bytes(img), "576x1024 quality 95")


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("quality", [50, 75, 90, 95])
def test_encode_equals_cv2_imencode(quality, gray):
    sizes = SIZES + ((16, 16), (8, 24), (577, 1023))
    rng = np.random.RandomState(quality)
    for h, w in sizes:
        for img in (rng.randint(0, 256, (h, w, 3), np.uint8),
                    smooth_frame(h, w, seed=quality + h)):
            if gray:
                img = np.ascontiguousarray(img[..., 0])
            got = N.encode_jpeg_bgr(img, quality=quality)
            ref = cv2_bytes(img, cv2.IMWRITE_JPEG_QUALITY, quality)
            assert got == ref, (h, w, quality, gray)
            if h * w > 100000:
                break  # the largest frame once: noise at full size


def test_write_image_writes_cv2_imwrite_bytes(tmp_path):
    img = smooth_frame(45, 31)
    N.write_image_bgr(str(tmp_path / "port.jpg"), img)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), img)
    assert ((tmp_path / "port.jpg").read_bytes()
            == (tmp_path / "cv2.jpg").read_bytes())
    gray = np.ascontiguousarray(img[..., 2])
    assert N.encode_jpeg_bgr(gray[..., None]) == N.encode_jpeg_bgr(gray)
    with pytest.raises(ValueError, match="uint8"):
        N.encode_jpeg_bgr(np.zeros((4, 4, 2), np.uint8))


def _patched(data, marker, offset, value):
    """``data`` with the byte ``offset`` bytes after ``marker`` set."""
    out = bytearray(data)
    out[data.index(marker) + offset] = value
    return bytes(out)


def _progressive_without_refinement():
    """A cv2 progressive file cut after its first scans: the low AC
    coefficients stay unrefined, so libjpeg would smooth the blocks."""
    data = cv2_bytes(smooth_frame(40, 48), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[:sos[2]] + b"\xff\xd9"


@pytest.mark.parametrize("variant,match", [
    ("arithmetic", "arithmetic-coded"), ("lossless", "lossless"),
    ("hierarchical", "hierarchical"), ("12-bit", "12-bit"),
    ("unrefined progressive", "smooth")])
def test_unsupported_variants_raise_naming_file_and_variant(tmp_path,
                                                            variant, match):
    base = cv2_bytes(smooth_frame(24, 40))
    data = {"arithmetic": _patched(base, b"\xff\xc0", 1, 0xC9),
            "lossless": _patched(base, b"\xff\xc0", 1, 0xC3),
            "hierarchical": _patched(base, b"\xff\xc0", 1, 0xC5),
            "12-bit": _patched(base, b"\xff\xc0", 4, 12),
            "unrefined progressive": _progressive_without_refinement(),
            }[variant]
    with pytest.raises(ValueError, match=match):
        N.decode_jpeg_bgr(data)
    path = tmp_path / "variant.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"variant.jpg.*{match}"):
        N.read_image_bgr(str(path))


def _corrupt(case):
    data = cv2_bytes(np.random.RandomState(0).randint(0, 256, (64, 80, 3),
                                                      np.uint8),
                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    n = len(data)
    return {"truncated 30%": data[:int(n * 0.3)],
            "truncated 90%": data[:int(n * 0.9)],
            "truncated 99.9%": data[:int(n * 0.999)],
            "no EOI": data[:-2],
            "wrong restart marker": _patched(data, b"\xff\xd0", 1, 0xD3),
            "bad Huffman table": _patched(data, b"\xff\xc4", 6, 200),
            "scan of an unknown component": _patched(data, b"\xff\xda", 5,
                                                     9),
            "flipped entropy byte": data[:n // 2] + bytes([data[n // 2]
                                                           ^ 0x55])
            + data[n // 2 + 1:],
            "CMYK": None}[case]


@pytest.mark.parametrize("case", [
    "truncated 30%", "truncated 90%", "truncated 99.9%", "no EOI",
    "wrong restart marker", "bad Huffman table",
    "scan of an unknown component", "flipped entropy byte", "CMYK"])
def test_truncated_and_corrupt_bytes_give_none(case):
    data = _corrupt(case)
    if data is None:  # four components: an Adobe CMYK file made by hand
        base = cv2_bytes(smooth_frame(16, 16), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
        i = base.index(b"\xff\xc0")
        sof = bytearray(base[i:i + 19])
        sof[3], sof[9] = 20, 4  # length and component count
        data = base[:i] + bytes(sof) + b"\x04\x11\x00" + base[i + 19:]
    assert N.decode_jpeg_bgr(data) is None
    if case.startswith(("truncated", "no EOI", "bad", "scan")):
        # cv2 gives None for these too; for a resynchronised restart, a
        # flipped byte or CMYK it returns an image the port does not
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR) is None


def test_one_codec_built_once_and_bound_once(monkeypatch):
    lib = N._lib()
    assert N._lib() is lib
    path = N.library_path()
    assert path.is_file() and path.name.startswith("fdr_jpeg_")
    assert N.build_library() == path  # built: found, not rebuilt
    sources = sorted(p.name for p in N.CSRC.glob("jpeg_*"))
    assert sources == ["jpeg_codec.cpp", "jpeg_ycc.h"]
    assert not hasattr(N, "io_route") and not hasattr(N, "find_route")
    # concurrent first callers: one build, one binding
    monkeypatch.setattr(N, "_LIB", [])
    got = []
    gate = threading.Barrier(4)

    def call():
        gate.wait(timeout=10)
        got.append(N._lib())

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(got) == 4 and all(g is got[0] for g in got)


def test_missing_compiler_raises_naming_it_and_the_source(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "CXX", ("no-such-cxx",))
    with pytest.raises(RuntimeError, match="no-such-cxx.*jpeg_codec.cpp"):
        N.build_library()
    assert not list(tmp_path.glob("*.so"))


def test_failed_build_raises_naming_compiler_and_source(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "CXX_FLAGS", N.CXX_FLAGS + ("-DFDR_BROKEN",
                                                       "-include",
                                                       "/nonexistent.h"))
    with pytest.raises(RuntimeError, match="jpeg_codec.cpp with .*g\\+\\+"):
        N.build_library()
