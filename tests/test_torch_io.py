"""The port's image I/O (``utils/native.py``), drawing (``utils/draw.py``)
and small host modules (``utils/files.py``, ``utils/parser.py``,
``core/config.py``) against cv2 and the JAX package (CPU).

JPEG goes through the port's own codec (``csrc/jpeg_codec.cpp``): its
decoder gives cv2.imread's pixels exactly and its encoder writes
cv2.imencode's bytes at the same quality; ``tests/test_torch_jpeg.py``
holds it to cv2 over samplings, sizes and variants.
"""
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.utils import draw as JD
from face_detection_and_recognition_tpu.utils.files import \
    get_file_type as j_get_file_type
from face_detection_and_recognition_tpu_torch.core import config as C
from face_detection_and_recognition_tpu_torch.core.detections import \
    PostProcessedDetection
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.utils import draw as D
from face_detection_and_recognition_tpu_torch.utils import native as N
from face_detection_and_recognition_tpu_torch.utils.files import get_file_type
from face_detection_and_recognition_tpu_torch.utils.parser import get_argparse

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ("test2_faces_3.jpg", "test1_faces_0.jpg")


def smooth_frame(h=96, w=160, seed=0):
    """A seeded BGR frame of low-frequency sinusoids (JPEG's easy case)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.uniform(0.002, 0.01, 2)
            img[..., c] += 30 * np.sin(2 * np.pi * (fx * x + fy * y)
                                       + rng.uniform(0, 6.28))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", GOLDEN)
def test_decode_equals_cv2_imread(name):
    path = os.path.join(DATA, name)
    got = N.read_image_bgr(path)
    ref = cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    # stated maximum difference: 0 (libjpeg's JDCT_ISLOW arithmetic)
    assert int(np.abs(got.astype(int) - ref).max()) == 0
    with open(path, "rb") as f:
        np.testing.assert_array_equal(N.decode_jpeg_bgr(f.read()), got)


def test_encode_decodes_in_cv2_within_bound():
    img = smooth_frame()
    data = N.encode_jpeg_bgr(img, quality=95)
    back = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    err = np.abs(back.astype(int) - img)
    # quality 95 on a smooth frame: stated bound, mean < 1 and max <= 8
    assert back.shape == img.shape
    assert err.mean() < 1.0 and err.max() <= 8, (err.mean(), err.max())
    # cv2.imencode's bytes at its defaults
    ok, ref = cv2.imencode(".jpg", img)
    assert ok and data == ref.tobytes()


def test_write_then_read_round_trip(tmp_path):
    img = smooth_frame()
    path = str(tmp_path / "out.jpg")
    N.write_image_bgr(path, img)
    np.testing.assert_array_equal(N.read_image_bgr(path), cv2.imread(path))


def test_grayscale_jpeg_comes_back_as_three_channels():
    gray = smooth_frame()[..., 1].copy()
    ok, data = cv2.imencode(".jpg", gray)
    assert ok
    got = N.decode_jpeg_bgr(data.tobytes())
    assert got.shape == gray.shape + (3,)
    assert (got[..., 0] == got[..., 1]).all()
    assert (got[..., 1] == got[..., 2]).all()
    np.testing.assert_array_equal(
        got, cv2.imdecode(data, cv2.IMREAD_COLOR))


def _golden_bytes():
    with open(os.path.join(DATA, GOLDEN[0]), "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["empty", "garbage", "header only",
                                  "truncated half", "truncated 99%"])
def test_unreadable_bytes_give_none(case):
    raw = _golden_bytes()
    data = {"empty": b"", "garbage": b"not a jpeg at all",
            "header only": raw[:100], "truncated half": raw[:len(raw) // 2],
            "truncated 99%": raw[:int(len(raw) * 0.99)]}[case]
    assert N.decode_jpeg_bgr(data) is None
    # cv2 gives None for each of them too
    arr = np.frombuffer(data, np.uint8)
    assert arr.size == 0 or cv2.imdecode(arr, cv2.IMREAD_COLOR) is None


def test_other_formats_and_missing_files(tmp_path):
    with pytest.raises(ValueError, match="PNG"):
        N.read_image_bgr(str(tmp_path / "a.png"))
    with pytest.raises(ValueError, match="only JPEG"):
        N.write_image_bgr(str(tmp_path / "a.png"), smooth_frame())
    assert N.read_image_bgr(str(tmp_path / "missing.jpg")) is None
    with pytest.raises(ValueError, match="uint8"):
        N.encode_jpeg_bgr(smooth_frame().astype(np.float32))
    with pytest.raises(ValueError, match="quality"):
        N.encode_jpeg_bgr(smooth_frame(), quality=0)


@pytest.mark.parametrize("module", ["native", "cuda_kernels"])
def test_library_is_built_and_bound_once_across_threads(monkeypatch, module):
    """Request threads reach the first build concurrently: the loader's lock
    lets one of them build and bind, and the rest find the library."""
    mod = {"native": N, "cuda_kernels": ck}[module]
    calls = []
    gate = threading.Barrier(8)

    def build():
        calls.append(1)
        threading.Event().wait(0.05)  # a slow build: the others pile up
        return "lib.so"

    monkeypatch.setattr(mod, "_LIB", [])
    monkeypatch.setattr(mod, "build_library", build)
    monkeypatch.setattr(mod, "_bind", lambda path: object())
    got = []

    def call():
        gate.wait(timeout=10)
        got.append(mod._lib())

    threads = [threading.Thread(target=call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_are_not_lost_across_threads(monkeypatch):
    import sys

    monkeypatch.setattr(ck, "LAUNCHES", dict(ck.LAUNCHES))
    ck.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ck._count("crop_resize") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert ck.LAUNCHES["crop_resize"] == 16000


# The decoder's finishing step (csrc/jpeg_ycc.h: libjpeg's chroma
# upsampling and YCbCr -> BGR) on libjpeg's own raw YCbCr planes: a small
# harness decodes with raw_data_out (libjpeg's IDCT, no upsampling) and
# finishes with jpeg_ycc.h; it must give the codec's full decode (and so
# cv2's) bit for bit.
_YCC_HARNESS = r"""
#include <cstdio>
#include <jpeglib.h>
#include <vector>
#include "jpeg_ycc.h"

extern "C" int raw_then_ycc(const unsigned char* data, size_t len,
                            unsigned char* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components != 3) return -1;
  cinfo.raw_data_out = TRUE;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int mh = cinfo.max_h_samp_factor, mv = cinfo.max_v_samp_factor;
  const int w = cinfo.image_width, h = cinfo.image_height;
  std::vector<unsigned char> pad[3];
  int pw[3], cw[3], ch[3];
  for (int c = 0; c < 3; ++c) {
    jpeg_component_info* k = &cinfo.comp_info[c];
    pw[c] = k->width_in_blocks * DCTSIZE;
    cw[c] = (w * k->h_samp_factor + mh - 1) / mh;
    ch[c] = (h * k->v_samp_factor + mv - 1) / mv;
    pad[c].resize(static_cast<size_t>(pw[c]) *
                  cinfo.total_iMCU_rows * k->v_samp_factor * DCTSIZE);
  }
  for (unsigned imcu = 0; imcu < cinfo.total_iMCU_rows; ++imcu) {
    JSAMPROW rows[3][4 * DCTSIZE];
    JSAMPARRAY arr[3];
    for (int c = 0; c < 3; ++c) {
      const int n = cinfo.comp_info[c].v_samp_factor * DCTSIZE;
      for (int i = 0; i < n; ++i)
        rows[c][i] = pad[c].data() + (imcu * n + i) * (size_t)pw[c];
      arr[c] = rows[c];
    }
    jpeg_read_raw_data(&cinfo, arr, mv * DCTSIZE);
  }
  std::vector<unsigned char> tight[3];
  for (int c = 0; c < 3; ++c) {
    tight[c].resize((size_t)cw[c] * ch[c]);
    for (int r = 0; r < ch[c]; ++r)
      for (int x = 0; x < cw[c]; ++x)
        tight[c][(size_t)r * cw[c] + x] = pad[c][(size_t)r * pw[c] + x];
  }
  fdr_ycc::Plane p[3];
  for (int c = 0; c < 3; ++c)
    p[c] = {tight[c].data(), static_cast<size_t>(cw[c]), cw[c], ch[c],
            mh / cinfo.comp_info[c].h_samp_factor,
            mv / cinfo.comp_info[c].v_samp_factor};
  fdr_ycc::planes_to_bgr(p, w, h, false, out);
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
"""


@pytest.fixture(scope="module")
def ycc_harness(tmp_path_factory):
    import ctypes
    import subprocess

    d = tmp_path_factory.mktemp("ycc")
    (d / "harness.cpp").write_text(_YCC_HARNESS)
    so = d / "harness.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{N.CSRC}", str(d / "harness.cpp"), "-o", str(so),
                    "-ljpeg"], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.raw_then_ycc.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_void_p]
    lib.raw_then_ycc.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("sampling", ["420", "422", "440", "444", "411"])
@pytest.mark.parametrize("kind", ["noise 97x131", "smooth 96x160"])
def test_decoder_finishing_step_jpeg_ycc_is_libjpeg(ycc_harness, sampling,
                                                    kind):
    if kind.startswith("noise"):
        img = np.random.RandomState(4).randint(0, 256, (97, 131, 3),
                                               np.uint8)
    else:
        img = smooth_frame()
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          factor])
    assert ok
    data = data.tobytes()
    out = np.empty(img.shape, np.uint8)
    assert ycc_harness.raw_then_ycc(data, len(data), out.ctypes.data) == 0
    np.testing.assert_array_equal(out, N.decode_jpeg_bgr(data))


# ---------------- drawing ----------------


def _post(boxes, lmarks, labels=None):
    boxes = np.asarray(boxes, np.float32)
    return PostProcessedDetection(
        boxes=boxes, bbox_confs=np.full(len(boxes), 0.93, np.float32),
        bbox_areas=np.full(len(boxes), 1.25, np.float32),
        bbox_lmarks=np.asarray(lmarks, np.float32), bbox_labels=labels)


def _dilate(mask, r):
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out |= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


@pytest.mark.parametrize("hw", [(200, 300), (700, 900)])
def test_draw_geometry_matches_jax(hw):
    """Boxes and landmark circles at the JAX version's pixels (its lines
    are anti-aliased: the port's solid lines lie on them, and they lie
    within the line thickness of the port's: 1 px at 200x300, 2 px at
    700x900, where cv2's round caps reach 3 px past a corner's line), and
    the label background's corner at the JAX version's (box x1 - 1, box
    y1)."""
    h, w = hw
    base = np.full((h, w, 3), 100, np.uint8)
    # the second box sits clear of the first one's label rows
    boxes = [[40, 110, 140, 190], [200, 20, 280, 80]]
    lmarks = [[70, 140, 110, 140, 90, 160, 75, 180, 105, 180],
              [220, 40, 260, 40, 240, 55, 225, 70, 255, 70]]
    post = _post(boxes, lmarks, ["Male:0.98,(25-32):0.87", "Female:0.51,"
                                 "(8-12):0.60"])
    ref = JD.draw_bbox_on_image(base.copy(), post)
    got = D.draw_bbox_on_image(base.copy(), post)
    red = (got == (0, 0, 255)).all(-1)
    # below the label rows, only boxes and circles are drawn
    below = np.zeros((h, w), bool)
    for x1, y1, x2, y2 in boxes:
        below[y1:y2 + 3, x1 - 3:x2 + 3] = True
    ref_changed = (ref != base).any(-1) & below
    got_changed = (got != base).any(-1) & below
    assert (got_changed <= ref_changed).all()
    thickness = max(int((w + h) / 600), 1)
    assert (ref_changed <= _dilate(got_changed, thickness)).all()
    # landmark circles: exactly cv2.circle's pixels (radius 3, LINE_8)
    for lm in lmarks:
        for cx, cy in zip(lm[::2], lm[1::2]):
            win = np.s_[cy - 4:cy + 5, cx - 4:cx + 5]
            ring = np.zeros((h, w, 3), np.uint8)
            cv2.circle(ring, (cx, cy), 3, (0, 0, 255), 1)
            np.testing.assert_array_equal(red[win],
                                          (ring[win] == (0, 0, 255)).all(-1))
            assert ((ref[win] == (0, 0, 255)).all(-1) == red[win]).all()
    # the label background: darkened from x1 - 1, ending above row y1
    for x1, y1, _, _ in boxes:
        for img in (ref, got):
            # row y1 - 4 is clear of the box's top edge at any thickness
            assert (img[y1 - 4, x1 - 1] == base[0, 0] // 2).all()
            assert (img[y1 - 4, x1 - 2] == base[0, 0]).all()
        # white glyph pixels on the background
        assert (got[y1 - 12:y1, x1:x1 + 40] == 255).all(-1).any()


def test_draw_label_text_and_palette():
    img = np.zeros((20, 80, 3), np.uint8)
    D.put_text(img, "0.93_(8)", (2, 10), 1)
    assert (img == 255).all(-1).sum() > 30
    assert D.text_size("0.93", 2) == (48, 14)
    for i in (0, 3, 6, 7, 55, 56, 200):
        assert D.get_distinct_rgb_color(i) == JD.get_distinct_rgb_color(i)


# ---------------- files, parser, config ----------------


@pytest.mark.parametrize("src", ["img.jpg", "a/b.JPEG", "x.png", "clip.mp4",
                                 "v.avi", "0", 3, "notes.txt", "noext"])
def test_get_file_type_matches_jax(src):
    assert get_file_type(src) == j_get_file_type(src)


def test_pickle_and_json_helpers_round_trip(tmp_path):
    from face_detection_and_recognition_tpu_torch.utils import files as F

    obj = {"emb": np.arange(6, dtype=np.float32).reshape(2, 3), "n": 2}
    F.write_pickle(str(tmp_path / "a.pkl"), obj)
    back = F.read_pickle(str(tmp_path / "a.pkl"))
    np.testing.assert_array_equal(back["emb"], obj["emb"])
    F.write_json({"b": 1, "a": [1, 2]}, str(tmp_path / "a.json"))
    got = F.read_json(str(tmp_path / "a.json"))
    assert list(got) == ["b", "a"] and got["a"] == [1, 2]


def test_parser_flags_and_remove_argument():
    p = get_argparse()
    a = p.parse_args([])
    assert (a.input_src, a.model, a.det_thres, a.bbox_area_thres, a.device,
            a.output, a.no_display) == ("0", "yolov5s", 0.70, 0.12, "cuda",
                                        None, False)
    assert p.parse_args(["-d", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        p.parse_args(["-d", "tpu"])
    # the case of tests/test_cli.py: a removed flag stops parsing and can
    # be added again
    p.remove_argument("input_src")
    with pytest.raises(SystemExit):
        p.parse_args(["-i", "x.mp4"])
    p.add_argument("-i", "--input_src", dest="input_src", default="z")
    assert p.parse_args(["-i", "y.jpg"]).input_src == "y.jpg"


def test_config_round_trip(tmp_path):
    import dataclasses

    from face_detection_and_recognition_tpu_torch.serving.service import \
        ServiceConfig

    cfg = ServiceConfig(detector="yolov5n", face_size=(64, 48), max_det=8)
    path = str(tmp_path / "svc.json")
    C.save_config(cfg, path)
    assert C.load_config(ServiceConfig, path) == cfg
    assert C.load_config(ServiceConfig, path, rect=True).rect is True
    with pytest.raises(ValueError, match="unknown config keys"):
        C.load_config(ServiceConfig, path, bogus=1)

    @dataclasses.dataclass
    class WithDtype:
        dtype: object = torch.float32

    C.save_config(WithDtype(torch.bfloat16), path)
    assert C.load_config(WithDtype, path).dtype is torch.bfloat16
