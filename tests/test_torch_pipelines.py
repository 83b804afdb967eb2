"""The port's dataset-curation slice against the JAX package (CPU): image
reads beyond JPEG, the cv2-exact host resize and letterbox, ``iou_single``,
the dataset walker and loader, ``extract_faces_from_dataset`` (and its golden
gate through the port) and the tracking pipeline.

Weights: the committed golden checkpoints, cast to f32 for both packages
(golden_blaze_ckpt, golden_embed_ckpt, golden_ag_ckpt; golden_yolov5n_ckpt
for the gate), bridged to the port by ``utils/weights``. Frames: 128x128
crops of the golden 3-face image, written as JPEG, PNG and BMP.

Tolerances, each stated where it is used:
- PNG and BMP pixels, the host resize and letterbox: equal to cv2 (5.0.0
  on this host) bit for bit;
- detections: boxes within 1 px (rounded pixels);
- features and embeddings: 1e-4 absolute (f32 nets, same weights);
- crop JPEGs: byte-equal where the integer crop regions agree (libjpeg on
  this host encodes as cv2.imwrite does);
- age/gender labels: equal wherever the port's top-two probability margin
  exceeds 1e-4.
"""
import json
import os
import struct
import threading
import zlib

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.ops import boxes as JB
from face_detection_and_recognition_tpu.ops import geometry as JG
from face_detection_and_recognition_tpu.pipelines import dataset as JD
from face_detection_and_recognition_tpu.pipelines import \
    extract_faces as JX
from face_detection_and_recognition_tpu.pipelines import tracking as JT
from face_detection_and_recognition_tpu.train.golden import (
    GOLDEN_IMG, extract_golden_faces)
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.ops import boxes as TB
from face_detection_and_recognition_tpu_torch.ops import geometry as TG
from face_detection_and_recognition_tpu_torch.pipelines import dataset as TD
from face_detection_and_recognition_tpu_torch.pipelines import \
    extract_faces as TX
from face_detection_and_recognition_tpu_torch.pipelines import tracking as TT
from face_detection_and_recognition_tpu_torch.utils import native as N
from face_detection_and_recognition_tpu_torch.utils.video import VideoWriter
from face_detection_and_recognition_tpu_torch.utils.logging_utils import \
    setup_job_logger
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, blazeface_state_dict, mobile_facenet_state_dict,
    yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
EMB_TOL = 1e-4
LABEL_MARGIN = 1e-4
KW = dict(detector="blazeface-front", det_thres=0.3, embedder="mobile_facenet",
          with_age_gender=True, max_det=8)
# (top, left, side) windows of the 540x720 golden image, each resized to a
# 128x128 frame; every window holds one to three of its faces
WINDOWS = ((0, 0, 540), (60, 100, 400), (100, 250, 440), (0, 150, 540),
           (20, 60, 480), (140, 300, 400))


@pytest.fixture
def rng():
    """A fresh generator a test: the state of conftest's shared one
    depends on which tests ran before on the worker."""
    return np.random.RandomState(909)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the Tier-1 run puts
    several pytest workers on the host's cores. The previous count is
    restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) at blazeface-front + mobile_facenet + age/gender, the
    golden weights on both."""
    blaze, emb, ag = (_load("golden_blaze_ckpt"), _load("golden_embed_ckpt"),
                      _load("golden_ag_ckpt"))
    jeng = JFaceEngine(JEngineConfig(**KW))
    jeng.variables, jeng.embed_vars = blaze, emb
    jeng.ag_vars = (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(**KW), device="cpu")
    teng.load_state_dict(blazeface_state_dict(blaze, False))
    teng.load_embed_state_dict(mobile_facenet_state_dict(emb))
    teng.load_age_gender_state_dict(age_gender_state_dict(ag["age"],
                                                          ag["gender"]))
    return jeng, teng


def golden_frames():
    img = cv2.imread(GOLDEN_IMG)
    return [cv2.resize(img[y:y + s, x:x + s], (128, 128))
            for y, x, s in WINDOWS]


@pytest.fixture(scope="module")
def face_tree(tmp_path_factory):
    """data/class_x/ with one JPEG, one PNG and one BMP a class, each a
    128x128 window of the golden image."""
    root = tmp_path_factory.mktemp("faces") / "data"
    frames = golden_frames()
    for c, cls in enumerate(("class_a", "class_b")):
        d = root / cls
        d.mkdir(parents=True)
        for j, ext in enumerate((".jpg", ".png", ".bmp")):
            cv2.imwrite(str(d / f"m{j}{ext}"), frames[3 * c + j])
    return root


# ---------------- image reads ----------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """PNG-filter each row, cycling through filter types 0-4."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, r in enumerate(rows.astype(np.int64)):
        kind = y % 5
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(r)]
        b = prev
        if kind == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = (0, a, b, (a + b) >> 1)[kind]
        out.append(bytes([kind]) + ((r - pred) & 255).astype(
            np.uint8).tobytes())
        prev = r
    return b"".join(out)


def encode_png(px: np.ndarray, ctype: int, depth: int,
               interlace: int = 0) -> bytes:
    """A PNG of ``px`` ([H, W] or [H, W, C] samples) whose rows use every
    filter type: a file cv2.imwrite does not write (gray + alpha, a
    palette, interlacing) or does not filter so."""
    h, w = px.shape[:2]
    if depth == 16:
        raw = px.astype(">u2").reshape(h, -1).view(np.uint8)
    else:
        raw = px.astype(np.uint8).reshape(h, -1)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, ch * depth // 8)
    body = N.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if ctype == 3:
        body += _chunk(b"PLTE", bytes(range(256)) * 3)
    return body + _chunk(b"IDAT", zlib.compress(_filter_rows(raw, bpp))) + \
        _chunk(b"IEND", b"")


def test_walk_class_tree_matches_jax(tmp_path):
    for cls in ("b_cls", "a_cls"):
        d = tmp_path / cls
        d.mkdir()
        for name in ("x.jpg", "y.JPEG", "z.png", "w.bmp", "v.webp",
                     "c.mp4", "d.avi", "e.mov", "f.mkv", "g.webm",
                     "notes.txt", "noext"):
            (d / name).write_bytes(b"")
        (d / "nested").mkdir()
    (tmp_path / "loose.jpg").write_bytes(b"")
    got = [(i.class_name, i.path, i.kind)
           for i in TD.walk_class_tree(str(tmp_path))]
    ref = [(i.class_name, i.path, i.kind)
           for i in JD.walk_class_tree(str(tmp_path))]
    assert got == ref and len(got) == 20


PNG_CASES = [(ctype, depth) for ctype in (0, 4, 2, 6) for depth in (8, 16)]


@pytest.mark.parametrize("ctype,depth", PNG_CASES,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_CASES])
def test_png_reads_equal_cv2(tmp_path, rng, ctype, depth):
    """Each color type at 8 and 16 bits, every filter type in its rows:
    the port's read equals cv2.imread bit for bit (tolerance 0), through
    the compiled unfilter and its plain version."""
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = rng.randint(0, 2 ** depth, (23, 37, ch))[..., :ch]
    path = tmp_path / "a.png"
    path.write_bytes(encode_png(px[..., 0] if ch == 1 else px, ctype, depth))
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = N.read_image_bgr(str(path), formats=N.IMAGE_EXTENSIONS)
    assert got.dtype == np.uint8 and got.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, ref)
    plain = N.decode_png_bgr(path.read_bytes(), N.png_unfilter_plain)
    np.testing.assert_array_equal(plain, got)


@pytest.mark.parametrize("kind", ["bgr", "gray", "bgra", "bgr16"])
def test_cv2_written_png_reads_equal_cv2(tmp_path, rng, kind):
    img = {"bgr": rng.randint(0, 256, (41, 30, 3)),
           "gray": rng.randint(0, 256, (41, 30)),
           "bgra": rng.randint(0, 256, (41, 30, 4)),
           "bgr16": rng.randint(0, 65536, (41, 30, 3))}[kind]
    img = img.astype(np.uint16 if kind == "bgr16" else np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(
        N.read_image_bgr(path, formats=N.IMAGE_EXTENSIONS),
        cv2.imread(path, cv2.IMREAD_COLOR))


def _bmp(px: np.ndarray, top_down: bool, bits: int, fields: bool = False
         ) -> bytes:
    """A BMP of BGR(A) ``px`` with a BITMAPINFOHEADER (BI_RGB, or
    BI_BITFIELDS with the BGRA masks), rows padded to 4 bytes."""
    h, w = px.shape[:2]
    stride = (w * bits + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    masks = struct.pack("<III", 0xFF0000, 0xFF00, 0xFF) if fields else b""
    offset = 54 + len(masks)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                       3 if fields else 0, stride * h, 2835, 2835, 0, 0)
    head = b"BM" + struct.pack("<IHHI", offset + stride * h, 0, 0, offset)
    return head + info + masks + rows.tobytes()


@pytest.mark.parametrize("case", ["cv2 24-bit", "cv2 32-bit",
                                  "24-bit top-down", "32-bit top-down",
                                  "24-bit odd width", "32-bit bitfields"])
def test_bmp_reads_equal_cv2(tmp_path, rng, case):
    """24- and 32-bit BMP, both row orders, padded rows: equal to
    cv2.imread bit for bit (tolerance 0)."""
    path = tmp_path / "a.bmp"
    px3 = rng.randint(0, 256, (19, 31, 3)).astype(np.uint8)
    px4 = rng.randint(0, 256, (19, 31, 4)).astype(np.uint8)
    if case.startswith("cv2"):
        cv2.imwrite(str(path), px3 if "24" in case else px4)
    else:
        bits = 24 if "24" in case else 32
        px = px3 if bits == 24 else px4
        if "odd" in case:
            px = px[:, :29]
        path.write_bytes(_bmp(px, "top-down" in case, bits,
                              fields="bitfields" in case))
    ref = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = N.read_image_bgr(str(path), formats=N.IMAGE_EXTENSIONS)
    assert ref is not None
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["palette PNG", "interlaced PNG",
                                  "4-bit PNG", "WebP", "8-bit BMP"])
def test_unsupported_variants_raise_naming_file_and_variant(tmp_path, rng,
                                                            case):
    px = rng.randint(0, 16, (8, 8))
    name, data = {
        "palette PNG": ("p.png", lambda: encode_png(px, 3, 8)),
        "interlaced PNG": ("i.png", lambda: encode_png(px, 0, 8, 1)),
        "4-bit PNG": ("g.png", lambda: encode_png(px[:, :4] * 17, 0, 4)),
        "WebP": ("w.webp", lambda: cv2.imencode(
            ".webp", px.astype(np.uint8))[1].tobytes()),
        "8-bit BMP": ("b.bmp", lambda: cv2.imencode(
            ".bmp", px.astype(np.uint8))[1].tobytes()),
    }[case]
    path = tmp_path / name
    path.write_bytes(data())
    word = {"palette PNG": "palette", "interlaced PNG": "interlaced",
            "4-bit PNG": "4-bit", "WebP": "WebP", "8-bit BMP": "8-bit"}[case]
    with pytest.raises(ValueError, match=word) as err:
        N.read_image_bgr(str(path), formats=N.IMAGE_EXTENSIONS)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("case", ["truncated PNG", "bad CRC", "garbage",
                                  "truncated BMP", "truncated JPEG"])
def test_corrupt_files_give_none_as_cv2_does(tmp_path, rng, case):
    img = rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    bad_crc = bytearray(png)
    bad_crc[40] ^= 0xFF   # inside IDAT
    data = {"truncated PNG": png[:len(png) // 2], "bad CRC": bytes(bad_crc),
            "garbage": b"\x89PNG\r\n\x1a\n not a png at all",
            "truncated BMP": cv2.imencode(".bmp", img)[1].tobytes()[:300],
            "truncated JPEG": cv2.imencode(".jpg", img)[1].tobytes()[:200]}[
        case]
    ext = {"truncated BMP": ".bmp", "truncated JPEG": ".jpg"}.get(case,
                                                                 ".png")
    path = tmp_path / f"a{ext}"
    path.write_bytes(data)
    assert N.read_image_bgr(str(path), formats=N.IMAGE_EXTENSIONS) is None
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_compiled_equals_plain(rng, bpp):
    rowbytes = 7 * bpp + 3 * (bpp > 1)
    rows = rng.randint(0, 256, (11, rowbytes))
    raw = _filter_rows(rows, bpp)
    got = N.png_unfilter(raw, 11, rowbytes, bpp)
    np.testing.assert_array_equal(got, N.png_unfilter_plain(raw, 11,
                                                            rowbytes, bpp))
    np.testing.assert_array_equal(got, rows)
    bad = bytes([7]) + raw[1:]
    assert N.png_unfilter(bad, 11, rowbytes, bpp) is None
    assert N.png_unfilter_plain(bad, 11, rowbytes, bpp) is None


# ---------------- host resize and letterbox ----------------


RESIZE_CASES = {"upscale": ((50, 60), (112, 112)),
                "2x down": ((128, 96), (64, 48)),
                "540x720 -> 112x112": ((540, 720), (112, 112)),
                "odd": ((37, 91), (23, 50)),
                "one axis": ((40, 80), (40, 33)),
                "to 1 px": ((9, 7), (1, 1)),
                "from 1 px": ((1, 1), (5, 3))}


@pytest.mark.parametrize("case", list(RESIZE_CASES))
@pytest.mark.parametrize("channels", [3, 0])
def test_host_resize_equals_cv2(rng, case, channels):
    """cv2.resize(INTER_LINEAR) on uint8, bit for bit (tolerance 0)."""
    (sh, sw), (dh, dw) = RESIZE_CASES[case]
    img = rng.randint(0, 256, (sh, sw, channels) if channels else (sh, sw))
    img = img.astype(np.uint8)
    np.testing.assert_array_equal(TG.host_resize(img, (dw, dh)),
                                  cv2.resize(img, (dw, dh)))


def test_host_resize_sweep_equals_cv2(rng):
    """120 seeded shape pairs, 1 to 300 px a side, with 3 and 4 channels:
    bit for bit (tolerance 0)."""
    for t in range(120):
        sh, sw, dh, dw = (int(v) for v in rng.randint(1, 300, 4))
        img = rng.randint(0, 256, (sh, sw, 3 + t % 2)).astype(np.uint8)
        np.testing.assert_array_equal(TG.host_resize(img, (dw, dh)),
                                      cv2.resize(img, (dw, dh)),
                                      err_msg=f"{img.shape} -> {dh}x{dw}")


@pytest.mark.parametrize("shape", [(80, 100), (120, 140), (576, 1024),
                                   (33, 300)])
def test_host_letterbox_matches_jax(rng, shape):
    img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    for out in ((640, 640), (128, 128)):
        np.testing.assert_array_equal(TG.host_letterbox(img, out),
                                      JG.host_letterbox(img, out))


def test_host_resize_rejects_other_input():
    with pytest.raises(ValueError, match="uint8"):
        TG.host_resize(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        TG.host_resize(np.zeros((4, 4, 3), np.uint8), (0, 2))


# ---------------- boxes, logging ----------------


@pytest.mark.parametrize("b2", [[5, 5, 15, 15], [10, 0, 20, 10],
                                [11, 0, 20, 10], [0, 0, 10, 10],
                                [2, 2, 2, 8], [-5, -5, 30, 30]],
                         ids=["overlap", "touching", "apart", "same",
                              "zero width", "containing"])
def test_iou_single_matches_jax(b2):
    b1 = np.array([0, 0, 10, 10], np.float32)
    b2 = np.array(b2, np.float32)
    got = float(TB.iou_single(torch.from_numpy(b1), torch.from_numpy(b2)))
    ref = float(JB.iou_single(b1, b2))
    assert got == ref


def test_setup_job_logger_writes_a_log_file(tmp_path):
    log = setup_job_logger("torch_pipeline_test", log_dir=str(tmp_path))
    try:
        log.info("hello %d", 7)
        assert setup_job_logger("torch_pipeline_test") is log
        files = os.listdir(tmp_path)
        assert len(files) == 1 and files[0].startswith(
            "torch_pipeline_test_statistics_")
        for h in log.handlers:
            h.flush()
        assert "hello 7" in (tmp_path / files[0]).read_text()
    finally:
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)


# ---------------- the loader ----------------


def test_prefetch_loader_early_exit_reclaims_threads(face_tree):
    items = TD.walk_class_tree(str(face_tree)) * 4
    loader = TD.PrefetchLoader(items, num_workers=3, queue_size=1)
    for _ in loader:
        break  # consumer stops at once; queue_size=1 parks the workers
    assert not loader._threads


def test_loader_hands_on_unreadable_items_without_frames(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    (d / "v.mp4").write_bytes(b"\x00" * 64)
    (d / "w.webp").write_bytes(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
    (d / "x.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    cv2.imwrite(str(d / "y.png"), np.zeros((8, 8, 3), np.uint8))
    # a Motion-JPEG AVI is read: 25 frames at 10 fps keep 0, 10 and 20
    with VideoWriter(str(d / "z.avi"), 10, (8, 8)) as vw:
        for i in range(25):
            vw.write(np.full((8, 8, 3), i, np.uint8))
    got = {os.path.basename(i.path): len(f) for i, f in TD.PrefetchLoader(
        TD.walk_class_tree(str(tmp_path)), num_workers=2)}
    assert got == {"v.mp4": 0, "w.webp": 0, "x.jpg": 0, "y.png": 1,
                   "z.avi": 3}


# ---------------- extract_faces ----------------


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_extract_faces_matches_jax(engines, face_tree, tmp_path):
    """Same files and per-class counts; crop JPEGs byte-equal where the
    crop regions agree (every one here: the boxes agree to the pixel);
    feature rows within EMB_TOL."""
    jeng, teng = engines
    kw = dict(num_workers=2, block_size=4)
    jstats = JX.extract_faces_from_dataset(jeng, str(face_tree),
                                           str(tmp_path / "jax"), **kw)
    tstats = TX.extract_faces_from_dataset(teng, str(face_tree),
                                           str(tmp_path / "port"), **kw)
    assert tstats.classes == jstats.classes and not tstats.failed
    assert tstats.total_faces() >= 10
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert tfiles == jfiles
    n_crops = 0
    for f in tfiles:
        a = (tmp_path / "jax" / f).read_bytes()
        b = (tmp_path / "port" / f).read_bytes()
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(tmp_path / "port" / f),
                                       np.load(tmp_path / "jax" / f),
                                       atol=EMB_TOL, rtol=0)
        else:
            assert a == b, f
            n_crops += 1
    assert n_crops == tstats.total_faces()
    assert set(tstats.seconds) == {"decode wait", "blocks", "crop writes",
                                   "feature saves"}
    assert all(v >= 0 for v in tstats.seconds.values())


def test_extract_faces_makes_one_fused_call_per_block(engines, face_tree,
                                                      tmp_path, monkeypatch):
    """The counterpart of tests/test_pipelines.py:220: the fused block call
    only, one a block (6 frames of one size in blocks of 4: 2 calls), and
    never the single-image path."""
    _, teng = engines
    calls = []
    real = teng.detect_embed_classify_batch

    def spy(imgs, **kw):
        calls.append((imgs.shape, kw["embed_offsets"]))
        return real(imgs, **kw)

    def boom(*a, **k):
        raise AssertionError("a per-frame call from the batch pipeline")

    monkeypatch.setattr(teng, "detect_embed_classify_batch", spy)
    monkeypatch.setattr(teng, "detect_image", boom)
    monkeypatch.setattr(teng, "embed_faces", boom)
    stats = TX.extract_faces_from_dataset(teng, str(face_tree),
                                          str(tmp_path / "out"),
                                          num_workers=2, block_size=4)
    assert not stats.failed
    assert sum(c["media"] for c in stats.classes.values()) == 6
    assert calls == [((4, 128, 128, 3), TX.EXTRACTION_OFFSETS)] * 2


def test_extract_faces_resumes_by_existence(engines, face_tree, tmp_path):
    _, teng = engines
    out = str(tmp_path / "out")
    first = TX.extract_faces_from_dataset(teng, str(face_tree), out,
                                          num_workers=2, block_size=4)
    assert sum(c["media"] for c in first.classes.values()) == 6
    feats = np.load(os.path.join(out, "class_b", "m0.npy"))
    assert feats.shape == (45, 512)
    again = TX.extract_faces_from_dataset(teng, str(face_tree), out,
                                          num_workers=2, block_size=4)
    assert again.classes == {} and not again.failed


def test_unreadable_media_fail_without_a_hang(engines, tmp_path):
    """A corrupt JPEG, a WebP, a video that is not a Motion-JPEG AVI (an
    MP4 cut after its ftyp) and a palette PNG end in stats.failed, the
    readable image is extracted, the job returns (within a minute), and no
    loader thread outlives it."""
    _, teng = engines
    d = tmp_path / "data" / "class_x"
    d.mkdir(parents=True)
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8 this is not a jpeg")
    (d / "w.webp").write_bytes(cv2.imencode(
        ".webp", np.zeros((8, 8, 3), np.uint8))[1].tobytes())
    (d / "v.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    (d / "p.png").write_bytes(encode_png(np.zeros((8, 8), np.int64), 3, 8))
    cv2.imwrite(str(d / "ok.png"), golden_frames()[0])
    before = threading.active_count()
    out = []
    job = threading.Thread(target=lambda: out.append(
        TX.extract_faces_from_dataset(teng, str(tmp_path / "data"),
                                      str(tmp_path / "out"), num_workers=3,
                                      block_size=4)))
    job.start()
    job.join(timeout=60)
    assert not job.is_alive() and out, "the extraction job hung"
    stats = out[0]
    assert sorted(os.path.basename(p) for p in stats.failed) == [
        "corrupt.jpg", "p.png", "v.mp4", "w.webp"]
    assert stats.classes["class_x"]["media"] == 1
    assert threading.active_count() == before
    crop_dir = tmp_path / "out" / "class_x" / "corrupt"
    assert not crop_dir.exists()


def test_feature_slot_alignment_matches_jax(tmp_path):
    frame_feats = [np.full((1, 4), 1.0, np.float32), None,
                   np.full((3, 4), 3.0, np.float32)]
    for mod, root in ((TX, tmp_path / "port"), (JX, tmp_path / "jax")):
        item = (TD if mod is TX else JD).MediaItem("cls", "vid.mp4", "video")
        mod.save_extracted_faces(str(root), item, [], frame_feats, 4,
                                 save_crops=False, save_features=True)
    got = np.load(tmp_path / "port" / "cls" / "vid.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "jax" / "cls" /
                                               "vid.npy"))
    assert got.shape == (45, 4) and (got[6:9] == 3.0).all()


def test_extract_faces_mesh_raises(engines, face_tree, tmp_path):
    """``mesh=``: each block splits over the mesh's "data" axis (two
    repeated CPU entries) and the job writes what the unsharded job writes:
    the crop JPEGs byte for byte, the feature rows within 1e-5 (the
    embedder's f32 sums in a batch of another size); a block the axis does
    not divide raises."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    teng = engines[1]
    mesh = make_mesh(("data",), devices=["cpu"] * 2)
    kw = dict(num_workers=2, block_size=4)
    plain = TX.extract_faces_from_dataset(teng, str(face_tree),
                                          str(tmp_path / "plain"), **kw)
    sharded = TX.extract_faces_from_dataset(teng, str(face_tree),
                                            str(tmp_path / "mesh"),
                                            mesh=mesh, **kw)
    assert sharded.classes == plain.classes and not sharded.failed
    assert sharded.total_faces() >= 10
    files = _files(tmp_path / "plain")
    assert _files(tmp_path / "mesh") == files
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(tmp_path / "mesh" / f),
                                       np.load(tmp_path / "plain" / f),
                                       atol=1e-5, rtol=0)
        else:
            assert (tmp_path / "mesh" / f).read_bytes() == \
                (tmp_path / "plain" / f).read_bytes(), f
    with pytest.raises(ValueError, match="must divide"):
        TX.extract_faces_from_dataset(teng, str(face_tree),
                                      str(tmp_path / "o"), block_size=3,
                                      mesh=mesh)


def _golden_tree(root, n_per_class=3, seed=0):
    """tests/test_golden_pipeline_e2e.py's tree: 640x640 composites, one
    golden face each, on the image's face-free top strip."""
    import random

    rnd = random.Random(seed)
    faces = extract_golden_faces(GOLDEN_IMG)
    img = cv2.imread(GOLDEN_IMG)
    for cid in range(2):
        cdir = os.path.join(root, f"person_{cid}")
        os.makedirs(cdir, exist_ok=True)
        for j in range(n_per_class):
            bg = cv2.resize(img[:180], (640, 640))
            patch = faces[cid]["patch"]
            s = rnd.uniform(1.4, 2.0)
            ph, pw = int(patch.shape[0] * s), int(patch.shape[1] * s)
            p = cv2.resize(patch, (pw, ph))
            x0, y0 = rnd.randint(0, 640 - pw), rnd.randint(0, 640 - ph)
            bg[y0:y0 + ph, x0:x0 + pw] = p
            cv2.imwrite(os.path.join(cdir, f"im{j}.jpg"), bg)
    return root


def test_golden_extraction_gate_through_the_port(tmp_path):
    """The gate of tests/test_golden_pipeline_e2e.py:53-98 through the
    port, on golden_yolov5n_ckpt + golden_embed_ckpt."""
    tree = _golden_tree(str(tmp_path / "dataset"))
    eng = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5,
                                  embedder="mobile_facenet"), device="cpu")
    eng.load_state_dict(yolov5_face_state_dict(_load("golden_yolov5n_ckpt"),
                                               "yolov5n"))
    eng.load_embed_state_dict(mobile_facenet_state_dict(
        _load("golden_embed_ckpt")))
    out = str(tmp_path / "out")
    stats = TX.extract_faces_from_dataset(eng, tree, out, block_size=4,
                                          num_workers=2)
    assert stats.total_faces() >= 4, vars(stats)
    assert not stats.failed, stats.failed
    feats = []
    for cls in ("person_0", "person_1"):
        cdir = os.path.join(out, cls)
        npys = [f for f in os.listdir(cdir) if f.endswith(".npy")]
        assert npys, f"no feature files for {cls}"
        feats += [(cls, np.load(os.path.join(cdir, f))) for f in npys]
    norms = [np.linalg.norm(v, axis=-1) for _, v in feats]
    real = np.concatenate([r[r > 1e-3] for r in norms])
    assert len(real) >= 4
    np.testing.assert_allclose(real, 1.0, atol=1e-2)
    by_cls = {}
    for cls, v in feats:
        rows = v[np.linalg.norm(v, axis=-1) > 1e-3]
        by_cls.setdefault(cls, []).append(rows)
    m0 = np.concatenate(by_cls["person_0"]).mean(0)
    m1 = np.concatenate(by_cls["person_1"]).mean(0)
    r0 = np.concatenate(by_cls["person_0"])
    d_same = np.linalg.norm(r0 - m0, axis=-1).max()
    d_cross = np.linalg.norm(r0 - m1, axis=-1).min()
    assert d_cross > d_same, (d_same, d_cross)


# ---------------- tracking ----------------


def test_tracker_gates_match_jax():
    """tests/test_pipelines.py's tracker sequence through both trackers:
    the same matches, new tracks and label carry-forward."""
    trs = (TT.FaceTracker(metric="l2"), JT.FaceTracker(metric="l2"))
    e1, b1 = np.zeros(4, np.float32), np.array([0, 0, 10, 10], np.float32)
    far, near = np.full(4, 5.0, np.float32), np.full(4, 5.1, np.float32)
    seq = [(e1, b1), (e1 + 0.45, b1 + 1),
           (far, np.array([50, 50, 60, 60], np.float32)),
           (near, np.array([200, 200, 210, 210], np.float32)),
           (e1 + 2.0, np.array([11, 0, 21, 10], np.float32))]
    got = [[(t.face_id, new) for t, new in (tr.match_or_add(e, b)
                                            for e, b in seq)] for tr in trs]
    assert got[0] == got[1] == [(0, True), (0, False), (1, True), (1, False),
                                (2, True)]
    trs[0].tracks[1].age = "25-39"
    track, new = trs[0].match_or_add(far, np.array([200, 200, 210, 210],
                                                   np.float32))
    assert track.age == "25-39" and not new
    for m in ("l2", "cosine"):
        assert TT.embedding_distance(near, far, m) == pytest.approx(
            JT.embedding_distance(near, far, m), abs=1e-7)
    trs[0].reset()
    assert trs[0].tracks == []


def test_extract_and_label_matches_jax(engines, face_tree, tmp_path,
                                       monkeypatch):
    """The auto labeler (the engine's age/gender heads) on both packages:
    the same media, face ids, boxes within 1 px, and labels equal wherever
    the port's top-two margin exceeds LABEL_MARGIN."""
    jeng, teng = engines
    margins = []
    real = teng._classify

    def spy(crops):
        a, g = real(crops)
        for p in (a[0], g[0]):
            top = torch.topk(p, 2).values
            margins.append(float(top[0] - top[1]))
        return a, g

    monkeypatch.setattr(teng, "_classify", spy)
    jann = JT.extract_and_label_faces(
        jeng, str(face_tree), str(tmp_path / "jax"),
        labeler=JT.auto_age_gender_labeler(jeng), num_workers=2)
    # one loader thread: the labeler's calls come in the walk's order
    tann = TT.extract_and_label_faces(
        teng, str(face_tree), str(tmp_path / "port"),
        labeler=TT.auto_age_gender_labeler(teng), num_workers=1)
    assert sorted(tann) == sorted(jann) and len(tann) == 6
    assert json.load(open(tmp_path / "port" / "annotations.json")) == tann
    n, new = 0, 0
    for key, got in tann.items():
        ref = jann[key]
        assert got["face_ids"] == ref["face_ids"], key
        np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1, rtol=0)
        n += len(got["face_ids"])
        seen = set()
        for i, fid in enumerate(got["face_ids"]):
            if fid in seen:
                continue
            seen.add(fid)   # a new track: the labeler's call number `new`
            age_margin, gender_margin = margins[2 * new:2 * new + 2]
            new += 1
            if age_margin > LABEL_MARGIN:
                assert got["ages"][i] == ref["ages"][i], key
            if gender_margin > LABEL_MARGIN:
                assert got["genders"][i] == ref["genders"][i], key
        assert all(a is not None for a in got["ages"] + got["genders"])
    assert n >= 10 and len(margins) == 2 * new


def test_labeler_fires_once_per_new_track(engines, face_tree, tmp_path):
    _, teng = engines
    calls = []

    def labeler(frame, box):
        calls.append(tuple(box))
        return "25-39", "Male"

    ann = TT.extract_and_label_faces(teng, str(face_tree), str(tmp_path),
                                     labeler=labeler, metric="l2",
                                     num_workers=2)
    n_dets = sum(len(a["face_ids"]) for a in ann.values())
    n_new = sum(len(set(a["face_ids"])) for a in ann.values())
    assert n_dets >= 10 and len(calls) == n_new
    for rec in ann.values():
        assert set(rec["ages"]) <= {"25-39"}
        assert set(rec["genders"]) <= {"Male"}


def test_interactive_labeler_key_machine(rng):
    """The JAX test's key sequences (tests/test_cli_pipelines.py:133)
    through the caller's show and wait_key."""
    shown = []
    frame = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    box = np.array([10, 10, 40, 40], np.float32)
    for keys, want in (([ord("w"), ord("3")], ("25-39", "Male")),
                       ([ord("1"), ord("e")], ("0-13", "Female")),
                       ([27], ("Unknown", "Unknown"))):
        it = iter(keys)
        label = TT.interactive_labeler(
            show=lambda name, img: shown.append(img),
            wait_key=lambda delay: next(it))
        assert label(frame, box) == want
    assert len(shown) == 3 and shown[0].shape == (30, 30, 3)
    with pytest.raises(RuntimeError, match="no display window"):
        TT.interactive_labeler()
