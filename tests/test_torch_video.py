"""The port's video path against cv2 and the JAX package (CPU).

``utils/video.py`` against this host's cv2 5.0.0: Motion-JPEG AVIs that
cv2 writes through both of its writer backends (FFmpeg and its own MJPEG
writer) read bit for bit as ``cv2.VideoCapture(path, CAP_OPENCV_MJPEG)``
reads them, with its fps and frame count, damaged chunks included; the
port's AVIs read by both cv2 readers, the OpenDML continuation past the
RIFF size limit (set small here) included. cv2's default reader (FFmpeg)
decodes Motion-JPEG with pixels up to ~90 levels from libjpeg's, so every
comparison with the JAX package pins its ``cv2.VideoCapture`` to
``CAP_OPENCV_MJPEG`` (a monkeypatch of the test; the JAX package is not
edited). Then ``inference_vid`` (yolov5s, the fused and the staged
age/gender routes), ``iter_media_frames``, ``extract_faces`` and
``tracking`` on video items, and ``detect_face -i clip.avi``, each against
the JAX package on the golden checkpoints (f32-cast), carried across by
``utils/weights.py``.
"""
import contextlib
import io
import os
import struct

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.cli.detect_face import main as jmain
from face_detection_and_recognition_tpu.core import inference as JI
from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.pipelines import dataset as JD
from face_detection_and_recognition_tpu.pipelines import \
    extract_faces as JX
from face_detection_and_recognition_tpu.pipelines import tracking as JT
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.cli.detect_face import main
from face_detection_and_recognition_tpu_torch.core import inference as TI
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                  FaceEngine)
from face_detection_and_recognition_tpu_torch.pipelines import dataset as TD
from face_detection_and_recognition_tpu_torch.pipelines import \
    extract_faces as TX
from face_detection_and_recognition_tpu_torch.pipelines import tracking as TT
from face_detection_and_recognition_tpu_torch.utils import native as N
from face_detection_and_recognition_tpu_torch.utils import video as V
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, blazeface_state_dict, mobile_facenet_state_dict,
    mtcnn_state_dict, yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
BOX_TOL, CONF_TOL = 1.0, 1e-4      # tests/test_torch_engine.py's
EMB_TOL = 1e-4                     # tests/test_torch_pipelines.py's
SHIFTS = [(2 * i, i) for i in range(6)]   # (dx, dy) of the golden clip


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pinned_reader(monkeypatch):
    """The JAX package's ``cv2.VideoCapture(path)`` reads through cv2's
    own MJPEG reader, whose pixels are libjpeg's (FFmpeg's are not)."""
    real = cv2.VideoCapture
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda src, *a: real(src, cv2.CAP_OPENCV_MJPEG))


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


def cv2_frames(path, api):
    """(frames, fps, frame count) of cv2's reader ``api``."""
    cap = cv2.VideoCapture(path, api)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    cap.release()
    return out, fps, count


def n_chunks(path):
    """The frame chunks of a file, zero-length ones included (what
    CAP_PROP_FRAME_COUNT counts)."""
    return len(list(V.VideoReader(path).chunks()))


def assert_same_frames(got, ref):
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def smooth_frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return [cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3), np.uint8),
                             (7, 7), 0) for _ in range(n)]


def write_port_clip(path, frames, fps):
    with V.VideoWriter(path, fps, (frames[0].shape[1],
                                   frames[0].shape[0])) as w:
        for f in frames:
            w.write(f)
    return path


def golden_clip(path, n=6):
    """``n`` frames of the golden image shifted by SHIFTS (rolled), as the
    port writes them: Motion-JPEG at 25 fps."""
    img = cv2.imread(IMG)
    return write_port_clip(path, [np.roll(img, (dy, dx), axis=(0, 1))
                                  for dx, dy in SHIFTS[:n]], 25)


# ---------------- the reader ----------------


@pytest.mark.parametrize("api,fps", [(cv2.CAP_FFMPEG, 29.97),
                                     (cv2.CAP_OPENCV_MJPEG, 10.0)],
                         ids=["ffmpeg-writer", "mjpeg-writer"])
def test_reader_equals_cv2_mjpeg_reader(tmp_path, api, fps):
    """cv2's MJPG AVI from either writer: the same frames bit for bit as
    CAP_OPENCV_MJPEG, the same fps (dwRate / dwScale) and count."""
    path = str(tmp_path / "cv2.avi")
    w = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                        (160, 120))
    for f in smooth_frames(5, 120, 160, 0):
        w.write(f)
    w.release()
    ref, ref_fps, ref_count = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    r = V.VideoReader(path)
    assert (r.width, r.height) == (160, 120)
    assert r.fps == ref_fps == fps and n_chunks(path) == ref_count == 5
    assert_same_frames(list(r.frames()), ref)


def strip_huffman_tables(data):
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + n]
        i += 2 + n
    return bytes(out + data[i:])


def damaged_chunks(case, frames):
    """The JPEG chunks of a clip of ``frames`` damaged as ``case`` says."""
    jp = [N.encode_jpeg_bgr(f) for f in frames]
    if case == "no-dht-422":
        return [strip_huffman_tables(cv2.imencode(
            ".jpg", f, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])[1].tobytes())
            for f in frames]
    return {"zero-length": [jp[0], jp[1], b"", jp[2]],
            "zero-length-first": [b"", jp[0], jp[1]],
            "garbage": [jp[0], b"\xff\xd8 not a jpeg", jp[1]],
            "cut-jpeg": [jp[0], jp[1][:len(jp[1]) // 2], jp[2]]}[case]


@pytest.mark.parametrize("case", ["no-dht-422", "zero-length",
                                  "zero-length-first", "garbage",
                                  "cut-jpeg"])
def test_reader_handles_damaged_chunks_as_cv2_mjpeg_reader(tmp_path, case,
                                                           monkeypatch):
    """Frames without Huffman tables decode; a zero-length chunk repeats
    the frame before it; an undecodable one, or a zero-length first one,
    ends the video: what CAP_OPENCV_MJPEG hands out, frame for frame, with
    the decode threads' window a frame or more ahead."""
    path = str(tmp_path / "d.avi")
    with V.VideoWriter(path, 10, (160, 120)) as w:
        for data in damaged_chunks(case, smooth_frames(4, 120, 160, 1)):
            w._append(data)  # the chunk as it is
    ref, _, count = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    r = V.VideoReader(path)
    assert n_chunks(path) == count
    assert_same_frames(list(r.frames()), ref)
    monkeypatch.setattr(V, "DECODE_WORKERS", 1)
    drawn = []
    for frame in r.frames():  # a caller that draws on what it is given
        drawn.append(frame.copy())
        frame[:] = 0
    assert_same_frames(drawn, ref)
    assert len(ref) == {"no-dht-422": 4, "zero-length": 4,
                        "zero-length-first": 0, "garbage": 1,
                        "cut-jpeg": 1}[case]


def test_reader_keep_decodes_only_the_kept_frames(tmp_path, monkeypatch):
    """``frames(keep=...)``, the sampler's read: only the kept chunks are
    decoded, a kept zero-length chunk is the frame before it (kept or
    not), and an undecodable chunk ends the read only where it is kept."""
    jp = [N.encode_jpeg_bgr(f) for f in smooth_frames(4, 48, 64, 4)]
    path = str(tmp_path / "k.avi")
    with V.VideoWriter(path, 10, (64, 48)) as w:
        for data in [jp[0], b"\xff\xd8 not a jpeg", jp[1], jp[2], b"",
                     jp[3]]:
            w._append(data)
    decoded = []
    real = V.decode_jpeg_bgr
    monkeypatch.setattr(V, "decode_jpeg_bgr",
                        lambda data: decoded.append(data) or real(data))
    got = list(V.VideoReader(path).frames(keep=lambda n: n % 2 == 0))
    assert_same_frames(got, [N.decode_jpeg_bgr(d) for d in jp[:3]])
    assert decoded == [jp[0], jp[1], jp[2]]
    assert len(list(V.VideoReader(path).frames())) == 1  # cv2's rule


def test_reader_of_a_truncated_file_ends_at_the_cut(tmp_path):
    frames = smooth_frames(5, 120, 160, 2)
    path = write_port_clip(str(tmp_path / "a.avi"), frames, 10)
    data = open(path, "rb").read()
    whole = list(V.VideoReader(path).frames())
    r = V.VideoReader(path)
    chunks = list(r.chunks())
    cut = str(tmp_path / "cut.avi")
    # inside the fourth frame's chunk: three whole frames before it
    at = data.index(chunks[3]) + len(chunks[3]) // 2
    with open(cut, "wb") as f:
        f.write(data[:at])
    assert_same_frames(list(V.VideoReader(cut).frames()), whole[:3])
    with open(cut, "wb") as f:  # inside the headers: no movi, no frames
        f.write(data[:4000])
    assert list(V.VideoReader(cut).frames()) == []


def _riff(fcc, body):
    return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def test_reader_walks_audio_junk_rec_lists_and_odd_sizes(tmp_path):
    """A hand-made AVI: an audio stream first (the video is stream 01), JUNK,
    odd-sized audio chunks, a 'LIST rec ' wrapper and an index: the video
    chunks are the frames, in order."""
    frames = smooth_frames(3, 16, 24, 3)
    jp = [N.encode_jpeg_bgr(f) for f in frames]
    auds = _riff(b"LIST", b"strl" + _riff(b"strh", b"auds" + bytes(52))
                 + _riff(b"strf", bytes(18)))
    vids = _riff(b"LIST", b"strl" + _riff(b"strh", struct.pack(
        "<4s4s4xHH4xII28x", b"vids", b"MJPG", 0, 0, 1001, 30000))
                 + _riff(b"strf", struct.pack("<Iii4x4s20x", 40, 24, -16,
                                              b"mjpg")))
    hdrl = _riff(b"LIST", b"hdrl" + _riff(b"avih", bytes(56)) + auds + vids)
    movi = _riff(b"LIST", b"movi" + _riff(b"JUNK", bytes(7))
                 + _riff(b"00wb", bytes(33)) + _riff(b"01dc", jp[0])
                 + _riff(b"LIST", b"rec " + _riff(b"00wb", bytes(5))
                         + _riff(b"01db", jp[1]))
                 + _riff(b"ix01", bytes(24)) + _riff(b"01dc", jp[2]))
    body = b"AVI " + hdrl + movi + _riff(b"idx1", bytes(16))
    path = str(tmp_path / "hand.avi")
    with open(path, "wb") as f:
        f.write(_riff(b"RIFF", body))
    r = V.VideoReader(path)
    assert (r.width, r.height, n_chunks(path)) == (24, 16, 3)
    assert r.fps == pytest.approx(30000 / 1001)
    assert_same_frames(list(r.frames()),
                       [N.decode_jpeg_bgr(d) for d in jp])


def test_reader_refuses_other_codecs_and_containers(tmp_path):
    mp4 = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 64))
    w.write(np.zeros((64, 64, 3), np.uint8))
    w.release()
    with pytest.raises(ValueError, match="clip.mp4: an MP4/MOV file with "
                       "video sample entry 'mp4v'"):
        V.VideoReader(mp4)
    xvid = str(tmp_path / "x.avi")
    w = cv2.VideoWriter(xvid, cv2.VideoWriter_fourcc(*"XVID"), 5, (64, 64))
    w.write(np.zeros((64, 64, 3), np.uint8))
    w.release()
    with pytest.raises(ValueError, match="x.avi: an AVI file whose video is "
                       "'XVID'"):
        V.VideoReader(xvid)
    (tmp_path / "z.mp4").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="z.mp4: not an AVI file"):
        V.VideoReader(str(tmp_path / "z.mp4"))
    with pytest.raises(FileNotFoundError):
        V.VideoReader(str(tmp_path / "missing.avi"))


# ---------------- the writer ----------------


@pytest.mark.parametrize("fps", [29.97, 25.0])
def test_writer_is_read_by_both_cv2_readers(tmp_path, fps):
    """The same count, size and fps through both readers; CAP_OPENCV_MJPEG's
    frames are the decode of cv2's JPEG encode of each frame."""
    frames = smooth_frames(5, 120, 160, 4)
    path = write_port_clip(str(tmp_path / "p.avi"), frames, fps)
    want = [cv2.imdecode(cv2.imencode(".jpg", f)[1], cv2.IMREAD_COLOR)
            for f in frames]
    for api in (cv2.CAP_FFMPEG, cv2.CAP_OPENCV_MJPEG):
        got, got_fps, count = cv2_frames(path, api)
        assert (got_fps, count, len(got)) == (fps, 5, 5), api
        assert got[0].shape == (120, 160, 3)
        if api == cv2.CAP_OPENCV_MJPEG:
            assert_same_frames(got, want)
    assert_same_frames(list(V.VideoReader(path).frames()), want)


def test_writer_continues_as_opendml_past_the_limit(tmp_path, monkeypatch):
    """Past AVI_RIFF_LIMIT bytes the writer opens RIFF 'AVIX' parts: cv2's
    FFmpeg reader reads every frame through the OpenDML indexes, cv2's MJPEG
    reader (idx1 only) the first part's, and the port's reader every
    frame."""
    monkeypatch.setattr(V, "AVI_RIFF_LIMIT", 25000)
    frames = smooth_frames(12, 120, 160, 5)
    path = str(tmp_path / "long.avi")
    with V.VideoWriter(path, 25, (160, 120)) as w:
        for f in frames:
            w.write(f)
    data = open(path, "rb").read()
    assert data.count(b"AVIX") >= 2 and b"indx" in data and b"odml" in data
    want = [N.decode_jpeg_bgr(N.encode_jpeg_bgr(f)) for f in frames]
    ff, fps, count = cv2_frames(path, cv2.CAP_FFMPEG)
    assert (len(ff), count, fps) == (12, 12, 25.0)
    first, _, _ = cv2_frames(path, cv2.CAP_OPENCV_MJPEG)
    assert 0 < len(first) < 12
    assert_same_frames(first, want[:len(first)])
    assert_same_frames(list(V.VideoReader(path).frames()), want)


def test_writer_refuses_other_outputs_before_any_work(tmp_path):
    for name in ("out.mp4", "out.avi.tmp", "out"):
        with pytest.raises(ValueError, match="Motion-JPEG in an AVI"):
            V.VideoWriter(str(tmp_path / name), 25, (64, 64))
        assert not (tmp_path / name).exists()
    with V.VideoWriter(str(tmp_path / "a.AVI"), 25, (64, 48)) as w:
        with pytest.raises(ValueError, match="expected a uint8 frame"):
            w.write(np.zeros((64, 64, 3), np.uint8))


# ---------------- inference_vid against the JAX package ----------------


@pytest.fixture(scope="module")
def y5s():
    """(JAX, port) yolov5s + age/gender engines on the golden weights."""
    v, ag = _load("golden_yolov5s_ckpt"), _load("golden_ag_ckpt")
    jeng = JFaceEngine(JEngineConfig(detector="yolov5s", det_thres=0.5,
                                     with_age_gender=True))
    jeng.variables, jeng.ag_vars = v, (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(detector="yolov5s", det_thres=0.5,
                                   with_age_gender=True), device="cpu")
    teng.load_state_dict(yolov5_face_state_dict(v, "yolov5s"))
    teng.load_age_gender_state_dict(age_gender_state_dict(ag["age"],
                                                          ag["gender"]))
    return jeng, teng


def assert_same_posts(got, ref, labels=False):
    assert len(got) == len(ref)
    for i, (p, r) in enumerate(zip(got, ref)):
        assert len(p.boxes) == len(r.boxes), i
        np.testing.assert_allclose(p.boxes, r.boxes, atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(p.bbox_confs, r.bbox_confs, atol=CONF_TOL,
                                   rtol=0)
        if labels:
            assert list(p.bbox_labels) == list(r.bbox_labels), i


@pytest.mark.parametrize("age_gender", [False, True],
                         ids=["detect", "fused-age-gender"])
def test_inference_vid_matches_jax(y5s, tmp_path, pinned_reader,
                                   age_gender):
    """6 frames in blocks of 4 (a padded tail): per-frame boxes within 1 px,
    confidences within 1e-4, equal counts; with age_gender the fused route
    (one ensemble call a block) and equal labels. The written AVI holds the
    6 annotated frames once each, at the clip's fps."""
    jeng, teng = y5s
    clip = golden_clip(str(tmp_path / "clip.avi"))
    calls = []
    real = teng.detect_embed_classify_batch
    teng.detect_embed_classify_batch = lambda imgs, **kw: calls.append(
        (tuple(imgs.shape), kw)) or real(imgs, **kw)
    try:
        out = str(tmp_path / "out.avi")
        got = TI.inference_vid(teng, clip, output=out, display=False,
                               age_gender=age_gender, micro_batch=4)
    finally:
        del teng.detect_embed_classify_batch
    ref = JI.inference_vid(jeng, clip, display=False, age_gender=age_gender,
                           micro_batch=4)
    assert len(got) == 6
    assert all(len(p.boxes) == 3 for p in got)
    assert_same_posts(got, ref, labels=age_gender)
    assert calls == ([((4, 540, 720, 3), {"want_embed": False})] * 2
                     if age_gender else [])
    r = V.VideoReader(out)
    assert (n_chunks(out), r.fps, r.width, r.height) == (6, 25.0, 720, 540)
    drawn = list(r.frames())
    for i, frame in enumerate(V.VideoReader(clip).frames()):
        TI.annotate(frame, got[i])
        assert_same_frames([drawn[i]],
                           [N.decode_jpeg_bgr(N.encode_jpeg_bgr(frame))])


def test_inference_vid_staged_mtcnn_matches_jax(tmp_path, pinned_reader):
    """MTCNN with age/gender takes the staged per-frame route
    (detect_age_gender) in both packages: the same boxes and labels."""
    mt, ag = _load("golden_mtcnn_ckpt"), _load("golden_ag_ckpt")
    jeng = JFaceEngine(JEngineConfig(detector="mtcnn", det_thres=0.5,
                                     with_age_gender=True))
    jeng.variables, jeng.ag_vars = mt, (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5,
                                   with_age_gender=True), device="cpu")
    teng.load_state_dict(mtcnn_state_dict(mt))
    teng.load_age_gender_state_dict(age_gender_state_dict(ag["age"],
                                                          ag["gender"]))
    img = cv2.imread(IMG)
    clip = write_port_clip(str(tmp_path / "m.avi"), [
        img[195 + dy:315 + dy, 250 + dx:410 + dx] for dx, dy in SHIFTS[:3]],
        10)
    got = TI.inference_vid(teng, clip, display=False, age_gender=True)
    ref = JI.inference_vid(jeng, clip, display=False, age_gender=True)
    assert len(got) == 3 and sum(len(p.boxes) for p in got) >= 3
    assert_same_posts(got, ref, labels=True)


def test_inference_vid_refusals(y5s, tmp_path):
    _, teng = y5s
    clip = golden_clip(str(tmp_path / "c.avi"), n=1)
    with pytest.raises(RuntimeError, match="no display window"):
        TI.inference_vid(teng, clip)
    with pytest.raises(ValueError, match="Motion-JPEG in an AVI"):
        TI.inference_vid(teng, clip, output=str(tmp_path / "o.mp4"),
                         display=False)
    assert not (tmp_path / "o.mp4").exists()
    for cam in (0, "1"):
        with pytest.raises(NotImplementedError, match="no camera capture"):
            TI.inference_vid(teng, cam, display=False)
        with pytest.raises(NotImplementedError, match="no camera capture"):
            TI.inference_webcam(teng, cam)
    assert TI._default_micro_batch(torch.device("cpu")) == 4
    assert TI._default_micro_batch(torch.device("cuda")) == 32


def test_inference_vid_reader_error_is_raised(y5s, tmp_path, monkeypatch):
    """A decode failure in the reader thread reaches the caller; the loop
    returns (no hang)."""
    _, teng = y5s
    clip = golden_clip(str(tmp_path / "c.avi"), n=2)

    def boom(self):
        yield np.zeros((540, 720, 3), np.uint8)
        raise OSError("disk gone")

    monkeypatch.setattr(V.VideoReader, "frames", boom)
    with pytest.raises(OSError, match="disk gone"):
        TI.inference_vid(teng, clip, display=False, micro_batch=1)


# ---------------- the CLI ----------------


def _cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_cli_video_prints_what_the_jax_cli_prints(y5s, tmp_path,
                                                  pinned_reader):
    """detect_face -i clip.avi with the golden yolov5s .pt: the JAX CLI's
    '<n> frames, <m> detections' line, and the AVI written."""
    jeng, _ = y5s
    pt = str(tmp_path / "y5s.pt")
    torch.save(yolov5_face_state_dict(jeng.variables, "yolov5s"), pt)
    clip = golden_clip(str(tmp_path / "clip.avi"))
    args = ["-i", clip, "--md", "yolov5s", "--ckpt", pt, "--dt", "0.5",
            "-d", "cpu", "--no-display"]
    rc, text = _cli(main, args + ["-o", str(tmp_path / "o.avi")])
    jrc, jtext = _cli(jmain, args)
    assert rc == jrc == 0
    assert text.strip() == jtext.strip() == "6 frames, 18 detections"
    assert n_chunks(str(tmp_path / "o.avi")) == 6


def test_cli_blazeface_video_random_frames(tmp_path, capsys):
    """JAX tests/test_cli.py:39-53 in Motion-JPEG: 5 random 64x64 frames
    through blazeface-front give 5 results, and the written AVI 5 frames
    (the padded tail is not written twice)."""
    rng = np.random.RandomState(7)
    clip = write_port_clip(str(tmp_path / "clip.avi"), [
        rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
        for _ in range(5)], 5)
    out = str(tmp_path / "out.avi")
    assert main(["-i", clip, "--md", "blazeface-front", "--dt", "0.3",
                 "--no-display", "-o", out, "-d", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("5 frames, ")
    assert n_chunks(out) == 5
    assert len(cv2_frames(out, cv2.CAP_FFMPEG)[0]) == 5


def test_cli_video_refusals(tmp_path, capsys):
    mp4 = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 64))
    w.write(np.zeros((64, 64, 3), np.uint8))
    w.release()
    clip = write_port_clip(str(tmp_path / "c.avi"),
                           [np.zeros((64, 64, 3), np.uint8)], 5)
    for argv, why in (([mp4], "video sample entry 'mp4v'"),
                      ([clip, "-o", str(tmp_path / "o.mp4")],
                       "Motion-JPEG in an AVI"),
                      (["0"], "no camera capture")):
        assert main(["-i", *argv, "-d", "cpu", "--no-display",
                     "--md", "yolov5n"]) == 2
        assert why in capsys.readouterr().err


# ---------------- the dataset pipelines ----------------


def test_iter_media_frames_samples_as_jax(tmp_path, pinned_reader):
    """25 frames at 10 fps: one a second, [0, 10, 20], as JAX samples
    them (tests/test_pipelines.py:41-46), pixel for pixel; max_frames
    caps; a video of another codec raises ValueError."""
    frames = smooth_frames(25, 48, 64, 6)
    path = write_port_clip(str(tmp_path / "v.avi"), frames, 10)
    got = list(TD.iter_media_frames(TD.MediaItem("c", path, "video")))
    ref = list(JD.iter_media_frames(JD.MediaItem("c", path, "video")))
    assert [i for i, _ in got] == [i for i, _ in ref] == [0, 10, 20]
    assert_same_frames([f for _, f in got], [f for _, f in ref])
    assert [i for i, _ in TD.iter_media_frames(
        TD.MediaItem("c", path, "video"), max_frames=2)] == [0, 10]
    (tmp_path / "x.mp4").write_bytes(b"\0\0\0\x18ftypmp42")
    with pytest.raises(ValueError, match="x.mp4"):
        list(TD.iter_media_frames(TD.MediaItem("c", str(tmp_path / "x.mp4"),
                                               "video")))


KW = dict(detector="blazeface-front", det_thres=0.3, embedder="mobile_facenet",
          max_det=8)


@pytest.fixture(scope="module")
def blaze():
    """(JAX, port) blazeface-front + mobile_facenet on the golden weights."""
    bl, emb = _load("golden_blaze_ckpt"), _load("golden_embed_ckpt")
    jeng = JFaceEngine(JEngineConfig(**KW))
    jeng.variables, jeng.embed_vars = bl, emb
    teng = FaceEngine(EngineConfig(**KW), device="cpu")
    teng.load_state_dict(blazeface_state_dict(bl, False))
    teng.load_embed_state_dict(mobile_facenet_state_dict(emb))
    return jeng, teng


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """data/person/ holding one Motion-JPEG clip: 21 frames at 10 fps of a
    128x128 window of the golden image sliding right, so frames 0, 10 and
    20 are sampled."""
    root = tmp_path_factory.mktemp("video") / "data"
    (root / "person").mkdir(parents=True)
    img = cv2.imread(IMG)
    write_port_clip(str(root / "person" / "walk.avi"), [
        cv2.resize(img[60:460, 100 + 2 * i:500 + 2 * i], (128, 128))
        for i in range(21)], 10)
    return root


def test_extract_faces_on_a_video_matches_jax(blaze, video_tree, tmp_path,
                                              pinned_reader):
    """One video item: the [45, D] .npy of its 3 sampled frames equal to
    the JAX package's within EMB_TOL, and the same crop files."""
    jeng, teng = blaze
    kw = dict(num_workers=2, block_size=4)
    jstats = JX.extract_faces_from_dataset(jeng, str(video_tree),
                                           str(tmp_path / "jax"), **kw)
    tstats = TX.extract_faces_from_dataset(teng, str(video_tree),
                                           str(tmp_path / "port"), **kw)
    assert tstats.classes == jstats.classes and not tstats.failed
    assert tstats.classes["person"]["media"] == 1
    assert tstats.total_faces() >= 3
    got = np.load(tmp_path / "port" / "person" / "walk.npy")
    assert got.shape == (45, 512)
    np.testing.assert_allclose(
        got, np.load(tmp_path / "jax" / "person" / "walk.npy"),
        atol=EMB_TOL, rtol=0)
    assert sorted(os.listdir(tmp_path / "port" / "person" / "walk")) == \
        sorted(os.listdir(tmp_path / "jax" / "person" / "walk"))


def test_tracking_on_a_video_matches_jax(blaze, video_tree, tmp_path,
                                         pinned_reader):
    """extract_and_label_faces tracks a video's sampled frames: the same
    face ids and boxes (1 px) as the JAX tracker, one track a face."""
    jeng, teng = blaze
    jann = JT.extract_and_label_faces(jeng, str(video_tree),
                                      str(tmp_path / "jax"), num_workers=1)
    tann = TT.extract_and_label_faces(teng, str(video_tree),
                                      str(tmp_path / "port"), num_workers=1)
    assert sorted(tann) == sorted(jann) and len(tann) == 1
    (key, got), = tann.items()
    assert got["face_ids"] == jann[key]["face_ids"]
    assert len(got["face_ids"]) >= 3
    assert len(set(got["face_ids"])) < len(got["face_ids"])  # tracked
    np.testing.assert_allclose(got["boxes"], jann[key]["boxes"], atol=1,
                               rtol=0)
