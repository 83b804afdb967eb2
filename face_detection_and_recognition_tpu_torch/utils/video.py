"""Motion-JPEG AVI read and write: the port's ``cv2.VideoCapture`` and
``cv2.VideoWriter``.

The JAX package has no module of this name: it reads video with
``cv2.VideoCapture`` (``core/inference.py``, ``pipelines/dataset.py``) and
writes it with ``cv2.VideoWriter(..., "mp4v")``. The port imports no cv2
and no video library. It reads and writes Motion-JPEG in an AVI container:
each frame is one JPEG, decoded and encoded by the port's own codec
(``utils/native.py``), inside RIFF chunks that this module walks and
writes. Motion-JPEG is what UVC webcams, IP cameras and dashcams record.

**Reader** (``VideoReader``). It reads ``avih``, the first video stream's
``strh`` (``vids``; the fps is ``dwRate / dwScale``) and ``strf`` (a
BITMAPINFOHEADER whose compression is ``MJPG``), then walks the ``movi``
lists in file order: the stream's ``##dc`` / ``##db`` chunks are its
frames; audio, ``JUNK``, ``ix##`` and ``idx1`` chunks are skipped,
``LIST rec `` wrappers are entered, odd sizes are padded to even, and the
OpenDML ``RIFF AVIX`` parts after the first GiB are followed. ``chunks()``
hands out each frame's JPEG bytes without decoding them; ``frames()``
decodes them on ``DECODE_WORKERS`` threads (the codec's ctypes call
releases the GIL) and keeps their order, and ``frames(keep=...)`` decodes
only the frames a sampler keeps.
Frames are handled as ``cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)``
handles them: a zero-length chunk repeats the frame before it, and a chunk
that does not decode (or a zero-length first one) ends the video. A
truncated file gives the frames before the cut and ends. Any other codec
or container raises ``ValueError`` naming the file and what it holds: the
AVI's fourcc, or an MP4 / MOV file's video sample entry (``mp4v``,
``avc1``, ...). A missing file raises ``FileNotFoundError``.

**Writer** (``VideoWriter``). Motion-JPEG AVI, as FFmpeg's AVI muxer lays
it out: each frame a ``00dc`` chunk of ``native.encode_jpeg_bgr``'s bytes
(``cv2.imencode``'s at ``JPEG_QUALITY`` 95), encoded on
``ENCODE_WORKERS`` threads ahead of the file and in order, an ``idx1``
index for the first RIFF, and past ``AVI_RIFF_LIMIT`` bytes an OpenDML continuation (``RIFF AVIX``
parts, a standard index ``ix00`` in each ``movi``, the super index
``indx`` and the ``odml`` header in the space the first part reserves), so
that a long 576x1024 stream does not stop at the first GiB. An output path
that does not end in ``.avi`` raises ``ValueError`` before anything is
written.

Usage::

    r = VideoReader("clip.avi")
    with VideoWriter("out.avi", r.fps, (r.width, r.height)) as w:
        for frame in r.frames():            # BGR uint8 [H, W, 3]
            w.write(frame)
"""
from __future__ import annotations

import collections
import concurrent.futures
import fractions
import os
import struct
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from .native import decode_jpeg_bgr, encode_jpeg_bgr

# bytes of one RIFF part before the writer starts the next (FFmpeg's
# AVI_MAX_RIFF_SIZE); a test may set it small
AVI_RIFF_LIMIT = 1 << 30
# entries of the OpenDML super index the first part reserves (FFmpeg's
# AVI_MASTER_INDEX_SIZE): parts a file may have
SUPER_INDEX_ENTRIES = 256
# threads decoding a read video's frames and encoding a written one's: a
# 576x1024 frame's JPEG decode or encode takes longer than the card's
# detect of it
DECODE_WORKERS = 4
ENCODE_WORKERS = 4
JPEG_QUALITY = 95     # of each written frame
MJPEG_FOURCC = b"MJPG"
OUTPUT_EXTENSION = ".avi"

# avih flags: AVIF_HASINDEX | AVIF_ISINTERLEAVED | AVIF_TRUSTCKTYPE
_AVIH_FLAGS = 0x10 | 0x100 | 0x800
_KEYFRAME = 0x10      # idx1's AVIIF_KEYFRAME
# top-level box types that mark an ISO-BMFF (MP4 / MOV) file
_ISO_BOXES = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
              b"pnot", b"styp", b"moof")
_ISO_CONTAINERS = (b"moov", b"trak", b"mdia", b"minf", b"stbl")


def _fourcc(b: bytes) -> str:
    """A fourcc as text, for messages."""
    return b.decode("latin-1")


class VideoReader:
    """A Motion-JPEG AVI file: its geometry, fps and frames (the module's
    docstring says what is read)."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fps = 0.0
        self.width = self.height = 0
        self._movi: List[Tuple[int, int]] = []  # (start, end) of each movi
        with open(self.path, "rb") as f:
            self._size = os.fstat(f.fileno()).st_size
            self._parse(f)

    # ---------------- the headers ----------------

    def _refuse(self, what: str) -> ValueError:
        return ValueError(f"{self.path}: {what}; the port reads Motion-JPEG "
                          "(MJPG) in an AVI file only")

    def _parse(self, f) -> None:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise self._refuse(self._container(f, head))
        riff_end = self._end(0, struct.unpack("<I", head[4:8])[0])
        hdrl = None
        for fcc, pos, size, kind in self._children(f, 12, riff_end):
            if fcc == b"LIST" and kind == b"hdrl":
                hdrl = (pos + 12, self._end(pos, size))
            elif fcc == b"LIST" and kind == b"movi":
                self._movi.append((pos + 12, self._end(pos, size)))
        if hdrl is None:
            raise self._refuse("an AVI file with no 'hdrl' header list")
        self._stream = self._video_stream(f, *hdrl)
        # OpenDML: the 'RIFF AVIX' parts after the first
        pos = riff_end + (riff_end & 1)
        while pos + 12 <= self._size:
            f.seek(pos)
            fcc, size, kind = struct.unpack("<4sI4s", f.read(12))
            if fcc != b"RIFF" or kind != b"AVIX":
                break
            end = self._end(pos, size)
            for cfcc, cpos, csize, ckind in self._children(f, pos + 12, end):
                if cfcc == b"LIST" and ckind == b"movi":
                    self._movi.append((cpos + 12, self._end(cpos, csize)))
            pos = end + (end & 1)

    def _end(self, pos: int, size: int) -> int:
        """The end of the chunk at ``pos`` whose size field is ``size``,
        cut at the end of the file (a truncated or unfinished file); a
        size of 0 (a writer that never came back to it) reaches the end."""
        end = pos + 8 + size
        return self._size if size == 0 or end > self._size else end

    def _children(self, f, pos: int, end: int):
        """(fourcc, position, size, list type or b'') of each chunk in
        [pos, end)."""
        while pos + 8 <= end:
            f.seek(pos)
            fcc, size = struct.unpack("<4sI", f.read(8))
            kind = f.read(4) if fcc in (b"LIST", b"RIFF") else b""
            yield fcc, pos, size, kind
            pos += 8 + size + (size & 1)

    def _video_stream(self, f, start: int, end: int) -> bytes:
        """Reads the first video stream's headers; returns the two digits
        that name its chunks."""
        index = 0
        for fcc, pos, size, kind in self._children(f, start, end):
            if fcc != b"LIST" or kind != b"strl":
                continue
            strh = strf = None
            for cfcc, cpos, csize, _ in self._children(
                    f, pos + 12, self._end(pos, size)):
                if cfcc in (b"strh", b"strf"):
                    f.seek(cpos + 8)
                    body = f.read(csize)
                    if cfcc == b"strh":
                        strh = body
                    else:
                        strf = body
            if strh is not None and len(strh) >= 36 and strh[:4] == b"vids":
                if strf is None or len(strf) < 20:
                    raise self._refuse("an AVI video stream with no "
                                       "BITMAPINFOHEADER")
                compression = strf[16:20]
                if compression.upper() != MJPEG_FOURCC:
                    raise self._refuse(
                        f"an AVI file whose video is "
                        f"'{_fourcc(compression)}'")
                scale, rate = struct.unpack("<II", strh[20:28])
                self.fps = rate / scale if scale else 0.0
                w, h = struct.unpack("<ii", strf[4:12])
                self.width, self.height = w, abs(h)
                return b"%02d" % index
            index += 1
        raise self._refuse("an AVI file with no video stream")

    def _container(self, f, head: bytes) -> str:
        """What a file that is not an AVI holds, for the message."""
        if head[4:8] in _ISO_BOXES:
            entry = self._iso_video_entry(f)
            return ("an MP4/MOV file with " + (
                f"video sample entry '{_fourcc(entry)}'" if entry
                else "no video sample entry"))
        if head[:4] == b"\x1a\x45\xdf\xa3":
            return "a Matroska/WebM file"
        if head[:4] == b"RIFF":
            return f"a RIFF '{_fourcc(head[8:12])}' file"
        return f"not an AVI file (it starts {head[:8]!r})"

    def _iso_video_entry(self, f) -> Optional[bytes]:
        """The sample entry of the first video track of an ISO-BMFF file
        (``moov/trak/mdia/minf/stbl/stsd``), by a short walk of its boxes;
        None when there is none."""

        def boxes(pos, end):
            while pos + 8 <= end:
                f.seek(pos)
                size, kind = struct.unpack(">I4s", f.read(8))
                head = 8
                if size == 1:
                    size, head = struct.unpack(">Q", f.read(8))[0], 16
                elif size == 0:
                    size = end - pos
                if size < head:
                    return
                yield kind, pos + head, min(pos + size, end)
                pos += size

        def find(pos, end, handler=None):
            for kind, body, stop in boxes(pos, end):
                if kind == b"hdlr" and stop - body >= 12:
                    f.seek(body + 8)
                    handler = f.read(4)
                elif kind == b"stsd" and stop - body >= 16 and handler in (
                        None, b"vide"):
                    f.seek(body + 12)
                    return f.read(4)
                elif kind in _ISO_CONTAINERS:
                    found = find(body, stop, handler if kind != b"trak"
                                 else None)
                    if found:
                        return found
            return None

        return find(0, self._size)

    # ---------------- the frames ----------------

    def _frame_chunks(self, f) -> Iterator[Tuple[int, int]]:
        """(data position, size) of each frame chunk, in file order."""
        wanted = (self._stream + b"dc", self._stream + b"db")
        for pos, end in self._movi:
            while pos + 8 <= end:
                f.seek(pos)
                fcc, size = struct.unpack("<4sI", f.read(8))
                if fcc == b"LIST":
                    if f.read(4) == b"rec ":
                        pos += 12  # a wrapper: its chunks follow
                        continue
                elif fcc in wanted:
                    if pos + 8 + size > self._size:
                        return  # cut off: the video ends here
                    yield pos + 8, size
                pos += 8 + size + (size & 1)

    def chunks(self) -> Iterator[bytes]:
        """Each frame's JPEG bytes, in order, undecoded (b"" for a
        zero-length chunk)."""
        with open(self.path, "rb") as f:
            for pos, size in self._frame_chunks(f):
                f.seek(pos)
                yield f.read(size)

    def frames(self, keep: Optional[Callable[[int], bool]] = None
               ) -> Iterator[np.ndarray]:
        """The decoded frames, BGR uint8 [H, W, 3], in order, with
        ``DECODE_WORKERS`` threads decoding ahead of the caller (each frame
        a new array). A zero-length chunk repeats the frame before it; one
        that does not decode, or a zero-length first one, ends the video
        (``CAP_OPENCV_MJPEG``). ``keep``, given a frame's number, says
        whether to hand it out: only the kept frames are decoded (a
        sampler's), so a frame that is not kept cannot end the video."""
        pool = concurrent.futures.ThreadPoolExecutor(
            DECODE_WORKERS, thread_name_prefix="mjpeg-decode")
        window: collections.deque = collections.deque()
        chunks = self.chunks()

        def decoded():
            for n, data in enumerate(chunks):
                kept = keep is None or keep(n)
                window.append((data, kept,
                               pool.submit(_decode, data) if kept else None))
                if len(window) > 2 * DECODE_WORKERS:
                    yield _result(*window.popleft())
            while window:
                yield _result(*window.popleft())

        try:
            yield from _in_order(decoded())
        finally:
            for _, _, fut in window:
                if fut is not None:
                    fut.cancel()
            pool.shutdown(wait=True)
            chunks.close()


def _decode(data: bytes) -> Optional[np.ndarray]:
    """A chunk's frame; None for a zero-length chunk or one that does not
    decode."""
    return decode_jpeg_bgr(data) if data else None


def _result(data: bytes, kept: bool, fut) -> Tuple[bytes, bool, object]:
    return data, kept, fut.result() if kept else None


def _in_order(decoded) -> Iterator[np.ndarray]:
    """The kept frames from (chunk, kept, decoded frame) triples, as
    ``CAP_OPENCV_MJPEG`` hands them out: a zero-length chunk gives the
    frame before it again, decoded anew (the caller may have drawn on the
    one it was given); a kept chunk that gives no frame ends the video."""
    last = b""
    for data, kept, frame in decoded:
        if kept:
            if not data and last:
                frame = decode_jpeg_bgr(last)
            if frame is None:
                return
            yield frame
        last = data or last


# ---------------------------------------------------------------- writer


def check_output_path(path: str) -> None:
    """Raises ``ValueError`` unless ``path`` is one the writer writes."""
    if os.path.splitext(str(path))[1].lower() != OUTPUT_EXTENSION:
        raise ValueError(f"{path}: the port writes video as Motion-JPEG in "
                         f"an AVI file only: give the output a "
                         f"'{OUTPUT_EXTENSION}' name")


def _rate_scale(fps: float) -> Tuple[int, int]:
    """(dwRate, dwScale) of ``fps``: 29.97 -> 2997 / 100, 30000 / 1001 as
    itself."""
    if not (fps > 0 and np.isfinite(fps)):
        raise ValueError(f"fps must be positive, got {fps}")
    frac = fractions.Fraction(fps).limit_denominator(1001)
    return frac.numerator, frac.denominator


# the first part's layout (FFmpeg's): RIFF, LIST hdrl, avih, LIST strl,
# strh, strf, the super index's reserved space, the odml header's
_AVIH = 32                               # avih's data
_STRH = 108                              # strh's data
_INDX = 212                              # 'JUNK' that becomes 'indx'
_INDX_SIZE = 24 + 16 * SUPER_INDEX_ENTRIES
_ODML = _INDX + 8 + _INDX_SIZE           # 'JUNK' that becomes 'LIST odml'
_ODML_SIZE = 4 + 8 + 248
_MOVI = _ODML + 8 + _ODML_SIZE           # 'LIST' of the first movi


class VideoWriter:
    """Motion-JPEG AVI at ``fps`` of ``size`` = (width, height) frames (the
    module's docstring says what is written). ``write`` takes BGR uint8
    [H, W, 3] frames of that size (a copy is encoded: the caller may reuse
    the array); ``release`` (or leaving a ``with`` block) finishes the
    file."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        check_output_path(path)
        self.path = str(path)
        self.width, self.height = (int(v) for v in size)
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"frame size must be positive, got {size}")
        self.rate, self.scale = _rate_scale(float(fps))
        self.fps = self.rate / self.scale
        self.frames = 0
        self._max_chunk = 0
        self._parts: List[dict] = []   # each RIFF part: offsets, index
        self._opendml = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            ENCODE_WORKERS, thread_name_prefix="mjpeg-encode")
        self._encoding: collections.deque = collections.deque()
        self._f = open(self.path, "wb")
        self._f.write(self._headers())
        self._start_part(0, b"AVI ")

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _headers(self) -> bytes:
        """Everything before the first movi, the counts left 0."""
        w, h = self.width, self.height
        avih = struct.pack("<14I", round(1e6 * self.scale / self.rate), 0, 0,
                           _AVIH_FLAGS, 0, 0, 1, 0, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", MJPEG_FOURCC, 0,
                           0, 0, 0, self.scale, self.rate, 0, 0, 0,
                           0xFFFFFFFF, 0, 0, 0, min(w, 32767), min(h, 32767))
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, MJPEG_FOURCC,
                           w * h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
                + _chunk(b"JUNK", bytes(_INDX_SIZE)))
        odml = b"odml" + _chunk(b"dmlh", bytes(248))
        hdrl = (b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
                + _chunk(b"JUNK", odml))
        head = b"RIFF" + bytes(4) + b"AVI " + _chunk(b"LIST", hdrl)
        assert len(head) == _MOVI
        return head[:_MOVI]

    def _start_part(self, riff: int, kind: bytes) -> None:
        """Opens a RIFF part (at ``riff``; the first one's header is
        written already) and its movi list."""
        f = self._f
        if riff:
            f.write(b"RIFF" + bytes(4) + kind)
        movi = f.tell()
        f.write(b"LIST" + bytes(4) + b"movi")
        self._parts.append({"riff": riff, "movi": movi, "index": []})

    def write(self, frame: np.ndarray) -> None:
        """Appends one BGR uint8 [H, W, 3] frame of the writer's size."""
        if frame.shape != (self.height, self.width, 3) or \
                frame.dtype != np.uint8:
            raise ValueError(f"{self.path}: expected a uint8 frame of "
                             f"{(self.height, self.width, 3)}, got "
                             f"{frame.dtype} {frame.shape}")
        self._encoding.append(self._pool.submit(
            encode_jpeg_bgr, frame.copy(), JPEG_QUALITY))
        while len(self._encoding) > 2 * ENCODE_WORKERS:
            self._append(self._encoding.popleft().result())

    def _append(self, data: bytes) -> None:
        f, part = self._f, self._parts[-1]
        if part["index"] and f.tell() - part["riff"] > AVI_RIFF_LIMIT:
            part = self._next_part()
        pos = f.tell()
        part["index"].append((pos, len(data)))
        f.write(_chunk(b"00dc", data))
        self.frames += 1
        self._max_chunk = max(self._max_chunk, len(data))

    def _next_part(self) -> dict:
        """Ends the current RIFF part and starts an 'AVIX' one: the file
        becomes an OpenDML one."""
        if len(self._parts) >= SUPER_INDEX_ENTRIES:
            raise RuntimeError(f"{self.path}: more than "
                               f"{SUPER_INDEX_ENTRIES} RIFF parts")
        self._opendml = True
        self._end_part(self._parts[-1])
        self._start_part(self._f.tell(), b"AVIX")
        return self._parts[-1]

    def _end_part(self, part: dict) -> None:
        """Ends a RIFF part: its standard index ix00 in an OpenDML file,
        the end of its movi, the idx1 after the first part's, the end of
        the RIFF."""
        f = self._f
        if self._opendml:
            base = part["movi"] + 8  # the 'movi' fourcc
            ix = _chunk(b"ix00", struct.pack(
                "<HBBI4sQI", 2, 0, 1, len(part["index"]), b"00dc", base, 0)
                + b"".join(struct.pack("<II", pos + 8 - base, n)
                           for pos, n in part["index"]))
            part["ix"] = (f.tell(), len(ix))
            f.write(ix)
        _patch_size(f, part["movi"])
        if part is self._parts[0]:
            movi = part["movi"] + 8
            f.write(_chunk(b"idx1", b"".join(
                struct.pack("<4sIII", b"00dc", _KEYFRAME, pos - movi, n)
                for pos, n in part["index"])))
        _patch_size(f, part["riff"])

    def release(self) -> None:
        """Finishes the file: indexes, counts, sizes. Safe to call twice."""
        f = self._f
        if f is None:
            return
        try:
            while self._encoding:
                self._append(self._encoding.popleft().result())
            self._end_part(self._parts[-1])
            f.seek(_AVIH + 16)  # dwTotalFrames: the first part's
            f.write(struct.pack("<I", len(self._parts[0]["index"])))
            f.seek(_AVIH + 28)  # dwSuggestedBufferSize
            f.write(struct.pack("<I", self._max_chunk + 8))
            f.seek(_STRH + 32)  # dwLength, dwSuggestedBufferSize
            f.write(struct.pack("<II", self.frames, self._max_chunk + 8))
            if self._opendml:
                self._write_odml(f)
        finally:
            self._f = None
            f.close()
            for fut in self._encoding:
                fut.cancel()
            self._pool.shutdown(wait=True)

    def _write_odml(self, f) -> None:
        """The super index (``indx``) over the parts' ix00 chunks, and the
        ``LIST odml`` header with the total frame count."""
        body = struct.pack("<HBBI4s12x", 4, 0, 0, len(self._parts),
                           b"00dc") + b"".join(
            struct.pack("<QII", *part["ix"], len(part["index"]))
            for part in self._parts)
        f.seek(_INDX)
        f.write(_chunk(b"indx", body + bytes(_INDX_SIZE - len(body))))
        f.seek(_ODML)
        f.write(b"LIST")
        f.seek(_ODML + 8 + 4 + 8)
        f.write(struct.pack("<I", self.frames))


def _chunk(fcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk: fourcc, size, body, a pad byte after an odd size."""
    return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _patch_size(f, pos: int) -> None:
    """Sets the size field of the chunk or list at ``pos`` to reach the
    current end of the file, and returns there."""
    end = f.tell()
    f.seek(pos + 4)
    f.write(struct.pack("<I", end - pos - 8))
    f.seek(end)
