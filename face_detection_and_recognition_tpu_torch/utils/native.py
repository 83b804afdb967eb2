"""Image I/O without cv2: JPEG decode and encode through the port's own
codec (``csrc/jpeg_codec.cpp``), bound with ``ctypes``, and PNG and BMP
decode.

The counterpart of ``utils/native.py`` in the JAX package and of the cv2
calls its entry points make (``cv2.imread``, ``cv2.imdecode(...,
IMREAD_COLOR)``, ``cv2.imwrite``, ``cv2.imencode``). Images are BGR uint8
HWC numpy arrays, as cv2 gives them; a grayscale file comes back with three
equal channels.

**JPEG: one codec, the same on every machine.** ``csrc/jpeg_codec.cpp``
computes what libjpeg-turbo computes with cv2's settings: the decoder
(baseline, extended-sequential and progressive Huffman files, restart
intervals, gray and any integral chroma sampling; a sequential file
without Huffman tables, as Motion-JPEG frames are written, takes the
standard ones, as libjpeg-turbo does) runs the JDCT_ISLOW integer IDCT and
finishes with libjpeg's fancy upsampling and colour tables
(``csrc/jpeg_ycc.h``), so its pixels are cv2's; the encoder writes
``cv2.imencode(".jpg", img)``'s bytes (quality 95 by default, 4:2:0, the
standard Huffman tables), one component for a gray image. It needs no
libjpeg and runs on the host, so the CPU tests hold exactly what runs
beside the card. It is built on first use by the host compiler into
``build/fdr_jpeg_<hash>.so`` at the repository root (the hash covers the
sources and the flags, so a later process finds it built); a failed build
raises, naming the compiler and the source. A file that is not a whole JPEG
(empty, garbage, truncated, corrupt, CMYK) gives ``None``, as cv2 does;
arithmetic-coded, lossless, hierarchical and 12-bit files, and progressive
ones whose scans leave coefficients unrefined (libjpeg would smooth them),
raise ``ValueError`` naming the variant. No call switches to another codec
or library.

**PNG and BMP** (read only), as ``cv2.imread(path, IMREAD_COLOR)`` reads
them, bit for bit: PNG of 8 or 16 bits in gray, gray + alpha, RGB and RGBA
(inflated with ``zlib``, unfiltered by ``csrc/png_unfilter.cpp``, built
like the JPEG library into ``build/fdr_png_<hash>.so``; 16-bit samples keep
their high byte and alpha is dropped, as cv2 does), and uncompressed 24-
and 32-bit BMP, bottom-up or top-down. Palette, interlaced and 1/2/4-bit
PNG, other BMP variants and WebP raise ``ValueError`` naming the variant; a
corrupt or truncated file gives ``None``.

``read_image_bgr`` reads JPEG files unless the caller names more formats:
``detect_face`` and serving take JPEG, the dataset pipelines
``IMAGE_EXTENSIONS``. ``write_image_bgr`` writes JPEG only. Video
(Motion-JPEG AVI, each frame a JPEG of this codec) is ``utils/video.py``'s.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
JPEG_EXTENSIONS = (".jpg", ".jpeg")
# what the dataset pipelines read (the JAX walker's list less WebP)
IMAGE_EXTENSIONS = JPEG_EXTENSIONS + (".png", ".bmp")
# the host compilers tried, in order
CXX = ("g++", "c++")
# -O3 with SSE4 (x86-64-v2, every x86 server CPU of the last decade)
# vectorizes the decoder's chroma upsampling and colour conversion
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall") + (
    ("-march=x86-64-v2",) if platform.machine() == "x86_64" else ())

# csrc/jpeg_codec.cpp's return codes: -1 and -2 mean the bytes are not a
# JPEG cv2 decodes to BGR (the caller gets None); the others name a variant
# the codec does not read
_UNREADABLE = (-1, -2)
_VARIANTS = {-11: "arithmetic-coded JPEG", -12: "lossless JPEG (SOF3)",
             -13: "hierarchical JPEG", -14: "12-bit JPEG",
             -15: "progressive JPEG whose scans leave coefficients "
                  "unrefined (libjpeg would smooth its blocks)"}

_LIB = []           # the loaded JPEG library, once built
_PNG_LIB = []       # the loaded PNG unfilter, once built
_LOCK = threading.Lock()


def _cxx(src: Path) -> str:
    for name in CXX:
        if shutil.which(name):
            return shutil.which(name)
    raise RuntimeError(f"no host C++ compiler ({' or '.join(CXX)}) to build "
                       f"{src}")


def _hashed_path(stem: str, sources, flags) -> Path:
    """``build/<stem>_<hash>.so``, the hash over ``flags`` and the sources'
    names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(src: Path, out: Path, link: Sequence[str], what: str) -> Path:
    """Build ``src`` into the shared library ``out`` with the host compiler
    unless it is built."""
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cxx = _cxx(src)
        cmd = [cxx, *CXX_FLAGS, str(src), "-o", tmp, *link]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the {what} from {src} with {cxx} "
                               f"failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path() -> Path:
    """Where the JPEG codec for the current sources (``jpeg_codec.cpp`` and
    the header beside it) and flags lives."""
    return _hashed_path("fdr_jpeg", [CSRC / "jpeg_codec.cpp",
                                     CSRC / "jpeg_ycc.h"], CXX_FLAGS)


def build_library() -> Path:
    """Build the JPEG codec unless it is built; returns its path."""
    return _compile(CSRC / "jpeg_codec.cpp", library_path(), (),
                    "JPEG codec")


def png_library_path() -> Path:
    """Where the PNG unfilter library for the current source lives."""
    return _hashed_path("fdr_png", [CSRC / "png_unfilter.cpp"], CXX_FLAGS)


def build_png_library() -> Path:
    """Build ``csrc/png_unfilter.cpp`` unless it is built; returns its
    path."""
    return _compile(CSRC / "png_unfilter.cpp", png_library_path(), (),
                    "PNG unfilter library")


def _lib() -> ctypes.CDLL:
    """The bound library, built and bound once: the first caller builds
    under the lock (request threads call in concurrently), and every later
    one finds it."""
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(build_library()))
    return _LIB[0]


def _bind(path: Path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fdr_jpeg_info.argtypes = [ctypes.c_char_p, sz, ip, ip]
    lib.fdr_jpeg_info.restype = i
    lib.fdr_jpeg_decode_bgr.argtypes = [ctypes.c_char_p, sz, p, i, i]
    lib.fdr_jpeg_decode_bgr.restype = i
    lib.fdr_jpeg_encode.argtypes = [p, i, i, i, i,
                                    ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(sz)]
    lib.fdr_jpeg_encode.restype = i
    lib.fdr_jpeg_free.argtypes = [p]
    lib.fdr_jpeg_free.restype = None
    return lib


def _check(rc: int) -> None:
    if rc in _VARIANTS:
        raise ValueError(f"{_VARIANTS[rc]} is not supported")
    if rc != 0:
        raise RuntimeError(f"JPEG decode failed (code {rc})")


def decode_jpeg_bgr(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> BGR uint8 [H, W, 3], cv2.imdecode's pixels; None when
    the bytes are not a whole JPEG (empty, garbage, truncated or corrupt, or
    CMYK), as ``cv2.imdecode`` returns None. The variants the codec does not
    read raise ``ValueError`` naming them."""
    data = bytes(data)
    if not data:
        return None
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.fdr_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc in _UNREADABLE:
        return None
    _check(rc)
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.fdr_jpeg_decode_bgr(data, len(data), out.ctypes.data, w.value,
                                 h.value)
    if rc in _UNREADABLE:
        return None
    _check(rc)
    return out


def encode_jpeg_bgr(img: np.ndarray, quality: int = 95) -> bytes:
    """BGR uint8 [H, W, 3] or gray uint8 [H, W] -> ``cv2.imencode(".jpg",
    img, [IMWRITE_JPEG_QUALITY, quality])``'s bytes: baseline, 4:2:0 chroma
    (one component for gray)."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)) or 0 in img.shape:
        raise ValueError(f"expected a BGR uint8 [H, W, 3] or gray [H, W] "
                         f"image, got {img.dtype} {img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [1, 100], got {quality}")
    lib = _lib()
    ptr, n = ctypes.c_void_p(), ctypes.c_size_t()
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    if lib.fdr_jpeg_encode(img.ctypes.data, w, h, channels, int(quality),
                           ctypes.byref(ptr), ctypes.byref(n)) != 0:
        raise ValueError(f"cannot encode a {w}x{h} image as JPEG (each side "
                         "must be 1-65535)")
    try:
        return ctypes.string_at(ptr.value, n.value)
    finally:
        lib.fdr_jpeg_free(ptr)


def _png_lib() -> ctypes.CDLL:
    """The bound PNG unfilter, built and bound once (loader threads call
    in concurrently)."""
    if _PNG_LIB:
        return _PNG_LIB[0]
    with _LOCK:
        if not _PNG_LIB:
            lib = ctypes.CDLL(str(build_png_library()))
            lib.fdr_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_long,
                                             ctypes.c_int]
            lib.fdr_png_unfilter.restype = ctypes.c_int
            _PNG_LIB.append(lib)
    return _PNG_LIB[0]


def png_unfilter(raw: bytes, height: int, rowbytes: int, bpp: int
                 ) -> Optional[np.ndarray]:
    """PNG's filtered scanlines (``height`` rows of a filter-type byte and
    ``rowbytes`` bytes) -> the unfiltered [height, rowbytes] uint8 rows,
    through ``csrc/png_unfilter.cpp``; None on a filter type outside 0-4."""
    out = np.empty((height, rowbytes), np.uint8)
    rc = _png_lib().fdr_png_unfilter(raw, out.ctypes.data, height, rowbytes,
                                     bpp)
    return None if rc else out


def png_unfilter_plain(raw: bytes, height: int, rowbytes: int, bpp: int
                       ) -> Optional[np.ndarray]:
    """``png_unfilter`` in numpy, byte by byte where a filter reads the
    byte to its left: the compiled one's plain version, for the tests."""
    rows = np.frombuffer(raw, np.uint8, height * (rowbytes + 1)).reshape(
        height, rowbytes + 1).astype(np.int64)
    out = np.zeros((height, rowbytes), np.int64)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        kind, src = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = src
        elif kind == 2:
            out[y] = (src + prev) & 255
        elif kind in (1, 3, 4):
            row = out[y]
            for i in range(rowbytes):
                a = row[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                b = prev[i]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                row[i] = (src[i] + pred) & 255
        else:
            return None
        prev = out[y]
    return out.astype(np.uint8)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples a pixel (type 3, palette, is not read)
_PNG_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def decode_png_bgr(data: bytes, unfilter=png_unfilter
                   ) -> Optional[np.ndarray]:
    """PNG bytes -> BGR uint8 [H, W, 3], as ``cv2.imdecode(...,
    IMREAD_COLOR)`` gives them: gray is repeated into three channels, alpha
    is dropped, a 16-bit sample keeps its high byte. None when the bytes are
    not a whole PNG (a bad signature, chunk or CRC, a truncated or corrupt
    stream). Palette, interlaced and 1/2/4-bit files raise ``ValueError``.
    ``unfilter``: ``png_unfilter`` or its plain version."""
    data = bytes(data)
    if not data.startswith(PNG_SIGNATURE):
        return None
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 12 > len(data):
            return None  # no IEND: truncated
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or zlib.crc32(kind + body) != int.from_bytes(crc,
                                                                     "big"):
            return None
        pos += 12 + n
        if kind == b"IHDR" and n == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        return None
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        raise ValueError("palette PNG (color type 3) is not supported")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if ctype in _PNG_SAMPLES and depth in (1, 2, 4):
        raise ValueError(f"{depth}-bit PNG is not supported")
    if ctype not in _PNG_SAMPLES or depth not in (8, 16) or comp or filt \
            or not (w and h):
        return None
    ch, nbytes = _PNG_SAMPLES[ctype], depth // 8
    rowbytes = w * ch * nbytes
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    if len(raw) < h * (rowbytes + 1):
        return None
    rows = unfilter(raw, h, rowbytes, ch * nbytes)
    if rows is None:
        return None
    px = rows.reshape(h, w, ch, nbytes)[..., 0]  # big-endian: the high byte
    if ch <= 2:   # gray, gray + alpha
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR


def decode_bmp_bgr(data: bytes) -> Optional[np.ndarray]:
    """BMP bytes -> BGR uint8 [H, W, 3], as ``cv2.imdecode(...,
    IMREAD_COLOR)`` gives them, for uncompressed 24- and 32-bit files
    (BI_RGB, or BI_BITFIELDS with the BGRA masks), bottom-up or top-down;
    the fourth byte of a 32-bit pixel is dropped. None when the bytes are
    not a whole BMP; other bit depths and compressions raise
    ``ValueError``."""
    data = bytes(data)
    if len(data) < 26 or data[:2] != b"BM":
        return None
    offset, hsize = struct.unpack("<I I", data[10:18])
    if hsize == 12:   # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        comp = 0
    elif hsize >= 40 and len(data) >= 54:
        w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    else:
        return None
    if bits not in (24, 32):
        raise ValueError(f"{bits}-bit BMP is not supported (24- and 32-bit "
                         "only)")
    if comp == 3 and bits == 32:   # BI_BITFIELDS: masks after the 40 bytes
        masks = struct.unpack("<III", data[54:66]) if len(data) >= 66 else ()
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"BMP with channel masks {masks} is not "
                             "supported")
    elif comp != 0:
        raise ValueError(f"compressed BMP (compression {comp}) is not "
                         "supported")
    top_down, h = h < 0, abs(h)
    stride = (w * bits + 31) // 32 * 4
    if w <= 0 or h == 0 or offset + stride * h > len(data):
        return None
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(
        h, stride)[:, :w * bits // 8].reshape(h, w, bits // 8)[..., :3]
    return np.ascontiguousarray(rows if top_down else rows[::-1])


def decode_image_bgr(data: bytes) -> Optional[np.ndarray]:
    """Image bytes -> BGR uint8 [H, W, 3] by their content, as
    ``cv2.imdecode`` picks its decoder: JPEG, PNG or BMP. None for bytes
    none of them decodes; WebP raises ``ValueError``."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        return decode_png_bgr(data)
    if data.startswith(b"BM"):
        return decode_bmp_bgr(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise ValueError("WebP is not supported: the port has no WebP "
                         "decoder")
    return decode_jpeg_bgr(data)


def _require(path: str, formats: Sequence[str]) -> None:
    ext = os.path.splitext(str(path))[1].lower()
    if ext in formats:
        return
    if formats == JPEG_EXTENSIONS:
        raise ValueError(f"{path}: only JPEG files (.jpg, .jpeg) are read "
                         "and written here; PNG and other formats are not "
                         "supported by this entry point")
    if ext == ".webp":
        raise ValueError(f"{path}: WebP is not supported: the port has no "
                         "WebP decoder")
    raise ValueError(f"{path}: only {', '.join(formats)} files are read")


def read_image_bgr(path: str, formats: Sequence[str] = JPEG_EXTENSIONS
                   ) -> Optional[np.ndarray]:
    """The ``cv2.imread`` slot: BGR uint8 [H, W, 3], or None when the file
    is missing or does not decode. ``formats``: the extensions this call
    reads, JPEG by default, ``IMAGE_EXTENSIONS`` (JPEG, PNG, BMP) for the
    dataset pipelines; the bytes are decoded by their content, as cv2 does.
    Other extensions, and variants the decoders do not read (palette or
    interlaced PNG, WebP...), raise ``ValueError`` naming the file."""
    _require(path, formats)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        if formats == JPEG_EXTENSIONS:
            return decode_jpeg_bgr(data)
        return decode_image_bgr(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def write_image_bgr(path: str, img: np.ndarray, quality: int = 95) -> None:
    """The ``cv2.imwrite`` slot for JPEG files. Other extensions raise
    ``ValueError``."""
    _require(path, JPEG_EXTENSIONS)
    data = encode_jpeg_bgr(img, quality)
    with open(path, "wb") as f:
        f.write(data)
