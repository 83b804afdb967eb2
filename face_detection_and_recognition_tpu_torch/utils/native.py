"""Image I/O without cv2: JPEG decode and encode through a small C++ library
of the port's own, bound with ``ctypes``.

The counterpart of ``utils/native.py`` in the JAX package and of the cv2
calls its entry points make (``cv2.imread``, ``cv2.imdecode(...,
IMREAD_COLOR)``, ``cv2.imwrite``, ``cv2.imencode``), for JPEG files. Images
are BGR uint8 HWC numpy arrays, as cv2 gives them; a grayscale JPEG comes
back with three equal channels.

**One route, fixed when the library is built**, the first of these that the
machine has:

- ``libjpeg``: ``csrc/jpeg_libjpeg.cpp`` (the port's own copy of the JAX
  package's libjpeg decoder, with a compressor added), when libjpeg's
  ``jpeglib.h`` is installed; its pixels are libjpeg's, as cv2's are;
- ``nvjpeg``: ``csrc/jpeg_nvjpeg.cpp``, nvJPEG from the CUDA toolkit
  (``nvjpeg.h`` beside ``nvcc``), which decodes and encodes on the card;
  the decoded chroma is upsampled and converted to BGR on the host by
  libjpeg's own arithmetic (``csrc/jpeg_ycc.h``), so its pixels are
  libjpeg's up to nvJPEG's IDCT.

Neither present raises an error naming both. The library is built on first
use by the host compiler into ``build/fdr_io_<route>_<hash>.so`` at the
repository root; the name carries the route and a hash of the source and
the flags, so a later process finds it built. A file the route cannot
decode gives ``None``, as cv2 does; no call switches to another route or to
another library.

Formats: JPEG in and out. Any other extension raises ``ValueError``; PNG
and video are not supported yet.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
JPEG_EXTENSIONS = (".jpg", ".jpeg")
INCLUDE_DIRS = ("/usr/include", "/usr/local/include")
# -O3 with SSE4 (x86-64-v2, every x86 server CPU of the last decade)
# vectorizes the nvjpeg route's chroma upsampling and color conversion
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall") + (
    ("-march=x86-64-v2",) if platform.machine() == "x86_64" else ())

# the fdr_jpeg_* return codes: -1 and -2 mean the bytes are not a JPEG the
# route decodes (the caller gets None); -3 and -4 a failure of the device
_UNREADABLE = (-1, -2)

_LIB = []           # the loaded library, once built
_LOCK = threading.Lock()


def _cuda_home() -> Optional[Path]:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return Path(nvcc).resolve().parent.parent
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "include").is_dir():
            return Path(root)
    return None


def find_route() -> Tuple[str, list]:
    """(route, compiler arguments after the source) for this machine: the
    first route whose header is installed. Raises when there is none."""
    for inc in INCLUDE_DIRS:
        if Path(inc, "jpeglib.h").is_file():
            return "libjpeg", ["-ljpeg"]
    cuda = _cuda_home()
    if cuda is not None and Path(cuda, "include", "nvjpeg.h").is_file():
        lib = cuda / "lib64"
        return "nvjpeg", [f"-I{cuda / 'include'}", f"-L{lib}", "-lnvjpeg",
                          "-lcudart_static", "-ldl", "-lrt", "-lpthread",
                          f"-Wl,-rpath,{lib}"]
    raise RuntimeError(
        "no JPEG route on this machine: libjpeg's jpeglib.h (route libjpeg) "
        f"is in none of {list(INCLUDE_DIRS)}, and the CUDA toolkit's "
        "nvjpeg.h (route nvjpeg) was not found beside nvcc, under "
        "CUDA_HOME or under /usr/local/cuda")


def _cxx() -> str:
    for name in ("g++", "c++"):
        if shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler (g++ or c++): the JPEG library "
                       "cannot be built")


def library_path(route: str, link: list) -> Path:
    """Where the library of ``route`` for the current sources (the route's
    ``.cpp`` and the headers beside it) and flags lives."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *link)).encode())
    for src in [CSRC / f"jpeg_{route}.cpp", *sorted(CSRC.glob("jpeg_*.h"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"fdr_io_{route}_{h.hexdigest()[:16]}.so"


def build_library() -> Tuple[str, Path]:
    """Build the JPEG library of this machine's route unless it is built.
    Returns (route, path)."""
    route, link = find_route()
    out = library_path(route, link)
    if out.is_file():
        return route, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_cxx(), *CXX_FLAGS, str(CSRC / f"jpeg_{route}.cpp"), "-o", tmp,
               *link]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the {route} JPEG library failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return route, out


def _lib() -> ctypes.CDLL:
    """The bound library, built and bound once: the first caller builds
    under the lock (request threads call in concurrently), and every later
    one finds it."""
    if _LIB:
        return _LIB[0]
    with _LOCK:
        if not _LIB:
            _LIB.append(_bind(build_library()[1]))
    return _LIB[0]


def _bind(path: Path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.fdr_jpeg_route.argtypes = []
    lib.fdr_jpeg_route.restype = ctypes.c_char_p
    lib.fdr_jpeg_info.argtypes = [ctypes.c_char_p, sz, ip, ip]
    lib.fdr_jpeg_info.restype = i
    lib.fdr_jpeg_decode_bgr.argtypes = [ctypes.c_char_p, sz, p, i, i]
    lib.fdr_jpeg_decode_bgr.restype = i
    lib.fdr_jpeg_encode_bgr.argtypes = [p, i, i, i,
                                        ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.POINTER(sz)]
    lib.fdr_jpeg_encode_bgr.restype = i
    lib.fdr_jpeg_free.argtypes = [p]
    lib.fdr_jpeg_free.restype = None
    return lib


def io_route() -> str:
    """The route the library was built with: "libjpeg" or "nvjpeg"."""
    return _lib().fdr_jpeg_route().decode()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"JPEG {what} failed on the {io_route()} route "
                           f"(code {rc})")


def decode_jpeg_bgr(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> BGR uint8 [H, W, 3]; None when the bytes are not a JPEG
    the route decodes (empty, garbage, an unsupported color space such as
    CMYK, a truncated or corrupt file on the libjpeg route), as
    ``cv2.imdecode`` returns None."""
    data = bytes(data)
    if not data:
        return None
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.fdr_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc in _UNREADABLE:
        return None
    _check(rc, "header read")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.fdr_jpeg_decode_bgr(data, len(data), out.ctypes.data, w.value,
                                 h.value)
    if rc in _UNREADABLE:
        return None
    _check(rc, "decode")
    return out


def encode_jpeg_bgr(img: np.ndarray, quality: int = 95) -> bytes:
    """BGR uint8 [H, W, 3] -> baseline JPEG bytes at ``quality`` with 4:2:0
    chroma (``cv2.imencode(".jpg", img)``'s defaults)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a BGR uint8 [H, W, 3] image, got "
                         f"{img.dtype} {img.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in [1, 100], got {quality}")
    lib = _lib()
    ptr, n = ctypes.c_void_p(), ctypes.c_size_t()
    h, w = img.shape[:2]
    _check(lib.fdr_jpeg_encode_bgr(img.ctypes.data, w, h, int(quality),
                                   ctypes.byref(ptr), ctypes.byref(n)),
           "encode")
    try:
        return ctypes.string_at(ptr.value, n.value)
    finally:
        lib.fdr_jpeg_free(ptr)


def _require_jpeg(path: str) -> None:
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in JPEG_EXTENSIONS:
        raise ValueError(f"{path}: only JPEG files (.jpg, .jpeg) are read "
                         "and written; PNG and other formats are not "
                         "supported yet")


def read_image_bgr(path: str) -> Optional[np.ndarray]:
    """The ``cv2.imread`` slot for JPEG files: BGR uint8 [H, W, 3], or None
    when the file is missing or does not decode. Other extensions raise
    ``ValueError``."""
    _require_jpeg(path)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_jpeg_bgr(data)


def write_image_bgr(path: str, img: np.ndarray, quality: int = 95) -> None:
    """The ``cv2.imwrite`` slot for JPEG files. Other extensions raise
    ``ValueError``."""
    _require_jpeg(path)
    data = encode_jpeg_bgr(img, quality)
    with open(path, "wb") as f:
        f.write(data)
