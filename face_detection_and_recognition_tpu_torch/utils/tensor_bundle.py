"""TensorFlow's TensorBundle (the variables of a SavedModel): a reader, and
a writer for fixtures, without TensorFlow.

The counterpart of ``utils/tensor_bundle.py`` in the JAX package. The
reference's similar-face filter loads a keras FaceNet SavedModel
(``similar_face_filtering/filter_faces_using_reference.py:131``); its
weights live in ``variables/variables.index`` + ``variables.data-00000-of-N``.
The index is a LevelDB-style SSTable whose values are BundleEntryProto
records (dtype, shape, shard, offset, size), and the data shards are raw
little-endian tensor bytes. The protobuf wire helpers are the port's own
(``utils/model_formats``). Entries come back as (name, ndarray) in key
order; ``utils/weights.keras_bundle_stream`` orders them into the layer
stream that ``convert_facenet_keras`` pours into the port's FaceNet.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .model_formats import (_LEN, _VARINT, _len_field, _varint_field,
                            _write_varint, iter_fields)

_TABLE_MAGIC = 0xDB4775248B80FB57
# TF DataType enum -> numpy (the subset tensors actually use)
_TF_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
              6: np.int8, 7: "string", 9: np.int64, 10: np.bool_,
              14: "bfloat16", 19: np.float16}


def _read_varint64(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


# ---------------------------------------------------------------------------
# SSTable block / footer plumbing
# ---------------------------------------------------------------------------

def _parse_block(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode one table block into (key, value) pairs (prefix-compressed
    entries + restart array)."""
    if len(data) < 4:
        return []
    n_restarts = struct.unpack("<I", data[-4:])[0]
    end = len(data) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    out: List[Tuple[bytes, bytes]] = []
    while pos < end:
        shared, pos = _read_varint64(data, pos)
        unshared, pos = _read_varint64(data, pos)
        vlen, pos = _read_varint64(data, pos)
        key = key[:shared] + data[pos:pos + unshared]
        pos += unshared
        out.append((key, data[pos:pos + vlen]))
        pos += vlen
    return out


def _read_block(buf: bytes, offset: int, size: int) -> bytes:
    """Read a block given its handle; trailer = 1-byte compression type +
    4-byte masked crc32c. Type 0 = raw, 1 = snappy (rejected explicitly)."""
    raw = buf[offset:offset + size]
    ctype = buf[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:
        try:
            import snappy  # pragma: no cover

            return snappy.uncompress(raw)
        except ImportError as e:
            raise ValueError("snappy-compressed bundle index "
                             "(install python-snappy)") from e
    raise ValueError(f"unknown block compression {ctype}")


def _parse_footer(buf: bytes) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    footer = buf[-48:]
    magic = struct.unpack("<Q", footer[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError("not a TensorBundle index (bad table magic)")
    pos = 0
    meta_off, pos = _read_varint64(footer, pos)
    meta_sz, pos = _read_varint64(footer, pos)
    idx_off, pos = _read_varint64(footer, pos)
    idx_sz, pos = _read_varint64(footer, pos)
    return (meta_off, meta_sz), (idx_off, idx_sz)


# ---------------------------------------------------------------------------
# BundleEntryProto
# ---------------------------------------------------------------------------

def _parse_bundle_entry(buf: bytes) -> Dict[str, object]:
    """BundleEntryProto: dtype=1, shape=2 (TensorShapeProto), shard_id=3,
    offset=4, size=5, crc32c=6 (fixed32)."""
    out: Dict[str, object] = {"dtype": 1, "shape": [], "shard": 0,
                              "offset": 0, "size": 0}
    for f, w, v in iter_fields(buf):
        if f == 1 and w == _VARINT:
            out["dtype"] = v
        elif f == 2 and w == _LEN:
            dims: List[int] = []
            for f2, w2, v2 in iter_fields(v):
                if f2 == 2 and w2 == _LEN:  # dim
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == _VARINT:
                            dims.append(v3)
            out["shape"] = dims
        elif f == 3 and w == _VARINT:
            out["shard"] = v
        elif f == 4 and w == _VARINT:
            out["offset"] = v
        elif f == 5 and w == _VARINT:
            out["size"] = v
    return out


def read_tensor_bundle(prefix: str) -> List[Tuple[str, np.ndarray]]:
    """Read all tensors of a bundle. ``prefix`` is the path WITHOUT the
    ``.index`` suffix (e.g. ``<savedmodel>/variables/variables``). Returns
    [(name, array)] in index (sorted-key) order; string tensors skipped."""
    with open(prefix + ".index", "rb") as f:
        buf = f.read()
    (_, _), (idx_off, idx_sz) = _parse_footer(buf)
    index_block = _read_block(buf, idx_off, idx_sz)
    shards: Dict[int, bytes] = {}
    entries: List[Tuple[str, Dict[str, object]]] = []
    header: Optional[Dict[str, object]] = None
    for _, handle in _parse_block(index_block):
        pos = 0
        off, pos = _read_varint64(handle, pos)
        sz, pos = _read_varint64(handle, pos)
        for key, value in _parse_block(_read_block(buf, off, sz)):
            if key == b"":
                header = _parse_bundle_entry(value)  # BundleHeaderProto
                continue
            entries.append((key.decode("utf-8", "replace"),
                            _parse_bundle_entry(value)))
    n_shards = 1
    if header is not None:
        # BundleHeaderProto: num_shards=1 (varint) — same field slot as
        # dtype in the entry parser
        n_shards = max(int(header.get("dtype", 1)), 1)
    out: List[Tuple[str, np.ndarray]] = []
    for name, e in entries:
        dt = _TF_DTYPES.get(int(e["dtype"]))
        if dt in (None, "string"):
            continue
        shard = int(e["shard"])
        if shard not in shards:
            data_path = f"{prefix}.data-{shard:05d}-of-{n_shards:05d}"
            with open(data_path, "rb") as f:
                shards[shard] = f.read()
        raw = shards[shard][int(e["offset"]):int(e["offset"]) + int(e["size"])]
        if dt == "bfloat16":
            u16 = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = u16.view(np.float32).copy()
        else:
            arr = np.frombuffer(raw, np.dtype(dt).newbyteorder("<")).copy()
        shape = [int(d) for d in e["shape"]]
        if int(np.prod(shape)) == arr.size:  # empty shape = rank-0 scalar
            arr = arr.reshape(shape)
        out.append((name, arr))
    return out


# ---------------------------------------------------------------------------
# writer (round-trip fixtures)
# ---------------------------------------------------------------------------

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven — the checksum the TF table
    format uses on every block."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _crc32c_masked(data: bytes) -> int:
    """TF/LevelDB masked crc: rotate right 15 and add a constant, so crcs
    of crc-bearing data don't look like valid crcs."""
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _write_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """Encode entries (sorted keys) with restart_interval=1 (no prefix
    sharing — simplest valid encoding)."""
    body = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(body))
        body += _write_varint(0)          # shared
        body += _write_varint(len(key))   # unshared
        body += _write_varint(len(value))
        body += key + value
    for r in restarts:
        body += struct.pack("<I", r)
    body += struct.pack("<I", len(restarts))
    return bytes(body)


def _encode_bundle_entry(dtype_code: int, shape, shard: int, offset: int,
                         size: int, crc: int = 0) -> bytes:
    shape_payload = b"".join(
        _len_field(2, _varint_field(1, int(d))) for d in shape)
    return (_varint_field(1, dtype_code) + _len_field(2, shape_payload)
            + _varint_field(3, shard) + _varint_field(4, offset)
            + _varint_field(5, size)
            + _write_varint((6 << 3) | 5) + struct.pack("<I", crc))


def write_tensor_bundle(prefix: str,
                        tensors: List[Tuple[str, np.ndarray]]) -> None:
    """Write a single-shard bundle our reader (and TF) can load."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    inv_dtypes = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
                  np.dtype(np.int32): 3, np.dtype(np.int64): 9,
                  np.dtype(np.float16): 19, np.dtype(np.bool_): 10}
    data = bytearray()
    entries: List[Tuple[bytes, bytes]] = []
    # header entry (key "") — BundleHeaderProto num_shards=1
    entries.append((b"", _varint_field(1, 1)))
    for name, arr in sorted(tensors, key=lambda kv: kv[0]):
        arr = np.asarray(arr)
        shape = arr.shape  # ascontiguousarray promotes 0-d to 1-d
        code = inv_dtypes[np.dtype(arr.dtype)]
        raw = np.ascontiguousarray(arr).astype(
            arr.dtype.newbyteorder("<")).tobytes()
        entries.append((name.encode(), _encode_bundle_entry(
            code, shape, 0, len(data), len(raw), _crc32c_masked(raw))))
        data += raw
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))

    data_block = _write_block(entries)
    out = bytearray()
    out += data_block
    out.append(0)                                   # compression type raw
    out += struct.pack("<I", _crc32c_masked(data_block + b"\x00"))
    data_handle = _write_varint(0) + _write_varint(len(data_block))

    # index block: one entry pointing at the data block
    last_key = entries[-1][0]
    index_block = _write_block([(last_key + b"\x00", data_handle)])
    idx_off = len(out)
    out += index_block
    out.append(0)
    out += struct.pack("<I", _crc32c_masked(index_block + b"\x00"))

    # empty metaindex block
    meta_block = _write_block([])
    meta_off = len(out)
    out += meta_block
    out.append(0)
    out += struct.pack("<I", _crc32c_masked(meta_block + b"\x00"))

    footer = bytearray()
    footer += _write_varint(meta_off) + _write_varint(len(meta_block))
    footer += _write_varint(idx_off) + _write_varint(len(index_block))
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(prefix + ".index", "wb") as f:
        f.write(bytes(out))
