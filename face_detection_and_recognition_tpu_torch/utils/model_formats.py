"""Readers of the reference's protobuf weight files: the Caffe
``.caffemodel`` (NetParameter) and the frozen TensorFlow GraphDef ``.pb``.

The counterpart of ``utils/model_formats.py`` in the JAX package, readers
only: a minimal protobuf wire decoder (varints and length-delimited fields,
unknown fields skipped), ``read_caffemodel`` (V2 ``layer`` and legacy V1
``layers``) and ``read_tf_graphdef`` (every Const tensor, with half-precision
and negative-integer encodings). The JAX package's writers build the test
fixtures; its OpenVINO IR reader comes with the OpenVINO detectors. The
arrays come out in the files' own layouts; ``utils/weights.py`` maps them
onto the port's modules.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    LEN fields yield raw bytes; VARINT yields int; I32/I64 yield raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, val


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _signed64(v: int) -> int:
    """Protobuf int32/int64 fields encode negatives as 64-bit
    two's-complement varints (NOT zigzag — that is sint*)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Caffe NetParameter (.caffemodel)
# ---------------------------------------------------------------------------
# Field numbers from the public caffe.proto:
#   NetParameter:  name=1, layers(V1)=2, layer(V2)=100
#   LayerParameter:   name=1, type=2(string), blobs=7
#   V1LayerParameter: name=4, type=5(enum),  blobs=6
#   BlobProto: num=1 ch=2 h=3 w=4, data=5(packed float), shape=7
#   BlobShape: dim=1 (packed int64)


@dataclasses.dataclass
class CaffeLayer:
    name: str
    type: str
    blobs: List[np.ndarray]


def _parse_blob(buf: bytes) -> np.ndarray:
    shape: List[int] = []
    legacy = [0, 0, 0, 0]
    data = b""
    floats: List[float] = []
    for field, wire, val in iter_fields(buf):
        if field == 7 and wire == _LEN:           # shape
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    if w2 == _LEN:
                        shape.extend(_packed_varints(v2))
                    else:
                        shape.append(v2)
        elif field == 5:                           # data
            if wire == _LEN:                       # packed
                data += val
            else:                                  # unpacked single float
                floats.append(struct.unpack("<f", val)[0])
        elif field in (1, 2, 3, 4) and wire == _VARINT:  # legacy NCHW dims
            legacy[field - 1] = val
    if data:
        arr = np.frombuffer(data, "<f4").copy()
    else:
        arr = np.asarray(floats, np.float32)
    if not shape and any(legacy):
        shape = [d for d in legacy]
        # legacy blobs default unset dims to 1-ish; trust the element count
        while len(shape) > 1 and int(np.prod(shape)) != arr.size and shape[0] == 1:
            shape = shape[1:]
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


# caffe.proto V1LayerParameter.LayerType values we care about
_V1_TYPES = {4: "Convolution", 14: "InnerProduct", 17: "Pooling", 18: "ReLU",
             15: "LRN", 20: "Softmax", 5: "Data", 6: "Dropout"}


def _parse_layer(buf: bytes, v1: bool) -> CaffeLayer:
    name = ""
    ltype = ""
    blobs: List[np.ndarray] = []
    name_f, type_f, blob_f = (4, 5, 6) if v1 else (1, 2, 7)
    for field, wire, val in iter_fields(buf):
        if field == name_f and wire == _LEN:
            name = val.decode("utf-8", "replace")
        elif field == type_f:
            if v1 and wire == _VARINT:
                ltype = _V1_TYPES.get(val, str(val))
            elif not v1 and wire == _LEN:
                ltype = val.decode("utf-8", "replace")
        elif field == blob_f and wire == _LEN:
            blobs.append(_parse_blob(val))
    return CaffeLayer(name=name, type=ltype, blobs=blobs)


def read_caffemodel(src: Union[str, bytes]) -> List[CaffeLayer]:
    """Parse a .caffemodel (NetParameter) into layers with weight blobs.
    Handles both the V2 ``layer`` (field 100) and legacy V1 ``layers``
    (field 2) encodings; layers without blobs are kept (type info is useful
    for BatchNorm/Scale pairing)."""
    buf = open(src, "rb").read() if isinstance(src, str) else src
    layers: List[CaffeLayer] = []
    try:
        for field, wire, val in iter_fields(buf):
            if field == 100 and wire == _LEN:
                layers.append(_parse_layer(val, v1=False))
            elif field == 2 and wire == _LEN:
                layers.append(_parse_layer(val, v1=True))
    except (IndexError, ValueError) as e:
        raise ValueError(f"not a valid caffemodel: {e}") from e
    return layers


# ---------------------------------------------------------------------------
# TensorFlow GraphDef (frozen .pb)
# ---------------------------------------------------------------------------
# Field numbers from the public tensorflow protos:
#   GraphDef: node=1
#   NodeDef:  name=1, op=2, input=3, attr=5 (map<string, AttrValue>)
#   AttrValue: tensor=8
#   TensorProto: dtype=1, tensor_shape=2, tensor_content=4, float_val=5,
#                double_val=6, int_val=7, int64_val=10, half_val=13
#   TensorShapeProto: dim=2;  Dim: size=1

_TF_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
              6: np.int8, 9: np.int64, 10: np.bool_, 19: np.float16}


def _parse_tensor_proto(buf: bytes) -> Optional[np.ndarray]:
    dtype = np.float32
    shape: List[int] = []
    content = b""
    vals: List[float] = []
    for field, wire, val in iter_fields(buf):
        if field == 1 and wire == _VARINT:
            if val not in _TF_DTYPES:
                return None
            dtype = _TF_DTYPES[val]
        elif field == 2 and wire == _LEN:          # tensor_shape
            for f2, w2, v2 in iter_fields(val):
                if f2 == 2 and w2 == _LEN:          # dim
                    size = 0
                    for f3, w3, v3 in iter_fields(v2):
                        if f3 == 1 and w3 == _VARINT:
                            size = v3
                    shape.append(size)
        elif field == 4 and wire == _LEN:
            content = val
        elif field in (5, 6, 7, 10, 13):
            if wire == _LEN:                        # packed numeric list
                if field == 5:
                    vals.extend(np.frombuffer(val, "<f4").tolist())
                elif field == 6:
                    vals.extend(np.frombuffer(val, "<f8").tolist())
                elif field == 13:  # half_val holds uint16 BIT PATTERNS
                    vals.extend(np.asarray(_packed_varints(val), np.uint16)
                                .view(np.float16).tolist())
                else:  # int_val/int64_val: negatives are 64-bit
                    # two's-complement varints
                    vals.extend(_signed64(v) for v in _packed_varints(val))
            elif wire == _I32:
                vals.append(struct.unpack("<f", val)[0])
            elif wire == _I64:
                vals.append(struct.unpack("<d", val)[0])
            elif field == 13:
                vals.append(float(np.asarray([val & 0xFFFF], np.uint16)
                                  .view(np.float16)[0]))
            else:
                vals.append(_signed64(val))
    if content:
        arr = np.frombuffer(content, dtype=np.dtype(dtype).newbyteorder("<")).copy()
    else:
        arr = np.asarray(vals, dtype)
        if shape and arr.size == 1 and int(np.prod(shape)) > 1:
            arr = np.full(shape, arr.reshape(-1)[0], dtype)  # splat encoding
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr.astype(dtype, copy=False)


@dataclasses.dataclass
class GraphConst:
    name: str
    value: np.ndarray


def read_tf_graphdef(src: Union[str, bytes]) -> List[GraphConst]:
    """Extract every Const tensor from a frozen GraphDef, in graph order.
    This is all a frozen inference graph's weights are — the blaueck
    mtcnn.pb is Const nodes + ops we reimplement natively."""
    buf = open(src, "rb").read() if isinstance(src, str) else src
    consts: List[GraphConst] = []
    try:
        return _read_graphdef_consts(buf, consts)
    except (IndexError, ValueError) as e:
        raise ValueError(f"not a valid GraphDef: {e}") from e


def _read_graphdef_consts(buf, consts):
    for field, wire, val in iter_fields(buf):
        if field != 1 or wire != _LEN:
            continue
        name = ""
        op = ""
        tensor: Optional[np.ndarray] = None
        for f2, w2, v2 in iter_fields(val):
            if f2 == 1 and w2 == _LEN:
                name = v2.decode("utf-8", "replace")
            elif f2 == 2 and w2 == _LEN:
                op = v2.decode("utf-8", "replace")
            elif f2 == 5 and w2 == _LEN:            # attr map entry
                for f3, w3, v3 in iter_fields(v2):
                    if f3 == 2 and w3 == _LEN:       # AttrValue
                        for f4, w4, v4 in iter_fields(v3):
                            if f4 == 8 and w4 == _LEN:
                                parsed = _parse_tensor_proto(v4)
                                if parsed is not None:
                                    tensor = parsed
        if op == "Const" and tensor is not None:
            consts.append(GraphConst(name=name, value=tensor))
    return consts
