"""Readers of the reference's weight files: the Caffe ``.caffemodel``
(NetParameter), the frozen TensorFlow GraphDef ``.pb`` and the OpenVINO IR
(``.xml`` + ``.bin``).

The counterpart of ``utils/model_formats.py`` in the JAX package: a minimal
protobuf wire decoder (varints and length-delimited fields, unknown fields
skipped) and its encoder primitives, ``read_caffemodel`` (V2 ``layer`` and
legacy V1 ``layers``), ``read_tf_graphdef`` (every Const tensor, with
half-precision and negative-integer encodings), ``read_openvino_ir`` (the
IR's constants, in layer order) and the writers ``write_caffemodel``,
``write_graphdef`` and ``write_openvino_ir``, byte for byte the JAX
package's. The arrays come out in the files' own layouts;
``utils/weights.py`` maps them onto the port's modules.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple, Union

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


def _write_varint(value: int) -> bytes:
    if value < 0:  # two's-complement 64-bit (10-byte varint), like protobuf
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | wire) + payload


def _len_field(field: int, payload: bytes) -> bytes:
    return _field(field, _LEN, _write_varint(len(payload)) + payload)


def _varint_field(field: int, value: int) -> bytes:
    return _field(field, _VARINT, _write_varint(value))


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


def write_caffemodel(layers: Sequence[CaffeLayer], v1: bool = False) -> bytes:
    """Encode layers (name, type, blobs) as NetParameter bytes, the V2
    ``layer`` messages or, with ``v1``, the V1 ``layers`` ones (the type
    then an enum; unknown types 0): the JAX package's writer, byte for
    byte. Each blob is f32 with a ``BlobShape``."""
    out = bytearray(_len_field(1, b"net"))
    name_f, type_f, blob_f = (4, 5, 6) if v1 else (1, 2, 7)
    inv_v1 = {v: k for k, v in _V1_TYPES.items()}
    for layer in layers:
        body = bytearray(_len_field(name_f, layer.name.encode()))
        if v1:
            body += _varint_field(type_f, inv_v1.get(layer.type, 0))
        else:
            body += _len_field(type_f, layer.type.encode())
        for blob in layer.blobs:
            arr = np.ascontiguousarray(blob, dtype="<f4")
            shape_payload = _len_field(
                1, b"".join(_write_varint(int(d)) for d in arr.shape))
            blob_body = (_len_field(7, shape_payload)
                         + _len_field(5, arr.tobytes()))
            body += _len_field(blob_f, bytes(blob_body))
        out += _len_field(100 if not v1 else 2, bytes(body))
    return bytes(out)


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


def write_graphdef(consts: Sequence[GraphConst]) -> bytes:
    """Encode named arrays as the Const nodes of a frozen GraphDef (each
    value in ``tensor_content``, little-endian, with its dtype code and
    shape): the JAX package's writer, byte for byte."""
    out = bytearray()
    codes = {v: k for k, v in _TF_DTYPES.items()}
    for c in consts:
        arr = np.ascontiguousarray(c.value)
        shape_payload = b"".join(
            _len_field(2, _varint_field(1, int(d))) for d in arr.shape)
        tensor = (_varint_field(1, codes[arr.dtype.type])
                  + _len_field(2, shape_payload)
                  + _len_field(4, arr.astype(
                      arr.dtype.newbyteorder("<")).tobytes()))
        attr_entry = _len_field(1, b"value") + _len_field(
            2, _len_field(8, tensor))
        node = (_len_field(1, c.name.encode()) + _len_field(2, b"Const")
                + _len_field(5, attr_entry))
        out += _len_field(1, node)
    return bytes(out)


# ---------------------------------------------------------------------------
# OpenVINO IR (.xml + .bin)
# ---------------------------------------------------------------------------

_IR_DTYPES = {"f32": np.float32, "fp32": np.float32, "f16": np.float16,
              "fp16": np.float16, "i64": np.int64, "i32": np.int32,
              "i8": np.int8, "u8": np.uint8, "boolean": np.bool_}


def parse_ir_xml(xml_src: Union[str, bytes]):
    """The IR's XML root; a file that is not XML raises ``ValueError``."""
    import xml.etree.ElementTree as ET

    text = open(xml_src, "rb").read() if isinstance(xml_src, str) else xml_src
    try:
        return ET.fromstring(text)
    except ET.ParseError as e:
        raise ValueError(f"not a valid OpenVINO IR: {e}") from e


def ir_array(blob: bytes, offset: int, size: int, etype: str,
             shape: Optional[Sequence[int]]) -> np.ndarray:
    """``size`` bytes at ``offset`` of the ``.bin`` as little-endian
    ``etype`` (an IR element type or precision, f32 where unknown),
    reshaped to ``shape`` where the element count fits."""
    dt = _IR_DTYPES.get(etype.lower(), np.float32)
    arr = np.frombuffer(blob[offset:offset + size],
                        np.dtype(dt).newbyteorder("<")).copy()
    if shape and int(np.prod(shape)) == arr.size:
        arr = arr.reshape(shape)
    return arr


def read_openvino_ir(xml_src: Union[str, bytes],
                     bin_src: Union[str, bytes]) -> List[GraphConst]:
    """Parse an OpenVINO IR into named constant tensors, in layer order:
    IR v10/v11 ``type="Const"`` layers (``<data element_type=.. offset=..
    size=.. shape=..>``) and the older v7-style ``<blobs>`` (``<weights
    offset=.. size=../>`` / ``<biases ../>``, in the layer's
    ``precision``). The reference compiles these files with the OpenVINO
    runtime (``modules/openvino/model.py:8-23``); here they feed
    ``utils.weights.structural_import``, or ``models.ov_graph`` executes
    the whole graph (``utils.ir_graph``)."""
    root = parse_ir_xml(xml_src)
    blob = open(bin_src, "rb").read() if isinstance(bin_src, str) else bin_src
    out: List[GraphConst] = []
    for layer in root.iter("layer"):
        name = layer.get("name", "")
        data = layer.find("data")
        if layer.get("type", "") == "Const" and data is not None \
                and data.get("offset") is not None:
            shape = [int(s) for s in data.get("shape", "").split(",")
                     if s.strip()]
            out.append(GraphConst(name=name, value=ir_array(
                blob, int(data.get("offset")), int(data.get("size")),
                data.get("element_type", "f32"), shape)))
            continue
        blobs = layer.find("blobs")
        if blobs is not None:
            prec = (layer.get("precision") or "f32").lower()
            for kind in ("weights", "biases"):
                b = blobs.find(kind)
                if b is not None:
                    out.append(GraphConst(
                        name=f"{name}/{kind}",
                        value=ir_array(blob, int(b.get("offset")),
                                       int(b.get("size")), prec, None)))
    return out


def write_openvino_ir(consts: Sequence[GraphConst]) -> Tuple[bytes, bytes]:
    """Encode constants as an IR v10-style (xml, bin) pair of f32 Const
    layers (test fixtures)."""
    xml_parts = ['<?xml version="1.0"?>', '<net name="net" version="10">',
                 "<layers>"]
    blob = bytearray()
    for i, c in enumerate(consts):
        arr = np.ascontiguousarray(c.value, dtype="<f4")
        offset = len(blob)
        blob += arr.tobytes()
        shape = ",".join(str(d) for d in arr.shape)
        xml_parts.append(
            f'<layer id="{i}" name="{c.name}" type="Const">'
            f'<data element_type="f32" offset="{offset}" '
            f'size="{arr.nbytes}" shape="{shape}"/></layer>')
    xml_parts += ["</layers>", "</net>"]
    return "\n".join(xml_parts).encode(), bytes(blob)
