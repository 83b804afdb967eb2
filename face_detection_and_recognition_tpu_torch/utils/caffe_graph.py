"""Caffe NetParameter graphs: each layer's edges, op parameters and blobs.

The counterpart of ``utils/caffe_graph.py`` in the JAX package.
``utils/model_formats.read_caffemodel`` extracts the weight blobs only; this
module decodes the rest of each LayerParameter (bottoms and tops, and the
per-op parameter messages: convolution, pooling, eltwise, prior box,
normalize, ...) from the protobuf wire format, with no caffe install. A
real ``.caffemodel`` is a training snapshot that embeds the full layer
definitions, so a file like OpenCV's res10_300x300 SSD
(``modules/opencv2_dnn/model.py:21`` of the reference) carries all it takes
to EXECUTE the net: ``models/caffe_ssd.py`` runs such graphs.
``write_caffemodel_graph`` encodes layer definitions back (fixtures and
round trips).

Field numbers follow the public caffe.proto (BVLC, plus the SSD fork's
PriorBox / DetectionOutput / Normalize / Permute extensions).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Sequence, Union

import numpy as np

from .model_formats import (_LEN, _VARINT, _len_field, _packed_varints,
                            _parse_blob, _varint_field, _write_varint,
                            iter_fields)

# LayerParameter (V2) field numbers
_F_NAME, _F_TYPE, _F_BOTTOM, _F_TOP, _F_BLOBS = 1, 2, 3, 4, 7
# parameter-message field numbers inside LayerParameter
_F_CONV = 106
_F_POOL = 121
_F_ELTWISE = 110
_F_LRN = 118
_F_INNER = 117
_F_RESHAPE = 133
_F_FLATTEN = 135
_F_CONCAT = 104
_F_SOFTMAX = 125
_F_BATCHNORM = 139
_F_SCALE = 142
_F_PERMUTE = 202          # SSD fork
_F_PRIORBOX = 203         # SSD fork
_F_DETECTION_OUT = 204    # SSD fork
_F_NORM = 206             # SSD fork NormalizeParameter


@dataclasses.dataclass
class CaffeLayerDef:
    """One LayerParameter: identity, connectivity, op params, weights."""
    name: str
    type: str
    bottoms: List[str] = dataclasses.field(default_factory=list)
    tops: List[str] = dataclasses.field(default_factory=list)
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    blobs: List[np.ndarray] = dataclasses.field(default_factory=list)


def _f32(val: bytes) -> float:
    return struct.unpack("<f", val)[0]


def _parse_repeated(msg: bytes, accum: Dict[int, list]):
    for f, w, v in iter_fields(msg):
        accum.setdefault(f, []).append((w, v))


def _floats(entries) -> List[float]:
    out: List[float] = []
    for w, v in entries or []:
        if w == 5:  # I32
            out.append(_f32(v))
        elif w == _LEN:  # packed floats
            out.extend(np.frombuffer(v, "<f4").tolist())
    return out


def _ints(entries) -> List[int]:
    out: List[int] = []
    for w, v in entries or []:
        if w == _VARINT:
            out.append(v)
        elif w == _LEN:  # packed
            out.extend(_packed_varints(v))
    return out


def _first_int(entries, default=None):
    vals = _ints(entries)
    return vals[0] if vals else default


def _first_float(entries, default=None):
    vals = _floats(entries)
    return vals[0] if vals else default


def _parse_conv_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    p: Dict[str, object] = {
        "num_output": _first_int(acc.get(1), 0),
        "bias_term": bool(_first_int(acc.get(2), 1)),
        "pad": _ints(acc.get(3)) or [0],
        "kernel": _ints(acc.get(4)) or [0],
        "group": _first_int(acc.get(5), 1),
        "stride": _ints(acc.get(6)) or [1],
        "dilation": _ints(acc.get(18)) or [1],
    }
    # _h/_w overrides (pad_h=9 pad_w=10 kernel_h=11 kernel_w=12 stride 13/14)
    kh, kw = _first_int(acc.get(11)), _first_int(acc.get(12))
    if kh is not None or kw is not None:
        p["kernel"] = [kh or 0, kw or 0]
    ph, pw = _first_int(acc.get(9)), _first_int(acc.get(10))
    if ph is not None or pw is not None:
        p["pad"] = [ph or 0, pw or 0]
    sh, sw = _first_int(acc.get(13)), _first_int(acc.get(14))
    if sh is not None or sw is not None:
        p["stride"] = [sh or 1, sw or 1]
    return p


def _parse_pool_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {
        "pool": {0: "max", 1: "ave", 2: "stochastic"}.get(
            _first_int(acc.get(1), 0), "max"),
        "kernel": _first_int(acc.get(2), 0),
        "stride": _first_int(acc.get(3), 1),
        "pad": _first_int(acc.get(4), 0),
        "global": bool(_first_int(acc.get(12), 0)),
        "ceil": True,  # caffe pooling is ceil-mode by definition
    }


def _parse_priorbox_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {
        "min_size": _floats(acc.get(1)),
        "max_size": _floats(acc.get(2)),
        "aspect_ratio": _floats(acc.get(3)),
        "flip": bool(_first_int(acc.get(4), 1)),
        "clip": bool(_first_int(acc.get(5), 0)),
        "variance": _floats(acc.get(6)) or [0.1],
        "step": _first_float(acc.get(10)),
        "offset": _first_float(acc.get(13), 0.5),
    }


def _parse_detection_output_param(msg: bytes) -> Dict[str, object]:
    # DetectionOutputParameter: num_classes=1, share_location=2,
    # background_label_id=3, nms_param=4 {nms_threshold=1, top_k=2},
    # code_type=6, keep_top_k=7, confidence_threshold=9
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    nms_thresh, top_k = 0.45, 400
    for w, v in acc.get(4, []):
        if w == _LEN:
            nacc: Dict[int, list] = {}
            _parse_repeated(v, nacc)
            nms_thresh = _first_float(nacc.get(1), nms_thresh)
            top_k = _first_int(nacc.get(2), top_k)
    return {
        "num_classes": _first_int(acc.get(1), 2),
        "background_label_id": _first_int(acc.get(3), 0),
        "nms_threshold": nms_thresh,
        "top_k": top_k,
        "keep_top_k": _first_int(acc.get(7), 200),
        "confidence_threshold": _first_float(acc.get(9), 0.01),
    }


def _parse_eltwise_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"operation": {0: "prod", 1: "sum", 2: "max"}.get(
        _first_int(acc.get(1), 1), "sum")}


def _parse_lrn_param(msg: bytes) -> Dict[str, object]:
    # LRNParameter: local_size=1 [5], alpha=2 [1.0], beta=3 [0.75],
    # norm_region=4 (0=ACROSS_CHANNELS, 1=WITHIN_CHANNEL), k=5 [1.0]
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {
        "local_size": _first_int(acc.get(1), 5),
        "alpha": _first_float(acc.get(2), 1.0),
        "beta": _first_float(acc.get(3), 0.75),
        "norm_region": _first_int(acc.get(4), 0),
        "k": _first_float(acc.get(5), 1.0),
    }


def _parse_scale_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    # ScaleParameter: axis=1, num_axes=2, bias_term=4
    return {"bias_term": bool(_first_int(acc.get(4), 0))}


def _parse_norm_param(msg: bytes) -> Dict[str, object]:
    # NormalizeParameter: across_spatial=1, scale_filler=2, channel_shared=3
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"across_spatial": bool(_first_int(acc.get(1), 1)),
            "channel_shared": bool(_first_int(acc.get(3), 1))}


def _parse_softmax_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"axis": _first_int(acc.get(2), 1)}


def _parse_concat_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"axis": _first_int(acc.get(2), 1)}


def _parse_flatten_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"axis": _first_int(acc.get(1), 1)}


def _parse_permute_param(msg: bytes) -> Dict[str, object]:
    acc: Dict[int, list] = {}
    _parse_repeated(msg, acc)
    return {"order": _ints(acc.get(1))}


def _parse_reshape_param(msg: bytes) -> Dict[str, object]:
    def signed(v: int) -> int:  # dim is int64: -1 arrives as 2^64-1
        return v if v < (1 << 63) else v - (1 << 64)

    dims: List[int] = []
    for f, w, v in iter_fields(msg):
        if f == 1 and w == _LEN:  # BlobShape
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    if w2 == _LEN:
                        dims.extend(signed(x) for x in _ints([(w2, v2)]))
                    else:
                        dims.append(signed(v2))
    return {"shape": dims}


_PARAM_PARSERS = {
    _F_CONV: ("conv", _parse_conv_param),
    _F_POOL: ("pool", _parse_pool_param),
    _F_ELTWISE: ("eltwise", _parse_eltwise_param),
    _F_LRN: ("lrn", _parse_lrn_param),
    _F_PRIORBOX: ("prior_box", _parse_priorbox_param),
    _F_DETECTION_OUT: ("detection_output", _parse_detection_output_param),
    _F_SCALE: ("scale", _parse_scale_param),
    _F_NORM: ("norm", _parse_norm_param),
    _F_SOFTMAX: ("softmax", _parse_softmax_param),
    _F_CONCAT: ("concat", _parse_concat_param),
    _F_FLATTEN: ("flatten", _parse_flatten_param),
    _F_PERMUTE: ("permute", _parse_permute_param),
    _F_RESHAPE: ("reshape", _parse_reshape_param),
}


def parse_layer_def(buf: bytes) -> CaffeLayerDef:
    d = CaffeLayerDef(name="", type="")
    for field, wire, val in iter_fields(buf):
        if field == _F_NAME and wire == _LEN:
            d.name = val.decode("utf-8", "replace")
        elif field == _F_TYPE and wire == _LEN:
            d.type = val.decode("utf-8", "replace")
        elif field == _F_BOTTOM and wire == _LEN:
            d.bottoms.append(val.decode("utf-8", "replace"))
        elif field == _F_TOP and wire == _LEN:
            d.tops.append(val.decode("utf-8", "replace"))
        elif field == _F_BLOBS and wire == _LEN:
            d.blobs.append(_parse_blob(val))
        elif field in _PARAM_PARSERS and wire == _LEN:
            key, fn = _PARAM_PARSERS[field]
            d.params[key] = fn(val)
    return d


def read_caffemodel_graph(src: Union[str, bytes]) -> List[CaffeLayerDef]:
    """Parse a .caffemodel / binary NetParameter into FULL layer definitions
    (V2 ``layer`` field 100 only — the SSD-era format)."""
    buf = open(src, "rb").read() if isinstance(src, str) else src
    out: List[CaffeLayerDef] = []
    for field, wire, val in iter_fields(buf):
        if field == 100 and wire == _LEN:
            out.append(parse_layer_def(val))
    return out


# ---------------------------------------------------------------------------
# writer (fixtures / round-trip tests)
# ---------------------------------------------------------------------------

def _write_conv_param(p: Dict[str, object]) -> bytes:
    body = bytearray(_varint_field(1, int(p.get("num_output", 0))))
    body += _varint_field(2, 1 if p.get("bias_term", True) else 0)
    for v in p.get("pad", []):
        body += _varint_field(3, int(v))
    for v in p.get("kernel", []):
        body += _varint_field(4, int(v))
    body += _varint_field(5, int(p.get("group", 1)))
    for v in p.get("stride", []):
        body += _varint_field(6, int(v))
    for v in p.get("dilation", []):
        body += _varint_field(18, int(v))
    return bytes(body)


def _write_pool_param(p: Dict[str, object]) -> bytes:
    pool_code = {"max": 0, "ave": 1}.get(p.get("pool", "max"), 0)
    body = bytearray(_varint_field(1, pool_code))
    body += _varint_field(2, int(p.get("kernel", 0)))
    body += _varint_field(3, int(p.get("stride", 1)))
    body += _varint_field(4, int(p.get("pad", 0)))
    if p.get("global"):
        body += _varint_field(12, 1)
    return bytes(body)


def _f32_field(field: int, value: float) -> bytes:
    return _write_varint((field << 3) | 5) + struct.pack("<f", value)


def _write_priorbox_param(p: Dict[str, object]) -> bytes:
    body = bytearray()
    for v in p.get("min_size", []):
        body += _f32_field(1, v)
    for v in p.get("max_size", []):
        body += _f32_field(2, v)
    for v in p.get("aspect_ratio", []):
        body += _f32_field(3, v)
    body += _varint_field(4, 1 if p.get("flip", True) else 0)
    body += _varint_field(5, 1 if p.get("clip", False) else 0)
    for v in p.get("variance", []):
        body += _f32_field(6, v)
    if p.get("step") is not None:
        body += _f32_field(10, p["step"])
    body += _f32_field(13, p.get("offset", 0.5))
    return bytes(body)


def _write_detection_output_param(p: Dict[str, object]) -> bytes:
    body = bytearray(_varint_field(1, int(p.get("num_classes", 2))))
    body += _varint_field(3, int(p.get("background_label_id", 0)))
    nms = _f32_field(1, p.get("nms_threshold", 0.45)) + _varint_field(
        2, int(p.get("top_k", 400)))
    body += _len_field(4, nms)
    body += _varint_field(7, int(p.get("keep_top_k", 200)))
    body += _f32_field(9, p.get("confidence_threshold", 0.01))
    return bytes(body)


def _write_eltwise_param(p: Dict[str, object]) -> bytes:
    return _varint_field(1, {"prod": 0, "sum": 1, "max": 2}.get(
        p.get("operation", "sum"), 1))


def _write_scale_param(p: Dict[str, object]) -> bytes:
    return _varint_field(4, 1 if p.get("bias_term") else 0)


def _write_lrn_param(p: Dict[str, object]) -> bytes:
    body = bytearray(_varint_field(1, int(p.get("local_size", 5))))
    body += _f32_field(2, p.get("alpha", 1.0))
    body += _f32_field(3, p.get("beta", 0.75))
    body += _varint_field(4, int(p.get("norm_region", 0)))
    body += _f32_field(5, p.get("k", 1.0))
    return bytes(body)


def _write_norm_param(p: Dict[str, object]) -> bytes:
    return (_varint_field(1, 1 if p.get("across_spatial", True) else 0)
            + _varint_field(3, 1 if p.get("channel_shared", True) else 0))


def _write_simple_axis(field_num: int):
    def write(p: Dict[str, object]) -> bytes:
        return _varint_field(field_num, int(p.get("axis", 1)))
    return write


def _write_permute_param(p: Dict[str, object]) -> bytes:
    return b"".join(_varint_field(1, int(v)) for v in p.get("order", []))


def _write_reshape_param(p: Dict[str, object]) -> bytes:
    dims = b""
    for d in p.get("shape", []):
        dims += _write_varint(d if d >= 0 else d + (1 << 64))
    return _len_field(1, _len_field(1, dims))


_PARAM_WRITERS = {
    "conv": (_F_CONV, _write_conv_param),
    "pool": (_F_POOL, _write_pool_param),
    "eltwise": (_F_ELTWISE, _write_eltwise_param),
    "lrn": (_F_LRN, _write_lrn_param),
    "prior_box": (_F_PRIORBOX, _write_priorbox_param),
    "detection_output": (_F_DETECTION_OUT, _write_detection_output_param),
    "scale": (_F_SCALE, _write_scale_param),
    "norm": (_F_NORM, _write_norm_param),
    "softmax": (_F_SOFTMAX, _write_simple_axis(2)),
    "concat": (_F_CONCAT, _write_simple_axis(2)),
    "flatten": (_F_FLATTEN, _write_simple_axis(1)),
    "permute": (_F_PERMUTE, _write_permute_param),
    "reshape": (_F_RESHAPE, _write_reshape_param),
}


def write_caffemodel_graph(layers: Sequence[CaffeLayerDef]) -> bytes:
    """Encode full layer definitions (graph + params + blobs) as a binary
    NetParameter — the synthetic twin of a real training snapshot."""
    out = bytearray(_len_field(1, b"net"))
    for layer in layers:
        body = bytearray(_len_field(_F_NAME, layer.name.encode()))
        body += _len_field(_F_TYPE, layer.type.encode())
        for b in layer.bottoms:
            body += _len_field(_F_BOTTOM, b.encode())
        for t in layer.tops:
            body += _len_field(_F_TOP, t.encode())
        for blob in layer.blobs:
            arr = np.ascontiguousarray(blob, dtype="<f4")
            shape_payload = _len_field(
                1, b"".join(_write_varint(int(d)) for d in arr.shape))
            blob_body = (_len_field(7, shape_payload)
                         + _len_field(5, arr.tobytes()))
            body += _len_field(_F_BLOBS, bytes(blob_body))
        for key, value in layer.params.items():
            if key in _PARAM_WRITERS:
                fnum, writer = _PARAM_WRITERS[key]
                body += _len_field(fnum, writer(value))
        out += _len_field(100, bytes(body))
    return bytes(out)
