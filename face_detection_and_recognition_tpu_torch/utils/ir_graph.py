"""OpenVINO IR graphs: layers, ports, edges and attributes.

The counterpart of ``utils/ir_graph.py`` in the JAX package.
``utils/model_formats.read_openvino_ir`` extracts the constants only; this
module parses the whole IR v10/v11 topology, so that ``models/ov_graph.py``
can EXECUTE an OpenVINO artifact (face-detection-0204, the SqueezeNet-light
SSD: ``modules/openvino/model.py:8-54`` of the reference). Standard-library
XML and numpy: each Const layer's payload is sliced from the ``.bin`` by its
offset and size and read as its ``element_type`` (f32, f16, i64, i32, u8,
...; a layer that gives only a ``precision``, FP32 or FP16, is read as that).
``write_ir_graph`` encodes a graph back (fixtures and round trips).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .model_formats import ir_array, parse_ir_xml

Edges = Dict[Tuple[int, int], Tuple[int, int]]


@dataclasses.dataclass
class IRLayer:
    id: int
    name: str
    type: str
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)
    value: Optional[np.ndarray] = None        # Const payload
    input_ports: List[int] = dataclasses.field(default_factory=list)
    output_ports: List[int] = dataclasses.field(default_factory=list)
    # each output port's dims as the xml gives them (NCHW)
    port_dims: Dict[int, List[int]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class IRGraph:
    layers: List[IRLayer]
    edges: Edges  # (to_layer, to_port) -> (from_layer, from_port)

    def __post_init__(self):
        self._index = {la.id: la for la in self.layers}

    def by_id(self, lid: int) -> IRLayer:
        return self._index[lid]

    def inputs_of(self, layer: IRLayer) -> List[Tuple[int, int]]:
        """The upstream (layer id, port) of each connected input port, in
        port order."""
        out = []
        for p in sorted(layer.input_ports):
            src = self.edges.get((layer.id, p))
            if src is not None:
                out.append(src)
        return out


def parse_ir_graph(xml_src: Union[str, bytes],
                   bin_src: Union[str, bytes, None]) -> IRGraph:
    """Parse an IR ``.xml`` (and its ``.bin`` for the Const payloads) into
    an IRGraph. A file that is not XML raises ``ValueError``."""
    root = parse_ir_xml(xml_src)
    blob = b""
    if bin_src is not None:
        blob = open(bin_src, "rb").read() if isinstance(bin_src, str) \
            else bin_src
    layers: List[IRLayer] = []
    for lx in root.iter("layer"):
        data = lx.find("data")
        attrs: Dict[str, str] = dict(data.attrib) if data is not None else {}
        layer = IRLayer(id=int(lx.get("id")), name=lx.get("name", ""),
                        type=lx.get("type", ""), attrs=attrs)
        inp = lx.find("input")
        if inp is not None:
            layer.input_ports = [int(p.get("id")) for p in inp.findall("port")]
        out = lx.find("output")
        if out is not None:
            for p in out.findall("port"):
                pid = int(p.get("id"))
                layer.output_ports.append(pid)
                layer.port_dims[pid] = [int(d.text) for d in p.findall("dim")]
        if layer.type == "Const" and attrs.get("offset") is not None:
            etype = (attrs.get("element_type") or attrs.get("precision")
                     or lx.get("precision") or "f32")
            shape = [int(s) for s in attrs.get("shape", "").split(",")
                     if s.strip()]
            layer.value = ir_array(blob, int(attrs["offset"]),
                                   int(attrs["size"]), etype, shape)
        layers.append(layer)
    edges: Edges = {}
    for ex in root.iter("edge"):
        edges[(int(ex.get("to-layer")), int(ex.get("to-port")))] = (
            int(ex.get("from-layer")), int(ex.get("from-port")))
    return IRGraph(layers=layers, edges=edges)


_ELEMENT_TYPES = {np.dtype(np.float32): "f32", np.dtype(np.int64): "i64",
                  np.dtype(np.int32): "i32", np.dtype(np.float16): "f16",
                  np.dtype(np.uint8): "u8"}


def write_ir_graph(layers: List[IRLayer], edges: Edges
                   ) -> Tuple[bytes, bytes]:
    """Encode layers and edges as an IR v11 (xml, bin) pair: each Const's
    payload appended to the ``.bin``, its offset, size, shape and element
    type written into its ``<data>``."""
    blob = bytearray()
    parts = ['<?xml version="1.0"?>', '<net name="net" version="11">',
             "<layers>"]
    for L in layers:
        attrs = dict(L.attrs)
        if L.type == "Const" and L.value is not None:
            arr = np.ascontiguousarray(L.value)
            attrs["offset"] = str(len(blob))
            attrs["size"] = str(arr.nbytes)
            attrs["shape"] = ",".join(str(d) for d in arr.shape)
            attrs.setdefault("element_type",
                             _ELEMENT_TYPES.get(arr.dtype, "f32"))
            blob += arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        parts.append(f'<layer id="{L.id}" name="{L.name}" type="{L.type}">')
        if attrs:
            parts.append("<data" + "".join(f' {k}="{v}"'
                                           for k, v in attrs.items()) + "/>")
        if L.input_ports:
            parts += (["<input>"] + [f'<port id="{p}"/>'
                                     for p in L.input_ports] + ["</input>"])
        if L.output_ports:
            parts.append("<output>")
            for p in L.output_ports:
                dims = "".join(f"<dim>{d}</dim>"
                               for d in L.port_dims.get(p, []))
                parts.append(f'<port id="{p}">{dims}</port>')
            parts.append("</output>")
        parts.append("</layer>")
    parts += ["</layers>", "<edges>"]
    for (tl, tp), (fl, fp) in edges.items():
        parts.append(f'<edge from-layer="{fl}" from-port="{fp}" '
                     f'to-layer="{tl}" to-port="{tp}"/>')
    parts += ["</edges>", "</net>"]
    return "\n".join(parts).encode(), bytes(blob)
