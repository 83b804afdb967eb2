"""The reference's OpenVINO detector topologies, encoded in the repo.

The counterpart of ``models/ov_topologies.py`` in the JAX package. The
reference runs two OpenVINO face detectors through ``OVModel``
(``modules/openvino/model.py:8-54``):

* ``weights/face_detection_0204/model.xml``, OMZ **face-detection-0204**:
  a MobileNetV2 backbone and one SSD head with clustered priors, input
  1x3x448x448, output ``DetectionOutput [1, 1, 200, 7]``, 1.829 MParams;
* the SqueezeNet-light SSD, OMZ **face-detection-retail-0004**: SqueezeNet
  at half channels and one SSD head with clustered priors, input
  1x3x300x300, output [1, 1, 200, 7], 0.588 MParams.

Both are IR graph tables here (``face_detection_0204_defs``,
``face_detection_retail_0004_defs``): they build ``utils.ir_graph.IRGraph``
objects that the IR interpreter (``models/ov_graph.OVGraphNet``) executes,
and ``write_ir_graph`` turns into a real ``model.xml`` + ``model.bin``.
The vendors' weights and exact prior clusters are not public: the weights
are He-init constants drawn from a seed (numpy, as in the JAX package, so
the same seed gives the same constants there), and the clusters are a
face-size ladder over the golden composites' faces.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from ..utils.ir_graph import IRGraph, IRLayer

Ref = Tuple[int, int]  # (layer_id, port)
Edges = Dict[Tuple[int, int], Tuple[int, int]]


class _IRBuilder:
    """A layer table under construction: auto ids, edges, port dims."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.layers: List[IRLayer] = []
        self.edges: Edges = {}
        self._id = 0

    def _next(self) -> int:
        i = self._id
        self._id += 1
        return i

    def const(self, name: str, value: np.ndarray) -> Ref:
        lid = self._next()
        arr = np.asarray(value)
        self.layers.append(IRLayer(
            id=lid, name=name, type="Const", attrs={}, value=arr,
            output_ports=[0], port_dims={0: list(arr.shape)}))
        return (lid, 0)

    def add(self, type_: str, name: str, inputs: List[Ref],
            attrs: Dict[str, str] = None, dims: List[int] = None) -> Ref:
        lid = self._next()
        L = IRLayer(id=lid, name=name, type=type_, attrs=dict(attrs or {}))
        for i, src in enumerate(inputs):
            L.input_ports.append(i)
            self.edges[(lid, i)] = src
        port = len(inputs)
        L.output_ports = [port]
        if dims is not None:
            L.port_dims[port] = list(dims)
        self.layers.append(L)
        return (lid, port)

    # ---- composite ops -------------------------------------------------
    def conv(self, name: str, src: Ref, cin: int, cout: int, k: int,
             hw: Tuple[int, int], stride: int = 1, pad: int = None,
             groups: int = 1, bias: bool = True, init_gain: float = 1.0
             ) -> Tuple[Ref, Tuple[int, int]]:
        """Convolution (+ bias Add) with He-init Const weights. Returns
        (output ref, output (h, w)). ``init_gain`` rescales the init std —
        conv1 uses 1/127 so the raw-BGR input convention (OVModel passes
        0..255 with no mean/scale, ``openvino/model.py:44-49``) starts at
        unit-scale activations, the same way OMZ folds input normalization
        into the first conv's weights."""
        if pad is None:
            pad = k // 2
        h, w = hw
        oh = (h + 2 * pad - k) // stride + 1
        ow = (w + 2 * pad - k) // stride + 1
        fan_in = (cin // groups) * k * k
        std = float(np.sqrt(2.0 / fan_in)) * init_gain
        if groups == 1:
            wshape = (cout, cin, k, k)
            ctype = "Convolution"
        else:
            assert groups == cin == cout, "depthwise only"
            wshape = (groups, 1, 1, k, k)  # [G, O/g, I/g, kh, kw]
            ctype = "GroupConvolution"
        wv = (self.rng.randn(*wshape) * std).astype(np.float32)
        wref = self.const(f"{name}/weights", wv)
        y = self.add(ctype, name, [src, wref], {
            "strides": f"{stride},{stride}",
            "pads_begin": f"{pad},{pad}", "pads_end": f"{pad},{pad}",
            "dilations": "1,1"}, dims=[1, cout, oh, ow])
        if bias:
            bv = np.zeros((1, cout, 1, 1), np.float32)
            if 0.0 < init_gain < 1.0:
                # fold the input MEAN into the bias too (OMZ folds the
                # whole normalization into conv1): b_c = -sum(W_c) * mean
                # zero-centers conv1's output over the all-positive raw-BGR
                # input, without which the DC component dominates training
                bv[0, :, 0, 0] = -wv.reshape(cout, -1).sum(1) * 114.7
            bref = self.const(f"{name}/bias", bv)
            y = self.add("Add", f"{name}/add", [y, bref],
                         dims=[1, cout, oh, ow])
        return y, (oh, ow)

    def relu(self, name: str, src: Ref, dims=None) -> Ref:
        return self.add("ReLU", name, [src], dims=dims)

    def relu6(self, name: str, src: Ref, dims=None) -> Ref:
        return self.add("Clamp", name, [src], {"min": "0", "max": "6"},
                        dims=dims)

    def maxpool_ceil(self, name: str, src: Ref, c: int, hw: Tuple[int, int],
                     k: int = 3, stride: int = 2
                     ) -> Tuple[Ref, Tuple[int, int]]:
        h, w = hw
        oh = math.ceil((h - k) / stride) + 1
        ow = math.ceil((w - k) / stride) + 1
        y = self.add("MaxPool", name, [src], {
            "kernel": f"{k},{k}", "strides": f"{stride},{stride}",
            "pads_begin": "0,0", "pads_end": "0,0",
            "rounding_type": "ceil"}, dims=[1, c, oh, ow])
        return y, (oh, ow)


def _ssd_head(b: _IRBuilder, feat: Ref, cfeat: int, hw: Tuple[int, int],
              img: int, widths: List[float], heights: List[float],
              param_ref: Ref) -> None:
    """The single SSD head + DetectionOutput plumbing shared by both nets:
    3x3 loc/conf convs -> Transpose(0,2,3,1) -> Reshape -> SoftMax ->
    PriorBoxClustered -> DetectionOutput (the exact layer chain the OMZ
    face-detection IRs lower to)."""
    fh, fw = hw
    k = len(widths)
    n = fh * fw * k
    loc, _ = b.conv("mbox_loc", feat, cfeat, 4 * k, 3, hw)
    conf, _ = b.conv("mbox_conf", feat, cfeat, 2 * k, 3, hw)
    perm = b.const("mbox/perm", np.asarray([0, 2, 3, 1], np.int64))
    loc_t = b.add("Transpose", "mbox_loc/transpose", [loc, perm],
                  dims=[1, fh, fw, 4 * k])
    loc_shape = b.const("mbox_loc/shape", np.asarray([1, -1], np.int64))
    loc_flat = b.add("Reshape", "mbox_loc_flat", [loc_t, loc_shape],
                     {"special_zero": "true"}, dims=[1, n * 4])
    conf_t = b.add("Transpose", "mbox_conf/transpose", [conf, perm],
                   dims=[1, fh, fw, 2 * k])
    conf_shape = b.const("mbox_conf/shape", np.asarray([1, -1, 2], np.int64))
    conf_r = b.add("Reshape", "mbox_conf_reshape", [conf_t, conf_shape],
                   {"special_zero": "true"}, dims=[1, n, 2])
    conf_sm = b.add("SoftMax", "mbox_conf/softmax", [conf_r], {"axis": "2"},
                    dims=[1, n, 2])
    conf_flat_shape = b.const("mbox_conf/flat_shape",
                              np.asarray([1, -1], np.int64))
    conf_flat = b.add("Reshape", "mbox_conf_flat", [conf_sm, conf_flat_shape],
                      {"special_zero": "true"}, dims=[1, n * 2])
    priors = b.add("PriorBoxClustered", "mbox_priorbox", [feat, param_ref], {
        "width": ",".join(str(v) for v in widths),
        "height": ",".join(str(v) for v in heights),
        "step": "0", "offset": "0.5", "clip": "0",
        "variance": "0.1,0.1,0.2,0.2"}, dims=[1, 2, n * 4])
    det = b.add("DetectionOutput", "detection_out",
                [loc_flat, conf_flat, priors], {
                    "num_classes": "2", "background_label_id": "0",
                    "nms_threshold": "0.45", "top_k": "400",
                    "keep_top_k": "200", "confidence_threshold": "0.02",
                    "code_type": "caffe.PriorBoxParameter.CENTER_SIZE",
                    "share_location": "1"},
                dims=[1, 1, 200, 7])
    b.add("Result", "out", [det])


# face-size prior clusters (free parameters — see module docstring): a
# geometric ladder covering ~4%..60% of the input side, the regime the
# reference's WIDER/golden faces occupy at these input sizes
_CLUSTERS_448 = ([20.0, 44.0, 84.0, 148.0, 240.0],
                 [26.0, 56.0, 108.0, 190.0, 300.0])
_CLUSTERS_300 = ([16.0, 32.0, 64.0, 112.0, 176.0],
                 [20.0, 42.0, 84.0, 144.0, 224.0])


def face_detection_0204_defs(seed: int = 0
                             ) -> Tuple[List[IRLayer], Edges]:
    """face-detection-0204: full MobileNetV2 inverted-residual ladder
    (t,c,n,s) = (1,16,1,1)(6,24,2,2)(6,32,3,2)(6,64,4,2)(6,96,3,1)
    (6,160,3,1)(6,320,1,1) — the 160/320 stages run at stride 1 so the
    single SSD head sits on the stride-16 28x28 map; backbone+head params
    land on the model card's 1.829M."""
    b = _IRBuilder(seed)
    img = 448
    param = b.add("Parameter", "image", [], {"shape": f"1,3,{img},{img}"},
                  dims=[1, 3, img, img])
    x, hw = b.conv("conv1", param, 3, 32, 3, (img, img), stride=2,
                   init_gain=1.0 / 127.0)
    x = b.relu6("conv1/relu", x, dims=[1, 32, *hw])
    cin = 32

    def inv_res(x, cin, cout, stride, t, hw, name):
        mid = cin * t
        residual = stride == 1 and cin == cout
        y = x
        if t != 1:
            y, _ = b.conv(f"{name}/expand", y, cin, mid, 1, hw)
            y = b.relu6(f"{name}/expand/relu", y, dims=[1, mid, *hw])
        y, hw2 = b.conv(f"{name}/dw", y, mid, mid, 3, hw, stride=stride,
                        groups=mid)
        y = b.relu6(f"{name}/dw/relu", y, dims=[1, mid, *hw2])
        # Fixup-style init: residual branches START AT ZERO (project conv
        # zeroed) so the 19-block no-normalization chain begins as its
        # short non-residual spine — without this the full-depth plain net
        # plateaus under any optimizer (0204 froze at loss 4.3)
        y, _ = b.conv(f"{name}/project", y, mid, cout, 1, hw2,
                      init_gain=0.0 if residual else 1.0)
        if residual:
            y = b.add("Add", f"{name}/residual", [y, x],
                      dims=[1, cout, *hw2])
        return y, hw2

    ladder = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 1), (6, 320, 1, 1)]
    for bi, (t, c, reps, s) in enumerate(ladder):
        for r in range(reps):
            x, hw = inv_res(x, cin, c, s if r == 0 else 1, t, hw,
                            f"block{bi}_{r}")
            cin = c
    assert hw == (28, 28), hw  # stride 16 at 448
    _ssd_head(b, x, cin, hw, img, *_CLUSTERS_448, param_ref=param)
    return b.layers, b.edges


def face_detection_retail_0004_defs(seed: int = 0
                                    ) -> Tuple[List[IRLayer], Edges]:
    """face-detection-retail-0004: SqueezeNet v1.1 at HALF channels
    (conv1 32ch; fire squeeze/expand 8/32 -> 16/64 -> 24/96 -> 32/128) +
    one 3x3 context conv + the single SSD head on the stride-16 18x18
    map; params land on the model card's 0.588M."""
    b = _IRBuilder(seed)
    img = 300
    param = b.add("Parameter", "image", [], {"shape": f"1,3,{img},{img}"},
                  dims=[1, 3, img, img])
    x, hw = b.conv("conv1", param, 3, 32, 3, (img, img), stride=2,
                   init_gain=1.0 / 127.0)
    x = b.relu("conv1/relu", x, dims=[1, 32, *hw])
    x, hw = b.maxpool_ceil("pool1", x, 32, hw)
    cin = 32

    def fire(x, cin, s, e, hw, name):
        sq, _ = b.conv(f"{name}/squeeze", x, cin, s, 1, hw)
        sq = b.relu(f"{name}/squeeze/relu", sq, dims=[1, s, *hw])
        e1, _ = b.conv(f"{name}/expand1x1", sq, s, e, 1, hw)
        e1 = b.relu(f"{name}/expand1x1/relu", e1, dims=[1, e, *hw])
        e3, _ = b.conv(f"{name}/expand3x3", sq, s, e, 3, hw)
        e3 = b.relu(f"{name}/expand3x3/relu", e3, dims=[1, e, *hw])
        return b.add("Concat", f"{name}/concat", [e1, e3], {"axis": "1"},
                     dims=[1, 2 * e, *hw]), 2 * e

    x, cin = fire(x, cin, 8, 32, hw, "fire2")
    x, cin = fire(x, cin, 8, 32, hw, "fire3")
    x, hw = b.maxpool_ceil("pool3", x, cin, hw)
    x, cin = fire(x, cin, 16, 64, hw, "fire4")
    x, cin = fire(x, cin, 16, 64, hw, "fire5")
    x, hw = b.maxpool_ceil("pool5", x, cin, hw)
    x, cin = fire(x, cin, 24, 96, hw, "fire6")
    x, cin = fire(x, cin, 24, 96, hw, "fire7")
    x, cin = fire(x, cin, 32, 128, hw, "fire8")
    x, cin = fire(x, cin, 32, 128, hw, "fire9")
    assert hw == (18, 18), hw  # stride 16 (ceil pools) at 300
    x, hw = b.conv("conv10_context", x, cin, 160, 3, hw)
    x = b.relu("conv10_context/relu", x, dims=[1, 160, *hw])
    _ssd_head(b, x, 160, hw, img, *_CLUSTERS_300, param_ref=param)
    return b.layers, b.edges


_TOPOLOGIES = {
    "ov-0204": face_detection_0204_defs,
    "ov-squeezenet-light": face_detection_retail_0004_defs,
}


def build_ov_topology(name: str, seed: int = 0) -> IRGraph:
    """IRGraph for one of the reference's OpenVINO detector topologies."""
    layers, edges = _TOPOLOGIES[name](seed)
    return IRGraph(layers=layers, edges=edges)


def count_params(name: str) -> int:
    """Trainable parameter count of a topology (model-card comparisons)."""
    layers, _ = _TOPOLOGIES[name]()
    return sum(int(np.prod(L.value.shape)) for L in layers
               if L.type == "Const" and L.value is not None
               and np.issubdtype(L.value.dtype, np.floating))
