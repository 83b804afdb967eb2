"""OpenVINO IR graphs, executed as the file defines them.

The counterpart of ``models/ov_graph.py`` in the JAX package. The reference
compiles face-detection-0204 and the SqueezeNet-light SSD with the OpenVINO
runtime (``modules/openvino/model.py``); here the IR *is* the net.
``OVGraphNet`` walks the parsed topology (``utils/ir_graph.py``), burns the
structural constants (reshape targets, transpose orders, prior boxes) into a
step list at build time, and replays the tensor ops in the IR's own NCHW
semantics: Reshape, Transpose, Squeeze and the axes of SoftMax, Concat and
ReduceMean are the file's, as written. PriorBox and PriorBoxClustered are
computed on the host at build time (static given the input shape);
DetectionOutput is ``make_ov_detect``, the Caffe interpreter's decode with
the IR's class count, ``top_k`` and ``keep_top_k``, its NMS the kernel B1.

Ops: Parameter, Result, Const and Convert chains, Convolution and
GroupConvolution, Add, Multiply, Subtract, Maximum, Divide, PReLU, ReLU,
Sigmoid, Elu, Tanh, Clamp, SoftMax, MaxPool, AvgPool, ReduceMean, Concat,
Reshape, Squeeze, Unsqueeze, Transpose, MatMul, PriorBox,
PriorBoxClustered, DetectionOutput and Interpolate (nearest, at an integer
uniform scale): the closed set the reference's IRs draw from, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.ir_graph import IRGraph
from ..utils.model_formats import _IR_DTYPES
from .caffe_ssd import caffe_priorbox, make_detection_output, pool2d
from .layers import jax_clip, param_key


def _floats(s: str) -> List[float]:
    return [float(v) for v in s.split(",") if v.strip()]


def _ints(s: str) -> List[int]:
    return [int(float(v)) for v in s.split(",") if v.strip()]


def _flag(attrs: Dict[str, str], key: str, default: str) -> bool:
    return str(attrs.get(key, default)).lower() in ("1", "true")


def priorbox_clustered(fh: int, fw: int, img_w: int, img_h: int,
                       attrs: Dict[str, str]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """PriorBoxClustered (the face-detection-020x anchors): in each cell,
    one prior a clustered (width, height) pair, centred on the step
    grid. Returns (corners [N, 4] normalized, variances [N, 4])."""
    widths = _floats(attrs.get("width", ""))
    heights = _floats(attrs.get("height", ""))
    step = float(attrs.get("step", 0.0) or 0.0)
    step_w = float(attrs.get("step_w", 0.0) or 0.0) or step or img_w / fw
    step_h = float(attrs.get("step_h", 0.0) or 0.0) or step or img_h / fh
    offset = float(attrs.get("offset", 0.5))
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for w_, h_ in zip(widths, heights):
                boxes.append([(cx - w_ / 2) / img_w, (cy - h_ / 2) / img_h,
                              (cx + w_ / 2) / img_w, (cy + h_ / 2) / img_h])
    corners = np.asarray(boxes, np.float32)
    if _flag(attrs, "clip", "0"):
        corners = np.clip(corners, 0.0, 1.0)
    v = np.asarray(_floats(attrs.get("variance", "")) or [0.1], np.float32)
    if v.size == 1:
        v = np.repeat(v, 4)
    return corners, np.tile(v[None], (len(corners), 1))


def priorbox_op(fh: int, fw: int, img_w: int, img_h: int,
                attrs: Dict[str, str]) -> Tuple[np.ndarray, np.ndarray]:
    """The IR's PriorBox (min / max sizes, aspect ratios): Caffe's
    PriorBox math (``caffe_ssd.caffe_priorbox``)."""
    return caffe_priorbox(fh, fw, img_w, img_h, {
        "min_size": _floats(attrs.get("min_size", "")),
        "max_size": _floats(attrs.get("max_size", "")),
        "aspect_ratio": _floats(attrs.get("aspect_ratio", "")),
        "flip": _flag(attrs, "flip", "1"),
        "clip": _flag(attrs, "clip", "0"),
        "variance": _floats(attrs.get("variance", "")) or [0.1],
        "step": float(attrs.get("step", 0.0)) or None,
        "offset": float(attrs.get("offset", 0.5)),
    })


@dataclasses.dataclass
class _Step:
    op: str
    name: str
    inputs: List[str]      # tensor keys "layer:port"
    output: str
    attrs: Dict[str, object]


_BINOPS = {"Add": torch.add, "Multiply": torch.mul, "Subtract": torch.sub,
           "Maximum": torch.maximum, "Divide": torch.div}
_UNARY = {"ReLU": F.relu, "Sigmoid": torch.sigmoid, "Elu": F.elu,
          "Tanh": torch.tanh}


class OVGraphNet(nn.Module):
    """One OpenVINO IR graph as a module.

    Every float constant that feeds a weight input (convolution kernels,
    the constant operand of an elementwise op, PReLU slopes, MatMul
    weights) is registered in f32 under ``consts.<param_key(name)>``, by
    the name of the layer that gives it (a Const, or the last Convert of
    its chain); ``weight_names`` maps each file name to its key.
    ``forward`` takes NHWC [B, H, W, C] (raw BGR, as the reference feeds
    OpenVINO) and returns the graph's output: (loc [B, N*4], conf [B,
    N*ncls]) for a DetectionOutput graph, whatever batch the IR's reshape
    literals name. ``input_dims`` is the Parameter's NCHW shape.

    A bf16 ``compute_dtype`` runs the graph as the JAX interpreter does on
    a bf16 input (``make_ov_detect(net, compute_dtype=bf16)``, JAX
    ``models/ov_graph.py:555-588``): the input cast to bf16, each
    convolution's or MatMul's weights cast to its input's dtype, and
    every op promoting as JAX promotes, so that a bf16 tensor meeting an
    f32 constant (a bias ``Add``) gives f32: the reference's IRs run their
    first convolution in bf16 (its sums rounded to bf16) and the rest in
    f32."""

    compute_dtype = torch.float32

    def __init__(self, graph: IRGraph):
        super().__init__()
        self.graph = graph
        self.steps: List[_Step] = []
        self.priors: Optional[np.ndarray] = None
        self.prior_variances: Optional[np.ndarray] = None
        self.detection_cfg: Optional[Dict[str, float]] = None
        self.input_key: Optional[str] = None
        self.input_dims: Optional[List[int]] = None
        self.outputs: List[str] = []
        self.consts = nn.ParameterDict()
        self.weight_names: Dict[str, str] = {}
        self._build()

    # -- build ---------------------------------------------------------------
    def _const_value(self, lid: int) -> Optional[np.ndarray]:
        """A layer id's constant value, through Convert chains; None for
        a tensor."""
        L = self.graph.by_id(lid)
        if L.type == "Const":
            return L.value
        if L.type == "Convert":
            src = self.graph.inputs_of(L)
            if src:
                v = self._const_value(src[0][0])
                if v is not None:
                    dt = L.attrs.get("destination_type", "f32").lower()
                    return v.astype(_IR_DTYPES.get(dt, np.float32))
        return None

    def _weight(self, lid: int, prefix: str, owner: int) -> Optional[str]:
        """Register layer ``lid``'s constant value in f32 and return its
        name; None when ``lid`` is not a constant."""
        v = self._const_value(lid)
        if v is None:
            return None
        name = self.graph.by_id(lid).name or f"{prefix}{owner}"
        self.consts[param_key(name)] = nn.Parameter(
            torch.tensor(np.asarray(v, np.float32)), requires_grad=False)
        self.weight_names[name] = param_key(name)
        return name

    def _axes(self, lid: int) -> List[int]:
        return [int(a) for a in np.asarray(self._const_value(lid)).reshape(-1)]

    def _build(self):
        g = self.graph
        prior_parts: List[Tuple[np.ndarray, np.ndarray]] = []
        prior_keys: set = set()
        for L in g.layers:
            t = L.type
            if t in ("Const", "Convert"):
                continue
            out_port = L.output_ports[0] if L.output_ports else 0
            out_key = f"{L.id}:{out_port}"
            srcs = g.inputs_of(L)
            ins = [f"{lid}:{port}" for lid, port in srcs]
            a = L.attrs
            step = None
            if t == "Parameter":
                self.input_key = out_key
                self.input_dims = (L.port_dims.get(out_port)
                                   or _ints(a.get("shape", "")))
            elif t == "Result":
                if ins:
                    self.outputs.append(ins[0])
            elif t in ("Convolution", "GroupConvolution"):
                w = self._weight(srcs[1][0], "w", L.id)
                if w is None:
                    raise NotImplementedError(
                        f"{t} '{L.name}': non-const weights")
                step = _Step("conv", L.name, [ins[0], w], out_key, {
                    "strides": _ints(a.get("strides", "1,1")),
                    "pads_begin": _ints(a.get("pads_begin", "0,0")),
                    "pads_end": _ints(a.get("pads_end", "0,0")),
                    "dilations": _ints(a.get("dilations", "1,1")),
                    "grouped": t == "GroupConvolution"})
            elif t in _BINOPS:
                # the second operand: a constant (bias, scale) or a tensor
                w = self._weight(srcs[1][0], "c", L.id) \
                    if len(srcs) > 1 else None
                step = _Step("binop", L.name,
                             [ins[0], w] if w is not None else ins, out_key,
                             {"kind": t, "const2": w is not None})
            elif t == "PReLU":
                step = _Step("prelu", L.name,
                             [ins[0], self._weight(srcs[1][0], "a", L.id)],
                             out_key, {})
            elif t in _UNARY:
                step = _Step("unary", L.name, ins[:1], out_key, {"kind": t})
            elif t == "Clamp":
                step = _Step("clamp", L.name, ins[:1], out_key,
                             {"min": float(a.get("min", 0)),
                              "max": float(a.get("max", 6))})
            elif t == "SoftMax":
                step = _Step("softmax", L.name, ins[:1], out_key,
                             {"axis": int(a.get("axis", 1))})
            elif t in ("MaxPool", "AvgPool"):
                step = _Step("pool", L.name, ins[:1], out_key, {
                    "mode": "max" if t == "MaxPool" else "avg",
                    "kernel": _ints(a.get("kernel", "2,2")),
                    "strides": _ints(a.get("strides", "1,1")),
                    "pads_begin": _ints(a.get("pads_begin", "0,0")),
                    "pads_end": _ints(a.get("pads_end", "0,0")),
                    "ceil": a.get("rounding_type", "floor") == "ceil",
                    "exclude_pad": _flag(a, "exclude-pad",
                                         a.get("exclude_pad", "true"))})
            elif t == "ReduceMean":
                step = _Step("reduce_mean", L.name, ins[:1], out_key,
                             {"axes": self._axes(srcs[1][0]),
                              "keep": _flag(a, "keep_dims", "true")})
            elif t == "Concat":
                if all(k in prior_keys for k in ins):
                    prior_keys.add(out_key)
                    step = _Step("prior", L.name, [], out_key, {})
                else:
                    step = _Step("concat", L.name, ins, out_key,
                                 {"axis": int(a.get("axis", 1))})
            elif t == "Reshape":
                step = _Step("reshape", L.name, ins[:1], out_key, {
                    "shape": self._axes(srcs[1][0]),
                    "special_zero": _flag(a, "special_zero", "true")})
            elif t in ("Squeeze", "Unsqueeze"):
                step = _Step(t.lower(), L.name, ins[:1], out_key, {
                    "axes": self._axes(srcs[1][0]) if len(srcs) > 1 else []})
            elif t == "Transpose":
                step = _Step("transpose", L.name, ins[:1], out_key,
                             {"order": self._axes(srcs[1][0])})
            elif t == "MatMul":
                w = self._weight(srcs[1][0], "w", L.id)
                step = _Step("matmul", L.name,
                             [ins[0], w] if w is not None else ins, out_key, {
                                 "ta": _flag(a, "transpose_a", "false"),
                                 "tb": _flag(a, "transpose_b", "false"),
                                 "const2": w is not None})
            elif t in ("PriorBoxClustered", "PriorBox"):
                prior_parts.append(self._priors(L, srcs))
                prior_keys.add(out_key)
                step = _Step("prior", L.name, [], out_key, {})
            elif t == "DetectionOutput":
                self.detection_cfg = {
                    "num_classes": int(a.get("num_classes", 2)),
                    "background_label_id": int(a.get("background_label_id",
                                                     0)),
                    "nms_threshold": float(a.get("nms_threshold", 0.45)),
                    "top_k": int(a.get("top_k", 400)),
                    "keep_top_k": _ints(str(a.get("keep_top_k", "200")))[0],
                    "confidence_threshold": float(
                        a.get("confidence_threshold", 0.01)),
                }
                self.outputs = [out_key]
                step = _Step("detection_output", L.name, ins[:2], out_key, {})
            elif t == "Interpolate":
                step = _Step("interp_nearest", L.name, ins[:1], out_key,
                             {"factor": self._interp_factor(L, srcs,
                                                            out_port)})
            else:
                raise NotImplementedError(f"IR op '{t}' ({L.name})")
            if step is not None:
                self.steps.append(step)
        if prior_parts:
            self.priors = np.concatenate([c for c, _ in prior_parts], 0)
            self.prior_variances = np.concatenate(
                [v for _, v in prior_parts], 0)
        if not self.outputs and self.steps:
            self.outputs = [self.steps[-1].output]

    def _priors(self, L, srcs) -> Tuple[np.ndarray, np.ndarray]:
        """A prior layer's table: the grid of its source feature map (a
        shape constant, or the source's port dims) over the image size (a
        shape constant, else the Parameter's)."""
        g = self.graph
        fdims = None
        v0 = self._const_value(srcs[0][0]) if srcs else None
        if v0 is not None and np.asarray(v0).size in (2, 4):
            fdims = [int(x) for x in np.asarray(v0).reshape(-1)][-2:]
        else:
            dims = g.by_id(srcs[0][0]).port_dims.get(srcs[0][1]) or []
            if len(dims) == 4:
                fdims = dims[2:]
        if fdims is None:
            raise NotImplementedError(
                f"{L.type} '{L.name}': cannot resolve feature grid")
        iw = ih = None
        if len(srcs) > 1:
            v1 = self._const_value(srcs[1][0])
            if v1 is not None and np.asarray(v1).size in (2, 4):
                ih, iw = [int(x) for x in np.asarray(v1).reshape(-1)][-2:]
        if iw is None and self.input_dims and len(self.input_dims) == 4:
            ih, iw = self.input_dims[2], self.input_dims[3]
        fn = priorbox_clustered if L.type == "PriorBoxClustered" \
            else priorbox_op
        return fn(fdims[0], fdims[1], iw, ih, L.attrs)

    def _interp_factor(self, L, srcs, out_port) -> int:
        """Interpolate's integer, uniform scale from the xml's port dims
        (2, the FPN's, where they are missing); any other mode or scale
        raises ``NotImplementedError`` naming the layer."""
        mode = str(L.attrs.get("mode", "nearest")).lower()
        if "nearest" not in mode:
            raise NotImplementedError(
                f"Interpolate '{L.name}': mode '{mode}' unsupported "
                "(nearest only)")
        out_dims = L.port_dims.get(out_port) or []
        src = self.graph.by_id(srcs[0][0]) if srcs else None
        in_dims = (src.port_dims.get(srcs[0][1]) or []) if src else []
        if len(out_dims) == 4 and len(in_dims) == 4 and in_dims[2] \
                and in_dims[3]:
            fy, fx = out_dims[2] / in_dims[2], out_dims[3] / in_dims[3]
            if fy != fx or not float(fy).is_integer() or fy < 1:
                raise NotImplementedError(
                    f"Interpolate '{L.name}': non-uniform or non-integer "
                    f"scale ({fy}, {fx})")
            return int(fy)
        return 2

    def weight(self, name: str) -> torch.Tensor:
        """A weight by the file's constant name."""
        return self.consts[self.weight_names[name]]

    # -- execution -----------------------------------------------------------
    def forward(self, imgs: torch.Tensor, taps: Sequence[str] = ()):
        """imgs: [B, H, W, C], raw BGR values. With ``taps`` (layer names)
        it returns {layer: output} after the whole run (the trainer reads
        the heads' ``mbox_loc_flat`` and ``mbox_conf_reshape``, before the
        softmax)."""
        env: Dict[str, object] = {
            self.input_key or "data":
                imgs.to(self.compute_dtype).permute(0, 3, 1, 2)}
        for s in self.steps:
            x = env[s.inputs[0]] if s.inputs else None
            env[s.output] = self._run(s, x, env)
        if taps:
            by_name = {s.name: s.output for s in self.steps}
            return {t: env[by_name[t]] for t in taps}
        return env[self.outputs[0]]

    def train_consts(self) -> List[torch.nn.Parameter]:
        """Make every registered constant trainable and return them."""
        for c in self.consts.values():
            c.requires_grad_(True)
        return list(self.consts.values())

    def _operand(self, s: _Step, env) -> torch.Tensor:
        return (self.consts[param_key(s.inputs[1])] if s.attrs["const2"]
                else env[s.inputs[1]])

    def _run(self, s: _Step, x, env):
        op, a = s.op, s.attrs
        if op == "conv":
            w = self.consts[param_key(s.inputs[1])].to(x.dtype)
            groups = 1
            if a["grouped"]:  # [G, O/G, I/G, kh, kw]
                groups = w.shape[0]
                w = w.reshape((-1,) + tuple(w.shape[2:]))
            (pt, pl), (pb, pr) = a["pads_begin"], a["pads_end"]
            if (pt, pl) == (pb, pr):
                return F.conv2d(x, w, None, a["strides"], (pt, pl),
                                a["dilations"], groups)
            return F.conv2d(F.pad(x, (pl, pr, pt, pb)), w, None,
                            a["strides"], 0, a["dilations"], groups)
        if op == "binop":
            y = self._operand(s, env)
            if x.dtype != y.dtype:  # JAX's promotion: an f32 constant wins
                t = torch.promote_types(x.dtype, y.dtype)
                x, y = x.to(t), y.to(t)
            return _BINOPS[a["kind"]](x, y)
        if op == "prelu":
            alpha = self.consts[param_key(s.inputs[1])].reshape(-1)
            if x.dim() == 4 and alpha.numel() > 1:
                alpha = alpha.reshape(1, -1, 1, 1)  # a slope a channel
            return torch.where(x >= 0, x, x * alpha)
        if op == "unary":
            return _UNARY[a["kind"]](x)
        if op == "clamp":  # with jnp.clip's gradient, for training
            return jax_clip(x, a["min"], a["max"])
        if op == "softmax":
            return torch.softmax(x, a["axis"])
        if op == "pool":
            (kh, kw), (sh, sw) = a["kernel"], a["strides"]
            pb, pe = list(a["pads_begin"]), list(a["pads_end"])
            if a["ceil"]:
                hh, ww = x.shape[2:]
                oh = math.ceil((hh + pb[0] + pe[0] - kh) / sh) + 1
                ow = math.ceil((ww + pb[1] + pe[1] - kw) / sw) + 1
                pe = [max((oh - 1) * sh + kh - hh - pb[0], pe[0]),
                      max((ow - 1) * sw + kw - ww - pb[1], pe[1])]
            return pool2d(x, a["mode"], (kh, kw), (sh, sw), tuple(pb),
                          tuple(pe), a["exclude_pad"])
        if op == "reduce_mean":
            return x.mean(tuple(a["axes"]), keepdim=a["keep"])
        if op == "concat":
            return torch.cat([env[k] for k in s.inputs], a["axis"])
        if op == "reshape":
            return x.reshape([x.shape[i] if d == 0 and a["special_zero"]
                              else d for i, d in enumerate(a["shape"])])
        if op == "squeeze":
            if not a["axes"]:
                return x.squeeze()
            for ax in sorted((d % x.dim() for d in a["axes"]), reverse=True):
                x = x.squeeze(ax)
            return x
        if op == "unsqueeze":
            for ax in sorted(a["axes"]):
                x = x.unsqueeze(ax)
            return x
        if op == "transpose":
            return x.permute(a["order"])
        if op == "matmul":
            y = self._operand(s, env)
            xa = x.transpose(-1, -2) if a["ta"] else x
            yb = y.transpose(-1, -2) if a["tb"] else y
            return xa @ yb.to(xa.dtype)
        if op == "prior":
            return None
        if op == "detection_output":
            # the batch comes from the images: the IR's reshape targets
            # are batch-1 literals ([1, -1]), so for B > 1 the batch is
            # folded into their flat axis
            b = env[self.input_key or "data"].shape[0]
            return (x.reshape(b, -1), env[s.inputs[1]].reshape(b, -1))
        if op == "interp_nearest":
            f = int(a["factor"])
            return x.repeat_interleave(f, 2).repeat_interleave(f, 3)
        raise AssertionError(op)  # pragma: no cover


def make_ov_detect(net: OVGraphNet) -> Callable:
    """decode((loc, conf), in_hw) -> (dets [B, K, 5] normalized xyxy +
    conf, valid): the DetectionOutput of the IR, in f32, with its class
    count, ``top_k``, ``keep_top_k`` and thresholds; NMS by B1."""
    if net.detection_cfg is None:
        raise ValueError("IR has no DetectionOutput")
    dc = net.detection_cfg
    return make_detection_output(
        net.priors, net.prior_variances, dc["num_classes"], dc["top_k"],
        dc["confidence_threshold"], dc["nms_threshold"], dc["keep_top_k"])
