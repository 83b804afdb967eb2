"""Caffe SSD deploy graphs, executed as the file defines them.

The counterpart of ``models/caffe_ssd.py`` in the JAX package. The reference
runs OpenCV's res10_300x300 SSD through cv2.dnn
(``modules/opencv2_dnn/model.py:11-37``); here ``CaffeGraphNet`` interprets
the NetParameter graph itself (``utils/caffe_graph.read_caffemodel_graph``),
so a real ``.caffemodel``, a training snapshot that embeds its layer
definitions, builds the real net: layer widths, PriorBox sizes, aspect
ratios and variances all come from the file.

The build infers every blob's shape on the host and emits a flat step list;
``forward`` replays it in the graph's own NCHW semantics, so Permute,
Flatten, Reshape and Concat are the file's operations as written. PriorBox
layers are computed at build time (they are static given the input size),
and DetectionOutput is ``make_caffe_ssd_detect``: variance decode, the
``top_k`` best scores, greedy NMS (the kernel B1, one launch for the batch)
and ``keep_top_k``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import greedy_nms, top_k
from ..utils.caffe_graph import CaffeLayerDef
from .layers import param_key


# ---------------------------------------------------------------------------
# PriorBox: Caffe's semantics (min/max sizes, aspect ratios, flip, clip)
# ---------------------------------------------------------------------------

def caffe_priorbox(fh: int, fw: int, img_w: int, img_h: int,
                   p: Dict[str, object]) -> Tuple[np.ndarray, np.ndarray]:
    """One PriorBox layer -> (priors [N, 4] corners normalized, variances
    [N, 4]), in prior_box_layer.cpp's order: a cell at a time, for each
    min_size the min square, the sqrt(min * max) square, then the aspect
    ratio boxes (flip pairs)."""
    step_w = p.get("step") or img_w / fw
    step_h = p.get("step") or img_h / fh
    offset = p.get("offset", 0.5)
    ars: List[float] = [1.0]
    for ar in p.get("aspect_ratio", []):
        if not any(abs(ar - x) < 1e-6 for x in ars):
            ars.append(ar)
            if p.get("flip", True):
                ars.append(1.0 / ar)
    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for i, mn in enumerate(p.get("min_size", [])):
                boxes.append([cx, cy, mn, mn])
                maxs = p.get("max_size", [])
                if i < len(maxs):
                    s = math.sqrt(mn * maxs[i])
                    boxes.append([cx, cy, s, s])
                for ar in ars[1:]:
                    boxes.append([cx, cy, mn * math.sqrt(ar),
                                  mn / math.sqrt(ar)])
    b = np.asarray(boxes, np.float32)
    corners = np.stack([
        (b[:, 0] - b[:, 2] / 2) / img_w, (b[:, 1] - b[:, 3] / 2) / img_h,
        (b[:, 0] + b[:, 2] / 2) / img_w, (b[:, 1] + b[:, 3] / 2) / img_h,
    ], axis=1)
    if p.get("clip", False):
        corners = np.clip(corners, 0.0, 1.0)
    var = np.asarray(p.get("variance", [0.1]), np.float32)
    if var.size == 1:
        var = np.repeat(var, 4)
    return corners, np.tile(var[None, :], (len(corners), 1))


def priors_per_cell(p: Dict[str, object]) -> int:
    """Priors a PriorBox layer places in each cell."""
    n_ar = 0
    seen = [1.0]
    for ar in p.get("aspect_ratio", []):
        if not any(abs(ar - x) < 1e-6 for x in seen):
            seen.append(ar)
            n_ar += 2 if p.get("flip", True) else 1
            if p.get("flip", True):
                seen.append(1.0 / ar)
    return len(p.get("min_size", [])) * (1 + (1 if p.get("max_size") else 0)
                                         + n_ar)


# ---------------------------------------------------------------------------
# ops shared with the OpenVINO interpreter
# ---------------------------------------------------------------------------

def pool2d(x: torch.Tensor, mode: str, kernel: Tuple[int, int],
           stride: Tuple[int, int], pad_lo: Tuple[int, int],
           pad_hi: Tuple[int, int], exclude_pad: bool = True) -> torch.Tensor:
    """Max or average pooling of NCHW ``x`` over windows of a padded
    input, (lo, hi) padding a spatial axis (asymmetric, as ceil mode and
    OpenVINO's pads_begin / pads_end need it). Max pads with -inf; the
    average sums over the window and divides by the count of input
    elements in it (``exclude_pad``) or by the window's size."""
    pads = (pad_lo[1], pad_hi[1], pad_lo[0], pad_hi[0])
    padded = any(pads)
    if mode == "max":
        xp = F.pad(x, pads, value=-math.inf) if padded else x
        return F.max_pool2d(xp, kernel, stride)
    xp = F.pad(x, pads) if padded else x
    y = F.avg_pool2d(xp, kernel, stride, divisor_override=1)
    if not exclude_pad:
        return y / (kernel[0] * kernel[1])
    ones = x.new_ones((1, 1) + tuple(x.shape[2:]))
    cnt = F.avg_pool2d(F.pad(ones, pads) if padded else ones, kernel, stride,
                       divisor_override=1)
    return y / cnt


def decode_variance_priors(locs: torch.Tensor, priors_center: torch.Tensor,
                           variances: torch.Tensor) -> torch.Tensor:
    """Caffe CENTER_SIZE decode, each prior's variances from its PriorBox
    layer: locs [B, N, 4] -> xyxy [B, N, 4] normalized."""
    pc = priors_center
    cx = pc[:, 0] + locs[..., 0] * variances[:, 0] * pc[:, 2]
    cy = pc[:, 1] + locs[..., 1] * variances[:, 1] * pc[:, 3]
    pw = pc[:, 2] * torch.exp(locs[..., 2] * variances[:, 2])
    ph = pc[:, 3] * torch.exp(locs[..., 3] * variances[:, 3])
    return torch.stack([cx - pw / 2, cy - ph / 2, cx + pw / 2, cy + ph / 2],
                       -1)


def prior_centers(corners: np.ndarray) -> np.ndarray:
    """Corner priors -> [cx, cy, w, h], in f32 as the JAX package makes
    them."""
    return np.stack([
        (corners[:, 0] + corners[:, 2]) / 2,
        (corners[:, 1] + corners[:, 3]) / 2,
        corners[:, 2] - corners[:, 0], corners[:, 3] - corners[:, 1],
    ], axis=1)


def make_detection_output(corners: np.ndarray, variances: np.ndarray,
                          ncls: int, top: int, conf_thres: float,
                          iou: float, keep: int) -> Callable:
    """The SSD DetectionOutput on a graph's (loc [B, N*4], conf [B, N *
    ncls] probabilities), in f32: variance decode, the ``top`` best face
    scores (class 1; ties to the lower prior, ``ops.nms.top_k``), greedy
    NMS (B1, one launch for the batch) over those above ``conf_thres``,
    then the ``keep`` best. Returns decode((loc, conf), in_hw) -> (dets
    [B, keep, 5] rows [x1, y1, x2, y2, conf] normalized, valid [B, keep]).
    The priors are normalized: the input size does not enter."""
    centers = prior_centers(corners)
    n = len(centers)
    top = min(top, n)
    on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def decode(raw: Tuple[torch.Tensor, torch.Tensor],
               in_hw: Tuple[int, int]):
        loc, conf = raw
        dev = loc.device
        if dev not in on_device:
            on_device[dev] = (torch.from_numpy(centers).to(dev),
                              torch.from_numpy(variances).to(dev))
        pc, var = on_device[dev]
        b = loc.shape[0]
        boxes = decode_variance_priors(loc.float().reshape(b, n, 4), pc, var)
        probs = conf.float().reshape(b, n, ncls)[..., 1]
        top_c, idx = top_k(probs, top)
        rows = torch.cat([torch.take_along_dim(boxes, idx[..., None], 1),
                          top_c[..., None]], -1)
        return greedy_nms(rows, top_c > conf_thres, iou, keep, score_col=4)

    return decode


# ---------------------------------------------------------------------------
# the graph interpreter
# ---------------------------------------------------------------------------

_SKIP_TYPES = {"Input", "Data", "Dropout", "Silence", "Split"}


@dataclasses.dataclass
class _Step:
    op: str
    name: str
    inputs: List[str]
    output: str
    attrs: Dict[str, object]


class CaffeGraphNet(nn.Module):
    """One Caffe deploy graph as a module.

    The build infers each blob's NCHW shape and registers every layer's
    blobs under ``blobs.<param_key(layer name)>.<i>`` (a Caffe layer name
    may hold '.' or '/'); blobs a layer lacks are drawn from ``generator``
    (convolution kernels, N(0, 1 / fan_in)) or set to the identity (biases
    0, BatchNorm mean 0, variance 1, scale factor 1, Scale 1, Normalize
    20). ``forward`` takes NHWC [B, H, W, C] (mean-subtracted BGR) and
    returns the graph's output: (loc [B, N*4], conf [B, N*ncls]) for a
    DetectionOutput graph."""

    def __init__(self, layers: Sequence[CaffeLayerDef],
                 input_size: Tuple[int, int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = tuple(input_size)  # (w, h)
        self.layer_defs = list(layers)
        self.steps: List[_Step] = []
        self.priors: Optional[np.ndarray] = None
        self.prior_variances: Optional[np.ndarray] = None
        self.detection_cfg: Optional[Dict[str, object]] = None
        self.outputs: List[str] = []
        self.blobs = nn.ModuleDict()
        self._generator = generator or torch.Generator().manual_seed(0)
        self._build()

    # -- build ---------------------------------------------------------------
    def _add_blobs(self, name: str, blobs: Sequence) -> None:
        self.blobs[param_key(name)] = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(b, np.float32)),
                         requires_grad=False) for b in blobs)

    def layer_blobs(self, name: str) -> List[torch.Tensor]:
        """A layer's blobs, by the file's layer name."""
        return list(self.blobs[param_key(name)])

    def blob_layers(self) -> List[str]:
        """The names of the layers that hold blobs, in graph order."""
        return [s.name for s in self.steps
                if param_key(s.name) in self.blobs]

    def _build(self):
        w, h = self.input_size
        shapes: Dict[str, Tuple[int, ...]] = {"data": (1, 3, h, w)}
        prior_parts: List[Tuple[np.ndarray, np.ndarray]] = []
        prior_tops: set = set()  # blobs that exist at build time only
        for L in self.layer_defs:
            lt = L.type
            if lt in _SKIP_TYPES:
                # an alias, where the layer renames its bottom (Input
                # layers have none)
                if L.tops and L.bottoms and L.tops[0] != L.bottoms[0] \
                        and L.bottoms[0] in shapes:
                    shapes[L.tops[0]] = shapes[L.bottoms[0]]
                    self.steps.append(_Step("identity", L.name,
                                            [L.bottoms[0]], L.tops[0], {}))
                continue
            bot = L.bottoms[0] if L.bottoms else "data"
            top = L.tops[0] if L.tops else L.name
            step = self._build_layer(L, lt, bot, top, shapes, prior_parts,
                                     prior_tops)
            self.steps.append(step)
            # in-place layers: extra tops alias the first
            for extra in (L.tops[1:] if L.tops else []):
                shapes[extra] = shapes[top]
        if prior_parts:
            self.priors = np.concatenate([c for c, _ in prior_parts], 0)
            self.prior_variances = np.concatenate(
                [v for _, v in prior_parts], 0)
        if not self.outputs:
            # a feature-extractor graph: its last blob is the output
            self.outputs = [self.steps[-1].output] if self.steps else []

    def _build_layer(self, L, lt, bot, top, shapes, prior_parts, prior_tops
                     ) -> _Step:
        w, h = self.input_size
        if lt == "Convolution":
            p = L.params.get("conv", {})
            n_out = int(p.get("num_output"))
            kh = kw = int(p.get("kernel", [3])[0])
            if len(p.get("kernel", [])) == 2:
                kh, kw = [int(v) for v in p["kernel"]]
            sh, sw = ([int(v) for v in p.get("stride", [1])] * 2)[:2]
            ph, pw = ([int(v) for v in p.get("pad", [0])] * 2)[:2]
            dil = int(p.get("dilation", [1])[0])
            group = int(p.get("group", 1))
            bias = bool(p.get("bias_term", True))
            b_, c_, hh, ww = shapes[bot]
            if L.blobs:
                blobs = [L.blobs[0].reshape(n_out, c_ // group, kh, kw)]
                if bias:
                    blobs.append(L.blobs[1] if len(L.blobs) > 1
                                 else np.zeros(n_out, np.float32))
            else:
                scale = 1.0 / math.sqrt(c_ // group * kh * kw)
                blobs = [torch.randn((n_out, c_ // group, kh, kw),
                                     generator=self._generator) * scale]
                if bias:
                    blobs.append(np.zeros(n_out, np.float32))
            self._add_blobs(L.name, blobs)
            oh = (hh + 2 * ph - dil * (kh - 1) - 1) // sh + 1
            ow = (ww + 2 * pw - dil * (kw - 1) - 1) // sw + 1
            shapes[top] = (b_, n_out, oh, ow)
            return _Step("conv", L.name, [bot], top, {
                "stride": (sh, sw), "pad": (ph, pw), "dilation": dil,
                "group": group, "bias": bias})
        if lt == "InnerProduct":
            if not L.blobs:
                raise ValueError(
                    f"InnerProduct '{L.name}' needs blobs or num_output")
            self._add_blobs(L.name, L.blobs)
            shapes[top] = (shapes[bot][0], L.blobs[0].shape[0])
            return _Step("inner_product", L.name, [bot], top, {})
        if lt == "BatchNorm":
            c_ = shapes[bot][1]
            self._add_blobs(L.name, L.blobs or [
                np.zeros(c_, np.float32), np.ones(c_, np.float32),
                np.ones(1, np.float32)])
            shapes[top] = shapes[bot]
            return _Step("batchnorm", L.name, [bot], top, {})
        if lt == "Scale":
            bias = bool(L.params.get("scale", {}).get("bias_term", False))
            c_ = shapes[bot][1]
            if L.blobs:
                blobs = list(L.blobs)
                bias = len(blobs) > 1
            else:
                blobs = [np.ones(c_, np.float32)] + (
                    [np.zeros(c_, np.float32)] if bias else [])
            self._add_blobs(L.name, blobs)
            shapes[top] = shapes[bot]
            return _Step("scale", L.name, [bot], top, {"bias": bias})
        if lt in ("ReLU", "ReLU6", "Sigmoid"):
            shapes[top] = shapes[bot]
            return _Step("sigmoid" if lt == "Sigmoid" else "relu", L.name,
                         [bot], top, {})
        if lt == "Pooling":
            p = L.params.get("pool", {})
            b_, c_, hh, ww = shapes[bot]
            if p.get("global"):
                shapes[top] = (b_, c_, 1, 1)
                return _Step("global_pool", L.name, [bot], top,
                             {"mode": p.get("pool", "max")})
            k = int(p.get("kernel", 2))
            s = int(p.get("stride", 1))
            pd = int(p.get("pad", 0))
            # caffe sizes the output by CEIL, and clips a last window that
            # would start in the padding
            oh = int(math.ceil((hh + 2 * pd - k) / s)) + 1
            ow = int(math.ceil((ww + 2 * pd - k) / s)) + 1
            if pd > 0:
                if (oh - 1) * s >= hh + pd:
                    oh -= 1
                if (ow - 1) * s >= ww + pd:
                    ow -= 1
            shapes[top] = (b_, c_, oh, ow)
            return _Step("pool", L.name, [bot], top, {
                "mode": p.get("pool", "max"), "kernel": (k, k),
                "stride": (s, s), "pad_lo": (pd, pd),
                "pad_hi": (max((oh - 1) * s + k - hh - pd, 0),
                           max((ow - 1) * s + k - ww - pd, 0))})
        if lt == "LRN":
            p = L.params.get("lrn", {})
            if p.get("norm_region", 0) != 0:
                raise NotImplementedError(
                    f"LRN '{L.name}': WITHIN_CHANNEL norm_region")
            shapes[top] = shapes[bot]
            return _Step("lrn", L.name, [bot], top, dict(p))
        if lt == "Eltwise":
            shapes[top] = shapes[L.bottoms[0]]
            return _Step("eltwise", L.name, list(L.bottoms), top, {
                "operation": L.params.get("eltwise", {}).get("operation",
                                                             "sum")})
        if lt == "Normalize":
            self._add_blobs(L.name, L.blobs or [
                np.full(shapes[bot][1], 20.0, np.float32)])
            shapes[top] = shapes[bot]
            return _Step("normalize", L.name, [bot], top, {})
        if lt == "Permute":
            order = list(L.params.get("permute", {}).get("order", []))
            shapes[top] = (tuple(shapes[bot][i] for i in order) if order
                           else shapes[bot])
            return _Step("permute", L.name, [bot], top, {"order": order})
        if lt == "Flatten":
            axis = int(L.params.get("flatten", {}).get("axis", 1))
            s_ = shapes[bot]
            shapes[top] = tuple(s_[:axis]) + (int(np.prod(s_[axis:])),)
            return _Step("flatten", L.name, [bot], top, {"axis": axis})
        if lt == "Reshape":
            dims = L.params.get("reshape", {}).get("shape", [])
            src = shapes[bot]
            # the batch comes from the input; 0 copies the input's dim,
            # -1 takes what is left
            out = [src[0]] + [src[i + 1] if d == 0 else int(d)
                              for i, d in enumerate(dims[1:])]
            if -1 in out:
                known = int(np.prod([d for d in out if d != -1]))
                out[out.index(-1)] = int(np.prod(src)) // known
            shapes[top] = tuple(out)
            return _Step("reshape", L.name, [bot], top, {"dims": list(dims)})
        if lt == "Softmax":
            shapes[top] = shapes[bot]
            return _Step("softmax", L.name, [bot], top, {
                "axis": L.params.get("softmax", {}).get("axis", 1)})
        if lt == "Concat":
            axis = L.params.get("concat", {}).get("axis", 1)
            parts = [shapes[b2] for b2 in L.bottoms]
            out = list(parts[0])
            out[axis] = sum(s[axis] for s in parts)
            shapes[top] = tuple(out)
            if all(b2 in prior_tops for b2 in L.bottoms):
                # the priors are built here: their concat has no run-time
                # work (DetectionOutput reads the build's table)
                prior_tops.add(top)
                return _Step("priorbox", L.name, [], top, {})
            return _Step("concat", L.name, list(L.bottoms), top,
                         {"axis": axis})
        if lt == "PriorBox":
            _, _, fh, fw = shapes[bot]
            corners, variances = caffe_priorbox(
                fh, fw, w, h, L.params.get("prior_box", {}))
            prior_parts.append((corners, variances))
            shapes[top] = (1, 2, corners.size)
            prior_tops.add(top)
            return _Step("priorbox", L.name, [], top, {})
        if lt == "DetectionOutput":
            self.detection_cfg = L.params.get("detection_output", {})
            shapes[top] = (1, 1, self.detection_cfg.get("keep_top_k", 200), 7)
            self.outputs = [top]
            return _Step("detection_output", L.name, list(L.bottoms[:2]),
                         top, {})
        raise NotImplementedError(
            f"caffe layer type '{lt}' ({L.name}) not supported")

    # -- execution -----------------------------------------------------------
    def forward(self, imgs: torch.Tensor):
        """imgs: [B, H, W, C] preprocessed (mean-subtracted BGR)."""
        env: Dict[str, object] = {"data": imgs.permute(0, 3, 1, 2)}
        for s in self.steps:
            x = env[s.inputs[0]] if s.inputs else None
            env[s.output] = self._run(s, x, env)
        return env[self.outputs[0]]

    def _run(self, s: _Step, x, env):
        op, a = s.op, s.attrs
        if op in ("conv", "inner_product", "batchnorm", "scale",
                  "normalize"):
            blobs = self.blobs[param_key(s.name)]
        if op == "identity":
            return x
        if op == "conv":
            return F.conv2d(x, blobs[0], blobs[1] if a["bias"] else None,
                            a["stride"], a["pad"], a["dilation"], a["group"])
        if op == "inner_product":
            return F.linear(x.reshape(x.shape[0], -1), blobs[0],
                            blobs[1] if len(blobs) > 1 else None)
        if op == "batchnorm":
            mean, var, sf = blobs[0], blobs[1], blobs[2].reshape(-1)[0]
            scale = torch.where(sf != 0, 1.0 / sf, 1.0)
            mu = (mean * scale).reshape(1, -1, 1, 1)
            sig = torch.sqrt(var * scale + 1e-5).reshape(1, -1, 1, 1)
            return (x - mu) / sig
        if op == "scale":
            y = x * blobs[0].reshape(1, -1, 1, 1)
            return y + blobs[1].reshape(1, -1, 1, 1) if a["bias"] else y
        if op == "relu":
            return F.relu(x)
        if op == "sigmoid":
            return torch.sigmoid(x)
        if op == "pool":
            return pool2d(x, a["mode"], a["kernel"], a["stride"],
                          a["pad_lo"], a["pad_hi"])
        if op == "global_pool":
            return (x.amax((2, 3), keepdim=True) if a["mode"] == "max"
                    else x.mean((2, 3), keepdim=True))
        if op == "lrn":
            return F.local_response_norm(
                x, int(a.get("local_size", 5)), float(a.get("alpha", 1.0)),
                float(a.get("beta", 0.75)), float(a.get("k", 1.0)))
        if op == "eltwise":
            acc = x
            for y in (env[i] for i in s.inputs[1:]):
                acc = (acc + y if a["operation"] == "sum" else
                       acc * y if a["operation"] == "prod" else
                       torch.maximum(acc, y))
            return acc
        if op == "normalize":
            # across the channels of each position
            denom = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
            return x / denom * blobs[0].reshape(1, -1, 1, 1)
        if op == "permute":
            return x.permute(a["order"]) if a["order"] else x
        if op == "flatten":
            return x.flatten(a["axis"])
        if op == "reshape":
            return x.reshape([x.shape[0]] + [
                x.shape[i + 1] if d == 0 else int(d)
                for i, d in enumerate(a["dims"][1:])])
        if op == "softmax":
            return torch.softmax(x, a["axis"])
        if op == "concat":
            return torch.cat([env[i] for i in s.inputs], a["axis"])
        if op == "priorbox":
            return None
        if op == "detection_output":
            b = env["data"].shape[0]
            return (x.reshape(b, -1), env[s.inputs[1]].reshape(b, -1))
        raise AssertionError(op)  # pragma: no cover

    # -- weight files --------------------------------------------------------
    def pour_blobs(self, layers: Sequence) -> Dict[str, List[np.ndarray]]:
        """The blobs of a parsed caffemodel (``CaffeLayerDef`` or
        ``CaffeLayer``), matched to this net's layers by NAME and reshaped
        to theirs: {layer name: [blobs]}. Raises ``ValueError`` with a
        table of every layer that is missing, short of blobs or of another
        size."""
        by_name = {L.name: list(L.blobs) for L in layers if L.blobs}
        out: Dict[str, List[np.ndarray]] = {}
        problems: List[str] = []
        for name in self.blob_layers():
            ours = self.layer_blobs(name)
            theirs = by_name.get(name)
            if theirs is None:
                problems.append(f"  {name}: MISSING in file "
                                f"(need {[tuple(b.shape) for b in ours]})")
                continue
            if len(theirs) < len(ours):
                problems.append(f"  {name}: {len(theirs)} blobs in file, "
                                f"need {len(ours)}")
                continue
            poured = []
            for i, b in enumerate(ours):
                t = np.asarray(theirs[i], np.float32)
                if t.size != b.numel():
                    problems.append(f"  {name}[{i}]: file {tuple(t.shape)} "
                                    f"vs net {tuple(b.shape)}")
                    break
                poured.append(t.reshape(tuple(b.shape)))
            else:
                out[name] = poured
        if problems:
            raise ValueError("caffemodel does not match the net; per-layer "
                             "diff:\n" + "\n".join(problems))
        return out


def make_caffe_ssd_detect(net: CaffeGraphNet) -> Callable:
    """decode((loc, conf), in_hw) -> (dets [B, K, 5] normalized xyxy +
    conf, valid) from the graph's DetectionOutput parameters (softmax is
    in the graph; class 1 is the face)."""
    if net.detection_cfg is None:
        raise ValueError("graph has no DetectionOutput")
    dc = net.detection_cfg
    return make_detection_output(
        net.priors, net.prior_variances, int(dc.get("num_classes", 2)),
        int(dc.get("top_k", 400)), float(dc.get("confidence_threshold", 0.01)),
        float(dc.get("nms_threshold", 0.45)), int(dc.get("keep_top_k", 200)))
