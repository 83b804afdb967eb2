"""YOLOv5-face detectors in PyTorch: the P5 graph (yolov5s/m/l), the
ShuffleNetV2 graph (yolov5n, yolov5n-0.5), their four-level P6 variants
(yolov5s6/m6/l6, yolov5n6) and the official multiclass, landmark-less head.

The counterpart of ``models/yolov5_face.py`` in the JAX package. The network
walks the same graph table and returns the same raw head maps
[B, na, ny, nx, no]; ``yolov5_face_detect_maps`` selects the top candidates,
gathers and decodes their rows in one pass (``candidate_decode``) and runs
greedy +1 px-IoU NMS (``nms_fixpoint``). The two kernels run as CUDA kernels
on CUDA tensors and as their plain versions on the CPU. The official head
(``yolov5_official_detect_maps``) gathers its 5 + nc column rows with
``torch.take_along_dim`` (the fused gather + decode is the 16-column face
layout's) and reaches the NMS kernel through ``ops.nms.multiclass_nms``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.boxes import xywh2xyxy
from ..ops.cuda_kernels import (_candidate_grid_params, candidate_decode,
                                nms_fixpoint)
from ..ops.nms import multiclass_nms, sort_by_score
from .layers import (BF16, C3, SPP, ShuffleV2Block, StemBlock, conv_bn,
                     conv_bias_bf16, make_divisible_torch)

FACE_ANCHORS = (
    ((4.0, 5.0), (8.0, 10.0), (13.0, 16.0)),
    ((23.0, 29.0), (43.0, 55.0), (73.0, 105.0)),
    ((146.0, 217.0), (231.0, 300.0), (335.0, 433.0)),
)
FACE_ANCHORS_P6 = (
    ((6.0, 7.0), (9.0, 11.0), (13.0, 16.0)),
    ((18.0, 23.0), (26.0, 33.0), (37.0, 47.0)),
    ((54.0, 67.0), (77.0, 104.0), (112.0, 154.0)),
    ((174.0, 238.0), (258.0, 355.0), (445.0, 568.0)),
)

# graph structure: list of (from, number, module, args) like the yamls
_P5_GRAPH: List[Tuple[Any, int, str, list]] = [
    # backbone
    (-1, 1, "StemBlock", [64, 3, 2]),          # 0  P2/4
    (-1, 3, "C3", [128]),                       # 1
    (-1, 1, "Conv", [256, 3, 2]),               # 2  P3/8
    (-1, 9, "C3", [256]),                       # 3
    (-1, 1, "Conv", [512, 3, 2]),               # 4  P4/16
    (-1, 9, "C3", [512]),                       # 5
    (-1, 1, "Conv", [1024, 3, 2]),              # 6  P5/32
    (-1, 1, "SPP", [1024, [3, 5, 7]]),          # 7
    (-1, 3, "C3", [1024, False]),               # 8
    # head
    (-1, 1, "Conv", [512, 1, 1]),               # 9
    (-1, 1, "Upsample", []),                    # 10
    ([-1, 5], 1, "Concat", []),                 # 11
    (-1, 3, "C3", [512, False]),                # 12
    (-1, 1, "Conv", [256, 1, 1]),               # 13
    (-1, 1, "Upsample", []),                    # 14
    ([-1, 3], 1, "Concat", []),                 # 15
    (-1, 3, "C3", [256, False]),                # 16  P3/8 out
    (-1, 1, "Conv", [256, 3, 2]),               # 17
    ([-1, 13], 1, "Concat", []),                # 18
    (-1, 3, "C3", [512, False]),                # 19  P4/16 out
    (-1, 1, "Conv", [512, 3, 2]),               # 20
    ([-1, 9], 1, "Concat", []),                 # 21
    (-1, 3, "C3", [1024, False]),               # 22  P5/32 out
    ([16, 19, 22], 1, "Detect", []),            # 23
]

# yolov5s6 / m6 / l6: the P5 graph with a P6/64 level
_P6_GRAPH: List[Tuple[Any, int, str, list]] = [
    (-1, 1, "StemBlock", [64, 3, 2]),           # 0
    (-1, 3, "C3", [128]),                        # 1
    (-1, 1, "Conv", [256, 3, 2]),                # 2  P3/8
    (-1, 9, "C3", [256]),                        # 3
    (-1, 1, "Conv", [512, 3, 2]),                # 4  P4/16
    (-1, 9, "C3", [512]),                        # 5
    (-1, 1, "Conv", [768, 3, 2]),                # 6  P5/32
    (-1, 3, "C3", [768]),                        # 7
    (-1, 1, "Conv", [1024, 3, 2]),               # 8  P6/64
    (-1, 1, "SPP", [1024, [3, 5, 7]]),           # 9
    (-1, 3, "C3", [1024, False]),                # 10
    (-1, 1, "Conv", [768, 1, 1]),                # 11
    (-1, 1, "Upsample", []),                     # 12
    ([-1, 7], 1, "Concat", []),                  # 13
    (-1, 3, "C3", [768, False]),                 # 14
    (-1, 1, "Conv", [512, 1, 1]),                # 15
    (-1, 1, "Upsample", []),                     # 16
    ([-1, 5], 1, "Concat", []),                  # 17
    (-1, 3, "C3", [512, False]),                 # 18
    (-1, 1, "Conv", [256, 1, 1]),                # 19
    (-1, 1, "Upsample", []),                     # 20
    ([-1, 3], 1, "Concat", []),                  # 21
    (-1, 3, "C3", [256, False]),                 # 22  P3
    (-1, 1, "Conv", [256, 3, 2]),                # 23
    ([-1, 19], 1, "Concat", []),                 # 24
    (-1, 3, "C3", [512, False]),                 # 25  P4
    (-1, 1, "Conv", [512, 3, 2]),                # 26
    ([-1, 15], 1, "Concat", []),                 # 27
    (-1, 3, "C3", [768, False]),                 # 28  P5
    (-1, 1, "Conv", [768, 3, 2]),                # 29
    ([-1, 11], 1, "Concat", []),                 # 30
    (-1, 3, "C3", [1024, False]),                # 31  P6
    ([22, 25, 28, 31], 1, "Detect", []),         # 32
]

# yolov5n / yolov5n-0.5: StemBlock + ShuffleNetV2 backbone
_SHUFFLE_GRAPH: List[Tuple[Any, int, str, list]] = [
    (-1, 1, "StemBlock", [32, 3, 2]),            # 0  P2/4
    (-1, 1, "ShuffleV2Block", [128, 2]),         # 1  P3/8
    (-1, 3, "ShuffleV2Block", [128, 1]),         # 2
    (-1, 1, "ShuffleV2Block", [256, 2]),         # 3  P4/16
    (-1, 7, "ShuffleV2Block", [256, 1]),         # 4
    (-1, 1, "ShuffleV2Block", [512, 2]),         # 5  P5/32
    (-1, 3, "ShuffleV2Block", [512, 1]),         # 6
    (-1, 1, "Conv", [128, 1, 1]),                # 7
    (-1, 1, "Upsample", []),                     # 8
    ([-1, 4], 1, "Concat", []),                  # 9
    (-1, 1, "C3", [128, False]),                 # 10
    (-1, 1, "Conv", [128, 1, 1]),                # 11
    (-1, 1, "Upsample", []),                     # 12
    ([-1, 2], 1, "Concat", []),                  # 13
    (-1, 1, "C3", [128, False]),                 # 14  P3/8 out
    (-1, 1, "Conv", [128, 3, 2]),                # 15
    ([-1, 11], 1, "Concat", []),                 # 16
    (-1, 1, "C3", [128, False]),                 # 17  P4/16 out
    (-1, 1, "Conv", [128, 3, 2]),                # 18
    ([-1, 7], 1, "Concat", []),                  # 19
    (-1, 1, "C3", [128, False]),                 # 20  P5/32 out
    ([14, 17, 20], 1, "Detect", []),             # 21
]

# yolov5n6: the ShuffleNetV2 graph with a P6/64 level
_SHUFFLE_P6_GRAPH: List[Tuple[Any, int, str, list]] = [
    (-1, 1, "StemBlock", [32, 3, 2]),            # 0  P2/4
    (-1, 1, "ShuffleV2Block", [128, 2]),         # 1  P3/8
    (-1, 3, "ShuffleV2Block", [128, 1]),         # 2
    (-1, 1, "ShuffleV2Block", [256, 2]),         # 3  P4/16
    (-1, 7, "ShuffleV2Block", [256, 1]),         # 4
    (-1, 1, "ShuffleV2Block", [384, 2]),         # 5  P5/32
    (-1, 3, "ShuffleV2Block", [384, 1]),         # 6
    (-1, 1, "ShuffleV2Block", [512, 2]),         # 7  P6/64
    (-1, 3, "ShuffleV2Block", [512, 1]),         # 8
    (-1, 1, "Conv", [128, 1, 1]),                # 9
    (-1, 1, "Upsample", []),                     # 10
    ([-1, 6], 1, "Concat", []),                  # 11
    (-1, 1, "C3", [128, False]),                 # 12
    (-1, 1, "Conv", [128, 1, 1]),                # 13
    (-1, 1, "Upsample", []),                     # 14
    ([-1, 4], 1, "Concat", []),                  # 15
    (-1, 1, "C3", [128, False]),                 # 16
    (-1, 1, "Conv", [128, 1, 1]),                # 17
    (-1, 1, "Upsample", []),                     # 18
    ([-1, 2], 1, "Concat", []),                  # 19
    (-1, 1, "C3", [128, False]),                 # 20  P3/8 out
    (-1, 1, "Conv", [128, 3, 2]),                # 21
    ([-1, 17], 1, "Concat", []),                 # 22
    (-1, 1, "C3", [128, False]),                 # 23  P4/16 out
    (-1, 1, "Conv", [128, 3, 2]),                # 24
    ([-1, 13], 1, "Concat", []),                 # 25
    (-1, 1, "C3", [128, False]),                 # 26  P5/32 out
    (-1, 1, "Conv", [128, 3, 2]),                # 27
    ([-1, 9], 1, "Concat", []),                  # 28
    (-1, 1, "C3", [128, False]),                 # 29  P6/64 out
    ([20, 23, 26, 29], 1, "Detect", []),         # 30
]

ARCHS: Dict[str, Dict[str, Any]] = {
    "yolov5s": dict(graph=_P5_GRAPH, gd=0.33, gw=0.35, anchors=FACE_ANCHORS,
                    strides=(8, 16, 32)),
    "yolov5m": dict(graph=_P5_GRAPH, gd=0.67, gw=0.75, anchors=FACE_ANCHORS,
                    strides=(8, 16, 32)),
    "yolov5l": dict(graph=_P5_GRAPH, gd=1.0, gw=1.0, anchors=FACE_ANCHORS,
                    strides=(8, 16, 32)),
    "yolov5s6": dict(graph=_P6_GRAPH, gd=0.33, gw=0.50,
                     anchors=FACE_ANCHORS_P6, strides=(8, 16, 32, 64)),
    "yolov5m6": dict(graph=_P6_GRAPH, gd=0.67, gw=0.75,
                     anchors=FACE_ANCHORS_P6, strides=(8, 16, 32, 64)),
    "yolov5l6": dict(graph=_P6_GRAPH, gd=1.0, gw=1.0,
                     anchors=FACE_ANCHORS_P6, strides=(8, 16, 32, 64)),
    "yolov5n6": dict(graph=_SHUFFLE_P6_GRAPH, gd=1.0, gw=1.0,
                     anchors=FACE_ANCHORS_P6, strides=(8, 16, 32, 64)),
    "yolov5n": dict(graph=_SHUFFLE_GRAPH, gd=1.0, gw=1.0,
                    anchors=FACE_ANCHORS, strides=(8, 16, 32)),
    "yolov5n-0.5": dict(graph=_SHUFFLE_GRAPH, gd=1.0, gw=0.5,
                        anchors=FACE_ANCHORS, strides=(8, 16, 32)),
}


def graph_depth(n: int, gd: float) -> int:
    """Repeat count of a graph entry under the depth multiple ``gd``."""
    return max(round(n * gd), 1) if n > 1 else n


class Concat(nn.Module):
    """Channel concat of the graph's listed inputs (wired by the net)."""


class Detect(nn.Module):
    """One 1x1 conv per level; emits [B, na, ny, nx, no] like the reference's
    ``view(bs, na, no, ny, nx).permute(0, 1, 3, 4, 2)``. With
    ``compute_dtype`` bfloat16 the convolutions are flax's bf16 ones,
    whatever their input (an int8 net's f32 levels included), and the maps
    stay bf16, as the JAX package's bf16 heads do."""

    def __init__(self, na: int, no: int, ch: Sequence[int]):
        super().__init__()
        self.na, self.no = na, no
        self.m = nn.ModuleList(nn.Conv2d(c, na * no, 1) for c in ch)
        self.compute_dtype = torch.float32

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        maps = []
        for conv, x in zip(self.m, xs):
            y = conv_bias_bf16(conv, x) if self.compute_dtype == BF16 \
                else conv(x)
            b, _, ny, nx = y.shape
            maps.append(y.view(b, self.na, self.no, ny, nx)
                        .permute(0, 1, 3, 4, 2).contiguous())
        return maps


class YoloV5FaceNet(nn.Module):
    """Graph-executing yolov5-face network. Takes NHWC [B, h, w, 3] RGB in
    [0, 1] and returns the raw per-level maps [B, na, ny, nx, no]
    (no = nc + 5 + 10; ``with_landmarks=False`` is the official yolov5
    head, no = nc + 5). Layers are ``model.{i}`` in graph order.
    ``quantized`` (True, or "static" for calibrated activation scales)
    builds every ConvBN as an int8 ``QConvBN``; the Detect head's 1x1
    convolutions stay float, as in the JAX package
    (``utils.quantize.quantize_net`` fills the weights). ``compute_dtype``
    (``layers.set_compute_dtype``) bfloat16 runs the JAX package's
    ``dtype=jnp.bfloat16`` net: the input is cast to bf16 and every layer
    follows it, and the maps come out bf16. An int8 net in bf16 casts
    nothing on the way in (its ConvBNs widen their input to f32, as JAX's
    do) and runs its Detect convolutions in bf16."""

    def __init__(self, arch: str = "yolov5s", nc: int = 1,
                 with_landmarks: bool = True, quantized=False):
        super().__init__()
        self.quantized = quantized
        self.compute_dtype = torch.float32
        q = dict(quantized=quantized)
        spec = ARCHS[arch]
        gd, gw = spec["gd"], spec["gw"]
        na = len(spec["anchors"][0])
        no = nc + 5 + (10 if with_landmarks else 0)

        def width(c: int) -> int:
            return make_divisible_torch(c * gw, 8)

        layers, ch, self.froms = [], [], []
        c_prev = 3
        for frm, n, mod, args in spec["graph"]:
            c_in = c_prev if frm == -1 else (ch[frm] if isinstance(frm, int)
                                             else None)
            if mod == "Conv":
                c_out = width(args[0])
                m = conv_bn(c_in, c_out, args[1], args[2], **q)
            elif mod == "C3":
                c_out = width(args[0])
                shortcut = args[1] if len(args) > 1 else True
                m = C3(c_in, c_out, graph_depth(n, gd), shortcut, **q)
            elif mod == "SPP":
                c_out = width(args[0])
                m = SPP(c_in, c_out, tuple(args[1]), **q)
            elif mod == "StemBlock":
                c_out = width(args[0])
                m = StemBlock(c_in, c_out, args[1], args[2], **q)
            elif mod == "ShuffleV2Block":
                # repeats are model.{i}.{r}, a single block model.{i}
                c_out = width(args[0])
                reps = graph_depth(n, gd)
                blocks = [ShuffleV2Block(c_in if r == 0 else c_out, c_out,
                                         args[1], **q) for r in range(reps)]
                m = blocks[0] if reps == 1 else nn.Sequential(*blocks)
            elif mod == "Upsample":
                c_out = c_in
                m = nn.Upsample(scale_factor=2, mode="nearest")
            elif mod == "Concat":
                c_out = sum(c_prev if j == -1 else ch[j] for j in frm)
                m = Concat()
            elif mod == "Detect":
                c_out = 0
                m = Detect(na, no, [ch[j] for j in frm])
            else:
                raise ValueError(f"unknown module {mod}")
            layers.append(m)
            ch.append(c_out)
            self.froms.append(frm)
            c_prev = c_out
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cur = x.permute(0, 3, 1, 2)  # NHWC data -> NCHW channels-last view
        if not self.quantized:
            cur = cur.to(self.compute_dtype)
        outputs: List[torch.Tensor] = []
        for m, frm in zip(self.model, self.froms):
            if isinstance(m, Detect):
                return m([outputs[j] for j in frm])
            if isinstance(m, Concat):
                cur = torch.cat([cur if j == -1 else outputs[j] for j in frm],
                                1)
            else:
                cur = m(cur if frm == -1 else outputs[frm])
            outputs.append(cur)
        raise RuntimeError("graph has no Detect layer")

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "YoloV5FaceNet":
        """Draw every weight from ``generator`` (CPU): conv kernels from
        N(0, 1/fan_in), flax's LeCun-normal scale, and conv biases 0. With
        identity BN statistics such a deep net's activations fade to ~1e-6
        by the last level, so the BN statistics are then set from one batch
        of 256 x 256 uniform noise frames drawn from the same generator:
        objectness logits then spread over a few units, as a trained net's
        do, and the detect path gets real suppression work."""
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
        for bn in bns:
            bn.reset_parameters()
            bn.momentum = None  # cumulative: one batch sets the statistics
        self.train()
        self(torch.rand((2, 256, 256, 3), generator=generator))
        for bn in bns:
            bn.momentum = 0.03
        return self.eval()


def decode_heads(maps: Sequence[torch.Tensor],
                 anchors: Sequence[Sequence[Tuple[float, float]]],
                 strides: Sequence[int], nc: int = 1,
                 landmarks: bool = True) -> torch.Tensor:
    """Grid/anchor decode over all levels. maps: per-level
    [B, na, ny, nx, no] (bf16 maps decode in f32). Returns [B, total, no]
    rows [cx, cy, w, h, obj, l1x, l1y, ..., l5x, l5y, cls...] in input
    pixels. ``landmarks=False`` decodes the official head's rows [cx, cy,
    w, h, obj, cls...], every column sigmoided. ``nc``, the class count,
    is the JAX package's argument: the class columns are the maps' own,
    so it takes part in no arithmetic there or here."""
    outs = []
    for m, anc, stride in zip(maps, anchors, strides):
        m = m.float()
        b, na, ny, nx, no = m.shape
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32,
                                             device=m.device),
                                torch.arange(nx, dtype=torch.float32,
                                             device=m.device), indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, None]           # [1,1,ny,nx,2]
        anc = torch.tensor(anc, dtype=torch.float32,
                           device=m.device).reshape(1, na, 1, 1, 2)
        if not landmarks:
            y = torch.sigmoid(m)
            xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
            wh = (y[..., 2:4] * 2.0) ** 2 * anc
            outs.append(torch.cat([xy, wh, y[..., 4:]], -1).reshape(b, -1,
                                                                     no))
            continue
        y = torch.cat([torch.sigmoid(m[..., :5]), m[..., 5:15],
                       torch.sigmoid(m[..., 15:])], -1)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        lmk = y[..., 5:15].reshape(b, na, ny, nx, 5, 2) * anc[..., None, :] \
            + (grid[..., None, :] * stride)
        out = torch.cat([xy, wh, y[..., 4:5], lmk.reshape(b, na, ny, nx, 10),
                         y[..., 15:]], -1)
        outs.append(out.reshape(b, -1, no))
    return torch.cat(outs, 1)


@dataclasses.dataclass(frozen=True)
class YoloV5FaceConfig:
    arch: str = "yolov5s"
    nc: int = 1
    input_size: Tuple[int, int] = (640, 640)
    conf_thres: float = 0.4
    iou_thres: float = 0.3
    max_candidates: int = 1024
    max_det: int = 300
    # the JAX key, checked against the device at build time: None, True
    # on the card (B1), False on the CPU (its plain version)
    # (ops.platform.check_kernel_choice). The device alone routes the NMS.
    pallas_nms: Optional[bool] = None


def _nms_candidate_rows(p: torch.Tensor, boxes: torch.Tensor,
                        cand_valid: torch.Tensor, cfg: YoloV5FaceConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NMS over decoded candidate rows [B, K, 16] sorted by score desc,
    with their xyxy ``boxes``: the +1 px-IoU >= thres suppression, and a
    max_det-sliced, score-ordered output block."""
    cls_conf = p[..., 15:].amax(-1, keepdim=True)
    rows = torch.cat([boxes, p[..., 4:15], cls_conf], -1)
    keep = nms_fixpoint(boxes, cand_valid, cfg.iou_thres, plus1=True,
                        strict=False)
    # push suppressed rows to the end, keep score order among kept
    _, _, out_valid, out = sort_by_score(rows[..., 4], keep, rows,
                                         top=cfg.max_det)
    return out, out_valid


def _rank_candidates(obj: torch.Tensor, k: int) -> torch.Tensor:
    """The flat indices [B, k] int32 of the k highest objectness logits
    ``obj`` [B, N], ranked on the f32 sigmoid as the JAX package ranks
    them: saturated scores tie at 1.0, and lax.top_k puts the lower index
    first among ties. A stable descending sort keeps that order;
    torch.topk on CUDA promises none."""
    return torch.sort(torch.sigmoid(obj.float()), dim=1, descending=True,
                      stable=True).indices[:, :k].to(torch.int32)


def yolov5_face_detect_maps(maps: Sequence[torch.Tensor],
                            anchors: Sequence[Sequence[Tuple[float, float]]],
                            strides: Sequence[int], cfg: YoloV5FaceConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates-first decode + NMS: the top ``cfg.max_candidates`` rows by
    objectness, then grid/anchor decode, box conversion and NMS on [B, K].

    maps: per-level [B, na, ny, nx, no]; anchors and strides as tuples.
    Returns dets [B, max_det, 16] rows [x1, y1, x2, y2, obj, lmk x10,
    cls_conf] in input pixels, sorted by obj, and valid [B, max_det]."""
    b, no = maps[0].shape[0], maps[0].shape[-1]
    maps_flat = [m.reshape(b, -1, no) for m in maps]
    n = sum(mf.shape[1] for mf in maps_flat)
    k = min(cfg.max_candidates, n)
    obj = torch.cat([mf[..., 4] for mf in maps_flat], 1)
    idx = _rank_candidates(obj, k)
    # input dims from the maps (level 0 is h/s0 x w/s0), so rect letterbox
    # inputs decode on their own grid
    in_size = (maps[0].shape[3] * strides[0], maps[0].shape[2] * strides[0])
    # gather + decode exactly as decode_heads (same op order and dtypes),
    # with the xyxy boxes and the obj >= conf_thres mask
    pred, boxes, cand_valid = candidate_decode(
        maps_flat, idx.contiguous(), anchors, strides, in_size,
        cfg.conf_thres)
    return _nms_candidate_rows(pred, boxes, cand_valid, cfg)


# ---------------- official (multiclass) yolov5 path ----------------

# the official yolov5 anchor set (yolov5s.yaml; the face anchors above are
# yolov5-face's re-tuned set)
OFFICIAL_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


def yolov5_official_postprocess_candidates(pred: torch.Tensor,
                                           cfg: YoloV5FaceConfig
                                           ) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """NMS stage of the official path over already-selected candidate rows
    ``pred`` [B, K, 5 + nc] decoded: obj > conf_thres, conf = obj * cls,
    the best class (the first among equal scores), then class-offset NMS
    with strict IoU. Returns dets [B, max_det, 6] rows [x1, y1, x2, y2,
    conf, cls] in input pixels and valid [B, max_det]."""
    valid = pred[..., 4] > cfg.conf_thres                 # reference xc
    cls_scores = pred[..., 5:] * pred[..., 4:5]           # conf = obj * cls
    conf = cls_scores.amax(-1)
    cls = cls_scores.argmax(-1)
    valid = valid & (conf > cfg.conf_thres)
    dets, out_valid, _ = multiclass_nms(xywh2xyxy(pred[..., :4]), conf, cls,
                                        valid, cfg.iou_thres, cfg.max_det)
    return dets, out_valid


def yolov5_official_postprocess(pred: torch.Tensor, cfg: YoloV5FaceConfig
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-grid official path, the plain reference of
    ``yolov5_official_detect_maps``: the top ``cfg.max_candidates`` rows of
    the decoded grid ``pred`` [B, N, 5 + nc] (``decode_heads(...,
    landmarks=False)``) by objectness among those above conf_thres, ties in
    index order, then ``yolov5_official_postprocess_candidates``."""
    k = min(cfg.max_candidates, pred.shape[1])
    obj = pred[..., 4]
    scores = torch.where(obj > cfg.conf_thres, obj, -1.0)
    order = torch.sort(scores, dim=1, descending=True, stable=True) \
        .indices[:, :k]
    cand = torch.take_along_dim(pred, order[..., None], 1)
    return yolov5_official_postprocess_candidates(cand, cfg)


def yolov5_official_detect_maps(maps: Sequence[torch.Tensor],
                                anchors: Sequence[Sequence[Tuple[float,
                                                                 float]]],
                                strides: Sequence[int], cfg: YoloV5FaceConfig
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates-first official (multiclass, landmark-less) path, as
    ``yolov5_face_detect_maps``: the top ``cfg.max_candidates`` rows by
    objectness on the raw maps, gathered, decoded on [B, K] and handed to
    the class-offset NMS. Returns what
    ``yolov5_official_postprocess_candidates`` returns."""
    b, no = maps[0].shape[0], maps[0].shape[-1]
    flat = torch.cat([m.reshape(b, -1, no) for m in maps], 1)
    k = min(cfg.max_candidates, flat.shape[1])
    idx = _rank_candidates(flat[..., 4], k)
    cand = torch.take_along_dim(flat, idx.long()[..., None], 1).float()
    # input dims from the maps (level 0 is h/s0 x w/s0): rect letterbox
    in_size = (maps[0].shape[3] * strides[0], maps[0].shape[2] * strides[0])
    grid, stride, anc = _candidate_grid_params(idx, anchors, strides,
                                               in_size)
    y = torch.sigmoid(cand)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (y[..., 2:4] * 2.0) ** 2 * anc
    pred = torch.cat([xy, wh, y[..., 4:]], -1)
    return yolov5_official_postprocess_candidates(pred, cfg)
