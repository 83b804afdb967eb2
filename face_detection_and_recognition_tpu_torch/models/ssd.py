"""SSD-class face detectors (the OpenCV-DNN / OpenVINO class): ssd-resnet10,
ssd-mobilenetv2 and ssd-squeezenet.

The counterpart of ``models/ssd.py`` in the JAX package: one detector with
pluggable backbones ("resnet10", "mobilenetv2", "squeezenet"), Caffe
PriorBox anchors, and the Caffe ``DetectionOutput`` chain (softmax conf ->
variance decode -> top-k -> NMS -> keep_top_k). The NMS is the keep-mask
kernel B1 (``ops.cuda_kernels.nms_fixpoint``), one launch for the batch.
Rows come out as [x1, y1, x2, y2, conf], normalized to the input size (the
reference wrappers' contract, ``opencv2_dnn/model.py:34-37``).

Modules keep the flax call order: a weight file streamed in execution order
(``utils/weights.structural_import``) fills the same slots in both
packages. ReLU (ReLU6 in MobileNetV2) after every ConvBN but the linear
projections and shortcuts, BN epsilon 1e-3 (``layers.ConvBN``). The
MobileNetV2 trunk also carries the ``reid-mnv2`` embedder
(``models/embedders.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import greedy_nms, top_k
from ..ops.platform import check_kernel_choice, on_device
from .layers import ConvBN, conv_bias, set_compute_dtype


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    backbone: str = "resnet10"
    input_size: Tuple[int, int] = (300, 300)
    # priorbox spec: per detection level (stride, min_sizes)
    strides: Tuple[int, ...] = (8, 16, 32, 64)
    min_sizes: Tuple[Tuple[int, ...], ...] = ((16, 24), (32, 48), (64, 96),
                                              (128, 192, 256))
    variances: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    num_classes: int = 2  # background + face
    conf_thres: float = 0.02
    iou_thres: float = 0.45
    top_k: int = 400
    keep_top_k: int = 200
    # the JAX key, checked against the device at build time: None, True
    # on the card (B1), False on the CPU (its plain version)
    # (ops.platform.check_kernel_choice)
    pallas_nms: Optional[bool] = None


def generate_priors(cfg: SSDConfig) -> np.ndarray:
    """Caffe PriorBox-style anchors: [N, 4] rows [cx, cy, w, h] normalized,
    aspect ratio 1, one prior per min_size per cell, ceil(side / stride)
    cells a level."""
    w, h = cfg.input_size
    priors: List[List[float]] = []
    for stride, sizes in zip(cfg.strides, cfg.min_sizes):
        fh, fw = -(-h // stride), -(-w // stride)
        for y in range(fh):
            for x in range(fw):
                cx, cy = (x + 0.5) * stride / w, (y + 0.5) * stride / h
                for s in sizes:
                    priors.append([cx, cy, s / w, s / h])
    return np.asarray(priors, np.float32)


def decode_ssd_locs(locs: torch.Tensor, priors: torch.Tensor,
                    variances: Sequence[float]) -> torch.Tensor:
    """Caffe SSD variance decode: locs [..., N, 4] -> xyxy normalized."""
    v = variances
    cx = priors[:, 0] + locs[..., 0] * v[0] * priors[:, 2]
    cy = priors[:, 1] + locs[..., 1] * v[1] * priors[:, 3]
    pw = priors[:, 2] * torch.exp(locs[..., 2] * v[2])
    ph = priors[:, 3] * torch.exp(locs[..., 3] * v[3])
    return torch.stack([cx - pw / 2, cy - ph / 2, cx + pw / 2, cy + ph / 2],
                       -1)


class _ResBlock(nn.Module):
    """Two 3x3 ConvBNs (the first strided) and a 1x1 ConvBN shortcut where
    the shape changes, added and ReLU'd; the shortcut runs last, as in
    flax."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(c_in, c_out, 3, stride, act="relu")
        self.conv2 = ConvBN(c_out, c_out, 3, 1, act=None)
        self.shortcut = (ConvBN(c_in, c_out, 1, stride, act=None)
                         if stride != 1 or c_in != c_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)


class _ResNet10Backbone(nn.Module):
    """A 7x7 stride-4 stem and four stride-2 residual blocks: the /8, /16,
    /32 and /64 maps (64, 128, 256, 512 channels) of the class of backbone
    inside OpenCV's res10_300x300 caffemodel."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 7, 4, act="relu")                  # /4
        blocks, c = [], 32
        for ch in (64, 128, 256, 512):
            blocks.append(_ResBlock(c, ch, 2))
            c = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for block in self.blocks:
            x = block(x)
            feats.append(x)
        return feats


# (out channels, stride, expansion) of the ten inverted residuals
_MNV2_BLOCKS = ((16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
                (64, 2, 6), (64, 1, 6), (96, 1, 6), (160, 2, 6), (160, 1, 6))
_MNV2_TAPS = (4, 7, 9)  # the blocks whose outputs are the /8, /16, /32 maps


class _InvertedResidual(nn.Module):
    """1x1 expand (ReLU6) -> 3x3 depthwise at ``stride`` (ReLU6) -> 1x1
    linear projection, with a residual when stride is 1 and the width is
    kept."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        hidden = c_in * expand
        self.expand = ConvBN(c_in, hidden, 1, 1, act="relu6")
        self.dw = ConvBN(hidden, hidden, 3, stride, groups=hidden,
                         act="relu6")
        self.project = ConvBN(hidden, c_out, 1, 1, act=None)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.project(self.dw(self.expand(x)))
        return x + h if self.residual else h


class _MobileNetV2Backbone(nn.Module):
    """MobileNetV2-style extractor (the OpenVINO face-detection-0204 class):
    NCHW in, the feature maps at strides 8, 16, 32 and 64 out (32, 96, 160
    and 256 channels)."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 32, 3, 2, act="relu6")                 # /2
        blocks, c = [], 32
        for c_out, stride, expand in _MNV2_BLOCKS:
            blocks.append(_InvertedResidual(c, c_out, stride, expand))
            c = c_out
        self.blocks = nn.ModuleList(blocks)
        self.head = ConvBN(160, 256, 3, 2, act="relu6")              # /64

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in _MNV2_TAPS:
                feats.append(x)
        return feats + [self.head(x)]


class _Fire(nn.Module):
    """SqueezeNet fire module: a 1x1 squeeze, then 1x1 and 3x3 expands
    concatenated."""

    def __init__(self, c_in: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = ConvBN(c_in, squeeze, 1, 1, act="relu")
        self.expand1 = ConvBN(squeeze, expand, 1, 1, act="relu")
        self.expand3 = ConvBN(squeeze, expand, 3, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.squeeze(x)
        return torch.cat([self.expand1(s), self.expand3(s)], 1)


class _SqueezeNetBackbone(nn.Module):
    """SqueezeNet-style extractor (the OpenVINO SqueezeNet-light SSD class):
    the /8, /16, /32 and /64 maps (256, 384, 512, 256 channels)."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 64, 3, 2, act="relu")                  # /2
        self.pool = nn.MaxPool2d(3, 2, 1)
        fires, c = [], 64
        for sq, ex in ((16, 64), (16, 64), (32, 128), (32, 128), (48, 192),
                       (48, 192), (64, 256)):
            fires.append(_Fire(c, sq, ex))
            c = 2 * ex
        self.fires = nn.ModuleList(fires)
        self.head = ConvBN(512, 256, 3, 2, act="relu")               # /64

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        f = self.fires
        x = self.pool(self.stem(x))                                  # /4
        x = self.pool(f[1](f[0](x)))                                 # /8
        f8 = f[3](f[2](x))
        f16 = f[5](f[4](self.pool(f8)))                              # /16
        f32 = f[6](self.pool(f16))                                   # /32
        return [f8, f16, f32, self.head(f32)]                        # /64


_BACKBONES = {"resnet10": (_ResNet10Backbone, (64, 128, 256, 512)),
              "mobilenetv2": (_MobileNetV2Backbone, (32, 96, 160, 256)),
              "squeezenet": (_SqueezeNetBackbone, (256, 384, 512, 256))}


class SSDFaceNet(nn.Module):
    """Backbone + per-level 3x3 loc/conf heads. Takes NHWC [B, h, w, 3]
    mean-subtracted BGR and returns (locs [B, N, 4], conf_logits [B, N,
    num_classes]), f32, over all priors, each level flattened (y, x,
    prior) as flax's NHWC reshape orders it. A bf16 ``compute_dtype`` runs
    the JAX package's bf16 net: the ConvBNs' forms (``layers.ConvBN``), the
    residual sums rounded, each head's sums and its sum with the bias
    rounded to bf16 before the cast to f32."""

    compute_dtype = torch.float32

    def __init__(self, cfg: SSDConfig = SSDConfig()):
        super().__init__()
        self.cfg = cfg
        cls, widths = _BACKBONES[cfg.backbone]
        self.backbone = cls()
        self.loc = nn.ModuleList(
            nn.Conv2d(c, len(s) * 4, 3, 1, 1)
            for c, s in zip(widths, cfg.min_sizes))
        self.conf = nn.ModuleList(
            nn.Conv2d(c, len(s) * cfg.num_classes, 3, 1, 1)
            for c, s in zip(widths, cfg.min_sizes))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x.to(self.compute_dtype).permute(0, 3, 1, 2))
        b, nc = x.shape[0], self.cfg.num_classes
        locs, confs = [], []
        for f, loc, conf in zip(feats, self.loc, self.conf):
            locs.append(conv_bias(loc, f).permute(0, 2, 3, 1)
                        .reshape(b, -1, 4))
            confs.append(conv_bias(conf, f).permute(0, 2, 3, 1)
                         .reshape(b, -1, nc))
        return torch.cat(locs, 1).float(), torch.cat(confs, 1).float()

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "SSDFaceNet":
        """Every conv kernel from N(0, 1/fan_in) drawn from ``generator``
        (CPU), biases 0; the BN statistics then come from one batch of two
        mean-subtracted noise frames at the input size, as
        ``YoloV5FaceNet.init_random_`` sets them."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        for bn in bns:
            bn.reset_parameters()
            bn.momentum = None  # cumulative: one batch sets the statistics
        self.train()
        w, h = self.cfg.input_size
        self(torch.rand((2, h, w, 3), generator=generator) * 255.0 - 117.0)
        for bn in bns:
            bn.momentum = 0.03
        return self.eval()


def ssd_postprocess(locs: torch.Tensor, conf_logits: torch.Tensor,
                    priors: torch.Tensor, cfg: SSDConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Caffe DetectionOutput: softmax -> decode -> the ``top_k`` best scores
    (ties to the lower prior, ``ops.nms.top_k``) -> greedy
    NMS (B1, one launch for the batch) -> ``keep_top_k``. Returns dets
    [B, keep_top_k, 5] rows [x1, y1, x2, y2, conf] normalized, and the
    validity mask."""
    conf = torch.softmax(conf_logits, -1)[..., 1]  # face class
    boxes = decode_ssd_locs(locs, priors, cfg.variances)
    top_c, idx = top_k(conf, cfg.top_k)
    rows = torch.cat([torch.take_along_dim(boxes, idx[..., None], 1),
                      top_c[..., None]], -1)
    return greedy_nms(rows, top_c > cfg.conf_thres, cfg.iou_thres,
                      cfg.keep_top_k, score_col=4)


def make_ssd_face(cfg: SSDConfig, generator: torch.Generator,
                  device: torch.device, dtype: torch.dtype = torch.float32
                  ) -> Tuple[SSDFaceNet, Callable]:
    """Net (weights from ``generator``, on ``device``, channels-last, eval,
    computing in ``dtype``: float32 or the JAX package's bfloat16 net) and
    ``decode((locs, conf_logits), in_hw) -> (dets [B, keep_top_k, 5]
    normalized, valid)``; the net takes [B, h, w, 3] mean-subtracted BGR
    at ``cfg.input_size`` and gives the decode f32 heads."""
    check_kernel_choice(cfg.pallas_nms, device, "pallas_nms")
    net = SSDFaceNet(cfg).init_random_(generator)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    set_compute_dtype(net, dtype)
    # the priors on each device a replica of the net decodes on
    cache = {}

    def decode(raw: Tuple[torch.Tensor, torch.Tensor],
               in_hw: Tuple[int, int]):
        # priors are normalized: the input size does not enter
        dev = raw[0].device
        priors = on_device(cache, dev, lambda: torch.from_numpy(
            generate_priors(cfg)).to(dev))
        return ssd_postprocess(*raw, priors, cfg)

    return net, decode
