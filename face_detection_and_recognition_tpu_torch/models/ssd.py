"""SSD detector family: so far only its MobileNetV2 trunk.

The counterpart of ``models/ssd.py`` in the JAX package, which holds the
SSD face detectors (ssd-resnet10, ssd-mobilenetv2, ssd-squeezenet). The
port has the MobileNetV2 extractor that the ``reid-mnv2`` embedder is built
on (``models/embedders.py``); the detectors, their heads and their decode
come with the rest of the SSD family. ReLU6 everywhere but the linear
projections, BN epsilon 1e-3 (``layers.ConvBN``).
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from .layers import ConvBN

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
