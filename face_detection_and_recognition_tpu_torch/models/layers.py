"""The yolov5-face building blocks as PyTorch modules.

The counterparts of ``models/layers.py`` in the JAX package. Submodules carry
the reference torch names (``conv``/``bn``, ``cv1``..``cv3``, ``m``,
``stem_*``), so a network's ``state_dict`` keys are those of a reference
yolov5-face checkpoint. Tensors are NCHW; the network keeps them in the
channels-last memory format.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


def make_divisible_torch(x: float, divisor: int) -> int:
    """Channel-width rounding of the reference's parse_model: ceil to a
    multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU: the yolov5 ``Conv``. The BN
    epsilon is the JAX package's 1e-3, not PyTorch's default 1e-5."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, autopad(k, p), bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.03)
        self.act = nn.SiLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Standard bottleneck, with a residual when shapes allow."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = ConvBN(c_in, c_, 1, 1)
        self.cv2 = ConvBN(c_, c_out, 3, 1)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = ConvBN(c_in, c_, 1, 1)
        self.cv2 = ConvBN(c_in, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c_out, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: stride-1 'same' max pools of several sizes."""

    def __init__(self, c_in: int, c_out: int,
                 kernels: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = ConvBN(c_in, c_, 1, 1)
        self.cv2 = ConvBN(c_ * (len(kernels) + 1), c_out, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class StemBlock(nn.Module):
    """PeleeNet-style stem; its 2x2 max pool rounds up (ceil_mode), as the
    JAX package's SAME-padded pool does."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, s: int = 2):
        super().__init__()
        self.stem_1 = ConvBN(c_in, c_out, k, s)
        self.stem_2a = ConvBN(c_out, c_out // 2, 1, 1, 0)
        self.stem_2b = ConvBN(c_out // 2, c_out, 3, 2, 1)
        self.stem_2p = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.stem_3 = ConvBN(c_out * 2, c_out, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1 = self.stem_1(x)
        s2 = self.stem_2b(self.stem_2a(s1))
        return self.stem_3(torch.cat([s2, self.stem_2p(s1)], 1))
