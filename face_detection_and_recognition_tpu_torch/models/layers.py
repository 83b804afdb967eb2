"""The yolov5-face, BlazeFace and MobileFaceNet building blocks as PyTorch
modules.

The counterparts of ``models/layers.py`` in the JAX package. Submodules carry
the reference torch names (``conv``/``bn``, ``cv1``..``cv3``, ``m``,
``stem_*``, ``convs``), so a network's ``state_dict`` keys are those of a
reference checkpoint. Tensors are NCHW; the network keeps them in the
channels-last memory format.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import conv_int8, pack_kernel_q


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


def make_divisible_torch(x: float, divisor: int) -> int:
    """Channel-width rounding of the reference's parse_model: ceil to a
    multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def param_key(name: str) -> str:
    """A file's layer or constant name as a module or parameter name:
    percent-encoded, so that '.' and '/' (which ``nn.Module`` names
    refuse or split on) become '%2E' and '%2F', one to one."""
    return (name.replace("%", "%25").replace(".", "%2E")
            .replace("/", "%2F"))


_ACTS = {"silu": nn.SiLU, "relu": nn.ReLU, "relu6": nn.ReLU6,
         None: nn.Identity}


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation: the yolov5 ``Conv``. The
    BN epsilon is the JAX package's 1e-3, not PyTorch's default 1e-5.
    ``groups`` and ``act`` ("silu", "relu", "relu6" or None for a linear
    output) serve the SSD trunks; the defaults are the yolov5 ``Conv``."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, groups: int = 1,
                 act: Optional[str] = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, autopad(k, p), groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.03)
        self.act = _ACTS[act]()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class QConvBN(nn.Module):
    """The int8 ConvBN (the JAX package's ``ConvBN(quantized=True |
    "static")``): BN folded into per-output-channel int8 weights
    ``kernel_q`` [C_out, k, k, C_in / g] (OHWI) with scales ``wscale`` and
    a ``bias``; the input quantized per tensor, from its absmax over the
    whole batch or, ``static``, from the calibrated ``ascale``; the codes
    convolved into int32 sums (``ops.int8_conv.conv_int8``: the Q1 kernel
    on the card), then dequantized, biased and passed through SiLU or
    none. ``utils.quantize`` builds the weights. On the card the kernel
    reads them packed (``pack_kernel_q``), packed once for each new or
    changed ``kernel_q``."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, groups: int = 1,
                 act: Optional[str] = "silu", static: bool = False):
        super().__init__()
        self.stride, self.pad, self.groups, self.act = s, autopad(k, p), \
            groups, act
        self.register_buffer("kernel_q", torch.zeros(
            (c_out, k, k, c_in // groups), dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(c_out))
        self.register_buffer("bias", torch.zeros(c_out))
        self.register_buffer("ascale", torch.ones(()) if static else None)
        self._wpack = self._wpack_of = None

    def _apply(self, fn, *args, **kwargs):
        # Module.to(memory_format=channels_last) restrides every 4-D
        # buffer; the kernel reads the codes as dense OHWI
        out = super()._apply(fn, *args, **kwargs)
        self.kernel_q = self.kernel_q.contiguous()
        return out

    def _packed(self) -> Optional[torch.Tensor]:
        """Q1's packed weights for the current ``kernel_q`` (None on the
        CPU): made again after ``to()`` or a weight load, which replace the
        tensor or bump its version. An inference tensor has no version:
        its pack is made every call."""
        kq = self.kernel_q
        if kq.device.type == "cpu":
            return None
        if kq.is_inference():
            return pack_kernel_q(kq, self.groups)
        of = self._wpack_of
        if of is None or of[0] is not kq or of[1] != kq._version:
            self._wpack = pack_kernel_q(kq, self.groups)
            self._wpack_of = (kq, kq._version)
        return self._wpack

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_int8(x, self.kernel_q, self.wscale, self.bias,
                         self.stride, self.pad, self.groups, self.act,
                         self.ascale, self._packed())


def conv_bn(c_in: int, c_out: int, k: int = 1, s: int = 1,
            p: Optional[int] = None, groups: int = 1,
            act: Optional[str] = "silu", quantized=False) -> nn.Module:
    """A ConvBN, or its int8 form when ``quantized`` (True: dynamic
    activation scales; "static": calibrated ones)."""
    if quantized:
        return QConvBN(c_in, c_out, k, s, p, groups, act,
                       static=quantized == "static")
    return ConvBN(c_in, c_out, k, s, p, groups, act)


class Bottleneck(nn.Module):
    """Standard bottleneck, with a residual when shapes allow."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 e: float = 0.5, quantized=False):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_, c_out, 3, 1, quantized=quantized)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = True, e: float = 0.5, quantized=False):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv3 = conv_bn(2 * c_, c_out, 1, quantized=quantized)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0,
                                            quantized=quantized)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: stride-1 'same' max pools of several sizes."""

    def __init__(self, c_in: int, c_out: int,
                 kernels: Sequence[int] = (5, 9, 13), quantized=False):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_ * (len(kernels) + 1), c_out, 1, 1,
                           quantized=quantized)
        self.m = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class StemBlock(nn.Module):
    """PeleeNet-style stem; its 2x2 max pool rounds up (ceil_mode), as the
    JAX package's SAME-padded pool does."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, s: int = 2,
                 quantized=False):
        super().__init__()
        q = dict(quantized=quantized)
        self.stem_1 = conv_bn(c_in, c_out, k, s, **q)
        self.stem_2a = conv_bn(c_out, c_out // 2, 1, 1, 0, **q)
        self.stem_2b = conv_bn(c_out // 2, c_out, 3, 2, 1, **q)
        self.stem_2p = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.stem_3 = conv_bn(c_out * 2, c_out, 1, 1, 0, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1 = self.stem_1(x)
        s2 = self.stem_2b(self.stem_2a(s1))
        return self.stem_3(torch.cat([s2, self.stem_2p(s1)], 1))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle of NCHW ``x``: channel j of the output is
    channel (j % groups) * (C / groups) + j // groups of the input. A
    channels-last ``x`` gives a channels-last result (the permutation made
    within each pixel's NHWC row), so the next layers read it in place."""
    b, c, h, w = x.shape
    if x.dim() == 4 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups) \
            .transpose(3, 4).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(b, c, h, w)


def _conv_bn(c_in: int, c_out: int, k: int, s: int, groups: int = 1):
    """(Conv2d without bias, BatchNorm) of a ShuffleV2 branch; BN epsilon
    1e-3, the JAX package's ConvBN."""
    return (nn.Conv2d(c_in, c_out, k, s, k // 2, groups=groups, bias=False),
            nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.03))


class ShuffleV2Block(nn.Module):
    """ShuffleNetV2 unit with SiLU activations (yolov5n). The branches are
    the reference's ``nn.Sequential``s, so their indices are its state_dict
    names: branch1 = (dw conv, bn, conv, bn, SiLU) when strided, branch2 =
    (conv, bn, SiLU, dw conv, bn, conv, bn, SiLU). ``quantized``: each
    (conv, bn) pair is one ``QConvBN`` (the depthwise ones linear), so
    branch1 = (dw, 1x1) and branch2 = (1x1, dw, 1x1)."""

    def __init__(self, c_in: int, c_out: int, stride: int, quantized=False):
        super().__init__()
        self.stride = stride
        bf = c_out // 2
        c2 = c_in if stride > 1 else c_in // 2
        if quantized:
            q = dict(quantized=quantized)
            self.branch1 = nn.Sequential(
                conv_bn(c_in, c_in, 3, stride, 1, c_in, None, **q),
                conv_bn(c_in, bf, 1, 1, 0, **q)) if stride > 1 \
                else nn.Sequential()
            self.branch2 = nn.Sequential(
                conv_bn(c2, bf, 1, 1, 0, **q),
                conv_bn(bf, bf, 3, stride, 1, bf, None, **q),
                conv_bn(bf, bf, 1, 1, 0, **q))
            return
        if stride > 1:
            self.branch1 = nn.Sequential(*_conv_bn(c_in, c_in, 3, stride, c_in),
                                         *_conv_bn(c_in, bf, 1, 1), nn.SiLU())
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            *_conv_bn(c2, bf, 1, 1), nn.SiLU(),
            *_conv_bn(bf, bf, 3, stride, bf), *_conv_bn(bf, bf, 1, 1),
            nn.SiLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


# ---------------- BlazeFace blocks ----------------


def _blaze_convs(c_in: int, c_out: int, k: int, stride: int, pad: int
                 ) -> nn.Sequential:
    """Depthwise k x k conv, then 1x1 conv, both with bias (the TFLite
    export folded BN into them): the reference's ``convs``."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_in, k, stride, pad, groups=c_in, bias=True),
        nn.Conv2d(c_in, c_out, 1, bias=True))


class BlazeBlock(nn.Module):
    """Depthwise-separable residual block with TFLite stride-2 padding.

    Stride 2: the depthwise conv reads x padded by (0, 2, 0, 2) with no
    padding of its own, and the residual is max-pooled 2x2; a channel
    deficit of the residual is zero-padded."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.c_pad = c_out - c_in
        self.convs = _blaze_convs(c_in, c_out, k, stride,
                                  0 if stride == 2 else (k - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            h, res = F.pad(x, (0, 2, 0, 2)), F.max_pool2d(x, 2, 2)
        else:
            h, res = x, x
        if self.c_pad > 0:
            res = F.pad(res, (0, 0, 0, 0, 0, self.c_pad))
        return F.relu(self.convs(h) + res)


class FinalBlazeBlock(nn.Module):
    """Stride-2 separable block without residual (BlazeFace back's
    ``final``)."""

    def __init__(self, channels: int, k: int = 3):
        super().__init__()
        self.convs = _blaze_convs(channels, channels, k, 2, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.convs(F.pad(x, (0, 2, 0, 2))))


# ---------------- MobileFaceNet blocks ----------------


class MFConvBlock(nn.Module):
    """Conv (no bias) + BN + per-channel PReLU: the reference's
    ``Conv_block`` (``conv``, ``bn``, ``prelu``). BN epsilon 1e-5."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5)
        self.prelu = nn.PReLU(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.bn(self.conv(x)))


class MFLinearBlock(nn.Module):
    """Conv (no bias) + BN, no activation: the reference's
    ``Linear_block``."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class MFDepthWise(nn.Module):
    """Pointwise expand to ``groups`` channels -> depthwise 3x3 -> linear
    project to ``c_out``, with an optional residual: the reference's
    ``Depth_Wise`` (``conv``, ``conv_dw``, ``project``)."""

    def __init__(self, c_in: int, c_out: int, groups: int, stride: int = 2,
                 residual: bool = False):
        super().__init__()
        self.conv = MFConvBlock(c_in, groups, 1)
        self.conv_dw = MFConvBlock(groups, groups, 3, stride, 1, groups=groups)
        self.project = MFLinearBlock(groups, c_out, 1)
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.conv_dw(self.conv(x)))
        return x + y if self.residual else y


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                           min=eps)
