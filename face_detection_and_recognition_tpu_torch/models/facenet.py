"""FaceNet embedder: Inception-ResNet-V1 -> 128-d or 512-d, in PyTorch.

The counterpart of ``models/facenet.py`` in the JAX package: the stem, 5 x
block35, reduction-A, 10 x block17, reduction-B, 5 x block8 and a last
block8 without its relu, then a global mean, a bias-free bottleneck Dense,
BatchNorm and L2 normalisation, on 160x160 prewhitened RGB crops. Modules
carry the names of the common PyTorch Inception-ResNet-V1 (``conv2d_1a``,
``repeat_1``, ``mixed_6a``, ``block8``, ``last_linear``, ``last_bn``...).

The conv block is conv (no bias) + BatchNorm without a scale (flax's
``use_scale=False``: here a BatchNorm whose weight stays 1, with no
gradient, ``layers.freeze_scale``) with epsilon 1e-3, then relu; in train
mode the BatchNorms are flax's (momentum 0.99 in flax's sense). Flax's
``SAME`` padding at stride 1 is (k - 1) / 2 on each side of each axis, so
the (1, 7) and (7, 1) kernels pad (0, 3) and (3, 0); every stride-2 conv
and the max pools are ``VALID``.

``compute_dtype`` bfloat16 runs the JAX package's bf16 net
(``models/layers.py``): the blocks' up-projections are bf16 convolutions
with a bias, and ``x + scale * up`` rounds the product with the scale
rounded to bf16, then the sum.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BF16, BatchNorm1d, BatchNorm2d, batch_norm_bf16,
                     bf16_scalar, conv_bias_bf16, conv_sums, freeze_scale,
                     l2_normalize, linear_sums, mean_hw_bf16,
                     set_compute_dtype)

Kernel = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """conv (no bias) + BN (weight 1, eps 1e-3) + relu: the JAX ``CB``.
    ``same`` pads (k - 1) / 2 on each side of each axis (flax ``SAME`` at
    stride 1); otherwise no padding (``VALID``)."""

    def __init__(self, c_in: int, c_out: int, kernel: Kernel = 3,
                 stride: int = 1, same: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        pad = ((kh - 1) // 2, (kw - 1) // 2) if same else (0, 0)
        self.conv = nn.Conv2d(c_in, c_out, (kh, kw), stride, pad, bias=False)
        self.bn = freeze_scale(BatchNorm2d(c_out, eps=1e-3, momentum=0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return F.relu(batch_norm_bf16(self.bn, conv_sums(self.conv, x)))
        return F.relu(self.bn(self.conv(x)))


def _residual(x: torch.Tensor, up_conv: nn.Conv2d, cat: torch.Tensor,
              scale: float) -> torch.Tensor:
    """``x + scale * up_conv(cat)``, in bf16 as flax computes it for a bf16
    ``x``."""
    if x.dtype == BF16:
        return x + bf16_scalar(scale) * conv_bias_bf16(up_conv, cat)
    return x + scale * up_conv(cat)


class Block35(nn.Module):
    """Inception-ResNet-A on 256 channels."""

    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1),
                                     BasicConv2d(32, 32, 3),
                                     BasicConv2d(32, 32, 3))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                        1)
        return F.relu(_residual(x, self.conv2d, cat, self.scale))


class Block17(nn.Module):
    """Inception-ResNet-B on 896 channels."""

    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(BasicConv2d(896, 128, 1),
                                     BasicConv2d(128, 128, (1, 7)),
                                     BasicConv2d(128, 128, (7, 1)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(_residual(x, self.conv2d, cat, self.scale))


class Block8(nn.Module):
    """Inception-ResNet-C on 1792 channels; ``relu=False`` for the last."""

    def __init__(self, scale: float = 0.20, relu: bool = True):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(1792, 192, 1),
                                     BasicConv2d(192, 192, (1, 3)),
                                     BasicConv2d(192, 192, (3, 1)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.branch0(x), self.branch1(x)], 1)
        y = _residual(x, self.conv2d, cat, self.scale)
        return F.relu(y) if self.relu else y


class Mixed6a(nn.Module):
    """Reduction-A: 256 -> 896 channels, stride 2."""

    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, 2, same=False)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1),
                                     BasicConv2d(192, 192, 3),
                                     BasicConv2d(192, 256, 3, 2, same=False))
        self.branch2 = nn.MaxPool2d(3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)],
                         1)


class Mixed7a(nn.Module):
    """Reduction-B: 896 -> 1792 channels, stride 2."""

    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 384, 3, 2, same=False))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3, 2, same=False))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1),
                                     BasicConv2d(256, 256, 3),
                                     BasicConv2d(256, 256, 3, 2, same=False))
        self.branch3 = nn.MaxPool2d(3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class InceptionResNetV1(nn.Module):
    """NHWC [N, 160, 160, 3] prewhitened RGB -> [N, ``embedding_size``]
    L2-normalized embeddings."""

    def __init__(self, embedding_size: int = 128):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, 2, same=False)
        self.conv2d_2a = BasicConv2d(32, 32, 3, 1, same=False)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1)
        self.maxpool_3a = nn.MaxPool2d(3, 2)
        self.conv2d_3b = BasicConv2d(64, 80, 1, 1, same=False)
        self.conv2d_4a = BasicConv2d(80, 192, 3, 1, same=False)
        self.conv2d_4b = BasicConv2d(192, 256, 3, 2, same=False)
        self.repeat_1 = nn.Sequential(*(Block35() for _ in range(5)))
        self.mixed_6a = Mixed6a()
        self.repeat_2 = nn.Sequential(*(Block17() for _ in range(10)))
        self.mixed_7a = Mixed7a()
        self.repeat_3 = nn.Sequential(*(Block8() for _ in range(5)))
        self.block8 = Block8(scale=1.0, relu=False)
        self.last_linear = nn.Linear(1792, embedding_size, bias=False)
        self.last_bn = freeze_scale(BatchNorm1d(embedding_size, eps=1e-3,
                                                momentum=0.01))
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC data -> NCHW channels-last view
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        for m in (self.conv2d_1a, self.conv2d_2a, self.conv2d_2b,
                  self.maxpool_3a, self.conv2d_3b, self.conv2d_4a,
                  self.conv2d_4b, self.repeat_1, self.mixed_6a,
                  self.repeat_2, self.mixed_7a, self.repeat_3, self.block8):
            x = m(x)
        if x.dtype == BF16:
            x = batch_norm_bf16(self.last_bn,
                                linear_sums(self.last_linear,
                                            mean_hw_bf16(x)))
        else:
            x = self.last_bn(self.last_linear(x.mean((2, 3))))
        return l2_normalize(x.float(), axis=-1)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "InceptionResNetV1":
        """Draw every weight from ``generator`` (CPU): conv and linear
        weights from N(0, 1/fan_in), conv biases 0, BN weights 1 (they have
        no scale) and biases 0, and the BN statistics from one batch of 4
        standard-normal 160x160 crops (the prewhitened input's range) drawn
        from the same generator."""
        bns = [m for m in self.modules()
               if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))]
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
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
        self(torch.randn((4, 160, 160, 3), generator=generator))
        for bn in bns:
            bn.momentum = 0.01
        return self.eval()


def make_facenet(generator: torch.Generator, device: torch.device,
                 embedding_size: int = 128,
                 dtype: torch.dtype = torch.float32) -> InceptionResNetV1:
    """An InceptionResNetV1 with weights drawn from ``generator``, on
    ``device`` in the channels-last memory format, in eval mode, computing
    in ``dtype`` (float32 or bfloat16)."""
    net = InceptionResNetV1(embedding_size).init_random_(generator)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    return set_compute_dtype(net, dtype)
