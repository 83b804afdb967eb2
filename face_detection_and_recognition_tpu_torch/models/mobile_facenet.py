"""MobileFaceNet embedder: 112x112 BGR crops in, 512-d L2-normalized
embeddings out.

The counterpart of ``models/mobile_facenet.py`` in the JAX package. The
submodules carry the reference torch implementation's names (``conv1``,
``conv2_dw``, ``conv_23``, ``conv_3.model.{i}``, ..., ``linear``, ``bn``), the
names the JAX package's ``convert_mobile_facenet`` reads, so a reference
state dict loads unchanged. Input normalization, (x - 127.5) / 127.5 on BGR
crops, is ``models.embedders.preprocess_crops``. The ArcFace head is
training and arrives with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import (BF16, MFConvBlock, MFDepthWise, MFLinearBlock,
                     batch_norm_bf16, l2_normalize, linear_sums,
                     set_compute_dtype)


class Residual(nn.Module):
    """``num_block`` residual depthwise units: the reference's
    ``Residual`` (``model.{i}``)."""

    def __init__(self, c: int, num_block: int, groups: int):
        super().__init__()
        self.model = nn.Sequential(*(MFDepthWise(c, c, groups, 1, True)
                                     for _ in range(num_block)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class MobileFaceNet(nn.Module):
    """512-d face embedder. Takes NHWC [N, 112, 112, 3] normalized crops and
    returns [N, 512] f32 unit vectors. ``compute_dtype`` bfloat16 runs the
    JAX package's bf16 net (``models/layers.py``): the input cast to bf16,
    the Dense's f32 sums into the last BatchNorm, rounded once, then the
    f32 normalization."""

    def __init__(self, embedding_size: int = 512):
        super().__init__()
        self.conv1 = MFConvBlock(3, 64, 3, 2, 1)
        self.conv2_dw = MFConvBlock(64, 64, 3, 1, 1, groups=64)
        self.conv_23 = MFDepthWise(64, 64, 128)
        self.conv_3 = Residual(64, 4, 128)
        self.conv_34 = MFDepthWise(64, 128, 256)
        self.conv_4 = Residual(128, 6, 256)
        self.conv_45 = MFDepthWise(128, 128, 512)
        self.conv_5 = Residual(128, 2, 256)
        self.conv_6_sep = MFConvBlock(128, 512, 1)
        self.conv_6_dw = MFLinearBlock(512, 512, 7, groups=512)
        self.linear = nn.Linear(512, embedding_size, bias=False)
        self.bn = nn.BatchNorm1d(embedding_size, eps=1e-5)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC data -> NCHW channels-last view
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        for m in (self.conv1, self.conv2_dw, self.conv_23, self.conv_3,
                  self.conv_34, self.conv_4, self.conv_45, self.conv_5,
                  self.conv_6_sep, self.conv_6_dw):
            x = m(x)
        if x.dtype == BF16:
            x = batch_norm_bf16(self.bn, linear_sums(self.linear,
                                                     x.flatten(1)))
        else:
            x = self.bn(self.linear(x.flatten(1)))
        return l2_normalize(x.float(), axis=-1)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "MobileFaceNet":
        """Draw every weight from ``generator`` (CPU): conv and linear
        weights from N(0, 1/fan_in), PReLU slopes 0.25, and BN statistics
        from one batch of uniform(-1, 1) crops (the normalized input range)
        drawn from the same generator, so that the activations keep their
        scale through the 50-odd layers."""
        bns = [m for m in self.modules()
               if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))]
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * fan_in ** -0.5)
        for bn in bns:
            bn.reset_parameters()
            bn.momentum = None  # cumulative: one batch sets the statistics
        self.train()
        self(torch.rand((8, 112, 112, 3), generator=generator) * 2 - 1)
        for bn in bns:
            bn.momentum = 0.1
        return self.eval()


def make_mobile_facenet(generator: torch.Generator, device: torch.device,
                        dtype: torch.dtype = torch.float32) -> MobileFaceNet:
    """A MobileFaceNet with weights drawn from ``generator``, on ``device``
    in the channels-last memory format, in eval mode, computing in
    ``dtype`` (float32 or bfloat16)."""
    net = MobileFaceNet().init_random_(generator)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    return set_compute_dtype(net, dtype)
