"""MobileFaceNet embedder: 112x112 BGR crops in, 512-d L2-normalized
embeddings out.

The counterpart of ``models/mobile_facenet.py`` in the JAX package. The
submodules carry the reference torch implementation's names (``conv1``,
``conv2_dw``, ``conv_23``, ``conv_3.model.{i}``, ..., ``linear``, ``bn``), the
names the JAX package's ``convert_mobile_facenet`` reads, so a reference
state dict loads unchanged. Input normalization, (x - 127.5) / 127.5 on BGR
crops, is ``models.embedders.preprocess_crops``. ``arcface_logits`` is the
ArcFace margin head that ``train/arcface.py`` trains the embedders with. In
train mode every BatchNorm is flax's (``layers.BatchNorm2d`` /
``BatchNorm1d``, momentum 0.99 in flax's sense).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import (BF16, BatchNorm1d, MFConvBlock, MFDepthWise,
                     MFLinearBlock, batch_norm_bf16, jax_clip, l2_normalize,
                     linear_sums, set_compute_dtype)


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
        self.bn = BatchNorm1d(embedding_size, eps=1e-5, momentum=0.01)
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
            bn.momentum = 0.01
        return self.eval()


def arcface_logits(embeddings: torch.Tensor, labels: torch.Tensor,
                   kernel: torch.Tensor, s: float = 64.0, m: float = 0.5,
                   col0: int = 0) -> torch.Tensor:
    """ArcFace additive-angular-margin logits (the reference's
    ``mobile_facenet.py:160-201``; JAX ``models/mobile_facenet.py:78-101``).

    embeddings [B, D] L2-normalized, labels [B], kernel [D, C] (each column
    normalized inside). Returns s * cos(theta) [B, C] with cos(theta + m)
    at the label positions, and the fallback ``cos - sin(m) * m`` where
    ``cos <= cos(pi - m)``. The clips are ``jax_clip``, so that the
    gradient at cos = +-1 is JAX's; the product is in the wider of the two
    dtypes, as JAX promotes it. ``col0``: the class of the kernel's first
    column, for a kernel that is one class shard of a wider one (a label
    outside the shard takes no margin there)."""
    kn = l2_normalize(kernel, axis=0)
    emb = embeddings.to(torch.promote_types(embeddings.dtype, kn.dtype))
    cos = jax_clip(emb @ kn, -1.0, 1.0)
    sin = torch.sqrt(jax_clip(1.0 - cos ** 2, 0.0, 1.0))
    cos_m, sin_m = math.cos(m), math.sin(m)
    cos_theta_m = cos * cos_m - sin * sin_m
    threshold = math.cos(math.pi - m)
    keep = cos - sin_m * m
    cos_theta_m = torch.where(cos - threshold <= 0, keep, cos_theta_m)
    cols = torch.arange(col0, col0 + kernel.shape[1], device=cos.device)
    onehot = (labels.long()[:, None] == cols).to(cos.dtype)
    return s * (onehot * cos_theta_m + (1.0 - onehot) * cos)


def make_mobile_facenet(generator: torch.Generator, device: torch.device,
                        dtype: torch.dtype = torch.float32) -> MobileFaceNet:
    """A MobileFaceNet with weights drawn from ``generator``, on ``device``
    in the channels-last memory format, in eval mode, computing in
    ``dtype`` (float32 or bfloat16)."""
    net = MobileFaceNet().init_random_(generator)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    return set_compute_dtype(net, dtype)
