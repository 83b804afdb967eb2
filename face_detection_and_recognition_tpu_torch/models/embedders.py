"""Embedder registry: the reference's five feature-extractor slots.

The counterpart of ``models/embedders.py`` in the JAX package. The
reference's ``Net`` loader has five feat-net types:

- ``mobile_facenet``: MobileFaceNet, 512-d, 112x112, (x - 127.5) / 127.5 BGR;
- ``facenet``: Inception-ResNet-V1, 128-d, 160x160, prewhitened RGB (the
  keras FaceNet of the similar-face filter);
- ``facenet-512``: the same net with a 512-d bottleneck (OpenVINO's
  facenet);
- ``reid-mnv2``: a MobileNetV2 trunk, 256-d, 128x128, (x - 127.5) / 127.5
  BGR (OpenVINO's face-reidentification-retail class);
- ``demographics``: the two CaffeNet heads' age probabilities then gender
  probabilities, 10-d, 227x227, caffe-mean-subtracted BGR.

``build(generator, device, dtype)`` returns the network, whose forward maps
normalized NHWC crops at the slot's ``input_size`` to [N, dim] f32;
``dtype`` bfloat16 builds the JAX package's bf16 net (``models/layers.py``). The keras
FaceNet SavedModel / HDF5 reader of the JAX engine is not ported yet: the
port loads torch weight files and ``utils.weights`` state dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch import nn

from ..ops.geometry import standardize_image
from ..ops.preprocess import AGE_GENDER
from .age_gender import AgeGenderNet
from .facenet import make_facenet
from .layers import (BF16, l2_normalize, linear_bias_bf16, mean_hw_bf16,
                     set_compute_dtype)
from .mobile_facenet import make_mobile_facenet
from .ssd import _MobileNetV2Backbone


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    name: str
    dim: int
    input_size: Tuple[int, int]  # (width, height)
    norm: str                    # "half" | "prewhiten" | "caffe_mean"
    rgb: bool
    build: Callable


class MobileNetV2Embedder(nn.Module):
    """MobileNetV2 trunk -> mean of its last (stride-64) map -> Dense ->
    L2-normalized ``embedding_size`` embedding. Takes NHWC crops;
    ``compute_dtype`` bfloat16 runs the JAX package's bf16 net."""

    def __init__(self, embedding_size: int = 256):
        super().__init__()
        self.backbone = _MobileNetV2Backbone()
        self.fc = nn.Linear(256, embedding_size)
        self.compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        if feats[-1].dtype == BF16:
            y = linear_bias_bf16(self.fc, mean_hw_bf16(feats[-1]))
        else:
            y = self.fc(feats[-1].mean((2, 3)))
        return l2_normalize(y.float(), axis=-1)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator
                     ) -> "MobileNetV2Embedder":
        """Conv and linear weights from N(0, 1/fan_in) drawn from
        ``generator`` (CPU), biases 0, and the BN statistics from one batch
        of 4 uniform(-1, 1) 128x128 crops (the normalized input range)."""
        bns = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
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
        self(torch.rand((4, 128, 128, 3), generator=generator) * 2 - 1)
        for bn in bns:
            bn.momentum = 0.03
        return self.eval()


class Demographics(AgeGenderNet):
    """The two age/gender heads as one 10-d feature vector: the age
    probabilities [N, 8], then the gender probabilities [N, 2]. Its state
    dict is ``AgeGenderNet``'s (``age.*``, ``gender.*``)."""

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        return torch.cat(super().forward(crops), -1)


def preprocess_crops(spec: EmbedderSpec, crops_bgr: torch.Tensor
                     ) -> torch.Tensor:
    """Crop normalization for every embedder call site: channel order and
    the spec's norm recipe. crops_bgr: [N, H, W, 3] BGR already at
    ``spec.input_size``."""
    x = crops_bgr.float()
    if spec.rgb:
        x = x.flip(-1)
    if spec.norm == "half":
        return (x - 127.5) / 127.5
    if spec.norm == "prewhiten":
        return standardize_image(x)
    if spec.norm == "caffe_mean":
        return x - torch.tensor(AGE_GENDER.mean, dtype=torch.float32,
                                device=x.device)
    raise ValueError(f"unknown embedder norm '{spec.norm}'")


_EMBEDDERS = {}


def register_embedder(spec: EmbedderSpec) -> EmbedderSpec:
    _EMBEDDERS[spec.name] = spec
    return spec


def get_embedder(name: str) -> EmbedderSpec:
    if name not in _EMBEDDERS:
        raise KeyError(f"unknown embedder '{name}'; have {sorted(_EMBEDDERS)}")
    return _EMBEDDERS[name]


def available_embedders():
    return sorted(_EMBEDDERS)


def _on(device: torch.device, net: nn.Module, dtype: torch.dtype
        ) -> nn.Module:
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    return set_compute_dtype(net, dtype)


def _build_facenet512(generator: torch.Generator, device: torch.device,
                      dtype: torch.dtype = torch.float32):
    return make_facenet(generator, device, embedding_size=512, dtype=dtype)


def _build_reid(generator: torch.Generator, device: torch.device,
                dtype: torch.dtype = torch.float32):
    return _on(device, MobileNetV2Embedder().init_random_(generator), dtype)


def _build_demographics(generator: torch.Generator, device: torch.device,
                        dtype: torch.dtype = torch.float32):
    return _on(device, Demographics().init_random_(generator), dtype)


register_embedder(EmbedderSpec("mobile_facenet", 512, (112, 112), "half",
                               rgb=False, build=make_mobile_facenet))
register_embedder(EmbedderSpec("facenet", 128, (160, 160), "prewhiten",
                               rgb=True, build=make_facenet))
register_embedder(EmbedderSpec("facenet-512", 512, (160, 160), "prewhiten",
                               rgb=True, build=_build_facenet512))
register_embedder(EmbedderSpec("reid-mnv2", 256, (128, 128), "half",
                               rgb=False, build=_build_reid))
register_embedder(EmbedderSpec("demographics", 10, (227, 227), "caffe_mean",
                               rgb=False, build=_build_demographics))
