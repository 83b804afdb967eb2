"""Embedder registry.

The counterpart of ``models/embedders.py`` in the JAX package, which has the
reference's five feature-extractor slots. This port has the
``mobile_facenet`` slot so far; ``build(generator, device)`` returns the
network, whose forward maps normalized NHWC crops to [N, dim] embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ..ops.preprocess import AGE_GENDER
from .mobile_facenet import make_mobile_facenet


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    name: str
    dim: int
    input_size: Tuple[int, int]  # (width, height)
    norm: str                    # "half" = (x-127.5)/127.5 | "caffe_mean"
    rgb: bool
    build: Callable


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


register_embedder(EmbedderSpec("mobile_facenet", 512, (112, 112), "half",
                               rgb=False, build=make_mobile_facenet))
