"""ArcFace training for the embedders, in PyTorch.

The counterpart of ``train/arcface.py`` in the JAX package (the reference
defines the ArcFace head, ``modules/mobile_facenet/mobile_facenet.py:160-201``,
but never trains it). An embedder slot (``mobile_facenet``, ``facenet``,
``facenet-512`` or ``reid-mnv2``) trains in train mode, its BatchNorms in
flax's form, under a class kernel [D, C] drawn uniform(-1, 1): the loss is
the softmax cross-entropy of ``models.mobile_facenet.arcface_logits``, plus,
with ``center_gain`` > 0, the mean squared distance of each embedding from
its class's batch mean (the means carry no gradient).

The optimizer is ``torch.optim.SGD`` (momentum, dampening 0) over two
groups, as optax's ``add_decayed_weights(mask=decay_mask)`` + ``sgd`` split
the flax tree by its leaf names: convolution and Dense kernels and the
class kernel decay; biases, BatchNorm scales and shifts and PReLU's slopes
do not. The step runs in ``train.detection.train_precision`` (f32, TF32
off on the card).

A train state is a dict: ``net`` (train mode), ``arcface_kernel`` (a
parameter on the device), ``opt``, ``cfg`` and ``device``.
The class-sharded step of the JAX package (``shard_train_state``,
``sharded_train_step``) waits for the multi-card slice (ROADMAP A12c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.mobile_facenet import arcface_logits
from ..ops.platform import resolve_device
from .detection import decay_groups, flax_init_, train_precision


@dataclasses.dataclass
class ArcFaceTrainConfig:
    num_classes: int = 512
    embedding_size: int = 512
    s: float = 64.0
    m: float = 0.5
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # "mobile_facenet" (112 px), "facenet" / "facenet-512"
    # (InceptionResNetV1, 160 px) or "reid-mnv2" (128 px)
    embedder: str = "mobile_facenet"
    # center-loss weight: pulls embeddings toward their batch class mean,
    # the statistic the similar-face filter thresholds
    center_gain: float = 0.0


def build_embedder(cfg: ArcFaceTrainConfig) -> nn.Module:
    """The slot's net at ``cfg.embedding_size``: 112 px MobileFaceNet,
    160 px InceptionResNetV1 or 128 px MobileNetV2."""
    if cfg.embedder in ("facenet", "facenet-512"):
        from ..models.facenet import InceptionResNetV1

        return InceptionResNetV1(cfg.embedding_size)
    if cfg.embedder == "reid-mnv2":
        from ..models.embedders import MobileNetV2Embedder

        return MobileNetV2Embedder(cfg.embedding_size)
    from ..models.mobile_facenet import MobileFaceNet

    return MobileFaceNet(cfg.embedding_size)


def create_train_state(cfg: ArcFaceTrainConfig,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, Any]:
    """The net with flax's initialization and the class kernel, both drawn
    from ``generator`` (seed 0 by default), on ``device`` (the card unless
    the caller passes the CPU), and SGD with the masked decay."""
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    net = build_embedder(cfg)
    flax_init_(net, gen)
    kernel = torch.rand((cfg.embedding_size, cfg.num_classes),
                        generator=gen) * 2.0 - 1.0
    net = net.to(device=device, memory_format=torch.channels_last).train()
    kernel = nn.Parameter(kernel.to(device))
    groups = decay_groups(net, cfg.weight_decay)
    groups[0]["params"].append(kernel)
    opt = torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                          dampening=0.0)
    return {"net": net, "arcface_kernel": kernel, "opt": opt, "cfg": cfg,
            "device": device}


def arcface_loss(state: Dict[str, Any], images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """The mean ArcFace cross-entropy of a batch (normalized NHWC crops,
    integer labels), plus the center term; moves the BatchNorm
    statistics (the net is in train mode)."""
    cfg: ArcFaceTrainConfig = state["cfg"]
    emb = state["net"](images)
    logits = arcface_logits(emb, labels, state["arcface_kernel"], s=cfg.s,
                            m=cfg.m)
    loss = F.cross_entropy(logits, labels.long())
    if cfg.center_gain > 0.0:
        emb = emb.to(logits.dtype)
        onehot = F.one_hot(labels.long(), cfg.num_classes).to(emb.dtype)
        counts = torch.clamp(onehot.sum(0), min=1.0)
        centers = ((onehot.T @ emb) / counts[:, None]).detach()
        d2 = torch.sum((emb - centers[labels.long()]) ** 2, -1)
        loss = loss + cfg.center_gain * d2.mean()
    return loss


def make_train_step(state: Dict[str, Any]):
    """``step(images, labels) -> loss``: one SGD update of the net and the
    class kernel in place, in ``train_precision``; the loss stays on the
    device."""
    opt = state["opt"]

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with train_precision(state["device"]):
            loss = arcface_loss(state, images, labels)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return loss.detach()

    return step


def shard_train_state(state: Dict[str, Any], mesh):
    """The class-sharded placement over several cards is not ported yet."""
    raise NotImplementedError(
        "shard_train_state (the ArcFace kernel class-sharded over a device "
        "mesh) is not ported yet: ROADMAP A12c")


def sharded_train_step(state: Dict[str, Any], mesh):
    """The data- and class-parallel step is not ported yet."""
    raise NotImplementedError(
        "sharded_train_step (data-parallel embedder, class-sharded ArcFace "
        "kernel over a device mesh) is not ported yet: ROADMAP A12c")
