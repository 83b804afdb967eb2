"""BlazeFace training: the trainable path of the MediaPipe-family detector,
in PyTorch.

The counterpart of ``train/blazeface.py`` in the JAX package. Matching is
one dense [B, N, T] mask (anchor centers inside the GT's central region,
plus each GT's nearest anchor), the score loss mines hard negatives with a
stable rank (``detection.mined_conf_loss``), and box targets are the net's
raw regression units: ``(gt - anchor_center) * scale`` for xy and ``gt_wh *
scale`` for wh (the inverse of ``ops.boxes.decode_boxes``). The net has no
BatchNorm; its four heads start at zero (the norm-free backbone's
activations run into the hundreds at init). The optimizer is optax's adamw
(``train.optim.OptaxAdam``; decay on the conv weights only) after clipping
the gradients to a global norm of 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.blazeface import BlazeFaceNet, generate_anchors
from ..ops.platform import resolve_device
from .detection import (decay_groups, flax_init_, images_to_float,
                        lr_schedule, mined_conf_loss, new_state,
                        optimizer_step, weighted_bce_logits, with_ema)
from .optim import OptaxAdam


@dataclasses.dataclass(frozen=True)
class BlazeTrainConfig:
    back_model: bool = False
    max_targets: int = 8
    center_frac: float = 0.6       # positive if anchor center in this GT core
    neg_ratio: int = 3             # hard negatives per positive
    box_gain: float = 1.0
    lr: float = 0.002
    weight_decay: float = 1e-5
    lrf: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 0
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0

    @property
    def input_size(self) -> Tuple[int, int]:
        return (256, 256) if self.back_model else (128, 128)

    @property
    def scale(self) -> float:
        return 256.0 if self.back_model else 128.0

    @property
    def arch(self) -> str:
        return "blazeface-back" if self.back_model else "blazeface-front"


def encode_blazeface_targets(anchors: torch.Tensor, gt_cxcywh: torch.Tensor,
                             gt_valid: torch.Tensor, scale: float,
                             center_frac: float = 0.6
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense matching + raw-unit encoding. anchors [N, 4] (cx, cy, 1, 1);
    gt [B, T, 4] cxcywh normalized, gt_valid [B, T]. Returns (box_t [B, N,
    4] raw regression targets, pos [B, N]). An anchor is positive for the
    GTs whose central ``center_frac`` region holds its center, and each
    valid GT claims its nearest anchor; a positive anchor regresses its
    smallest such GT."""
    b, t = gt_cxcywh.shape[:2]
    ac = anchors[:, :2]
    d = torch.abs(ac[None, :, None, :] - gt_cxcywh[:, None, :, :2])
    half = gt_cxcywh[:, None, :, 2:] * (center_frac / 2.0)
    inside = (d <= half).all(-1) & gt_valid[:, None, :]      # [B, N, T]
    dist2 = ((ac[None, :, None, :] - gt_cxcywh[:, None, :, :2]) ** 2).sum(-1)
    best_anchor = torch.argmin(dist2, dim=1)                  # [B, T]
    force = torch.zeros_like(inside)
    force.scatter_(1, best_anchor[:, None, :], gt_valid[:, None, :])
    inside = inside | force
    area = gt_cxcywh[..., 2] * gt_cxcywh[..., 3]
    cand = torch.where(inside, area[:, None, :], torch.inf)
    best_gt = torch.argmin(cand, dim=2)                       # [B, N]
    pos = inside.any(2)
    g = torch.take_along_dim(gt_cxcywh, best_gt[..., None], 1)
    t_xy = (g[..., :2] - ac[None]) * scale
    t_wh = g[..., 2:] * scale
    return torch.cat([t_xy, t_wh], -1), pos


def blazeface_loss(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                   box_t: torch.Tensor, pos: torch.Tensor, scale: float,
                   neg_ratio: int = 3, box_gain: float = 1.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smooth-L1 on the matched raw offsets (divided by ``scale``) + sigmoid
    BCE on the scores with hard-negative mining."""
    posf = pos.float()
    diff = torch.abs(raw_boxes[..., :4] - box_t) / scale
    smooth = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    l_box = (smooth * posf).sum() / torch.clamp(posf.sum(), min=1.0)
    ce = weighted_bce_logits(raw_scores[..., 0], posf)
    l_conf = mined_conf_loss(ce, pos, neg_ratio)
    zero = l_box.new_zeros(())
    return box_gain * l_box + l_conf, {"box": l_box, "obj": l_conf,
                                       "lmk": zero, "cls": zero}


def create_blaze_train_state(cfg: BlazeTrainConfig,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> Dict[str, Any]:
    """The BlazeFace train state: flax's initialization with zero heads,
    AdamW with the masked decay."""
    device = resolve_device(device)
    net = flax_init_(BlazeFaceNet(cfg.back_model),
                     generator or torch.Generator().manual_seed(0))
    with torch.no_grad():
        for head in (net.classifier_8, net.classifier_16, net.regressor_8,
                     net.regressor_16):
            head.weight.zero_()
    net = net.to(device=device, memory_format=torch.channels_last).train()
    opt = OptaxAdam(decay_groups(net, cfg.weight_decay), lr=cfg.lr)
    return new_state(net, cfg, opt, device,
                     anchors=torch.from_numpy(generate_anchors()).to(device))


def make_blaze_train_step_ema(state: Dict[str, Any]):
    """The family step: images [B, H, W, 3] uint8 RGB (normalized to x /
    127.5 - 1 on the device), targets [B, T, 14] pixel rows (landmark
    columns ignored); one clipped AdamW update and the EMA."""
    cfg: BlazeTrainConfig = state["cfg"]
    net, anchors = state["net"], state["anchors"]
    w, h = cfg.input_size
    img_scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=state["device"])
    state.setdefault("lr", lr_schedule(cfg))

    def step(images, targets, valid):
        raw_boxes, raw_scores = net(images_to_float(images, 127.5, 1.0))
        box_t, pos = encode_blazeface_targets(
            anchors, targets[..., :4] / img_scale, valid, cfg.scale,
            cfg.center_frac)
        loss, metrics = blazeface_loss(raw_boxes, raw_scores, box_t, pos,
                                       cfg.scale, cfg.neg_ratio,
                                       cfg.box_gain)
        optimizer_step(state, loss, clip_norm=10.0)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return with_ema(state, step)
