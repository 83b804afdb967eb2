"""SSD MultiBox training: the trainable path of the SSD face family, in
PyTorch.

The counterpart of ``train/ssd.py`` in the JAX package: prior matching is
one dense [B, N, T] IoU tensor (every prior takes its best GT above
``iou_pos``, every GT claims its best prior), hard-negative mining a stable
rank (``detection.mined_conf_loss``), and the step takes the uint8 BGR
batch (the OpenCV-SSD convention: no RGB swap, the BGR mean subtracted on
the device). The net's BatchNorms train in flax's form; the optimizer is
SGD with the masked decay.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.ssd import SSDConfig, SSDFaceNet, generate_priors
from ..ops.boxes import iou_matrix, xywh2xyxy
from ..ops.platform import resolve_device
from .detection import (decay_groups, flax_init_, lr_schedule,
                        mined_conf_loss, new_state, optimizer_step, with_ema)

OPENCV_SSD_MEAN = (104.0, 117.0, 123.0)  # BGR mean (ops/preprocess.py)


@dataclasses.dataclass(frozen=True)
class SSDTrainConfig:
    backbone: str = "resnet10"
    input_size: Tuple[int, int] = (300, 300)
    max_targets: int = 32
    iou_pos: float = 0.5           # prior -> gt match threshold
    neg_ratio: int = 3             # hard negatives per positive
    loc_gain: float = 1.0
    lr: float = 0.001
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lrf: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 0
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0

    @property
    def arch(self):
        return f"ssd-{self.backbone}"


def encode_ssd_targets(priors: torch.Tensor, gt_cxcywh: torch.Tensor,
                       gt_valid: torch.Tensor,
                       variances=(0.1, 0.1, 0.2, 0.2), iou_pos: float = 0.5
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense SSD matching + variance encoding. priors [N, 4] cxcywh
    normalized; gt [B, T, 4] cxcywh normalized, gt_valid [B, T]. Returns
    (loc_t [B, N, 4], pos [B, N])."""
    iou = iou_matrix(xywh2xyxy(priors)[None], xywh2xyxy(gt_cxcywh), eps=1e-9)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)         # [B, N, T]
    # bipartite force: each valid GT claims its best prior with iou 2.0
    best_prior = torch.argmax(iou, dim=1)                      # [B, T]
    force = torch.zeros(iou.shape, dtype=torch.bool, device=iou.device)
    force = force.scatter(1, best_prior[:, None, :], gt_valid[:, None, :])
    iou = torch.where(force, 2.0, iou)
    best_gt_iou, best_gt = iou.max(2)
    pos = best_gt_iou >= iou_pos
    g = torch.take_along_dim(gt_cxcywh, best_gt[..., None], 1)
    v = variances
    pw = torch.clamp(priors[None, :, 2:], min=1e-9)
    t_xy = (g[..., :2] - priors[None, :, :2]) / pw / torch.tensor(
        v[:2], device=priors.device)
    t_wh = torch.log(torch.clamp(g[..., 2:], min=1e-9) / pw) / torch.tensor(
        v[2:], device=priors.device)
    return torch.cat([t_xy, t_wh], -1), pos


def ssd_multibox_loss(locs: torch.Tensor, conf_logits: torch.Tensor,
                      loc_t: torch.Tensor, pos: torch.Tensor,
                      neg_ratio: int = 3, loc_gain: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Smooth-L1 on the matched offsets + softmax CE with hard-negative
    mining, normalized by the positive count (Liu et al. eq. 1)."""
    posf = pos.float()
    diff = torch.abs(locs - loc_t)
    smooth = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    l_loc = (smooth * posf).sum() / torch.clamp(posf.sum(), min=1.0)
    ce = -torch.take_along_dim(F.log_softmax(conf_logits, -1),
                               pos.long()[..., None], -1)[..., 0]
    l_conf = mined_conf_loss(ce, pos, neg_ratio)
    zero = l_loc.new_zeros(())
    return loc_gain * l_loc + l_conf, {"box": l_loc, "obj": l_conf,
                                       "lmk": zero, "cls": zero}


def create_ssd_train_state(cfg: SSDTrainConfig,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> Dict[str, Any]:
    """The SSD train state: flax's initialization, SGD with the masked
    decay."""
    device = resolve_device(device)
    mcfg = SSDConfig(backbone=cfg.backbone, input_size=cfg.input_size)
    net = flax_init_(SSDFaceNet(mcfg),
                     generator or torch.Generator().manual_seed(0))
    net = net.to(device=device, memory_format=torch.channels_last).train()
    opt = torch.optim.SGD(decay_groups(net, cfg.weight_decay), lr=cfg.lr,
                          momentum=cfg.momentum, dampening=0.0)
    return new_state(net, cfg, opt, device, mcfg=mcfg,
                     priors=torch.from_numpy(generate_priors(mcfg)).to(device))


def make_ssd_train_step_ema(state: Dict[str, Any]):
    """The family step: images [B, H, W, 3] uint8 BGR, targets [B, T, 14]
    pixel rows (landmark columns ignored); one SGD update and the EMA."""
    cfg: SSDTrainConfig = state["cfg"]
    net, priors, mcfg = state["net"], state["priors"], state["mcfg"]
    dev = state["device"]
    w, h = cfg.input_size
    mean = torch.tensor(OPENCV_SSD_MEAN, dtype=torch.float32, device=dev)
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    state.setdefault("lr", lr_schedule(cfg))

    def step(images, targets, valid):
        locs, conf = net(images.float() - mean)
        loc_t, pos = encode_ssd_targets(priors, targets[..., :4] / scale,
                                        valid, mcfg.variances, cfg.iou_pos)
        loss, metrics = ssd_multibox_loss(locs, conf, loc_t, pos,
                                          cfg.neg_ratio, cfg.loc_gain)
        optimizer_step(state, loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return with_ema(state, step)
