"""YOLOv5-face detector training: the losses, the dense target builder and
the train step, in PyTorch.

The counterpart of ``train/detection.py`` in the JAX package: CIoU box loss,
BCE objectness and class loss with the reference's per-level balance, Wing
landmark loss, over the raw detect maps [B, na, gh, gw, no]; targets built
as dense per-level tensors with no host sync (the yolov5 recipe: anchors
with max(w_ratio, h_ratio) < anchor_t at the GT's cell and its two nearest
neighbour cells are positives).

The net trains as an ``nn.Module`` in train mode, its BatchNorm in flax's
form (``models.layers.BatchNorm2d``); gradients come from autograd; the
optimizer is ``torch.optim.SGD`` (momentum, dampening 0) with two parameter
groups, as optax's ``add_decayed_weights(mask=decay_mask)`` + ``sgd`` split
them: conv and linear weights decay, BatchNorm scales and every bias do not.
The learning rate of each update is optax's ``warmup_cosine_decay_schedule``
at the 0-based update count (``lr_schedule``), set on the groups from a
host-side count before each ``step()``.

Every family's step trains in full f32 (``train_precision``): on the card
cuDNN's TF32 convolutions are off for the forward and the backward, as the
engine's forward turns them off, so the card trains at the precision of the
JAX package's f32 reference and of the CPU; and cuDNN takes its
deterministic algorithms, so a run repeats as the JAX package's does.

A train state is a dict: ``net`` (train mode), ``cfg``, ``opt``, ``ema`` (a
copy of the net whose parameters the ``_ema`` step averages and whose
BatchNorm statistics the device loop averages), ``n_updates`` (an int32
tensor on the device, the EMA ramp's counter) and ``updates`` (the host
count of optimizer steps, the schedule's input).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.yolov5_face import ARCHS, OFFICIAL_ANCHORS, YoloV5FaceNet
from ..ops.boxes import xywh2xyxy
from ..ops.platform import resolve_device

# flax's lecun_normal: a normal truncated at 2 standard deviations, scaled so
# that its variance is 1 / fan_in (the truncation's std is 0.8796...)
_TRUNC_STD = 0.87962566103423978


def ciou(box1: torch.Tensor, box2: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between [..., 4] xywh boxes (loss.py bbox_iou CIoU=True);
    the aspect term's alpha carries no gradient."""
    b1, b2 = xywh2xyxy(box1), xywh2xyxy(box2)
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = box1[..., 2] * box1[..., 3]
    a2 = box2[..., 2] * box2[..., 3]
    iou = inter / (a1 + a2 - inter + eps)
    c_lt = torch.minimum(b1[..., :2], b2[..., :2])
    c_rb = torch.maximum(b1[..., 2:], b2[..., 2:])
    c2 = torch.sum((c_rb - c_lt) ** 2, -1) + eps
    rho2 = torch.sum((box1[..., :2] - box2[..., :2]) ** 2, -1)
    v = (4 / math.pi ** 2) * (
        torch.atan(box2[..., 2] / (box2[..., 3] + eps))
        - torch.atan(box1[..., 2] / (box1[..., 3] + eps))) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - rho2 / c2 - alpha.detach() * v


def wing_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              w: float = 10.0, e: float = 2.0) -> torch.Tensor:
    """Wing loss for landmark regression (loss.py WingLoss), the masked
    mean; ``mask`` also zeroes invisible landmarks."""
    c = w - w * math.log(1.0 + w / e)
    d = torch.abs(pred - target)
    losses = torch.where(d < w, w * torch.log(1.0 + d / e), d - c) * mask
    return losses.sum() / torch.clamp(mask.sum(), min=1.0)


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    arch: str = "yolov5n"
    nc: int = 1
    input_size: Tuple[int, int] = (640, 640)
    max_targets: int = 32          # padded GT faces per image
    box_gain: float = 0.05
    obj_gain: float = 1.0
    cls_gain: float = 0.5
    lmk_gain: float = 0.005
    anchor_t: float = 4.0          # anchor ratio threshold
    lr: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    # per-level objectness balance (loss.py balance=[4.0, 1.0, 0.4])
    level_balance: Tuple[float, ...] = (4.0, 1.0, 0.4)
    obj_pw: float = 1.0            # objectness BCE pos_weight
    cls_pw: float = 1.0            # class BCE pos_weight
    gr: float = 1.0                # iou-ratio for tobj: (1-gr) + gr*iou
    lrf: float = 0.2               # final LR fraction for cosine decay
    warmup_steps: int = 0          # linear LR warmup steps
    total_steps: int = 0           # cosine horizon; 0: constant-lr SGD
    ema_decay: float = 0.9999      # ModelEMA decay ceiling
    ema_tau: float = 2000.0        # ramp: d = decay*(1-exp(-updates/tau))
    # False: the official (multiclass) yolov5 head, no = nc + 5
    with_landmarks: bool = True


def anchors_for(cfg: DetTrainConfig):
    """The anchor set the engine decodes this head with: yolov5-face's for
    the landmark head, the official yolov5s.yaml set for the landmark-less
    one."""
    return ARCHS[cfg.arch]["anchors"] if cfg.with_landmarks \
        else OFFICIAL_ANCHORS


def build_targets(targets: torch.Tensor, target_valid: torch.Tensor,
                  anchors: Sequence[Sequence[Tuple[float, float]]],
                  strides: Sequence[int], grid_hw: Sequence[Tuple[int, int]],
                  anchor_t: float) -> List[Dict[str, torch.Tensor]]:
    """Dense target maps from padded GT, on the targets' device with no
    host sync.

    targets: [B, T, 14] rows [cx, cy, w, h, lmk x10] in input pixels;
    target_valid [B, T]. Returns per level: tobj [B, na, gh, gw] (0/1),
    tbox [B, na, gh, gw, 4] (xywh in grid units relative to the cell),
    tlmk and lmk_mask [B, na, gh, gw, 10], and the level's anchors in grid
    units. Each GT is also assigned to the nearest lateral cell in x and in
    y. Where several matched rows share a (cell, anchor) slot, the last of
    them in (image, row, anchor) order writes it, as the JAX package's
    scatter does; unmatched rows write nothing."""
    out = []
    dev = targets.device
    b = targets.shape[0]
    for anc, stride, (gh, gw) in zip(anchors, strides, grid_hw):
        na = len(anc)
        anc_arr = torch.tensor(anc, dtype=torch.float32, device=dev) / stride
        t = targets / stride
        cx, cy, w, h = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
        fcx, fcy = torch.floor(cx), torch.floor(cy)
        gi0 = fcx.long().clamp(0, gw - 1)
        gj0 = fcy.long().clamp(0, gh - 1)
        fx, fy = cx - fcx, cy - fcy
        gi_n = (gi0 + torch.where(fx < 0.5, -1, 1)).clamp(0, gw - 1)
        gj_n = (gj0 + torch.where(fy < 0.5, -1, 1)).clamp(0, gh - 1)
        ok_x = torch.where(fx < 0.5, cx > 1.0, cx < gw - 1.0)
        ok_y = torch.where(fy < 0.5, cy > 1.0, cy < gh - 1.0)

        def expand(center, x_neigh, y_neigh):
            # [B, T] x3 -> [B, 3T], variant-major along the target axis
            return torch.cat([center, x_neigh, y_neigh], 1)

        def rep(a):
            return torch.cat([a, a, a], 1)

        gi, gj = expand(gi0, gi_n, gi0), expand(gj0, gj0, gj_n)
        cell_ok = expand(torch.ones_like(ok_x), ok_x, ok_y)
        cx_e, cy_e, w_e, h_e = rep(cx), rep(cy), rep(w), rep(h)

        r_w = w_e[..., None] / anc_arr[None, None, :, 0]
        r_h = h_e[..., None] / anc_arr[None, None, :, 1]
        ratio = torch.maximum(
            torch.maximum(r_w, 1.0 / torch.clamp(r_w, min=1e-9)),
            torch.maximum(r_h, 1.0 / torch.clamp(r_h, min=1e-9)))
        match = ((ratio < anchor_t) & rep(target_valid)[..., None]
                 & cell_ok[..., None])                       # [B, 3T, na]
        tt = gi.shape[1]

        # the slot each (image, row, anchor) writes, and its last writer
        n_slots = b * na * gh * gw
        bidx = torch.arange(b, device=dev)[:, None, None]
        aidx = torch.arange(na, device=dev)[None, None, :]
        slot = ((bidx * na + aidx) * gh + gj[..., None]) * gw + gi[..., None]
        slot = torch.where(match, slot, n_slots).reshape(-1)
        order = torch.arange(b * tt * na, device=dev)
        win = torch.full((n_slots + 1,), -1, dtype=torch.long, device=dev)
        win = win.scatter_reduce(0, slot, order, "amax")[:n_slots]
        has = win >= 0
        pick = win.clamp(min=0) // na                         # [b * tt] row

        boxv = torch.stack([cx_e - gi, cy_e - gj, w_e, h_e], -1)
        lmk = torch.cat([t[..., 4:14]] * 3, 1)                # [B, 3T, 10]
        lmk_rel = lmk - torch.stack([gi, gj] * 5, -1).float()
        lmk_vis = (lmk > 0).float()

        def place(rows: torch.Tensor, width: int) -> torch.Tensor:
            v = rows.reshape(b * tt, width)[pick]
            return torch.where(has[:, None], v, 0.0).reshape(
                b, na, gh, gw, width)

        out.append({
            "tobj": has.float().reshape(b, na, gh, gw),
            "tbox": place(boxv, 4), "tlmk": place(lmk_rel, 10),
            "lmk_mask": place(lmk_vis, 10), "anchors": anc_arr,
        })
    return out


def weighted_bce_logits(logits: torch.Tensor, labels: torch.Tensor,
                        pos_weight: float = 1.0) -> torch.Tensor:
    """BCE-with-logits with a positive-class weight: -[pw*z*log s(x) +
    (1-z)*log(1-s(x))]."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def detection_loss(maps: Sequence[torch.Tensor],
                   targets_per_level: Sequence[Dict[str, torch.Tensor]],
                   cfg: DetTrainConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over raw detect maps [B, na, gh, gw, no] (loss.py
    compute_loss): CIoU box loss, BCE objectness with the per-level
    balance and ``obj_pw`` on iou-ratio targets ``(1-gr) + gr*iou``, Wing
    landmarks (the face head), and class BCE when nc > 1 or for the
    official head (whose decode multiplies objectness by the class
    score)."""
    zero = maps[0].new_zeros(())
    lbox, lobj, llmk, lcls = zero, zero, zero, zero
    balance = list(cfg.level_balance)
    if len(balance) < len(maps):   # P3-P6: [4.0, 1.0, 0.4, 0.1]
        balance += [0.1] * (len(maps) - len(balance))
    for m, t, bal in zip(maps, targets_per_level, balance):
        m = m.float()
        pos = t["tobj"]
        anc = t["anchors"][None, :, None, None, :]
        pxy = torch.sigmoid(m[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(m[..., 2:4]) * 2.0) ** 2 * anc
        iou = ciou(torch.cat([pxy, pwh], -1), t["tbox"])
        n_pos = torch.clamp(pos.sum(), min=1.0)
        lbox = lbox + ((1.0 - iou) * pos).sum() / n_pos
        tconf = pos * ((1.0 - cfg.gr)
                       + cfg.gr * torch.clamp(iou.detach(), min=0.0))
        lobj = lobj + weighted_bce_logits(m[..., 4], tconf,
                                          cfg.obj_pw).mean() * bal
        if cfg.with_landmarks:
            planc = m[..., 5:15] * anc.repeat(1, 1, 1, 1, 5)
            llmk = llmk + wing_loss(planc, t["tlmk"], t["lmk_mask"])
        if cfg.nc > 1 or not cfg.with_landmarks:
            pcls = m[..., 15:] if cfg.with_landmarks else m[..., 5:]
            onehot = torch.zeros_like(pcls)
            onehot[..., 0] = 1.0
            lcls = lcls + (weighted_bce_logits(pcls, onehot, cfg.cls_pw)
                           * pos[..., None]).sum() / torch.clamp(
                               pos.sum() * cfg.nc, min=1.0)
    total = (cfg.box_gain * lbox + cfg.obj_gain * lobj
             + cfg.lmk_gain * llmk + cfg.cls_gain * lcls)
    return total, {"box": lbox, "obj": lobj, "lmk": llmk, "cls": lcls}


def lr_schedule(cfg) -> Callable[[int], float]:
    """The learning rate of each update, a function of the 0-based update
    count: with ``total_steps`` > 0 optax's ``warmup_cosine_decay_schedule``
    (linear from 0 to ``lr`` over ``warmup_steps``, or from ``lr`` with no
    warmup, then a cosine to ``lr * lrf`` at ``total_steps``), computed in
    f32 as optax computes it; else the constant ``lr``."""
    lr = np.float32(cfg.lr)
    if cfg.total_steps <= 0:
        return lambda count: float(lr)
    f32 = np.float32
    warm = max(cfg.warmup_steps, 0)
    init = 0.0 if cfg.warmup_steps > 0 else cfg.lr
    decay = max(cfg.total_steps, cfg.warmup_steps + 1) - warm
    end = cfg.lr * cfg.lrf
    alpha = 0.0 if cfg.lr == 0 else end / cfg.lr

    def at(count: int) -> float:
        if count < warm:
            frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
            return float(f32(init - cfg.lr) * frac + f32(cfg.lr))
        c = f32(min(count - warm, decay))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(cfg.lr) * (f32(1 - alpha) * cos + f32(alpha)))

    return at


def ema_decay_at(n: torch.Tensor, decay: float, tau: float) -> torch.Tensor:
    """The ramped decay ``decay * (1 - exp(-n / tau))`` of the update
    count ``n`` (a tensor; f32 on its device)."""
    return decay * (1.0 - torch.exp(-(n.float() / tau)))


@torch.no_grad()
def ema_update_ramped(ema: Sequence[torch.Tensor],
                      live: Sequence[torch.Tensor], n: torch.Tensor,
                      decay: float, tau: float) -> None:
    """ModelEMA's update in place (torch_utils.py:262-283): ``e = e * d +
    p * (1 - d)`` with the ramped ``d`` of ``n``, as multi-tensor ops (a
    few launches for the whole net); the device loop's
    BatchNorm-statistics average shares it with the parameters'."""
    d = ema_decay_at(n, decay, tau)
    ema, live = list(ema), list(live)
    if not ema:
        return
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, torch._foreach_mul(live, 1.0 - d))


def ema_update(ema_params: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], n: torch.Tensor, cfg) -> None:
    """``ema_update_ramped`` with the config's decay and tau."""
    ema_update_ramped(ema_params, params, n, cfg.ema_decay, cfg.ema_tau)


def mined_conf_loss(ce: torch.Tensor, pos: torch.Tensor,
                    neg_ratio: float) -> torch.Tensor:
    """SSD-style hard-negative-mined confidence loss, shared by the SSD and
    BlazeFace MultiBox losses: negatives ranked by their CE per image (a
    stable double-argsort rank), the top ``neg_ratio * n_pos`` kept, and
    the positive + mined sum normalized by the positive count. ``ce`` [B,
    N] per-anchor loss, ``pos`` [B, N] bool."""
    posf = pos.float()
    n_pos = posf.sum(1)
    n = ce.shape[1]
    neg_ce = torch.where(pos, -torch.inf, ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    n_neg = torch.clamp(neg_ratio * n_pos, 1.0, n - 1.0)
    neg = (rank < n_neg[:, None]) & ~pos
    return (ce * (posf + neg.float())).sum() / torch.clamp(n_pos.sum(),
                                                           min=1.0)


def decay_groups(net: nn.Module, weight_decay: float) -> List[Dict]:
    """Two parameter groups, as optax's ``decay_mask`` splits a flax tree:
    the weights of convolutions and linear layers (flax ``kernel`` leaves)
    decay by ``weight_decay``; BatchNorm scales and shifts, every bias and
    PReLU's slopes (flax's ``alpha``) do not. Parameters without a gradient
    (a BatchNorm without a scale) are in neither."""
    decay_ids = {id(m.weight) for m in net.modules()
                 if isinstance(m, (nn.Conv2d, nn.Linear))}
    params = [p for p in net.parameters() if p.requires_grad]
    decay = [p for p in params if id(p) in decay_ids]
    rest = [p for p in params if id(p) not in decay_ids]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": rest, "weight_decay": 0.0}]


@torch.no_grad()
def flax_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialization, drawn from ``generator`` (CPU): each
    conv and linear weight from lecun_normal (a normal truncated at two
    standard deviations, variance 1 / fan_in), biases 0, BatchNorm scale 1,
    shift 0, running mean 0 and variance 1."""
    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return net


def bn_statistics(net: nn.Module) -> List[torch.Tensor]:
    """The running means and variances of ``net``'s BatchNorms, in module
    order: what the device loop averages beside the parameters."""
    out = []
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            out += [m.running_mean, m.running_var]
    return out


def new_state(net: nn.Module, cfg, opt: torch.optim.Optimizer,
              device: torch.device, **extra) -> Dict[str, Any]:
    """A train state around ``net`` (already on ``device``, in train mode)
    and its optimizer: the EMA copy, the device counter, the host count."""
    ema = copy.deepcopy(net).eval().requires_grad_(False)
    return {"net": net, "cfg": cfg, "opt": opt, "ema": ema,
            "n_updates": torch.zeros((), dtype=torch.int32, device=device),
            "updates": 0, "device": device, **extra}


def create_det_train_state(cfg: DetTrainConfig,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> Dict[str, Any]:
    """The yolov5-face train state: the net (``cfg.arch``, ``cfg.nc``, the
    face or the official head) with flax's initialization drawn from
    ``generator`` (seed 0 by default), channels-last on ``device`` (the
    card unless the caller passes the CPU), and SGD with the masked decay."""
    device = resolve_device(device)
    net = YoloV5FaceNet(cfg.arch, cfg.nc, with_landmarks=cfg.with_landmarks)
    flax_init_(net, generator or torch.Generator().manual_seed(0))
    net = net.to(device=device, memory_format=torch.channels_last).train()
    opt = torch.optim.SGD(decay_groups(net, cfg.weight_decay), lr=cfg.lr,
                          momentum=cfg.momentum, dampening=0.0)
    return new_state(net, cfg, opt, device)


def load_train_weights(state: Dict[str, Any],
                       state_dict: Dict[str, torch.Tensor]) -> None:
    """Pour a state dict (a ``.pt`` of the same net) into BOTH the live net
    and the EMA copy; the optimizer restarts cold, as the JAX package's
    ``resume_from`` does."""
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith((".anchors", ".anchor_grid"))}
    state["net"].load_state_dict(sd)
    state["ema"].load_state_dict(sd)


def optimizer_step(state: Dict[str, Any], loss: torch.Tensor,
                   clip_norm: Optional[float] = None) -> None:
    """Backward ``loss``, then one optimizer update at the schedule's
    learning rate for the current update count; with ``clip_norm`` the
    gradients are first clipped to that global norm as optax's
    ``clip_by_global_norm`` does (``g / norm * max`` where the norm
    exceeds it). No host sync. Inside a shard of ``parallel.training.
    data_parallel_step`` the backward is the mesh's one backward and each
    gradient the sum of its copies' (``spmd_backward``, ``reduce_grads``)
    before the clip and the update."""
    from ..parallel import collectives as C

    opt = state["opt"]
    opt.zero_grad(set_to_none=True)
    if C.in_spmd():
        from ..parallel.training import reduce_grads, spmd_backward

        spmd_backward(loss)
        reduce_grads([p for g in opt.param_groups for p in g["params"]],
                     C.current().mesh.axis_names)
    else:
        loss.backward()
    if clip_norm is not None:
        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * clip_norm))
    lr = state["lr"](state["updates"])
    for g in opt.param_groups:
        g["lr"] = lr
    opt.step()
    state["updates"] += 1


def train_precision(device: torch.device):
    """The context a training step runs in, forward, backward and update:
    full f32 convolutions (TF32 off on the card), the engine's inference
    precision, with cuDNN's deterministic algorithms, so that a seed gives
    the same run every time on the card (its default backward algorithms
    vary from run to run: the golden embedder's curve parted at its first
    eval); a no-op on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=False, deterministic=True,
                   allow_tf32=False)


def images_to_float(images: torch.Tensor, scale: float = 255.0,
                    shift: float = 0.0) -> torch.Tensor:
    """A uint8 batch normalized on the device (``x / scale - shift``); a
    float batch passes as it is."""
    if images.dtype == torch.uint8:
        x = images.float() / scale
        return x - shift if shift else x
    return images


def make_det_train_step(state: Dict[str, Any]):
    """``step(images, targets, target_valid) -> (loss, metrics)``: one SGD
    update of ``state["net"]`` in place. ``images`` [B, H, W, 3] RGB, f32
    in [0, 1] or uint8 (divided by 255 on the device); ``targets`` [B, T,
    14] pixel rows; the loss and metrics stay on the device."""
    cfg: DetTrainConfig = state["cfg"]
    net = state["net"]
    spec = ARCHS[cfg.arch]
    w, h = cfg.input_size
    grid_hw = [(h // s, w // s) for s in spec["strides"]]
    state.setdefault("lr", lr_schedule(cfg))

    def step(images, targets, target_valid):
        with train_precision(state["device"]):
            maps = net(images_to_float(images))
            tpl = build_targets(targets, target_valid,
                                anchors_for(state["cfg"]), spec["strides"],
                                grid_hw, state["cfg"].anchor_t)
            loss, metrics = detection_loss(maps, tpl, state["cfg"])
            optimizer_step(state, loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return step


def with_ema(state: Dict[str, Any], base: Callable) -> Callable:
    """Wrap a family step so that it runs in ``train_precision`` and each
    update also moves the update counter and the EMA copy's parameters
    (``ema_update`` with the config's decay and tau)."""
    live = list(state["net"].parameters())
    shadow = list(state["ema"].parameters())

    def step(images, targets, target_valid):
        with train_precision(state["device"]):
            loss, metrics = base(images, targets, target_valid)
        state["n_updates"] += 1
        ema_update(shadow, live, state["n_updates"], state["cfg"])
        return loss, metrics

    return step


def make_det_train_step_ema(state: Dict[str, Any]):
    """``make_det_train_step`` that also carries the EMA: the shared family
    step of the device loop."""
    return with_ema(state, make_det_train_step(state))


def sharded_det_train_step(state: Dict[str, Any], mesh):
    """Data-parallel training over a device mesh (``parallel.mesh``):
    returns ``(step, replicas)``, ``step(images, targets, target_valid) ->
    (loss, metrics)`` over the whole batch (B divides the "data" axis),
    weights and optimizer state replicated, each coordinate's piece of the
    batch through its replica, the BatchNorms on the whole batch's
    statistics and the gradients summed (``parallel.training.
    data_parallel_step``): the step of ``make_det_train_step`` on the whole
    batch. ``state`` trains in place as the first replica."""
    from ..parallel.training import data_parallel_step

    return data_parallel_step(state, make_det_train_step, mesh)
