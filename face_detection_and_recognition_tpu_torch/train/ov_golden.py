"""Train the reference's OpenVINO topologies through the IR interpreter
itself.

The counterpart of ``train/ov_golden.py`` in the JAX package, the move of
``train/caffe_golden.py`` repeated for OpenVINO: ``models/ov_graph.
OVGraphNet`` runs the face-detection-0204 / face-detection-retail-0004
graph tables (``models/ov_topologies.py``) as a module whose constants are
parameters, and the topology trains directly with the SSD family's
MultiBox loss, reading the heads through the interpreter's taps. The
trained constants export as a real ``model.xml`` + ``model.bin``
(``models.ov_topologies.export_trained_ir``), which
``FaceEngine.load_weights`` runs as the file's own graph.

These graphs carry no normalization layers (real IRs fold BN into the
convolutions), so the optimizer is the graph trainers' chain: each
constant's gradient clipped to block RMS 1 (conv1's gradient rides the raw
BGR scale), L2 decay on the multiplicative kernels (ndim >= 2 and not a
``/bias``), then Adam at the schedule's rate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.platform import resolve_device
from .caffe_golden import graph_adam, prior_table
from .detection import lr_schedule, new_state, optimizer_step, with_ema
from .ssd import encode_ssd_targets, ssd_multibox_loss


@dataclasses.dataclass(frozen=True)
class OVGoldenConfig:
    topology: str = "ov-0204"
    input_size: Tuple[int, int] = (448, 448)
    max_targets: int = 8
    iou_pos: float = 0.5
    neg_ratio: int = 3
    loc_gain: float = 1.0
    lr: float = 0.002
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lrf: float = 0.1
    warmup_steps: int = 0
    total_steps: int = 0
    ema_decay: float = 0.999
    ema_tau: float = 500.0

    @property
    def arch(self):
        return self.topology


def create_ov_train_state(cfg: OVGoldenConfig,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> Dict[str, Any]:
    """The topology with its He-init constants from a seed drawn from
    ``generator``, on ``device`` (the card unless the CPU is asked), every
    constant trainable, and the graph optimizer."""
    from ..models.ov_graph import OVGraphNet
    from ..models.ov_topologies import build_ov_topology

    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    net = OVGraphNet(build_ov_topology(cfg.topology, seed=seed))
    ih, iw = net.input_dims[2], net.input_dims[3]
    if (iw, ih) != tuple(cfg.input_size):
        raise ValueError(f"{cfg.topology} runs its fixed {iw}x{ih} graph: "
                         f"pass --size {iw}")
    net = net.to(device).train()
    net.train_consts()
    decay, rest = [], []
    for name, key in net.weight_names.items():
        c = net.consts[key]
        (decay if c.dim() >= 2 and not name.endswith("/bias")
         else rest).append(c)
    priors, variances = prior_table(net)
    return new_state(net, cfg, graph_adam(decay, rest, cfg), device,
                     priors=priors.to(device), variances=variances)


def make_ov_train_step_ema(state: Dict[str, Any]):
    """The family step: images [B, H, W, 3] uint8 BGR, raw values (the
    OVModel convention: no mean subtracted), targets [B, T, 14] pixel rows
    (landmark columns ignored); one update and the EMA. The IR's reshape
    literals are batch-1, so the taps fold the batch into their flat axis:
    it is unfolded here."""
    cfg: OVGoldenConfig = state["cfg"]
    net, priors = state["net"], state["priors"]
    dev = state["device"]
    w, h = cfg.input_size
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    n = priors.shape[0]
    state.setdefault("lr", lr_schedule(cfg))

    def step(images, targets, valid):
        env = net(images.float(), taps=("mbox_loc_flat",
                                         "mbox_conf_reshape"))
        b = images.shape[0]
        locs = env["mbox_loc_flat"].float().reshape(b, n, 4)
        conf = env["mbox_conf_reshape"].float().reshape(b, n, 2)
        loc_t, pos = encode_ssd_targets(priors, targets[..., :4] / scale,
                                        valid, state["variances"],
                                        cfg.iou_pos)
        loss, metrics = ssd_multibox_loss(locs, conf, loc_t, pos,
                                          cfg.neg_ratio, cfg.loc_gain)
        optimizer_step(state, loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return with_ema(state, step)
