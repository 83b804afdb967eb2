"""Train the public res10_300x300 deploy graph through the Caffe graph
interpreter itself.

The counterpart of ``train/caffe_golden.py`` in the JAX package.
``models/caffe_ssd.CaffeGraphNet`` runs the deploy table
(``models/res10.res10_deploy_defs``) as a module whose blobs are
parameters, so the real topology trains directly with the SSD family's
MultiBox loss (``train/ssd.py``), reading the heads' logits through the
interpreter's taps. Caffe's ``BatchNorm`` blobs are inference statistics:
they stay frozen at their identity init (no gradient, no decay), and the
following ``Scale`` layers carry the learnable affine, as Caffe fine-tuning
freezes BN. The trained blobs round-trip through a real binary
``.caffemodel`` with the layer definitions (``export_trained_caffemodel``),
which ``FaceEngine.load_weights`` reads back.

The init is LSUV over every convolution (each kernel and bias rescaled,
input to output, so that its output's std on a batch of random pixels is
1: with the frozen identity BN nothing else tames the +-120 input scale)
and a background prior bias on the confidence heads (every prior starts at
p(face) ~ 0.02). The optimizer is the JAX package's chain, each blob's
gradient clipped to block RMS 1, the kernels' L2 decay, then Adam at the
schedule's rate (``train.optim.OptaxAdam(decoupled=False)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import param_key
from ..ops.platform import resolve_device
from .detection import lr_schedule, new_state, optimizer_step, with_ema
from .optim import OptaxAdam
from .ssd import OPENCV_SSD_MEAN, encode_ssd_targets, ssd_multibox_loss


@dataclasses.dataclass(frozen=True)
class CaffeGoldenConfig:
    input_size: Tuple[int, int] = (300, 300)
    max_targets: int = 8
    # 0.35: the deploy graph's smallest priors are 30 px, and the golden
    # faces are 18-19 px at 300 px (IoU 0.36 with a 30 px prior)
    iou_pos: float = 0.35
    # 7:1 hard negatives against the lower-quality 0.35 positives
    neg_ratio: int = 7
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
        return "res10-ssd"


def prior_table(net) -> Tuple[torch.Tensor, Tuple[float, ...]]:
    """A graph's priors as [N, 4] cxcywh and their variance 4-vector (the
    same for every prior, as ``encode_ssd_targets`` takes one)."""
    corners = np.asarray(net.priors, np.float32)
    priors = np.stack([
        (corners[:, 0] + corners[:, 2]) / 2,
        (corners[:, 1] + corners[:, 3]) / 2,
        corners[:, 2] - corners[:, 0],
        corners[:, 3] - corners[:, 1]], axis=1)
    variances = np.asarray(net.prior_variances, np.float32)
    if not np.allclose(variances, variances[0]):
        raise ValueError("non-uniform prior variances")
    return torch.from_numpy(priors), tuple(float(v) for v in variances[0])


@torch.no_grad()
def lsuv_rescale(net, input_size: Tuple[int, int], seed: int = 0,
                 target_std: float = 1.0) -> None:
    """LSUV over every convolution of the graph, in place: for each, input
    to output, its output's std (population) on two random-pixel images
    (mean-subtracted) measured against the already-rescaled layers before
    it, and its blobs scaled by ``clip(target_std / std, 1e-4, 1e4)``."""
    w, h = input_size
    dev = next(net.parameters()).device
    x = torch.from_numpy(
        np.random.RandomState(seed).randint(0, 255, (2, h, w, 3))
        .astype(np.float32)
        - np.asarray(OPENCV_SSD_MEAN, np.float32)).to(dev)
    for s in net.steps:
        if s.op != "conv":
            continue
        std = float(torch.std(net(x, taps=(s.output,))[s.output],
                              unbiased=False))
        if np.isfinite(std) and std > 1e-12:
            g = float(np.clip(target_std / std, 1e-4, 1e4))
            for b in net.blobs[param_key(s.name)]:
                b.mul_(g)


@torch.no_grad()
def apply_background_prior_bias(net, logit: float = 2.0) -> None:
    """A RetinaNet-style prior on the confidence heads, in place: the
    background channels (even) of each ``mbox_conf`` bias + ``logit``, the
    face channels (odd) - ``logit``."""
    for s in net.steps:
        if s.op == "conv" and "mbox_conf" in s.name:
            blobs = net.blobs[param_key(s.name)]
            if len(blobs) > 1 and blobs[1].dim() == 1:
                blobs[1][0::2] += logit
                blobs[1][1::2] -= logit


def graph_adam(params_decay: List[torch.Tensor], params_rest:
               List[torch.Tensor], cfg) -> OptaxAdam:
    """The graph trainers' optimizer: per-blob RMS clip 1, L2 decay on the
    multiplicative kernels, Adam."""
    return OptaxAdam([{"params": params_decay,
                       "weight_decay": cfg.weight_decay},
                      {"params": params_rest, "weight_decay": 0.0}],
                     lr=cfg.lr, decoupled=False, clip_rms=1.0)


def create_res10_train_state(cfg: CaffeGoldenConfig,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> Dict[str, Any]:
    """The res10 deploy graph with its kernels drawn from ``generator``,
    LSUV-rescaled and prior-biased, on ``device`` (the card unless the CPU
    is asked), its BN statistics frozen, and the graph optimizer."""
    from ..models.res10 import build_res10

    device = resolve_device(device)
    net, _ = build_res10(generator or torch.Generator().manual_seed(0),
                         device)
    lsuv_rescale(net, cfg.input_size)
    apply_background_prior_bias(net)
    net.train()
    trainable = net.train_blobs()
    decay = [b for b in trainable if b.dim() >= 2]
    rest = [b for b in trainable if b.dim() < 2]
    priors, variances = prior_table(net)
    return new_state(net, cfg, graph_adam(decay, rest, cfg), device,
                     priors=priors.to(device), variances=variances)


def make_res10_train_step_ema(state: Dict[str, Any]):
    """The family step: images [B, 300, 300, 3] uint8 BGR (the OpenCV-SSD
    convention, no RGB swap, the mean subtracted on the device), targets
    [B, T, 14] pixel rows (landmark columns ignored); one update and the
    EMA."""
    cfg: CaffeGoldenConfig = state["cfg"]
    net, priors = state["net"], state["priors"]
    dev = state["device"]
    w, h = cfg.input_size
    mean = torch.tensor(OPENCV_SSD_MEAN, dtype=torch.float32, device=dev)
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    n = priors.shape[0]
    state.setdefault("lr", lr_schedule(cfg))

    def step(images, targets, valid):
        env = net(images.float() - mean, taps=("mbox_loc",
                                                "mbox_conf_reshape"))
        b = images.shape[0]
        locs = env["mbox_loc"].float().reshape(b, n, 4)
        conf = env["mbox_conf_reshape"].float().reshape(b, n, 2)
        loc_t, pos = encode_ssd_targets(priors, targets[..., :4] / scale,
                                        valid, state["variances"],
                                        cfg.iou_pos)
        loss, metrics = ssd_multibox_loss(locs, conf, loc_t, pos,
                                          cfg.neg_ratio, cfg.loc_gain)
        optimizer_step(state, loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return with_ema(state, step)


def blobs_by_layer(weights: Dict[str, Any]) -> Dict[str, List[np.ndarray]]:
    """{layer name: [blobs]} from a ``CaffeGraphNet`` state dict
    (``blobs.<param_key(layer)>.<i>``)."""
    from ..models.layers import param_unkey

    out: Dict[str, Dict[int, np.ndarray]] = {}
    for k, v in weights.items():
        key, i = k[len("blobs."):].rsplit(".", 1)
        out.setdefault(param_unkey(key), {})[int(i)] = np.asarray(
            v.detach().cpu().float() if torch.is_tensor(v) else v,
            np.float32)
    return {k: [d[i] for i in sorted(d)] for k, d in out.items()}


def export_trained_caffemodel(weights: Dict[str, Any], path: str) -> None:
    """Write trained blobs (a res10 ``CaffeGraphNet`` state dict, e.g. the
    ``.pt`` the golden loop saves) into a binary
    ``.caffemodel`` holding the deploy table's layer definitions with
    them, which ``FaceEngine.load_weights`` and
    ``models.res10.build_res10_from_caffemodel`` read."""
    from ..models.res10 import res10_deploy_defs
    from ..utils.caffe_graph import write_caffemodel_graph

    blobs = blobs_by_layer(weights)
    defs = res10_deploy_defs()
    for layer in defs:
        if layer.name in blobs:
            layer.blobs = blobs[layer.name]
    with open(path, "wb") as f:
        f.write(write_caffemodel_graph(defs))
