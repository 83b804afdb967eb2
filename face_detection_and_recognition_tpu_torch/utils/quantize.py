"""Post-training int8 quantization of the yolov5-face detectors.

The counterpart of ``utils/quantize.py`` in the JAX package. An f32 net
becomes the int8 inference net of ``YoloV5FaceNet(quantized=True |
"static")``:

* BatchNorm is folded into the conv: ``w' = w * gamma / sqrt(var + eps)``,
  ``b' = beta - mean * gamma / sqrt(var + eps)`` (eps 1e-3, ConvBN's);
* the folded weights quantize per output channel, symmetric:
  ``wscale = max(amax, 1e-12) / 127``, ``kernel_q = clip(round(w' /
  wscale), -127, 127)`` in int8, rounding half to even;
* activations quantize per tensor, dynamically in the layer (the absmax of
  the whole input batch), or from a calibrated ``ascale``
  (``calibrate_activation_scales`` + ``pour_activation_scales``) in the
  static mode.

Two inputs are taken: the JAX package's variables tree of numpy arrays
(``quantize_variables``, the same walk as the JAX one) and the port's own
f32 state dict (``quantize_state_dict``), so a ``.pt`` checkpoint quantizes
without JAX. Both fold and round in numpy on the same f32 values, so
``kernel_q``, ``wscale`` and ``bias`` equal the JAX package's bit for bit.

The port's quantized state dict holds ``{path}.kernel_q`` (int8, OHWI),
``{path}.wscale``, ``{path}.bias`` and, in the static mode,
``{path}.ascale`` for each quantized ConvBN at module path ``path``. A
ShuffleV2 branch's (conv, bn) pairs, ``branchN.{i}`` + ``branchN.{i + 1}``
in the f32 net, become ``branchN.{rank}``: the pair's rank in its branch.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch
from torch import nn

BN_EPS = 1e-3  # ConvBN's BatchNorm epsilon


def _fold_convbn(conv_params: Mapping, bn_params: Mapping,
                 bn_stats: Mapping):
    """Fold BN affine + stats into HWIO conv weights; returns (w_folded,
    bias)."""
    w = np.asarray(conv_params["kernel"], np.float32)  # [kh,kw,in/g,out]
    gamma = np.asarray(bn_params["scale"], np.float32)
    beta = np.asarray(bn_params["bias"], np.float32)
    mean = np.asarray(bn_stats["mean"], np.float32)
    var = np.asarray(bn_stats["var"], np.float32)
    factor = gamma / np.sqrt(var + BN_EPS)             # [out]
    w_f = w * factor                                    # broadcast over out
    b_f = beta - mean * factor
    if "bias" in conv_params:
        b_f = b_f + np.asarray(conv_params["bias"], np.float32) * factor
    return w_f, b_f


def _quantize_weights(w_f: np.ndarray):
    """Per-output-channel symmetric int8 of HWIO weights: (kernel_q,
    wscale)."""
    amax = np.abs(w_f).reshape(-1, w_f.shape[-1]).max(axis=0)
    wscale = np.maximum(amax, 1e-12) / 127.0
    kernel_q = np.clip(np.round(w_f / wscale), -127, 127).astype(np.int8)
    return kernel_q, wscale.astype(np.float32)


def quantize_variables(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX f32 variables tree ({'params', 'batch_stats'} of numpy arrays)
    -> the JAX quantized-params tree: each ConvBN subtree ({'Conv_0',
    'BatchNorm_0'}) becomes {'kernel_q' (HWIO), 'wscale', 'bias'};
    everything else passes through. ``utils.weights.yolov5_face_state_dict``
    maps the result onto the port's quantized net."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def walk(p: Any, s: Any) -> Any:
        if isinstance(p, dict):
            if "Conv_0" in p and "BatchNorm_0" in p and set(p) <= {
                "Conv_0", "BatchNorm_0"
            }:
                w_f, b_f = _fold_convbn(
                    p["Conv_0"], p["BatchNorm_0"],
                    (s or {}).get("BatchNorm_0", {"mean": 0.0, "var": 1.0}),
                )
                kernel_q, wscale = _quantize_weights(w_f)
                return {"kernel_q": kernel_q, "wscale": wscale, "bias": b_f}
            return {
                k: walk(v, (s or {}).get(k) if isinstance(s, dict) else None)
                for k, v in p.items()
            }
        return p

    return {"params": walk(params, stats)}


def conv_bn_pairs(keys: Iterable[str]) -> Dict[str, tuple]:
    """The quantizable (conv, bn) pairs of an f32 yolov5 state dict's keys:
    {conv prefix: (bn prefix, quantized module path)}. A ConvBN's
    ``P.conv`` + ``P.bn`` quantize at ``P``; a ShuffleV2 branch's
    ``S.i`` + ``S.{i + 1}`` at ``S.{rank}``."""
    keys = set(keys)
    pairs = {}
    seq: Dict[str, list] = {}
    for k in keys:
        if not k.endswith(".running_var"):
            continue
        bn = k[:-len(".running_var")]
        if bn.endswith(".bn") and f"{bn[:-3]}.conv.weight" in keys:
            pairs[f"{bn[:-3]}.conv"] = (bn, bn[:-3])
            continue
        m = re.fullmatch(r"(.*)\.(\d+)", bn)
        if m and f"{m.group(1)}.{int(m.group(2)) - 1}.weight" in keys:
            seq.setdefault(m.group(1), []).append(int(m.group(2)) - 1)
    for s, idx in seq.items():
        for rank, i in enumerate(sorted(idx)):
            pairs[f"{s}.{i}"] = (f"{s}.{i + 1}", f"{s}.{rank}")
    return pairs


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The port's f32 yolov5 state dict -> the state dict of the same net
    built quantized (the dynamic mode; ``pour_activation_scales`` adds the
    static mode's ``ascale``). The fold and the rounding are
    ``quantize_variables``' on the same f32 values, in numpy."""
    sd = {k: v for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    out = dict(sd)
    for conv, (bn, path) in conv_bn_pairs(sd).items():
        w = sd[f"{conv}.weight"].detach().cpu().numpy()
        conv_p = {"kernel": np.transpose(w, (2, 3, 1, 0))}   # OIHW -> HWIO
        if f"{conv}.bias" in sd:
            conv_p["bias"] = sd[f"{conv}.bias"].detach().cpu().numpy()
        bn_np = {n: sd[f"{bn}.{t}"].detach().cpu().numpy() for n, t in (
            ("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
            ("var", "running_var"))}
        w_f, b_f = _fold_convbn(conv_p, bn_np, bn_np)
        kernel_q, wscale = _quantize_weights(w_f)
        for k in [k for k in out if k.startswith((f"{conv}.", f"{bn}."))]:
            del out[k]
        out[f"{path}.kernel_q"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(kernel_q, (3, 0, 1, 2))))
        out[f"{path}.wscale"] = torch.from_numpy(wscale)
        out[f"{path}.bias"] = torch.from_numpy(b_f.astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# static activation calibration
# ---------------------------------------------------------------------------


def calibrate_activation_scales(net: nn.Module, batches: Iterable[torch.Tensor]
                                ) -> Dict[str, float]:
    """Each quantizable ConvBN's input absmax over the calibration
    ``batches`` of the f32 ``net`` -> static activation scales
    ``max(absmax, 1e-6) / 127``, keyed by the quantized net's module path
    (``conv_bn_pairs``). Forward pre-hooks on the pairs' convs read the
    inputs; the net runs in eval mode."""
    names = {m: n for n, m in net.named_modules()}
    paths = {conv: path for conv, (_, path)
             in conv_bn_pairs(net.state_dict()).items()}
    maxima: Dict[str, float] = {}

    def hook(mod, args):
        key = paths[names[mod]]
        val = float(args[0].float().abs().amax())
        maxima[key] = max(maxima.get(key, 0.0), val)

    handles = [m.register_forward_pre_hook(hook)
               for n, m in net.named_modules() if n in paths]
    was_training = net.training
    try:
        net.eval()
        with torch.no_grad():
            for b in batches:
                net(b.to(next(net.parameters()).device))
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    return {k: max(v, 1e-6) / 127.0 for k, v in maxima.items()}


def pour_activation_scales(qstate_dict: Mapping[str, torch.Tensor],
                           scales: Mapping[str, float]
                           ) -> Dict[str, torch.Tensor]:
    """Add each quantized ConvBN's ``ascale`` (f32, the calibrated scale;
    1.0 for a slot with no calibration record) to a quantized state dict,
    for a net built with ``quantized="static"``."""
    out = dict(qstate_dict)
    for k in qstate_dict:
        if k.endswith(".kernel_q"):
            path = k[:-len(".kernel_q")]
            out[f"{path}.ascale"] = torch.tensor(scales.get(path, 1.0),
                                                 dtype=torch.float32)
    return out


def quantize_net(net: nn.Module, qnet: nn.Module,
                 batches: Iterable[torch.Tensor] = None) -> nn.Module:
    """Load ``qnet`` (the same architecture built quantized) with ``net``'s
    folded, quantized weights; a static ``qnet`` takes the scales
    calibrated on ``batches``. Returns ``qnet``."""
    sd = quantize_state_dict(net.state_dict())
    if any(k.endswith(".ascale") for k in qnet.state_dict()):
        if batches is None:
            raise ValueError("a static int8 net needs calibration batches")
        sd = pour_activation_scales(
            sd, calibrate_activation_scales(net, batches))
    qnet.load_state_dict(sd)
    return qnet


def quantized_mode(state_dict: Mapping[str, torch.Tensor]):
    """The ``quantized`` build switch a state dict was made for: False (f32),
    True (int8, dynamic scales) or "static" (int8 with ``ascale``)."""
    if not any(k.endswith(".kernel_q") for k in state_dict):
        return False
    return "static" if any(k.endswith(".ascale") for k in state_dict) \
        else True
