"""Weight bridge: a flax variables tree of numpy arrays -> a PyTorch
state_dict.

The inverse of ``convert_yolov5_face`` in the JAX package's
``utils/weights.py``: flax names layers ``layer{i}`` with ``ConvBN_k`` /
``Bottleneck_k`` children; the port's modules carry the reference torch names
(``model.{i}.cv1.conv``...). Conv kernels go HWIO -> OIHW; flax BatchNorm
``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` become ``weight``,
``bias``, ``running_mean`` and ``running_var``. Reading a checkpoint is the
caller's business: this module takes arrays, nothing else.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..models.yolov5_face import ARCHS, graph_depth


def f2t_conv(w: np.ndarray) -> torch.Tensor:
    """flax conv kernel [kh, kw, in/g, out] -> torch weight [out, in/g, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def yolov5_face_state_dict(variables: Mapping, arch: str
                           ) -> Dict[str, torch.Tensor]:
    """Map a ``YoloV5FaceNet`` flax tree {"params", "batch_stats"} of numpy
    arrays onto the port's ``YoloV5FaceNet(arch)`` state_dict."""
    spec = ARCHS[arch]
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def convbn(tp: str, p: Mapping, s: Mapping) -> None:
        sd[f"{tp}.conv.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        sd[f"{tp}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
        sd[f"{tp}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
        sd[f"{tp}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
        sd[f"{tp}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
        sd[f"{tp}.bn.num_batches_tracked"] = torch.tensor(0)

    def children(tp: str, p: Mapping, s: Mapping, names) -> None:
        for k, sub in enumerate(names):
            convbn(f"{tp}.{sub}", p[f"ConvBN_{k}"], s[f"ConvBN_{k}"])

    for i, (frm, n, mod, _) in enumerate(spec["graph"]):
        t, name = f"model.{i}", f"layer{i}"
        if mod == "Conv":
            convbn(t, params[name], stats[name])
        elif mod == "C3":
            p, s = params[name], stats[name]
            children(t, p, s, ("cv1", "cv2", "cv3"))
            for j in range(graph_depth(n, spec["gd"])):
                children(f"{t}.m.{j}", p[f"Bottleneck_{j}"],
                         s[f"Bottleneck_{j}"], ("cv1", "cv2"))
        elif mod == "SPP":
            children(t, params[name], stats[name], ("cv1", "cv2"))
        elif mod == "StemBlock":
            children(t, params[name], stats[name],
                     ("stem_1", "stem_2a", "stem_2b", "stem_3"))
        elif mod == "Detect":
            for li in range(len(frm)):
                det = params[f"detect_m{li}"]
                sd[f"{t}.m.{li}.weight"] = f2t_conv(det["kernel"])
                sd[f"{t}.m.{li}.bias"] = _t(det["bias"])
    return sd
