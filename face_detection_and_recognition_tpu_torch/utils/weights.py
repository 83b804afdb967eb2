"""Weight bridge: a flax variables tree of numpy arrays -> a PyTorch
state_dict, for the yolov5-face and BlazeFace detectors, MobileFaceNet,
FaceNet (Inception-ResNet-V1), the MobileNetV2 reid embedder and the
age/gender heads (which the ``demographics`` slot reuses).

The inverse of ``convert_yolov5_face`` / ``convert_blazeface`` /
``convert_mobile_facenet`` / ``convert_caffenet_head`` in the JAX package's
``utils/weights.py``: flax
names layers ``layer{i}`` with ``ConvBN_k`` / ``Bottleneck_k`` children; the
port's modules carry the reference torch names (``model.{i}.cv1.conv``...). Conv kernels go HWIO -> OIHW; flax BatchNorm
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


def _bn(sd: Dict[str, torch.Tensor], tp: str, p: Mapping, s: Mapping) -> None:
    """flax BatchNorm ``scale``/``bias`` + ``mean``/``var`` -> torch BN."""
    sd[f"{tp}.weight"] = _t(p["scale"])
    sd[f"{tp}.bias"] = _t(p["bias"])
    sd[f"{tp}.running_mean"] = _t(s["mean"])
    sd[f"{tp}.running_var"] = _t(s["var"])
    sd[f"{tp}.num_batches_tracked"] = torch.tensor(0)


def yolov5_face_state_dict(variables: Mapping, arch: str
                           ) -> Dict[str, torch.Tensor]:
    """Map a ``YoloV5FaceNet`` flax tree {"params", "batch_stats"} of numpy
    arrays onto the port's ``YoloV5FaceNet(arch)`` state_dict."""
    spec = ARCHS[arch]
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(conv: str, bn: str, p: Mapping, s: Mapping) -> None:
        sd[f"{conv}.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        _bn(sd, bn, p["BatchNorm_0"], s["BatchNorm_0"])

    def convbn(tp: str, p: Mapping, s: Mapping) -> None:
        conv_bn(f"{tp}.conv", f"{tp}.bn", p, s)

    def children(tp: str, p: Mapping, s: Mapping, names) -> None:
        for k, sub in enumerate(names):
            convbn(f"{tp}.{sub}", p[f"ConvBN_{k}"], s[f"ConvBN_{k}"])

    for i, (frm, n, mod, args) in enumerate(spec["graph"]):
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
        elif mod == "ShuffleV2Block":
            # flax: layer{i}_{r} with ConvBN_k in call order (branch1's two
            # when strided, then branch2's three); torch: the branches'
            # Sequential indices of each (conv, bn) pair
            pairs = ([("branch1.0", "branch1.1"), ("branch1.2", "branch1.3")]
                     if args[1] > 1 else [])
            pairs += [("branch2.0", "branch2.1"), ("branch2.3", "branch2.4"),
                      ("branch2.5", "branch2.6")]
            reps = graph_depth(n, spec["gd"])
            for r in range(reps):
                tp = t if reps == 1 else f"{t}.{r}"
                p, s = params[f"layer{i}_{r}"], stats[f"layer{i}_{r}"]
                for k, (cp, bp) in enumerate(pairs):
                    conv_bn(f"{tp}.{cp}", f"{tp}.{bp}", p[f"ConvBN_{k}"],
                            s[f"ConvBN_{k}"])
        elif mod == "Detect":
            for li in range(len(frm)):
                det = params[f"detect_m{li}"]
                sd[f"{t}.m.{li}.weight"] = f2t_conv(det["kernel"])
                sd[f"{t}.m.{li}.bias"] = _t(det["bias"])
    return sd


def blazeface_state_dict(variables: Mapping, back_model: bool
                         ) -> Dict[str, torch.Tensor]:
    """Map a flax ``BlazeFaceNet`` tree {"params": ...} of numpy arrays onto
    the port's ``BlazeFaceNet(back_model)`` state_dict (the reference torch
    names): ``conv0`` -> the backbone's first conv, ``BlazeBlock_i`` ->
    ``backbone.{i + 2}`` (back) or ``backbone1.{i + 2}`` / ``backbone2.{i -
    11}`` (front), ``FinalBlazeBlock_0`` -> ``final``, the heads by name."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(tp: str, p: Mapping) -> None:
        sd[f"{tp}.weight"] = f2t_conv(p["kernel"])
        sd[f"{tp}.bias"] = _t(p["bias"])

    def block(tp: str, p: Mapping) -> None:
        conv(f"{tp}.convs.0", p["Conv_0"])
        conv(f"{tp}.convs.1", p["Conv_1"])

    if back_model:
        conv("backbone.0", params["conv0"])
        for i in range(31):
            block(f"backbone.{i + 2}", params[f"BlazeBlock_{i}"])
        block("final", params["FinalBlazeBlock_0"])
    else:
        conv("backbone1.0", params["conv0"])
        for i in range(11):
            block(f"backbone1.{i + 2}", params[f"BlazeBlock_{i}"])
        for i in range(5):
            block(f"backbone2.{i}", params[f"BlazeBlock_{11 + i}"])
    for head in ("classifier_8", "classifier_16", "regressor_8",
                 "regressor_16"):
        conv(head, params[head])
    return sd


def mobile_facenet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``MobileFaceNet`` tree {"params", "batch_stats"} of numpy
    arrays onto the port's ``MobileFaceNet`` state_dict (the reference
    torch names). The inverse of the JAX package's
    ``convert_mobile_facenet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def block(tp: str, p: Mapping, s: Mapping) -> None:
        # MFConvBlock (with PReLU) or MFLinearBlock
        sd[f"{tp}.conv.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        _bn(sd, f"{tp}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
        if "PReLU_0" in p:
            sd[f"{tp}.prelu.weight"] = _t(p["PReLU_0"]["alpha"])

    def depthwise(tp: str, p: Mapping, s: Mapping) -> None:
        for sub, name in (("conv", "MFConvBlock_0"), ("conv_dw", "MFConvBlock_1"),
                          ("project", "MFLinearBlock_0")):
            block(f"{tp}.{sub}", p[name], s[name])

    for name in ("conv1", "conv2_dw", "conv_6_sep", "conv_6_dw"):
        block(name, params[name], stats[name])
    for name in ("conv_23", "conv_34", "conv_45"):
        depthwise(name, params[name], stats[name])
    for name, nb in (("conv_3", 4), ("conv_4", 6), ("conv_5", 2)):
        for i in range(nb):
            depthwise(f"{name}.model.{i}", params[name][f"MFDepthWise_{i}"],
                      stats[name][f"MFDepthWise_{i}"])
    sd["linear.weight"] = _t(params["linear"]["kernel"]).T.contiguous()
    _bn(sd, "bn", params["bn"], stats["bn"])
    return sd


def _caffenet_head(sd: Dict[str, torch.Tensor], tp: str,
                   params: Mapping) -> None:
    for i in range(3):
        conv = params[f"Conv_{i}"]
        sd[f"{tp}.conv{i + 1}.weight"] = f2t_conv(conv["kernel"])
        sd[f"{tp}.conv{i + 1}.bias"] = _t(conv["bias"])
    # fc6 reads conv3's map: flax flattens it (H, W, C), the port (C, H, W)
    w6 = np.asarray(params["Dense_0"]["kernel"], np.float32)    # [H*W*C, out]
    c3 = params["Conv_2"]["bias"].shape[0]
    side = int(round((w6.shape[0] // c3) ** 0.5))
    if side * side * c3 != w6.shape[0]:
        raise ValueError(f"fc6 input {w6.shape[0]} is not H*W*C with "
                         f"C={c3} and H == W")
    w6 = w6.reshape(side, side, c3, -1).transpose(2, 0, 1, 3) \
        .reshape(w6.shape[0], -1)
    sd[f"{tp}.fc6.weight"] = torch.from_numpy(np.ascontiguousarray(w6.T))
    sd[f"{tp}.fc6.bias"] = _t(params["Dense_0"]["bias"])
    for i, name in ((1, "fc7"), (2, "fc8")):
        dense = params[f"Dense_{i}"]
        sd[f"{tp}.{name}.weight"] = _t(dense["kernel"]).T.contiguous()
        sd[f"{tp}.{name}.bias"] = _t(dense["bias"])


def age_gender_state_dict(age_vars: Mapping, gender_vars: Mapping
                          ) -> Dict[str, torch.Tensor]:
    """Map the two flax ``CaffeNetHead`` trees ({"params": ...} of numpy
    arrays, any float dtype) onto the port's ``AgeGenderNet`` state_dict
    (``age.*``, ``gender.*``), in float32."""
    sd: Dict[str, torch.Tensor] = {}
    _caffenet_head(sd, "age", age_vars["params"])
    _caffenet_head(sd, "gender", gender_vars["params"])
    return sd


def _bn_unscaled(sd: Dict[str, torch.Tensor], tp: str, p: Mapping,
                 s: Mapping) -> None:
    """A flax BatchNorm with ``use_scale=False`` (``bias`` only) -> torch
    BN with its weight set to ones."""
    bias = _t(p["bias"])
    sd[f"{tp}.weight"] = torch.ones_like(bias)
    sd[f"{tp}.bias"] = bias
    sd[f"{tp}.running_mean"] = _t(s["mean"])
    sd[f"{tp}.running_var"] = _t(s["var"])
    sd[f"{tp}.num_batches_tracked"] = torch.tensor(0)


def facenet_state_dict(variables: Mapping, embedding_size: int = 128
                       ) -> Dict[str, torch.Tensor]:
    """Map a flax ``InceptionResNetV1`` tree {"params", "batch_stats"} of
    numpy arrays onto the port's ``InceptionResNetV1(embedding_size)``
    state_dict. Flax names the blocks in call order (``CB_i``,
    ``Block35_i``, ``Block17_i``, ``Block8_i`` at the top, ``CB_i`` and
    ``Conv_0`` inside a block)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def cb(tp: str, p: Mapping, s: Mapping) -> None:
        sd[f"{tp}.conv.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        _bn_unscaled(sd, f"{tp}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    def block(tp: str, name: str, branches) -> None:
        p, s = params[name], stats[name]
        for k, sub in enumerate(branches):
            cb(f"{tp}.{sub}", p[f"CB_{k}"], s[f"CB_{k}"])
        sd[f"{tp}.conv2d.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        sd[f"{tp}.conv2d.bias"] = _t(p["Conv_0"]["bias"])

    top = ["conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a",
           "conv2d_4b", "mixed_6a.branch0", "mixed_6a.branch1.0",
           "mixed_6a.branch1.1", "mixed_6a.branch1.2",
           "mixed_7a.branch0.0", "mixed_7a.branch0.1", "mixed_7a.branch1.0",
           "mixed_7a.branch1.1", "mixed_7a.branch2.0", "mixed_7a.branch2.1",
           "mixed_7a.branch2.2"]
    for k, tp in enumerate(top):
        cb(tp, params[f"CB_{k}"], stats[f"CB_{k}"])
    for i in range(5):
        block(f"repeat_1.{i}", f"Block35_{i}",
              ("branch0", "branch1.0", "branch1.1", "branch2.0",
               "branch2.1", "branch2.2"))
    for i in range(10):
        block(f"repeat_2.{i}", f"Block17_{i}",
              ("branch0", "branch1.0", "branch1.1", "branch1.2"))
    for i in range(6):
        block(f"repeat_3.{i}" if i < 5 else "block8", f"Block8_{i}",
              ("branch0", "branch1.0", "branch1.1", "branch1.2"))
    w = _t(params["bottleneck"]["kernel"])
    if w.shape[1] != embedding_size:
        raise ValueError(f"the tree's bottleneck is {w.shape[1]}-d, not "
                         f"{embedding_size}-d")
    sd["last_linear.weight"] = w.T.contiguous()
    _bn_unscaled(sd, "last_bn", params["bottleneck_bn"],
                 stats["bottleneck_bn"])
    return sd


def reid_mnv2_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``MobileNetV2Embedder`` tree {"params", "batch_stats"} of
    numpy arrays onto the port's ``MobileNetV2Embedder`` state_dict: the
    backbone's ``ConvBN_0`` / ``ConvBN_1`` are its stem and head,
    ``_InvertedResidual_i`` its blocks (``ConvBN_0..2`` = expand,
    depthwise, project), ``Dense_0`` the embedding layer."""
    params = variables["params"]["_MobileNetV2Backbone_0"]
    stats = variables["batch_stats"]["_MobileNetV2Backbone_0"]
    sd: Dict[str, torch.Tensor] = {}

    def convbn(tp: str, p: Mapping, s: Mapping) -> None:
        sd[f"{tp}.conv.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        _bn(sd, f"{tp}.bn", p["BatchNorm_0"], s["BatchNorm_0"])

    convbn("backbone.stem", params["ConvBN_0"], stats["ConvBN_0"])
    convbn("backbone.head", params["ConvBN_1"], stats["ConvBN_1"])
    for i in range(10):
        name = f"_InvertedResidual_{i}"
        p, s = params[name], stats[name]
        for k, sub in enumerate(("expand", "dw", "project")):
            convbn(f"backbone.blocks.{i}.{sub}", p[f"ConvBN_{k}"],
                   s[f"ConvBN_{k}"])
    dense = variables["params"]["Dense_0"]
    sd["fc.weight"] = _t(dense["kernel"]).T.contiguous()
    sd["fc.bias"] = _t(dense["bias"])
    return sd
