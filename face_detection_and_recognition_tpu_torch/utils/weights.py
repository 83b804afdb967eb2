"""Weight bridge: a flax variables tree of numpy arrays -> a PyTorch
state_dict, for the yolov5-face, BlazeFace and SSD detectors, the MTCNN
cascade, MobileFaceNet, FaceNet (Inception-ResNet-V1), the MobileNetV2 reid
embedder and the age/gender heads (which the ``demographics`` slot reuses);
and the importers of the reference's protobuf weight files
(``utils/model_formats.py`` reads them): a caffemodel's or GraphDef's array
stream poured into a net's slots in execution order
(``structural_import``), the CaffeNet age/gender heads
(``convert_caffenet_head``), the frozen MTCNN graph
(``convert_mtcnn_graphdef``) and the res10 GraphDef poured into the deploy
graph (``convert_res10_graphdef``); and the bridges of the graph
interpreters, whose weights are the files' own blobs and constants:
``caffe_graph_state_dict`` (res10-ssd) and ``ov_graph_state_dict`` (the
OpenVINO IR nets); the int8 yolov5 trees of the JAX package's
``utils/quantize.py`` (``yolov5_face_state_dict`` maps them onto the
port's quantized net); and the keras FaceNet readers
(``keras_bundle_stream`` for a SavedModel's TensorBundle,
``read_keras_h5_stream`` for an ``.h5``, ``convert_facenet_keras``).

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

import re
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..models.layers import param_key
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


def _qconvbn(sd: Dict[str, torch.Tensor], tp: str, p: Mapping) -> None:
    """A quantized flax ConvBN {kernel_q (HWIO int8), wscale, bias[,
    ascale]} -> the port's ``QConvBN`` at ``tp`` (kernel_q OHWI)."""
    sd[f"{tp}.kernel_q"] = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(p["kernel_q"], np.int8), (3, 0, 1, 2))))
    for leaf in ("wscale", "bias", "ascale"):
        if leaf in p:
            sd[f"{tp}.{leaf}"] = _t(p[leaf])


def yolov5_face_state_dict(variables: Mapping, arch: str
                           ) -> Dict[str, torch.Tensor]:
    """Map a ``YoloV5FaceNet`` flax tree {"params", "batch_stats"} of numpy
    arrays onto the port's ``YoloV5FaceNet(arch)`` state_dict; a quantized
    tree ({"params"} with {kernel_q, wscale, bias[, ascale]} ConvBNs, the
    JAX ``quantize_variables`` / ``pour_activation_scales``) onto the
    port's ``YoloV5FaceNet(arch, quantized=...)``, whose ShuffleV2
    branches hold one ``QConvBN`` a (conv, bn) pair."""
    spec = ARCHS[arch]
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(conv: str, bn: str, p: Mapping, s: Mapping,
                qpath: str) -> None:
        if "kernel_q" in p:
            _qconvbn(sd, qpath, p)
            return
        sd[f"{conv}.weight"] = f2t_conv(p["Conv_0"]["kernel"])
        _bn(sd, bn, p["BatchNorm_0"], s["BatchNorm_0"])

    def convbn(tp: str, p: Mapping, s: Mapping) -> None:
        conv_bn(f"{tp}.conv", f"{tp}.bn", p, s, tp)

    def children(tp: str, p: Mapping, s: Mapping, names) -> None:
        for k, sub in enumerate(names):
            convbn(f"{tp}.{sub}", p[f"ConvBN_{k}"], s.get(f"ConvBN_{k}"))

    for i, (frm, n, mod, args) in enumerate(spec["graph"]):
        t, name = f"model.{i}", f"layer{i}"
        if mod == "Conv":
            convbn(t, params[name], stats.get(name))
        elif mod == "C3":
            p, s = params[name], stats.get(name, {})
            children(t, p, s, ("cv1", "cv2", "cv3"))
            for j in range(graph_depth(n, spec["gd"])):
                children(f"{t}.m.{j}", p[f"Bottleneck_{j}"],
                         s.get(f"Bottleneck_{j}", {}), ("cv1", "cv2"))
        elif mod == "SPP":
            children(t, params[name], stats.get(name, {}), ("cv1", "cv2"))
        elif mod == "StemBlock":
            children(t, params[name], stats.get(name, {}),
                     ("stem_1", "stem_2a", "stem_2b", "stem_3"))
        elif mod == "ShuffleV2Block":
            # flax: layer{i}_{r} with ConvBN_k in call order (branch1's two
            # when strided, then branch2's three); torch: the branches'
            # Sequential indices of each (conv, bn) pair, or of each
            # QConvBN in a quantized net
            pairs = ([("branch1.0", "branch1.1", "branch1.0"),
                      ("branch1.2", "branch1.3", "branch1.1")]
                     if args[1] > 1 else [])
            pairs += [("branch2.0", "branch2.1", "branch2.0"),
                      ("branch2.3", "branch2.4", "branch2.1"),
                      ("branch2.5", "branch2.6", "branch2.2")]
            reps = graph_depth(n, spec["gd"])
            for r in range(reps):
                tp = t if reps == 1 else f"{t}.{r}"
                p = params[f"layer{i}_{r}"]
                s = stats.get(f"layer{i}_{r}", {})
                for k, (cp, bp, qp) in enumerate(pairs):
                    conv_bn(f"{tp}.{cp}", f"{tp}.{bp}", p[f"ConvBN_{k}"],
                            s.get(f"ConvBN_{k}"), f"{tp}.{qp}")
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


def _convbn(sd: Dict[str, torch.Tensor], tp: str, p: Mapping, s: Mapping
            ) -> None:
    """A flax ``ConvBN`` (``Conv_0`` + ``BatchNorm_0``) -> the port's."""
    sd[f"{tp}.conv.weight"] = f2t_conv(p["Conv_0"]["kernel"])
    _bn(sd, f"{tp}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


# flax module name of each SSD backbone, and its (flax child, port child)
# names: top-level ConvBNs, then (flax block prefix, port list, children)
_SSD_TRUNKS = {
    "resnet10": ("_ResNet10Backbone_0", (("ConvBN_0", "stem"),),
                 ("_ResBlock", "blocks", 4, ("conv1", "conv2", "shortcut"))),
    "mobilenetv2": ("_MobileNetV2Backbone_0",
                    (("ConvBN_0", "stem"), ("ConvBN_1", "head")),
                    ("_InvertedResidual", "blocks", 10,
                     ("expand", "dw", "project"))),
    "squeezenet": ("_SqueezeNetBackbone_0",
                   (("ConvBN_0", "stem"), ("ConvBN_1", "head")),
                   ("_Fire", "fires", 7, ("squeeze", "expand1", "expand3"))),
}


def ssd_state_dict(variables: Mapping, backbone: str
                   ) -> Dict[str, torch.Tensor]:
    """Map a flax ``SSDFaceNet`` tree {"params", "batch_stats"} of numpy
    arrays onto the port's ``SSDFaceNet`` state_dict for ``backbone``
    ("resnet10", "mobilenetv2", "squeezenet"): the backbone's blocks by
    call order, the heads ``loc{l}`` / ``conf{l}`` onto ``loc.l`` /
    ``conf.l``."""
    name, tops, (prefix, plist, n, children) = _SSD_TRUNKS[backbone]
    params = variables["params"][name]
    stats = variables["batch_stats"][name]
    sd: Dict[str, torch.Tensor] = {}
    for fl, tp in tops:
        _convbn(sd, f"backbone.{tp}", params[fl], stats[fl])
    for i in range(n):
        p, s = params[f"{prefix}_{i}"], stats[f"{prefix}_{i}"]
        for k, child in enumerate(children):
            if f"ConvBN_{k}" in p:  # a block without a shortcut has two
                _convbn(sd, f"backbone.{plist}.{i}.{child}", p[f"ConvBN_{k}"],
                        s[f"ConvBN_{k}"])
    for head in ("loc", "conf"):
        level = 0
        while f"{head}{level}" in variables["params"]:
            conv = variables["params"][f"{head}{level}"]
            sd[f"{head}.{level}.weight"] = f2t_conv(conv["kernel"])
            sd[f"{head}.{level}.bias"] = _t(conv["bias"])
            level += 1
    return sd


# ---------------------------------------------------------------------------
# MTCNN
# ---------------------------------------------------------------------------

# flax child of each stage -> the port's module (PReLU slopes: ``weight``)
_MTCNN_NAMES = {
    "pnet": {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
             "Conv_3": "prob", "Conv_4": "reg", "PReLU_0": "prelu1",
             "PReLU_1": "prelu2", "PReLU_2": "prelu3"},
    "rnet": {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
             "Dense_0": "fc", "Dense_1": "prob", "Dense_2": "reg",
             "PReLU_0": "prelu1", "PReLU_1": "prelu2", "PReLU_2": "prelu3",
             "PReLU_3": "prelu4"},
    "onet": {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
             "Conv_3": "conv4", "Dense_0": "fc", "Dense_1": "prob",
             "Dense_2": "reg", "Dense_3": "lmk", "PReLU_0": "prelu1",
             "PReLU_1": "prelu2", "PReLU_2": "prelu3", "PReLU_3": "prelu4",
             "PReLU_4": "prelu5"},
}


def _natural_key(name: str):
    """Flax's auto-numbered siblings in numeric order (Conv_2 < Conv_10)."""
    return tuple(int(p) if p.isdigit() else p
                 for p in re.split(r"(\d+)", name))


def _flax_leaf_to_torch(leaf: str, arr) -> torch.Tensor:
    """A flax leaf (kernel HWIO or [in, out], bias, alpha) as the torch
    tensor of the same slot."""
    a = np.asarray(arr, np.float32)
    if leaf == "kernel":
        return f2t_conv(a) if a.ndim == 4 else _t(a).T.contiguous()
    return _t(a)


def _mtcnn_slots(stage: str):
    """(flax child, leaf, port name) of a stage in the JAX importer's walk
    order: Conv children first, then the rest, each in numeric order;
    kernel before bias."""
    names = sorted(_MTCNN_NAMES[stage], key=lambda k: (
        0 if k.startswith("Conv") else 1, _natural_key(k)))
    for child in names:
        port = _MTCNN_NAMES[stage][child]
        if child.startswith("PReLU"):
            yield child, "alpha", f"{stage}.{port}.weight"
        else:
            yield child, "kernel", f"{stage}.{port}.weight"
            yield child, "bias", f"{stage}.{port}.bias"


def mtcnn_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map the JAX cascade's variables ({"pnet", "rnet", "onet"}, each
    {"params": ...} of numpy arrays) onto the port's ``MTCNN`` state_dict.
    The Dense kernels load as they are: the port flattens channels-last."""
    sd: Dict[str, torch.Tensor] = {}
    for stage in _MTCNN_NAMES:
        params = variables[stage]["params"]
        for child, leaf, name in _mtcnn_slots(stage):
            sd[name] = _flax_leaf_to_torch(leaf, params[child][leaf])
    return sd


def convert_mtcnn_graphdef(consts, net: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a frozen MTCNN GraphDef's Const tensors (blaueck/tf-mtcnn's
    ``mtcnn.pb``, the reference's ``modules/mtcnn/model.py:57-101``) onto
    the port's ``MTCNN`` state_dict, as the JAX package's
    ``convert_mtcnn_graphdef`` pours them onto its cascade: consts grouped
    by stage name (pnet/rnet/onet substrings), each slot taken in the JAX
    walk order by the first unused const of its name kind (weights/kernel,
    bias, prelu/alpha) and shape, then of no kind, then of any kind. TF
    kernels are HWIO and flax's, so the same const lands on the same slot
    in both packages."""
    by_stage = {s: [] for s in _MTCNN_NAMES}
    for c in consts:
        low = c.name.lower()
        for stage in _MTCNN_NAMES:
            if stage in low:
                by_stage[stage].append(c)
                break

    def name_kind(name: str):
        low = name.lower()
        base = low.rsplit("/", 1)[-1].split(":")[0]
        if "alpha" in low or "prelu" in low:
            return "alpha"
        if "bias" in base or base in ("b", "beta"):
            return "bias"
        if "weight" in base or "kernel" in base or base == "w":
            return "kernel"
        return None

    current = net.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for stage in _MTCNN_NAMES:
        pool = by_stage[stage]
        if not pool:
            raise ValueError(f"no consts matching stage '{stage}' in graph")
        kinds = [name_kind(c.name) for c in pool]
        used = [False] * len(pool)
        for child, leaf, name in _mtcnn_slots(stage):
            t = current[name]
            shape = (tuple(t.shape[2:]) + (t.shape[1], t.shape[0])
                     if t.dim() == 4 else
                     tuple(t.shape[::-1]) if leaf == "kernel"
                     else tuple(t.shape))
            hit = None
            for want in (leaf, None, "any"):
                for j, c in enumerate(pool):
                    if not used[j] and tuple(c.value.shape) == shape \
                            and (want == "any" or kinds[j] == want):
                        hit = j
                        break
                if hit is not None:
                    break
            if hit is None:
                raise ValueError(f"{stage}: no const of shape {shape} left "
                                 f"for {stage}/{child}/{leaf}")
            used[hit] = True
            sd[name] = _flax_leaf_to_torch(leaf, pool[hit].value)
    return sd


# ---------------------------------------------------------------------------
# caffemodel / GraphDef array streams
# ---------------------------------------------------------------------------


def c2f_conv(w: np.ndarray) -> np.ndarray:
    """caffe/OpenVINO OIHW conv kernel -> flax HWIO."""
    return np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0))


def caffe_layers_to_arrays(layers) -> List[np.ndarray]:
    """Flatten caffemodel layers into the ordered array stream
    ``structural_import`` consumes, in the JAX package's layouts:
    Convolution -> kernel (HWIO), bias; InnerProduct -> kernel [in, out],
    bias; BatchNorm (+ Scale) -> gamma, beta, mean, var (caffe stores mean
    and var times the scale factor in blob 2)."""
    arrays = []
    i = 0
    while i < len(layers):
        layer = layers[i]
        if layer.type == "Convolution" and layer.blobs:
            arrays.append(c2f_conv(layer.blobs[0]))
            if len(layer.blobs) > 1:
                arrays.append(np.asarray(layer.blobs[1]))
        elif layer.type == "InnerProduct" and layer.blobs:
            arrays.append(np.asarray(layer.blobs[0]).T)
            if len(layer.blobs) > 1:
                arrays.append(np.asarray(layer.blobs[1]))
        elif layer.type == "BatchNorm" and layer.blobs:
            sf = (float(layer.blobs[2].reshape(-1)[0])
                  if len(layer.blobs) > 2 else 1.0)
            sf = 1.0 / sf if sf != 0 else 0.0
            mean = np.asarray(layer.blobs[0]) * sf
            var = np.asarray(layer.blobs[1]) * sf
            gamma, beta = np.ones_like(mean), np.zeros_like(mean)
            nxt = layers[i + 1] if i + 1 < len(layers) else None
            if nxt is not None and nxt.type == "Scale" and nxt.blobs:
                gamma = np.asarray(nxt.blobs[0])
                if len(nxt.blobs) > 1:
                    beta = np.asarray(nxt.blobs[1])
                i += 1
            arrays += [gamma, beta, mean, var]
        i += 1
    return arrays


# each parameter module's slots in the JAX walk's leaf order (kernel,
# scale, bias, alpha, mean, var), as (torch name, flax leaf)
_SLOT_LEAVES = (
    (nn.Conv2d, (("weight", "kernel"), ("bias", "bias"))),
    (nn.Linear, (("weight", "kernel"), ("bias", "bias"))),
    (nn.BatchNorm2d, (("weight", "scale"), ("bias", "bias"),
                      ("running_mean", "mean"), ("running_var", "var"))),
    (nn.BatchNorm1d, (("weight", "scale"), ("bias", "bias"),
                      ("running_mean", "mean"), ("running_var", "var"))),
    (nn.PReLU, (("weight", "alpha"),)),
)


def execution_slots(net: nn.Module, example: torch.Tensor,
                    skip: Sequence[str] = ()):
    """The net's weight slots in the order a serialized file streams them:
    parameter modules by their first call on ``example`` (the flax call
    order the JAX package records, since the port's forwards call in it),
    each module's leaves in the JAX walk's order, less the flax leaves
    named in ``skip`` (a BatchNorm without a scale has no ``scale`` slot).
    Returns [(state_dict name, flax leaf, flax shape)]."""
    names = {m: n for n, m in net.named_modules()}
    order: List[nn.Module] = []

    def hook(mod, args):
        if mod not in order:
            order.append(mod)

    handles = [m.register_forward_pre_hook(hook) for m in net.modules()
               if isinstance(m, tuple(t for t, _ in _SLOT_LEAVES))]
    was_training = net.training
    try:
        net.eval()
        with torch.no_grad():
            net(example.to(next(net.parameters()).device))
    finally:
        for h in handles:
            h.remove()
        net.train(was_training)
    slots = []
    for mod in order:
        leaves = next(lv for t, lv in _SLOT_LEAVES if isinstance(mod, t))
        for attr, leaf in leaves:
            t = getattr(mod, attr, None)
            if t is None or leaf in skip:
                continue
            shape = tuple(t.shape)
            if leaf == "kernel":  # the flax layout of the file's array
                shape = (shape[2:] + (shape[1], shape[0]) if t.dim() == 4
                         else shape[::-1])
            slots.append((f"{names[mod]}.{attr}", leaf, shape))
    return slots


def structural_import(arrays: Sequence[np.ndarray], net: nn.Module,
                      example: torch.Tensor, strict: bool = True,
                      skip: Sequence[str] = (), omit: Sequence[str] = ()
                      ) -> Dict[str, torch.Tensor]:
    """Pour an ordered array stream (``caffe_layers_to_arrays``, or a
    GraphDef's float consts) into ``net``'s slots in execution order, as
    the JAX package's ``structural_import`` with ``execution_module_order``
    pours it into a flax tree: the same arrays land on the same layers.
    Arrays are in the flax layouts (HWIO kernels, [in, out] Dense); every
    shape is checked against the slot, a mismatch naming the slot; the
    flax leaves in ``skip`` take no array (``execution_slots``), nor do the
    state dict entries named in ``omit``. Returns ``net``'s full state_dict
    with every slot replaced."""
    slots = [sl for sl in execution_slots(net, example, skip)
             if sl[0] not in omit]
    if strict and len(arrays) != len(slots):
        raise ValueError(f"weight stream has {len(arrays)} arrays but the "
                         f"model has {len(slots)} leaves")
    sd = dict(net.state_dict())
    for (name, leaf, shape), arr in zip(slots, arrays):
        arr = np.asarray(arr, np.float32)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {name}: file "
                             f"{tuple(arr.shape)} vs model {shape}")
        sd[name] = _flax_leaf_to_torch(leaf, arr).to(sd[name].device)
    return sd


# ---------------------------------------------------------------------------
# keras FaceNet importer (SavedModel TensorBundle / HDF5)
# ---------------------------------------------------------------------------

# keras attribute -> its place in a layer's stream, the JAX walk's leaf
# order (kernel, scale/gamma, bias/beta, mean, var)
_KERAS_ATTR_PRI = {"kernel": 0, "depthwise_kernel": 0, "gamma": 1,
                   "beta": 2, "bias": 2, "moving_mean": 3,
                   "moving_variance": 4}


def keras_bundle_stream(named) -> List[np.ndarray]:
    """(name, array) pairs of a TF2 SavedModel's variables bundle
    (``utils.tensor_bundle.read_tensor_bundle``) -> the model's layer
    stream.

    TF2 object-graph keys look like
    ``layer_with_weights-12/kernel/.ATTRIBUTES/VARIABLE_VALUE``: layers are
    numbered in build order and their attributes sorted by name (a conv's
    ``bias`` before its ``kernel``), so the pairs are regrouped by layer and
    each layer's emitted as kernel, gamma, beta, mean, var. Optimizer slots
    and the step counter are dropped."""
    groups: dict = {}
    for name, arr in named:
        if "/.OPTIMIZER_SLOT" in name \
                or ".ATTRIBUTES/VARIABLE_VALUE" not in name:
            continue
        m = re.search(r"layer_with_weights-(\d+)/([a-z_]+)/", name)
        if not m or m.group(2) not in _KERAS_ATTR_PRI:
            continue
        groups.setdefault(int(m.group(1)), []).append(
            (_KERAS_ATTR_PRI[m.group(2)], arr))
    return [arr for idx in sorted(groups)
            for _, arr in sorted(groups[idx], key=lambda t: t[0])]


def read_keras_h5_stream(path: str) -> List[np.ndarray]:
    """A keras ``.h5`` file's weight arrays in the model's own layer order
    (the ``model_weights`` group's ``layer_names`` and each layer's
    ``weight_names``: [kernel, bias] / [gamma, beta, moving_mean,
    moving_variance], already the stream order). Reading HDF5 needs
    ``h5py``, imported here only: without it this raises ``ImportError``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{path}: reading a keras .h5 needs h5py, which "
                          "is not installed") from e

    def names(attrs, key):
        return [n.decode() if isinstance(n, bytes) else n
                for n in attrs.get(key, [])]

    out = []
    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        for lname in names(g.attrs, "layer_names") or list(g.keys()):
            lg = g[lname]
            out += [np.asarray(lg[wn]) for wn in names(lg.attrs,
                                                         "weight_names")]
    return out


FACENET_EXAMPLE = (1, 160, 160, 3)  # the input FaceNet's call order is read on


def convert_facenet_keras(stream: Sequence[np.ndarray], net: nn.Module
                          ) -> Dict[str, torch.Tensor]:
    """Pour a keras FaceNet weight stream (``read_keras_h5_stream`` or
    ``keras_bundle_stream``) into the port's ``InceptionResNetV1``: keras
    and flax are both HWIO, so this is ``structural_import`` in execution
    order, every shape checked. FaceNet's BatchNorms have no scale
    (keras ``scale=False``): their weights stay 1 and take no array. The
    reference loads the model with ``tf.keras.models.load_model``
    (``similar_face_filtering/filter_faces_using_reference.py:131``).

    A keras FaceNet stores the final BatchNorm's moving mean and variance
    like every other's. The JAX package's stream stops short of them (its
    slot walk gives statistics only to modules named ``BatchNorm_*``, and
    the bottleneck's is ``bottleneck_bn``), so its files are two arrays
    shorter; such a stream is taken too, and those two statistics are
    then mean 0 and variance 1, the values the JAX import leaves there.
    Returns ``net``'s state dict."""
    stream = list(stream)
    example = torch.zeros(FACENET_EXAMPLE)
    slots = execution_slots(net, example, ("scale",))
    last = slots[-1][0].rsplit(".", 1)[0]
    stats = (f"{last}.running_mean", f"{last}.running_var")
    if len(stream) != len(slots) - 2 or \
            tuple(sl[0] for sl in slots[-2:]) != stats:
        return structural_import(stream, net, example, skip=("scale",))
    sd = structural_import(stream, net, example, skip=("scale",), omit=stats)
    sd[stats[0]] = torch.zeros_like(sd[stats[0]])
    sd[stats[1]] = torch.ones_like(sd[stats[1]])
    return sd


def convert_caffenet_head(layers, num_classes: int = None
                          ) -> Dict[str, torch.Tensor]:
    """An age_net / gender_net ``.caffemodel`` (the Levi-Hassner CaffeNet,
    ``modules/opencv2_dnn/model.py:49-83``) -> the port's ``CaffeNetHead``
    state_dict: the three Convolution layers onto conv1..3, the three
    InnerProduct layers onto fc6..8. Caffe's OIHW kernels and its (C, H, W)
    flatten before fc6 are the port's own, so the blobs load as they
    are."""
    convs = [la for la in layers if la.type == "Convolution" and la.blobs]
    fcs = [la for la in layers if la.type == "InnerProduct" and la.blobs]
    if len(convs) != 3 or len(fcs) != 3:
        raise ValueError("expected a 3-conv + 3-fc CaffeNet, got "
                         f"{len(convs)} Convolution / {len(fcs)} "
                         "InnerProduct layers")
    out_classes = np.asarray(fcs[2].blobs[1]).shape[0]
    if num_classes is not None and out_classes != num_classes:
        raise ValueError(f"caffemodel has {out_classes} output classes, "
                         f"expected {num_classes}")
    sd: Dict[str, torch.Tensor] = {}
    for name, layer in zip(("conv1", "conv2", "conv3", "fc6", "fc7", "fc8"),
                           convs + fcs):
        sd[f"{name}.weight"] = _t(layer.blobs[0])
        sd[f"{name}.bias"] = _t(np.asarray(layer.blobs[1]).reshape(-1))
    return sd


def dequantize_graphdef_consts(consts) -> list:
    """Collapse TF ``quantize_weights``-transform triplets back to f32, as
    the JAX package's ``dequantize_graphdef_consts`` does:
    ``<stem>_quantized_const`` (uint8) with its ``_quantized_min`` and
    ``_quantized_max`` scalars becomes ``min + q * (max - min) / 255``
    named ``<stem>``; plain consts pass through."""
    from .model_formats import GraphConst

    by_name = {c.name: c for c in consts}
    out = []
    for c in consts:
        if c.name.endswith(("_quantized_min", "_quantized_max")):
            continue
        if c.name.endswith("_quantized_const"):
            stem = c.name[: -len("_quantized_const")]
            mn = by_name.get(stem + "_quantized_min")
            mx = by_name.get(stem + "_quantized_max")
            if mn is None or mx is None:
                raise ValueError(f"{c.name}: missing _quantized_min/"
                                 "_quantized_max siblings")
            lo = float(np.asarray(mn.value).reshape(-1)[0])
            hi = float(np.asarray(mx.value).reshape(-1)[0])
            deq = lo + c.value.astype(np.float32) * ((hi - lo) / 255.0)
            out.append(GraphConst(name=stem, value=deq))
        else:
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# the graph interpreters: res10-ssd (Caffe) and the OpenVINO IR nets
# ---------------------------------------------------------------------------


def caffe_graph_state_dict(blobs: Mapping) -> Dict[str, torch.Tensor]:
    """{caffe layer name: [blobs]} (the JAX package's res10 variables, or
    ``CaffeGraphNet.pour_blobs``) -> a ``CaffeGraphNet`` state_dict: the
    blobs as they are, under ``blobs.<param_key(layer)>.<i>``."""
    return {f"blobs.{param_key(layer)}.{i}": _t(b)
            for layer, bl in blobs.items() for i, b in enumerate(bl)}


def ov_graph_state_dict(consts: Mapping) -> Dict[str, torch.Tensor]:
    """{IR constant name: array} (the JAX package's OpenVINO variables)
    -> an ``OVGraphNet`` state_dict: each weight under
    ``consts.<param_key(name)>``, f32."""
    return {f"consts.{param_key(name)}": _t(v) for name, v in consts.items()}


def _gd_name_kind(cname: str):
    base = cname.lower().rsplit("/", 1)[-1].split(":")[0]
    if "gamma" in base or base in ("scale", "mul", "w"):
        return "gamma"
    if "beta" in base or "offset" in base:
        return "beta"
    if "mean" in base:
        return "mean"
    if "var" in base:
        return "var"
    if "bias" in base or base in ("b",):
        return "bias"
    if "weight" in base or "kernel" in base or "conv" in base:
        return "kernel"
    return None


def convert_res10_graphdef(consts, net) -> Dict[str, List[np.ndarray]]:
    """A TF-GraphDef face SSD's consts poured into the res10 deploy graph
    (``models/res10.py``; OpenCV builds this net from both its
    ``.caffemodel`` and its ``opencv_face_detector_uint8.pb``), as the JAX
    package's ``convert_res10_graphdef`` pours them: {layer: [blobs]} in
    the net's Caffe layouts (``caffe_graph_state_dict`` loads it).

    The GraphDef is transform-optimized: weights as uint8 triplets
    (dequantized first, ``dequantize_graphdef_consts``) and batch norms
    folded. Convolution kernels and biases come from the file, by layer
    name prefix (``<layer>/...`` or ``<layer>_...``) first, then graph
    order and shape; a BatchNorm takes the identity statistics (mean 0,
    var 1, scale factor 1) and a Scale the identity affine, unless the
    graph carries layer-prefixed consts for them (gamma / beta / mean /
    var by name). TF kernels are HWIO: a 4-D const is transposed
    (3, 2, 0, 1) where that, and not its raw shape, fits the slot. Raises
    ``ValueError`` with a per-layer table where a convolution slot cannot
    fill."""
    consts = dequantize_graphdef_consts(consts)
    used = [False] * len(consts)
    bn_layers = {st.name for st in net.steps if st.op == "batchnorm"}
    scale_layers = {st.name for st in net.steps if st.op == "scale"}

    def owner_prefix(cname: str, layer: str) -> bool:
        return (cname == layer or cname.startswith(layer + "/")
                or cname.startswith(layer + "_"))

    def fit(value, want):
        """f32 ``value`` in the slot's layout (shape ``want``), or None."""
        v = np.asarray(value, np.float32)
        if v.ndim == 4:
            hwio = np.transpose(v, (3, 2, 0, 1))
            if tuple(hwio.shape) == want:
                return hwio
        if tuple(v.shape) == want:
            return v
        if v.size == int(np.prod(want)) and v.ndim <= 1:
            return v.reshape(want)
        return None

    def take_prefixed(layer: str, want, kind=None):
        for j, c in enumerate(consts):
            if used[j] or not owner_prefix(c.name, layer):
                continue
            if kind is not None and _gd_name_kind(c.name) != kind:
                continue
            f = fit(c.value, want)
            if f is not None:
                used[j] = True
                return f
        return None

    out: Dict[str, List[np.ndarray]] = {}
    problems = []
    for layer in net.blob_layers():
        shapes = [tuple(b.shape) for b in net.layer_blobs(layer)]
        if layer in bn_layers or layer in scale_layers:
            # BatchNorm [mean, var, scale factor] (the factor has no TF
            # counterpart: always 1), Scale [gamma(, beta)]: the identity
            # unless the graph carries them
            kinds = (("mean", np.zeros), ("var", np.ones), (None, np.ones)) \
                if layer in bn_layers else (("gamma", np.ones),
                                            ("beta", np.zeros))
            blobs = []
            for want, (kind, ident) in zip(shapes, kinds):
                v = take_prefixed(layer, want, kind) if kind else None
                blobs.append(v if v is not None
                             else ident(want, np.float32))
            out[layer] = blobs
            continue
        poured = []
        for want in shapes:
            f = take_prefixed(layer, want,
                              "kernel" if len(want) == 4 else "bias")
            if f is None:
                f = take_prefixed(layer, want)       # prefixed, any kind
            if f is None:                            # graph order + shape
                for j, c in enumerate(consts):
                    if not used[j]:
                        f = fit(c.value, want)
                        if f is not None:
                            used[j] = True
                            break
            if f is None:
                problems.append(f"  {layer}: no const left for slot {want}")
                break
            poured.append(f)
        else:
            out[layer] = poured
    if problems:
        raise ValueError("GraphDef pour failed:\n" + "\n".join(problems))
    return out
