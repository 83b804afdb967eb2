"""The res10_300x300 SSD face detector: its deploy graph.

The counterpart of ``models/res10.py`` in the JAX package. OpenCV's face
detector (``modules/opencv2_dnn/model.py:21`` of the reference loads
``res10_300x300_ssd_iter_140000.caffemodel``) is a half-width
pre-activation ResNet-10 trunk with SSD300-style extras and heads,
published as ``deploy.prototxt`` in opencv/samples/dnn/face_detector. This
module encodes that graph as a ``CaffeLayerDef`` table for the interpreter
in ``models/caffe_ssd.py``:

* trunk: conv1 (32, 7x7/2) -> maxpool/2 -> pre-activation residual stages
  layer_64_1 (32, /1), layer_128_1 (64, /2), layer_256_1 (128, /2),
  layer_512_1 (256, dilated, /1), the ``_h``-suffixed half-width variant;
* extras: conv6 (128 -> 256, /2), conv7 (64 -> 128, /2), conv8 (64 -> 128,
  3x3 valid), conv9 (64 -> 128, 3x3 valid);
* heads on conv4_3_norm (38x38), fc7 (19x19), conv6_2 (10x10), conv7_2
  (5x5), conv8_2 (3x3) and conv9_2 (1x1) with the SSD300 PriorBox ladder:
  min 30/60/111/162/213/264, max 60/111/162/213/264/315, aspect ratios
  [2], [2, 3] x 3, [2], [2], flipped, variance (0.1, 0.1, 0.2, 0.2): 8732
  priors, 2 classes.

The table is reconstructed from the public prototxt. Where a real
``.caffemodel`` disagrees, ``CaffeGraphNet.pour_blobs`` raises with a
per-layer name and shape diff; and since a real caffemodel embeds its own
layer definitions, ``build_res10_from_caffemodel(path, strict_table=False)``
builds the net from the FILE's graph instead.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..utils.caffe_graph import CaffeLayerDef, read_caffemodel_graph
from .caffe_ssd import CaffeGraphNet, make_caffe_ssd_detect

RES10_SIZE = (300, 300)


def _conv(name, bottom, top, n_out, kernel, stride=1, pad=0, bias=False,
          dilation=1):
    return CaffeLayerDef(
        name=name, type="Convolution", bottoms=[bottom], tops=[top],
        params={"conv": {"num_output": n_out, "bias_term": bias,
                         "pad": [pad], "kernel": [kernel],
                         "stride": [stride], "group": 1,
                         "dilation": [dilation]}})


def _bn(name, bottom, top):
    return CaffeLayerDef(name=name, type="BatchNorm", bottoms=[bottom],
                         tops=[top])


def _scale(name, bottom, top, bias=True):
    return CaffeLayerDef(name=name, type="Scale", bottoms=[bottom],
                         tops=[top], params={"scale": {"bias_term": bias}})


def _relu(name, bottom, top):
    return CaffeLayerDef(name=name, type="ReLU", bottoms=[bottom], tops=[top])


def _pool(name, bottom, top, kernel, stride, mode="max", pad=0):
    return CaffeLayerDef(name=name, type="Pooling", bottoms=[bottom],
                         tops=[top],
                         params={"pool": {"pool": mode, "kernel": kernel,
                                          "stride": stride, "pad": pad}})


def _sum(name, bottoms, top):
    return CaffeLayerDef(name=name, type="Eltwise", bottoms=list(bottoms),
                         tops=[top],
                         params={"eltwise": {"operation": "sum"}})


def _preact_stage(defs: List[CaffeLayerDef], tag: str, bottom: str,
                  n_out: int, stride: int, dilation: int = 1) -> str:
    """Pre-activation residual stage layer_<tag>_1_* (bn1->relu1->conv1 ->
    bn2->relu2->conv2, shortcut conv_expand on relu1)."""
    p = f"layer_{tag}_1"
    defs += [
        _bn(f"{p}_bn1_h", bottom, f"{p}_bn1"),
        _scale(f"{p}_scale1_h", f"{p}_bn1", f"{p}_scale1"),
        _relu(f"{p}_relu1", f"{p}_scale1", f"{p}_relu1_t"),
        _conv(f"{p}_conv1_h", f"{p}_relu1_t", f"{p}_conv1", n_out, 3,
              stride=stride, pad=dilation, dilation=dilation),
        _bn(f"{p}_bn2_h", f"{p}_conv1", f"{p}_bn2"),
        _scale(f"{p}_scale2_h", f"{p}_bn2", f"{p}_scale2"),
        _relu(f"{p}_relu2", f"{p}_scale2", f"{p}_relu2_t"),
        _conv(f"{p}_conv2_h", f"{p}_relu2_t", f"{p}_conv2", n_out, 3,
              stride=1, pad=dilation, dilation=dilation),
        _conv(f"{p}_conv_expand_h", f"{p}_relu1_t", f"{p}_expand", n_out, 1,
              stride=stride),
        _sum(f"{p}_sum", [f"{p}_conv2", f"{p}_expand"], f"{p}_sum_t"),
    ]
    return f"{p}_sum_t"


# (source, min, max, aspect_ratios, step, n_priors_per_cell)
RES10_PRIOR_LADDER: Tuple[Tuple[str, float, float, Tuple[float, ...], float,
                                int], ...] = (
    ("conv4_3_norm", 30.0, 60.0, (2.0,), 8.0, 4),
    ("fc7", 60.0, 111.0, (2.0, 3.0), 16.0, 6),
    ("conv6_2", 111.0, 162.0, (2.0, 3.0), 32.0, 6),
    ("conv7_2", 162.0, 213.0, (2.0, 3.0), 64.0, 6),
    ("conv8_2", 213.0, 264.0, (2.0,), 100.0, 4),
    ("conv9_2", 264.0, 315.0, (2.0,), 300.0, 4),
)


def res10_deploy_defs() -> List[CaffeLayerDef]:
    """The full deploy graph as layer definitions (no blobs)."""
    d: List[CaffeLayerDef] = []
    d += [
        _bn("data_bn", "data", "data_bn_t"),
        _scale("data_scale", "data_bn_t", "data_scale_t"),
        _conv("conv1_h", "data_scale_t", "conv1", 32, 7, stride=2, pad=3,
              bias=True),
        _bn("conv1_bn_h", "conv1", "conv1_bn"),
        _scale("conv1_scale_h", "conv1_bn", "conv1_scale"),
        _relu("conv1_relu", "conv1_scale", "conv1_relu_t"),
        _pool("conv1_pool", "conv1_relu_t", "conv1_pool_t", 3, 2),
    ]
    # layer_64_1: no pre-activation (conv1 path already ends in relu),
    # identity shortcut
    d += [
        _conv("layer_64_1_conv1_h", "conv1_pool_t", "l64_conv1", 32, 3,
              pad=1),
        _bn("layer_64_1_bn2_h", "l64_conv1", "l64_bn2"),
        _scale("layer_64_1_scale2_h", "l64_bn2", "l64_scale2"),
        _relu("layer_64_1_relu2", "l64_scale2", "l64_relu2"),
        _conv("layer_64_1_conv2_h", "l64_relu2", "l64_conv2", 32, 3, pad=1),
        _sum("layer_64_1_sum", ["l64_conv2", "conv1_pool_t"], "l64_sum"),
    ]
    f128 = _preact_stage(d, "128", "l64_sum", 64, 2)        # 38x38
    f256 = _preact_stage(d, "256", f128, 128, 2)            # 19x19
    f512 = _preact_stage(d, "512", f256, 256, 1, dilation=2)  # 19x19 dilated
    d += [
        _bn("last_bn_h", f512, "last_bn"),
        _scale("last_scale_h", "last_bn", "last_scale"),
        _relu("last_relu", "last_scale", "fc7"),
        _conv("conv6_1_h", "fc7", "conv6_1", 128, 1, bias=True),
        _relu("conv6_1_relu", "conv6_1", "conv6_1_t"),
        _conv("conv6_2_h", "conv6_1_t", "conv6_2", 256, 3, stride=2, pad=1,
              bias=True),
        _relu("conv6_2_relu", "conv6_2", "conv6_2_t"),
        _conv("conv7_1_h", "conv6_2_t", "conv7_1", 64, 1, bias=True),
        _relu("conv7_1_relu", "conv7_1", "conv7_1_t"),
        _conv("conv7_2_h", "conv7_1_t", "conv7_2", 128, 3, stride=2, pad=1,
              bias=True),
        _relu("conv7_2_relu", "conv7_2", "conv7_2_t"),
        _conv("conv8_1_h", "conv7_2_t", "conv8_1", 64, 1, bias=True),
        _relu("conv8_1_relu", "conv8_1", "conv8_1_t"),
        _conv("conv8_2_h", "conv8_1_t", "conv8_2", 128, 3, bias=True),
        _relu("conv8_2_relu", "conv8_2", "conv8_2_t"),
        _conv("conv9_1_h", "conv8_2_t", "conv9_1", 64, 1, bias=True),
        _relu("conv9_1_relu", "conv9_1", "conv9_1_t"),
        _conv("conv9_2_h", "conv9_1_t", "conv9_2", 128, 3, bias=True),
        _relu("conv9_2_relu", "conv9_2", "conv9_2_t"),
    ]
    # conv4_3_norm: L2 normalize (across channels) of the stride-8 feature —
    # the activated input of the 256 stage
    d.append(CaffeLayerDef(
        name="conv4_3_norm", type="Normalize",
        bottoms=["layer_256_1_relu1_t"], tops=["conv4_3_norm"],
        params={"norm": {"across_spatial": False, "channel_shared": False}}))

    src_top = {"conv4_3_norm": "conv4_3_norm", "fc7": "fc7",
               "conv6_2": "conv6_2_t", "conv7_2": "conv7_2_t",
               "conv8_2": "conv8_2_t", "conv9_2": "conv9_2_t"}
    loc_flats, conf_flats, prior_tops = [], [], []
    for (src, mn, mx, ars, step, npc) in RES10_PRIOR_LADDER:
        bot = src_top[src]
        d += [
            _conv(f"{src}_mbox_loc", bot, f"{src}_mbox_loc", npc * 4, 3,
                  pad=1, bias=True),
            CaffeLayerDef(name=f"{src}_mbox_loc_perm", type="Permute",
                          bottoms=[f"{src}_mbox_loc"],
                          tops=[f"{src}_mbox_loc_perm"],
                          params={"permute": {"order": [0, 2, 3, 1]}}),
            CaffeLayerDef(name=f"{src}_mbox_loc_flat", type="Flatten",
                          bottoms=[f"{src}_mbox_loc_perm"],
                          tops=[f"{src}_mbox_loc_flat"],
                          params={"flatten": {"axis": 1}}),
            _conv(f"{src}_mbox_conf", bot, f"{src}_mbox_conf", npc * 2, 3,
                  pad=1, bias=True),
            CaffeLayerDef(name=f"{src}_mbox_conf_perm", type="Permute",
                          bottoms=[f"{src}_mbox_conf"],
                          tops=[f"{src}_mbox_conf_perm"],
                          params={"permute": {"order": [0, 2, 3, 1]}}),
            CaffeLayerDef(name=f"{src}_mbox_conf_flat", type="Flatten",
                          bottoms=[f"{src}_mbox_conf_perm"],
                          tops=[f"{src}_mbox_conf_flat"],
                          params={"flatten": {"axis": 1}}),
            CaffeLayerDef(
                name=f"{src}_mbox_priorbox", type="PriorBox",
                bottoms=[bot, "data"], tops=[f"{src}_mbox_priorbox"],
                params={"prior_box": {
                    "min_size": [mn], "max_size": [mx],
                    "aspect_ratio": list(ars), "flip": True, "clip": False,
                    "variance": [0.1, 0.1, 0.2, 0.2], "step": step,
                    "offset": 0.5}}),
        ]
        loc_flats.append(f"{src}_mbox_loc_flat")
        conf_flats.append(f"{src}_mbox_conf_flat")
        prior_tops.append(f"{src}_mbox_priorbox")
    d += [
        CaffeLayerDef(name="mbox_loc", type="Concat", bottoms=loc_flats,
                      tops=["mbox_loc"], params={"concat": {"axis": 1}}),
        CaffeLayerDef(name="mbox_conf", type="Concat", bottoms=conf_flats,
                      tops=["mbox_conf"], params={"concat": {"axis": 1}}),
        CaffeLayerDef(name="mbox_priorbox", type="Concat",
                      bottoms=prior_tops, tops=["mbox_priorbox"],
                      params={"concat": {"axis": 2}}),
        CaffeLayerDef(name="mbox_conf_reshape", type="Reshape",
                      bottoms=["mbox_conf"], tops=["mbox_conf_reshape"],
                      params={"reshape": {"shape": [0, -1, 2]}}),
        CaffeLayerDef(name="mbox_conf_softmax", type="Softmax",
                      bottoms=["mbox_conf_reshape"],
                      tops=["mbox_conf_softmax"],
                      params={"softmax": {"axis": 2}}),
        CaffeLayerDef(name="mbox_conf_flatten", type="Flatten",
                      bottoms=["mbox_conf_softmax"],
                      tops=["mbox_conf_flatten"],
                      params={"flatten": {"axis": 1}}),
        CaffeLayerDef(
            name="detection_out", type="DetectionOutput",
            bottoms=["mbox_loc", "mbox_conf_flatten", "mbox_priorbox"],
            tops=["detection_out"],
            params={"detection_output": {
                "num_classes": 2, "background_label_id": 0,
                "nms_threshold": 0.45, "top_k": 400, "keep_top_k": 200,
                "confidence_threshold": 0.01}}),
    ]
    return d


def build_res10(generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None
                ) -> Tuple[CaffeGraphNet, Callable]:
    """res10 from the deploy table, its kernels drawn from ``generator``:
    (net on ``device``, eval, and its decode)."""
    net = CaffeGraphNet(res10_deploy_defs(), RES10_SIZE, generator=generator)
    return net.to(device).eval(), make_caffe_ssd_detect(net)


def build_res10_from_caffemodel(path: str, strict_table: bool = True,
                                device: Optional[torch.device] = None
                                ) -> Tuple[CaffeGraphNet, Callable]:
    """res10 from a real caffemodel: (net on ``device``, eval, and its
    decode). With ``strict_table=False`` and a file that embeds a usable
    graph (convolution parameters and a DetectionOutput), the file's own
    graph runs, with its blobs; otherwise the file's blobs are poured by
    layer name into the deploy-table net (``pour_blobs``: a diagnostic
    error on any mismatch)."""
    from ..utils.weights import caffe_graph_state_dict

    defs = read_caffemodel_graph(path)
    has_graph = any(L.params.get("conv") for L in defs) and any(
        L.type == "DetectionOutput" for L in defs)
    if has_graph and not strict_table:
        net = CaffeGraphNet(defs, RES10_SIZE)
    else:
        net = CaffeGraphNet(res10_deploy_defs(), RES10_SIZE)
        net.load_state_dict(caffe_graph_state_dict(net.pour_blobs(defs)))
    return net.to(device).eval(), make_caffe_ssd_detect(net)
