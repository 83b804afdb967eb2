"""Detector registry: one uniform build-and-detect interface.

The counterpart of ``models/registry.py`` in the JAX package, with the
detectors this port has so far: the nine yolov5-face names (yolov5s/m/l,
yolov5n, yolov5n-0.5, yolov5s6/m6/l6, yolov5n6), the official multiclass
heads yolov5s-official and yolov5n-official, blazeface-front and
blazeface-back, the SSD family (ssd-resnet10, ssd-mobilenetv2,
ssd-squeezenet), the exact res10_300x300 Caffe deploy graph (res10-ssd),
the OpenVINO IR nets (openvino-ir, which executes the ``.xml`` given as
``detector_overrides={"xml": ...}``; ov-0204 and ov-squeezenet-light, the
reference's two IR topologies) and the MTCNN cascade (mtcnn, at native
resolution: ``input_size`` (-1, -1)). The nine yolov5-face names also
build int8 nets (``detector_overrides={"quantized": True | "static"}``).
The yolov5-face names and the official heads build bf16 nets
(``build(..., dtype=torch.bfloat16)``: ``DetectorSpec.bf16``); the other
families run f32 only (ROADMAP.md A8b).
``build`` returns the network and
its decode, with detections in the normalized contract: rows [xmin, ymin,
xmax, ymax, (lmk xy pairs...), conf] in [0, 1] wrt the model input size.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import preprocess as P
from ..ops.platform import check_kernel_choice
from .blazeface import BlazeFaceConfig, make_blazeface
from .mtcnn import MTCNNConfig, make_mtcnn
from .ov_graph import OVGraphNet, make_ov_detect
from .ov_topologies import build_ov_topology
from .res10 import build_res10
from .ssd import SSDConfig, make_ssd_face
from .layers import set_compute_dtype
from .yolov5_face import (ARCHS, OFFICIAL_ANCHORS, YoloV5FaceConfig,
                          YoloV5FaceNet, yolov5_face_detect_maps,
                          yolov5_official_detect_maps)


# ---------------- weight-file importers ----------------
# fn(path, net, input_size) -> net's state_dict; FaceEngine.load_weights
# calls the spec's importer for the file's extension. An .xml importer may
# instead return (net, decode): the file is the net


def example_input(input_size: Tuple[int, int]) -> torch.Tensor:
    """A zero input at ``input_size`` (w, h), on the CPU: what the
    structural import runs the net on to record its call order."""
    iw, ih = input_size
    return torch.zeros((1, ih, iw, 3))


def import_caffemodel_structural(path: str, net: torch.nn.Module,
                                 input_size: Tuple[int, int]
                                 ) -> Dict[str, torch.Tensor]:
    """A Caffe NetParameter whose Convolution, BatchNorm + Scale and
    InnerProduct layers stream in the net's execution order, poured slot
    by slot (JAX ``core/engine.py:267-277``, without ``res10-ssd``'s
    ``pour_blobs``)."""
    from ..utils import model_formats as MF
    from ..utils import weights as W

    return W.structural_import(
        W.caffe_layers_to_arrays(MF.read_caffemodel(path)), net,
        example_input(input_size))


def import_graphdef_structural(path: str, net: torch.nn.Module,
                               input_size: Tuple[int, int]
                               ) -> Dict[str, torch.Tensor]:
    """A frozen TF GraphDef's consts, dequantized, poured as a
    caffemodel's are: float consts of one dimension or more only (a
    transformed GraphDef also carries shape vectors and priorbox
    tables)."""
    from ..utils import model_formats as MF
    from ..utils import weights as W

    consts = W.dequantize_graphdef_consts(MF.read_tf_graphdef(path))
    arrays = [np.asarray(c.value, np.float32) for c in consts
              if np.issubdtype(np.asarray(c.value).dtype, np.floating)
              and np.asarray(c.value).ndim >= 1]
    return W.structural_import(arrays, net, example_input(input_size))


def import_mtcnn_graphdef(path: str, net: torch.nn.Module,
                          input_size: Tuple[int, int]
                          ) -> Dict[str, torch.Tensor]:
    """blaueck/tf-mtcnn's frozen ``mtcnn.pb`` onto the cascade
    (``utils.weights.convert_mtcnn_graphdef``)."""
    from ..utils import model_formats as MF
    from ..utils import weights as W

    return W.convert_mtcnn_graphdef(MF.read_tf_graphdef(path), net)


def import_xml_structural(path: str, net: torch.nn.Module,
                          input_size: Tuple[int, int]
                          ) -> Dict[str, torch.Tensor]:
    """An OpenVINO IR's float consts (sibling ``.bin``), 4-D ones as
    flax kernels, poured as a caffemodel's are (JAX
    ``core/engine.py:336-346``)."""
    from ..utils import model_formats as MF
    from ..utils import weights as W

    consts = MF.read_openvino_ir(path, os.path.splitext(path)[0] + ".bin")
    arrays = [W.c2f_conv(c.value) if c.value.ndim == 4 else c.value
              for c in consts if np.issubdtype(c.value.dtype, np.floating)]
    return W.structural_import(arrays, net, example_input(input_size))


def import_ir_net(path: str, net: torch.nn.Module,
                  input_size: Tuple[int, int]):
    """An IR net's ``.xml`` (sibling ``.bin``): the file is the net, so
    the importer builds it anew, on the old net's device: (net, decode)
    (JAX ``core/engine.py:314-335``)."""
    from ..utils.ir_graph import parse_ir_graph

    new = OVGraphNet(parse_ir_graph(path, os.path.splitext(path)[0]
                                    + ".bin"))
    new = new.to(next(net.parameters()).device).eval()
    return new, make_ov_detect(new)


def import_res10_caffemodel(path: str, net: torch.nn.Module,
                            input_size: Tuple[int, int]
                            ) -> Dict[str, torch.Tensor]:
    """A res10 caffemodel's blobs poured by layer NAME into the deploy
    graph (``CaffeGraphNet.pour_blobs``, a per-layer diff on mismatch;
    JAX ``core/engine.py:270-273``)."""
    from ..utils.caffe_graph import read_caffemodel_graph
    from ..utils.weights import caffe_graph_state_dict

    return caffe_graph_state_dict(net.pour_blobs(read_caffemodel_graph(path)))


def import_res10_graphdef(path: str, net: torch.nn.Module,
                          input_size: Tuple[int, int]
                          ) -> Dict[str, torch.Tensor]:
    """OpenCV's ``opencv_face_detector_uint8.pb`` flavour of res10:
    dequantized and poured into the deploy graph
    (``utils.weights.convert_res10_graphdef``; JAX
    ``core/engine.py:285-293``)."""
    from ..utils import model_formats as MF
    from ..utils import weights as W

    return W.caffe_graph_state_dict(
        W.convert_res10_graphdef(MF.read_tf_graphdef(path), net))


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """A detector registry entry.

    build(generator, device, **overrides) -> (net, decode) where net(imgs
    [B, h, w, 3] preprocessed) gives the raw heads and decode(raw, (h, w))
    returns (dets [B, K, 4+L+1] NORMALIZED to the input size, valid [B, K]).
    A native-resolution detector (input_size (-1, -1), no preprocess) runs
    whole in decode: decode(frames [B, H, W, 3] BGR, (H, W)). A spec with
    ``bf16`` set also takes ``dtype=torch.bfloat16``: the JAX package's
    bf16 net, whose raw heads are bf16 and whose detections are f32.
    """

    name: str
    input_size: Tuple[int, int]  # (width, height)
    preprocess: P.PreprocessSpec
    n_landmark_cols: int         # L: 10 yolov5-face, 12 BlazeFace, 0 none
    build: Callable
    # detect() accepts any input whose sides are a multiple of this stride
    # (rect letterbox); input_size stays the box rect shapes fit in
    rect_stride: int = 0
    # the weight-file importers (above); None: no such file for this net
    import_caffemodel: Optional[Callable] = import_caffemodel_structural
    import_pb: Optional[Callable] = None
    import_xml: Optional[Callable] = import_xml_structural
    # the build takes detector_overrides={"quantized": True | "static"}
    # (the int8 yolov5-face nets); load_weights rebuilds the net to the
    # mode of an int8 state dict
    quantizable: bool = False
    # the build takes dtype=torch.bfloat16 (ROADMAP.md A8: the yolov5
    # family; A8b: the others)
    bf16: bool = False


_REGISTRY = {}


def register(spec: DetectorSpec) -> DetectorSpec:
    _REGISTRY[spec.name] = spec
    return spec


def available():
    return sorted(_REGISTRY)


def get(name: str) -> DetectorSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown detector '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


# ---------------- yolov5-face family ----------------


CALIBRATION_BATCH = (2, 256, 256, 3)  # a static int8 net's seeded frames


def _build_yolov5(arch: str, input_size):
    def build(generator: torch.Generator, device: torch.device,
              dtype: torch.dtype = torch.float32, **kw):
        kw.setdefault("input_size", input_size)
        # quantized is a build-time graph switch, not a config field, as
        # in the JAX registry: the seeded f32 net is folded and quantized
        # into the int8 one, whose static scales are calibrated on seeded
        # noise frames (utils/quantize.py)
        quantized = kw.pop("quantized", False)
        cfg = YoloV5FaceConfig(arch=arch, **kw)
        check_kernel_choice(cfg.pallas_nms, device, "pallas_nms")
        net = YoloV5FaceNet(arch, cfg.nc).init_random_(generator)
        if quantized:
            from ..utils.quantize import quantize_net

            net = quantize_net(
                net, YoloV5FaceNet(arch, cfg.nc, quantized=quantized),
                [torch.rand(CALIBRATION_BATCH, generator=generator)])
        net = net.to(device=device, memory_format=torch.channels_last).eval()
        set_compute_dtype(net, dtype)
        spec = ARCHS[arch]

        def decode(maps, in_hw: Tuple[int, int]):
            # normalize by the ACTUAL input dims: the same decode serves
            # square and rect letterbox resolutions
            ih, iw = in_hw
            scale = torch.tensor([iw, ih] * 7 + [1.0], dtype=torch.float32,
                                 device=maps[0].device)
            dets, valid = yolov5_face_detect_maps(
                maps, spec["anchors"], spec["strides"], cfg)
            # [x1,y1,x2,y2,obj,lmk x10, cls] pixels ->
            # [x1,y1,x2,y2, lmk x10, obj] normalized
            cols = torch.cat([dets[..., :4], dets[..., 5:15], dets[..., 4:5]],
                             -1)
            return cols / scale, valid

        return net, decode

    return build


for _arch in ("yolov5s", "yolov5m", "yolov5l", "yolov5n", "yolov5n-0.5",
              "yolov5s6", "yolov5m6", "yolov5l6", "yolov5n6"):
    register(DetectorSpec(
        name=_arch,
        input_size=(640, 640),
        preprocess=P.YOLOV5_FACE,
        n_landmark_cols=10,
        build=_build_yolov5(_arch, (640, 640)),
        rect_stride=64 if _arch.endswith("6") else 32,
        quantizable=True,
        bf16=True,
    ))


# ---------------- official (multiclass) yolov5 ----------------


def _build_yolov5_official(arch: str, input_size):
    def build(generator: torch.Generator, device: torch.device,
              dtype: torch.dtype = torch.float32, **kw):
        kw.setdefault("input_size", input_size)
        kw.setdefault("nc", 80)            # COCO classes
        kw.setdefault("conf_thres", 0.4)   # the reference's official call
        kw.setdefault("iou_thres", 0.5)
        cfg = YoloV5FaceConfig(arch=arch, **kw)
        check_kernel_choice(cfg.pallas_nms, device, "pallas_nms")
        net = YoloV5FaceNet(arch, cfg.nc, with_landmarks=False) \
            .init_random_(generator)
        net = net.to(device=device, memory_format=torch.channels_last).eval()
        set_compute_dtype(net, dtype)
        strides = ARCHS[arch]["strides"]

        def decode(maps, in_hw: Tuple[int, int]):
            ih, iw = in_hw
            scale = torch.tensor([iw, ih, iw, ih, 1.0], dtype=torch.float32,
                                 device=maps[0].device)
            dets, valid = yolov5_official_detect_maps(
                maps, OFFICIAL_ANCHORS, strides, cfg)
            # [xyxy, conf, cls] pixels -> [xyxy, conf] normalized: the
            # reference wrapper keeps 5 columns
            return dets[..., :5] / scale, valid

        return net, decode

    return build


for _arch in ("yolov5s", "yolov5n"):
    register(DetectorSpec(
        name=f"{_arch}-official",
        input_size=(640, 640),
        preprocess=P.YOLOV5_FACE,
        n_landmark_cols=0,
        build=_build_yolov5_official(_arch, (640, 640)),
        rect_stride=32,
        bf16=True,
    ))


# ---------------- blazeface ----------------


def _build_blazeface(back: bool):
    def build(generator: torch.Generator, device: torch.device, **kw):
        if kw.pop("input_size", None) is not None:
            raise ValueError(
                "blazeface input size is fixed by the architecture "
                "(front 128x128 / back 256x256)")
        # detections come out normalized, in the 17-column contract
        return make_blazeface(BlazeFaceConfig(back_model=back, **kw),
                              generator, device)

    return build


register(DetectorSpec("blazeface-front", (128, 128), P.BLAZEFACE_FRONT, 12,
                      _build_blazeface(False)))
register(DetectorSpec("blazeface-back", (256, 256), P.BLAZEFACE_BACK, 12,
                      _build_blazeface(True)))


# ---------------- SSD family (OpenCV-DNN / OpenVINO class) ----------------


def _build_ssd(backbone: str, input_size):
    def build(generator: torch.Generator, device: torch.device, **kw):
        kw.setdefault("input_size", input_size)
        return make_ssd_face(SSDConfig(backbone=backbone, **kw), generator,
                             device)

    return build


register(DetectorSpec("ssd-resnet10", (300, 300), P.OPENCV_SSD, 0,
                      _build_ssd("resnet10", (300, 300)),
                      import_pb=import_graphdef_structural))
register(DetectorSpec("ssd-mobilenetv2", (448, 448),
                      dataclasses.replace(P.OPENCV_SSD, size=(448, 448)), 0,
                      _build_ssd("mobilenetv2", (448, 448)),
                      import_pb=import_graphdef_structural))
register(DetectorSpec("ssd-squeezenet", (300, 300), P.OPENCV_SSD, 0,
                      _build_ssd("squeezenet", (300, 300)),
                      import_pb=import_graphdef_structural))


def _build_res10(generator: torch.Generator, device: torch.device, **kw):
    if kw.pop("input_size", None) not in (None, (300, 300)):
        raise ValueError("res10 runs the fixed 300x300 deploy graph")
    return build_res10(generator, device)


# the exact public res10_300x300 deploy graph (models/res10.py): the import
# target of OpenCV's res10_300x300_ssd_iter_140000.caffemodel and its
# opencv_face_detector_uint8.pb (the reference's opencv2_dnn/model.py:21,
# 30-32); ssd-resnet10 above is the trainable twin of its class
register(DetectorSpec("res10-ssd", (300, 300), P.OPENCV_SSD, 0, _build_res10,
                      import_caffemodel=import_res10_caffemodel,
                      import_pb=import_res10_graphdef))


# ---------------- OpenVINO IR nets ----------------


def _build_ov_ir(generator: torch.Generator, device: torch.device, **kw):
    """The IR named by ``xml`` (``bin``: the sibling .bin by default);
    its input size is the IR's own."""
    from ..utils.ir_graph import parse_ir_graph

    xml = kw.pop("xml", None)
    kw.pop("input_size", None)  # the size comes from the IR itself
    if xml is None:
        raise ValueError(
            "detector='openvino-ir' executes a REAL IR: pass "
            "detector_overrides={'xml': 'model.xml'} (bin defaults to "
            "the sibling .bin)")
    bin_path = kw.pop("bin", os.path.splitext(xml)[0] + ".bin")
    net = OVGraphNet(parse_ir_graph(xml, bin_path)).to(device).eval()
    return net, make_ov_detect(net)


def _build_ov_topology(topology: str):
    def build(generator: torch.Generator, device: torch.device, **kw):
        kw.pop("input_size", None)  # the size comes from the topology
        # the He-init constants are the topology's, from a seed drawn
        # from the engine's generator
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        net = OVGraphNet(build_ov_topology(topology, seed=seed))
        net = net.to(device).eval()
        return net, make_ov_detect(net)

    return build


# any real OpenVINO detector IR (face-detection-0204, SqueezeNet-light, ...:
# the reference's modules/openvino/model.py loads any model.xml this way);
# the engine sizes its preprocess to the IR's Parameter
register(DetectorSpec("openvino-ir", (448, 448), P.OPENVINO, 0, _build_ov_ir,
                      import_caffemodel=None, import_xml=import_ir_net))
# the reference's two IR topologies (models/ov_topologies.py)
register(DetectorSpec("ov-0204", (448, 448), P.OPENVINO, 0,
                      _build_ov_topology("ov-0204"),
                      import_caffemodel=None, import_xml=import_ir_net))
register(DetectorSpec("ov-squeezenet-light", (300, 300),
                      dataclasses.replace(P.OPENVINO, size=(300, 300)), 0,
                      _build_ov_topology("ov-squeezenet-light"),
                      import_caffemodel=None, import_xml=import_ir_net))


# ---------------- MTCNN ----------------


def _build_mtcnn(generator: torch.Generator, device: torch.device, **kw):
    if kw.pop("input_size", None) is not None:
        raise ValueError("mtcnn runs at native image resolution")
    return make_mtcnn(MTCNNConfig(**kw), generator, device)


register(DetectorSpec(
    name="mtcnn",
    input_size=(-1, -1),  # native resolution
    preprocess=P.PreprocessSpec(size=None, resize="none"),
    n_landmark_cols=10,
    build=_build_mtcnn,
    import_caffemodel=None,
    import_pb=import_mtcnn_graphdef,
))
