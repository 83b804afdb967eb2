"""Detector registry: one uniform build-and-detect interface.

The counterpart of ``models/registry.py`` in the JAX package, with the
detectors this port has so far (yolov5s, yolov5n, yolov5n-0.5,
blazeface-front, blazeface-back). ``build``
returns the network and ``detect(imgs) -> (dets, valid)``, with detections
in the normalized contract: rows [xmin, ymin, xmax, ymax, (lmk xy
pairs...), conf] in [0, 1] wrt the model input size.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from ..ops import preprocess as P
from .blazeface import BlazeFaceConfig, make_blazeface
from .yolov5_face import (ARCHS, YoloV5FaceConfig, YoloV5FaceNet,
                          yolov5_face_detect_maps)


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """A detector registry entry.

    build(generator, device, **overrides) -> (net, decode) where net(imgs
    [B, h, w, 3] preprocessed) gives the raw heads and decode(raw, (h, w))
    returns (dets [B, K, 4+L+1] NORMALIZED to the input size, valid [B, K]).
    """

    name: str
    input_size: Tuple[int, int]  # (width, height)
    preprocess: P.PreprocessSpec
    build: Callable
    # detect() accepts any input whose sides are a multiple of this stride
    # (rect letterbox); input_size stays the box rect shapes fit in
    rect_stride: int = 0


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


def _build_yolov5(arch: str, input_size):
    def build(generator: torch.Generator, device: torch.device, **kw):
        kw.setdefault("input_size", input_size)
        cfg = YoloV5FaceConfig(arch=arch, **kw)
        net = YoloV5FaceNet(arch, cfg.nc).init_random_(generator)
        net = net.to(device=device, memory_format=torch.channels_last).eval()
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


for _arch in ("yolov5s", "yolov5n", "yolov5n-0.5"):
    register(DetectorSpec(
        name=_arch,
        input_size=(640, 640),
        preprocess=P.YOLOV5_FACE,
        build=_build_yolov5(_arch, (640, 640)),
        rect_stride=32,
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


register(DetectorSpec("blazeface-front", (128, 128), P.BLAZEFACE_FRONT,
                      _build_blazeface(False)))
register(DetectorSpec("blazeface-back", (256, 256), P.BLAZEFACE_BACK,
                      _build_blazeface(True)))
