"""BlazeFace (MediaPipe) front and back detectors.

The counterpart of ``models/blazeface.py`` in the JAX package. The modules
carry the reference torch implementation's names (``backbone1.{i}`` /
``backbone2.{i}`` for the front model, ``backbone.{i}`` / ``final`` for the
back one, ``classifier_8`` ... ``regressor_16``), so a reference state dict
loads as it is. Anchors come from the MediaPipe SSD anchor options: both
models have the same 896 unit-sized anchors (16x16 cells x 2 + 8x8 cells x 6).

Decode, score sigmoid, threshold and the weighted-blend NMS run on the
device in one kernel launch, over fixed-size tensors: [B, max_faces, 17]
rows and a validity mask.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import decode_boxes  # re-exported beside the model
from ..ops.cuda_kernels import blaze_decode_blend
from .layers import BlazeBlock, FinalBlazeBlock

_FRONT_BLOCKS = ((24, 1), (28, 1), (32, 2), (36, 1), (42, 1), (48, 2),
                 (56, 1), (64, 1), (72, 1), (80, 1), (88, 1))
_FRONT_BLOCKS2 = ((96, 2), (96, 1), (96, 1), (96, 1), (96, 1))
_BACK_BLOCKS = ([(24, 1)] * 7 + [(24, 2)] + [(24, 1)] * 7 + [(48, 2)]
                + [(48, 1)] * 7 + [(96, 2)] + [(96, 1)] * 7)


def generate_anchors() -> np.ndarray:
    """MediaPipe SSD anchors for both variants: [896, 4] rows of
    [x_center, y_center, w=1, h=1] in normalized units (ssd_anchors options
    num_layers=4, aspect_ratios=[1.0], fixed_anchor_size=True; same-stride
    layers merge into 2 anchors a cell on the 16x16 map, 6 on the 8x8)."""
    anchors = []
    for fm, per_cell in ((16, 2), (8, 6)):
        for y in range(fm):
            for x in range(fm):
                cx, cy = (x + 0.5) / fm, (y + 0.5) / fm
                anchors.extend([[cx, cy, 1.0, 1.0]] * per_cell)
    return np.asarray(anchors, np.float32)


@dataclasses.dataclass(frozen=True)
class BlazeFaceConfig:
    back_model: bool = False
    score_clipping_thresh: float = 100.0
    min_suppression_threshold: float = 0.3
    max_faces: int = 16

    @property
    def input_size(self) -> Tuple[int, int]:
        return (256, 256) if self.back_model else (128, 128)

    @property
    def scale(self) -> float:
        return 256.0 if self.back_model else 128.0

    @property
    def min_score_thresh(self) -> float:
        return 0.65 if self.back_model else 0.75


def _blocks(spec, c_in: int) -> List[nn.Module]:
    out = []
    for c, stride in spec:
        out.append(BlazeBlock(c_in, c, stride=stride))
        c_in = c
    return out


class BlazeFaceNet(nn.Module):
    """Backbone and the two-scale heads. Takes NHWC [B, H, W, 3] images in
    [-1, 1] RGB and returns raw boxes [B, 896, 16] and scores [B, 896, 1],
    the heads flattened in NHWC order (the anchors' order)."""

    def __init__(self, back_model: bool = False):
        super().__init__()
        self.back_model = back_model
        stem = [nn.Conv2d(3, 24, 5, 2, 0, bias=True), nn.ReLU()]
        if back_model:
            self.backbone = nn.Sequential(*stem, *_blocks(_BACK_BLOCKS, 24))
            self.final = FinalBlazeBlock(96)
            c8 = 96
        else:
            self.backbone1 = nn.Sequential(*stem,
                                           *_blocks(_FRONT_BLOCKS, 24))
            self.backbone2 = nn.Sequential(*_blocks(_FRONT_BLOCKS2, 88))
            c8 = 88
        self.classifier_8 = nn.Conv2d(c8, 2, 1, bias=True)
        self.classifier_16 = nn.Conv2d(96, 6, 1, bias=True)
        self.regressor_8 = nn.Conv2d(c8, 32, 1, bias=True)
        self.regressor_16 = nn.Conv2d(96, 96, 1, bias=True)

    def features(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The 16x16 and 8x8 maps the heads read, NCHW."""
        # TFLite-style first-conv padding: 1 before, 2 after
        x = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2))
        if self.back_model:
            x = self.backbone(x)
            return x, self.final(x)
        x = self.backbone1(x)
        return x, self.backbone2(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        c8, c16 = self.features(x)

        def flat(y: torch.Tensor, n: int) -> torch.Tensor:
            return y.permute(0, 2, 3, 1).reshape(b, -1, n)

        scores = torch.cat([flat(self.classifier_8(c8), 1),
                            flat(self.classifier_16(c16), 1)], 1)
        boxes = torch.cat([flat(self.regressor_8(c8), 16),
                           flat(self.regressor_16(c16), 16)], 1)
        return boxes.float(), scores.float()

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator,
                     cfg: BlazeFaceConfig) -> "BlazeFaceNet":
        """Draw every weight from ``generator`` (CPU) and set the heads'
        scale from one batch of uniform(-1, 1) images drawn from it.

        Backbone convs draw from N(0, 2/fan_in), biases 0. The net has no
        normalization, so drawn heads would put nearly every raw score at
        the +-100 clip; instead the classifiers are scaled so their logits
        on the batch spread with standard deviation 2 around
        logit(``min_score_thresh``), and the regressors so boxes come out
        about 0.15 +- 0.05 of the input wide, centred near their anchors.
        Some anchors of a frame then pass the threshold and some do not."""
        heads = (self.classifier_8, self.classifier_16, self.regressor_8,
                 self.regressor_16)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * (2.0 / fan_in) ** 0.5)
                mod.bias.zero_()
        w, h = cfg.input_size
        x = torch.rand((8, h, w, 3), generator=generator) * 2 - 1
        c8, c16 = self.features(x)
        thr = cfg.min_score_thresh
        for head, feat in zip(heads, (c8, c16, c8, c16)):
            y = head(feat)                                 # bias is 0
            if head.out_channels % 16 == 0:                # a regressor
                y = y.reshape(y.shape[0], -1, 16, *y.shape[2:])
                std = y.std(dim=(0, 1, 3, 4))              # per column
                head.weight.mul_((0.05 * cfg.scale / std).repeat(
                    head.out_channels // 16)[:, None, None, None])
                bias = torch.zeros(16)
                bias[2:4] = 0.15 * cfg.scale               # w, h
                head.bias.copy_(bias.repeat(head.out_channels // 16))
            else:
                head.weight.mul_(2.0 / y.std())
                head.bias.fill_(float(np.log(thr / (1 - thr))))
        return self


def blazeface_postprocess(raw_boxes: torch.Tensor, raw_scores: torch.Tensor,
                          anchors: torch.Tensor, cfg: BlazeFaceConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode, clip and sigmoid the scores, threshold, weighted-blend NMS:
    one launch of the fused kernel on the card, its plain chain of torch
    ops on the CPU (``ops/cuda_kernels.blaze_decode_blend``).

    Returns dets [B, max_faces, 17] rows [xmin, ymin, xmax, ymax, kps...,
    conf] (the wrapper contract's column order) and valid [B, max_faces]."""
    return blaze_decode_blend(raw_boxes, raw_scores, anchors, cfg.scale,
                              cfg.score_clipping_thresh, cfg.min_score_thresh,
                              cfg.min_suppression_threshold, cfg.max_faces)


def make_blazeface(cfg: BlazeFaceConfig, generator: torch.Generator,
                   device: torch.device
                   ) -> Tuple[BlazeFaceNet, Callable]:
    """Net (weights from ``generator``, on ``device``, channels-last, eval)
    and ``decode((raw_boxes, raw_scores), in_hw) -> (dets [B, max_faces,
    17] normalized, valid [B, max_faces])``; the net takes [B, H, W, 3]
    RGB in [-1, 1]."""
    net = BlazeFaceNet(cfg.back_model).init_random_(generator, cfg)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    anchors = torch.from_numpy(generate_anchors()).to(device)

    def decode(raw: Tuple[torch.Tensor, torch.Tensor],
               in_hw: Tuple[int, int]):
        # anchors are normalized: the input size does not enter
        return blazeface_postprocess(*raw, anchors, cfg)

    return net, decode
