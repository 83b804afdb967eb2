"""MTCNN P/R/O-Net cascade at native resolution.

The counterpart of ``models/mtcnn.py`` in the JAX package: the reference's
two MTCNN backends (the ``mtcnn`` pip package and the frozen blaueck/tf-mtcnn
graph, ``modules/mtcnn/model.py``, min_size 40, factor 0.7, thresholds
(0.6, 0.7, 0.8)), the standard algorithm of facenet's ``detect_face.py``: an
image pyramid over a fully-convolutional P-Net, then R-Net and O-Net
refinement with per-stage NMS, box regression, square re-centering and
5-point landmarks.

As in the JAX package every stage keeps a fixed top-K proposal block with a
validity mask, so empty levels and stages flow through as masked rows. The
JAX package ran one frame's cascade under ``vmap``; here the batch is a
leading dimension of every stage, so each NMS is one launch of the keep-mask
kernel B1 (``ops.cuda_kernels.nms_fixpoint``) for the whole batch: one a
pyramid level, then the global pass, R-Net's and O-Net's (``min`` mode),
eleven a 576x1024 batch. R-Net's 24x24 and O-Net's 48x48 crops of the
normalized frame are two launches of the crop kernel B3 in zero-pad mode
(``ops.crop.crop_and_resize_padded``): boxes past the frame read zeros.

Top-k picks keep ``jax.lax.top_k``'s order (``ops.nms.top_k``). The box arithmetic rounds as
the JAX package's compiled cascade does, since the truncations after it
turn a last-bit difference into a pixel: each box regression and the
landmark decode ``a * b + c`` is one fused multiply-add, and the division
by a pyramid scale a product with its f32 reciprocal (XLA's rewrites of
those expressions). R-Net and O-Net flatten their last map channels-last, as flax's NHWC reshape does, so the Dense weights
of a flax tree or a TF graph load as they are. Output rows are
[xmin, ymin, xmax, ymax, lmk x/y pairs x5, conf] normalized to the frame.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.crop import crop_and_resize_padded
from ..ops.cuda_kernels import _fma_f32
from ..ops.geometry import resize_bilinear
from ..ops.nms import greedy_nms_mask, sort_by_score, top_k
from ..ops.platform import check_kernel_choice

# crop_method's values (the JAX package's): "pallas" the hand-written crop
# (B3), "gather" and "gemm" (JAX's two exact crops) the plain one, None /
# "auto" by device
CROP_METHODS = {None: None, "auto": None, "pallas": True, "gather": False,
                "gemm": False}


@dataclasses.dataclass(frozen=True)
class MTCNNConfig:
    min_size: int = 40
    factor: float = 0.7
    thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.8)
    max_per_level: int = 128
    max_stage1: int = 256
    max_stage2: int = 128
    max_faces: int = 64
    crop_method: Optional[str] = None  # a key of CROP_METHODS


def check_crop_method(cfg: MTCNNConfig, device) -> None:
    """Validate ``cfg.crop_method`` against the engine's device
    (``ops.platform.check_kernel_choice``): the device alone routes the
    R/O-Net crops through B3's wrapper."""
    if cfg.crop_method not in CROP_METHODS:
        raise ValueError(f"crop_method {cfg.crop_method!r} is not one of "
                         f"{sorted(map(str, CROP_METHODS))}")
    check_kernel_choice(CROP_METHODS[cfg.crop_method], device, "crop_method")


def _ceil_pool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """torch/caffe ceil_mode max pool, as the JAX package pads the edge."""
    return F.max_pool2d(x, k, s, ceil_mode=True)


class PNet(nn.Module):
    """Proposal net: fully convolutional, stride 2, 12 px receptive field.
    NCHW in; (prob [B, 2, h, w], reg [B, 4, h, w]) out."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 10, 3), nn.PReLU(10)
        self.conv2, self.prelu2 = nn.Conv2d(10, 16, 3), nn.PReLU(16)
        self.conv3, self.prelu3 = nn.Conv2d(16, 32, 3), nn.PReLU(32)
        self.prob = nn.Conv2d(32, 2, 1)
        self.reg = nn.Conv2d(32, 4, 1)

    def forward(self, x: torch.Tensor):
        x = _ceil_pool(self.prelu1(self.conv1(x)), 2, 2)
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        return torch.softmax(self.prob(x), 1), self.reg(x)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, H * W * C], flax's NHWC flatten order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class RNet(nn.Module):
    """Refine net: NCHW 24x24 crops -> (prob [N, 2], reg [N, 4])."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 28, 3), nn.PReLU(28)
        self.conv2, self.prelu2 = nn.Conv2d(28, 48, 3), nn.PReLU(48)
        self.conv3, self.prelu3 = nn.Conv2d(48, 64, 2), nn.PReLU(64)
        self.fc, self.prelu4 = nn.Linear(576, 128), nn.PReLU(128)
        self.prob = nn.Linear(128, 2)
        self.reg = nn.Linear(128, 4)

    def forward(self, x: torch.Tensor):
        x = _ceil_pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _ceil_pool(self.prelu2(self.conv2(x)), 3, 2)
        x = self.prelu4(self.fc(_flatten_hwc(self.prelu3(self.conv3(x)))))
        return torch.softmax(self.prob(x), -1), self.reg(x)


class ONet(nn.Module):
    """Output net: NCHW 48x48 crops -> (prob [N, 2], reg [N, 4],
    landmarks [N, 10])."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = nn.Conv2d(3, 32, 3), nn.PReLU(32)
        self.conv2, self.prelu2 = nn.Conv2d(32, 64, 3), nn.PReLU(64)
        self.conv3, self.prelu3 = nn.Conv2d(64, 64, 3), nn.PReLU(64)
        self.conv4, self.prelu4 = nn.Conv2d(64, 128, 2), nn.PReLU(128)
        self.fc, self.prelu5 = nn.Linear(1152, 256), nn.PReLU(256)
        self.prob = nn.Linear(256, 2)
        self.reg = nn.Linear(256, 4)
        self.lmk = nn.Linear(256, 10)

    def forward(self, x: torch.Tensor):
        x = _ceil_pool(self.prelu1(self.conv1(x)), 3, 2)
        x = _ceil_pool(self.prelu2(self.conv2(x)), 3, 2)
        x = _ceil_pool(self.prelu3(self.conv3(x)), 2, 2)
        x = self.prelu5(self.fc(_flatten_hwc(self.prelu4(self.conv4(x)))))
        return torch.softmax(self.prob(x), -1), self.reg(x), self.lmk(x)


def pyramid_scales(h: int, w: int, min_size: int, factor: float
                   ) -> List[float]:
    """Static pyramid: scale_0 = 12/min_size, times ``factor`` while the
    scaled short side still fits a 12 px P-Net window."""
    scales = []
    m = 12.0 / min_size
    minl = min(h, w) * m
    while minl >= 12.0:
        scales.append(m)
        m *= factor
        minl *= factor
    return scales


def _rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Square boxes around their centre (facenet rerec)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    m = torch.maximum(w, h)
    cx = boxes[..., 0] + w * 0.5
    cy = boxes[..., 1] + h * 0.5
    return torch.stack([cx - m * 0.5, cy - m * 0.5, cx + m * 0.5,
                        cy + m * 0.5], -1)


def _regress(boxes: torch.Tensor, reg: torch.Tensor, w: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """``boxes + reg * [w, h, w, h]``, each coordinate rounded once."""
    wh = torch.stack([w, h, w, h], -1)
    return _fma_f32(reg.contiguous(), wh, boxes.contiguous())


def _bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Box regression with the classic +1 width convention (facenet
    bbreg)."""
    return _regress(boxes, reg, boxes[..., 2] - boxes[..., 0] + 1.0,
                    boxes[..., 3] - boxes[..., 1] + 1.0)


class MTCNN(nn.Module):
    """The cascade's three nets (``pnet``, ``rnet``, ``onet``) and
    ``detect``, the whole cascade over a batch of frames."""

    def __init__(self, cfg: MTCNNConfig = MTCNNConfig()):
        super().__init__()
        self.cfg = cfg
        self.pnet, self.rnet, self.onet = PNet(), RNet(), ONet()

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "MTCNN":
        """Conv and Dense weights from N(0, 1/fan_in) drawn from
        ``generator`` (CPU), biases 0, PReLU slopes 0.25 (flax's
        initializers' scales)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * fan_in ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.PReLU):
                mod.weight.fill_(0.25)
        return self.eval()

    def detect(self, imgs: torch.Tensor, trace: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """imgs: [B, H, W, 3] BGR (uint8 or float) at native resolution.
        Returns (dets [B, max_faces, 15] normalized, valid [B, max_faces]).
        ``trace``, when given, receives each stage's (boxes, valid) and its
        milliseconds (the device synchronized at each stage's end)."""
        cfg = self.cfg
        t1, t2, t3 = cfg.thresholds
        b, h, w = imgs.shape[:3]
        dev = imgs.device
        stamp = [time.perf_counter()]

        def mark(name: str, boxes: torch.Tensor, valid: torch.Tensor):
            if trace is None:
                return
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            trace[name] = dict(boxes=boxes, valid=valid,
                               ms=(now - stamp[0]) * 1e3)
            stamp[0] = now

        # MTCNN reads RGB, normalized (x - 127.5) / 128
        norm = (imgs.float().flip(-1) - 127.5) * 0.0078125

        # ---- stage 1: P-Net over the pyramid ----
        lv_boxes, lv_scores, lv_regs, lv_valid = [], [], [], []
        for scale in pyramid_scales(h, w, cfg.min_size, cfg.factor):
            sh, sw = int(math.ceil(h * scale)), int(math.ceil(w * scale))
            resized = resize_bilinear(norm, (sh, sw))
            prob, reg = self.pnet(resized.permute(0, 3, 1, 2))
            score = prob[:, 1]                                # [B, oh, ow]
            ow = score.shape[-1]
            top, idx = top_k(score.reshape(b, -1), cfg.max_per_level)
            row = (idx // ow).float()
            col = (idx % ow).float()
            # generateBoundingBox: stride 2, cell 12, +1 origin, truncated;
            # x / scale as x * (1 / scale) in f32, the product XLA makes of
            # a division by a constant
            r = 1.0 / torch.tensor(scale, dtype=torch.float32, device=dev)
            boxes = torch.stack([torch.trunc((2.0 * col + 1.0) * r),
                                 torch.trunc((2.0 * row + 1.0) * r),
                                 torch.trunc((2.0 * col + 12.0) * r),
                                 torch.trunc((2.0 * row + 12.0) * r)], -1)
            # per-level NMS 0.5 union (facenet's +1 px IoU)
            keep = greedy_nms_mask(boxes, top, top > t1, 0.5, plus1=True)
            regs = reg.permute(0, 2, 3, 1).reshape(b, -1, 4)
            lv_boxes.append(boxes)
            lv_scores.append(top)
            lv_regs.append(torch.take_along_dim(regs, idx[..., None], 1))
            lv_valid.append(keep)
        if not lv_boxes:
            return (torch.zeros((b, cfg.max_faces, 15), device=dev),
                    torch.zeros((b, cfg.max_faces), dtype=torch.bool,
                                device=dev))
        boxes = torch.cat(lv_boxes, 1)
        scores = torch.cat(lv_scores, 1)
        regs = torch.cat(lv_regs, 1)
        valid = torch.cat(lv_valid, 1)

        # global NMS 0.7 union, the best max_stage1 kept
        keep = greedy_nms_mask(boxes, scores, valid, 0.7, plus1=True)
        _, _, valid, boxes, regs = sort_by_score(scores, keep, boxes, regs,
                                                 top=cfg.max_stage1)
        # stage-1 regression (facenet's w = x2 - x1 here) + rerec
        boxes = torch.trunc(_rerec(_regress(
            boxes, regs, boxes[..., 2] - boxes[..., 0],
            boxes[..., 3] - boxes[..., 1])))
        mark("pnet", boxes, valid)

        # ---- stage 2: R-Net ----
        # facenet's pad() crops img[y-1:ey, x-1:ex] of 1-based boxes: the
        # 0-based region starts at (x1 - 1, y1 - 1)
        shift = torch.tensor([-1.0, -1.0, 0.0, 0.0], device=dev)
        k1 = boxes.shape[1]
        crops = crop_and_resize_padded(norm, boxes + shift, (24, 24), valid)
        prob, reg = self.rnet(crops.reshape(b * k1, 24, 24, 3)
                              .permute(0, 3, 1, 2))
        score = prob[:, 1].reshape(b, k1)
        valid = valid & (score > t2)
        keep = greedy_nms_mask(boxes, score, valid, 0.7, plus1=True)
        boxes = torch.trunc(_rerec(_bbreg(boxes, reg.reshape(b, k1, 4))))
        _, score, valid, boxes = sort_by_score(score, keep, boxes,
                                               top=cfg.max_stage2)
        mark("rnet", boxes, valid)

        # ---- stage 3: O-Net ----
        k2 = boxes.shape[1]
        crops = crop_and_resize_padded(norm, boxes + shift, (48, 48), valid)
        prob, reg, lmk = self.onet(crops.reshape(b * k2, 48, 48, 3)
                                   .permute(0, 3, 1, 2))
        score = prob[:, 1].reshape(b, k2)
        reg, lmk = reg.reshape(b, k2, 4), lmk.reshape(b, k2, 10)
        valid = valid & (score > t3)
        # landmarks decoded BEFORE the regression (facenet's order)
        bw = (boxes[..., 2] - boxes[..., 0] + 1.0)[..., None].expand(-1, -1, 5)
        bh = (boxes[..., 3] - boxes[..., 1] + 1.0)[..., None].expand(-1, -1, 5)
        lx = _fma_f32(bw, lmk[..., 0:5], boxes[..., 0:1].expand(-1, -1, 5)) \
            - 1.0
        ly = _fma_f32(bh, lmk[..., 5:10], boxes[..., 1:2].expand(-1, -1, 5)) \
            - 1.0
        boxes = _bbreg(boxes, reg)
        keep = greedy_nms_mask(boxes, score, valid, 0.7, plus1=True,
                               mode="min")
        # landmarks interleaved [x1, y1, ..., x5, y5], all normalized
        pairs = torch.stack([lx, ly], -1).reshape(b, k2, 10)
        dets = torch.cat([boxes, pairs, score[..., None]], -1)
        dets = dets / torch.tensor([w, h] * 7 + [1], dtype=torch.float32,
                                   device=dev)
        _, _, out_valid, out = sort_by_score(score, keep, dets,
                                             top=cfg.max_faces)
        mark("onet", out, out_valid)
        return out, out_valid


def make_mtcnn(cfg: MTCNNConfig, generator: torch.Generator,
               device: torch.device) -> Tuple[MTCNN, Callable]:
    """The cascade (weights from ``generator``, on ``device``, eval) and
    ``decode(frames [B, H, W, 3] BGR, in_hw) -> (dets [B, max_faces, 15]
    normalized, valid)``: a native-resolution detector runs whole in its
    decode."""
    check_crop_method(cfg, device)
    net = MTCNN(cfg).init_random_(generator).to(device)

    def decode(frames: torch.Tensor, in_hw: Tuple[int, int]):
        return net.detect(frames)

    return net, decode
