"""FaceEngine: preprocess -> detector -> postprocess over batched NHWC frames.

The counterpart of the detect path of ``core/engine.py`` in the JAX package.
That engine compiled one XLA program per source resolution, cached them, and
handed out frozen views of its weights so that a compiled program could
never serve stale ones. PyTorch runs eagerly and reads the module's
parameters on every call, so neither the program cache nor the frozen views
has a counterpart here; weights change through ``load_state_dict``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models import registry
from ..ops import preprocess as P
from ..ops.geometry import rect_letterbox_size
from ..ops.platform import resolve_device
from .detections import Detections, PostProcessedDetection, postprocess_detections


@dataclasses.dataclass
class EngineConfig:
    """Engine settings. The embedder and age/gender stages of the JAX
    package's config arrive with the slice that ports them."""

    detector: str = "yolov5s"
    det_thres: float = 0.70
    bbox_area_thres: float = 0.12
    max_det: int = 64
    # rect letterbox inference: each source resolution runs at the smallest
    # stride-multiple canvas its letterbox fits in, instead of the square
    # input_size (576x1024 -> 384x640)
    rect: bool = False
    seed: int = 0
    detector_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _full_f32(device: torch.device):
    """cuDNN runs f32 convolutions in TF32 by default; the reference is f32.
    Turn TF32 off for the forward only, leaving every other flag as set."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


class FaceEngine:
    """One engine over a registered detector.

    ``device=None`` means the CUDA card, and raises when there is none; pass
    ``device="cpu"`` to run on the CPU. Weights start random, drawn from
    ``cfg.seed``; ``load_state_dict`` replaces them."""

    def __init__(self, cfg: EngineConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = registry.get(cfg.detector)
        # an input_size override must also retarget the preprocess recipe
        ov_size = cfg.detector_overrides.get("input_size")
        if ov_size:
            ov_size = tuple(ov_size)
            self.spec = dataclasses.replace(
                self.spec, input_size=ov_size,
                preprocess=dataclasses.replace(self.spec.preprocess,
                                               size=ov_size))
        generator = torch.Generator().manual_seed(cfg.seed)
        self.net, self._detect = self.spec.build(generator, self.device,
                                                 **cfg.detector_overrides)

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load detector weights (e.g. from ``utils.weights`` bridge)."""
        self.net.load_state_dict(state_dict)

    @property
    def input_size(self) -> Tuple[int, int]:
        return self.spec.input_size

    def _pipeline_for(self, shape: Tuple[int, int, int]) -> Callable:
        """Preprocess + detect + postprocess for one source resolution. The
        JAX package compiled and cached this per resolution
        (``_compile_pipeline``); here it is a closure over the resolution's
        geometry, and the resample matrices it needs are cached in
        ``ops.geometry``."""
        h, w = shape[:2]
        in_size = self.spec.input_size
        spec_pre = self.spec.preprocess
        if self.cfg.rect and self.spec.rect_stride:
            in_size = rect_letterbox_size((h, w), self.spec.input_size,
                                          self.spec.rect_stride)
            spec_pre = dataclasses.replace(spec_pre, size=in_size)
        max_det = self.cfg.max_det

        def run(imgs: torch.Tensor, det_thres: float,
                area_thres: float) -> Detections:
            with torch.inference_mode():
                x = P.apply_preprocess_batch(imgs, spec_pre)
                with _full_f32(imgs.device):
                    dets, valid = self._detect(x)
                return postprocess_detections(
                    dets[:, :max_det], valid[:, :max_det], (w, h), in_size,
                    det_thres, area_thres)

        return run

    def _frames(self, imgs) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(imgs)).to(self.device)

    def detect_batch(self, imgs: np.ndarray, det_thres: float = None,
                     bbox_area_thres: float = None) -> Detections:
        """imgs: [B, H, W, 3] BGR uint8 (one resolution). Returns Detections
        with boxes/landmarks in original pixels, on the engine's device.
        Thresholds given here override the config for this call."""
        run = self._pipeline_for(tuple(imgs.shape[1:]))
        dt = self.cfg.det_thres if det_thres is None else det_thres
        at = (self.cfg.bbox_area_thres if bbox_area_thres is None
              else bbox_area_thres)
        return run(self._frames(imgs), float(dt), float(at))

    def detect_image(self, img: np.ndarray, det_thres: float = None,
                     bbox_area_thres: float = None) -> PostProcessedDetection:
        """Single BGR image -> per-image ragged result."""
        return self.detect_batch(img[None], det_thres,
                                 bbox_area_thres).to_numpy()[0]

    def detect_raw(self, img: np.ndarray) -> np.ndarray:
        """Reference ``Model.__call__`` contract: [N, 4+L+1] normalized to
        the model input size, threshold-unfiltered (conf in last column)."""
        with torch.inference_mode():
            x = P.apply_preprocess_batch(self._frames(img[None]),
                                         self.spec.preprocess)
            with _full_f32(self.device):
                dets, valid = self._detect(x)
            return dets[0][valid[0]].cpu().numpy()
