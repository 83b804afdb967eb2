"""FaceEngine: preprocess -> detector -> postprocess -> crop -> embed /
age-gender over batched NHWC frames.

The counterpart of ``core/engine.py`` in the JAX package: the detect path and
the fused ensemble (``detect_embed_classify_batch``) with its staged entry
points.
That engine compiled one XLA program per source resolution, cached them, and
handed out frozen views of its weights so that a compiled program could
never serve stale ones. PyTorch runs eagerly and reads the module's
parameters on every call, so neither the program cache nor the frozen views
has a counterpart here; weights change through ``load_state_dict``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models import registry
from ..models.age_gender import labels_from_probs, make_age_gender
from ..models.embedders import get_embedder, preprocess_crops
from ..ops import preprocess as P
from ..ops.crop import crop_and_resize, crop_for_net, pad_boxes
from ..ops.geometry import rect_letterbox_size, resize_bilinear
from ..ops.platform import resolve_device
from .detections import Detections, PostProcessedDetection, postprocess_detections

AG_HW = (227, 227)                  # age/gender crop size
AG_PAD = (-5.0, -5.0, 5.0, 5.0)     # the cascade's +-5 px crop padding
TORCH_WEIGHTS = (".pt", ".pth")     # the weight files the loaders read


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch weight file -> a flat state dict: the dict under
    ``state_dict`` or ``model`` when there is one (a pickled module's own
    state dict), with the ``module.`` prefix of a data-parallel save
    stripped. The file is unpickled, which can run code: load only
    trusted files. Orbax checkpoints, ``.caffemodel``, ``.pb`` and
    ``.xml`` raise ``ValueError``: the port has no reader for them yet."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in TORCH_WEIGHTS:
        raise ValueError(
            f"{path}: the port reads torch weight files (.pt, .pth); orbax "
            "checkpoints, .caffemodel, .pb and .xml are not supported yet")
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    if hasattr(sd, "state_dict"):  # a pickled torch Module
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}


@dataclasses.dataclass
class EnsembleResult:
    """Output of ``detect_embed_classify_batch``: fixed-shape [B, K, ...]
    tensors on the engine's device, aligned with ``det.valid``. ``crops``
    are raw-pixel f32 BGR face crops; ``embeddings`` / ``age_probs`` /
    ``gender_probs`` are None when the engine lacks that stage or the call
    did not want it. Rows of invalid slots are zero."""

    det: Detections
    crops: torch.Tensor                          # [B, K, ch, cw, 3]
    embeddings: Optional[torch.Tensor] = None    # [B, K, D]
    age_probs: Optional[torch.Tensor] = None     # [B, K, 8]
    gender_probs: Optional[torch.Tensor] = None  # [B, K, 2]


@dataclasses.dataclass
class EngineConfig:
    """Engine settings, the JAX package's less ``dtype`` (the port runs
    f32)."""

    detector: str = "yolov5s"
    det_thres: float = 0.70
    bbox_area_thres: float = 0.12
    max_det: int = 64
    embedder: Optional[str] = None          # "mobile_facenet" | None
    with_age_gender: bool = False
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
        self.net, self._decode = self.spec.build(generator, self.device,
                                                 **cfg.detector_overrides)
        # each stage draws from its own stream of the seed
        self.embed_spec = self.embed_net = None
        if cfg.embedder is not None:
            self.embed_spec = get_embedder(cfg.embedder)
            self.embed_net = self.embed_spec.build(
                torch.Generator().manual_seed(cfg.seed + 1), self.device)
        self.ag_net = None
        if cfg.with_age_gender:
            self.ag_net = make_age_gender(
                torch.Generator().manual_seed(cfg.seed + 2), self.device)

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load detector weights (e.g. from ``utils.weights`` bridge)."""
        self.net.load_state_dict(state_dict)

    def load_embed_state_dict(self, state_dict: Dict[str, torch.Tensor]
                              ) -> None:
        """Load embedder weights (``utils.weights.mobile_facenet_state_dict``
        or a reference MobileFaceNet state dict)."""
        if self.embed_net is None:
            raise ValueError("engine built without an embedder")
        self.embed_net.load_state_dict(state_dict)

    def load_age_gender_state_dict(self, state_dict: Dict[str, torch.Tensor]
                                   ) -> None:
        """Load both heads (``utils.weights.age_gender_state_dict``)."""
        if self.ag_net is None:
            raise ValueError("engine built without age/gender heads "
                             "(with_age_gender=True)")
        self.ag_net.load_state_dict(state_dict)

    # ---------------- weight files ----------------

    def load_weights(self, path: str) -> None:
        """Load detector weights from a torch weight file (a reference
        yolov5-face or BlazeFace state dict, or one ``save_weights``
        wrote): the port's modules carry the reference's names, so the
        state dict loads as it is, less the yolov5 Detect layer's
        ``anchors`` / ``anchor_grid`` buffers (the port keeps its anchors
        in ``ARCHS``)."""
        sd = read_state_dict(path)
        sd = {k: v for k, v in sd.items()
              if not k.endswith((".anchors", ".anchor_grid"))}
        self.net.load_state_dict(sd)

    def save_weights(self, path: str) -> None:
        """Save the detector's state dict with ``torch.save``; reloadable
        with ``load_weights`` (and by the JAX engine's ``.pt`` reader)."""
        torch.save(self.net.state_dict(), path)

    def load_embed_weights(self, path: str) -> None:
        """Load embedder weights from a torch weight file (a reference
        MobileFaceNet state dict)."""
        if self.embed_net is None:
            raise ValueError("engine built without an embedder")
        self.embed_net.load_state_dict(read_state_dict(path))

    def load_age_gender_weights(self, path: str) -> None:
        """Load both age/gender heads from a torch weight file of the
        port's ``AgeGenderNet`` (``age.*``, ``gender.*``). The reference's
        two ``.caffemodel`` files are not read yet."""
        if self.ag_net is None:
            raise ValueError("engine built without age/gender heads "
                             "(with_age_gender=True)")
        self.ag_net.load_state_dict(read_state_dict(path))

    @property
    def input_size(self) -> Tuple[int, int]:
        return self.spec.input_size

    # ---------------- the detect stages ----------------

    def _preprocess(self, imgs: torch.Tensor,
                    spec_pre: Optional[P.PreprocessSpec] = None
                    ) -> torch.Tensor:
        """[B, H, W, 3] BGR uint8 frames on the device -> the detector's
        input, by ``spec_pre`` (default: the detector's square recipe)."""
        return P.apply_preprocess_batch(imgs,
                                        spec_pre or self.spec.preprocess)

    def _network(self, x: torch.Tensor):
        """The detector net's raw heads on its preprocessed input, f32."""
        with _full_f32(x.device):
            return self.net(x)

    def _detect(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Network, then decode + NMS: (dets [B, K, 4+L+1] normalized to
        the input size, valid [B, K])."""
        return self._decode(self._network(x), tuple(x.shape[1:3]))

    def _postprocess(self, dets: torch.Tensor, valid: torch.Tensor,
                     src_wh: Tuple[int, int], in_size: Tuple[int, int],
                     det_thres: float, area_thres: float) -> Detections:
        """The first ``max_det`` rows, thresholded and mapped back to the
        source frames' pixels."""
        k = self.cfg.max_det
        return postprocess_detections(dets[:, :k], valid[:, :k], src_wh,
                                      in_size, det_thres, area_thres)

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

        def run(imgs: torch.Tensor, det_thres: float,
                area_thres: float) -> Detections:
            with torch.inference_mode():
                dets, valid = self._detect(self._preprocess(imgs, spec_pre))
                return self._postprocess(dets, valid, (w, h), in_size,
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
            dets, valid = self._detect(self._preprocess(
                self._frames(img[None])))
            return dets[0][valid[0]].cpu().numpy()

    # ---------------- the fused ensemble ----------------

    def _embed(self, crops: torch.Tensor) -> torch.Tensor:
        """[N, eh, ew, 3] BGR crops at the embedder's size -> [N, D]."""
        with _full_f32(crops.device):
            return self.embed_net(preprocess_crops(self.embed_spec, crops))

    def _classify(self, crops: torch.Tensor):
        """[N, 227, 227, 3] mean-subtracted BGR crops -> (age, gender)."""
        with _full_f32(crops.device):
            return self.ag_net(crops)

    @staticmethod
    def _face_crops(frames: torch.Tensor, boxes: torch.Tensor,
                    size: Tuple[int, int], valid: torch.Tensor
                    ) -> torch.Tensor:
        """Raw BGR crops [B, K, oh, ow, 3] of the [B, K, 4] boxes, zero in
        the invalid slots. The kernel reads the uint8 frames and writes the
        invalid slots without reading; exact bilinear cannot leave
        [0, 255], so the clip (fused into the kernel's store) is the JAX
        engine's contract, kept."""
        return crop_for_net(frames, boxes, size, valid, clip=True)

    @staticmethod
    def _ag_crops(frames: torch.Tensor, boxes: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  clip: bool = False) -> torch.Tensor:
        """227x227 age/gender crops of ``boxes`` padded by +-5 px, BGR mean
        subtracted (``clip``: clipped to [0, 255] first, as the ensemble
        is), both in the crop kernel's store. Invalid slots hold
        ``-mean``."""
        h, w = frames.shape[-3:-1]
        return crop_for_net(frames, pad_boxes(boxes, AG_PAD, (w, h)), AG_HW,
                            valid, clip=clip, mean=P.AGE_GENDER.mean)

    @staticmethod
    def _live_slots(valid: torch.Tensor) -> int:
        """One past the last slot column valid in any frame (one host
        read). Slot skipping, the counterpart of the JAX engine's lax.cond
        over 4-wide slot columns: every slot at or past it is invalid in
        every frame, so its rows are zero whatever the nets would compute,
        and the nets and the 227x227 crops run on [:, :k_live] alone:
        exact for any validity pattern."""
        live_cols = valid.any(0).nonzero()
        return int(live_cols[-1]) + 1 if len(live_cols) else 0

    def detect_embed_classify_batch(
        self,
        imgs: np.ndarray,
        det_thres: float = None,
        bbox_area_thres: float = None,
        crop_size: Tuple[int, int] = None,
        embed_offsets: Tuple[float, ...] = None,
        want_embed: bool = True,
        want_ag: bool = True,
    ) -> EnsembleResult:
        """Detect -> crop -> embed -> age/gender on a [B, H, W, 3] BGR uint8
        batch, every stage on the engine's device.

        crop_size: (height, width) of the returned raw face crops; defaults
        to the embedder's input size (112x112 with no embedder).
        embed_offsets: optional per-corner crop offsets applied to the boxes
        before cropping and embedding (the extraction pipelines'
        (-6, -1, +4, +5)); the reported boxes stay as detected.
        want_embed / want_ag: skip those stages for this call."""
        if crop_size is None:
            crop_size = (112, 112)
            if self.embed_spec is not None:
                ew, eh = self.embed_spec.input_size
                crop_size = (eh, ew)
        crop_size = tuple(crop_size)
        frames = self._frames(imgs)
        bsz, h, w = frames.shape[:3]
        dt = self.cfg.det_thres if det_thres is None else det_thres
        at = (self.cfg.bbox_area_thres if bbox_area_thres is None
              else bbox_area_thres)
        post = self._pipeline_for(tuple(frames.shape[1:]))(
            frames, float(dt), float(at))
        k = post.valid.shape[1]
        do_embed = want_embed and self.embed_net is not None
        do_ag = want_ag and self.ag_net is not None
        with torch.inference_mode():
            crop_boxes = (post.boxes if embed_offsets is None else
                          pad_boxes(post.boxes, tuple(embed_offsets), (w, h)))
            crops = self._face_crops(frames, crop_boxes, crop_size,
                                     post.valid)
            if not (do_embed or do_ag):
                return EnsembleResult(det=post, crops=crops)
            emb = age = gender = None
            k_live = self._live_slots(post.valid)
            v = post.valid[:, :k_live]
            vf = v.reshape(-1, 1)

            def scatter(rows: torch.Tensor, dim: int) -> torch.Tensor:
                out = crops.new_zeros((bsz, k, dim))
                if k_live:
                    out[:, :k_live] = torch.where(vf, rows, 0.0).reshape(
                        bsz, k_live, dim)
                return out

            if do_embed:
                ew, eh = self.embed_spec.input_size
                e = None
                if k_live:
                    ecrops = (crops[:, :k_live] if (eh, ew) == crop_size
                              else self._face_crops(
                                  frames, crop_boxes[:, :k_live], (eh, ew),
                                  v))
                    e = self._embed(ecrops.reshape(-1, eh, ew, 3))
                emb = scatter(e, self.embed_spec.dim)
            if do_ag:
                a = g = None
                if k_live:
                    agc = self._ag_crops(frames, post.boxes[:, :k_live], v,
                                         clip=True)
                    a, g = self._classify(agc.reshape(-1, *AG_HW, 3))
                age, gender = scatter(a, 8), scatter(g, 2)
        return EnsembleResult(det=post, crops=crops, embeddings=emb,
                              age_probs=age, gender_probs=gender)

    # ---------------- batched crop entry points ----------------

    def embed_crops(self, faces: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] BGR face crops (any same size) -> [N, D]
        embeddings: stretch-resize to the embedder's size, normalize,
        embed."""
        if self.embed_net is None:
            raise RuntimeError("engine built without an embedder")
        spec = self.embed_spec
        if faces.shape[0] == 0:
            return np.zeros((0, spec.dim), np.float32)
        ew, eh = spec.input_size
        with torch.inference_mode():
            x = self._frames(faces).float()
            if tuple(x.shape[1:3]) != (eh, ew):
                x = resize_bilinear(x, (eh, ew))
            return self._embed(x).cpu().numpy()

    def classify_crops_age_gender(self, faces: np.ndarray):
        """[N, H, W, 3] BGR face crops -> (age_probs [N, 8], gender_probs
        [N, 2]), through the ``AGE_GENDER`` recipe (stretch to 227x227,
        BGR mean subtracted)."""
        if self.ag_net is None:
            raise RuntimeError("engine built without age/gender heads")
        if faces.shape[0] == 0:
            return np.zeros((0, 8), np.float32), np.zeros((0, 2), np.float32)
        with torch.inference_mode():
            x = P.apply_preprocess_batch(self._frames(faces), P.AGE_GENDER)
            a, g = self._classify(x)
            return a.cpu().numpy(), g.cpu().numpy()

    def embed_faces(self, img: np.ndarray, boxes: np.ndarray,
                    offsets: Tuple[float, float, float, float] = None
                    ) -> np.ndarray:
        """Crop faces from one BGR frame (optionally offset like the
        reference's extraction crops) -> [N, D] L2-normalized embeddings."""
        if self.embed_net is None:
            raise RuntimeError("engine built without an embedder")
        spec = self.embed_spec
        if len(boxes) == 0:
            return np.zeros((0, spec.dim), np.float32)
        h, w = img.shape[:2]
        ew, eh = spec.input_size
        with torch.inference_mode():
            frame = self._frames(img)
            b = torch.as_tensor(np.asarray(boxes, np.float32),
                                device=self.device)
            if offsets is not None:
                b = pad_boxes(b, tuple(offsets), (w, h))
            crops = crop_and_resize(frame, b, (eh, ew))
            return self._embed(crops).cpu().numpy()

    def detect_and_embed(self, img: np.ndarray):
        """Detections and embeddings of one BGR frame."""
        post = self.detect_image(img)
        dim = self.embed_spec.dim if self.embed_spec else 512
        emb = (self.embed_faces(img, post.boxes) if len(post.boxes)
               else np.zeros((0, dim), np.float32))
        return post, emb

    def detect_age_gender(self, img: np.ndarray) -> PostProcessedDetection:
        """The two-stage cascade on one BGR frame: detect, crop with +-5 px
        padding, classify all faces in one batch, and attach
        'Gender:conf,(age):conf' labels as ``bbox_labels``."""
        if self.ag_net is None:
            raise RuntimeError("engine built without age/gender heads")
        post = self.detect_image(img)
        if len(post.boxes) == 0:
            post.bbox_labels = []
            return post
        with torch.inference_mode():
            crops = self._ag_crops(
                self._frames(img), torch.as_tensor(
                    post.boxes, dtype=torch.float32, device=self.device))
            a, g = self._classify(crops)
        post.bbox_labels = list(labels_from_probs(a.cpu().numpy(),
                                                  g.cpu().numpy()))
        return post
