"""FaceEngine: preprocess -> detector -> postprocess -> crop -> embed /
age-gender over batched NHWC frames.

The counterpart of ``core/engine.py`` in the JAX package: the detect path and
the fused ensemble (``detect_embed_classify_batch``) with its staged entry
points.
That engine compiled one XLA program per source resolution, cached them, and
handed out frozen views of its weights so that a compiled program could
never serve stale ones. PyTorch runs eagerly and reads the module's
parameters on every call, so neither the program cache nor the frozen views
has a counterpart here; weights change through ``load_state_dict``. What
that cache held is still counted (``compiled_pipelines``): each entry point
and input shape the engine has run.

``EngineConfig.dtype`` bfloat16 runs the JAX package's bf16 engine for the
yolov5-face detectors (the official heads included), the five embedder slots
and the age/gender heads: the detector's preprocess in bf16, bf16 nets
(``models/layers.py`` sets out their rounding points), the 227x227
age/gender crops stored in bf16 by the crop kernel; detections, embeddings
and probabilities come out f32. The other detector families raise
``ValueError`` for it (ROADMAP.md A8b).

Any registered detector and embedder slot serves: detections carry the
detector's ``n_landmark_cols`` landmark columns (none for the official
yolov5 heads, the SSD family and the graph interpreters), and each
embedder runs at its own input size. A native-resolution detector (MTCNN)
takes the frames without a preprocess, at their own size; the fused
ensemble refuses it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models import registry
from .config import as_dtype
from ..models.layers import BF16
from ..models.age_gender import labels_from_probs, make_age_gender
from ..models.embedders import get_embedder, preprocess_crops
from ..ops import preprocess as P
from ..ops.crop import crop_and_resize, crop_for_net, pad_boxes
from ..ops.geometry import rect_letterbox_size, resize_bilinear
from ..ops.platform import resolve_device
from ..utils.quantize import quantized_mode
from .detections import Detections, PostProcessedDetection, postprocess_detections

AG_HW = (227, 227)                  # age/gender crop size
AG_PAD = (-5.0, -5.0, 5.0, 5.0)     # the cascade's +-5 px crop padding
TORCH_WEIGHTS = (".pt", ".pth")     # the weight files the loaders read
NET_WEIGHTS = (".caffemodel", ".pb", ".xml")  # read against a net


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch weight file -> a flat state dict: the dict under
    ``state_dict`` or ``model`` when there is one (a pickled module's own
    state dict), with the ``module.`` prefix of a data-parallel save
    stripped. The file is unpickled, which can run code: load only
    trusted files. A ``.caffemodel``, ``.pb`` or OpenVINO ``.xml`` is read
    against a net (``FaceEngine.load_weights``; the CaffeNet caffemodels
    through ``load_age_gender_weights``), not here; orbax checkpoints
    raise ``ValueError``: the port has no orbax reader."""
    ext = os.path.splitext(path)[1].lower()
    if ext in NET_WEIGHTS:
        kind = {".caffemodel": "a Caffe .caffemodel", ".pb": "a frozen .pb",
                ".xml": "an OpenVINO IR (.xml)"}[ext]
        raise ValueError(
            f"{path}: {kind} holds no state dict of its own; "
            "FaceEngine.load_weights (detectors) and "
            "load_age_gender_weights (age/gender caffemodels) read it "
            "against the net")
    if ext not in TORCH_WEIGHTS:
        raise ValueError(
            f"{path}: the port reads torch weight files (.pt, .pth), and "
            ".caffemodel, .pb and .xml through FaceEngine.load_weights; "
            "orbax checkpoints are not supported yet")
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
    """Engine settings, the JAX package's. ``dtype`` is the compute type:
    float32 or bfloat16, in any spelling ``core.config.as_dtype`` reads
    (a JAX ``save_config`` file's "bfloat16" included). A bfloat16 engine
    of a detector family without a bf16 build raises when it is built."""

    detector: str = "yolov5s"
    det_thres: float = 0.70
    bbox_area_thres: float = 0.12
    max_det: int = 64
    embedder: Optional[str] = None          # models.embedders slot | None
    with_age_gender: bool = False
    # rect letterbox inference: each source resolution runs at the smallest
    # stride-multiple canvas its letterbox fits in, instead of the square
    # input_size (576x1024 -> 384x640)
    rect: bool = False
    dtype: Any = torch.float32
    seed: int = 0
    # build-time detector settings: input_size, conf_thres... and, for the
    # yolov5-face family, {"quantized": True | "static"}: the int8 net
    # (utils/quantize.py; Q1 on the card)
    detector_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.dtype = as_dtype(self.dtype)


def _ir_input_size(net) -> Optional[Tuple[int, int]]:
    """(w, h) of a net that names its NCHW input (``input_dims``), else
    None."""
    dims = getattr(net, "input_dims", None)
    return (int(dims[3]), int(dims[2])) if dims and len(dims) == 4 else None


def _full_f32(device: torch.device):
    """cuDNN runs f32 convolutions in TF32 by default; the reference is f32.
    Turn TF32 off for the forward only, leaving every other flag as set. A
    bf16 net's f32 convolutions of bf16 values run under it too, so their
    sums are f32 sums of exact products, as the JAX layer's are."""
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
        if cfg.dtype == BF16 and not self.spec.bf16:
            raise ValueError(
                f"EngineConfig.dtype bfloat16: detector '{self.spec.name}' "
                "runs float32 only in the port; bf16 for the BlazeFace, SSD, "
                "MTCNN, res10 and OpenVINO families is ROADMAP.md A8b")
        generator = torch.Generator().manual_seed(cfg.seed)
        self.net, self._decode = self.spec.build(generator, self.device,
                                                 **self._build_kw())
        # a graph net (an OpenVINO IR) carries its own input size: the
        # preprocess recipe follows the IR's Parameter shape
        size = _ir_input_size(self.net)
        if size and size != self.spec.input_size:
            self.spec = dataclasses.replace(
                self.spec, input_size=size,
                preprocess=dataclasses.replace(self.spec.preprocess,
                                               size=size))
        # each stage draws from its own stream of the seed
        self.embed_spec = self.embed_net = None
        if cfg.embedder is not None:
            self.embed_spec = get_embedder(cfg.embedder)
            self.embed_net = self.embed_spec.build(
                torch.Generator().manual_seed(cfg.seed + 1), self.device,
                dtype=cfg.dtype)
        self.ag_net = None
        if cfg.with_age_gender:
            self.ag_net = make_age_gender(
                torch.Generator().manual_seed(cfg.seed + 2), self.device,
                dtype=cfg.dtype)
        self._pipelines = set()

    def _build_kw(self, **overrides) -> Dict[str, Any]:
        """The detector build's keywords: the overrides, and the dtype for
        a bf16 engine."""
        kw = {**self.cfg.detector_overrides, **overrides}
        if self.cfg.dtype == BF16:
            kw["dtype"] = BF16
        return kw

    @property
    def native_resolution(self) -> bool:
        """A native-resolution detector (MTCNN): no preprocess, the cascade
        runs whole on the frames."""
        return self.spec.input_size == (-1, -1)

    @property
    def compiled_pipelines(self) -> int:
        """How many (entry point, input shape) pairs this engine has run:
        detect at each source resolution, ``detect_raw``, the ensemble at
        each (resolution, crop size, offsets, stages) and ``embed_crops``
        at each crop size. The JAX engine compiled one XLA program for each
        and cached it (``_pipeline_cache``); eager PyTorch compiles
        nothing, so this counts the programs that cache would hold. Weight
        loads do not reset it; an IR ``.xml`` that replaces the net does,
        as the JAX engine drops its programs then."""
        return len(self._pipelines)

    def load_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load detector weights (e.g. from ``utils.weights`` bridge)."""
        self.net.load_state_dict(state_dict)

    def load_embed_state_dict(self, state_dict: Dict[str, torch.Tensor]
                              ) -> None:
        """Load the embedder slot's weights: from ``utils.weights``,
        ``mobile_facenet_state_dict`` (or a reference MobileFaceNet state
        dict), ``facenet_state_dict`` for facenet and facenet-512,
        ``reid_mnv2_state_dict`` for reid-mnv2, ``age_gender_state_dict``
        for demographics."""
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
        """Load detector weights, by the file's extension:

        - ``.pt`` / ``.pth``: a torch state dict (a reference yolov5-face
          or BlazeFace one, or one ``save_weights`` wrote): the port's
          modules carry the reference's names, so it loads as it is, less
          the yolov5 Detect layer's ``anchors`` / ``anchor_grid`` buffers
          (the port keeps its anchors in ``ARCHS``). An int8 yolov5 state
          dict (``utils/quantize.py``: ``kernel_q``, ``wscale``, ``bias``
          and, static, ``ascale`` a ConvBN) rebuilds the net in its mode
          first;
        - ``.caffemodel`` / ``.pb`` / ``.xml`` (with its sibling ``.bin``):
          read against the net by the detector's importer
          (``DetectorSpec.import_caffemodel`` / ``import_pb`` /
          ``import_xml``): a caffemodel's layers, or an SSD's GraphDef or
          an IR's consts, poured slot by slot in execution order
          (``utils.weights.structural_import``); res10's blobs by layer
          name (``pour_blobs``) and its GraphDef through
          ``convert_res10_graphdef``; the blaueck MTCNN cascade's GraphDef
          (``convert_mtcnn_graphdef``). An OpenVINO IR net's ``.xml`` is
          the net: its importer builds it anew, and the engine runs it
          from then on (an IR of another input size raises ``ValueError``:
          the engine's preprocess is sized at build). A detector without
          an importer for the file raises ``ValueError``.

        Other formats raise ``ValueError`` (``read_state_dict``)."""
        ext = os.path.splitext(path)[1].lower()
        if ext in NET_WEIGHTS:
            importer = {".caffemodel": self.spec.import_caffemodel,
                        ".pb": self.spec.import_pb,
                        ".xml": self.spec.import_xml}[ext]
            if importer is None:
                raise ValueError(f"{path}: no {ext} importer for detector "
                                 f"'{self.spec.name}'")
            out = importer(path, self.net, self.spec.input_size)
            if isinstance(out, tuple):  # the file is the net
                self._replace_net(path, *out)
                return
            sd = out
        else:
            sd = {k: v for k, v in read_state_dict(path).items()
                  if not k.endswith((".anchors", ".anchor_grid"))}
            self._match_quantized(path, quantized_mode(sd))
        self.net.load_state_dict(sd)

    def _match_quantized(self, path: str, mode) -> None:
        """Rebuild the detector net in the int8 mode of the weight file
        (``mode``: False, True or "static", ``utils.quantize.
        quantized_mode``) when it is not the net's: an int8 ``.pt`` serves
        through the same entry points (the CLI's ``--ckpt``,
        ``ServiceConfig.ckpt``). A detector without an int8 build raises
        ``ValueError`` for an int8 file."""
        if mode == getattr(self.net, "quantized", False):
            return
        if not self.spec.quantizable:
            raise ValueError(f"{path}: int8 weights, and detector "
                             f"'{self.spec.name}' has no int8 build")
        self.net, self._decode = self.spec.build(
            torch.Generator().manual_seed(self.cfg.seed), self.device,
            **self._build_kw(quantized=mode))
        self._pipelines.clear()

    def _replace_net(self, path: str, net, decode: Callable) -> None:
        """Run ``net`` and its ``decode`` from now on, in place of the
        detector the engine was built with; the input shapes run so far
        are forgotten (the JAX engine drops its compiled programs)."""
        size = _ir_input_size(net)
        if size and size != self.spec.input_size:
            raise ValueError(
                f"{path}: the IR takes {size[0]}x{size[1]} input, the engine "
                f"was built for {self.spec.input_size[0]}x"
                f"{self.spec.input_size[1]}; build an engine for it "
                "(detector_overrides={'xml': ...})")
        self.net, self._decode = net, decode
        self._pipelines.clear()

    def save_weights(self, path: str) -> None:
        """Save the detector's state dict with ``torch.save``; reloadable
        with ``load_weights`` (and by the JAX engine's ``.pt`` reader)."""
        torch.save(self.net.state_dict(), path)

    def load_embed_weights(self, path: str) -> None:
        """Load the embedder slot's weights, by the artifact's kind:

        - a directory holding ``saved_model.pb``: a keras FaceNet
          SavedModel, the similar-face filter's model
          (``filter_faces_using_reference.py:131``), its variables read
          without TensorFlow from the TensorBundle
          (``utils/tensor_bundle.py``);
        - ``.h5``: a keras FaceNet HDF5 file (``h5py`` is needed for it);
        - anything else: a torch weight file (a reference MobileFaceNet
          state dict, or any slot's state dict that
          ``load_embed_state_dict`` takes, saved with ``torch.save``).

        The keras files pour into the slot's net in execution order
        (``utils.weights.convert_facenet_keras``): the facenet and
        facenet-512 slots."""
        if self.embed_net is None:
            raise ValueError("engine built without an embedder")
        from ..utils import weights as W

        if os.path.isdir(path) and os.path.exists(
                os.path.join(path, "saved_model.pb")):
            from ..utils.tensor_bundle import read_tensor_bundle

            stream = W.keras_bundle_stream(read_tensor_bundle(
                os.path.join(path, "variables", "variables")))
            sd = W.convert_facenet_keras(stream, self.embed_net)
        elif os.path.splitext(path)[1].lower() == ".h5":
            sd = W.convert_facenet_keras(W.read_keras_h5_stream(path),
                                         self.embed_net)
        else:
            sd = read_state_dict(path)
        self.embed_net.load_state_dict(sd)

    def load_age_gender_weights(self, path: str = None,
                                age_caffemodel: str = None,
                                gender_caffemodel: str = None) -> None:
        """Load both age/gender heads: from ``path``, a torch weight file of
        the port's ``AgeGenderNet`` (``age.*``, ``gender.*``), or from the
        reference's two ``.caffemodel`` files (age_net.caffemodel /
        gender_net.caffemodel, ``modules/opencv2_dnn/model.py:49-83``)."""
        if self.ag_net is None:
            raise ValueError("engine built without age/gender heads "
                             "(with_age_gender=True)")
        if path is not None:
            self.ag_net.load_state_dict(read_state_dict(path))
            return
        from ..utils import model_formats as MF
        from ..utils import weights as W

        sd = {}
        for head, file, n in (("age", age_caffemodel, 8),
                              ("gender", gender_caffemodel, 2)):
            if file is None:
                raise ValueError("pass path, or both age_caffemodel and "
                                 "gender_caffemodel")
            for k, v in W.convert_caffenet_head(MF.read_caffemodel(file),
                                                num_classes=n).items():
                sd[f"{head}.{k}"] = v
        self.ag_net.load_state_dict(sd)

    @property
    def input_size(self) -> Tuple[int, int]:
        return self.spec.input_size

    # ---------------- the detect stages ----------------

    def _preprocess(self, imgs: torch.Tensor,
                    spec_pre: Optional[P.PreprocessSpec] = None
                    ) -> torch.Tensor:
        """[B, H, W, 3] BGR uint8 frames on the device -> the detector's
        input, by ``spec_pre`` (default: the detector's square recipe), in
        the engine's dtype."""
        return P.apply_preprocess_batch(imgs,
                                        spec_pre or self.spec.preprocess,
                                        self.cfg.dtype)

    def _network(self, x: torch.Tensor):
        """The detector net's raw heads on its preprocessed input (bf16
        heads for a bf16 engine)."""
        with _full_f32(x.device):
            return self.net(x)

    def _detect(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Network, then decode + NMS: (dets [B, K, 4+L+1] normalized to
        the input size, valid [B, K])."""
        return self._decode(self._network(x), tuple(x.shape[1:3]))

    def _cascade(self, frames: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A native-resolution detector on [B, H, W, 3] frames, f32: its
        nets and decode run whole in the registry's decode."""
        with _full_f32(frames.device):
            return self._decode(frames, tuple(frames.shape[1:3]))

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
        ``ops.geometry``. A native-resolution detector takes the frames as
        they are, and its input size is theirs."""
        self._pipelines.add(("detect",) + tuple(shape))
        h, w = shape[:2]
        native = self.native_resolution
        in_size = (w, h) if native else self.spec.input_size
        spec_pre = self.spec.preprocess
        if self.cfg.rect and self.spec.rect_stride and not native:
            in_size = rect_letterbox_size((h, w), self.spec.input_size,
                                          self.spec.rect_stride)
            spec_pre = dataclasses.replace(spec_pre, size=in_size)

        def run(imgs: torch.Tensor, det_thres: float,
                area_thres: float) -> Detections:
            with torch.inference_mode():
                dets, valid = (self._cascade(imgs) if native else
                               self._detect(self._preprocess(imgs, spec_pre)))
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
        self._pipelines.add(("raw",) + tuple(img.shape))
        with torch.inference_mode():
            frames = self._frames(img[None])
            dets, valid = (self._cascade(frames) if self.native_resolution
                           else
                           self._detect(self._preprocess(frames)))
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
                  clip: bool = False,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """227x227 age/gender crops of ``boxes`` padded by +-5 px, BGR mean
        subtracted (``clip``: clipped to [0, 255] first, as the ensemble
        is), both in the crop kernel's store; ``out_dtype`` bfloat16 is the
        bf16 ensemble's store (the clipped crop cast to bf16, then less the
        mean in f32, cast again). Invalid slots hold ``-mean``."""
        h, w = frames.shape[-3:-1]
        return crop_for_net(frames, pad_boxes(boxes, AG_PAD, (w, h)), AG_HW,
                            valid, clip=clip, mean=P.AGE_GENDER.mean,
                            out_dtype=out_dtype)

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
        want_embed / want_ag: skip those stages for this call.
        A native-resolution detector (MTCNN) raises
        ``NotImplementedError``, as in the JAX package: serving takes the
        staged path for it (``FaceService._faces_staged``)."""
        if self.native_resolution:
            raise NotImplementedError(
                "fused ensemble requires a fixed-size detector (got "
                f"native-resolution '{self.spec.name}')")
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
        self._pipelines.add(("ens", tuple(frames.shape[1:]), crop_size,
                             None if embed_offsets is None
                             else tuple(embed_offsets), do_embed, do_ag))
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
                                         clip=True, out_dtype=self.cfg.dtype)
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
        self._pipelines.add(("embed_crops",) + tuple(faces.shape[1:]))
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
