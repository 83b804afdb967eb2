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

``EngineConfig.dtype`` bfloat16 runs the JAX package's bf16 engine for
every registered detector, the five embedder slots and the age/gender
heads: the detector's preprocess in bf16 (MTCNN's pyramid), bf16 nets
(``models/layers.py`` and each family's module set out their rounding
points), the 227x227 age/gender crops stored in bf16 by the crop kernel;
detections, embeddings and probabilities come out f32.

Any registered detector and embedder slot serves: detections carry the
detector's ``n_landmark_cols`` landmark columns (none for the official
yolov5 heads, the SSD family and the graph interpreters), and each
embedder runs at its own input size. A native-resolution detector (MTCNN)
takes the frames without a preprocess, at their own size; the fused
ensemble refuses it.
"""
from __future__ import annotations

import copy
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
from ..ops.platform import full_f32 as _full_f32
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
    (a JAX ``save_config`` file's "bfloat16" included)."""

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
        """Preprocess + detect + postprocess for one source resolution
        (``_detect_fn``), run in inference mode. The JAX package compiled
        and cached this per resolution (``_compile_pipeline``); here it
        is a closure, and the resample matrices it needs are cached in
        ``ops.geometry``."""
        self._pipelines.add(("detect",) + tuple(shape))
        detect = self._detect_fn(shape)

        def run(imgs: torch.Tensor, det_thres: float,
                area_thres: float) -> Detections:
            with torch.inference_mode():
                return detect(imgs, det_thres, area_thres)

        return run

    def _detect_fn(self, shape: Tuple[int, int, int]) -> Callable:
        """``(frames, det_thres, area_thres) -> Detections`` for one source
        resolution: a function of tensors with no host read, closed over
        the resolution's geometry (the detect program ``export_ensemble``
        traces). A native-resolution detector takes the frames as they
        are, and its input size is theirs."""
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
            dets, valid = (self._cascade(imgs) if native else
                           self._detect(self._preprocess(imgs, spec_pre)))
            return self._postprocess(dets, valid, (w, h), in_size,
                                     det_thres, area_thres)

        return run

    def _frames(self, imgs) -> torch.Tensor:
        if isinstance(imgs, torch.Tensor):
            return imgs.to(self.device)
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

    # ---------------- over a device mesh ----------------

    def _replica(self, device: torch.device) -> "FaceEngine":
        """This engine with its nets copied to ``device`` (itself when it
        is already there)."""
        from ..parallel.mesh import same_device

        if same_device(device, self.device):
            return self
        other = copy.copy(self)
        other.device = torch.device(device)
        for name in ("net", "embed_net", "ag_net"):
            net = getattr(self, name)
            if net is not None:
                setattr(other, name, copy.deepcopy(net).to(other.device))
        other._pipelines = set()
        return other

    def _on_mesh(self, mesh, imgs, run: Callable) -> Any:
        """``run(engine, frames)`` on each piece of the [B, H, W, 3] batch
        split over the mesh's "data" axis (B must divide it), each on its
        coordinate's device with a replica of the nets; the pieces'
        outputs, every tensor's dim 0 a piece of the batch, are gathered
        whole over "data" on every coordinate, as the JAX package's
        sharded programs return replicated results. Inside, the layers see
        the whole batch (``models.layers.global_batch``): a dynamic int8
        net quantizes every piece with the whole batch's absmax. Returns
        the result on this engine's device."""
        from ..models.layers import global_batch
        from ..parallel import collectives as C
        from ..parallel.sharding import batch_sharding, put_global

        frames = torch.as_tensor(np.ascontiguousarray(imgs)) \
            if not isinstance(imgs, torch.Tensor) else imgs
        pieces = put_global(frames, batch_sharding(mesh, 4))
        engines = {}
        for coord in mesh.local_coords():
            dev = mesh.device(coord)
            if dev not in engines:
                engines[dev] = self._replica(dev)
        shards = mesh.shape["data"]

        def shard(coord):
            with torch.inference_mode(), \
                    global_batch(C.reduce_batch("data"), shards):
                out = run(engines[mesh.device(coord)], pieces[coord])
                return C.gather_batch(out, "data")

        # cuDNN's flags are global: held here, around every shard thread
        with _full_f32(mesh.device(mesh.local_coords()[0])):
            out = C.run_spmd(mesh, shard)[mesh.local_coords()[0]]
        return C.tree_map(lambda t: t.to(self.device), out)

    def detect_batch_sharded(self, imgs: np.ndarray, mesh) -> Detections:
        """Data-parallel ``detect_batch`` over a device mesh
        (``parallel.mesh``): the frame batch splits over the mesh's "data"
        axis (B must divide it), each piece runs the detect path on its
        device, and the Detections come back whole: ``detect_batch`` on
        each piece, a dynamic int8 net quantizing with the whole batch's
        absmax (on the card cuDNN may sum a piece's convolutions otherwise
        than the whole batch's). The config's thresholds apply."""
        return self._on_mesh(mesh, imgs, lambda eng, frames:
                             eng.detect_batch(frames))

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

    def _ensemble_fn(self, shape: Tuple[int, int, int],
                     crop_size: Tuple[int, int],
                     embed_offsets: Optional[Tuple[float, ...]],
                     do_embed: bool, do_ag: bool,
                     skip_slots: bool = True) -> Callable:
        """The fused detect -> crop -> embed -> age/gender program for one
        source resolution: ``(frames, det_thres, area_thres) -> (post,
        crops, embeddings, age_probs, gender_probs)``, a stage left out
        giving None. With ``skip_slots`` the nets and the 227x227 crops run
        on the slots before the last live column alone (``_live_slots``,
        one host read); without, on every slot, masked, with no host read:
        the program ``utils.export.export_ensemble`` traces (the JAX
        engine's ``_build_ensemble`` body). Both give zero rows in the
        invalid slots."""
        self._require_fixed_size()
        h, w = shape[:2]
        detect = self._detect_fn(shape)

        def run(frames: torch.Tensor, det_thres: float, area_thres: float):
            post = detect(frames, det_thres, area_thres)
            bsz, k = post.valid.shape
            crop_boxes = (post.boxes if embed_offsets is None else
                          pad_boxes(post.boxes, tuple(embed_offsets), (w, h)))
            crops = self._face_crops(frames, crop_boxes, crop_size,
                                     post.valid)
            emb = age = gender = None
            if not (do_embed or do_ag):
                return post, crops, emb, age, gender
            k_live = self._live_slots(post.valid) if skip_slots else k
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
            return post, crops, emb, age, gender

        return run

    def _require_fixed_size(self) -> None:
        if self.native_resolution:
            raise NotImplementedError(
                "fused ensemble requires a fixed-size detector (got "
                f"native-resolution '{self.spec.name}')")

    def _default_crop_size(self) -> Tuple[int, int]:
        """(height, width) of the ensemble's raw face crops: the embedder's
        input size, 112x112 with no embedder."""
        if self.embed_spec is None:
            return (112, 112)
        ew, eh = self.embed_spec.input_size
        return (eh, ew)

    def detect_embed_classify_batch(
        self,
        imgs: np.ndarray,
        det_thres: float = None,
        bbox_area_thres: float = None,
        crop_size: Tuple[int, int] = None,
        embed_offsets: Tuple[float, ...] = None,
        mesh=None,
        want_embed: bool = True,
        want_ag: bool = True,
    ) -> EnsembleResult:
        """Detect -> crop -> embed -> age/gender on a [B, H, W, 3] BGR uint8
        batch, every stage on the engine's device (``_ensemble_fn``).

        crop_size: (height, width) of the returned raw face crops; defaults
        to the embedder's input size (112x112 with no embedder).
        embed_offsets: optional per-corner crop offsets applied to the boxes
        before cropping and embedding (the extraction pipelines'
        (-6, -1, +4, +5)); the reported boxes stay as detected.
        mesh: a device mesh (``parallel.mesh``): the batch splits over its
        "data" axis (B must divide it), each piece runs the ensemble on its
        device, and every field comes back whole (``_on_mesh``), as
        ``detect_batch_sharded`` does.
        want_embed / want_ag: skip those stages for this call.
        A native-resolution detector (MTCNN) raises
        ``NotImplementedError``, as in the JAX package: serving takes the
        staged path for it (``FaceService._faces_staged``)."""
        self._require_fixed_size()
        if mesh is not None:
            return self._on_mesh(mesh, imgs, lambda eng, frames:
                                 eng.detect_embed_classify_batch(
                                     frames, det_thres, bbox_area_thres,
                                     crop_size, embed_offsets,
                                     want_embed=want_embed,
                                     want_ag=want_ag))
        crop_size = tuple(crop_size or self._default_crop_size())
        frames = self._frames(imgs)
        shape = tuple(frames.shape[1:])
        dt = self.cfg.det_thres if det_thres is None else det_thres
        at = (self.cfg.bbox_area_thres if bbox_area_thres is None
              else bbox_area_thres)
        do_embed = want_embed and self.embed_net is not None
        do_ag = want_ag and self.ag_net is not None
        offsets = None if embed_offsets is None else tuple(embed_offsets)
        self._pipelines.add(("detect",) + shape)
        self._pipelines.add(("ens", shape, crop_size, offsets, do_embed,
                             do_ag))
        run = self._ensemble_fn(shape, crop_size, offsets, do_embed, do_ag)
        with torch.inference_mode():
            post, crops, emb, age, gender = run(frames, float(dt), float(at))
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
