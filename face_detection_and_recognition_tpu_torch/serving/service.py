"""In-process face service: the Triton ensemble's counterpart.

The counterpart of ``serving/service.py`` in the JAX package. The reference
serves four Triton servers: an ensemble (yolov5s + a python postprocess
returning 112x112 face crops), a facenet embedder and two age/gender heads,
wired over gRPC. Here the ensemble is
``FaceEngine.detect_embed_classify_batch`` on the card in one process, and
``FaceService`` keeps the ensemble's I/O contract: faces [N, 3, 112, 112]
normalized to (-1, 1) CHW, bboxes [N, 4], confs [N, 1], and the
[[0, 0, 0, 0]] no-face sentinel
(``face_detection_trt_server/inference.py:94-98``). The HTTP and gRPC front
doors (``http_server.py``, ``grpc_server.py``) serve it to other processes.

Device-to-host copies follow the JAX service: the validity mask first (a
frame without faces needs nothing else), then one copy of only the valid
rows' crops.

Every engine call runs on one long-lived thread of the service's own.
PyTorch keeps cuDNN's execution plans per thread, so a thread that runs
the nets for the first time builds every convolution's plan again: on an
H100 at 700 W a yolov5s ``detect_faces`` of a 576x1024 frame took 82.7-91.9
ms from a new thread each call against 15.4-19.7 ms through this thread
(``chip_smoke.py``'s serving phase). The HTTP front door starts a thread a
request, so requests hand their engine work to that thread and wait for
it.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core.engine import EngineConfig, FaceEngine
from ..models.age_gender import labels_from_probs
from ..ops.crop import crop_and_resize

NO_FACE_SENTINEL = np.array([[0, 0, 0, 0]], np.float32)


@dataclasses.dataclass
class ServiceConfig:
    detector: str = "yolov5s"
    det_thres: float = 0.70
    bbox_area_thres: float = 0.10
    max_det: int = 32
    face_size: Tuple[int, int] = (112, 112)
    with_embedder: bool = True
    with_age_gender: bool = True
    # data-parallel serving over several cards: not ported yet (ROADMAP
    # A12); anything but None raises
    mesh: object = None
    # rect letterbox inference (yolov5 families): the smallest
    # stride-multiple canvas a source resolution fits in
    rect: bool = False
    # weight files loaded at construction: ckpt through FaceEngine's
    # load_weights (.pt/.pth, .caffemodel, .pb, .xml), the others through
    # load_embed_weights / load_age_gender_weights (.pt/.pth). None =
    # random weights from a seed: fine for shape and speed tests, not for
    # serving
    ckpt: Optional[str] = None
    embed_ckpt: Optional[str] = None
    ag_ckpt: Optional[str] = None
    # None = the card; "cpu" runs on the CPU
    device: Optional[str] = None
    # the engine's compute dtype (EngineConfig.dtype): float32, or
    # bfloat16 for the yolov5 detectors (ROADMAP.md A8)
    dtype: Any = torch.float32


class FaceService:
    """Single-process serving facade over a FaceEngine."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig()):
        if cfg.mesh is not None:
            raise NotImplementedError(
                "ServiceConfig.mesh: serving over several cards is not "
                "ported yet (ROADMAP A12)")
        self.cfg = cfg
        self.engine = FaceEngine(
            EngineConfig(
                detector=cfg.detector,
                det_thres=cfg.det_thres,
                bbox_area_thres=cfg.bbox_area_thres,
                max_det=cfg.max_det,
                embedder="mobile_facenet" if cfg.with_embedder else None,
                with_age_gender=cfg.with_age_gender,
                rect=cfg.rect,
                dtype=cfg.dtype,
            ),
            device=cfg.device,
        )
        if cfg.ckpt:
            self.engine.load_weights(cfg.ckpt)
        if cfg.embed_ckpt:
            self.engine.load_embed_weights(cfg.embed_ckpt)
        if cfg.ag_ckpt:
            self.engine.load_age_gender_weights(cfg.ag_ckpt)
        self._batcher = None
        self._device = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="face-service-device")
        self._device_thread = self._device.submit(threading.get_ident) \
            .result()

    def _on_device(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on the service's engine thread."""
        if threading.get_ident() == self._device_thread:
            return fn(*args, **kwargs)
        return self._device.submit(fn, *args, **kwargs).result()

    def close(self) -> None:
        """Stop the batcher, if any, and the engine thread."""
        if self._batcher is not None:
            self._batcher.shutdown()
            self._batcher = None
        self._device.shutdown(wait=True)

    def ready(self) -> bool:
        """Readiness probe (the reference pings Triton up to 100 times): one
        small detection, which also builds and binds the kernels."""
        self._on_device(self.engine.detect_image,
                        np.zeros((64, 64, 3), np.uint8))
        return True

    def warmup(self, shapes=((576, 1024),), batches=(1,)) -> None:
        """Run the ensemble once at the resolutions production traffic will
        send (Triton's model_warmup), so that the engine thread has built
        cuDNN's plans before the first real request; a native-resolution
        detector (MTCNN) runs ``detect_batch``, its serving path."""
        for h, w in shapes:
            for b in batches:
                img = np.zeros((b, h, w, 3), np.uint8)
                if self.engine.native_resolution:
                    self._on_device(self.engine.detect_batch, img)
                else:
                    self._on_device(
                        self.engine.detect_embed_classify_batch, img,
                        crop_size=self.cfg.face_size,
                        want_embed=False, want_ag=False)

    # ---- dynamic batching (Triton config.pbtxt dynamic_batching) ----

    def enable_dynamic_batching(self, max_batch: int = 8,
                                max_delay_ms: float = 4.0,
                                preferred_batch_sizes=None):
        """Coalesce concurrent ``detect_faces`` calls into shared ensemble
        dispatches (grouped by image shape + thresholds). Returns the
        batcher, whose ``requests`` / ``dispatches`` count the traffic."""
        from .batcher import DynamicBatcher

        def faces(imgs, key):
            _, dt, at = key
            res = self.engine.detect_embed_classify_batch(
                imgs, dt, at, crop_size=self.cfg.face_size,
                want_embed=False, want_ag=False)
            valid_t = res.det.valid
            valid = valid_t.cpu().numpy()
            if not valid.any():
                return [self._contract_tuple(v, None, None) for v in valid]
            posts = res.det.to_numpy()
            rows = res.crops[valid_t].cpu().numpy()  # the valid rows only
            ends = np.cumsum(valid.sum(1))
            return [self._contract_tuple(valid[i], rows[e - n:e], posts[i])
                    for i, (n, e) in enumerate(zip(valid.sum(1), ends))]

        def run_batch(imgs, key):
            return self._on_device(faces, imgs, key)

        if self._batcher is not None:
            self._batcher.shutdown()
        self._batcher = DynamicBatcher(
            run_batch, max_batch=max_batch, max_delay_ms=max_delay_ms,
            preferred_batch_sizes=preferred_batch_sizes)
        return self._batcher

    def _contract_tuple(self, valid_mask, faces_hwc, post):
        """The one home of the ensemble I/O contract (faces CHW in (-1, 1),
        bboxes, confs, or the no-face sentinel), for the unbatched and the
        batched path alike. ``faces_hwc``: the valid rows' raw crops
        [N, h, w, 3] on the host."""
        if not np.asarray(valid_mask).any():
            return (np.zeros((0, 3, *self.cfg.face_size), np.float32),
                    NO_FACE_SENTINEL.copy(), np.zeros((0, 1), np.float32))
        faces = (np.asarray(faces_hwc, np.float32) - 127.5) / 127.5
        return (faces.transpose(0, 3, 1, 2).astype(np.float32),
                np.asarray(post.boxes, np.float32),
                np.asarray(post.bbox_confs, np.float32)[:, None])

    def _faces_out(self, res, i: int):
        """Frame ``i`` of an EnsembleResult as the contract tuple. Copies
        the frame's validity mask first: a frame without faces returns the
        sentinel after that one small copy."""
        v = res.det.valid[i]
        m = v.cpu().numpy()
        if not m.any():
            return self._contract_tuple(m, None, None)
        return self._contract_tuple(m, res.crops[i][v].cpu().numpy(),
                                    res.det.to_numpy()[i])

    # ---- ensemble contract (face_detection_trt_server) ----

    def detect_faces(
        self,
        image_bgr: np.ndarray,
        det_thres: Optional[float] = None,
        bbox_area_thres: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """image -> (faces [N, 3, 112, 112] in (-1, 1) CHW, bboxes [N, 4],
        confs [N, 1]); no faces -> (empty, [[0, 0, 0, 0]], empty), the
        reference's sentinel. Thresholds given here override the config
        for this call. A native-resolution detector (MTCNN) takes the staged
        path (``_faces_staged``), unbatched."""
        if self.engine.native_resolution:
            return self._on_device(self._faces_staged, image_bgr, det_thres,
                                   bbox_area_thres)
        if self._batcher is not None:
            # concurrent callers share one dispatch (Triton
            # dynamic_batching)
            return self._batcher.submit(image_bgr,
                                        key=(det_thres, bbox_area_thres))
        return self._on_device(self._detect_faces, image_bgr, det_thres,
                               bbox_area_thres)

    def _detect_faces(self, image_bgr, det_thres, bbox_area_thres):
        res = self.engine.detect_embed_classify_batch(
            image_bgr[None], det_thres, bbox_area_thres,
            crop_size=self.cfg.face_size,
            want_embed=False, want_ag=False)   # Detect returns crops only
        return self._faces_out(res, 0)

    def _faces_staged(self, image_bgr, det_thres=None, bbox_area_thres=None):
        """The contract tuple for a detector the fused ensemble does not
        take (native-resolution cascades): ``detect_image``, then the boxes
        cropped from the frame and resized to ``face_size``, clamped to the
        frame (the crop kernel B3)."""
        post = self.engine.detect_image(image_bgr, det_thres, bbox_area_thres)
        n = len(post.boxes)
        if not n:
            return self._contract_tuple(np.zeros(1, bool), None, None)
        crops = crop_and_resize(torch.as_tensor(image_bgr).to(self.engine.device),
                                np.asarray(post.boxes, np.float32),
                                self.cfg.face_size)
        return self._contract_tuple(np.ones(n, bool), crops.cpu().numpy(),
                                    post)

    # ---- facenet server contract ----

    def embed(self, faces_bgr: np.ndarray) -> np.ndarray:
        """[N, H, W, 3] BGR face crops -> [N, D] embeddings in one batched
        call (the reference's facenet server takes 160x160 prewhitened
        input; MobileFaceNet takes 112x112 in (-1, 1): the same slot)."""
        if faces_bgr.shape[0] == 0:
            return np.zeros((0, 512), np.float32)
        return self._on_device(self.engine.embed_crops, np.asarray(faces_bgr))

    # ---- age/gender server contract ----

    def age_gender(self, faces_bgr: np.ndarray):
        """[N, H, W, 3] BGR crops -> (age_probs [N, 8], gender_probs [N, 2])
        in one batched call (the reference ran two Triton servers)."""
        return self._on_device(self.engine.classify_crops_age_gender,
                               np.asarray(faces_bgr))

    def detect_embed_classify(self, image_bgr: np.ndarray):
        """The full ensemble in one call: boxes, confs, embeddings and
        age/gender labels of one frame."""
        return self._on_device(self._detect_embed_classify, image_bgr)

    def _detect_embed_classify(self, image_bgr: np.ndarray):
        if self.engine.native_resolution:  # staged (mtcnn)
            return self._staged_embed_classify(image_bgr)
        res = self.engine.detect_embed_classify_batch(image_bgr[None])
        v = res.det.valid[0]
        m = v.cpu().numpy()
        dim = self.engine.embed_spec.dim if self.engine.embed_spec else 512
        if not m.any():
            return {"bboxes": NO_FACE_SENTINEL.copy(),
                    "confs": np.zeros((0, 1), np.float32),
                    "embeddings": np.zeros((0, dim), np.float32),
                    "labels": []}
        post = res.det.to_numpy()[0]
        out = {"bboxes": np.asarray(post.boxes, np.float32),
               "confs": np.asarray(post.bbox_confs, np.float32)[:, None]}
        out["embeddings"] = (res.embeddings[0][v].cpu().numpy()
                             if res.embeddings is not None
                             else np.zeros((int(m.sum()), dim), np.float32))
        out["labels"] = ([] if res.age_probs is None else list(
            labels_from_probs(res.age_probs[0][v].cpu().numpy(),
                              res.gender_probs[0][v].cpu().numpy())))
        return out

    def _staged_embed_classify(self, image_bgr: np.ndarray):
        """``detect_embed_classify`` through the staged crops: the faces
        back in raw pixels, then embedded and classified as crops."""
        faces_chw, bboxes, confs = self._faces_staged(image_bgr)
        if faces_chw.shape[0] == 0:
            return {"bboxes": bboxes, "confs": confs,
                    "embeddings": np.zeros((0, 512), np.float32),
                    "labels": []}
        faces = faces_chw.transpose(0, 2, 3, 1) * 127.5 + 127.5
        out = {"bboxes": bboxes, "confs": confs,
               "embeddings": self.engine.embed_crops(faces)
               if self.engine.embed_net is not None
               else np.zeros((len(bboxes), 512), np.float32)}
        out["labels"] = ([] if self.engine.ag_net is None else list(
            labels_from_probs(*self.engine.classify_crops_age_gender(faces))))
        return out
