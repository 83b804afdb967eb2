"""gRPC front door: the reference's cross-process serving boundary.

The counterpart of ``serving/grpc_server.py`` in the JAX package, with
generic method handlers and identity byte serializers (no generated stubs):
JPEG bytes in, JSON bytes out, call parameters in gRPC metadata. Images are
decoded by the port's JPEG codec (``utils/native.py``). ``grpc`` is imported
inside the functions that use it, so the module imports without it.

Service ``fdrt.FaceService``:
  /fdrt.FaceService/Health  ()        -> {"ready": true}
  /fdrt.FaceService/Detect  (jpeg)    -> {"num_faces", "bboxes", "confs"}
        metadata: det-thres, bbox-area-thres (optional floats)
  /fdrt.FaceService/DetectEmbedClassify (jpeg)
        -> {"bboxes", "confs", "embeddings", "labels"}
"""
from __future__ import annotations

import json
from concurrent import futures
from typing import Optional, Tuple

import numpy as np

from ..utils.native import decode_jpeg_bgr
from .http_server import _args
from .service import FaceService, ServiceConfig


def _ident(b: bytes) -> bytes:  # identity (de)serializer: raw bytes
    return b


def _thresholds(context) -> Tuple[Optional[float], Optional[float]]:
    md = {k: v for k, v in context.invocation_metadata()}
    dt = md.get("det-thres")
    at = md.get("bbox-area-thres")
    return (float(dt) if dt is not None else None,
            float(at) if at is not None else None)


def make_grpc_server(service: FaceService, host: str = "0.0.0.0",
                     port: int = 8081, max_workers: int = 8):
    """Build (not start) a grpc.Server bound to ``service``."""
    import grpc

    def image(request: bytes, context):
        img = decode_jpeg_bgr(request)
        if img is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "request body is not a decodable image")
        return img

    def health(request: bytes, context) -> bytes:
        return json.dumps({"ready": True}).encode()

    def detect(request: bytes, context) -> bytes:
        img = image(request, context)
        try:
            dt, at = _thresholds(context)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"bad threshold: {e}")
        faces, bboxes, confs = service.detect_faces(img, dt, at)
        return json.dumps({
            "num_faces": int(faces.shape[0]),
            "bboxes": np.asarray(bboxes).tolist(),
            "confs": np.asarray(confs).reshape(-1).tolist(),
        }).encode()

    def detect_embed_classify(request: bytes, context) -> bytes:
        out = service.detect_embed_classify(image(request, context))
        return json.dumps({
            "bboxes": np.asarray(out["bboxes"]).tolist(),
            "confs": np.asarray(out["confs"]).reshape(-1).tolist(),
            "embeddings": np.asarray(out["embeddings"]).tolist(),
            "labels": list(out["labels"]),
        }).encode()

    def handler(fn):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=_ident, response_serializer=_ident)

    handlers = {"Health": handler(health), "Detect": handler(detect),
                "DetectEmbedClassify": handler(detect_embed_classify)}
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler("fdrt.FaceService", handlers),
    ))
    server.add_insecure_port(f"{host}:{port}")
    return server


def serve_grpc(cfg: ServiceConfig = None, host: str = "0.0.0.0",
               port: int = 8081, block: bool = True,
               dynamic_batching: int = 0, warmup_shapes=((576, 1024),)):
    """Build, probe and warm the service, then start the gRPC server.
    ``block=False`` returns the started server, with the service as its
    ``service``: call ``stop(None)`` and ``service.close()`` when done."""
    service = FaceService(cfg or ServiceConfig())
    service.ready()
    if warmup_shapes:
        service.warmup(shapes=warmup_shapes)
    if dynamic_batching:
        service.enable_dynamic_batching(max_batch=dynamic_batching)
    server = make_grpc_server(service, host, port)
    server.service = service
    server.start()
    if block:
        try:
            server.wait_for_termination()
        finally:
            service.close()
    return server


# ---- client side (the reference's Triton client slot) ----


def grpc_call(addr: str, method: str, payload: bytes = b"",
              metadata=None) -> bytes:
    import grpc

    with grpc.insecure_channel(addr) as channel:
        fn = channel.unary_unary(f"/fdrt.FaceService/{method}",
                                 request_serializer=_ident,
                                 response_deserializer=_ident)
        return fn(payload, metadata=metadata)


def grpc_detect(addr: str, jpeg_bytes: bytes,
                det_thres: float = None, bbox_area_thres: float = None):
    """JPEG bytes -> dict with num_faces/bboxes/confs."""
    md = []
    if det_thres is not None:
        md.append(("det-thres", str(det_thres)))
    if bbox_area_thres is not None:
        md.append(("bbox-area-thres", str(bbox_area_thres)))
    return json.loads(grpc_call(addr, "Detect", jpeg_bytes, md or None))


if __name__ == "__main__":
    _cfg, _a = _args()
    serve_grpc(_cfg, host=_a.host, port=_a.port,
               dynamic_batching=_a.dynamic_batch)
