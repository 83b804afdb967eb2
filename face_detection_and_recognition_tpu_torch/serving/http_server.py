"""HTTP front door for FaceService, on the standard library.

The counterpart of ``serving/http_server.py`` in the JAX package, with the
same routes, JSON bodies and 400 cases; images are decoded by the port's
JPEG codec (``utils/native.py``), not cv2.

    GET  /health               -> {"ready": true}
    GET  /stats                -> {"dynamic_batching", "requests",
                                  "dispatches", "compiled_pipelines",
                                  "detector"} as the JAX package answers,
                                  and "kernel_launches": each CUDA
                                  kernel's launch count
    POST /detect   (image/jpeg body, query det_thres/bbox_area_thres)
        -> {"bboxes": [[x1,y1,x2,y2],...], "confs": [...], "num_faces": N}
    POST /ensemble (image/jpeg body)
        -> {"bboxes", "confs", "embeddings", "labels"}

Run: python -m face_detection_and_recognition_tpu_torch.serving.http_server
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..ops import cuda_kernels
from ..utils.native import decode_jpeg_bgr
from .service import FaceService, ServiceConfig


def make_handler(service: FaceService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                self._send(200, {"ready": True})
            elif path == "/stats":
                b = service._batcher
                self._send(200, {
                    "dynamic_batching": b is not None,
                    "requests": getattr(b, "requests", 0),
                    "dispatches": getattr(b, "dispatches", 0),
                    # the (entry point, input shape) pairs the engine has
                    # run: the programs the JAX engine compiles and caches
                    "compiled_pipelines": service.engine.compiled_pipelines,
                    "detector": service.cfg.detector,
                    "kernel_launches": dict(cuda_kernels.LAUNCHES),
                })
            else:
                self._send(404, {"error": "not found"})

        def _read_image(self):
            length = int(self.headers.get("Content-Length", 0))
            return decode_jpeg_bgr(self.rfile.read(length))

        def do_POST(self):
            # a malformed request comes back as a JSON 400, not a dropped
            # connection (the gRPC twin maps these to INVALID_ARGUMENT)
            try:
                url = urlparse(self.path)
                q = parse_qs(url.query)
                img = self._read_image()
                if img is None:
                    self._send(400, {"error": "cannot decode image"})
                    return
                if url.path == "/detect":
                    dt = (float(q["det_thres"][0])
                          if "det_thres" in q else None)
                    at = (float(q["bbox_area_thres"][0])
                          if "bbox_area_thres" in q else None)
                elif url.path != "/ensemble":
                    self._send(404, {"error": "not found"})
                    return
            except (ValueError, KeyError, IndexError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            if url.path == "/detect":
                faces, bboxes, confs = service.detect_faces(img, dt, at)
                self._send(200, {
                    "bboxes": bboxes.tolist(),
                    "confs": confs.ravel().tolist(),
                    "num_faces": int(faces.shape[0]),
                })
            else:
                out = service.detect_embed_classify(img)
                self._send(200, {
                    "bboxes": out["bboxes"].tolist(),
                    "confs": out["confs"].ravel().tolist(),
                    "embeddings": out["embeddings"].tolist(),
                    "labels": out["labels"],
                })

    return Handler


def serve(cfg: ServiceConfig = None, host: str = "0.0.0.0", port: int = 8081,
          block: bool = True, dynamic_batching: int = 0,
          warmup_shapes=((576, 1024),)):
    """Build the service, probe and warm it, and serve HTTP on (host,
    port). ``block=False`` serves from a daemon thread and returns the
    server, with the service as its ``service``: call ``shutdown()``,
    ``server_close()`` and ``service.close()`` when done."""
    service = FaceService(cfg or ServiceConfig())
    service.ready()
    if warmup_shapes:
        service.warmup(shapes=warmup_shapes)
    if dynamic_batching:
        service.enable_dynamic_batching(max_batch=dynamic_batching)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service
    if block:
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
            service.close()
        return httpd
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


def _args(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--detector", default="yolov5s")
    ap.add_argument("--rect", action="store_true",
                    help="rect letterbox inference (yolov5 families)")
    ap.add_argument("--dynamic-batch", type=int, default=0,
                    help="coalesce concurrent requests into batches of N")
    ap.add_argument("--ckpt", default=None,
                    help="detector weights (.pt/.pth state dict)")
    ap.add_argument("--embed-ckpt", default=None)
    ap.add_argument("--ag-ckpt", default=None)
    ap.add_argument("-d", "--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = ServiceConfig(detector=args.detector, rect=args.rect,
                        ckpt=args.ckpt, embed_ckpt=args.embed_ckpt,
                        ag_ckpt=args.ag_ckpt, device=args.device)
    return cfg, args


if __name__ == "__main__":
    _cfg, _a = _args()
    serve(_cfg, host=_a.host, port=_a.port, dynamic_batching=_a.dynamic_batch)
