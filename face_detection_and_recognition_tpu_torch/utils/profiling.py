"""Where the detect, ensemble, BlazeFace and similarity paths' time goes on
the card, for yolov5s and yolov5s6 (and the official head's detect).

    python3 -m face_detection_and_recognition_tpu_torch.utils.profiling

Builds the engines with seeded weights, as ``chip_smoke.py`` does, and for
one batch of 8 seeded 576x1024 frames prints

- the device time of each yolov5s, yolov5s6 and yolov5s-official detect
  stage (frame upload, preprocess, network, candidates-first decode + NMS,
  postprocess), between CUDA events, and for ``decode+nms`` also its
  device time and the device operations (kernels, copies, memsets) it
  launches, from torch.profiler;
- the NMS kernel (B1) alone on the candidates that the detect path hands
  it for these frames, and the boxes it keeps a frame;
- the device time of each ensemble stage (detect, the embedder's crops,
  the embedder, 227x227 crops, the age/gender heads) with every NMS
  survivor live, as ``chip_smoke.py`` drives it: yolov5s + MobileFaceNet
  (112x112) and yolov5s6 + FaceNet (160x160);
- the same stages of each BlazeFace detect (preprocess, network,
  decode + blend NMS, postprocess), back and front; their ``decode+nms``
  is one launch of B5's fused kernel, so its profiler time is the
  kernel's device time and its device operations count 1;
- ``topk_similar`` of 512 queries against a 524,288 x 512 gallery on both
  search paths: the host's normalisation and copy, and the device's search;
- for ``detect_batch`` (yolov5s, BlazeFace back and front) and
  ``detect_embed_classify_batch``, the kernels with the most device time,
  from ``torch.profiler``, and the device's busy and idle share of the
  window.

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import contextlib

import subprocess
import sys
import time

import numpy as np
import torch

from ..core.engine import AG_HW, EngineConfig, FaceEngine
from ..ops.cuda_kernels import nms_fixpoint, topk_gallery
from ..pipelines.similarity import (_f32_matmul, _topk_stable,
                                   normalize_rows, topk_similar)

B, H, W = 8, 576, 1024
ITERS = 20


def cuda_ms(fn, iters: int = ITERS) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls after one
    warm-up, between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(fn, iters: int = ITERS) -> dict:
    """{name: (mean device ms, count a call)} of each kernel, copy or
    memset that ``fn`` puts on the card, from torch.profiler over
    ``iters`` calls after one warm-up. A profiler session that records no
    device operation at all (seen now and then on an H100) is run again,
    up to three sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ops = {e.key: (e.self_device_time_total / e.count / 1e3,
                       round(e.count / iters))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.count}
        if ops:
            return ops
    return {}


def device_ms(fn, iters: int = ITERS):
    """(device milliseconds, device operations) per call of ``fn``: each
    operation's mean self time times its count a call, so that a launch
    whose record the profiler misses lowers no sum. Where no profiler
    session records device time (an H100 has stopped recording for the
    rest of a process), the time between CUDA events stands in and the
    count is None."""
    ops = device_ops(fn, iters).values()
    total_ms = sum(ms * n for ms, n in ops)
    if total_ms <= 0:
        print("torch.profiler recorded no device time: timing between CUDA "
              "events instead", file=sys.stderr, flush=True)
        return cuda_ms(fn, iters), None
    return total_ms, sum(n for _, n in ops)


def detect_stages(eng: FaceEngine, frames: np.ndarray) -> dict:
    """Device milliseconds of each stage of ``eng.detect_batch`` (square
    letterbox, the engine's own thresholds), each timed alone on the same
    inputs through the engine's stage methods."""
    h, w = frames.shape[1:3]
    side = eng.spec.input_size
    dt, at = eng.cfg.det_thres, eng.cfg.bbox_area_thres
    imgs = torch.from_numpy(frames).to(eng.device)
    out = {}
    with torch.inference_mode():
        out["upload"] = cuda_ms(lambda: torch.from_numpy(frames).to(
            eng.device))
        x = eng._preprocess(imgs)
        out["preprocess"] = cuda_ms(lambda: eng._preprocess(imgs))
        raw = eng._network(x)
        out["network"] = cuda_ms(lambda: eng._network(x))
        hw = tuple(x.shape[1:3])
        dets, valid = eng._decode(raw, hw)
        out["decode+nms"] = cuda_ms(lambda: eng._decode(raw, hw))
        out["decode+nms, profiler"], out["decode+nms device ops"] = \
            device_ms(lambda: eng._decode(raw, hw))
        out["postprocess"] = cuda_ms(lambda: eng._postprocess(
            dets, valid, (w, h), side, dt, at))
        out["detect_batch"] = cuda_ms(lambda: eng.detect_batch(frames))
    return out


@contextlib.contextmanager
def spied_calls(targets):
    """Record the (args, kwargs) of every call to each ``(module, name)``
    of ``targets`` while the block runs; the real functions still run,
    and are put back after. Yields {name: calls}."""
    real = {name: getattr(module, name) for module, name in targets}
    seen = {name: [] for name in real}

    def spy(name):
        def call(*args, **kwargs):
            seen[name].append((args, kwargs))
            return real[name](*args, **kwargs)
        return call

    try:
        for module, name in targets:
            setattr(module, name, spy(name))
        yield seen
    finally:
        for module, name in targets:
            setattr(module, name, real[name])


def captured_calls(module, name: str, run) -> list:
    """The (args, kwargs) of every call that ``run()`` makes to
    ``module.name``, which still runs: a spy stands in for it during the
    call, and the real function is put back after."""
    with spied_calls([(module, name)]) as seen, torch.inference_mode():
        run()
    return seen[name]


def detect_nms_inputs(eng: FaceEngine, frames: np.ndarray):
    """(args, kwargs) of the ``nms_fixpoint`` call that the yolov5 decode
    makes in one ``eng.detect_batch(frames)``: the candidates' boxes
    [B, K, 4], their valid mask and the IoU options, as the path hands
    them over."""
    from ..models import yolov5_face

    return captured_calls(yolov5_face, "nms_fixpoint",
                          lambda: eng.detect_batch(frames))[0]


def nms_stage(eng: FaceEngine, frames: np.ndarray) -> dict:
    """B1 alone on the detect path's own candidates: milliseconds between
    CUDA events and of device time, the valid candidates and the kept boxes
    a frame."""
    args, kwargs = detect_nms_inputs(eng, frames)
    with torch.inference_mode():
        keep = nms_fixpoint(*args, **kwargs)
        out = {"nms (B1)": cuda_ms(lambda: nms_fixpoint(*args, **kwargs)),
               "nms (B1), profiler": device_ms(
                   lambda: nms_fixpoint(*args, **kwargs))[0]}
    out["valid a frame"] = args[1].sum(1).tolist()
    out["kept a frame"] = keep.sum(1).tolist()
    return out


def ensemble_stages(eng: FaceEngine, frames: np.ndarray) -> dict:
    """Device milliseconds of each stage of
    ``eng.detect_embed_classify_batch`` with both thresholds 0 (every NMS
    survivor a live slot), each timed alone on the same inputs, and
    ``k_live``, the slot columns the nets run on."""
    imgs = torch.from_numpy(frames).to(eng.device)
    out = {}
    with torch.inference_mode():
        out["detect"] = cuda_ms(lambda: eng.detect_batch(frames, 0.0, 0.0))
        post = eng.detect_batch(frames, 0.0, 0.0)
        k_live = eng._live_slots(post.valid)
        v = post.valid[:, :k_live]
        ew, eh = eng.embed_spec.input_size
        out[f"crops {eh}"] = cuda_ms(lambda: eng._face_crops(
            imgs, post.boxes, (eh, ew), post.valid))
        faces = eng._face_crops(imgs, post.boxes[:, :k_live], (eh, ew),
                                v).reshape(-1, eh, ew, 3)
        out[eng.embed_spec.name] = cuda_ms(lambda: eng._embed(faces))
        boxes = post.boxes[:, :k_live]
        out["crops 227"] = cuda_ms(lambda: eng._ag_crops(imgs, boxes, v,
                                                         clip=True))
        agc = eng._ag_crops(imgs, boxes, v, clip=True).reshape(-1, *AG_HW, 3)
        out["age/gender"] = cuda_ms(lambda: eng._classify(agc))
        out["ensemble"] = cuda_ms(lambda: eng.detect_embed_classify_batch(
            frames, det_thres=0.0, bbox_area_thres=0.0))
    return out, k_live


def similarity_stages(n: int = 512, m: int = 524288, d: int = 512,
                      k: int = 5) -> dict:
    """Milliseconds of ``topk_similar`` on both search paths: the host's
    normalisation and the gallery's copy (host clock), the search on the
    card (CUDA events), and the whole call (host clock)."""
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    gallery = rng.standard_normal((m, d), dtype=np.float32)
    out = {}
    t = time.perf_counter()
    g = normalize_rows(gallery)
    out["host normalise"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    gt = torch.as_tensor(g, device="cuda")
    torch.cuda.synchronize()
    out["gallery copy"] = (time.perf_counter() - t) * 1e3
    et = torch.as_tensor(normalize_rows(emb), device="cuda")
    with torch.inference_mode():
        out["search, kernel"] = cuda_ms(lambda: topk_gallery(et, gt, k), 5)
        with _f32_matmul():
            out["search, matmul"] = cuda_ms(
                lambda: _topk_stable(et @ gt.T, k), 5)
    for use_kernel in (True, False):
        topk_similar(emb[:8], gallery[:4096], k, use_pallas=use_kernel)
        t = time.perf_counter()
        topk_similar(emb, gallery, k, use_pallas=use_kernel)
        out[f"call, use_pallas={use_kernel}"] = \
            (time.perf_counter() - t) * 1e3
    return out


def kernel_breakdown(run, top: int = 12):
    """(rows, busy_ms, wall_ms) of ``ITERS`` calls of ``run`` (one batch)
    under torch.profiler: rows are (name, calls, device ms per batch)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): the host ops that launch
    # them report the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    rows = [(e.key, e.count // ITERS,
             e.self_device_time_total / 1e3 / ITERS) for e in events[:top]]
    return rows, busy_ms / ITERS, wall_ms / ITERS


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    eng = FaceEngine(EngineConfig(detector="yolov5s"))
    frames = np.random.RandomState(0).randint(0, 256, (B, H, W, 3), np.uint8)
    for det in ("yolov5s", "yolov5s6", "yolov5s-official"):
        deng = eng if det == "yolov5s" else FaceEngine(
            EngineConfig(detector=det))
        print(f"{det} stage device ms, B={B} frames {H}x{W}, square "
              "640x640:")
        for name, ms in detect_stages(deng, frames).items():
            print(f"  {name:<22} {ms:9.4f}")
        if det != "yolov5s-official":
            for name, v in nms_stage(deng, frames).items():
                print(f"  {name:<22} "
                      f"{v if isinstance(v, list) else f'{v:9.4f}'}")
    ensembles = {}
    for det, embedder in (("yolov5s", "mobile_facenet"),
                          ("yolov5s6", "facenet")):
        ens = ensembles[embedder] = FaceEngine(EngineConfig(
            detector=det, embedder=embedder, with_age_gender=True))
        stages, k_live = ensemble_stages(ens, frames)
        print(f"{det} + {embedder} + age/gender ensemble stage device ms, "
              f"B={B} frames {H}x{W}, every NMS survivor live, "
              f"k_live={k_live} of {ens.cfg.max_det} slots:")
        for name, ms in stages.items():
            print(f"  {name:<22} {ms:9.4f}")
    blaze = {name: FaceEngine(EngineConfig(detector=name))
             for name in ("blazeface-back", "blazeface-front")}
    for detector, beng in blaze.items():
        print(f"{detector} stage device ms, B={B} frames {H}x{W}:")
        for name, ms in detect_stages(beng, frames).items():
            print(f"  {name:<22} {ms:9.4f}")
    print("topk_similar, 512 queries x 524288 x 512 gallery, k=5, ms:")
    for name, ms in similarity_stages().items():
        print(f"  {name:<24} {ms:9.3f}")
    for label, run in (
            ("detect_batch", lambda: eng.detect_batch(frames)),
            ("blazeface-back detect_batch",
             lambda: blaze["blazeface-back"].detect_batch(frames)),
            ("blazeface-front detect_batch",
             lambda: blaze["blazeface-front"].detect_batch(frames)),
            ("detect_embed_classify_batch",
             lambda: ensembles["mobile_facenet"].detect_embed_classify_batch(
                 frames, det_thres=0.0, bbox_area_thres=0.0)),
            ("yolov5s6 + facenet detect_embed_classify_batch",
             lambda: ensembles["facenet"].detect_embed_classify_batch(
                 frames, det_thres=0.0, bbox_area_thres=0.0))):
        rows, busy, wall = kernel_breakdown(run)
        print(f"{label} under torch.profiler: {wall:.3f} ms wall per batch,"
              f" device busy {busy:.3f} ms ({100 * busy / wall:.1f} %), "
              f"idle {100 * (1 - busy / wall):.1f} %")
        for name, calls, ms in rows:
            print(f"  {ms:9.4f} ms  x{calls:<4} {name[:90]}")


if __name__ == "__main__":
    main()
