#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's detect path on one CUDA card.

    python3 chip_smoke.py

Phases, each announced by a line of its own and closed with the elapsed
seconds:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the kernels of the path;
2. build: ``csrc/*.cu`` through one nvcc call (cold, or found built);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main path's shapes (B = 8 frames, K = 1024 candidates, the three
   yolov5s levels at 640 x 640); both must be exactly equal. Prints kernel,
   plain and library times;
4. main path: ``FaceEngine(EngineConfig(detector="yolov5s"))`` at full width
   with weights drawn from a seeded generator, ``detect_batch`` on 8 seeded
   576 x 1024 frames (square and rect letterbox) and ``detect_image`` on 3
   single frames. Launch counts are zeroed just before and read just after;
   every kernel of the path must have launched, and every output must be
   finite and of the contract's shape;
5. reference: the network's raw maps on the card against the same network
   on the CPU, two frames at 160 x 160.

The line before the last is a JSON object of per-kernel numbers, and the last
line is ``{"ok": true, "device": {...}}``. Any failure propagates: the script
then exits non-zero and prints no result. Without a CUDA device, or without
the repository beside it, it fails at once.
"""
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine, _full_f32)
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.utils.profiling import cuda_ms

T0 = time.time()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32, outside the tensor cores
B, K = 8, 1024              # frames per batch, NMS candidates per frame
LEVEL_ROWS = (19200, 4800, 1200)  # yolov5s at 640 x 640: 3 x (640/s)^2
SEED = 0


def say(msg):
    print(msg, flush=True)


def phase_end(name):
    say(f"[{name}] done at {time.time() - T0:.1f} s")


def nms_inputs(gen):
    """Score-sorted pixel boxes on a 640 canvas with duplicate boxes and
    invalid rows, as the detect path hands them to the NMS."""
    xy = torch.rand((B, K, 2), generator=gen) * 600
    wh = torch.rand((B, K, 2), generator=gen) * 80 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 100:140] = boxes[:, 0:40]            # identical boxes
    valid = torch.rand((B, K), generator=gen) > 0.1
    return boxes.cuda(), valid.cuda()


def check_nms(gen):
    boxes, valid = nms_inputs(gen)
    err = 0.0
    for plus1, strict, mode in ((False, True, "union"), (True, False, "union"),
                                (True, False, "min")):
        got = ck.nms_fixpoint(boxes, valid, 0.3, plus1, strict, mode)
        ref = ck.nms_fixpoint_plain(boxes, valid, 0.3, plus1, strict, mode)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        err = max(err, float((got.int() - ref.int()).abs().max()))
        say(f"  nms_fixpoint plus1={plus1} strict={strict} mode={mode}: "
            f"kept {int(got.sum())} of {int(valid.sum())}, "
            f"mismatches {mism}")
        if mism:
            raise AssertionError("nms_fixpoint differs from its plain version")
    # the detect path's option set: +1 px IoU, suppress at IoU >= 0.3
    args = (boxes, valid, 0.3, True, False, "union")
    ms = cuda_ms(lambda: ck.nms_fixpoint(*args), 50)
    plain_ms = cuda_ms(lambda: ck.nms_fixpoint_plain(*args), 5)
    # IoU of every pair i < j: 2 max, 2 min, 2 sub, 2 add, 2 clamp, 1 mul
    # (intersection), add, sub, add eps (union), div, compare = 16 ops;
    # areas 5 ops a box. Bytes: boxes in, valid in, keep out.
    ops = B * (K * (K - 1) // 2 * 16 + 5 * K)
    nbytes = B * K * (16 + 1 + 1)
    return dict(
        name="nms_fixpoint", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/nms.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:90",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
        bound_by=("bytes" if nbytes / HBM_BYTES_PER_S > ops / F32_OPS_PER_S
                  else "operations"),
        library_ms=None)


def check_gather(gen):
    levels32 = [torch.randn((B, n, 16), generator=gen).cuda()
                for n in LEVEL_ROWS]
    obj = torch.cat([m[..., 4] for m in levels32], 1)
    # candidate indices as the detect path makes them: the top K rows by
    # sigmoid objectness, stable among ties
    idx = torch.sort(torch.sigmoid(obj), dim=1, descending=True,
                     stable=True).indices[:, :K].to(torch.int32).contiguous()
    result = None
    for dtype in (torch.float32, torch.bfloat16):
        levels = [m.to(dtype) for m in levels32]
        got = ck.rows_gather(levels, idx)
        ref = ck.rows_gather_plain(levels, idx)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        say(f"  rows_gather {dtype}: [{B}, {K}, 16] from levels {LEVEL_ROWS},"
            f" max abs err {err}")
        if not torch.equal(got, ref):
            raise AssertionError("rows_gather differs from its plain version")
        if dtype == torch.float32:  # the detect path's maps are f32
            flat = torch.cat(levels, 1)
            idx3 = idx.long()[..., None].expand(B, K, 16)
            ms = cuda_ms(lambda: ck.rows_gather(levels, idx), 200)
            plain_ms = cuda_ms(lambda: ck.rows_gather_plain(levels, idx), 50)
            # one library call on the prebuilt concat (the port never calls it)
            library_ms = cuda_ms(lambda: torch.gather(flat, 1, idx3), 200)
            # the selected rows read once, the indices read, the rows written
            nbytes = B * K * (16 * 4 + 4 + 16 * 4)
            result = dict(
                name="rows_gather", route="cuda",
                source="face_detection_and_recognition_tpu_torch/csrc/"
                       "rows_gather.cu",
                replaces="face_detection_and_recognition_tpu/ops/"
                         "pallas_kernels.py:545",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=library_ms)
    return result


def check_reference(net):
    """The card's raw maps against the same network on the CPU."""
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.rand((2, 160, 160, 3), generator=gen)
    cpu_net = copy.deepcopy(net).cpu()
    with torch.inference_mode():
        ref = cpu_net(x)
        with _full_f32(torch.device("cuda")):
            got = net(x.cuda())
    for g, r in zip(got, ref):
        rel = float((g.cpu() - r).abs().max() / r.abs().max())
        say(f"  raw map {tuple(r.shape)}: max |card - cpu| / max |cpu| = "
            f"{rel:.2e}")
        # f32 on both sides, summed in other orders through ~60 layers
        if not rel < 1e-4:
            raise AssertionError("the card's raw maps disagree with the CPU's")


def main():
    say("[environment]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(f"  card: {card}")
    say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    say(f"  kernels: {sorted(ck.LAUNCHES)} (B1 NMS keep mask, B2 candidate"
        " row gather), CUDA C++ for sm_90a")
    phase_end("environment")

    say("[build]")
    cold = not ck.library_path().is_file()
    t = time.time()
    lib = ck.build_library()
    say(f"  {'built' if cold else 'found'} {lib.name} in "
        f"{time.time() - t:.1f} s")
    phase_end("build")

    say(f"[kernels] against their plain versions on {card}")
    gen = torch.Generator().manual_seed(SEED)
    kernels = [check_nms(gen), check_gather(gen)]
    for k in kernels:
        say(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']})")
    phase_end("kernels")

    say("[main path] yolov5s-face FaceEngine on the card")
    t = time.time()
    engines = {rect: FaceEngine(EngineConfig(detector="yolov5s", rect=rect,
                                             seed=SEED))
               for rect in (False, True)}
    say(f"  engines built in {time.time() - t:.1f} s on "
        f"{engines[False].device}")
    rng = np.random.RandomState(SEED)
    frames = rng.randint(0, 256, (B, 576, 1024, 3), np.uint8)
    singles = rng.randint(0, 256, (3, 540, 720, 3), np.uint8)
    ck.reset_launches()
    for rect, eng in engines.items():
        eng.detect_batch(frames)  # first call: cuDNN picks its algorithms
        torch.cuda.synchronize()
        t = time.time()
        reps = 5
        for _ in range(reps):
            dets = eng.detect_batch(frames)
        torch.cuda.synchronize()
        sec = (time.time() - t) / reps
        for name, arr in (("boxes", dets.boxes), ("scores", dets.scores),
                          ("lmarks", dets.lmarks), ("areas", dets.areas)):
            if not bool(torch.isfinite(arr).all()):
                raise AssertionError(f"non-finite {name}")
        want = {"boxes": (B, 64, 4), "scores": (B, 64), "lmarks": (B, 64, 10),
                "valid": (B, 64)}
        for name, shape in want.items():
            if tuple(getattr(dets, name).shape) != shape:
                raise AssertionError(f"{name} shape "
                                     f"{tuple(getattr(dets, name).shape)}")
        say(f"  detect_batch rect={rect}: {B} x 576x1024 frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; "
            f"detections per frame {dets.valid.sum(1).tolist()}")
    for i, img in enumerate(singles):
        t = time.time()
        res = engines[False].detect_image(img)
        if not (np.isfinite(res.boxes).all() and res.boxes.shape[1:] == (4,)):
            raise AssertionError("detect_image returned bad boxes")
        say(f"  detect_image request {i}: {len(res)} faces in "
            f"{(time.time() - t) * 1e3:.2f} ms")
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    say(f"  launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path")

    say("[reference] raw maps on the card against the CPU")
    check_reference(engines[False].net)
    phase_end("reference")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
