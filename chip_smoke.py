#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's detect and ensemble paths on one CUDA card.

    python3 chip_smoke.py

Phases, each announced by a line of its own and closed with the elapsed
seconds:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the kernels of the paths;
2. build: ``csrc/*.cu`` through one nvcc call (cold, or found built);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes (B = 8 frames, K = 1024 candidates, the three
   yolov5s levels at 640 x 640; 64 crop slots a frame at 112 x 112 and
   227 x 227); each must be exactly equal. Prints kernel, plain and library
   times and the bound;
4. main path, detect: ``FaceEngine(EngineConfig(detector="yolov5s"))`` at
   full width with weights drawn from a seeded generator, ``detect_batch``
   on 8 seeded 576 x 1024 frames (square and rect letterbox) and
   ``detect_image`` on 3 single frames;
5. main path, ensemble: the yolov5s + mobile_facenet + age/gender engine,
   ``detect_embed_classify_batch`` on the same 8 frames with every NMS
   survivor a live slot, then ``embed_crops``, ``classify_crops_age_gender``
   and ``detect_age_gender``.
   Each main path zeroes the launch counts just before it and reads them
   just after; every kernel of the path must have launched, and every
   output must be finite and of the contract's shape;
6. reference: the detector's raw maps, MobileFaceNet's embeddings and the
   age/gender heads' logits on the card against the same modules on the
   CPU.

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


CROP_HW = ((112, 112), (227, 227))  # face crops, age/gender crops
CROP_K = 64                          # EngineConfig.max_det slots a frame


def crop_inputs(gen, frames):
    """K boxes a frame in pixels of the 576 x 1024 frames: face-sized boxes
    plus every edge case (invalid, inverted, 1-px, crossing the edge, fully
    outside, the full frame)."""
    h, w = frames.shape[1:3]
    xy = torch.rand((B, CROP_K, 2), generator=gen) * torch.tensor([w, h])
    wh = torch.rand((B, CROP_K, 2), generator=gen) * 200 + 8
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 0] = torch.tensor([5.5, 7.25, 6.0, 8.0])          # 1-px box
    boxes[:, 1] = torch.tensor([300.0, 200.0, 250.0, 150.0])  # inverted
    boxes[:, 2] = torch.tensor([-40.0, -30.0, 60.0, 50.0])    # crosses 0
    boxes[:, 3] = torch.tensor([w - 30.0, h - 20.0, w + 45.0, h + 35.0])
    boxes[:, 4] = torch.tensor([-90.0, -80.0, -10.0, -5.0])   # outside
    boxes[:, 5] = torch.tensor([w + 10.0, 10.0, w + 90.0, 80.0])
    boxes[:, 6] = torch.tensor([0.0, 0.0, float(w), float(h)])  # full frame
    valid = torch.rand((B, CROP_K), generator=gen) > 0.2
    valid[:, :7] = True
    return boxes.cuda(), valid.cuda()


def crop_read_bytes(img, boxes, valid, out_hw, clamp):
    """Bytes of the frames that the crops need: the in-frame pixels that
    the taps of any live box of a frame touch, the union over the frame's
    boxes (overlapping boxes read a pixel once)."""
    b, h, w, c = img.shape
    hits = []
    for (lo, hi), size, n_out in (((1, 3), h, out_hw[0]),
                                  ((0, 2), w, out_hw[1])):
        i0, i1, _, in0, in1 = ck._crop_taps(boxes[..., lo], boxes[..., hi],
                                            size, n_out, clamp)
        hit = torch.zeros((b, boxes.shape[1], size + 1), device=img.device)
        for idx, inside in ((i0, in0), (i1, in1)):
            hit.scatter_(2, torch.where(inside, idx, size), 1.0)
        hits.append(hit[..., :size])
    rows = hits[0] * valid[..., None]                     # [B, K, H]
    # per frame, the pixels (y, x) that some live box touches in row y
    # and column x: a count of such boxes, exact in f32 (at most K)
    covered = torch.bmm(rows.transpose(1, 2), hits[1]) > 0  # [B, H, W]
    return float(covered.sum()) * c * img.element_size()


def check_crop(gen, frames):
    """B3 against its plain version: both box semantics, both crop sizes of
    the ensemble, uint8 frames (the engine's) and f32 frames once."""
    boxes, valid = crop_inputs(gen, frames)
    cases = [(hw, clamp, frames) for hw in CROP_HW for clamp in (True, False)]
    cases.append(((112, 112), True, frames.float()))
    err = 0.0
    for hw, clamp, img in cases:
        got = ck.crop_resize(img, boxes, valid, hw, clamp)
        ref = ck.crop_resize_plain(img, boxes, valid, hw, clamp)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        err = max(err, e)
        say(f"  crop_resize {hw[0]}x{hw[1]} clamp={clamp} {img.dtype}: "
            f"[{B}, {CROP_K}] boxes, {int(valid.sum())} live, "
            f"max abs err {e}")
        if not torch.equal(got, ref):
            raise AssertionError("crop_resize differs from its plain version")
        if bool((got[~valid] != 0).any()):
            raise AssertionError("crop_resize wrote an invalid slot")
    # timed on the 227 x 227 age/gender crops, the larger of the path's two
    hw = CROP_HW[1]
    args = (frames, boxes, valid, hw, True)
    ms = cuda_ms(lambda: ck.crop_resize(*args), 50)
    plain_ms = cuda_ms(lambda: ck.crop_resize_plain(*args), 5)
    # the library call: one grid_sample over the f32 NCHW frames, the K
    # crops stacked along the grid's rows, at the same sample coordinates
    # (zero padding reads 0 only where the weight is 0 here)
    y0, _, wy, _, _ = ck._crop_taps(boxes[..., 1], boxes[..., 3],
                                    frames.shape[1], hw[0], True)
    x0, _, wx, _, _ = ck._crop_taps(boxes[..., 0], boxes[..., 2],
                                    frames.shape[2], hw[1], True)
    gy = (2 * (y0 + wy) + 1) / frames.shape[1] - 1           # [B, K, oh]
    gx = (2 * (x0 + wx) + 1) / frames.shape[2] - 1           # [B, K, ow]
    grid = torch.stack(torch.broadcast_tensors(
        gx[..., None, :], gy[..., :, None]), -1).reshape(B, -1, hw[1], 2)
    nchw = frames.permute(0, 3, 1, 2).float().contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)

    library_ms = cuda_ms(library, 50)
    lib_out = library().reshape(B, 3, CROP_K, hw[0], hw[1]) \
        .permute(0, 2, 3, 4, 1)
    lib_err = float((torch.where(valid[..., None, None, None], lib_out, 0.0)
                     - ck.crop_resize(*args)).abs().max())
    say(f"  grid_sample {hw[0]}x{hw[1]} against the kernel: max abs err "
        f"{lib_err:.3g} (its own rounding of the coordinates)")
    # every output slot written once (zeros included), the box regions of
    # the live slots read once, boxes and valid read
    nbytes = (B * CROP_K * hw[0] * hw[1] * 3 * 4
              + crop_read_bytes(frames, boxes, valid, hw, True)
              + B * CROP_K * (16 + 1))
    return dict(
        name="crop_resize", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/crop_resize.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:420",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=library_ms)


def check_reference(name, fn, x):
    """``fn`` on the card against a copy of it on the CPU, on ``x``."""
    with torch.inference_mode():
        ref = fn(x, "cpu")
        with _full_f32(torch.device("cuda")):
            got = fn(x.cuda(), "cuda")
    for g, r in zip(got, ref):
        rel = float((g.cpu() - r).abs().max() / r.abs().max())
        say(f"  {name} {tuple(r.shape)}: max |card - cpu| / max |cpu| = "
            f"{rel:.2e}")
        # f32 on both sides (TF32 off), summed in other orders
        if not rel < 1e-4:
            raise AssertionError(f"the card's {name} disagree with the CPU's")


def on(module, call=lambda m, x: m(x)):
    """fn(x, device): ``call(module, x)`` on the card, or with a CPU copy
    of ``module``."""
    cpu = copy.deepcopy(module).cpu()
    return lambda x, dev: call(cpu if dev == "cpu" else module, x)


def run_ensemble(eng, frames, card):
    """The ensemble main path: one warm-up call and 5 timed calls of
    ``detect_embed_classify_batch``, then the staged entry points. Returns
    the launch counts of this path alone."""
    b, k = frames.shape[0], eng.cfg.max_det
    rng = np.random.RandomState(SEED + 2)
    faces = rng.randint(0, 256, (16, 96, 96, 3), np.uint8)
    single = rng.randint(0, 256, (540, 720, 3), np.uint8)
    ck.reset_launches()
    kw = dict(det_thres=0.0, bbox_area_thres=0.0)
    eng.detect_embed_classify_batch(frames, **kw)
    torch.cuda.synchronize()
    t = time.time()
    reps = 5
    for _ in range(reps):
        r = eng.detect_embed_classify_batch(frames, **kw)
    torch.cuda.synchronize()
    sec = (time.time() - t) / reps
    v = r.det.valid
    live = v.any(0).nonzero()
    k_live = int(live[-1]) + 1 if len(live) else 0
    say(f"  detect_embed_classify_batch: {b} x 576x1024 frames in "
        f"{sec * 1e3:.2f} ms = {b / sec:.1f} frames/s on {card}; live slots "
        f"per frame {v.sum(1).tolist()}, k_live {k_live} of {k}")
    want = {"crops": (b, k, 112, 112, 3), "embeddings": (b, k, 512),
            "age_probs": (b, k, 8), "gender_probs": (b, k, 2)}
    for name, shape in want.items():
        t_ = getattr(r, name)
        if tuple(t_.shape) != shape:
            raise AssertionError(f"{name} shape {tuple(t_.shape)}")
        if not bool(torch.isfinite(t_).all()):
            raise AssertionError(f"non-finite {name}")
        if bool((t_[~v] != 0).any()):
            raise AssertionError(f"{name}: an invalid row is not zero")
    if k_live == 0:
        raise AssertionError("no live slot: the nets never ran")
    norm_err = float((r.embeddings[v].norm(dim=-1) - 1).abs().max())
    sum_err = max(float((p[v].sum(-1) - 1).abs().max())
                  for p in (r.age_probs, r.gender_probs))
    say(f"  valid embeddings: max |norm - 1| = {norm_err:.2e}; "
        f"probabilities: max |sum - 1| = {sum_err:.2e}")
    if not (norm_err <= 1e-4 and sum_err <= 1e-5):
        raise AssertionError("embeddings not unit or probabilities not 1")
    emb = eng.embed_crops(faces)
    age, gender = eng.classify_crops_age_gender(faces)
    res = eng.detect_age_gender(single)
    if emb.shape != (16, 512) or age.shape != (16, 8) \
            or gender.shape != (16, 2) or not np.isfinite(emb).all():
        raise AssertionError("staged entry points returned bad outputs")
    if len(res.bbox_labels) != len(res):
        raise AssertionError("detect_age_gender labels do not match boxes")
    say(f"  embed_crops {emb.shape}, classify_crops_age_gender "
        f"{age.shape} {gender.shape}, detect_age_gender: {len(res)} faces, "
        f"labels {res.bbox_labels[:2]}")
    torch.cuda.synchronize()
    return dict(ck.LAUNCHES)


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
        " row gather, B3 crop + bilinear resize), CUDA C++ for sm_90a")
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
    rng = np.random.RandomState(SEED)
    frames = rng.randint(0, 256, (B, 576, 1024, 3), np.uint8)
    singles = rng.randint(0, 256, (3, 540, 720, 3), np.uint8)
    kernels = [check_nms(gen), check_gather(gen),
               check_crop(gen, torch.from_numpy(frames).cuda())]
    for k in kernels:
        say(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']})")
    phase_end("kernels")

    say("[main path: detect] yolov5s-face FaceEngine on the card")
    t = time.time()
    engines = {rect: FaceEngine(EngineConfig(detector="yolov5s", rect=rect,
                                             seed=SEED))
               for rect in (False, True)}
    say(f"  engines built in {time.time() - t:.1f} s on "
        f"{engines[False].device}")
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
    detect_launches = dict(ck.LAUNCHES)
    say(f"  launches on the detect path: {detect_launches}")
    for name in ("nms_fixpoint", "rows_gather"):
        if detect_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: detect")

    say("[main path: ensemble] yolov5s + mobile_facenet + age/gender")
    t = time.time()
    ens = FaceEngine(EngineConfig(detector="yolov5s",
                                  embedder="mobile_facenet",
                                  with_age_gender=True, seed=SEED))
    say(f"  engine built in {time.time() - t:.1f} s")
    ensemble_launches = run_ensemble(ens, frames, card)
    say(f"  launches on the ensemble path: {ensemble_launches}")
    for name, n in ensemble_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: ensemble")

    say("[reference] the card against the CPU")
    gen = torch.Generator().manual_seed(SEED + 1)
    check_reference("raw maps", on(engines[False].net),
                    torch.rand((2, 160, 160, 3), generator=gen))
    check_reference("embeddings", on(ens.embed_net, lambda m, x: [m(x)]),
                    torch.rand((4, 112, 112, 3), generator=gen) * 2 - 1)
    check_reference(
        "age/gender logits",
        on(ens.ag_net, lambda m, x: [m.age(x.permute(0, 3, 1, 2)),
                                     m.gender(x.permute(0, 3, 1, 2))]),
        torch.rand((4, 227, 227, 3), generator=gen) * 255 - 100)
    phase_end("reference")

    # each path's counts were zeroed just before it and read just after;
    # launches is their sum, launches_by_path keeps them apart
    for k in kernels:
        by_path = {"detect": detect_launches[k["name"]],
                   "ensemble": ensemble_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
