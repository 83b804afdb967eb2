#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's detect, ensemble, similarity, BlazeFace,
export, yolov5 family + embedders, CLI + serving, dataset pipeline, SSD + MTCNN,
res10 + OpenVINO, int8 + keras + eval, bfloat16, trained-weights,
bf16-families, training, recognition-training, multi-device and video
paths on one CUDA card, and trace its detect path.

    python3 chip_smoke.py

Phases, each announced by a line of its own and closed with the elapsed
seconds:

1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, the kernels of the paths;
2. build: ``csrc/*.cu``, one nvcc a source at once and a link (cold, or
   found built);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the main paths' shapes; each must be exactly equal. B1, in each of
   its three option sets: B = 8 frames of K = 1024 candidates, K = 1000
   (not a multiple of 32), B = 1, and K = 8192 (the cap). B2, the fused
   candidate gather + decode: f32 and bf16 maps in three level layouts
   (yolov5s's P5 at 640 x 640 and 640 x 384, the four-level P6 at
   640 x 640), K = 1024 a frame. B3: 64 crop slots a frame at 112 x 112,
   227 x 227, 160 x 160, 128 x 128 and 45 x 31 (odd rows of 93 floats),
   both box semantics, uint8 and f32 frames, with the epilogue off, clip
   only, and clip + the age/gender mean, each with the f32 store and the
   bf16 one (compared bit for bit; timed at 227 x 227 with clip + mean
   beside the f32 store). B4: 512 queries against a
   524,288 x 512 gallery, k = 5, against the plain FMA chain on the whole
   gallery. B5, the standalone entry point: 896 BlazeFace rows a frame,
   16 slots; 10 rows; nothing valid; K = 2048; K = 1500 (two words a
   pick warp, ragged); K = 2048 at D = 32 (rows read from L2); 40 slots
   (past the first chunk of 32 picks). B5, the fused entry point (decode,
   sigmoid, threshold, sort, blend NMS): seeded raw heads of both nets at
   B = 8 with ties at sigmoid 1.0 and an inverted box, nothing above the
   threshold, every anchor above it, NaN raw scores, 600 and 1000 anchors,
   and (in phase 7) the nets' own heads on the path's frames. The gallery
   top-k is
   also held to the default search path (matrix product and stable top-k).
   Prints for each kernel its time between CUDA events over a loop of
   calls, its device time a call from torch.profiler (the time between
   events stands in, and says so, where the profiler records nothing),
   the plain and library times and the bound; for B2 also the host microseconds a call
   and its two yardsticks (``torch.gather`` on the prebuilt concat, and
   that gather + the plain decode); for B4 whether it beats
   ``torch.topk(q @ g.T)`` and is within 2x its bound;
4. main path, detect: ``FaceEngine(EngineConfig(detector="yolov5s"))`` at
   full width with weights drawn from a seeded generator, ``detect_batch``
   on 8 seeded 576 x 1024 frames (square and rect letterbox) and
   ``detect_image`` on 3 single frames; then, after the path's counts are
   read, B1 alone on the candidates that path hands it (checked against
   the plain version, timed, its kept boxes a frame printed); then
   tracing: three ``detect_batch`` steps of that engine under
   ``utils.profiling.device_trace``, read back by
   ``utils.trace_analysis``: the trace's device operations and time a
   step equal to the same profiler session's ``key_averages`` (the count
   exact, the time within 1 %), an untraced session printed beside it,
   B1's and B2's kernels found by
   name, ``print_report`` and the share of device time left
   ``<unattributed>``;
5. main path, ensemble: the yolov5s + mobile_facenet + age/gender engine,
   ``detect_embed_classify_batch`` on the same 8 frames with every NMS
   survivor a live slot, then ``embed_crops``, ``classify_crops_age_gender``
   and ``detect_age_gender``;
6. main path, similarity: the ensemble's live embeddings through
   ``topk_similar`` (k = 5) on both search paths against a seeded
   524,288 x 512 numpy gallery (IMDB-WIKI's size), which must agree, and
   ``filter_embeddings``; prints the call's time and the host's share;
7. main path, BlazeFace: ``FaceEngine(EngineConfig(detector=...))`` for
   ``blazeface-back`` (256 x 256) and ``blazeface-front`` (128 x 128) at
   full width, ``detect_batch`` on the same 8 frames and ``detect_image``
   on the 3 single frames. After the path's counts are read, on the
   path's raw heads: the anchors above the score threshold and the blend
   NMS's picks a frame, the fused kernel against its plain version and
   timed alone, and the engine's fused stage bit for bit against the ops
   layer's route (``decode_boxes`` + ``weighted_blend_nms``, the
   standalone B5, which no engine calls).
8. main path, export (``utils/export.py``): ``export_detector`` of the
   phase 4 yolov5s engine (B1 + B2), BlazeFace-front (B5 fused), a dynamic
   int8 yolov5n (Q1 + B2 + B1) and ov-0204 (B1 at K = 400), each on its
   preprocessed 8 frames; ``export_ensemble`` of the phase 5 engine on the
   8 576 x 1024 frames (B1 + B2 + B3; thresholds 0); ``export_jitted`` of
   a B4 search of the similarity path's gallery (its live embeddings as
   queries) and of the ops layer's blend NMS (the standalone B5) on seeded
   rows. Each program is written under ``build/chip_smoke/export/``,
   reloaded by ``load_exported`` and called; its outputs must equal the
   eager call's bit for bit, the ensemble's nets' outputs within
   ``EXPORT_NET_TOL`` (the program runs them on every slot, the eager call
   on the live ones). The counts are zeroed after each program's export
   (which runs it once eagerly) and reload, and read after its reloaded
   call: its kernels must launch there, and the path's counts are the sum
   over the reloaded calls. Then the export and reload seconds, each program's ms between
   CUDA events in turns with its eager call (eager, reloaded, reloaded,
   eager), the device ms and operations of both (profiler), and B1's host
   us a call through ``fdr::nms_fixpoint`` against its wrapper;
   Each main path zeroes the launch counts just before it and reads them
   just after; every kernel of the path must have launched, and every
   output must be finite and of the contract's shape;
9. main path, yolov5 family + embedders: yolov5s6-face (four levels, gd
   0.33, gw 0.50) ``detect_batch`` on the 8 frames square (640 x 640),
   rect (640 x 384) and at 960 x 960; yolov5s-official (nc 80, no
   landmarks) ``detect_batch``; yolov5s6 + FaceNet (160 x 160, 128-d) +
   age/gender ``detect_embed_classify_batch`` with every NMS survivor
   live; ``embed_crops`` and ``embed_faces`` through facenet-512,
   reid-mnv2 (128 x 128) and demographics (227 x 227). Each part zeroes
   the counts before it and reads them after; the path's counts are the
   sums. After the counts are read, on the arguments the path handed them
   (captured by a spy that calls the real wrapper): B2's calls, which
   must take four levels, B1's on yolov5s6 and B3's at the path's sizes
   (160, 128, 227) bit for bit against their plain versions, and B1 alone
   on the official head's class-shifted candidates (coordinates up to
   ~3.3e5), bit for bit and timed; each net's device ms on up to 512
   crops;
10. main path, cli + serving: a seeded smooth 576 x 1024 frame through the
   port's JPEG codec (``utils/native.py``: encoded, decoded, the round
   trip's error bounded, the codec's library printed); the ``detect_face`` CLI in
   process on that JPEG (yolov5s, thresholds 0, then again with
   ``--age-gender --embedder mobile_facenet``); then the HTTP front door of
   ``FaceService(ServiceConfig())`` (yolov5s, MobileFaceNet, both
   age/gender heads, 32 slots) on 127.0.0.1: ``/health``, 8 sequential
   ``/detect`` and 8 sequential ``/ensemble`` requests, one ``Detect``
   through the gRPC front door, and 8 concurrent ``/detect`` requests
   through the dynamic batcher (batches of up to 8).
   After the path's counts are read: the CLI's printed boxes against
   ``FaceEngine.detect_image`` on the decoded frame, every sequential and
   gRPC answer against the service's direct call on it, and each batched
   answer against the engine's answer in a batch of its dispatch's size
   (the batcher records each dispatch's size); the request times (p50,
   max) and the batcher's counts are printed;
11. main path, pipelines: the dataset CLIs on seeded trees written through
   the card's JPEG encoder. ``extract_faces`` (yolov5s + mobile_facenet,
   blocks of 64, thresholds 0) on two classes of 48 576 x 1024 JPEGs, a
   PNG and a BMP, with a WebP and a video that must end in
   ``stats.failed``: a warm-up run, then a timed one whose frames/s,
   media/s and seconds (decode wait, device blocks, crop JPEG writes,
   feature saves) are printed; ``extract_and_label`` (blazeface-front,
   reid-mnv2, the auto labeler: B5 fused and B3 at 227 x 227 with clip +
   mean) on 8 frames; ``extract_features`` on 128 face crops of mixed
   sizes (JPEG, PNG, BMP); ``extract_imdb_wiki`` (blazeface-back,
   mobile_facenet) on 32 images of mixed sizes with a ``savemat``-built
   .mat, at a threshold that leaves many images one face. Each part zeroes
   the counts before it and reads them after; every B1/B2/B3/B5 call of
   the path, recorded by a spy, is then held to its plain version bit for
   bit. Then extract_faces on 2 media a class on the card and on the CPU
   (face counts equal, feature rows of the same boxes within 1e-4), and
   1-px, sliver and odd-sized crops through the port's JPEG codec;
12. main path, ssd + mtcnn: ``detect_batch`` of ssd-resnet10 (300 x 300),
   ssd-mobilenetv2 (448 x 448) and ssd-squeezenet (300 x 300) on the 8
   frames at thresholds 0, one B1 launch each; mtcnn at native resolution
   at its default thresholds and with every stage full (thresholds 0): 11
   B1 launches (8 pyramid levels, the global pass, R-Net's, O-Net's in
   ``min`` mode) and 2 B3 launches in pad mode (24 x 24 and 48 x 48 crops
   of the normalized frames) a batch; one ``/detect`` request to the HTTP
   front door of an mtcnn ``FaceService`` (the staged path: the cascade,
   then B3 clamped at 112), its answer against the service's direct call.
   Each part zeroes the counts before it and reads them after. Then every
   B1 and B3 call of those parts, recorded by a spy, against its plain
   version bit for bit; frames/s of each detector and the milliseconds of
   each MTCNN stage; each SSD detector's rows and each MTCNN stage's on
   the first 2 frames against the port on the CPU (the same rows within
   1e-4 after normalization, the same counts); B1 at K = 400 (SSD), at
   MTCNN's global pass and in ``min`` mode, and B3 pad at 24 and 48,
   timed beside their bounds; the host JPEG codec's decode of a 576 x 1024
   quality-95 frame and encode of the frame and of 112 x 112 crops;
13. main path, res10 + openvino: a seeded res10 caffemodel and a seeded
   ov-0204 IR (``.xml`` + ``.bin``) written under ``build/chip_smoke/``
   by the port's writers; ``detect_batch`` (8 frames, thresholds 0) and
   ``detect_image`` of res10-ssd (the caffemodel through
   ``load_weights``), ov-0204, ov-squeezenet-light and openvino-ir (built
   from the IR), ``detect_face --md openvino-ir --ckpt`` on a frame's
   JPEG, and one ``/detect`` to a res10-ssd ``FaceService`` loaded through
   ``ServiceConfig.ckpt``: one B1 launch a part, and one B3 (the face
   crops) for ``/detect``. Each part zeroes the counts before it and reads
   them after. Then every B1 and B3 call of those parts against its plain
   version bit for bit; the openvino-ir engine and an ov-0204 engine of
   another seed reloaded from the IR against the ov-0204 engine whose
   constants the IR holds (equal rows); each detector's rows on the first
   2 frames against the port on the CPU (1e-4); frames/s, the stage split
   (``utils/profiling.detect_stages``) and B1 at K = 400 of each detector,
   timed beside its bound;
14. main path, int8 + keras + eval: yolov5n and yolov5s at full width
   built with ``detector_overrides={"quantized": True}`` and ``"static"``
   (seeded f32 weights folded and quantized by ``utils/quantize.py``; the
   static scales calibrated again on the 8 frames), ``detect_batch`` of
   the 8 frames at thresholds 0 (square 640): Q1 (``csrc/conv_int8.cu``)
   on every quantized ConvBN (82 calls a yolov5n forward, 61 a yolov5s
   one); a keras FaceNet SavedModel written by the port's TensorBundle
   writer and loaded by ``load_embed_weights`` into an engine of another
   seed (embeddings equal to the state-dict engine's); the ``eval_wider``
   CLI with the static yolov5n's ``.pt`` on a seeded WIDER-format tree of
   16 JPEGs, equal to ``evaluate_engine_on_wider`` in process. Each part
   zeroes the counts before it and reads them after. Then every Q1 call of
   one forward of each net and mode, captured by a spy, against its plain
   version (the pre-activation bit for bit, SiLU within 4 ulps), and
   yolov5n's dynamic ones against the plain version on the CPU on the
   first two frames of the same inputs (the pre-activation bit for bit,
   SiLU's ulps printed); Q1
   on a fixed sweep of its edge shapes (``Q1_SWEEP``: ragged C_in, C_out
   and M, k = 5, depthwise, channel-slice and NCHW inputs; both modes)
   against its plain version the same way; Q1 timed
   call by call over yolov5n's dynamic forward and yolov5s's static one
   (the sums, the profiler's device ms, the plain version's, ``F.conv2d``
   in float64 on the same codes as the library call, and the bound: bytes
   over 3.35 TB/s against int8 operations over 1979 TOPS), its device ms
   by call class (stem, dense 1x1, dense 3x3, depthwise) beside each
   class's launches and bound, the kernels one call launches (the
   profiler's names), and ``torch._int_mm`` on the codes of the 1x1 calls
   it takes, beside Q1's device ms of the same calls; each net's rows
   on the first 2 frames against the port on the CPU (the difference
   printed); frames/s and network ms of int8 against f32;
15. main path, bf16: ``FaceEngine(EngineConfig(detector="yolov5s",
   dtype=torch.bfloat16))`` at full width with seeded weights,
   ``detect_batch`` on the 8 frames square and rect and ``detect_image`` on
   the 3 single frames, then the yolov5s + mobile_facenet + age/gender bf16
   ensemble with every NMS survivor a live slot: B1 and B2 on each detect
   part, B3 on the ensemble (its 227 x 227 crops in the bf16 store). Each
   part zeroes the counts before it and reads them after. Then the net's
   heads must be bf16; B2 on the bf16 net's own maps, B1 on its candidates
   and B3 on the ensemble's own crops (recorded by a spy) against their
   plain versions bit for bit; ``detect_stages`` and ``ensemble_stages``
   of the bf16 engines beside the f32 ones of phases 4 and 5, each
   network's device ms and operations by kind (profiler), frames/s bf16
   against f32, the share of the f32 engine's boxes that a bf16 box
   matches at IoU >= 0.5 (information, not a gate), the bf16 maps of 2
   frames on the card against the same bf16 net on the CPU, and each
   ConvBN and Detect convolution of that forward on the input it had on
   the card against the same layer on the CPU (at least 99.9 % of its
   elements bit for bit and every difference within 2 bf16 ulps of its
   largest output, or the run fails);
16. main path, trained weights: the nets of ``card_weights/``
   (``eval/card_weights.py``; yolov5s f32 and bf16, yolov5n f32 and int8
   static, blazeface-front, mtcnn f32 and bf16, loaded through the engine's
   weight loaders) through the golden gate of each net's JAX test on the
   golden image and the negative one, their boxes at each of the gate's
   thresholds within 1 px of the JAX CPU engine's (``expected.json``; the
   int8 net: the same counts, its largest difference printed), and
   MobileFaceNet's embeddings of the pinned crops at cosine >= 0.999 to
   JAX's; each net is a part of the path;
17. main path, bf16 families: blazeface front and back, the three SSDs,
   mtcnn (every stage full), res10-ssd, ov-0204, ov-squeezenet-light and
   openvino-ir with ``EngineConfig(dtype=torch.bfloat16)``,
   ``detect_batch`` on the 8 frames at thresholds 0, a part each; then B1,
   B3 and the fused B5 on the path's own inputs against their plain
   versions bit for bit, each family's bf16 heads on 2 frames on the card
   against the same net on the CPU (the share of equal elements), and
   each network's ms between events and device ms and operations, bf16
   beside f32;
18. main path, training: one ``make_det_train_step_ema`` step of yolov5s
   at 640 x 640, B = 4 (golden composites) on the card and on the CPU
   from the same weights and batch, in the step's own precision (f32,
   TF32 off, as the timed chunks and ``train_golden`` train): the loss
   and each updated parameter, BN statistic and EMA tensor within the
   stated tolerances;
   the device loop's step timed (ms between events, steps/s) and one
   chunk traced (device ms a step, the device's idle share);
   ``train_golden`` (yolov5s, 640, B = 16, 4 steps resumed from
   ``card_weights/yolov5s.pt``, evals every 2, 32 composites, a buffer of
   the 64 augmented examples the steps draw): finite
   chunk losses, 4 updates, the EMA moved, B1 and B2 launched by the
   gates, the written ``.pt`` reloaded into a fresh engine giving the
   in-memory candidate's detections of the golden pair bit for bit (the
   gate's verdict printed, not asserted); ``quantize_golden`` of
   ``card_weights/yolov5n.pt`` on the card: its activation scales against
   the JAX CPU calibration of ``expected.json`` and against
   ``yolov5n_int8.pt``, the int8 gate of ``expected.json`` passed through
   Q1; three steps of the BlazeFace-front (128) and ssd-resnet10 (300)
   trainers, each loss against the CPU's. Each of ``train_golden`` and
   ``quantize_golden`` is a part of the path;
19. main path, recognition training: one ArcFace step of MobileFaceNet
   (112 x 112, 512-d, B = 48, three golden identities, s = 16, center
   gain 0.02) on the card and on the CPU from the same weights and batch:
   the loss, each parameter, BN statistic and SGD momentum buffer within
   the stated tolerances; the step timed (ms between events, steps/s,
   device ms and operations, the device's idle share over a traced chunk);
   ``train_golden_embedder`` (25 steps of its recipe) with its ``.pt``
   reloaded into a fresh engine bit for bit, and ``evaluate_retrieval``
   over 16 identities with ``use_pallas=True`` (B4) and ``False``, the
   same rank-1 lists; ``train_golden_ag`` from ``card_weights/yolov5n.pt``
   (its gates through B1 / B2 / B3, the reload bit for bit);
   ``train_golden_mtcnn`` on 12 composites (B1 / B3, the reload bit for
   bit); three res10-ssd and ov-0204 steps against the CPU's, res10's BN
   statistics unmoved, the exported ``.caffemodel`` / ``.xml`` reloaded by
   ``FaceEngine.load_weights`` giving the in-memory net's detections bit
   for bit. The gates' verdicts are printed, not asserted; each trainer is
   a part of the path;
20. multi-device: single-process meshes over the card (``parallel/``;
   the entries repeat the card, or are dealt over the cards of a larger
   host): yolov5s ``detect_batch_sharded`` and the yolov5s +
   mobile_facenet + age/gender ensemble (``mesh=``, thresholds 0) on the 8
   frames over 2 "data" entries, BlazeFace-front ``detect_batch_sharded``,
   ``topk_similar(mesh=, use_pallas=True)`` of 512 queries against a
   seeded 524,288 x 512 gallery over 2 "model" entries (B4 a shard, then
   the merge), and the dynamic int8 yolov5n ``detect_batch_sharded`` (the
   whole batch's absmax a layer, Q1 with that scale); each a part of the
   path, held bit for bit to the unsharded call on each piece of the batch
   (int8: each piece quantized with the whole batch's scales), held to
   the unsharded call on the whole batch within ``MD_WHOLE_TOL`` (cuDNN
   picks a convolution's algorithm by its batch size: the valid masks
   equal, boxes and landmarks within 1 px, the crops of equal boxes equal;
   the search must equal the whole search bit for bit), and timed (ms between events, sharded and
   unsharded; the search also on tensors already on the card against B4
   alone). B1 and B2 must
   launch on the detect, ensemble and int8 parts, B3 on the ensemble, B5
   fused on BlazeFace, B4 on the search and Q1 on int8. Then the
   MobileFaceNet B = 48 ArcFace step DP + TP on a 2 x 2 mesh (4 classes,
   the kernel split by classes) against the unsharded step on the card,
   within phase 19's tolerances, both timed; and ``parallel.mp_demo`` as
   one rank over NCCL (world size 1) in both modes, each result equal to
   the same job on a one-entry mesh in this process;
21. main path, video (``utils/video.py``, ``core.inference
   .inference_vid``): a Motion-JPEG AVI of 64 576 x 1024 frames (the
   golden image scaled to the golden gate's own letterbox scale, at eight
   places on an 8-pixel lattice in turn) and one of the negative image,
   written under the gitignored ``build/chip_smoke/video/``;
   ``inference_vid`` of yolov5s with ``card_weights/yolov5s.pt`` at the
   default micro-batch (B1, B2), each frame bit for bit equal to
   ``detect_batch`` on its decoded block of 32 and passing the golden gate
   of ``expected.json`` at its three thresholds, with its place's boxes
   and negative frame; the fused age/gender route (B3), each frame equal
   to the ensemble call on its block and its labels to the staged
   ``detect_age_gender``; ``detect_face -i clip.avi --md blazeface-front``
   in process (B5 fused); ``extract_faces`` over a class tree holding the
   clip (frames 0, 25 and 50 sampled, a [45, D] ``.npy``); the written AVI
   read back, each frame the JPEG of its annotated frame. Each part zeroes
   the launch counts before it and reads them after, with the kernels'
   calls spied where the path makes them and replayed against their plain
   versions bit for bit after it. Then frames/s file to annotated file at
   micro-batch 8 and 32, decode and encode ms a frame (one thread, and the
   reader's and writer's threads), device ms a block, the synchronizing
   calls in one block's dispatch (``torch.cuda.set_sync_debug_mode``), and
   the device's idle share over a traced loop
   (``utils.trace_analysis.idle_share``);
22. reference: the detector's raw maps, MobileFaceNet's embeddings, the
   age/gender heads' logits, both BlazeFace nets' raw heads, yolov5s6's
   and yolov5s-official's raw maps and FaceNet's and reid-mnv2's
   embeddings on the card against the same modules on the CPU.

The line before the last is a JSON object of per-kernel numbers, and the last
line is ``{"ok": true, "device": {...}}``. Any failure propagates: the script
then exits non-zero and prints no result. Without a CUDA device, or without
the repository beside it, it fails at once.
"""
import collections
import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import torch

from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine, _full_f32)
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.models.yolov5_face import \
    FACE_ANCHORS
from face_detection_and_recognition_tpu_torch.ops.preprocess import \
    AGE_GENDER
from face_detection_and_recognition_tpu_torch.utils.profiling import (
    captured_calls, cuda_ms, detect_nms_inputs, device_ms, device_ops,
    spied_calls)

T0 = time.time()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32, outside the tensor cores
B, K = 8, 1024              # frames per batch, NMS candidates per frame
SEED = 0


def say(msg):
    print(msg, flush=True)


def phase_end(name):
    say(f"[{name}] done at {time.time() - T0:.1f} s")


TEMPLATE_ARGS = {"h": "uint8", "f": "float", "Lb0E": "false", "Lb1E": "true"}


def kernel_resources(report):
    """(kernel, registers, static shared bytes, stack bytes) of each kernel
    in nvcc's ``-Xptxas -v`` report."""
    rows, name, stack = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"\d+([a-z_]+_kernel)", mangled).group(1)
            rest = mangled.split("_kernelI", 1)[1:]  # template arguments
            if rest:
                args, rest = [], rest[0]
                while (t := re.match(r"h|f|L[bi](\d+)E", rest)):
                    args.append(TEMPLATE_ARGS.get(t.group(0), t.group(1)))
                    rest = rest[t.end():]
                name += "<%s>" % ", ".join(args)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0), stack))
            name = None
    return rows


NMS_OPTION_SETS = ((False, True, "union"), (True, False, "union"),
                   (True, False, "min"))


def nms_inputs(gen, b=B, k=K):
    """Score-sorted pixel boxes on a 640 canvas with duplicate boxes and
    invalid rows, as the detect path hands them to the NMS."""
    xy = torch.rand((b, k, 2), generator=gen) * 600
    wh = torch.rand((b, k, 2), generator=gen) * 80 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 100:140] = boxes[:, 0:40]            # identical boxes
    valid = torch.rand((b, k), generator=gen) > 0.1
    return boxes.cuda(), valid.cuda()


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def nms_work(boxes, valid, keep):
    """(operations, bytes) that greedy NMS needs on these inputs: the IoU
    of each kept box with each later valid box (2 max, 2 min, 2 sub, 2 add,
    2 clamp, 1 mul for the intersection, add, sub, add eps for the union,
    div, compare: 16 ops) and the areas (5 ops) of the valid boxes; the
    valid boxes and every valid flag read, the keep mask written."""
    v = valid.int()
    later = v.flip(1).cumsum(1).flip(1) - v   # valid rows after each row
    pairs = int((later * keep.int()).sum())
    n_valid = int(v.sum())
    return 16 * pairs + 5 * n_valid, 16 * n_valid + 2 * valid.numel()


def check_nms(gen):
    """B1 against its plain version in every option set: the kernel row
    (B = 8, K = 1024), K = 1000 (a ragged last block), B = 1, and K = 8192
    (the cap: 256 blocks, 64 KB of staged rows); then the kernel row
    shifted by class as ``multiclass_nms`` shifts it."""
    boxes, valid = nms_inputs(gen)
    extra = torch.Generator().manual_seed(SEED + 10)
    cases = [(f"B={B} K={K}", boxes, valid),
             (f"B={B} K=1000", *nms_inputs(extra, B, 1000)),
             (f"B=1 K={K}", *nms_inputs(extra, 1, K)),
             ("B=1 K=8192", *nms_inputs(extra, 1, 8192))]
    err = 0.0
    for case, bx, vd in cases:
        for plus1, strict, mode in NMS_OPTION_SETS:
            got = ck.nms_fixpoint(bx, vd, 0.3, plus1, strict, mode)
            ref = ck.nms_fixpoint_plain(bx, vd, 0.3, plus1, strict, mode)
            torch.cuda.synchronize()
            mism = int((got != ref).sum())
            err = max(err, float((got.int() - ref.int()).abs().max()))
            say(f"  nms_fixpoint {case} plus1={plus1} strict={strict} "
                f"mode={mode}: kept {int(got.sum())} of {int(vd.sum())}, "
                f"mismatches {mism}")
            if mism:
                raise AssertionError("nms_fixpoint differs from its plain "
                                     "version")
    # multiclass_nms's input: the boxes shifted by class * 4096, strict
    # IoU > 0.5, no +1 px. Classes 76-79, the largest shifts (coordinates
    # up to ~3.3e5, where an f32 ulp is 1/32 px), and the duplicated rows
    # in their originals' class, so that the pass has work to do
    cls = torch.randint(76, 80, (B, K), generator=extra)
    cls[:, 100:140] = cls[:, 0:40]
    shifted = (boxes + (cls.float().cuda() * 4096.0)[..., None]).contiguous()
    got = ck.nms_fixpoint(shifted, valid, 0.5, False, True, "union")
    ref = ck.nms_fixpoint_plain(shifted, valid, 0.5, False, True, "union")
    torch.cuda.synchronize()
    say(f"  nms_fixpoint B={B} K={K} class-shifted (classes 76-79, up to "
        f"{float(shifted.max()):.1f}) strict union: kept {int(got.sum())} of "
        f"{int(valid.sum())}, mismatches {int((got != ref).sum())}")
    if not torch.equal(got, ref):
        raise AssertionError("nms_fixpoint differs from its plain version "
                             "on class-shifted boxes")
    # the detect path's option set: +1 px IoU, suppress at IoU >= 0.3
    args = (boxes, valid, 0.3, True, False, "union")
    ms = cuda_ms(lambda: ck.nms_fixpoint(*args), 50)
    ops = device_ops(lambda: ck.nms_fixpoint(*args), 50)
    dev_ms = sum(t * n for t, n in ops.values())
    if dev_ms <= 0:
        say("  torch.profiler recorded no device time for nms_fixpoint: "
            "its time between CUDA events stands in")
        dev_ms = ms
    phases = {re.search(r"\w+_kernel", name).group(0): t
              for name, (t, _) in ops.items() if "_kernel" in name}
    say(f"  nms_fixpoint B={B} K={K} device ms by kernel: {phases}")
    plain_ms = cuda_ms(lambda: ck.nms_fixpoint_plain(*args), 5)
    big = cases[-1][1:] + (0.3, True, False, "union")
    big_ms = cuda_ms(lambda: ck.nms_fixpoint(*big), 20)
    ops, nbytes = nms_work(boxes, valid, ck.nms_fixpoint(*args))
    bound_ms, bound_by = bound(ops, nbytes)
    # the bound over every pair i < j of all K rows, as earlier runs gave it
    all_pairs_ms = B * (K * (K - 1) // 2 * 16 + 5 * K) / F32_OPS_PER_S * 1e3
    say(f"  nms_fixpoint B={B} K={K}: {ms:.5f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}; all {K} x {K} pairs: {all_pairs_ms:.6f} ms); "
        f"B=1 K=8192: {big_ms:.5f} ms")
    return dict(
        name="nms_fixpoint", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/nms.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:90",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        k8192_ms=big_ms, phase_ms=phases)


def check_nms_on_path(eng, frames):
    """B1 on the candidates that the detect path hands it for ``frames``:
    against its plain version, timed, and its keep counts."""
    args, kwargs = detect_nms_inputs(eng, frames)
    with torch.inference_mode():
        got = ck.nms_fixpoint(*args, **kwargs)
        ref = ck.nms_fixpoint_plain(*args, **kwargs)
        if not torch.equal(got, ref):
            raise AssertionError("nms_fixpoint differs from its plain version"
                                 " on the detect path's candidates")
        ms = cuda_ms(lambda: ck.nms_fixpoint(*args, **kwargs), 200)
        dev_ms, _ = device_ms(lambda: ck.nms_fixpoint(*args, **kwargs), 50)
    bound_ms, bound_by = bound(*nms_work(args[0], args[1], got))
    say(f"  nms_fixpoint on the detect path's candidates "
        f"{tuple(args[0].shape)}: valid a frame {args[1].sum(1).tolist()}, "
        f"kept {got.sum(1).tolist()}; {ms:.5f} ms between events, "
        f"{dev_ms:.5f} ms device, bound {bound_ms:.6f} ms ({bound_by})")
    return dict(path_ms=ms, path_device_ms=dev_ms, path_bound_ms=bound_ms,
                path_kept=got.sum(1).tolist(),
                path_valid=args[1].sum(1).tolist())


# B2's level layouts: yolov5s-face's P5 at the square and rect letterbox
# sizes, and the P6 layout of yolov5s6-face (four levels) at 640 x 640
FACE_ANCHORS_P6 = (((6.0, 7.0), (9.0, 11.0), (13.0, 16.0)),
                   ((18.0, 23.0), (26.0, 33.0), (37.0, 47.0)),
                   ((54.0, 67.0), (77.0, 104.0), (112.0, 154.0)),
                   ((174.0, 238.0), (258.0, 355.0), (445.0, 568.0)))
DECODE_LAYOUTS = (("P5 640x640", FACE_ANCHORS, (8, 16, 32), (640, 640)),
                  ("P5 640x384", FACE_ANCHORS, (8, 16, 32), (640, 384)),
                  ("P6 640x640", FACE_ANCHORS_P6, (8, 16, 32, 64), (640, 640)))
CONF = 0.4  # YoloV5FaceConfig.conf_thres


def decode_inputs(gen, anchors, strides, wh, dtype):
    """Raw maps of one layout (w, h) and their top-K rows by sigmoid
    objectness, stable among ties, as the detect path ranks them. Every
    97th objectness logit is saturated (a tie at 1.0), the rest are
    N(-7, 3), so that a part of the K candidates passes CONF."""
    w, h = wh
    levels = []
    for anc, s in zip(anchors, strides):
        m = torch.randn((B, len(anc) * (h // s) * (w // s), 16),
                        generator=gen) * 3
        m[..., 4] -= 7.0
        m[:, ::97, 4] = 30.0
        levels.append(m.to(dtype).cuda())
    obj = torch.cat([m[..., 4] for m in levels], 1).float()
    idx = torch.sort(torch.sigmoid(obj), dim=1, descending=True,
                     stable=True).indices[:, :K].to(torch.int32).contiguous()
    return levels, idx


def max_ulps(a, b):
    """The largest distance in float32 ulps between two f32 tensors."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def host_us(fn, iters=1000):
    """Host microseconds per call of ``fn``, the calls issued back to back
    (the device keeps up, so this is the cost of issuing one)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sec = time.perf_counter() - t
    torch.cuda.synchronize()
    return sec / iters * 1e6


def check_decode(gen):
    """B2, the fused candidate gather + decode, against its plain version
    bit for bit: f32 and bf16 maps, in each of the three layouts. Timed on
    the detect path's own case, P5 640x640 f32 maps."""
    result, err = None, 0.0
    for name, anchors, strides, wh in DECODE_LAYOUTS:
        for dtype in (torch.float32, torch.bfloat16):
            levels, idx = decode_inputs(gen, anchors, strides, wh, dtype)
            args = (levels, idx, anchors, strides, wh, CONF)
            got = ck.candidate_decode(*args)
            ref = ck.candidate_decode_plain(*args)
            torch.cuda.synchronize()
            e = max(float((g.float() - r.float()).abs().max())
                    for g, r in zip(got, ref))
            err = max(err, e)
            say(f"  rows_gather (gather + decode) {name} {dtype}: [{B}, {K}]"
                f" from levels {[m.shape[1] for m in levels]}, "
                f"{int(got[2].sum())} valid; max abs err {e}, pred "
                f"{max_ulps(got[0], ref[0])} ulps, boxes "
                f"{max_ulps(got[1], ref[1])} ulps, valid equal "
                f"{torch.equal(got[2], ref[2])}")
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise AssertionError("candidate_decode differs from its "
                                     "plain version")
            if result is not None or dtype != torch.float32:
                continue
            def kernel():
                return ck.candidate_decode(*args)
            flat = torch.cat(levels, 1)
            idx3 = idx.long()[..., None].expand(B, K, 16)
            ms = cuda_ms(kernel, 200)
            dev_ms, _ = device_ms(kernel, 50)
            us = host_us(kernel)
            plain_ms = cuda_ms(lambda: ck.candidate_decode_plain(*args), 50)
            # yardsticks, never called by the port: no single PyTorch call
            # computes the fused function; one gather on the prebuilt
            # concat, and that gather followed by the plain decode
            gather_ms = cuda_ms(lambda: torch.gather(flat, 1, idx3), 200)
            gather_decode_ms = cuda_ms(lambda: ck.decode_candidates_plain(
                torch.gather(flat, 1, idx3), idx, anchors, strides, wh,
                CONF), 50)
            say(f"  rows_gather: {ms:.5f} ms a call between events, "
                f"{dev_ms:.5f} ms on the device (profiler), {us:.1f} us of "
                f"host a call; torch.gather {gather_ms:.5f} ms, torch.gather"
                f" + plain decode {gather_decode_ms:.5f} ms")
            # the selected raw rows and the indices read once; the decoded
            # rows, boxes and valid bytes written once
            nbytes = B * K * (16 * 4 + 4 + 16 * 4 + 16 + 1)
            bound_ms, bound_by = bound(0, nbytes)
            result = dict(
                name="rows_gather", route="cuda",
                source="face_detection_and_recognition_tpu_torch/csrc/"
                       "rows_gather.cu",
                replaces="face_detection_and_recognition_tpu/ops/"
                         "pallas_kernels.py:545",
                ms=ms, device_ms=dev_ms, host_us=us, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, gather_ms=gather_ms,
                gather_decode_ms=gather_decode_ms)
    result["max_abs_err"] = err
    return result


# face crops (MobileFaceNet), age/gender crops, FaceNet's and the reid
# embedder's crops
CROP_HW = ((112, 112), (227, 227), (160, 160), (128, 128))
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


CROP_ODD_HW = (45, 31)          # rows of 93 floats: odd spans
CROP_EPILOGUES = ((False, None), (True, None), (True, AGE_GENDER.mean))


def crop_heads(n_slots, out_hw, c=3):
    """(CTA spans, spans whose first float is not 16-byte aligned) of a
    launch with this many slots, as csrc/crop_resize.cu tiles the output
    (rows of about 2048 pixels a CTA)."""
    oh, ow = out_hw
    rows = max(1, min(oh, 2048 // ow))
    r0 = np.arange(0, oh, rows)
    offs = (np.arange(n_slots)[:, None] * oh + r0[None]) * ow * c
    return offs.size, int((offs % 4 != 0).sum())


def check_crop(gen, frames):
    """B3 against its plain version: both box semantics, the crop sizes of
    the ensembles (112, 227, 160 and 128) and an odd one, uint8 frames (the
    engine's) and f32 frames stretched past [0, 255], each with the
    epilogue off, clip only and clip + the age/gender mean, each in the
    f32 store and the bf16 one (the bf16 ensemble's age/gender crops).
    Timed at 227 x 227 with clip + mean in both stores, and at 160 x 160
    and 128 x 128 with the clip alone (the embedders' face crops)."""
    boxes, valid = crop_inputs(gen, frames)
    f32 = frames.float() * 1.5 - 100.0
    err = 0.0
    for hw in CROP_HW + (CROP_ODD_HW,):
        spans, heads = crop_heads(B * CROP_K, hw)
        for clamp in (True, False):
            for img in (frames, f32):
                for clip, mean in CROP_EPILOGUES:
                    got = ck.crop_resize(img, boxes, valid, hw, clamp, clip,
                                         mean)
                    ref = ck.crop_resize_plain(img, boxes, valid, hw, clamp,
                                               clip, mean)
                    torch.cuda.synchronize()
                    e = float((got - ref).abs().max())
                    err = max(err, e)
                    say(f"  crop_resize {hw[0]}x{hw[1]} clamp={clamp} "
                        f"{img.dtype} clip={clip} mean={mean is not None}: "
                        f"[{B}, {CROP_K}] boxes, {int(valid.sum())} live, "
                        f"{heads} of {spans} spans with a head; max abs err "
                        f"{e}")
                    if not torch.equal(got, ref):
                        raise AssertionError("crop_resize differs from its "
                                             "plain version")
                    dead = torch.zeros(3, device=got.device) if mean is None \
                        else -torch.tensor(mean, device=got.device)
                    if not bool((got[~valid] == dead).all()):
                        raise AssertionError("crop_resize: an invalid slot "
                                             "is not 0 - mean")
                    got = ck.crop_resize(img, boxes, valid, hw, clamp, clip,
                                         mean, out_dtype=torch.bfloat16)
                    ref = ck.crop_resize_plain(img, boxes, valid, hw, clamp,
                                               clip, mean,
                                               out_dtype=torch.bfloat16)
                    torch.cuda.synchronize()
                    if not same_bits(got, ref):
                        e = float((got.float() - ref.float()).abs().max())
                        raise AssertionError(
                            f"crop_resize's bf16 store differs from its "
                            f"plain version by up to {e}")
                    if not bool((got[~valid] == dead.to(got.dtype)).all()):
                        raise AssertionError("crop_resize bf16: an invalid "
                                             "slot is not bf16(-mean)")
    # timed on the 227 x 227 age/gender crops as the ensemble runs them
    # (clamp, uint8, clip and mean fused), the larger of the path's two
    hw = CROP_HW[1]
    base = (frames, boxes, valid, hw, True)
    args = base + (True, AGE_GENDER.mean)
    mean_t = torch.tensor(AGE_GENDER.mean, device=frames.device)

    def unfused():  # what the engine ran before the epilogue was fused
        out = ck.crop_resize(*base)
        out.clamp_(0.0, 255.0)
        out -= mean_t
        return out

    if not torch.equal(unfused(), ck.crop_resize(*args)):
        raise AssertionError("the fused epilogue differs from the passes")
    ms = cuda_ms(lambda: ck.crop_resize(*args), 50)
    bare_ms = cuda_ms(lambda: ck.crop_resize(*base), 50)
    unfused_ms = cuda_ms(unfused, 50)
    dev_ms, _ = device_ms(lambda: ck.crop_resize(*args), 20)
    plain_ms = cuda_ms(lambda: ck.crop_resize_plain(*args), 5)
    # the library call: one grid_sample at the same sample coordinates; it
    # computes the crop alone, without the clip and the mean
    library, lib_nhwc = grid_sample_crop(frames, boxes, hw, True)
    library_ms = cuda_ms(library, 50)
    lib_out = lib_nhwc(library())
    lib_err = float((torch.where(valid[..., None, None, None], lib_out, 0.0)
                     - ck.crop_resize(*base)).abs().max())
    say(f"  grid_sample {hw[0]}x{hw[1]} against the kernel: max abs err "
        f"{lib_err:.3g} (its own rounding of the coordinates)")
    # every output slot written once (invalid slots included), the box
    # regions of the live slots read once, boxes and valid read
    nbytes = (B * CROP_K * hw[0] * hw[1] * 3 * 4
              + crop_read_bytes(frames, boxes, valid, hw, True)
              + B * CROP_K * (16 + 1))
    bound_ms, bound_by = bound(0, nbytes)
    say(f"  crop_resize {hw[0]}x{hw[1]}: {ms:.5f} ms with clip + mean "
        f"fused, {bare_ms:.5f} ms without the epilogue, {unfused_ms:.5f} ms "
        f"as crop + clamp_ + -= (the passes it replaces); bound "
        f"{bound_ms:.5f} ms; {int(valid.sum())} of {B * CROP_K} slots live")
    by_size = {}
    for side in (160, 128):
        face = (frames, boxes, valid, (side, side), True, True, None)
        face_ms = cuda_ms(lambda: ck.crop_resize(*face), 50)
        face_bound = bound(0, B * CROP_K * side * side * 3 * 4
                           + crop_read_bytes(frames, boxes, valid,
                                             (side, side), True)
                           + B * CROP_K * (16 + 1))[0]
        by_size[side] = (face_ms, face_bound)
        say(f"  crop_resize {side}x{side} with clip (an embedder's face "
            f"crops): {face_ms:.5f} ms, bound {face_bound:.5f} ms")
    # the bf16 store of the bf16 ensemble: the same samples, half the bytes
    # written
    bf16 = dict(out_dtype=torch.bfloat16)
    bf16_ms = cuda_ms(lambda: ck.crop_resize(*args, **bf16), 50)
    bf16_dev, _ = device_ms(lambda: ck.crop_resize(*args, **bf16), 20)
    bf16_plain = cuda_ms(lambda: ck.crop_resize_plain(*args, **bf16), 5)
    bf16_bound = bound(0, B * CROP_K * hw[0] * hw[1] * 3 * 2
                       + crop_read_bytes(frames, boxes, valid, hw, True)
                       + B * CROP_K * (16 + 1))[0]
    say(f"  crop_resize {hw[0]}x{hw[1]} with clip + mean, bf16 store: "
        f"{bf16_ms:.5f} ms ({bf16_dev:.5f} ms device), plain "
        f"{bf16_plain:.4f} ms, bound {bf16_bound:.5f} ms (bytes), against "
        f"{ms:.5f} ms for the f32 store")
    return dict(
        name="crop_resize", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/crop_resize.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:420",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        no_epilogue_ms=bare_ms, unfused_ms=unfused_ms,
        ms_160=by_size[160][0], bound_ms_160=by_size[160][1],
        ms_128=by_size[128][0], bound_ms_128=by_size[128][1],
        bf16_ms=bf16_ms, bf16_device_ms=bf16_dev, bf16_plain_ms=bf16_plain,
        bf16_bound_ms=bf16_bound)


TOPK_N, TOPK_M, TOPK_D, TOPK_K = 512, 524288, 512, 5  # the similarity path
TOPK_TOL = 1e-6  # |cosine| gap under which two orders may differ


def unit_rows(x):
    return x / x.norm(dim=1, keepdim=True)


def close_ranks(s, tol=TOPK_TOL):
    """[N, k] mask of the ranks whose score lies within ``tol`` of a
    neighbour's: there a product summed in another order may swap them.
    Given k + 1 scores, it also flags the last rank against the next."""
    gap = s[:, :-1] - s[:, 1:]
    near = torch.zeros_like(s, dtype=torch.bool)
    near[:, :-1] |= gap <= tol
    near[:, 1:] |= gap <= tol
    return near


def check_topk(gen):
    """B4 against its plain version (the FMA chain, bit for bit, on the full
    gallery) and against the default search path (a full-f32 matrix product
    and a stable top-k) at the similarity path's shape: unit queries
    against a unit gallery."""
    from face_detection_and_recognition_tpu_torch.pipelines.similarity \
        import _f32_matmul, _topk_stable

    q = unit_rows(torch.randn((TOPK_N, TOPK_D), generator=gen,
                              device="cuda"))
    g = unit_rows(torch.randn((TOPK_M, TOPK_D), generator=gen,
                              device="cuda"))
    g[TOPK_M - 1] = g[12345]  # an exact tie: the smaller index first
    q[7] = g[12345]
    got = ck.topk_gallery(q, g, TOPK_K)
    torch.cuda.synchronize()
    # the plain version once, timed between events: it takes seconds
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = ck.topk_gallery_plain(q, g, TOPK_K)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got[0] - ref[0]).abs().max())
    say(f"  topk_gallery [{TOPK_N}, {TOPK_D}] x [{TOPK_M}, {TOPK_D}], "
        f"k {TOPK_K}, against the plain FMA chain on the whole gallery: max "
        f"abs err {err}, indices equal {torch.equal(got[1], ref[1])}")
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError("topk_gallery differs from its plain version")
    if int(got[1][7, 0]) != 12345 or int(got[1][7, 1]) != TOPK_M - 1:
        raise AssertionError("topk_gallery broke an exact tie wrongly")

    def library():
        with _f32_matmul():
            return torch.topk(q @ g.T, TOPK_K)

    with _f32_matmul():  # one rank more, to see the k-th rank's gap
        mm_s, mm_i = _topk_stable(q @ g.T, TOPK_K + 1)
    far = ~close_ranks(mm_s)[:, :TOPK_K]
    mism = int((mm_i[:, :TOPK_K].int() != got[1])[far].sum())
    serr = float((mm_s[:, :TOPK_K] - got[0]).abs().max())
    say(f"  topk_gallery against the matrix-product path: max |score "
        f"difference| {serr:.2e}, index mismatches {mism} among "
        f"{int(far.sum())} ranks more than {TOPK_TOL} from a neighbour")
    if mism or serr > TOPK_TOL:
        raise AssertionError("topk_gallery disagrees with the matmul path")
    ms = cuda_ms(lambda: ck.topk_gallery(q, g, TOPK_K), 10)
    dev_ms, _ = device_ms(lambda: ck.topk_gallery(q, g, TOPK_K), 10)
    library_ms = cuda_ms(library, 10)
    with _f32_matmul():  # the product alone, for scale: cuBLAS's f32 rate
        matmul_ms = cuda_ms(lambda: q @ g.T, 10)
    # every score is D multiply-adds; queries and gallery read once, scores
    # and indices written once
    ops = 2 * TOPK_N * TOPK_M * TOPK_D
    nbytes = (TOPK_N + TOPK_M) * TOPK_D * 4 + TOPK_N * TOPK_K * 8
    bound_ms, bound_by = bound(ops, nbytes)
    met = ms < library_ms and ms <= 2 * bound_ms
    say(f"  topk_gallery: {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s), "
        f"torch.topk(q @ g.T) {library_ms:.3f} ms, q @ g.T alone "
        f"{matmul_ms:.3f} ms ({ops / matmul_ms / 1e9:.1f} TFLOP/s), bound "
        f"{bound_ms:.3f} ms; target (faster than the library call, within "
        f"2x the bound) {'met' if met else 'missed'}")
    return dict(
        name="topk_gallery", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/"
               "topk_gallery.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:186",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        matmul_ms=matmul_ms)


BLEND_B, BLEND_K, BLEND_OUT = 8, 896, 16  # 8 frames of BlazeFace anchors


def blend_inputs(gen, b, k):
    """Score-sorted BlazeFace rows [ymin, xmin, ymax, xmax, 12 kps, score]
    in clusters of overlapping boxes, with an inverted box and invalid
    rows, as the decode hands them to the blend NMS."""
    centers = torch.rand((b, 40, 2), generator=gen) * 0.8
    pick = torch.randint(0, 40, (b, k), generator=gen)
    c = torch.take_along_dim(centers, pick[..., None], 1) \
        + torch.randn((b, k, 2), generator=gen) * 0.01
    wh = 0.05 + torch.rand((b, k, 2), generator=gen) * 0.02
    dets = torch.cat([c, c + wh, torch.rand((b, k, 13), generator=gen)], -1)
    dets[:, 3, 2:4] = dets[:, 3, 0:2] - 0.05          # inverted box
    valid = torch.rand((b, k), generator=gen) > 0.3
    order = torch.argsort(torch.where(valid, dets[..., 16], -1e30), dim=1,
                          descending=True, stable=True)
    return (torch.take_along_dim(dets, order[..., None], 1).cuda(),
            torch.take_along_dim(valid, order, 1).cuda())


def blend_work(sdets, svalid, thr, max_out):
    """(IoUs, taken rows) that the blend NMS computes on these inputs: one
    IoU a slot for each row alive at its pick, and each taken row blended
    once."""
    y1, x1, y2, x2 = sdets[..., :4].unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    alive, ious, taken = svalid.clone(), 0, 0
    rows = torch.arange(sdets.shape[1], device=sdets.device)
    for _ in range(max_out):
        ious += int(alive.sum())
        f = alive.to(torch.uint8).argmax(1, keepdim=True)
        iw = (torch.minimum(x2.gather(1, f), x2)
              - torch.maximum(x1.gather(1, f), x1)).clamp(min=0)
        ih = (torch.minimum(y2.gather(1, f), y2)
              - torch.maximum(y1.gather(1, f), y1)).clamp(min=0)
        inter = iw * ih
        over = alive & ((inter / ((area.gather(1, f) + area) - inter) > thr)
                        | (rows == f))
        taken += int(over.sum())
        alive &= ~over
    return ious, taken


def same_bits(a, b):
    """Equal tensors, float32 and bfloat16 ones compared bit for bit."""
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        if a.dtype == dtype and b.dtype == dtype:
            return a.shape == b.shape and torch.equal(a.view(bits),
                                                      b.view(bits))
    return a.dtype == b.dtype and torch.equal(a, b)


def singleton_rows(gen, k):
    """K score-sorted rows of boxes that overlap no other: every row is a
    slot of its own, so max_out > 32 slots run past the kernel's first
    chunk of picks."""
    dets = torch.zeros((1, k, 17))
    dets[0, :, 0] = dets[0, :, 1] = torch.arange(k, dtype=torch.float32)
    dets[0, :, 2:4] = dets[0, :, 0:2] + 0.5
    dets[0, :, 4:16] = torch.randn((k, 12), generator=gen)
    dets[0, :, 16] = torch.linspace(1.0, 0.5, k)
    return dets.cuda(), torch.ones((1, k), dtype=torch.bool).cuda()


def wide_rows(gen, b, k, d):
    """``blend_inputs`` rows widened to D columns (random coords inserted
    before the score): at K = 2048 and D = 32 the rows exceed the
    kernel's shared-memory budget, so the blend reads them from L2."""
    sd, sv = blend_inputs(gen, b, k)
    extra = torch.rand((b, k, d - 17), generator=gen).cuda()
    return torch.cat([sd[..., :16], extra, sd[..., 16:]], -1), sv


def check_blend(gen):
    """B5's standalone entry point against its plain version, bit for bit:
    the BlazeFace shape (8 frames of 896 rows), fewer rows than slots,
    nothing valid, K = 2048 (the cap; 139 KB of rows staged), K = 1500 (two
    words a pick warp, the last one ragged), K = 2048 at D = 32 (rows read
    from L2), and 40 slots (past the first chunk of 32 picks)."""
    sd, sv = blend_inputs(gen, BLEND_B, BLEND_K)
    cases = [(sd, sv, BLEND_OUT), (*blend_inputs(gen, 2, 10), BLEND_OUT),
             (sd, torch.zeros_like(sv), BLEND_OUT),
             (*blend_inputs(gen, 2, 2048), BLEND_OUT),
             (*blend_inputs(gen, 2, 1500), BLEND_OUT),
             (*wide_rows(gen, 2, 2048, 32), BLEND_OUT),
             (*singleton_rows(gen, 100), 40)]
    err = 0.0
    for d, v, m in cases:
        got = ck.blend_nms(d, v, 0.3, m)
        ref = ck.blend_nms_plain(d, v, 0.3, m)
        torch.cuda.synchronize()
        e = float((got[0] - ref[0]).abs().max())
        err = max(err, e)
        say(f"  blend_nms {list(d.shape)} max_out={m}: "
            f"{int(v.sum())} valid rows, {int(got[1].sum())} picks, "
            f"max abs err {e}")
        if not (same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])):
            raise AssertionError("blend_nms differs from its plain version")
    ms = cuda_ms(lambda: ck.blend_nms(sd, sv, 0.3, BLEND_OUT), 200)
    dev_ms, _ = device_ms(lambda: ck.blend_nms(sd, sv, 0.3, BLEND_OUT), 50)
    plain_ms = cuda_ms(lambda: ck.blend_nms_plain(sd, sv, 0.3, BLEND_OUT), 2)
    big = cases[3]
    k2048_ms = cuda_ms(lambda: ck.blend_nms(*big[:2], 0.3, BLEND_OUT), 50)
    ious, taken = blend_work(sd, sv, 0.3, BLEND_OUT)
    # an IoU: 2 max, 2 min, 2 sub, 2 clamp, 1 mul, the other box's area
    # (2 sub, 1 mul), add, sub, div, compare = 15; a taken row: a multiply
    # and two adds a column, then a divide a column a slot
    ops = ious * 15 + taken * 17 * 3 + BLEND_B * BLEND_OUT * 17
    # what the function must read: every valid byte, the box (cols 0:4) of
    # every valid row, the rest of each taken row; it writes the slots'
    # rows and valid bytes
    nbytes = (BLEND_B * BLEND_K + int(sv.sum()) * 16 + taken * (17 - 4) * 4
              + BLEND_B * BLEND_OUT * (17 * 4 + 1))
    say(f"  blend_nms bound: {ious} IoUs, {taken} taken rows, {nbytes} bytes"
        f" read and written, {ops} operations; B=2 K=2048: {k2048_ms:.5f} ms")
    bound_ms, bound_by = bound(ops, nbytes)
    return dict(
        name="blend_nms", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/blend_nms.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:689",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        k2048_ms=k2048_ms)


# (net, scale, score threshold) of the two BlazeFace detectors
BLAZE_NETS = (("back", 256.0, 0.65), ("front", 128.0, 0.75))
BLAZE_CLIP, BLAZE_IOU = 100.0, 0.3


def blaze_heads(gen, b, thr, case="ties", n=896):
    """Raw BlazeFace heads [B, n, 16], [B, n, 1] on the card: box offsets
    in input pixels, logits spread around the score threshold with every
    97th at +150 (ties at sigmoid 1.0) and every 101st at -150, and anchor
    10 an inverted box at +150. "none" puts every logit below the
    threshold, "all" every one above it, "nan" makes every 13th logit NaN
    (and anchor 10 stays +150)."""
    logit = float(np.log(thr / (1 - thr)))
    boxes = torch.randn((b, n, 16), generator=gen) * 6
    boxes[..., 2:4] = torch.rand((b, n, 2), generator=gen) * 20 + 10
    boxes[:, 10, 2:4] = -20.0
    noise = torch.randn((b, n, 1), generator=gen) * 1.5
    scores = logit + noise
    if case == "none":
        scores = logit - 0.01 - noise.abs()
    elif case == "all":
        scores = logit + 0.01 + noise.abs()
    if case != "none":
        scores[:, ::97] = 150.0
        scores[:, 10] = 150.0
    if case == "ties":
        scores[:, 5::101] = -150.0
    if case == "nan":
        scores[:, 3::13] = float("nan")
    return boxes.cuda(), scores.cuda()


def blaze_anchors(n):
    """n anchor rows on the card: BlazeFace's 896, cut or repeated."""
    from face_detection_and_recognition_tpu_torch.models.blazeface import \
        generate_anchors

    a = generate_anchors()
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate([a] * (n // len(a) + 1))[:n])).cuda()


def same_rows_nan(got, ref):
    """The fused entry point's output against its plain version where NaN
    may appear: bit for bit, else the same slots valid and the same values
    with NaN in the same places. Returns how they matched, or None."""
    if same_bits(got[0], ref[0]) and same_bits(got[1], ref[1]):
        return "equal bits"
    if torch.equal(got[1], ref[1]) and torch.equal(
            torch.isnan(got[0]), torch.isnan(ref[0])) and torch.equal(
            torch.nan_to_num(got[0]), torch.nan_to_num(ref[0])):
        return "the same rows (NaN payloads differ)"
    return None


def blaze_args(raw_boxes, raw_scores, anchors, scale, thr):
    return (raw_boxes, raw_scores, anchors, scale, BLAZE_CLIP, thr,
            BLAZE_IOU, BLEND_OUT)


def blaze_work(args):
    """(operations, bytes) that BlazeFace's postprocess needs on these
    inputs: the clip, sigmoid (counted as 4) and threshold of every score,
    the decode of each valid row (3 operations a column, 4 more for the box
    corners), n log2 n comparisons to sort a frame's n valid rows, and the
    blend NMS's IoUs and blends (``check_blend``); every input byte read
    once and the slots written."""
    from face_detection_and_recognition_tpu_torch.models.blazeface import \
        decode_boxes
    from face_detection_and_recognition_tpu_torch.ops.nms import \
        sort_by_score

    raw_boxes, raw_scores, anchors, scale, clip, thr, iou, max_out = args
    scores = torch.sigmoid(raw_scores[..., 0].clamp(-clip, clip))
    dets = torch.cat([decode_boxes(raw_boxes, anchors, scale),
                      scores[..., None]], -1)
    valid = scores >= thr
    _, _, sv, sd = sort_by_score(scores, valid, dets)
    ious, taken = blend_work(sd, sv, iou, max_out)
    nv = valid.sum(1).double()
    sort_ops = int((nv * torch.log2(nv.clamp(min=2))).sum())
    b, n = valid.shape
    ops = (b * n * 7 + int(nv.sum()) * (16 * 3 + 4) + sort_ops + ious * 15
           + taken * 17 * 3 + b * max_out * 17)
    nbytes = sum(t.numel() * 4 for t in (raw_boxes, raw_scores, anchors)) \
        + b * max_out * (17 * 4 + 1)
    return ops, nbytes


def check_fused_case(label, args):
    """The fused entry point against its plain version on ``args``, bit
    for bit (where NaN appears: equal bits, or the same rows). Returns the
    max abs difference (0)."""
    got = ck.blaze_decode_blend(*args)
    ref = ck.blaze_decode_blend_plain(*args)
    torch.cuda.synchronize()
    e = float(torch.nan_to_num(got[0] - ref[0]).abs().max())
    scores = torch.sigmoid(args[1][..., 0].clamp(-BLAZE_CLIP, BLAZE_CLIP))
    how = same_rows_nan(got, ref)
    say(f"  blaze_decode_blend {label}: valid anchors a frame "
        f"{(scores >= args[5]).sum(1).tolist()}, picks "
        f"{got[1].sum(1).tolist()}, max abs err {e}; {how}")
    if how is None:
        raise AssertionError(f"blaze_decode_blend differs from its plain "
                             f"version ({label})")
    return e


def check_blaze_decode(gen):
    """B5's fused entry point (decode, sigmoid, threshold, sort, blend NMS,
    reorder) against its plain version, bit for bit, for both nets at
    B = 8: seeded heads with ties at sigmoid 1.0 and an inverted box,
    nothing above the threshold, every anchor above it; then NaN raw
    scores, and anchor counts other than 896 (600, and 1000 near the cap of
    1024). Timed on the back net's seeded heads."""
    from face_detection_and_recognition_tpu_torch.models.blazeface import \
        generate_anchors

    anchors = torch.from_numpy(generate_anchors()).cuda()
    err, timed = 0.0, None
    for net, scale, thr in BLAZE_NETS:
        for case in ("ties", "none", "all"):
            args = blaze_args(*blaze_heads(gen, B, thr, case), anchors,
                              scale, thr)
            err = max(err, check_fused_case(f"{net} B={B} {case}", args))
            if timed is None:
                timed = args
    _, scale, thr = BLAZE_NETS[0]
    for n, case in ((896, "nan"), (600, "ties"), (1000, "ties"),
                    (1000, "nan")):
        args = blaze_args(*blaze_heads(gen, B, thr, case, n),
                          blaze_anchors(n), scale, thr)
        err = max(err, check_fused_case(f"back B={B} N={n} {case}", args))
    ms = cuda_ms(lambda: ck.blaze_decode_blend(*timed), 200)
    dev_ms, _ = device_ms(lambda: ck.blaze_decode_blend(*timed), 50)
    plain_ms = cuda_ms(lambda: ck.blaze_decode_blend_plain(*timed), 2)
    ops, nbytes = blaze_work(timed)
    bound_ms, bound_by = bound(ops, nbytes)
    say(f"  blaze_decode_blend back B={B}: {ms:.5f} ms, device "
        f"{dev_ms:.5f} ms; bound: "
        f"{ops} operations, {nbytes} bytes, {bound_ms:.6f} ms ({bound_by})")
    return dict(
        name="blaze_decode_blend", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/blend_nms.cu",
        replaces="face_detection_and_recognition_tpu/ops/pallas_kernels.py:689",
        fuses="face_detection_and_recognition_tpu/models/blazeface.py:144",
        max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_blaze_on_path(engines, frames):
    """On the raw heads that each BlazeFace net gives for ``frames``: the
    fused kernel against its plain version, and the engine's fused stage
    against the ops layer's route to the same rows (``decode_boxes``, the
    sigmoid and threshold, ``ops.nms.weighted_blend_nms``: the standalone
    B5), both bit for bit; the fused kernel timed on the back net's."""
    from face_detection_and_recognition_tpu_torch.models.blazeface import (
        BlazeFaceConfig, decode_boxes, generate_anchors)
    from face_detection_and_recognition_tpu_torch.ops.nms import \
        weighted_blend_nms

    anchors = torch.from_numpy(generate_anchors()).cuda()
    out = {}
    for name, eng in engines.items():
        cfg = BlazeFaceConfig(back_model=name == "blazeface-back",
                              **eng.cfg.detector_overrides)
        with torch.inference_mode():
            x = eng._preprocess(eng._frames(frames))
            raw_boxes, raw_scores = eng._network(x)
            args = blaze_args(raw_boxes, raw_scores, anchors, cfg.scale,
                              cfg.min_score_thresh)
            check_fused_case(f"on the {name} path's heads", args)
            dets, valid = eng._decode((raw_boxes, raw_scores),
                                      tuple(x.shape[1:3]))
            scores = torch.sigmoid(raw_scores[..., 0].clamp(
                -cfg.score_clipping_thresh, cfg.score_clipping_thresh))
            above = scores >= cfg.min_score_thresh
            rows = torch.cat([decode_boxes(raw_boxes, anchors, cfg.scale),
                              scores[..., None]], -1)
            ops_dets, ops_valid = weighted_blend_nms(
                rows, above, cfg.min_suppression_threshold, cfg.max_faces)
            ops_dets = ops_dets[..., [1, 0, 3, 2] + list(range(4, 17))]
            if name == "blazeface-back":
                out["path_ms"] = cuda_ms(
                    lambda: ck.blaze_decode_blend(*args), 200)
                out["path_device_ms"] = device_ms(
                    lambda: ck.blaze_decode_blend(*args), 50)[0]
                out["path_bound_ms"] = bound(*blaze_work(args))[0]
        if not (same_bits(dets, ops_dets) and torch.equal(valid, ops_valid)):
            raise AssertionError(f"{name}: the fused stage and the ops "
                                 "layer's route differ")
        above = above.sum(1)
        say(f"  {name}: anchors above {cfg.min_score_thresh} a frame "
            f"{above.tolist()} of 896; blend NMS picks "
            f"{valid.sum(1).tolist()}, equal bit for bit through the fused "
            "kernel and through decode_boxes + weighted_blend_nms")
        if not bool(((above > 0) & (above < 896)).all()):
            raise AssertionError("every or no anchor passes: the blend NMS "
                                 "would have nothing to do")
    say(f"  blaze_decode_blend on the back path's heads: "
        f"{out['path_ms']:.5f} ms between events, {out['path_device_ms']:.5f}"
        f" ms device, bound {out['path_bound_ms']:.6f} ms")
    return out


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
    return dict(ck.LAUNCHES), r


def run_similarity(emb, card):
    """The similarity main path: the ensemble's live embeddings searched
    with ``topk_similar`` on both paths against a seeded numpy gallery of
    IMDB-WIKI's size, then ``filter_embeddings`` on the card. Returns the
    launch counts of this path alone, and the normalised gallery on the
    card (the export phase searches it)."""
    from face_detection_and_recognition_tpu_torch.pipelines import \
        similarity as S

    t = time.time()
    gallery = np.random.default_rng(SEED + 3).standard_normal(
        (TOPK_M, TOPK_D), dtype=np.float32)
    say(f"  gallery [{TOPK_M}, {TOPK_D}] f32 ({gallery.nbytes / 2**30:.2f} "
        f"GiB) drawn on the host in {time.time() - t:.2f} s; queries: "
        f"{emb.shape[0]} live embeddings of the ensemble batch")
    # what topk_similar spends on the host: its numpy normalisation, and
    # the copy of the gallery to the card
    t = time.time()
    g = S.normalize_rows(gallery)
    t_norm = time.time() - t
    t = time.time()
    g_card = torch.as_tensor(g, device="cuda")
    torch.cuda.synchronize()
    t_copy = time.time() - t
    del g
    for use_kernel in (True, False):
        S.topk_similar(emb[:8], gallery[:4096], k=TOPK_K,
                       use_pallas=use_kernel)  # warm-up
    torch.cuda.synchronize()
    ck.reset_launches()
    out = {}
    for use_kernel in (True, False):
        t = time.time()
        out[use_kernel] = S.topk_similar(emb, gallery, k=TOPK_K,
                                         use_pallas=use_kernel)
        sec = time.time() - t
        say(f"  topk_similar(k={TOPK_K}, use_pallas={use_kernel}): "
            f"{sec * 1e3:.1f} ms on {card}, of which the host's "
            f"normalisation ~{t_norm * 1e3:.1f} ms and the gallery's copy "
            f"~{t_copy * 1e3:.1f} ms")
    (ks, ki), (ms_, mi) = out[True], out[False]
    far = ~close_ranks(torch.from_numpy(ks)).numpy()
    mism = int((ki != mi)[far].sum())
    if ks.shape != (emb.shape[0], TOPK_K) or not np.isfinite(ks).all():
        raise AssertionError("topk_similar returned bad scores")
    if mism or np.abs(ks - ms_).max() > TOPK_TOL:
        raise AssertionError(f"the two search paths disagree: {mism} "
                             "indices")
    say(f"  both paths: equal indices at {int(far.sum())} of {far.size} "
        f"ranks more than {TOPK_TOL} from a neighbour (the rest within it),"
        f" max |score difference| {np.abs(ks - ms_).max():.2e}; best "
        f"cosine {ks[:, 0].max():.4f}")
    # up to 16 classes of 16 references from the first embeddings; the
    # rest, each held to one class, are filtered (no reference row sits on
    # its own class's threshold)
    n_cls = max(1, min(16, emb.shape[0] // 32))
    refs = [S.ClassReference(str(c), *S.ref_mean_and_threshold(
        emb[c * 16:(c + 1) * 16])) for c in range(n_cls)]
    probes = emb[n_cls * 16:]
    ids = np.arange(probes.shape[0]) % n_cls
    keep = S.filter_embeddings(probes, refs, ids)
    keep_cpu = S.filter_embeddings(probes, refs, ids, device="cpu")
    say(f"  filter_embeddings on the card: {int(keep.sum())} of {len(keep)}"
        f" clean against {n_cls} classes, "
        f"{int((keep != keep_cpu).sum())} differ from the CPU's")
    if keep.shape != (probes.shape[0],) or (keep != keep_cpu).any():
        raise AssertionError("filter_embeddings on the card is off")
    torch.cuda.synchronize()
    return dict(ck.LAUNCHES), g_card


def run_blazeface(frames, singles, card):
    """The BlazeFace main path: the back (256 x 256) and front (128 x 128)
    detectors on the 8 frames and on single frames, through the engine's
    entry points alone. Returns the launch counts of this path alone, and
    the engines."""
    t = time.time()
    engines = {name: FaceEngine(EngineConfig(detector=name, seed=SEED))
               for name in ("blazeface-back", "blazeface-front")}
    say(f"  engines built in {time.time() - t:.1f} s")
    ck.reset_launches()
    for name, eng in engines.items():
        eng.detect_batch(frames)
        torch.cuda.synchronize()
        t = time.time()
        reps = 5
        for _ in range(reps):
            dets = eng.detect_batch(frames)
        torch.cuda.synchronize()
        sec = (time.time() - t) / reps
        want = {"boxes": (B, 16, 4), "scores": (B, 16), "lmarks": (B, 16, 12),
                "valid": (B, 16)}
        for field, shape in want.items():
            arr = getattr(dets, field)
            if tuple(arr.shape) != shape:
                raise AssertionError(f"{name} {field} shape "
                                     f"{tuple(arr.shape)}")
            if field != "valid" and not bool(torch.isfinite(arr).all()):
                raise AssertionError(f"{name}: non-finite {field}")
        say(f"  {name} detect_batch: {B} x 576x1024 frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; "
            f"detections per frame {dets.valid.sum(1).tolist()}")
        for i, img in enumerate(singles):
            t = time.time()
            res = eng.detect_image(img)
            if not (np.isfinite(res.boxes).all()
                    and res.boxes.shape[1:] == (4,)):
                raise AssertionError("detect_image returned bad boxes")
            say(f"  {name} detect_image request {i}: {len(res)} faces in "
                f"{(time.time() - t) * 1e3:.2f} ms")
    torch.cuda.synchronize()
    return dict(ck.LAUNCHES), engines


FAMILY_SLOTS = ("facenet-512", "reid-mnv2", "demographics")
EMBED_N = 512                # crops a net runs on in the timed calls


class Windows:
    """Launch counts of a main path driven in parts: each part zeroes the
    counts just before it and reads them just after; the path's counts are
    the parts' sums."""

    def __init__(self):
        self.parts = {}

    def run(self, name, fn):
        ck.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        self.parts[name] = dict(ck.LAUNCHES)
        return out

    def total(self):
        return {k: sum(p[k] for p in self.parts.values())
                for k in ck.LAUNCHES}


def timed_batches(fn, reps):
    """(result, seconds a call) of ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t) / reps


def check_dets(name, dets, n_lmk, k=64):
    want = {"boxes": (B, k, 4), "scores": (B, k), "lmarks": (B, k, n_lmk),
            "valid": (B, k)}
    for field, shape in want.items():
        arr = getattr(dets, field)
        if tuple(arr.shape) != shape:
            raise AssertionError(f"{name} {field} shape {tuple(arr.shape)}")
        if field != "valid" and not bool(torch.isfinite(arr).all()):
            raise AssertionError(f"{name}: non-finite {field}")


def check_on_path(label, fn, plain, calls):
    """A kernel's wrapper against its plain version on the arguments the
    path handed it (``calls``, from ``captured_calls``), bit for bit."""
    with torch.inference_mode():
        for args, kwargs in calls:
            got, ref = fn(*args, **kwargs), plain(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            if not all(same_bits(g, r) for g, r in zip(got, ref)):
                raise AssertionError(f"{label} differs from its plain "
                                     "version on the path's own inputs")
    say(f"  {label}: {len(calls)} calls of the path held to the plain "
        "version, equal bit for bit")


def run_family(frames, card):
    """The yolov5 family + embedders main path: yolov5s6 (four levels)
    square, rect and at 960 x 960; yolov5s-official (nc 80, no landmarks,
    class-offset NMS); yolov5s6 + FaceNet + age/gender through the
    ensemble; embed_crops and embed_faces through facenet-512, reid-mnv2
    and demographics. Returns the path's launch counts, the numbers to
    print, and the nets for the reference phase."""
    from face_detection_and_recognition_tpu_torch.models import \
        yolov5_face
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.ops import nms as nms_ops

    win, stats, nets = Windows(), {}, {}
    t = time.time()
    s6 = {key: FaceEngine(EngineConfig(detector="yolov5s6", rect=rect,
                                       seed=SEED, detector_overrides=ov))
          for key, rect, ov in (("square", False, {}), ("rect", True, {}),
                                ("960", False, {"input_size": (960, 960)}))}
    official = FaceEngine(EngineConfig(detector="yolov5s-official",
                                       seed=SEED))
    ens = FaceEngine(EngineConfig(detector="yolov5s6", embedder="facenet",
                                  with_age_gender=True, seed=SEED))
    slots = {name: FaceEngine(EngineConfig(detector="blazeface-front",
                                           embedder=name, seed=SEED))
             for name in FAMILY_SLOTS}
    say(f"  engines built in {time.time() - t:.1f} s")

    # yolov5s6: square 640, rect 640x384, square 960
    def s6_run(key, reps):
        dets, sec = timed_batches(
            lambda: s6[key].detect_batch(frames, 0.0, 0.0), reps)
        check_dets(f"yolov5s6 {key}", dets, 10)
        stats[f"s6_{key}_fps"] = B / sec
        say(f"  yolov5s6 detect_batch {key} ({s6[key].input_size} box): "
            f"{B} x 576x1024 frames in {sec * 1e3:.2f} ms = {B / sec:.1f} "
            f"frames/s on {card}; detections per frame "
            f"{dets.valid.sum(1).tolist()}")

    for key, reps in (("square", 3), ("rect", 3), ("960", 1)):
        win.run(f"s6 {key}", lambda: s6_run(key, reps))
    for key in ("square", "rect", "960"):
        for k in ("nms_fixpoint", "rows_gather"):
            if win.parts[f"s6 {key}"][k] <= 0:
                raise AssertionError(f"{k} never launched on yolov5s6 {key}")
    # B2's calls on the path: four levels, each layout's own input size
    b2 = {}
    for key in ("square", "rect", "960"):
        calls = captured_calls(
            yolov5_face, "candidate_decode",
            lambda: s6[key].detect_batch(frames, 0.0, 0.0))
        b2[key] = calls
        levels = {len(a[0]) for a, _ in calls}
        sizes = {a[4] for a, _ in calls}
        say(f"  rows_gather on yolov5s6 {key}: {len(calls)} call(s), "
            f"levels {sorted(levels)}, input sizes {sorted(sizes)}, level "
            f"rows {[m.shape[1] for m in calls[0][0][0]]}")
        if levels != {4}:
            raise AssertionError("yolov5s6's gather did not take 4 levels")
    check_on_path("rows_gather (4 levels) on yolov5s6's maps",
                  ck.candidate_decode, ck.candidate_decode_plain,
                  [c for calls in b2.values() for c in calls])
    nms_calls = captured_calls(
        yolov5_face, "nms_fixpoint",
        lambda: s6["square"].detect_batch(frames, 0.0, 0.0))
    check_on_path("nms_fixpoint on yolov5s6's candidates", ck.nms_fixpoint,
                  ck.nms_fixpoint_plain, nms_calls)
    nets["s6"] = s6["square"].net

    # the official head: 85 columns, no landmarks, class-offset NMS
    def official_run():
        dets, sec = timed_batches(
            lambda: official.detect_batch(frames, 0.0, 0.0), 3)
        check_dets("yolov5s-official", dets, 0)
        stats["official_fps"] = B / sec
        stats["official_dets"] = dets.valid.sum(1).tolist()
        say(f"  yolov5s-official detect_batch (nc 80): {B} x 576x1024 "
            f"frames in {sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on "
            f"{card}; detections per frame {stats['official_dets']} (with "
            f"area > 0 of the {official.cfg.max_det} slots)")

    win.run("official", official_run)
    if win.parts["official"]["nms_fixpoint"] <= 0:
        raise AssertionError("nms_fixpoint never launched on the official "
                             "path")
    calls = captured_calls(nms_ops, "nms_fixpoint",
                           lambda: official.detect_batch(frames, 0.0, 0.0))
    (args, kwargs), = calls
    with torch.inference_mode():
        got = ck.nms_fixpoint(*args, **kwargs)
        ref = ck.nms_fixpoint_plain(*args, **kwargs)
        if not torch.equal(got, ref):
            raise AssertionError("nms_fixpoint differs from its plain "
                                 "version on the official path's "
                                 "class-shifted candidates")
        ms = cuda_ms(lambda: ck.nms_fixpoint(*args, **kwargs), 200)
        dev_ms, _ = device_ms(lambda: ck.nms_fixpoint(*args, **kwargs), 50)
    bound_ms, bound_by = bound(*nms_work(args[0], args[1], got))
    stats["official_b1"] = dict(
        ms=ms, device_ms=dev_ms, bound_ms=bound_ms,
        valid=args[1].sum(1).tolist(), kept=got.sum(1).tolist(),
        max_coord=float(args[0][args[1]].abs().max()))
    say(f"  nms_fixpoint on the official path's class-shifted candidates "
        f"{tuple(args[0].shape)} (strict={kwargs.get('strict')}, "
        f"plus1={kwargs.get('plus1')}): coordinates up to "
        f"{stats['official_b1']['max_coord']:.1f}, valid a frame "
        f"{stats['official_b1']['valid']}, kept {stats['official_b1']['kept']}"
        f"; equal bit for bit to the plain version; {ms:.5f} ms between "
        f"events, {dev_ms:.5f} ms device, bound {bound_ms:.6f} ms "
        f"({bound_by})")
    nets["official"] = official.net

    # yolov5s6 + FaceNet + age/gender, every NMS survivor a live slot
    def ensemble_run():
        r, sec = timed_batches(lambda: ens.detect_embed_classify_batch(
            frames, det_thres=0.0, bbox_area_thres=0.0), 2)
        v = r.det.valid
        want = {"crops": (B, 64, 160, 160, 3), "embeddings": (B, 64, 128),
                "age_probs": (B, 64, 8), "gender_probs": (B, 64, 2)}
        for name, shape in want.items():
            arr = getattr(r, name)
            if tuple(arr.shape) != shape or not bool(
                    torch.isfinite(arr).all()):
                raise AssertionError(f"facenet ensemble {name}: "
                                     f"{tuple(arr.shape)}")
        norm_err = float((r.embeddings[v].norm(dim=-1) - 1).abs().max())
        if not (int(v.sum()) > 0 and norm_err <= 1e-4):
            raise AssertionError("facenet ensemble: no live slot or "
                                 "embeddings not unit")
        stats["facenet_ensemble_fps"] = B / sec
        say(f"  yolov5s6 + facenet + age/gender detect_embed_classify_batch"
            f": {B} x 576x1024 frames in {sec * 1e3:.2f} ms = "
            f"{B / sec:.1f} frames/s on {card}; live slots "
            f"{v.sum(1).tolist()}; max |norm - 1| {norm_err:.2e}")
        return r

    res = win.run("facenet ensemble", ensemble_run)
    if win.parts["facenet ensemble"]["crop_resize"] <= 0:
        raise AssertionError("crop_resize never launched on the facenet "
                             "ensemble")
    faces = res.crops[res.det.valid][:EMBED_N].cpu().numpy()
    frame0 = np.ascontiguousarray(frames[0])
    post0 = ens.detect_image(frame0, 0.0, 0.0)
    boxes0 = post0.boxes[:32]

    def slot_run(name):
        eng = slots[name]
        emb = eng.embed_crops(faces)
        per_face = eng.embed_faces(frame0, boxes0)
        dim = eng.embed_spec.dim
        if emb.shape != (len(faces), dim) or per_face.shape != (
                len(boxes0), dim) or not (np.isfinite(emb).all()
                                          and np.isfinite(per_face).all()):
            raise AssertionError(f"{name}: bad embeddings")
        return emb

    for name in FAMILY_SLOTS:
        win.run(name, lambda: slot_run(name))
        if win.parts[name]["crop_resize"] <= 0:
            raise AssertionError(f"crop_resize never launched for {name}")
    # B3 at each slot's size on the path's own frames and boxes
    b3 = captured_calls(crop_ops, "crop_resize",
                        lambda: ens.detect_embed_classify_batch(
                            frames, 0.0, 0.0))
    for name in FAMILY_SLOTS:
        b3 += captured_calls(crop_ops, "crop_resize",
                             lambda: slots[name].embed_faces(frame0, boxes0))
    sizes = sorted({a[3] for a, _ in b3})
    say(f"  crop_resize output sizes on the path: {sizes}")
    for hw in ((160, 160), (128, 128), (227, 227)):
        if hw not in sizes:
            raise AssertionError(f"crop_resize never ran at {hw}")
    check_on_path("crop_resize at the path's sizes", ck.crop_resize,
                  ck.crop_resize_plain, b3)
    # each net's device time on up to EMBED_N crops at its own size
    frames_t = torch.from_numpy(frames).cuda()
    live = res.det.valid
    per_net = {"facenet": ens}
    per_net.update(slots)
    with torch.inference_mode():
        for name, eng in per_net.items():
            w, h = eng.embed_spec.input_size
            crops = crop_ops.crop_for_net(frames_t, res.det.boxes, (h, w),
                                          live)[live][:EMBED_N].contiguous()
            net_ms = cuda_ms(lambda: eng._embed(crops), 5)
            dev, n_ops = device_ms(lambda: eng._embed(crops), 3)
            stats[f"{name}_ms"] = (len(crops), net_ms, dev)
            say(f"  {name} ({h}x{w}, {eng.embed_spec.dim}-d): "
                f"{len(crops)} crops in {net_ms:.2f} ms between events, "
                f"{dev:.2f} ms device ({n_ops} device operations) on {card}")
    nets["facenet"] = ens.embed_net
    nets["reid"] = slots["reid-mnv2"].embed_net
    stats["windows"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in win.parts.items()}
    return win.total(), stats, nets


IO_HW = (576, 1024)          # the serving frame: the reference's video size
IO_QUALITY = 95
IO_MAE = 2.0                 # round-trip bound, mean |decoded - frame|
N_REQUESTS = 8
WORK_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def smooth_frame(seed, hw=IO_HW):
    """A seeded BGR frame of low-frequency sinusoids (not noise), so that
    a JPEG round trip at quality 95 loses little."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    img = np.full((*hw, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.uniform(0.0005, 0.004, 2)
            img[..., c] += 28 * np.sin(2 * np.pi * (fx * x + fy * y)
                                       + rng.uniform(0, 6.28))
    return np.clip(img, 0, 255).astype(np.uint8)


def printed_faces(text):
    """The CLI's face lines -> (int boxes [N, 4], confs, suffixes)."""
    rows = [li.split() for li in text.splitlines()
            if li.strip().startswith("[")]
    boxes = np.array([[int(v) for v in r[0].strip("[]").split(",")]
                      for r in rows], np.int64).reshape(-1, 4)
    confs = [float(r[1].split("=")[1]) for r in rows]
    return boxes, confs, [" ".join(r[2:]) for r in rows]


def run_cli(module, argv):
    """``module.main(argv)`` in process: (its stdout, seconds); fails
    unless it returns 0."""
    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    if rc != 0:
        raise AssertionError(f"{module.__name__} {argv} returned {rc}")
    return buf.getvalue(), time.time() - t


def http(url, body=None):
    """One request; returns (JSON answer, client ms)."""
    req = urllib.request.Request(url, data=body,
                                 method="GET" if body is None else "POST")
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.load(r)
    return out, (time.perf_counter() - t) * 1e3


def in_new_thread(fn, *args):
    """``fn(*args)`` on a thread started for it; returns its result."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn(*args)))
    th.start()
    th.join(timeout=300)
    if not out:
        raise AssertionError("the call on a new thread did not return")
    return out[0]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ms_summary(ms):
    return {"p50_ms": float(np.percentile(ms, 50)), "max_ms": float(max(ms)),
            "n": len(ms)}


def check_answers(name, answers, ref):
    """HTTP answers against the service's direct call on the same frame:
    boxes and confs to 1e-4, embeddings to 1e-5, labels equal."""
    for a in answers:
        np.testing.assert_allclose(a["bboxes"], ref["bboxes"], atol=1e-4,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(a["confs"], np.ravel(ref["confs"]),
                                   atol=1e-4, rtol=0, err_msg=name)
        if "embeddings" in ref:
            np.testing.assert_allclose(a["embeddings"], ref["embeddings"],
                                       atol=1e-5, rtol=0, err_msg=name)
            if a["labels"] != ref["labels"]:
                raise AssertionError(f"{name}: labels differ")


def batched_refs(service, frame, sizes):
    """{b: the service's answer for ``frame`` in an engine call of b copies
    of it}, b in ``sizes``, on the service's engine thread; every row of a
    call must answer alike."""
    refs = {}
    for b in sorted(set(sizes)):
        res = service._on_device(
            service.engine.detect_embed_classify_batch,
            np.stack([frame] * b), 0.0, 0.0, crop_size=service.cfg.face_size,
            want_embed=False, want_ag=False)
        posts = res.det.to_numpy()
        rows = [{"bboxes": np.asarray(p.boxes, np.float32),
                 "confs": np.asarray(p.bbox_confs, np.float32)}
                for p in posts]
        for r in rows[1:]:
            check_answers(f"a batch of {b}", [r], rows[0])
        refs[b] = rows[0]
    return refs


def check_batched(service, frame, answers, dispatch_sizes):
    """The dynamic batcher's answers against the engine's answers at the
    sizes it dispatched (``dispatch_sizes``, the batcher's record {size:
    dispatches}: groups run at their own size). cuDNN picks its
    convolution algorithms by batch size, so a coordinate that rounds at
    x.5 can land a pixel apart between sizes. The requests all carry the
    same frame, so a dispatch of size b owes b answers equal to the
    engine's answer in a batch of b: the answers are matched one to one to
    those slots, each exactly (1e-4), and the sizes whose answer differs
    from a lone frame's are printed. Returns {size: dispatches}."""
    sizes = dict(sorted(dispatch_sizes.items()))
    slots = [b for b, n in sizes.items() for _ in range(b * n)]
    if len(slots) != len(answers):
        raise AssertionError(f"the batcher dispatched {sizes} (size: "
                             f"dispatches) for {len(answers)} answers")
    refs = batched_refs(service, frame, list(sizes) + [1])

    def same(a, r):
        try:
            check_answers("", [a], r)
            return True
        except AssertionError:
            return False

    def as_answer(r):
        return {"bboxes": r["bboxes"].tolist(), "confs": r["confs"].tolist()}

    differ = [b for b in refs if not same(as_answer(refs[b]), refs[1])]
    for i, a in enumerate(answers):
        hit = next((j for j, b in enumerate(slots) if same(a, refs[b])),
                   None)
        if hit is None:
            raise AssertionError(
                f"batched answer {i} equals the engine's answer at none of "
                f"the sizes still owed {sorted(set(slots))} (dispatched "
                f"{sizes})")
        slots.pop(hit)
    say(f"  batched /detect answers: dispatched {sizes} (size: "
        f"dispatches), each answer equal to the engine's at its "
        f"dispatch's size; sizes whose answer differs from a lone frame's: "
        f"{differ or 'none'}")
    return sizes


def grpc_detect_once(service, data):
    """One Detect request through the gRPC front door of ``service`` on
    127.0.0.1 (thresholds 0): (its JSON answer, client ms). The server is
    stopped before this returns."""
    from face_detection_and_recognition_tpu_torch.serving.grpc_server import (
        grpc_call, grpc_detect, make_grpc_server)

    port = free_port()
    server = make_grpc_server(service, "127.0.0.1", port, max_workers=2)
    server.start()
    addr = f"127.0.0.1:{port}"
    try:
        if json.loads(grpc_call(addr, "Health")) != {"ready": True}:
            raise AssertionError("gRPC Health is not ready")
        t = time.perf_counter()
        out = grpc_detect(addr, data, det_thres=0.0, bbox_area_thres=0.0)
        return out, (time.perf_counter() - t) * 1e3
    finally:
        server.stop(None)


def run_cli_serving(card, device="cuda"):
    """The CLI + serving main path. Returns its launch counts and the
    numbers to print: the JPEG route's, the CLI's, the requests'."""
    from face_detection_and_recognition_tpu_torch.cli import detect_face
    from face_detection_and_recognition_tpu_torch.serving.http_server import \
        serve
    from face_detection_and_recognition_tpu_torch.serving.service import \
        ServiceConfig
    from face_detection_and_recognition_tpu_torch.utils import native

    stats = {}
    frame = smooth_frame(SEED + 4)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    jpg, out = str(WORK_DIR / "frame.jpg"), str(WORK_DIR / "out.jpg")
    t = time.time()
    codec = native.build_library().name
    say(f"  JPEG codec: {codec} (built in {time.time() - t:.2f} s)")
    native.write_image_bgr(jpg, frame, IO_QUALITY)
    decoded = native.read_image_bgr(jpg)
    err = np.abs(decoded.astype(np.int64) - frame)
    if decoded.shape != frame.shape or decoded.dtype != np.uint8 \
            or not err.mean() < IO_MAE:
        raise AssertionError(f"JPEG round trip off: {decoded.shape} "
                             f"{decoded.dtype}, mean error {err.mean()}")
    data = Path(jpg).read_bytes()
    if native.decode_jpeg_bgr(b"not a jpeg") is not None:
        raise AssertionError("garbage bytes decoded")
    gray = native.decode_jpeg_bgr(native.encode_jpeg_bgr(
        np.repeat(frame[..., 1:2], 3, axis=2), IO_QUALITY))
    if not (gray[..., 0] == gray[..., 1]).all():
        raise AssertionError("a gray frame did not come back gray")
    for fn, name in ((lambda: native.decode_jpeg_bgr(data), "decode"),
                     (lambda: native.encode_jpeg_bgr(frame, IO_QUALITY),
                      "encode")):
        fn()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        stats[f"{name}_ms"] = (time.perf_counter() - t) / 10 * 1e3
    stats.update(codec=codec, jpeg_bytes=len(data),
                 round_trip_mae=float(err.mean()),
                 round_trip_max=int(err.max()))
    say(f"  {IO_HW[1]}x{IO_HW[0]} frame at quality {IO_QUALITY}: "
        f"{len(data)} bytes, round trip mean |error| {err.mean():.3f} "
        f"(bound {IO_MAE}), max {err.max()}; decode "
        f"{stats['decode_ms']:.3f} ms, encode {stats['encode_ms']:.3f} ms a "
        f"frame on {card}")

    cli = ["-i", jpg, "--md", "yolov5s", "--dt", "0", "--at", "0",
           "--no-display", "-o", out, "-d", device]
    answers = {"detect": [], "ensemble": [], "batched": []}
    ms = {"detect": [], "ensemble": []}
    ck.reset_launches()
    text1, sec1 = run_cli(detect_face, cli)
    after_cli1 = dict(ck.LAUNCHES)
    text2, sec2 = run_cli(detect_face, cli + ["--age-gender", "--embedder",
                                 "mobile_facenet"])
    after_cli2 = dict(ck.LAUNCHES)
    httpd = serve(ServiceConfig(device=device), host="127.0.0.1",
                  port=free_port(), block=False)
    service = httpd.service
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        if http(base + "/health")[0] != {"ready": True}:
            raise AssertionError("/health is not ready")
        before_http = dict(ck.LAUNCHES)
        for _ in range(N_REQUESTS):
            a, t_ms = http(base + "/detect?det_thres=0&bbox_area_thres=0",
                           data)
            answers["detect"].append(a)
            ms["detect"].append(t_ms)
        for _ in range(N_REQUESTS):
            a, t_ms = http(base + "/ensemble", data)
            answers["ensemble"].append(a)
            ms["ensemble"].append(t_ms)
        answers["grpc"], stats["grpc_detect_ms"] = grpc_detect_once(
            service, data)
        batcher = service.enable_dynamic_batching(max_batch=N_REQUESTS,
                                                  max_delay_ms=50.0)
        threads = [threading.Thread(target=lambda: answers["batched"].append(
            http(base + "/detect?det_thres=0&bbox_area_thres=0", data)[0]))
            for _ in range(N_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if any(th.is_alive() for th in threads) \
                or len(answers["batched"]) != N_REQUESTS:
            raise AssertionError("a batched request did not answer")
        if device == "cuda":
            torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)   # the path's counts, read here
        http_launches = {k: launches[k] - before_http[k] for k in launches}
        batcher.shutdown()
        service._batcher = None       # the direct calls below run alone
        stats["batcher"] = {"requests": batcher.requests,
                            "dispatches": batcher.dispatches,
                            "sizes": dict(batcher.dispatch_sizes)}
        # what the path answered, against direct calls on the decoded frame
        ref_det = service.detect_faces(decoded, 0.0, 0.0)
        check_answers("/detect", answers["detect"] + [answers["grpc"]],
                      {"bboxes": ref_det[1], "confs": ref_det[2]})
        stats["batched_sizes"] = check_batched(
            service, decoded, answers["batched"], batcher.dispatch_sizes)
        ref_ens = service.detect_embed_classify(decoded)
        check_answers("/ensemble", answers["ensemble"],
                      {k: np.asarray(v) if k != "labels" else v
                       for k, v in ref_ens.items()})
        # why the service runs the engine on one thread of its own: the
        # same call from a new thread each time (as ThreadingHTTPServer
        # starts one a request), and through the service's engine thread
        for name, call in (
                ("a new thread each call", lambda: in_new_thread(
                    service._detect_faces, decoded, 0.0, 0.0)),
                ("the service's engine thread",
                 lambda: service.detect_faces(decoded, 0.0, 0.0))):
            t_ms = []
            for _ in range(4):
                t = time.perf_counter()
                call()
                t_ms.append((time.perf_counter() - t) * 1e3)
            stats[f"detect_faces_ms, {name}"] = t_ms
            say(f"  detect_faces from {name}: "
                f"{', '.join(f'{x:.2f}' for x in t_ms)} ms")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    # the CLI's printed faces against the engine's on the decoded frame
    eng = FaceEngine(EngineConfig(detector="yolov5s", det_thres=0.0,
                                  bbox_area_thres=0.0, seed=0), device=device)
    ref = eng.detect_image(decoded)
    boxes, confs, _ = printed_faces(text1)
    if f"{len(ref)} face(s)" not in text1 or \
            not np.array_equal(boxes, ref.boxes.astype(np.int64)) or \
            not np.allclose(confs, ref.bbox_confs, atol=5e-4, rtol=0):
        raise AssertionError("the CLI's faces differ from detect_image's")
    boxes2, _, suffix = printed_faces(text2)
    if not np.array_equal(boxes2, boxes) or not all(
            s.endswith("emb[512d]") and ":" in s for s in suffix):
        raise AssertionError("--age-gender --embedder printed other faces "
                             "or no labels")
    drawn = native.read_image_bgr(out)
    if drawn is None or drawn.shape != frame.shape:
        raise AssertionError("the CLI's output image does not decode")
    n_det = len(answers["detect"][0]["bboxes"])
    n_ens = len(answers["ensemble"][0]["labels"])
    stats.update(cli_s=(sec1, sec2), cli_faces=len(ref),
                 detect=ms_summary(ms["detect"]),
                 ensemble=ms_summary(ms["ensemble"]),
                 detect_faces=n_det, ensemble_faces=n_ens)
    say(f"  detect_face CLI: {len(ref)} face(s) in {sec1:.2f} s (engine "
        f"build included), with --age-gender --embedder mobile_facenet "
        f"{sec2:.2f} s; printed boxes equal detect_image's")
    say(f"  launches: CLI {after_cli1}; CLI --age-gender --embedder "
        f"{ {k: after_cli2[k] - after_cli1[k] for k in after_cli2} }; HTTP "
        f"{http_launches}")
    for name in ("detect", "ensemble"):
        say(f"  HTTP /{name}: {N_REQUESTS} sequential requests of a "
            f"{len(data)}-byte JPEG, p50 {stats[name]['p50_ms']:.2f} ms, max "
            f"{stats[name]['max_ms']:.2f} ms a request on {card}; "
            f"{stats[name + '_faces']} faces an answer")
    say(f"  gRPC /fdrt.FaceService/Detect: "
        f"{answers['grpc']['num_faces']} faces in "
        f"{stats['grpc_detect_ms']:.2f} ms (channel set-up included), equal "
        "to the service's direct call")
    say(f"  HTTP /detect, {N_REQUESTS} concurrent through the batcher: "
        f"requests {stats['batcher']['requests']}, dispatches "
        f"{stats['batcher']['dispatches']} (size: dispatches "
        f"{stats['batcher']['sizes']}); each answer equals the "
        "engine's in a batch of its dispatch's size")
    if stats["batcher"]["requests"] != N_REQUESTS:
        raise AssertionError("the batcher did not serve every request")
    for name, got in (("CLI", after_cli1), ("HTTP", http_launches)):
        for k in ("nms_fixpoint", "rows_gather") + (
                ("crop_resize",) if name == "HTTP" else ()):
            if got[k] <= 0:
                raise AssertionError(f"kernel {k} never launched in the "
                                     f"{name} window")
    if after_cli2["crop_resize"] - after_cli1["crop_resize"] <= 0:
        raise AssertionError("crop_resize never launched in the CLI's "
                             "--age-gender --embedder run")
    return launches, stats


PIPE_DIR = WORK_DIR / "pipelines"
PIPE_DEVICE = "cuda"         # where the phase's engines run
# seeded yolov5s saturates many scores at 1.0, so no threshold leaves one
# face an image; seeded BlazeFace spreads them
WIKI_DETECTOR = "blazeface-back"
PIPE_JPEGS = 48              # 576 x 1024 JPEGs a class
PIPE_BLOCK = 64
ODD_CROPS = ((1, 1), (1, 37), (53, 1), (3, 5), (17, 31), (111, 113))
CPU_TOL = 1e-4               # card vs CPU feature rows of the same boxes


def png_bytes(img):
    """A BGR uint8 image as an RGB PNG whose rows cycle through the five
    filter types (so the reader's unfilter runs each), zlib-compressed."""
    rows = img[..., ::-1].reshape(img.shape[0], -1).astype(np.int64)
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, r in enumerate(rows):
        kind = y % 5
        a = np.concatenate([np.zeros(3, np.int64), r[:-3]])
        c = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if kind == 4:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        else:
            pred = (0, a, prev, (a + prev) >> 1)[kind]
        out.append(bytes([kind]) + ((r - pred) & 255).astype(
            np.uint8).tobytes())
        prev = r

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    h, w = img.shape[:2]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out), 6))
            + chunk(b"IEND", b""))


def bmp_bytes(img):
    """A BGR uint8 image as a bottom-up 24-bit BMP."""
    h, w = img.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img.reshape(h, -1)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 2835,
                       2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + stride * h, 0, 0, 54) + info
            + rows[::-1].tobytes())


def pipeline_frames(n, seed):
    """``n`` distinct 576 x 1024 frames: rolled and flipped copies of four
    seeded smooth frames (cheap to make, and not noise, so the JPEG
    round trip stays close)."""
    bases = [smooth_frame(seed + i) for i in range(4)]
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        f = np.roll(bases[i % 4], tuple(rng.randint(0, 400, 2)), (0, 1))
        out.append(np.ascontiguousarray(f[:, ::-1] if i % 8 >= 4 else f))
    return out


def build_pipeline_trees():
    """The trees the phase reads, written through the port's encoder:
    ``faces/`` (two classes of 48 JPEGs, a PNG, a BMP, a WebP and a video),
    ``label/`` (8 JPEGs), ``crops/`` (two classes of 64 face-crop images of
    mixed sizes, JPEG, PNG and BMP), ``wiki/`` (32 images of mixed sizes
    and their .mat)."""
    from face_detection_and_recognition_tpu_torch.utils import native

    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    frames = pipeline_frames(2 * PIPE_JPEGS + 4, SEED + 10)
    for c, cls in enumerate(("class_a", "class_b")):
        d = PIPE_DIR / "faces" / cls
        d.mkdir(parents=True)
        mine = frames[c * (PIPE_JPEGS + 2):(c + 1) * (PIPE_JPEGS + 2)]
        for i in range(PIPE_JPEGS):
            native.write_image_bgr(str(d / f"f{i:02d}.jpg"), mine[i])
        (d / "p.png").write_bytes(png_bytes(mine[PIPE_JPEGS]))
        (d / "b.bmp").write_bytes(bmp_bytes(mine[PIPE_JPEGS + 1]))
        (d / "w.webp").write_bytes(b"RIFF\x1a\x00\x00\x00WEBPVP8 " + bytes(14))
        (d / "v.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42" + bytes(16))
    d = PIPE_DIR / "label" / "clip"
    d.mkdir(parents=True)
    for i, f in enumerate(frames[:8]):
        native.write_image_bgr(str(d / f"t{i}.jpg"), f)
    rng = np.random.RandomState(SEED + 11)
    for cls in ("id_a", "id_b"):
        d = PIPE_DIR / "crops" / cls
        d.mkdir(parents=True)
        for i in range(64):
            h, w = rng.randint(40, 200, 2)
            y, x = rng.randint(0, 576 - h), rng.randint(0, 1024 - w)
            crop = np.ascontiguousarray(frames[i % len(frames)][y:y + h,
                                                                x:x + w])
            kind = i % 4
            if kind == 2:
                (d / f"c{i}.png").write_bytes(png_bytes(crop))
            elif kind == 3:
                (d / f"c{i}.bmp").write_bytes(bmp_bytes(crop))
            else:
                native.write_image_bgr(str(d / f"c{i}.jpg"), crop)
    d = PIPE_DIR / "wiki"
    d.mkdir(parents=True)
    paths = []
    for i in range(32):
        h, w = rng.randint(200, 576), rng.randint(200, 1024)
        name = f"{i % 4:02d}/w{i}.{('jpg', 'png')[i % 2]}"
        (d / name).parent.mkdir(exist_ok=True)
        img = np.ascontiguousarray(frames[i % len(frames)][:h, :w])
        if i % 2:
            (d / name).write_bytes(png_bytes(img))
        else:
            native.write_image_bgr(str(d / name), img)
        paths.append(name)
    return paths


def write_wiki_mat(path, paths):
    from scipy.io import savemat

    n = len(paths)
    full_path = np.empty((1, n), object)
    for i, p in enumerate(paths):
        full_path[0, i] = np.array([p])
    savemat(str(path), {"wiki": {
        "full_path": full_path, "dob": np.full((1, n), 715876.0),
        "photo_taken": np.full((1, n), 2000.0), "gender": np.ones((1, n)),
        "face_score": np.full((1, n), 2.0),
        "second_face_score": np.full((1, n), np.nan)}})


def imdb_threshold(paths):
    """A --dt for the IMDB-WIKI run at which many of the seeded images have
    exactly one face (the pipeline keeps only those): the seeded detector's
    scores on the letterboxed images decide it."""
    from face_detection_and_recognition_tpu_torch.ops.geometry import \
        host_letterbox
    from face_detection_and_recognition_tpu_torch.utils.native import (
        IMAGE_EXTENSIONS, read_image_bgr)

    eng = FaceEngine(EngineConfig(detector=WIKI_DETECTOR, det_thres=0.0,
                                  bbox_area_thres=0.0, seed=0),
                     device=PIPE_DEVICE)
    iw, ih = eng.input_size
    block = np.stack([host_letterbox(
        read_image_bgr(str(PIPE_DIR / "wiki" / p), formats=IMAGE_EXTENSIONS),
        (ih, iw), eng.spec.preprocess.fill) for p in paths])
    posts = eng.detect_batch(block, 0.0, 0.0).to_numpy()
    tops = [np.sort(p.bbox_confs)[::-1][:2] for p in posts]
    cands = sorted({float(t[0]) - 1e-6 for t in tops if len(t)})

    def singles(dt):
        return int(sum((t > dt).sum() == 1 for t in tops))

    return max(cands, key=singles), max(singles(c) for c in cands)


def card_against_cpu(card_stats_dir):
    """extract_faces on 2 media a class (yolov5s + MobileFaceNet, seed 0,
    thresholds 0) on the card and on the CPU: per-media face counts equal,
    and the feature rows of the boxes both devices found within CPU_TOL.
    Returns (rows compared, boxes that flipped)."""
    from face_detection_and_recognition_tpu_torch.pipelines.extract_faces \
        import extract_faces_from_dataset
    from face_detection_and_recognition_tpu_torch.utils.native import (
        IMAGE_EXTENSIONS, read_image_bgr)

    sub = PIPE_DIR / "sub"
    for cls in ("class_a", "class_b"):
        (sub / cls).mkdir(parents=True)
        for name in ("f00.jpg", "p.png"):
            shutil.copy(PIPE_DIR / "faces" / cls / name, sub / cls / name)
    kw = dict(detector="yolov5s", det_thres=0.0, bbox_area_thres=0.0,
              embedder="mobile_facenet", seed=0)
    out = {}
    dets = {}
    for device in ("cuda", "cpu"):
        eng = FaceEngine(EngineConfig(**kw), device=(
            device if PIPE_DEVICE == "cuda" else "cpu"))
        extract_faces_from_dataset(eng, str(sub), str(PIPE_DIR / device),
                                   block_size=4, num_workers=2)
        out[device] = PIPE_DIR / device
        # the boxes of each frame, from a block of the four as the job ran
        keys = [(cls, name) for cls in ("class_a", "class_b")
                for name in ("f00.jpg", "p.png")]
        block = np.stack([read_image_bgr(str(sub / c / n),
                                         formats=IMAGE_EXTENSIONS)
                          for c, n in keys])
        posts = eng.detect_batch(block).to_numpy()
        dets[device] = {k: p.boxes[:3] for k, p in zip(keys, posts)}
    compared, flipped = 0, []
    for (cls, name), boxes in dets["cuda"].items():
        stem = name.split(".")[0]
        n = {d: len(os.listdir(out[d] / cls / stem)) for d in out}
        if n["cuda"] != n["cpu"]:
            raise AssertionError(f"{cls}/{name}: {n['cuda']} faces on the "
                                 f"card, {n['cpu']} on the CPU")
        rows = {d: np.load(out[d] / cls / f"{stem}.npy") for d in out}
        cpu_boxes = dets["cpu"][(cls, name)]
        for i, box in enumerate(boxes):
            same = np.nonzero((cpu_boxes == box).all(1))[0]
            if not len(same):
                flipped.append((cls, name, box.tolist()))
                continue
            err = float(np.abs(rows["cuda"][i] - rows["cpu"][same[0]]).max())
            if err > CPU_TOL:
                raise AssertionError(f"{cls}/{name} box {box}: card and CPU "
                                     f"features differ by {err}")
            compared += 1
    return compared, flipped


def check_odd_crops():
    """Odd, 1-px and sliver crops of a smooth frame through the card's
    JPEG route: they encode, decode to their own shape, and stay within
    IO_MAE (the frame's round-trip bound) on average."""
    from face_detection_and_recognition_tpu_torch.utils import native

    frame = smooth_frame(SEED + 12)
    worst = 0.0
    for h, w in ODD_CROPS:
        crop = np.ascontiguousarray(frame[100:100 + h, 200:200 + w])
        back = native.decode_jpeg_bgr(native.encode_jpeg_bgr(crop))
        if back is None or back.shape != crop.shape:
            raise AssertionError(f"a {h}x{w} crop did not round-trip: "
                                 f"{None if back is None else back.shape}")
        err = float(np.abs(back.astype(np.int64) - crop).mean())
        worst = max(worst, err)
        if err > IO_MAE:
            raise AssertionError(f"a {h}x{w} crop came back {err:.2f} off")
    return worst


def run_pipelines(card):
    """The dataset-curation main path: the extract_faces, extract_and_label,
    extract_features and extract_imdb_wiki CLIs on the card. Each part
    zeroes the launch counts before it and reads them after; a spy records
    the kernels' arguments and each call is replayed against its plain
    version after the counts are read. Returns the path's counts and its
    numbers."""
    from face_detection_and_recognition_tpu_torch.cli import (
        extract_and_label, extract_faces, extract_features,
        extract_imdb_wiki)
    from face_detection_and_recognition_tpu_torch.models import (blazeface,
                                                                 yolov5_face)
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops

    win, stats = Windows(), {}
    t = time.time()
    wiki_paths = build_pipeline_trees()
    write_wiki_mat(PIPE_DIR / "wiki.mat", wiki_paths)
    say(f"  trees written in {time.time() - t:.1f} s (JPEGs through the "
        "card's encoder)")
    kernels = ((yolov5_face, "nms_fixpoint"), (yolov5_face, "candidate_decode"),
               (crop_ops, "crop_resize"), (blazeface, "blaze_decode_blend"))

    # extract_faces: a warm-up run (cuDNN picks its plans) that the spy
    # records, then the timed run, both through the CLI
    runs = []
    real_job = extract_faces.extract_faces_from_dataset

    def job(*args, **kwargs):
        runs.append(real_job(*args, **kwargs))
        return runs[-1]

    argv = ["-i", str(PIPE_DIR / "faces"), "-o", str(PIPE_DIR / "faces_out"),
            "--md", "yolov5s", "--fd", "mobile_facenet", "--block",
            str(PIPE_BLOCK), "--dt", "0", "--at", "0", "--no-resume",
            "-d", PIPE_DEVICE]
    extract_faces.extract_faces_from_dataset = job
    try:
        with spied_calls(kernels) as faces_calls, torch.inference_mode():
            run_cli(extract_faces, argv)
        sec = win.run("extract_faces",
                      lambda: run_cli(extract_faces, argv)[1])
    finally:
        extract_faces.extract_faces_from_dataset = real_job
    st = runs[-1]
    failed = sorted(os.path.basename(p) for p in st.failed)
    if failed != ["v.mp4", "v.mp4", "w.webp", "w.webp"]:
        raise AssertionError(f"extract_faces failed on {failed}")
    media = sum(c["media"] for c in st.classes.values())
    n_frames = media   # one frame an image
    if media != 2 * (PIPE_JPEGS + 2) or st.total_faces() <= 0:
        raise AssertionError(f"extract_faces: {st.classes}")
    feats = np.load(PIPE_DIR / "faces_out" / "class_b" / "p.npy")
    norms = np.linalg.norm(feats, axis=1)
    if feats.shape != (45, 512) or not np.allclose(norms[:3], 1.0, atol=1e-4):
        raise AssertionError("extract_faces: bad feature file")
    stats["extract_faces"] = dict(
        media=media, frames=n_frames, faces=st.total_faces(),
        wall_s=st.wall_s, cli_s=sec, frames_per_s=n_frames / st.wall_s,
        media_per_s=(media + len(st.failed)) / st.wall_s,
        seconds=st.seconds, warm_up_wall_s=runs[0].wall_s)
    say(f"  extract_faces CLI (yolov5s + mobile_facenet, block "
        f"{PIPE_BLOCK}, thresholds 0): {media} media ({n_frames} 576x1024 "
        f"frames: {2 * PIPE_JPEGS} JPEG, 2 PNG, 2 BMP) + {len(st.failed)} "
        f"unreadable (WebP, video) in {st.wall_s:.2f} s = "
        f"{n_frames / st.wall_s:.1f} frames/s, "
        f"{(media + len(st.failed)) / st.wall_s:.1f} media/s on {card} "
        f"(warm-up run {runs[0].wall_s:.2f} s); {st.total_faces()} face "
        f"crops; seconds: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in st.seconds.items()))

    # extract_and_label: BlazeFace front (B5 fused), reid-mnv2 tracking,
    # the auto labeler's 227 x 227 crops (B3 with clip + mean)
    argv = ["-i", str(PIPE_DIR / "label"), "-o", str(PIPE_DIR / "label_out"),
            "--md", "blazeface-front", "--fd", "reid-mnv2", "--labeler",
            "auto", "--dt", "0", "--at", "0", "--workers", "2",
            "-d", PIPE_DEVICE]
    with spied_calls(kernels) as label_calls, torch.inference_mode():
        sec = win.run("extract_and_label",
                      lambda: run_cli(extract_and_label, argv)[1])
    ann = json.load(open(PIPE_DIR / "label_out" / "annotations.json"))
    n_det = sum(len(a["face_ids"]) for a in ann.values())
    n_tracks = sum(len(set(a["face_ids"])) for a in ann.values())
    ag = [c for c in label_calls["crop_resize"] if c[0][3] == (227, 227)]
    if len(ann) != 8 or n_det == 0 or len(ag) != n_tracks or any(
            a is None for r in ann.values() for a in r["ages"]):
        raise AssertionError(f"extract_and_label: {len(ann)} media, {n_det} "
                             f"detections, {n_tracks} tracks, {len(ag)} "
                             "labeler crops")
    stats["extract_and_label"] = dict(media=len(ann), detections=n_det,
                                      tracks=n_tracks, cli_s=sec)
    say(f"  extract_and_label CLI (blazeface-front, reid-mnv2, auto "
        f"labeler): {len(ann)} frames, {n_det} detections, {n_tracks} "
        f"tracks labeled in {sec:.2f} s (engine build included)")

    # extract_features: 128 face crops of mixed sizes, resized on the host
    argv = ["-i", str(PIPE_DIR / "crops"), "-o", str(PIPE_DIR / "crops_out"),
            "--fd", "mobile_facenet", "--batch", "64", "-d", PIPE_DEVICE]
    sec = win.run("extract_features",
                  lambda: run_cli(extract_features, argv)[1])
    recs = [np.load(p) for p in sorted((PIPE_DIR / "crops_out").rglob(
        "*.npy"))]
    if len(recs) != 128 or any(r.shape != (513,) for r in recs) or not \
            np.allclose([np.linalg.norm(r[:-1]) for r in recs], 1.0,
                        atol=1e-4):
        raise AssertionError("extract_features: bad records")
    stats["extract_features"] = dict(records=len(recs), cli_s=sec)
    say(f"  extract_features CLI: 128 crops (40-199 px a side, JPEG, PNG, "
        f"BMP) -> {len(recs)} records in {sec:.2f} s (engine build "
        "included)")

    # extract_imdb_wiki: 32 images of mixed sizes, letterboxed on the host
    dt, singles = imdb_threshold(wiki_paths)
    argv = ["--mat", str(PIPE_DIR / "wiki.mat"), "-i", str(PIPE_DIR / "wiki"),
            "-o", str(PIPE_DIR / "wiki_out"), "--md", WIKI_DETECTOR, "--mf",
            "mobile_facenet", "--dt", repr(dt), "--batch", "32",
            "-d", PIPE_DEVICE]
    with spied_calls(kernels) as wiki_calls, torch.inference_mode():
        sec = win.run("extract_imdb_wiki",
                      lambda: run_cli(extract_imdb_wiki, argv)[1])
    meta = json.load(open(PIPE_DIR / "wiki_out" / "cleaning_metadata.json"))
    data = np.load(PIPE_DIR / "wiki_out" / "data.npy", allow_pickle=True)
    if meta["kept_metadata"] != 32 or not data.size or not all(
            r["embedding"].shape == (512,) for r in data):
        raise AssertionError(f"extract_imdb_wiki: {meta}, {len(data)} "
                             f"records")
    stats["extract_imdb_wiki"] = dict(images=32, records=len(data),
                                      one_face_before=singles, dt=dt,
                                      cli_s=sec)
    say(f"  extract_imdb_wiki CLI ({WIKI_DETECTOR} + mobile_facenet, --dt "
        f"{dt:.4f}):"
        f" 32 images of mixed sizes -> {len(data)} one-face records in "
        f"{sec:.2f} s (engine build included)")

    for part, names in (("extract_faces", ("nms_fixpoint", "rows_gather",
                                           "crop_resize")),
                        ("extract_and_label", ("blaze_decode_blend",
                                               "crop_resize")),
                        ("extract_imdb_wiki", ("blaze_decode_blend",))):
        for k in names:
            if win.parts[part][k] <= 0:
                raise AssertionError(f"{k} never launched in {part}")
    # every captured kernel call of the path against its plain version
    plain = {"nms_fixpoint": (ck.nms_fixpoint, ck.nms_fixpoint_plain),
             "candidate_decode": (ck.candidate_decode,
                                  ck.candidate_decode_plain),
             "crop_resize": (ck.crop_resize, ck.crop_resize_plain),
             "blaze_decode_blend": (ck.blaze_decode_blend,
                                    ck.blaze_decode_blend_plain)}
    replayed = {}
    for part, calls in (("extract_faces", faces_calls),
                        ("extract_and_label", label_calls),
                        ("extract_imdb_wiki", wiki_calls)):
        for name, seen in calls.items():
            if seen:
                check_on_path(f"{name} in {part}", *plain[name], seen)
                replayed[f"{part}: {name}"] = len(seen)
    stats["replayed"] = replayed
    sizes = sorted({a[3] for a, _ in faces_calls["crop_resize"]
                    + label_calls["crop_resize"]})
    say(f"  crop_resize sizes on the path: {sizes}")

    t = time.time()
    compared, flipped = card_against_cpu(PIPE_DIR)
    stats["card_vs_cpu"] = dict(rows=compared, flipped=flipped,
                                s=time.time() - t)
    say(f"  card against CPU (extract_faces, 2 media a class): face counts "
        f"equal; {compared} feature rows of the same boxes within "
        f"{CPU_TOL}; boxes that flipped on a near-tie: {flipped or 'none'}")
    if compared == 0:
        raise AssertionError("no feature row compared between card and CPU")
    stats["odd_crop_worst_mae"] = check_odd_crops()
    say(f"  the card's JPEG route on crops {list(ODD_CROPS)}: each "
        f"round-trips to its shape, worst mean |error| "
        f"{stats['odd_crop_worst_mae']:.2f} (bound {IO_MAE})")
    stats["windows"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in win.parts.items()}
    return win.total(), stats


SSD_NAMES = ("ssd-resnet10", "ssd-mobilenetv2", "ssd-squeezenet")
MTCNN_FULL = {"thresholds": (0.0, 0.0, 0.0)}  # every stage full
MTCNN_B1, MTCNN_B3 = 11, 2   # launches a 576 x 1024 batch: 8 levels + 3
CPU_FRAMES = 2               # frames the CPU reference runs


def same_stage(label, got, ref, wh):
    """A stage's rows on the card against the CPU's: the same valid slots,
    the valid rows (normalized by the frame size where ``wh``) within
    CPU_TOL."""
    (gb, gv), (rb, rv) = got, ref
    gb, gv = gb[:CPU_FRAMES].cpu(), gv[:CPU_FRAMES].cpu()
    if not torch.equal(gv, rv):
        raise AssertionError(f"{label}: card and CPU keep different rows "
                             f"({gv.sum(1).tolist()} vs {rv.sum(1).tolist()})")
    scale = torch.tensor([wh[0], wh[1]] * (gb.shape[-1] // 2)
                         + [1] * (gb.shape[-1] % 2)) if wh else 1.0
    err = float(((gb - rb) / scale)[gv].abs().max()) if gv.any() else 0.0
    if err > CPU_TOL:
        raise AssertionError(f"{label}: card and CPU rows differ by {err}")
    return int(gv.sum()), err


def grid_sample_crop(img, boxes, hw, clamp):
    """The one PyTorch call that computes ``crop_resize``'s crop: a
    ``grid_sample`` over the f32 NCHW frames [B, C, H, W], the K crops
    stacked along the grid's rows, bilinear with zero padding (clamped
    boxes: at the kernel's clamped sample coordinates, where zero padding
    reads 0 only where the weight is 0; padded boxes: at the unclamped
    coordinates ``lo + (o + 0.5) * len / n_out - 0.5``, where it reads 0
    outside the frame as the pad mode does). Returns (the call, a map of
    its output to crop_resize's [B, K, oh, ow, C])."""
    b, h, w, c = img.shape
    k = boxes.shape[1]

    def coords(b0, b1, n, n_out):
        if clamp:
            i0, _, wt, _, _ = ck._crop_taps(b0, b1, n, n_out, True)
            return i0 + wt
        lo = torch.floor(b0)[..., None]
        length = (torch.floor(b1) - torch.floor(b0)).clamp(min=1.0)[..., None]
        o = torch.arange(n_out, dtype=torch.float32, device=b0.device) + 0.5
        return lo + o * length / n_out - 0.5

    gy = (2 * coords(boxes[..., 1], boxes[..., 3], h, hw[0]) + 1) / h - 1
    gx = (2 * coords(boxes[..., 0], boxes[..., 2], w, hw[1]) + 1) / w - 1
    grid = torch.stack(torch.broadcast_tensors(
        gx[..., None, :], gy[..., :, None]), -1).reshape(b, -1, hw[1], 2)
    nchw = img.permute(0, 3, 1, 2).float().contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False)

    def to_nhwc(out):
        return out.reshape(b, c, k, hw[0], hw[1]).permute(0, 2, 3, 4, 1)

    return library, to_nhwc


def time_kernel(label, fn, plain, work, card, library=None):
    """ms between events and of device time, the plain version's ms, the
    library call's ms (None where there is none) and the bound of one
    kernel call of the path."""
    ms = cuda_ms(fn, 100)
    dev, _ = device_ms(fn, 20)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 20) if library is not None else None
    bound_ms, bound_by = bound(*work)
    lib = "none" if library_ms is None else f"{library_ms:.5f} ms"
    say(f"  {label}: {ms:.5f} ms between events, {dev:.5f} ms device, "
        f"plain {plain_ms:.4f} ms, library {lib}, bound {bound_ms:.6f} ms "
        f"({bound_by}) on {card}")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def run_ssd_mtcnn(frames, card):
    """The SSD family and the MTCNN cascade: ``detect_batch`` of
    ssd-resnet10, ssd-mobilenetv2 and ssd-squeezenet on the 8 frames at
    thresholds 0 (one B1 launch each); mtcnn at its default thresholds and
    with every stage full (11 B1 launches and 2 B3 launches in pad mode a
    batch); one ``/detect`` request to an mtcnn FaceService's HTTP front
    door (the staged path: the cascade, then B3 clamped at 112). Each part
    zeroes the counts before it and reads them after; the timings run in
    parts of their own. After the counts are read: every B1 and B3 call of
    the parts, recorded by a spy, against its plain version bit for bit;
    each detector's rows and each MTCNN stage on the card against the CPU
    on the first frames; B1 at K = 400 and 1024 and B3 pad at 24 and 48
    timed beside their bounds; the host codec's decode and encode times."""
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.ops import nms as nms_ops
    from face_detection_and_recognition_tpu_torch.serving.http_server import \
        serve
    from face_detection_and_recognition_tpu_torch.serving.service import \
        ServiceConfig
    from face_detection_and_recognition_tpu_torch.utils import native

    win, stats = Windows(), {}
    t = time.time()
    engines = {name: FaceEngine(EngineConfig(detector=name, seed=SEED))
               for name in SSD_NAMES}
    engines["mtcnn"] = FaceEngine(EngineConfig(detector="mtcnn", seed=SEED))
    engines["mtcnn full"] = FaceEngine(EngineConfig(
        detector="mtcnn", seed=SEED, detector_overrides=MTCNN_FULL))
    say(f"  engines built in {time.time() - t:.1f} s")
    frame0 = np.ascontiguousarray(frames[0])
    jpg = native.encode_jpeg_bgr(frame0, IO_QUALITY)
    httpd = serve(ServiceConfig(detector="mtcnn", with_embedder=False,
                                with_age_gender=False), host="127.0.0.1",
                  port=free_port(), block=False, warmup_shapes=())
    service = httpd.service
    # random weights find no face at the default thresholds: the served
    # cascade runs with every stage full, so that the staged crops run
    service.engine.net.cfg = engines["mtcnn full"].net.cfg
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    targets = [(nms_ops, "nms_fixpoint"), (crop_ops, "crop_resize")]

    def counted():
        """Each detector once, each in its own part; the spy records the
        B1 and B3 calls, which still launch."""
        out = {}
        for name in SSD_NAMES + ("mtcnn", "mtcnn full"):
            out[name] = win.run(name, lambda: engines[name].detect_batch(
                frames, 0.0, 0.0))
        out["/detect"] = win.run("/detect", lambda: http(
            base + "/detect?det_thres=0&bbox_area_thres=0", jpg))
        return out

    try:
        with spied_calls(targets) as seen, torch.inference_mode():
            dets = counted()
        for name in SSD_NAMES:
            p = win.parts[name]
            if (p["nms_fixpoint"], p["crop_resize"]) != (1, 0):
                raise AssertionError(f"{name}: {p}, not one B1 launch")
            check_dets(name, dets[name], 0)
        for name in ("mtcnn", "mtcnn full"):
            p = win.parts[name]
            if (p["nms_fixpoint"], p["crop_resize"]) != (MTCNN_B1, MTCNN_B3):
                raise AssertionError(f"{name}: {p}, not {MTCNN_B1} B1 and "
                                     f"{MTCNN_B3} B3 launches")
            check_dets(name, dets[name], 10)
        p = win.parts["/detect"]
        answer, detect_ms = dets["/detect"]
        n_faces = answer["num_faces"]
        if p["nms_fixpoint"] != MTCNN_B1 or p["crop_resize"] != MTCNN_B3 + (
                1 if n_faces else 0) or not n_faces:
            raise AssertionError(f"/detect with mtcnn: {p}, {n_faces} faces")
        with torch.inference_mode():
            _, bboxes, confs = service.detect_faces(
                native.decode_jpeg_bgr(jpg), 0.0, 0.0)
        check_answers("/detect mtcnn", [answer], {"bboxes": bboxes,
                                                  "confs": confs})
        say(f"  /detect with mtcnn (staged: cascade, then {n_faces} crops "
            f"at 112): {detect_ms:.2f} ms on {card}, the answer equal to "
            "the service's direct call")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    say(f"  launches by part: {json.dumps(win.parts)}")
    modes = {(kw.get("mode", "union"), a[0].shape[1])
             for a, kw in seen["nms_fixpoint"]}
    pads = sorted({(a[3], a[4]) for a, _ in seen["crop_resize"]})
    say(f"  spied: {len(seen['nms_fixpoint'])} B1 calls (mode, K) "
        f"{sorted(modes)}; {len(seen['crop_resize'])} B3 calls (size, "
        f"clamp) {pads}")
    if ("min", 128) not in modes or ((24, 24), False) not in pads \
            or ((48, 48), False) not in pads:
        raise AssertionError("B1 min mode or B3 pad mode missing on the path")
    check_on_path("nms_fixpoint (union and min) on the path",
                  ck.nms_fixpoint, ck.nms_fixpoint_plain,
                  seen["nms_fixpoint"])
    check_on_path("crop_resize (pad 24 and 48, clamp 112) on the path",
                  ck.crop_resize, ck.crop_resize_plain, seen["crop_resize"])

    # frames/s of each detector, and of MTCNN per stage
    for name in SSD_NAMES + ("mtcnn", "mtcnn full"):
        _, sec = win.run(f"{name} timed", lambda: timed_batches(
            lambda: engines[name].detect_batch(frames, 0.0, 0.0), 3))
        stats[f"{name} fps"] = B / sec
        say(f"  {name} detect_batch: {B} x 576x1024 frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; "
            f"detections per frame {dets[name].valid.sum(1).tolist()}")
    frames_t = torch.from_numpy(frames).cuda()
    traces = {}
    for name in ("mtcnn", "mtcnn full"):
        net = engines[name].net
        traces[name] = {}
        with torch.inference_mode(), _full_f32(frames_t.device):
            win.run(f"{name} stages", lambda: net.detect(frames_t,
                                                         traces[name]))
        ms = {k: v["ms"] for k, v in traces[name].items()}
        stats[f"{name} stage ms"] = ms
        say(f"  {name} stages: " + ", ".join(
            f"{k} {v:.2f} ms ({B * 1e3 / v:.1f} frames/s)"
            for k, v in ms.items()) + f" on {card}; valid a frame after "
            f"O-Net {traces[name]['onet']['valid'].sum(1).tolist()}")

    # the card against the CPU on the first frames
    head = frames[:CPU_FRAMES]
    for name in SSD_NAMES + ("mtcnn full",):
        ov = MTCNN_FULL if name == "mtcnn full" else {}
        cpu = FaceEngine(EngineConfig(detector=name.split()[0], seed=SEED,
                                      detector_overrides=ov), device="cpu")
        if name == "mtcnn full":
            ref = {}
            with torch.inference_mode():
                cpu.net.detect(torch.from_numpy(head), ref)
            for stage in ("pnet", "rnet", "onet"):
                got = traces[name][stage]
                n, err = same_stage(
                    f"mtcnn {stage}", (got["boxes"], got["valid"]),
                    (ref[stage]["boxes"], ref[stage]["valid"]),
                    None if stage == "onet" else (1024, 576))
                say(f"  mtcnn {stage} on the card against the CPU: {n} "
                    f"rows equal within {CPU_TOL} (max {err:.2e})")
            continue
        with torch.inference_mode():
            got = engines[name]._detect(engines[name]._preprocess(frames_t))
            ref = cpu._detect(cpu._preprocess(torch.from_numpy(head)))
        n, err = same_stage(name, got, ref, None)
        say(f"  {name} on the card against the CPU: {n} rows equal within "
            f"{CPU_TOL} (max {err:.2e})")

    # B1 at an SSD's K = 400, at MTCNN's global pass (the largest K: 6
    # levels of 128 and two smaller ones at 576 x 1024) and in O-Net's min
    # mode; B3 pad at 24 and 48 (R-Net's and O-Net's crops) and clamped at
    # 112 (the staged crops); each on the path's own inputs
    with torch.inference_mode():
        calls = seen["nms_fixpoint"]
        union = [c for c in calls if c[1].get("mode", "union") == "union"]
        picks = {"ssd": next(c for c in union if c[0][0].shape[1] == 400),
                 "mtcnn global": max(
                     (c for c in union if c[0][0].shape[1] != 400),
                     key=lambda c: c[0][0].shape[1]),
                 "onet min": next(c for c in calls
                                  if c[1].get("mode") == "min")}
        for what, (args, kw) in picks.items():
            keep = ck.nms_fixpoint(*args, **kw)
            k_b = args[0].shape[1]
            stats[f"B1 {what} K={k_b}"] = time_kernel(
                f"nms_fixpoint, {what}: K = {k_b}, B = {args[0].shape[0]}",
                lambda: ck.nms_fixpoint(*args, **kw),
                lambda: ck.nms_fixpoint_plain(*args, **kw),
                nms_work(args[0], args[1], keep), card)
        for args, _ in seen["crop_resize"]:
            img, boxes, valid, hw, clamp = args[:5]
            key = f"B3 pad {hw[0]}" if not clamp else f"B3 clamp {hw[0]}"
            if key in stats:
                continue
            nbytes = (boxes.shape[0] * boxes.shape[1] * hw[0] * hw[1]
                      * img.shape[-1] * 4
                      + crop_read_bytes(img, boxes, valid, hw, clamp)
                      + boxes.shape[0] * boxes.shape[1] * (16 + 1))
            library, to_nhwc = grid_sample_crop(img, boxes, hw, clamp)
            lib_err = float((torch.where(valid[..., None, None, None],
                                         to_nhwc(library()), 0.0)
                             - ck.crop_resize(*args[:5])).abs().max())
            mode = "clamp" if clamp else "zero pad"
            say(f"  grid_sample {hw[0]}x{hw[1]} ({mode}) against the "
                f"kernel: max abs err {lib_err:.3g} (its own rounding of "
                "the coordinates)")
            stats[key] = time_kernel(
                f"crop_resize {hw[0]}x{hw[1]} ({'clamp' if clamp else 'pad'}"
                f", {tuple(boxes.shape[:2])} boxes, {img.dtype})",
                lambda: ck.crop_resize(*args), lambda: ck.crop_resize_plain(
                    *args), (0, nbytes), card, library)
            stats[key]["library_max_abs_err"] = lib_err

    # the host codec: a 576 x 1024 quality-95 frame, and 112 x 112 crops
    crops = [np.ascontiguousarray(frame0[y:y + 112, x:x + 112])
             for y in range(0, 448, 112) for x in range(0, 896, 112)]
    for label, fn, n in (
            ("decode 576x1024", lambda: native.decode_jpeg_bgr(jpg), 1),
            ("encode 576x1024", lambda: native.encode_jpeg_bgr(frame0), 1),
            ("encode 112x112 crop", lambda: [native.encode_jpeg_bgr(c)
                                             for c in crops], len(crops))):
        fn()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        stats[f"codec {label} ms"] = (time.perf_counter() - t) / 10 / n * 1e3
        say(f"  host codec {label}: {stats[f'codec {label} ms']:.3f} ms "
            f"(host CPU beside {card})")
    stats["windows"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in win.parts.items()}
    return win.total(), stats


R10OV_NAMES = ("res10-ssd", "ov-0204", "ov-squeezenet-light", "openvino-ir")
R10OV_DIR = WORK_DIR / "res10_openvino"


def write_res10_caffemodel(net, path):
    """The res10 deploy table with ``net``'s blobs, written as a
    caffemodel by the port's writer; ``data_scale`` scales the
    mean-subtracted input by 1/64, as a trained net's input normalisation
    does (at the seeded init's 1 the heads reach ~170 and the decoded
    boxes ~1e9)."""
    from face_detection_and_recognition_tpu_torch.models.res10 import \
        res10_deploy_defs
    from face_detection_and_recognition_tpu_torch.utils.caffe_graph import \
        write_caffemodel_graph

    defs = res10_deploy_defs()
    held = set(net.blob_layers())
    for d in defs:
        if d.name in held:
            d.blobs = [b.detach().cpu().numpy()
                       for b in net.layer_blobs(d.name)]
        if d.name == "data_scale":
            d.blobs[0] = np.full_like(d.blobs[0], 1 / 64)
    path.write_bytes(write_caffemodel_graph(defs))


def write_ir(net, xml_path):
    """``net``'s IR graph with its current constants, written as
    ``.xml`` + ``.bin`` by the port's writer."""
    from face_detection_and_recognition_tpu_torch.utils.ir_graph import \
        write_ir_graph

    layers = copy.deepcopy(net.graph.layers)
    for la in layers:
        if la.name in net.weight_names and la.value is not None:
            la.value = net.weight(la.name).detach().cpu().numpy()
    xml, blob = write_ir_graph(layers, net.graph.edges)
    xml_path.write_bytes(xml)
    xml_path.with_suffix(".bin").write_bytes(blob)


def run_res10_openvino(frames, singles, card):
    """The res10 deploy graph and the OpenVINO IR nets: a seeded res10
    caffemodel and a seeded ov-0204 IR written by the port's writers,
    loaded by ``load_weights`` (the res10 blobs by layer name; the IR
    rebuilds an ov-0204 engine built from another seed) and by
    ``detect_face --md openvino-ir --ckpt``; ``detect_batch`` of the four
    detectors on the 8 frames at thresholds 0 (one B1 launch each), their
    ``detect_image`` on one frame, the CLI, and one ``/detect`` to a
    res10-ssd ``FaceService`` loaded through ``ServiceConfig.ckpt``. Each
    part zeroes the counts before it and reads them after. After the
    read: every B1 (and the service's B3) call of the parts against its
    plain version bit for bit; the openvino-ir engine and the reloaded
    ov-0204 engine against the ov-0204 engine whose constants the IR holds
    (equal rows); each detector's rows on the first frames against the
    port on the CPU; frames/s, the stage split and B1 at each detector's
    K timed beside its bound."""
    from face_detection_and_recognition_tpu_torch.cli import detect_face
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.ops import nms as nms_ops
    from face_detection_and_recognition_tpu_torch.serving.http_server import \
        serve
    from face_detection_and_recognition_tpu_torch.serving.service import \
        ServiceConfig
    from face_detection_and_recognition_tpu_torch.utils import native
    from face_detection_and_recognition_tpu_torch.utils.profiling import \
        detect_stages

    R10OV_DIR.mkdir(parents=True, exist_ok=True)
    caffemodel, xml = R10OV_DIR / "res10.caffemodel", R10OV_DIR / "ov_0204.xml"
    win, stats = Windows(), {}
    t = time.time()
    cfg = dict(det_thres=0.0, bbox_area_thres=0.0)

    def engine(name, device=None, seed=SEED, **ov):
        return FaceEngine(EngineConfig(detector=name, seed=seed,
                                       detector_overrides=ov, **cfg),
                          device=device)

    write_res10_caffemodel(engine("res10-ssd", "cpu", SEED + 1).net,
                           caffemodel)
    engines = {"res10-ssd": engine("res10-ssd"),
               "ov-0204": engine("ov-0204"),
               "ov-squeezenet-light": engine("ov-squeezenet-light")}
    write_ir(engines["ov-0204"].net, xml)
    engines["res10-ssd"].load_weights(str(caffemodel))
    engines["openvino-ir"] = engine("openvino-ir", xml=str(xml))
    reloaded = engine("ov-0204", seed=SEED + 2)
    reloaded.load_weights(str(xml))
    say(f"  wrote {caffemodel.name} ({caffemodel.stat().st_size} bytes) and "
        f"{xml.name} + .bin; engines built and loaded in "
        f"{time.time() - t:.1f} s; openvino-ir input "
        f"{engines['openvino-ir'].input_size}")
    frame0 = np.ascontiguousarray(frames[0])
    jpg = native.encode_jpeg_bgr(frame0, IO_QUALITY)
    jpg_path = R10OV_DIR / "frame.jpg"
    jpg_path.write_bytes(jpg)
    httpd = serve(ServiceConfig(detector="res10-ssd", with_embedder=False,
                                with_age_gender=False, ckpt=str(caffemodel)),
                  host="127.0.0.1", port=free_port(), block=False,
                  warmup_shapes=())
    service = httpd.service
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    cli_argv = ["-i", str(jpg_path), "--md", "openvino-ir", "--ckpt", str(xml),
                "--dt", "0", "--at", "0", "--no-display",
                "-o", str(R10OV_DIR / "out.jpg")]
    try:
        with spied_calls([(nms_ops, "nms_fixpoint"),
                          (crop_ops, "crop_resize")]) as seen, \
                torch.inference_mode():
            dets, images = {}, {}
            for name in R10OV_NAMES:
                dets[name] = win.run(name, lambda: engines[name].detect_batch(
                    frames, 0.0, 0.0))
                images[name] = win.run(f"{name} image", lambda: engines[
                    name].detect_image(singles[0], 0.0, 0.0))
            cli_out, cli_s = win.run("cli", lambda: run_cli(detect_face,
                                                            cli_argv))
            answer, detect_ms = win.run("/detect", lambda: http(
                base + "/detect?det_thres=0&bbox_area_thres=0", jpg))
        for part, p in win.parts.items():
            want_b3 = 1 if part == "/detect" else 0
            if p["nms_fixpoint"] != 1 or p["crop_resize"] != want_b3:
                raise AssertionError(f"{part}: {p}, not one B1 launch")
        for name in R10OV_NAMES:
            check_dets(name, dets[name], 0)
            res = images[name]
            if not (np.isfinite(res.boxes).all() and len(res.boxes)):
                raise AssertionError(f"{name} detect_image: bad boxes")
        with torch.inference_mode():
            _, bboxes, confs = service.detect_faces(
                native.decode_jpeg_bgr(jpg), 0.0, 0.0)
            want = engines["openvino-ir"].detect_image(
                native.decode_jpeg_bgr(jpg), 0.0, 0.0)
        check_answers("/detect res10-ssd", [answer], {"bboxes": bboxes,
                                                      "confs": confs})
        boxes, _, _ = printed_faces(cli_out)
        if not np.array_equal(boxes, want.boxes.astype(np.int64)):
            raise AssertionError("detect_face --md openvino-ir printed other "
                                 "boxes than the engine's")
        say(f"  detect_face --md openvino-ir --ckpt {xml.name}: "
            f"{len(boxes)} faces in {cli_s:.2f} s, the engine's boxes; "
            f"/detect res10-ssd: {answer['num_faces']} faces in "
            f"{detect_ms:.2f} ms, the service's direct answer, on {card}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    say(f"  launches by part: {json.dumps(win.parts)}")
    ks = sorted({a[0].shape[1] for a, _ in seen["nms_fixpoint"]})
    say(f"  spied: {len(seen['nms_fixpoint'])} B1 calls at K {ks}, "
        f"{len(seen['crop_resize'])} B3 calls")
    check_on_path("nms_fixpoint on the res10 + openvino path",
                  ck.nms_fixpoint, ck.nms_fixpoint_plain,
                  seen["nms_fixpoint"])
    check_on_path("crop_resize of the /detect answer", ck.crop_resize,
                  ck.crop_resize_plain, seen["crop_resize"])

    # the IR built from the written file, and an ov-0204 engine of another
    # seed reloaded from it, against the ov-0204 engine whose constants it
    # holds
    frames_t = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        ref = engines["ov-0204"]._detect(engines["ov-0204"]._preprocess(
            frames_t))
        for label, eng in (("openvino-ir", engines["openvino-ir"]),
                           ("reloaded ov-0204", reloaded)):
            got = eng._detect(eng._preprocess(frames_t))
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                                ref[1])):
                raise AssertionError(f"{label} differs from the ov-0204 "
                                     "engine with the same constants")
    say("  openvino-ir from the written IR and the reloaded ov-0204: rows "
        "equal to the ov-0204 engine's, bit for bit")

    # the card against the CPU on the first frames
    head = torch.from_numpy(frames[:CPU_FRAMES])
    cpu = {"res10-ssd": engine("res10-ssd", "cpu"),
           "ov-0204": engine("ov-0204", "cpu"),
           "ov-squeezenet-light": engine("ov-squeezenet-light", "cpu"),
           "openvino-ir": engine("openvino-ir", "cpu", xml=str(xml))}
    cpu["res10-ssd"].load_weights(str(caffemodel))
    for name in R10OV_NAMES:
        eng, c = engines[name], cpu[name]
        with torch.inference_mode():
            got = eng._detect(eng._preprocess(frames_t))
            ref = c._detect(c._preprocess(head))
        n, err = same_stage(name, got, ref, None)
        say(f"  {name} on the card against the CPU: {n} rows equal within "
            f"{CPU_TOL} (max {err:.2e})")

    # frames/s, the stage split, and B1 at each detector's K
    for name in R10OV_NAMES:
        eng = engines[name]
        _, sec = win.run(f"{name} timed", lambda: timed_batches(
            lambda: eng.detect_batch(frames, 0.0, 0.0), 3))
        stats[f"{name} fps"] = B / sec
        stages = win.run(f"{name} stages", lambda: detect_stages(eng, frames))
        stats[f"{name} stage ms"] = stages
        say(f"  {name} detect_batch ({eng.input_size[0]}x"
            f"{eng.input_size[1]}): {B} x 576x1024 frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()
                        if isinstance(v, float)) + " ms")
        (args, kw), = captured_calls(
            nms_ops, "nms_fixpoint", lambda: eng.detect_batch(frames, 0.0,
                                                              0.0))
        with torch.inference_mode():
            keep = ck.nms_fixpoint(*args, **kw)
            stats[f"B1 {name} K={args[0].shape[1]}"] = time_kernel(
                f"nms_fixpoint, {name}: K = {args[0].shape[1]}, B = "
                f"{args[0].shape[0]}", lambda: ck.nms_fixpoint(*args, **kw),
                lambda: ck.nms_fixpoint_plain(*args, **kw),
                nms_work(args[0], args[1], keep), card)
    stats["windows"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in win.parts.items()}
    counted = {k: v for k, v in win.parts.items()
               if not k.endswith((" timed", " stages"))}
    return {k: sum(p[k] for p in counted.values()) for k in ck.LAUNCHES}, \
        stats


# ---------------- int8 + keras + eval ----------------

INT8_ARCHS = ("yolov5n", "yolov5s")
INT8_MODES = (True, "static")
INT8_OPS_PER_S = 1979e12     # H100 SXM dense int8 tensor-core rate
SILU_ULPS = 4                # Q1's SiLU (expf) against PyTorch's exp
IKE_DIR = WORK_DIR / "int8_keras_eval"
WIDER_N = 16                 # images of the phase's WIDER-format tree


def mode_name(q):
    return "static" if q == "static" else "dynamic"


def q1_work(args):
    """(int8 operations, bytes) that one Q1 call needs: 2 * M * C_out * K
    operations; the f32 input read once, the weights' codes (unpadded),
    scales and bias, and the f32 output written once."""
    x, _, ws, _, k, stride, pad, groups, _, ascale = args
    b, c, h, w = x.shape
    cout, cg = ws.shape[0], c // groups
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    ops = 2 * b * ho * wo * cout * k * k * cg
    nbytes = (4 * x.numel() + cout * k * k * cg + 8 * cout
              + (4 if ascale is not None else 0) + 4 * b * ho * wo * cout)
    return ops, nbytes


def q1_bound(ops, nbytes):
    """(bound_ms, bound_by) of Q1: bytes over the memory rate against int8
    operations over the dense int8 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else \
        "operations"


def q1_codes(args):
    """The int8 codes [B, C, H, W] of a Q1 call's input, and its OHWI
    weights (made outside any timing)."""
    from face_detection_and_recognition_tpu_torch.ops import int8_conv

    x, wpack, ws, _, k, _, _, groups, _, ascale = args
    s = int8_conv.act_scale(x) if ascale is None else ascale
    kq = int8_conv.unpack_kernel_q(wpack, k, x.shape[1] // groups,
                                   ws.shape[0], groups)
    return int8_conv.quantize_codes(x, s), kq


def q1_library(args):
    """The one PyTorch call that computes Q1's integers, ``F.conv2d`` in
    float64 on the same codes (the codes are made outside the timing)."""
    import torch.nn.functional as F

    _, _, _, _, _, stride, pad, groups, _, _ = args
    xq, kq = q1_codes(args)
    xq, w = xq.double(), kq.permute(0, 3, 1, 2).double()
    return lambda: F.conv2d(xq, w, None, stride, pad, 1, groups)


def q1_int_mm(args):
    """For a dense 1x1 call whose shape ``torch._int_mm`` takes (int8
    [M, K] @ [K, N], M > 16, K and N multiples of 8): that product on the
    same codes, the int8 tensor cores' yardstick (the port never calls
    it). Else None."""
    x, _, ws, _, k, stride, pad, groups, _, _ = args
    b, c, h, w = x.shape
    cout = ws.shape[0]
    if k != 1 or stride != 1 or pad or groups != 1 or c % 8 or cout % 8 \
            or b * h * w <= 16:
        return None
    xq, kq = q1_codes(args)
    a = xq.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
    wt = kq.reshape(cout, c).t()  # [K, N], column-major
    return lambda: torch._int_mm(a, wt)


def q1_class(args):
    """A Q1 call's class: the stem (C_in 3), dense 1x1, dense k x k, or
    depthwise."""
    x, _, _, _, k, _, _, groups, _, _ = args
    if groups > 1:
        return "depthwise"
    if x.shape[1] == 3:
        return "stem"
    return "dense 1x1" if k == 1 else f"dense {k}x{k}"


def q1_plain(args):
    from face_detection_and_recognition_tpu_torch.ops import int8_conv

    return int8_conv.conv_int8_packed_plain(*args)


def q1_linear(args):
    """The same call without its activation: the pre-activation."""
    return args[:8] + (None, args[9])


def check_q1_calls(label, calls):
    """Each Q1 call of a forward against its plain version on the same
    inputs: the pre-activation (the call again without its activation) bit
    for bit, the call's own output within SILU_ULPS. Returns (calls,
    largest ulps, max |kernel - plain|)."""
    worst, err = 0, 0.0
    with torch.inference_mode():
        for args, _ in calls:
            lin = q1_linear(args)
            if not same_bits(ck.conv_int8(*lin), q1_plain(lin)):
                raise AssertionError(f"{label}: Q1's pre-activation differs "
                                     f"from its plain version at "
                                     f"{tuple(args[0].shape)} -> "
                                     f"{tuple(args[1].shape)}")
            got, ref = ck.conv_int8(*args), q1_plain(args)
            worst = max(worst, max_ulps(got, ref))
            err = max(err, float((got - ref).abs().max()))
    if worst > SILU_ULPS:
        raise AssertionError(f"{label}: Q1's SiLU {worst} ulps from its "
                             "plain version")
    return len(calls), worst, err


# the redesign's edge shapes (B, C_in, H, W, C_out, k, stride, groups,
# input): the C_in = 3 stem path, ragged C_in (12, 92, 5), C_out off the N
# tile (40, 360 over two tiles, 520 over three, 300 at k = 5), ragged M
# (odd frames), depthwise at C % 16 != 0 and C % 4 != 0, two real widths;
# the input channels-last ("nhwc"), the second half of a channels-last
# tensor's channels ("slice": read in place, its pixel stride 2 C), or
# NCHW ("nchw": copied first)
Q1_SWEEP = ((1, 3, 33, 31, 16, 3, 2, 1, "nhwc"),
            (2, 12, 17, 23, 40, 1, 1, 1, "nhwc"),
            (1, 16, 21, 19, 40, 3, 2, 1, "nhwc"),
            (1, 92, 13, 11, 360, 3, 1, 1, "nhwc"),
            (3, 5, 9, 14, 7, 3, 1, 1, "nhwc"),
            (1, 8, 9, 9, 300, 5, 1, 1, "nhwc"),
            (1, 64, 7, 9, 520, 1, 1, 1, "nhwc"),
            (2, 20, 19, 17, 20, 3, 1, 20, "nhwc"),
            (1, 6, 11, 13, 6, 3, 2, 6, "nhwc"),
            (2, 32, 15, 17, 48, 1, 1, 1, "slice"),
            (1, 64, 13, 11, 64, 3, 2, 64, "slice"),
            (1, 24, 9, 10, 36, 3, 1, 1, "nchw"),
            (8, 184, 40, 40, 360, 3, 2, 1, "nhwc"),
            (8, 720, 20, 20, 360, 1, 1, 1, "nhwc"),
            (8, 256, 40, 40, 256, 3, 2, 256, "nhwc"))


def check_q1_sweep():
    """Q1 against its plain version on Q1_SWEEP's seeded layers, dynamic
    and static: the pre-activation bit for bit, SiLU within SILU_ULPS.
    Returns (calls, largest ulps)."""
    from face_detection_and_recognition_tpu_torch.ops import int8_conv

    gen = torch.Generator().manual_seed(SEED + 7)
    n, worst = 0, 0
    with torch.inference_mode():
        for b, c, h, w, cout, k, stride, groups, view in Q1_SWEEP:
            x = (torch.randn((b, 2 * c if view == "slice" else c, h, w),
                             generator=gen) * 2).cuda()
            if view != "nchw":
                x = x.contiguous(memory_format=torch.channels_last)
            if view == "slice":
                x = x[:, c:]
            kq = torch.randint(-127, 128, (cout, k, k, c // groups),
                               generator=gen, dtype=torch.int8).cuda()
            ws = (torch.rand(cout, generator=gen) * 1e-3 + 1e-4).cuda()
            bias = torch.randn(cout, generator=gen).cuda()
            static = (x.abs().amax() * 0.8 / 127).reshape(())
            wpack = int8_conv.pack_kernel_q(kq, groups)
            for ascale in (None, static):
                args = (x, wpack, ws, bias, k, stride, k // 2, groups,
                        "silu", ascale)
                lin = q1_linear(args)
                if not same_bits(ck.conv_int8(*lin), q1_plain(lin)):
                    raise AssertionError(
                        f"Q1 sweep: pre-activation differs at B {b}, C {c}, "
                        f"{h}x{w} -> {cout}, k {k}, stride {stride}, groups "
                        f"{groups}, {view}, "
                        f"{'static' if ascale is not None else 'dynamic'}")
                worst = max(worst, max_ulps(ck.conv_int8(*args),
                                            q1_plain(args)))
                n += 1
    if worst > SILU_ULPS:
        raise AssertionError(f"Q1 sweep: SiLU {worst} ulps from the plain "
                             "version")
    return n, worst


def q1_card_against_cpu(label, calls):
    """Each Q1 call of a forward on the card against the plain version on
    the CPU, on the first ``CPU_FRAMES`` frames of its input, copied
    there: the pre-activation bit for bit (both convolve the same codes
    exactly), and SiLU's largest distance in ulps (the card's expf against
    PyTorch's exp on the CPU). Returns that distance."""
    worst = 0
    with torch.inference_mode():
        for args, _ in calls:
            args = (args[0][:CPU_FRAMES],) + args[1:]
            host = tuple(a.cpu() if torch.is_tensor(a) else a for a in args)
            if not same_bits(ck.conv_int8(*q1_linear(args)).cpu(),
                             q1_plain(q1_linear(host))):
                raise AssertionError(f"{label}: Q1's pre-activation on the "
                                     "card differs from the CPU's at "
                                     f"{tuple(args[0].shape)} -> "
                                     f"{tuple(args[1].shape)}")
            worst = max(worst, max_ulps(ck.conv_int8(*args).cpu(),
                                        q1_plain(host)))
    say(f"  Q1 on {label}, card against the CPU's plain version, layer by "
        f"layer on the card's inputs (their first {CPU_FRAMES} frames): "
        f"{len(calls)} calls, pre-activation "
        f"bit for bit, SiLU within {worst} ulps")
    return worst


def q1_launches_a_call(calls):
    """The kernels a Q1 call puts on the card, from the profiler's names
    over all of a forward's calls (so that one record the profiler misses
    moves the mean by a fraction, not to 0): {name: launches / calls}."""
    ops = device_ops(lambda: [ck.conv_int8(*a) for a, _ in calls], 3)
    names = {}
    for name, (_, n) in ops.items():
        short = re.sub(r"\(anonymous namespace\)::", "", name)
        short = re.split(r"[<(]", short.replace("void ", ""))[0]
        names[short] = names.get(short, 0) + n
    return {name: round(n / len(calls), 3) for name, n in names.items()}


def time_q1(label, calls, card):
    """Q1 over one forward's calls: the sums of each call's ms between
    events, of the plain version's and of ``F.conv2d`` in float64, the
    device ms of the whole set from the profiler and of each call class
    (stem, dense 1x1, dense 3x3, depthwise) with its launches and bound,
    ``torch._int_mm`` on the codes of the 1x1 calls it takes beside Q1's
    device ms of the same calls, and the kernels a call launches."""
    ms = plain_ms = library_ms = bound_ms = 0.0
    ops = nbytes = 0
    rows, classes, mm = [], {}, []
    with torch.inference_mode():
        for args, _ in calls:
            k_ms = cuda_ms(lambda: ck.conv_int8(*args), 20)
            o, n = q1_work(args)
            b_ms, _ = q1_bound(o, n)
            ms += k_ms
            bound_ms += b_ms
            ops, nbytes = ops + o, nbytes + n
            plain_ms += cuda_ms(lambda: q1_plain(args), 2)
            library_ms += cuda_ms(q1_library(args), 5)
            cls = classes.setdefault(q1_class(args), dict(
                calls=[], bound_ms=0.0, ops=0, nbytes=0))
            cls["calls"].append(args)
            cls["bound_ms"] += b_ms
            cls["ops"], cls["nbytes"] = cls["ops"] + o, cls["nbytes"] + n
            int_mm = q1_int_mm(args)
            if int_mm is not None:
                mm.append((args, cuda_ms(int_mm, 10)))
            rows.append((k_ms, b_ms, tuple(args[0].shape),
                         tuple(args[1].shape), args[5], args[7]))
        dev, _ = device_ms(lambda: [ck.conv_int8(*a) for a, _ in calls], 3)
        per_call = q1_launches_a_call(calls)
        for cls in classes.values():
            cls["device_ms"], cls["launches"] = device_ms(
                lambda: [ck.conv_int8(*a) for a in cls["calls"]], 3)
        mm_q1, _ = device_ms(lambda: [ck.conv_int8(*a) for a, _ in mm], 3) \
            if mm else (0.0, 0)
    _, bound_by = q1_bound(ops, nbytes)
    mode = "static" if calls[0][0][9] is not None else "dynamic"
    say(f"  Q1 conv_int8, {label}: {len(calls)} calls, {ms:.4f} ms between "
        f"events, {dev:.4f} ms device, plain {plain_ms:.3f} ms, F.conv2d "
        f"float64 {library_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by};"
        f" {ops / 1e9:.2f} G int8 ops, {nbytes / 1e6:.1f} MB) on {card}")
    say(f"    kernels a call ({mode}, from the profiler's names over the "
        f"{len(calls)} calls): {sum(per_call.values()):.3f}: {per_call}")
    for name, cls in sorted(classes.items()):
        say(f"    {name}: {len(cls['calls'])} calls, {cls['launches']} "
            f"launches, device {cls['device_ms']:.4f} ms, bound "
            f"{cls['bound_ms']:.5f} ms ({cls['nbytes'] / 1e6:.1f} MB, "
            f"{cls['ops'] / 1e9:.2f} G ops)")
    mm_ms = sum(t for _, t in mm)
    say(f"    torch._int_mm on the codes of the {len(mm)} 1x1 calls it takes:"
        f" {mm_ms:.4f} ms between events, against Q1's {mm_q1:.4f} ms "
        "device on the same calls (yardstick only; the port never calls it)")
    for k_ms, b_ms, xs, ws, stride, groups in sorted(rows, reverse=True)[:6]:
        say(f"    {k_ms:.4f} ms (bound {b_ms:.5f}): x {xs}, w {ws}, stride "
            f"{stride}, groups {groups}")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                launches_a_call=round(sum(per_call.values()), 3),
                classes={n: dict(calls=len(c["calls"]),
                                 launches=c["launches"],
                                 device_ms=c["device_ms"],
                                 bound_ms=c["bound_ms"])
                         for n, c in classes.items()},
                int_mm_1x1=dict(calls=len(mm), ms=mm_ms, q1_device_ms=mm_q1))


def write_facenet_savedmodel(net, path):
    """A keras FaceNet SavedModel directory of ``net``'s weights, written
    by the port's TensorBundle writer: the stream of
    ``utils.weights.execution_slots`` (HWIO kernels, [in, out] Dense, no BN
    scales), one ``layer_with_weights-i`` a module, keras attribute
    names."""
    from torch.nn.modules.batchnorm import _BatchNorm

    from face_detection_and_recognition_tpu_torch.utils import weights as W
    from face_detection_and_recognition_tpu_torch.utils.tensor_bundle import \
        write_tensor_bundle

    mods, sd = dict(net.named_modules()), net.state_dict()
    layers, named = {}, []
    for name, leaf, _ in W.execution_slots(
            net, torch.zeros(W.FACENET_EXAMPLE), ("scale",)):
        mod = name.rsplit(".", 1)[0]
        arr = sd[name].detach().cpu().numpy()
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        attr = {"kernel": "kernel", "mean": "moving_mean",
                "var": "moving_variance",
                "bias": "beta" if isinstance(mods[mod], _BatchNorm)
                else "bias"}[leaf]
        i = layers.setdefault(mod, len(layers))
        named.append((f"layer_with_weights-{i}/{attr}/.ATTRIBUTES/"
                      "VARIABLE_VALUE", np.ascontiguousarray(arr)))
    (path / "variables").mkdir(parents=True, exist_ok=True)
    (path / "saved_model.pb").write_bytes(b"\x08\x01")
    write_tensor_bundle(str(path / "variables" / "variables"), named)
    return len(named)


def write_wider_tree(root):
    """WIDER_N seeded frames (576x1024 and 480x640) as JPEGs through the
    port's codec, and a WIDER-format annotation file with 1-3 seeded boxes
    an image. Returns (ann path, images root)."""
    from face_detection_and_recognition_tpu_torch.utils import native

    rng = np.random.RandomState(SEED + 7)
    images = root / "images"
    (images / "0--Seeded").mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(WIDER_N):
        hw = IO_HW if i % 2 else (480, 640)
        rel = f"0--Seeded/s{i:03d}.jpg"
        native.write_image_bgr(str(images / rel), smooth_frame(SEED + i, hw))
        n = rng.randint(1, 4)
        lines += [rel, str(n)]
        for _ in range(n):
            w, h = rng.randint(20, 200, 2)
            x, y = rng.randint(0, hw[1] - w), rng.randint(0, hw[0] - h)
            lines.append(f"{x} {y} {w} {h} 0 0 0 0 0 0")
    ann = root / "gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return str(ann), str(images)


def matched_share(ref, got, thr=0.5):
    """(matched, total): the boxes of ``ref`` (Detections) that a box of
    ``got`` in the same frame overlaps at IoU >= thr."""
    from face_detection_and_recognition_tpu_torch.ops.boxes import \
        iou_matrix

    hit = total = 0
    for b in range(ref.valid.shape[0]):
        rb = ref.boxes[b][ref.valid[b]]
        gb = got.boxes[b][got.valid[b]]
        total += len(rb)
        if len(rb) and len(gb):
            hit += int((iou_matrix(rb, gb).amax(1) >= thr).sum())
    return hit, total


def run_bf16(frames, singles, card, f32_det, f32_ens):
    """The bf16 main path: yolov5s bf16 engines, ``detect_batch`` square
    and rect and ``detect_image``, then the yolov5s + mobile_facenet +
    age/gender bf16 ensemble at thresholds 0. After the counts: the heads'
    dtype, B2 / B1 / B3 on the path's own arguments against their plain
    versions, the stages and frames/s beside the f32 engines ``f32_det``
    (square, rect) and ``f32_ens``, the f32 boxes a bf16 box matches, and
    the card against the CPU. Returns (launches, numbers)."""
    from face_detection_and_recognition_tpu_torch.models import \
        yolov5_face
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.utils.profiling import (
        detect_stages, ensemble_stages)

    bf16 = torch.bfloat16
    win, stats = Windows(), {}
    t = time.time()
    engines = {rect: FaceEngine(EngineConfig(detector="yolov5s", rect=rect,
                                             seed=SEED, dtype=bf16))
               for rect in (False, True)}
    ens = FaceEngine(EngineConfig(detector="yolov5s",
                                  embedder="mobile_facenet",
                                  with_age_gender=True, seed=SEED,
                                  dtype=bf16))
    say(f"  bf16 engines built in {time.time() - t:.1f} s")

    def detect_run(rect):
        dets, sec = timed_batches(
            lambda: engines[rect].detect_batch(frames), 5)
        check_dets(f"bf16 rect={rect}", dets, 10)
        stats[f"bf16 rect={rect} fps"] = B / sec
        say(f"  bf16 detect_batch rect={rect}: {B} x 576x1024 frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; "
            f"detections per frame {dets.valid.sum(1).tolist()}")

    for rect in (False, True):
        win.run(f"detect rect={rect}", lambda: detect_run(rect))

    def image_run():
        for i, img in enumerate(singles):
            res = engines[False].detect_image(img)
            if not (np.isfinite(res.boxes).all()
                    and res.boxes.shape[1:] == (4,)):
                raise AssertionError("bf16 detect_image returned bad boxes")
            say(f"  bf16 detect_image request {i}: {len(res)} faces")

    win.run("detect_image", image_run)

    def ens_run():
        r, sec = timed_batches(lambda: ens.detect_embed_classify_batch(
            frames, det_thres=0.0, bbox_area_thres=0.0), 3)
        v = r.det.valid
        for name in ("crops", "embeddings", "age_probs", "gender_probs"):
            t_ = getattr(r, name)
            if t_.dtype != torch.float32 or not bool(
                    torch.isfinite(t_).all()) or bool((t_[~v] != 0).any()):
                raise AssertionError(f"bf16 ensemble {name}: not f32, not "
                                     "finite or an invalid row not zero")
        norm_err = float((r.embeddings[v].norm(dim=-1) - 1).abs().max())
        if not norm_err <= 1e-4:
            raise AssertionError("bf16 embeddings are not unit vectors")
        stats["bf16 ensemble fps"] = B / sec
        say(f"  bf16 detect_embed_classify_batch: {B} frames in "
            f"{sec * 1e3:.2f} ms = {B / sec:.1f} frames/s on {card}; live "
            f"slots per frame {v.sum(1).tolist()}; max |norm - 1| "
            f"{norm_err:.2e}")

    win.run("ensemble", ens_run)
    for part in ("detect rect=False", "detect rect=True", "detect_image"):
        for k in ("nms_fixpoint", "rows_gather"):
            if win.parts[part][k] <= 0:
                raise AssertionError(f"{k} never launched on bf16 {part}")
    if win.parts["ensemble"]["crop_resize"] <= 0:
        raise AssertionError("crop_resize never launched on the bf16 "
                             "ensemble")

    # after the counts: the path's own arguments against the plain versions
    frames_t = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        maps = engines[False]._network(engines[False]._preprocess(frames_t))
    if any(m.dtype != bf16 for m in maps):
        raise AssertionError("the bf16 engine's heads are not bf16")
    b2 = [c for rect in (False, True) for c in captured_calls(
        yolov5_face, "candidate_decode",
        lambda: engines[rect].detect_batch(frames))]
    if any(m.dtype != bf16 for args, _ in b2 for m in args[0]):
        raise AssertionError("rows_gather did not read bf16 maps")
    check_on_path("rows_gather on the bf16 net's own maps",
                  ck.candidate_decode, ck.candidate_decode_plain, b2)
    b1 = [c for rect in (False, True) for c in captured_calls(
        yolov5_face, "nms_fixpoint",
        lambda: engines[rect].detect_batch(frames))]
    check_on_path("nms_fixpoint on the bf16 net's candidates",
                  ck.nms_fixpoint, ck.nms_fixpoint_plain, b1)
    b3 = captured_calls(crop_ops, "crop_resize", lambda: (
        ens.detect_embed_classify_batch(frames, det_thres=0.0,
                                        bbox_area_thres=0.0)))
    stores = sorted({(tuple(a[3]), str(a[7])) for a, _ in b3})
    say(f"  crop_resize calls on the bf16 ensemble (size, store): {stores}")
    if ((227, 227), str(bf16)) not in stores:
        raise AssertionError("the bf16 ensemble's 227 crops are not bf16")
    check_on_path("crop_resize (bf16 store at 227) on the ensemble's own "
                  "crops", ck.crop_resize, ck.crop_resize_plain, b3)

    # stages, frames/s and boxes beside f32
    stages = {"bf16": detect_stages(engines[False], frames),
              "f32": detect_stages(f32_det, frames)}
    for name, st in stages.items():
        say(f"  detect_stages {name}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in st.items()))
    stats["detect_stages"] = stages
    ens_st = {"bf16": ensemble_stages(ens, frames),
              "f32": ensemble_stages(f32_ens, frames)}
    for name, (st, k_live) in ens_st.items():
        say(f"  ensemble_stages {name} (k_live {k_live}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()))
    stats["ensemble_stages"] = {k: v[0] for k, v in ens_st.items()}
    # the network's device time and its operations by kind: where the
    # bf16 net's time goes beside the f32 one's
    with torch.inference_mode():
        for name, eng in (("bf16", engines[False]), ("f32", f32_det)):
            x = eng._preprocess(frames_t)
            ops = device_ops(lambda: eng._network(x), 10)
            total = sum(ms * n for ms, n in ops.values())
            kinds = {}
            for op, (ms, n) in ops.items():
                kind = ("convolution" if "conv" in op.lower() or "gemm"
                        in op.lower() or "xmma" in op.lower()
                        or "cudnn" in op.lower() else "elementwise / other")
                kinds[kind] = kinds.get(kind, 0.0) + ms * n
            count = sum(n for _, n in ops.values())
            stats[f"{name} network device"] = dict(ms=total, ops=count,
                                                   by_kind=kinds)
            top = sorted(ops.items(), key=lambda kv: -kv[1][0] * kv[1][1])
            say(f"  {name} network: {total:.3f} ms device in {count} "
                f"operations a forward; by kind " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in kinds.items())
                + "; the largest: " + "; ".join(
                    f"{op[:60]} {ms * n:.3f} ms ({n}x)"
                    for op, (ms, n) in top[:4]))
    _, f32_sec = timed_batches(lambda: f32_det.detect_batch(frames), 5)
    _, bf_sec = timed_batches(lambda: engines[False].detect_batch(frames), 5)
    stats["detect fps bf16 / f32"] = (B / bf_sec, B / f32_sec)
    say(f"  detect_batch square: bf16 {B / bf_sec:.1f} frames/s against f32 "
        f"{B / f32_sec:.1f} frames/s on {card}")
    for label, kw in (("default thresholds", {}),
                      ("thresholds 0", dict(det_thres=0.0,
                                            bbox_area_thres=0.0))):
        with torch.inference_mode():
            hit, total = matched_share(f32_det.detect_batch(frames, **kw),
                                       engines[False].detect_batch(frames,
                                                                   **kw))
        stats[f"f32 boxes matched by bf16 ({label})"] = (hit, total)
        say(f"  {label}: {hit} of {total} f32 boxes matched by a bf16 box "
            f"at IoU >= 0.5 (information, not a gate)")

    # the card against the CPU: the same bf16 net on 2 frames
    cpu = FaceEngine(EngineConfig(detector="yolov5s", seed=SEED,
                                  dtype=bf16), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         engines[False].net.state_dict().items()})
    with torch.inference_mode():
        got = [m.float().cpu() for m in engines[False]._network(
            engines[False]._preprocess(frames_t[:2]))]
        ref = [m.float() for m in cpu._network(cpu._preprocess(
            torch.from_numpy(frames[:2])))]
    rel = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, ref))
    equal = sum(int((g == r).sum()) for g, r in zip(got, ref)) \
        / sum(r.numel() for r in ref)
    stats["bf16 maps card vs cpu"] = dict(rel=rel, equal=equal)
    say(f"  bf16 maps on the card against the CPU, 2 frames: max |card - "
        f"cpu| / max |cpu| = {rel:.3e}, {equal:.4f} of the elements equal "
        "(a flipped rounding compounds over the net's ~60 layers)")
    equal, scale_ulps, where = bf16_layers_card_vs_cpu(
        engines[False], cpu, engines[False]._preprocess(frames_t[:2]))
    stats["bf16 ConvBNs card vs cpu"] = dict(
        min_equal=equal, max_scale_ulps=scale_ulps, least=where)
    say(f"  bf16 ConvBNs and Detect convolutions on the card against the "
        f"same layers on the CPU, each on the input it had on the card: at "
        f"least {equal:.5f} of a layer's elements equal bit for bit (the "
        f"least: {where}), every difference within {scale_ulps:.3f} bf16 "
        f"ulps of the layer's largest output")
    if equal < 0.999 or scale_ulps > 2.0:
        raise AssertionError(f"bf16 {where} on the card does not compute "
                             "what it computes on the CPU")
    return win.total(), stats


def bf16_layers_card_vs_cpu(eng, cpu, x):
    """Every ConvBN (one convolution, its BatchNorm and SiLU) and each
    Detect convolution of the bf16 yolov5 net on the card against the same
    layer of ``cpu``'s net given the input the card's layer had. Returns
    (the least share of a layer's elements equal bit for bit, the largest
    difference in bf16 ulps of the layer's largest output, the layer with
    the least share). The same rounding points leave only the order of f32
    sums and the platforms' exp / rsqrt to differ."""
    from face_detection_and_recognition_tpu_torch.models.layers import (
        ConvBN, conv_bias_bf16)
    from face_detection_and_recognition_tpu_torch.models.yolov5_face import \
        Detect

    mods = [(n, m) for n, m in eng.net.named_modules()
            if isinstance(m, (ConvBN, Detect))]
    cpu_mods = dict(cpu.net.named_modules())
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: seen.append((n, i[0], o))) for n, m in mods]
    try:
        with torch.inference_mode():
            eng._network(x)
    finally:
        for h in hooks:
            h.remove()
    worst_eq, worst_ulps, where = 1.0, 0.0, None
    card_mods = dict(eng.net.named_modules())
    with torch.inference_mode():
        for n, xi, out in seen:
            m = cpu_mods[n]
            if isinstance(m, Detect):  # each level's convolution
                pairs = [(f"{n}.m.{lv}", conv_bias_bf16(m.m[lv], xl.cpu()),
                          conv_bias_bf16(card_mods[n].m[lv], xl).cpu())
                         for lv, xl in enumerate(xi)]
            else:
                pairs = [(n, m(xi.cpu()), out.cpu())]
            for name, ref, got in pairs:
                if ref.dtype != torch.bfloat16 or got.dtype != torch.bfloat16:
                    raise AssertionError(f"bf16 layer {name} is not bf16")
                eq = float((ref.view(torch.int16) == got.view(torch.int16))
                           .float().mean())
                if eq < worst_eq:
                    worst_eq, where = eq, name
                top = float(ref.float().abs().max())
                ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top else 1.0
                worst_ulps = max(worst_ulps, float(
                    (ref.float() - got.float()).abs().max()) / ulp)
    return worst_eq, worst_ulps, where


TRACE_STEPS = 3
TRACE_KERNELS = {"B1 nms_fixpoint": ("nms_overlap_mask_kernel",
                                     "nms_sweep_kernel"),
                 "B2 rows_gather + decode": ("candidate_decode_kernel",)}


def run_tracing(eng, frames, card):
    """``TRACE_STEPS`` ``detect_batch`` steps of the f32 yolov5s engine
    ``eng`` under ``utils.profiling.device_trace``, read back by
    ``utils.trace_analysis``: the device operations and device time the
    reader finds in the trace file against the profiler's own aggregate
    (``key_averages``) of the same session (the same count, the time
    within 1 %), B1's and B2's kernels found by name, the report, and the
    share of device time whose launch the trace leaves ``<unattributed>``.
    An untraced profiler session of the same call (``device_ops``) is
    printed beside it, with the operations whose time differs most: a
    traced step's device time may drift from an untraced one's (the
    frames' upload from pageable memory runs on a shared host), so that
    comparison is read, not held. A trace that records no device
    operation is taken again, up to three times. Returns its numbers."""
    from face_detection_and_recognition_tpu_torch.utils import \
        trace_analysis as TA
    from face_detection_and_recognition_tpu_torch.utils.profiling import \
        device_trace

    out_dir = WORK_DIR / "trace"
    run = lambda: eng.detect_batch(frames)  # noqa: E731
    run()
    torch.cuda.synchronize()
    for _ in range(3):
        shutil.rmtree(out_dir, ignore_errors=True)
        t = time.time()
        with torch.inference_mode(), device_trace(str(out_dir)) as prof:
            for _ in range(TRACE_STEPS):
                run()
            torch.cuda.synchronize()
        trace_s = time.time() - t
        t = time.time()
        ops = TA.load_device_ops(str(out_dir))
        parse_s = time.time() - t
        if ops:
            break
    if not ops:
        raise AssertionError("three device traces recorded no device "
                             "operation")
    step_ms = sum(o.duration_us for o in ops) / 1e3 / TRACE_STEPS
    agg = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    agg_ms = sum(e.self_device_time_total for e in agg) / 1e3 / TRACE_STEPS
    agg_n = sum(e.count for e in agg)
    if len(ops) != agg_n or abs(step_ms - agg_ms) > 0.01 * agg_ms:
        raise AssertionError(f"trace: the reader found {len(ops)} device "
                             f"operations, {step_ms:.4f} device ms a step, "
                             f"against the session's key_averages' {agg_n}, "
                             f"{agg_ms:.4f} ms")
    traced = {}
    for o in ops:
        traced[o.name] = traced.get(o.name, 0.0) + o.duration_us / 1e3
    untraced = device_ops(run, TRACE_STEPS)
    ref_ms = sum(ms * n for ms, n in untraced.values()) or None
    ref_ops = sum(n for _, n in untraced.values())
    drift = sorted(((traced.get(k, 0.0) / TRACE_STEPS
                     - untraced.get(k, (0.0, 0))[0]
                     * untraced.get(k, (0.0, 0))[1], k)
                    for k in set(traced) | set(untraced)),
                   key=lambda d: -abs(d[0]))[:3]
    found = {}
    for label, names in TRACE_KERNELS.items():
        hits = [o for o in ops if any(n in o.name for n in names)]
        if not hits:
            raise AssertionError(f"trace: no {label} kernel "
                                 f"({', '.join(names)}) among "
                                 f"{sorted({o.name for o in ops})}")
        found[label] = {"launches a step": len(hits) / TRACE_STEPS,
                        "ms a step": sum(o.duration_us for o in hits)
                        / 1e3 / TRACE_STEPS,
                        "source": TA.source_file_key(hits[0])}
    unattributed = sum(o.duration_us for o in ops
                       if TA.source_file_key(o) == TA.UNATTRIBUTED)
    share = unattributed / sum(o.duration_us for o in ops)
    say(f"  trace of {TRACE_STEPS} detect_batch steps (yolov5s f32, "
        f"{B} x 576x1024): {len(ops)} device operations, {step_ms:.4f} "
        f"device ms a step, against the session's key_averages' {agg_n} "
        f"and {agg_ms:.4f} ms on {card}; traced in {trace_s:.2f} s, "
        f"parsed in {parse_s:.2f} s")
    say(f"  an untraced session: {ref_ms and round(ref_ms, 4)} device ms"
        f" a step in {ref_ops} operations; traced minus untraced,"
        f" the largest per operation (ms a step): "
        + "; ".join(f"{k[:60]} {d:+.4f}" for d, k in drift))
    for label, f in found.items():
        say(f"  {label}: {json.dumps(f)}")
    say(f"  <unattributed> share of the device time: {share:.4f}")
    with contextlib.redirect_stdout(io.StringIO()) as report:
        TA.print_report(str(out_dir), steps=TRACE_STEPS, n=10)
    for line in report.getvalue().splitlines():
        say(f"  | {line}")
    return {"step_ms": step_ms, "key_averages_ms": agg_ms,
            "device_ms": ref_ms, "ops": len(ops),
            "unattributed_share": share, "kernels": found,
            "trace_s": trace_s, "parse_s": parse_s}


BF16_FAMILIES = ("blazeface-front", "blazeface-back", "ssd-resnet10",
                 "ssd-mobilenetv2", "ssd-squeezenet", "mtcnn", "res10-ssd",
                 "ov-0204", "ov-squeezenet-light", "openvino-ir")
BF16_FAMILY_DIR = WORK_DIR / "bf16_families"


def family_heads(eng, x):
    """A detector's raw heads on the device of ``x`` (B frames, uint8), as
    f32 tensors: the net on the preprocessed frames, or for MTCNN P-Net on
    the first pyramid level (the cascade runs in its decode)."""
    from face_detection_and_recognition_tpu_torch.models.mtcnn import \
        pyramid_scales
    from face_detection_and_recognition_tpu_torch.ops.geometry import \
        resize_bilinear

    with torch.inference_mode(), _full_f32(x.device):
        if not eng.native_resolution:
            out = eng._network(eng._preprocess(x))
        else:
            net, (h, w) = eng.net, x.shape[1:3]
            scale = pyramid_scales(h, w, net.cfg.min_size, net.cfg.factor)[0]
            norm = (x.float().flip(-1) - 127.5) * 0.0078125
            level = resize_bilinear(norm, (int(math.ceil(h * scale)),
                                           int(math.ceil(w * scale))),
                                    dtype=net.pnet.compute_dtype)
            out = net.pnet(level.permute(0, 3, 1, 2))
    return [t.float().cpu() for t in out]


def run_bf16_families(frames, card):
    """The bf16 engines of the other families (A8b): blazeface front and
    back, the three SSDs, mtcnn (every stage full), res10-ssd (a seeded
    caffemodel, ``data_scale`` 1/64), ov-0204, ov-squeezenet-light and
    openvino-ir (a seeded ov-0204 IR), each built with
    ``EngineConfig(dtype=torch.bfloat16)`` and ``detect_batch`` on the 8
    frames at thresholds 0, a part each. After the counts are read: B1, B3
    and the fused B5 on the path's own inputs (recorded by a spy) against
    their plain versions bit for bit; each family's bf16 heads on 2 frames
    on the card against the same bf16 net on the CPU (the share of equal
    elements); each network's device ms and operations bf16 beside the
    f32 engine of the same weights. Returns (launches, numbers)."""
    from face_detection_and_recognition_tpu_torch.models import blazeface
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.ops import nms as nms_ops

    BF16_FAMILY_DIR.mkdir(parents=True, exist_ok=True)
    caffemodel = BF16_FAMILY_DIR / "res10.caffemodel"
    xml = BF16_FAMILY_DIR / "ov_0204.xml"
    t = time.time()

    def engine(name, dtype, device=None):
        ov = dict(MTCNN_FULL) if name == "mtcnn" else {}
        if name == "openvino-ir":
            ov["xml"] = str(xml)
        eng = FaceEngine(EngineConfig(detector=name, seed=SEED, dtype=dtype,
                                      detector_overrides=ov), device=device)
        if name == "res10-ssd":
            eng.load_weights(str(caffemodel))
        return eng

    write_res10_caffemodel(FaceEngine(EngineConfig(
        detector="res10-ssd", seed=SEED + 1), device="cpu").net, caffemodel)
    write_ir(FaceEngine(EngineConfig(detector="ov-0204", seed=SEED),
                        device="cpu").net, xml)
    engines = {n: engine(n, torch.bfloat16) for n in BF16_FAMILIES}
    f32 = {n: engine(n, torch.float32) for n in BF16_FAMILIES}
    say(f"  bf16 and f32 engines built in {time.time() - t:.1f} s")
    win, stats = Windows(), {}
    targets = [(nms_ops, "nms_fixpoint"), (crop_ops, "crop_resize"),
               (blazeface, "blaze_decode_blend")]
    with spied_calls(targets) as seen, torch.inference_mode():
        for name, eng in engines.items():
            eng.detect_batch(frames, 0.0, 0.0)  # cuDNN picks its plans
            dets = win.run(name, lambda: eng.detect_batch(frames, 0.0, 0.0))
            check_dets(f"bf16 {name}", dets, eng.spec.n_landmark_cols,
                       k=dets.valid.shape[1])
            kernels = ("blaze_decode_blend",) if name.startswith("blaze") \
                else ("nms_fixpoint", "crop_resize") if name == "mtcnn" \
                else ("nms_fixpoint",)
            for k in kernels:
                if win.parts[name][k] <= 0:
                    raise AssertionError(f"bf16 {name}: {k} never launched")
            stats[f"{name} detections a frame"] = dets.valid.sum(1).tolist()
    say(f"  launches by part: {json.dumps(win.parts)}")
    check_on_path("nms_fixpoint on the bf16 families' candidates",
                  ck.nms_fixpoint, ck.nms_fixpoint_plain, seen["nms_fixpoint"])
    check_on_path("crop_resize on the bf16 cascade's R/O-Net crops",
                  ck.crop_resize, ck.crop_resize_plain, seen["crop_resize"])
    check_on_path("blaze_decode_blend on the bf16 nets' heads",
                  ck.blaze_decode_blend, ck.blaze_decode_blend_plain,
                  seen["blaze_decode_blend"])

    frames_t = torch.from_numpy(frames).cuda()
    for name, eng in engines.items():
        heads = family_heads(eng, frames_t[:2])
        cpu = engine(name, torch.bfloat16, "cpu")
        cpu.net.load_state_dict({k: v.cpu()
                                 for k, v in eng.net.state_dict().items()})
        ref = family_heads(cpu, torch.from_numpy(frames[:2]))
        equal = sum(int((g == r).sum()) for g, r in zip(heads, ref)) \
            / sum(r.numel() for r in ref)
        rel = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                  for g, r in zip(heads, ref))
        timing = {}
        for dt, e in (("bf16", eng), ("f32", f32[name])):
            with torch.inference_mode():
                if e.native_resolution:
                    fn = lambda e=e: e.net.detect(frames_t)  # noqa: E731
                else:
                    x = e._preprocess(frames_t)
                    fn = lambda e=e, x=x: e._network(x)  # noqa: E731
                with _full_f32(frames_t.device):
                    timing[dt] = (cuda_ms(fn, 10), *device_ms(fn, 5))
        stats[name] = dict(heads_equal=equal, heads_rel=rel, **{
            f"{dt} network": dict(ms=v[0], device_ms=v[1], ops=v[2])
            for dt, v in timing.items()})
        say(f"  {name}: bf16 heads on the card against the CPU, 2 frames: "
            f"{equal:.4f} of the elements equal, max |card - cpu| / max "
            f"|cpu| = {rel:.3e}; network ({'cascade' if eng.native_resolution else 'net'}) "
            + ", ".join(f"{dt} {v[0]:.3f} ms between events, {v[1]:.3f} ms "
                        f"device in {v[2]} operations"
                        for dt, v in timing.items()) + f" on {card}")
    return win.total(), stats


def run_trained_weights(card):
    """The trained-weights main path: each net of ``card_weights/``
    (``eval/card_weights.py``) loaded on the card through the engine's
    weight loaders, run through the golden gate of its JAX test on the
    golden image and the negative one, and held to the JAX CPU engine's
    detections at each of the gate's thresholds (``expected.json``);
    MobileFaceNet's embeddings of the pinned crops to JAX's at cosine >=
    0.999. Each net is a part of the path (``Windows``). A net that fails
    is run again on the CPU, and the card's boxes against the CPU's are
    printed before the run fails. Returns (launches, numbers)."""
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    exp = CW.load_expected()
    pos, neg = CW.golden_images()
    golden = np.asarray(exp["golden_boxes"], np.float32)
    win, stats = Windows(), {}
    for name, entry in exp["nets"].items():
        t = time.time()
        eng = CW.build_engine(entry)
        try:
            summary = win.run(name, lambda: CW.check_detector(
                name, entry, eng, pos, neg, golden))
        except AssertionError:
            cpu = CW.build_engine(entry, "cpu")
            for tag, img in (("golden", pos), ("negative", neg)):
                thr = entry["gate"]["det_thres"]
                got = eng.detect_image(img, det_thres=thr)
                ref = cpu.detect_image(img, det_thres=thr)
                say(f"  {name} on the {tag} image at {thr}: card "
                    f"{np.asarray(got.boxes).tolist()} "
                    f"{np.asarray(got.bbox_confs).tolist()}, CPU "
                    f"{np.asarray(ref.boxes).tolist()} "
                    f"{np.asarray(ref.bbox_confs).tolist()}")
            raise
        summary["s"] = time.time() - t
        stats[name] = summary
        say(f"  {name} ({entry['file']}, {entry.get('dtype', 'float32')}"
            f"{', ' + json.dumps(entry['overrides']) if entry.get('overrides') else ''}): "
            f"gate ok {summary['ok']}, {summary['n_pos']} faces at IoU "
            f"{summary['ious']}, {summary['n_neg']} on the negative image; "
            f"largest box difference from the JAX CPU engine "
            f"{summary['max_px']} px over {len(entry['jax']['runs'])} "
            f"thresholds x 2 images ({summary['s']:.1f} s)")
    for name, entry in exp["embedders"].items():
        eng = CW.build_engine(entry)
        stats[name] = win.run(name, lambda: CW.check_embedder(
            name, entry, eng, pos))
        say(f"  {name} ({entry['file']}): cosines to JAX's embeddings of "
            f"the pinned crops {stats[name]['cosines']}")
    stats["windows"] = win.parts
    say(f"  trained weights on {card}: every gate held")
    return win.total(), stats


def run_int8_keras_eval(frames, card):
    """The int8 yolov5 detectors, the keras FaceNet reader and the WIDER
    eval on the card. yolov5n and yolov5s at full width, seeded f32
    weights folded and quantized by ``utils/quantize.py`` in the registry
    (``detector_overrides={"quantized": True | "static"}``), the static
    scales then calibrated again on the path's own 8 frames;
    ``detect_batch`` of the 8 576x1024 frames at thresholds 0 (square
    640). A FaceNet SavedModel written by the port's TensorBundle writer,
    loaded into an engine of another seed with ``load_embed_weights``, and
    ``embed_crops``; the ``eval_wider`` CLI with the static yolov5n's
    ``.pt`` on a seeded WIDER-format tree, and ``evaluate_engine_on_wider``
    in process on the same file. Each part zeroes the counts before it and
    reads them after. After the read: every Q1 call of one int8 forward of
    each net and mode against its plain version (pre-activation bit for
    bit, SiLU within SILU_ULPS) and, for yolov5n's dynamic forward,
    against the plain version on the CPU too; Q1 timed over yolov5n's
    dynamic forward and yolov5s's static one, the card's rows and raw maps
    against the port on the CPU (the differences printed; an int8 net
    turns the ulps of exp into flipped codes, and those compound), frames/s of int8 against
    f32, the embeddings against the state-dict engine's (equal) and the
    CLI's metrics against the in-process ones (equal)."""
    from face_detection_and_recognition_tpu_torch.cli import eval_wider
    from face_detection_and_recognition_tpu_torch.eval.coco_eval import \
        evaluate_engine_on_wider
    from face_detection_and_recognition_tpu_torch.utils import quantize as Q

    IKE_DIR.mkdir(parents=True, exist_ok=True)
    win, stats = Windows(), {}
    frames_t = torch.from_numpy(frames).cuda()
    cfg = dict(det_thres=0.0, bbox_area_thres=0.0, seed=SEED)
    engines, f32 = {}, {}
    for arch in INT8_ARCHS:
        f32[arch] = FaceEngine(EngineConfig(detector=arch, **cfg))
        with torch.inference_mode(), _full_f32(torch.device("cuda")):
            scales = Q.calibrate_activation_scales(
                f32[arch].net, [f32[arch]._preprocess(frames_t)])
        static = Q.pour_activation_scales(
            Q.quantize_state_dict(f32[arch].net.state_dict()), scales)
        for q in INT8_MODES:
            eng = FaceEngine(EngineConfig(detector=arch, **cfg,
                                          detector_overrides={"quantized": q}))
            if q == "static":
                eng.load_state_dict(static)
            engines[arch, q] = eng
    say(f"  engines built; {len(scales)} calibrated scales a static net")

    for (arch, q), eng in engines.items():
        label = f"{arch} int8 {mode_name(q)}"
        dets = win.run(label, lambda: eng.detect_batch(frames))
        check_dets(label, dets, 10)
        say(f"  {label} detect_batch: detections per frame "
            f"{dets.valid.sum(1).tolist()}, Q1 launches "
            f"{win.parts[label]['conv_int8']}")
        if win.parts[label]["conv_int8"] <= 0:
            raise AssertionError(f"{label}: Q1 never launched")

    # the keras FaceNet SavedModel, written by the port and read on the card
    sm = IKE_DIR / "facenet_keras_p38"
    shutil.rmtree(sm, ignore_errors=True)
    ref_eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                      embedder="facenet", seed=SEED))
    n_arrays = write_facenet_savedmodel(ref_eng.embed_net, sm)
    crops = np.random.RandomState(SEED + 3).randint(0, 256, (64, 150, 130, 3),
                                                    np.uint8)
    keras_eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                        embedder="facenet", seed=SEED + 5))

    def keras_part():
        keras_eng.load_embed_weights(str(sm))
        return keras_eng.embed_crops(crops)

    emb = win.run("facenet savedmodel", keras_part)
    ref_emb = ref_eng.embed_crops(crops)
    if not np.array_equal(emb, ref_emb):
        raise AssertionError("the SavedModel's embeddings differ from the "
                             "state-dict engine's")
    say(f"  facenet SavedModel ({n_arrays} arrays) on the card: {len(emb)} "
        "embeddings equal to the state-dict engine's")

    # eval_wider: the CLI and the in-process runner on the same int8 .pt
    ann, images = write_wider_tree(IKE_DIR / "wider")
    pt = IKE_DIR / "yolov5n_int8_static.pt"
    engines["yolov5n", "static"].save_weights(str(pt))
    out, sec = win.run("eval_wider cli", lambda: run_cli(eval_wider, [
        "--ann", ann, "--images", images, "--md", "yolov5n", "--ckpt",
        str(pt)]))
    cli_metrics = json.loads(out.strip().splitlines()[-1])
    ev = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.02,
                                 bbox_area_thres=0.0, max_det=300))
    ev.load_weights(str(pt))
    metrics = win.run("evaluate_engine_on_wider",
                      lambda: evaluate_engine_on_wider(ev, ann, images))
    if cli_metrics != metrics:
        raise AssertionError(f"eval_wider printed {cli_metrics}, the runner "
                             f"gave {metrics}")
    say(f"  eval_wider on {WIDER_N} seeded images (int8 static yolov5n, "
        f"seeded weights: the AP means nothing): {cli_metrics} in "
        f"{sec:.2f} s, equal to evaluate_engine_on_wider")
    stats["eval_wider"] = cli_metrics

    # after the counts: Q1 against its plain version on the path's inputs
    q1 = {}
    for (arch, q), eng in engines.items():
        label = f"{arch} int8 {mode_name(q)}"
        calls = captured_calls(ck, "conv_int8",
                               lambda: eng.detect_batch(frames))
        n, worst, err = check_q1_calls(label, calls)
        q1[label] = (calls, err)
        say(f"  Q1 on {label}: {n} calls, pre-activation bit for bit, SiLU "
            f"within {worst} ulps (max |kernel - plain| {err:.2e})")
    n, worst = check_q1_sweep()
    say(f"  Q1 on the sweep of the redesign's edge shapes ({len(Q1_SWEEP)} "
        f"layers, dynamic and static): {n} calls, pre-activation bit for "
        f"bit, SiLU within {worst} ulps")
    stats["Q1 sweep"] = dict(calls=n, silu_ulps=worst)
    stats["Q1 card vs cpu silu ulps"] = q1_card_against_cpu(
        "yolov5n int8 dynamic", q1["yolov5n int8 dynamic"][0])
    timing = time_q1("yolov5n int8 dynamic, B = 8, 640x640",
                     q1["yolov5n int8 dynamic"][0], card)
    stats["Q1 yolov5s int8 static"] = time_q1(
        "yolov5s int8 static, B = 8, 640x640", q1["yolov5s int8 static"][0],
        card)

    # the card against the CPU, and int8 against f32
    head = torch.from_numpy(frames[:CPU_FRAMES])
    for (arch, q), eng in engines.items():
        label = f"{arch} int8 {mode_name(q)}"
        cpu = FaceEngine(EngineConfig(detector=arch, **cfg,
                                      detector_overrides={"quantized": q}),
                         device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             eng.net.state_dict().items()})
        # the same frames on both (a dynamic scale is the whole batch's):
        # the rows, and the raw maps under them (an int8 code flipped by an
        # ulp of exp moves scores enough to reorder a seeded net's rows)
        with torch.inference_mode():
            xg = eng._preprocess(frames_t[:CPU_FRAMES])
            xc = cpu._preprocess(head)
            got = [m.cpu() for m in eng._network(xg)]
            ref = cpu._network(xc)
            (gb, gv), (rb, rv) = eng._detect(xg), cpu._detect(xc)
        gb, gv = gb.cpu(), gv.cpu()
        rows = float((gb - rb)[gv & rv].abs().max()) if (gv & rv).any() \
            else 0.0
        rel = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(got, ref))
        share = sum(int(((g - r).abs() > 1e-3 * r.abs().max()).sum())
                    for g, r in zip(got, ref)) / sum(r.numel() for r in ref)
        say(f"  {label} on the card against the CPU, {CPU_FRAMES} frames: "
            f"rows {gv.sum(1).tolist()} / {rv.sum(1).tolist()}, max |card - "
            f"cpu| of the row slots both fill {rows:.3e}; raw maps max "
            f"|card - cpu| / max |cpu| = {rel:.3e}, {share:.2e} of the "
            "elements beyond 1e-3 of their level's max")
        stats[f"{label} card vs cpu"] = dict(rows=rows, maps=rel,
                                             share=share)
        _, sec = win.run(f"{label} timed", lambda: timed_batches(
            lambda: eng.detect_batch(frames), 5))
        _, f32_sec = win.run(f"{arch} f32 timed", lambda: timed_batches(
            lambda: f32[arch].detect_batch(frames), 5))
        stats[f"{label} fps"] = B / sec
        stats[f"{arch} f32 fps"] = B / f32_sec
        with torch.inference_mode():
            x = eng._preprocess(frames_t)
            net_ms = cuda_ms(lambda: eng._network(x), 10)
            f32_ms = cuda_ms(lambda: f32[arch]._network(x), 10)
        stats[f"{label} network ms"] = net_ms
        stats[f"{arch} f32 network ms"] = f32_ms
        say(f"  {label}: {B / sec:.1f} frames/s (network {net_ms:.3f} ms) "
            f"against f32 {B / f32_sec:.1f} frames/s (network {f32_ms:.3f}"
            f" ms) on {card}")

    stats["windows"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in win.parts.items()}
    counted = {k: v for k, v in win.parts.items() if not k.endswith(" timed")}
    launches = {k: sum(p[k] for p in counted.values()) for k in ck.LAUNCHES}
    kernel = dict(
        name="conv_int8", route="cuda",
        source="face_detection_and_recognition_tpu_torch/csrc/conv_int8.cu",
        replaces="face_detection_and_recognition_tpu/models/layers.py:80 "
                 "(ConvBN quantized: lax.conv_general_dilated int8 x int8 -> "
                 "int32; no Pallas kernel)",
        max_abs_err=max(err for _, err in q1.values()), **timing)
    return launches, stats, kernel


# [main path: training]: yolov5s at the main path's width and train_golden's
# batch; the golden run resumes from the trained net, 4 steps, two evals:
# its augmented buffer then holds the 64 examples the steps draw, where
# 768 (the buffer of a run of 48 steps or more) took ~100 of the phase's
# 167 s of host mosaic on the card's host (~0.15-0.3 s an example)
TRAIN_DIR = WORK_DIR / "training"
TRAIN_DEVICE = "cuda"
TRAIN_ARCH, TRAIN_SIZE, TRAIN_B = "yolov5s", 640, 16
GOLDEN_STEPS, GOLDEN_EVAL, GOLDEN_IMAGES = 4, 2, 32
# the strict IoU bar keeps the run from stopping at its first eval (the
# trained net's IoUs are 0.85-0.96): the verdict is printed, not asserted
GOLDEN_GATE = {"gate_det_thres": 0.6, "gate_margin": 0.15, "gate_iou": 0.95}
TIMED_STEPS = 5
# the card-against-CPU step runs on the batch's first STEP_B examples (all
# 16 took ~11 s of the CPU on the card's host)
STEP_B = 4
FAMILY_STEPS, FAMILY_B = 3, 8
# card against CPU, one step from the same weights and batch, in the
# precision every step trains in (train_precision: f32, TF32 off): the
# loss, and each updated tensor's largest difference over its largest value
# (at least 0.01, the scale of a parameter)
STEP_LOSS_RTOL, STEP_TENSOR_RTOL = 1e-4, 1e-3
FAMILY_LOSS_RTOL = 1e-3     # the BlazeFace and SSD steps, three in a row


def tensor_gap(got, ref):
    """(largest difference over max(largest |ref|, 0.01), its name) over
    the float tensors of two state dicts (``got`` may be on the card)."""
    worst = (0.0, "")
    for k, r in ref.items():
        if not r.dtype.is_floating_point:
            continue
        d = float((got[k].detach().cpu() - r).abs().max())
        worst = max(worst, (d / max(float(r.abs().max()), 0.01), k))
    return worst


def split_state(net):
    """(parameters, BatchNorm statistics) of a net as CPU state dicts."""
    sd = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    stats = {k: v for k, v in sd.items() if ".running_" in k}
    return {k: v for k, v in sd.items() if k not in stats
            and not k.endswith("num_batches_tracked")}, stats


def train_step_card_vs_cpu(batch):
    """One ``make_det_train_step_ema`` step of yolov5s at the phase's size
    and batch on the card and on the CPU from the same weights and batch,
    each in the step's own precision (``train_precision``, the one the
    timed chunks and ``train_golden`` train in). Returns (the card's state,
    numbers); raises when a difference exceeds its tolerance."""
    from face_detection_and_recognition_tpu_torch.train import detection as TD

    cfg = TD.DetTrainConfig(arch=TRAIN_ARCH, input_size=(TRAIN_SIZE,
                                                         TRAIN_SIZE),
                            max_targets=8, ema_decay=0.999, ema_tau=500.0)
    states, losses = {}, {}
    for dev in (TRAIN_DEVICE, "cpu"):
        st = TD.create_det_train_state(cfg, torch.Generator().manual_seed(
            SEED), dev)
        step = TD.make_det_train_step_ema(st)
        t = time.time()
        loss, _ = step(*(torch.from_numpy(a).to(st["device"])
                         for a in batch))
        losses[dev] = float(loss)
        say(f"  one step on {st['device']}: loss {losses[dev]:.6f} "
            f"({time.time() - t:.1f} s)")
        states[dev] = st
    card, cpu = states[TRAIN_DEVICE], states["cpu"]
    cp, cs = split_state(card["net"])
    rp, rs = split_state(cpu["net"])
    ce, _ = split_state(card["ema"])
    re_, _ = split_state(cpu["ema"])
    out = {"loss_rel": abs(losses[TRAIN_DEVICE] - losses["cpu"])
           / abs(losses["cpu"]),
           "params": tensor_gap(cp, rp), "bn_stats": tensor_gap(cs, rs),
           "ema": tensor_gap(ce, re_)}
    say(f"  card against CPU: loss relative difference "
        f"{out['loss_rel']:.3e} (tolerance {STEP_LOSS_RTOL}); largest "
        f"relative difference (over the tensor's largest value, at least "
        f"0.01; tolerance {STEP_TENSOR_RTOL}): parameters "
        f"{out['params'][0]:.3e} ({out['params'][1]}), BN statistics "
        f"{out['bn_stats'][0]:.3e} ({out['bn_stats'][1]}), EMA "
        f"{out['ema'][0]:.3e} ({out['ema'][1]})")
    if out["loss_rel"] > STEP_LOSS_RTOL or max(
            out[k][0] for k in ("params", "bn_stats", "ema")) \
            > STEP_TENSOR_RTOL:
        raise AssertionError(f"training step: card against CPU {out}")
    return card, out


def time_training(state, data):
    """The card's figures of the yolov5s step in the device loop: ms a step
    between CUDA events over chunks of ``TIMED_STEPS``, steps/s, and one
    chunk traced without Python stacks (``utils.profiling.device_trace``):
    device ms a step (``trace_analysis``) and the device's idle share over
    the chunk."""
    from torch.profiler import record_function

    from face_detection_and_recognition_tpu_torch.train import detection as TD
    from face_detection_and_recognition_tpu_torch.train import \
        device_loop as DL
    from face_detection_and_recognition_tpu_torch.utils import \
        trace_analysis as TA
    from face_detection_and_recognition_tpu_torch.utils.profiling import \
        device_trace

    dev = state["device"]
    xs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in data]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    chunk = DL.make_chunk_trainer(TD.make_det_train_step_ema(state), state,
                                  TRAIN_B, TIMED_STEPS, flip_lr=0.5,
                                  brightness=0.2, ema_stats_cfg=(0.999,
                                                                 500.0))
    step_ms = cuda_ms(lambda: chunk(*xs, gen), iters=2) / TIMED_STEPS
    trace_dir = TRAIN_DIR / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with device_trace(str(trace_dir), with_stack=False):
        with record_function("chunk"):
            loss, _ = chunk(*xs, gen)
            torch.cuda.synchronize()
    ops = TA.load_device_ops(str(trace_dir))
    busy_ms, wall_ms, idle = TA.idle_share(str(trace_dir), "chunk")
    out = {"step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
           "device_ms_per_step": sum(o.ms for o in ops) / TIMED_STEPS,
           "device_ops_per_step": len(ops) / TIMED_STEPS,
           "chunk_wall_ms": wall_ms, "chunk_busy_ms": busy_ms,
           "idle_share": idle, "chunk_loss": float(loss)}
    # the profiler slows the host's issue; beside the traced window's share,
    # the share the untraced step leaves (its device ms against its ms)
    out["idle_share_untraced"] = 1.0 - out["device_ms_per_step"] / step_ms
    if not ops or not math.isfinite(out["chunk_loss"]):
        raise AssertionError(f"training timing: {out}")
    return out


def family_steps_card_vs_cpu():
    """``FAMILY_STEPS`` steps of the BlazeFace-front and ssd-resnet10
    trainers at their native sizes on the card and on the CPU from the same
    weights and seeded batches: each step's loss, card against CPU."""
    from face_detection_and_recognition_tpu_torch.train import blazeface as TB
    from face_detection_and_recognition_tpu_torch.train import ssd as TS

    out = {}
    for name, cfg, create, make in (
            ("blazeface-front", TB.BlazeTrainConfig(max_targets=4),
             TB.create_blaze_train_state, TB.make_blaze_train_step_ema),
            ("ssd-resnet10", TS.SSDTrainConfig(max_targets=4),
             TS.create_ssd_train_state, TS.make_ssd_train_step_ema)):
        size = cfg.input_size[0]
        rng = np.random.RandomState(SEED)
        batches = []
        for _ in range(FAMILY_STEPS):
            x = rng.randint(0, 255, (FAMILY_B, size, size, 3)).astype(
                np.uint8)
            t = np.zeros((FAMILY_B, 4, 14), np.float32)
            t[..., 4:] = -1.0
            t[:, 0, :4] = rng.uniform(0.3, 0.7, (FAMILY_B, 4)) * [
                size, size, 0.5 * size, 0.5 * size]
            batches.append((x, t, t[..., 2] > 0))
        losses = {}
        for dev in (TRAIN_DEVICE, "cpu"):
            st = create(cfg, torch.Generator().manual_seed(SEED), dev)
            step = make(st)
            losses[dev] = [float(step(*(torch.from_numpy(a).to(
                st["device"]) for a in b))[0]) for b in batches]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses[TRAIN_DEVICE],
                                                   losses["cpu"])]
        say(f"  {name} at {size}x{size}, B = {FAMILY_B}: losses card "
            f"{[round(v, 6) for v in losses[TRAIN_DEVICE]]}, CPU "
            f"{[round(v, 6) for v in losses['cpu']]}, relative differences "
            f"{[f'{r:.2e}' for r in rel]} (tolerance {FAMILY_LOSS_RTOL})")
        if max(rel) > FAMILY_LOSS_RTOL or not all(
                math.isfinite(v) for v in losses[TRAIN_DEVICE]):
            raise AssertionError(f"{name} steps: card against CPU {losses}")
        out[name] = {"card": losses[TRAIN_DEVICE], "cpu": losses["cpu"],
                     "rel": rel}
    return out


def check_reload(ckpt, candidate, frames):
    """A fresh engine loading the written ``.pt`` against an engine holding
    the in-memory candidate: the same detections of the golden pair, bit
    for bit."""
    from face_detection_and_recognition_tpu_torch.train import golden as G

    mem = G.golden_engine(TRAIN_ARCH, TRAIN_SIZE, device=TRAIN_DEVICE)
    mem.load_state_dict(candidate)
    disk = G.golden_engine(TRAIN_ARCH, TRAIN_SIZE, device=TRAIN_DEVICE)
    disk.load_weights(str(ckpt))
    a = mem.detect_batch(frames, det_thres=0.3)
    b = disk.detect_batch(frames, det_thres=0.3)
    for field in ("boxes", "scores", "lmarks", "valid"):
        if not torch.equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"reloaded .pt: {field} differ from the "
                                 "in-memory candidate's")
    return int(a.valid.sum())


def run_training(card):
    """The training main path: the card-against-CPU step, ``train_golden``
    resumed from the trained yolov5s, ``quantize_golden`` of the golden
    yolov5n, three BlazeFace and SSD steps, and the card's figures.
    Returns (launches, numbers)."""
    from face_detection_and_recognition_tpu_torch.cli import \
        quantize_golden as QG
    from face_detection_and_recognition_tpu_torch.core.engine import \
        read_state_dict
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW
    from face_detection_and_recognition_tpu_torch.train import golden as G
    from face_detection_and_recognition_tpu_torch.train.data import \
        load_wider_index
    from face_detection_and_recognition_tpu_torch.train.device_loop import \
        build_example_buffer

    t_phase = time.time()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    win, stats = Windows(), {}
    exp = CW.load_expected()
    pos, neg = CW.golden_images()

    # a batch of golden composites, as train_golden's buffer holds them
    ann, root = G.make_composite_dataset(
        str(TRAIN_DIR / "step_ds"), n_images=TRAIN_B,
        out_wh=(TRAIN_SIZE, TRAIN_SIZE), seed=SEED, include_real=False)
    data = build_example_buffer(load_wider_index(ann, root), TRAIN_B,
                                (TRAIN_SIZE, TRAIN_SIZE), 8, seed=SEED)
    state, stats["step"] = train_step_card_vs_cpu(
        tuple(a[:STEP_B] for a in data))
    stats["timing"] = time_training(state, data)
    del state
    torch.cuda.empty_cache()

    ckpt = TRAIN_DIR / "golden_yolov5s.pt"
    lines = []
    t = time.time()
    res = win.run("train_golden", lambda: G.train_golden(
        str(ckpt), str(TRAIN_DIR / "golden"), arch=TRAIN_ARCH,
        input_size=TRAIN_SIZE, batch_size=TRAIN_B, max_steps=GOLDEN_STEPS,
        eval_every=GOLDEN_EVAL, n_images=GOLDEN_IMAGES, seed=SEED,
        resume_from=str(CW.CARD_WEIGHTS / "yolov5s.pt"),
        device=TRAIN_DEVICE, log=lines.append,
        **GOLDEN_GATE))
    golden_s = time.time() - t
    for line in lines:
        say(f"  {line}")
    losses = res["chunk_losses"]
    if len(losses) != GOLDEN_STEPS // GOLDEN_EVAL or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"train_golden chunk losses {losses}")
    if res["n_updates"] != GOLDEN_STEPS:
        raise AssertionError(f"train_golden: {res['n_updates']} updates")
    resumed = read_state_dict(str(CW.CARD_WEIGHTS / "yolov5s.pt"))
    ema_moved = max(float((res["candidate"][k] - v).abs().max())
                    for k, v in resumed.items() if v.dtype.is_floating_point
                    and ".running_" not in k)
    if not ema_moved > 0:
        raise AssertionError("train_golden: the EMA did not move")
    n_dets = check_reload(ckpt, res["candidate"], np.stack([pos, neg]))
    stats["train_golden"] = {
        "s": golden_s, "steps": GOLDEN_STEPS, "chunk_losses": losses,
        "gate_ok": res["ok"], "reload_ok": res["reload_ok"],
        "ious": [round(i, 4) for i in res["ious"]],
        "top_conf": res.get("top_conf"), "ema_moved": ema_moved,
        "reload_detections": n_dets,
        "launches": win.parts["train_golden"]}
    say(f"  train_golden ({TRAIN_ARCH} {TRAIN_SIZE}, B = {TRAIN_B}, "
        f"{GOLDEN_STEPS} steps, evals every {GOLDEN_EVAL}): chunk losses "
        f"{[round(v, 4) for v in losses]}, {res['n_updates']} updates, the "
        f"EMA moved {ema_moved:.3e} from the resumed weights; gate verdict "
        f"(printed, not asserted) ok {res['ok']}, reload ok "
        f"{res['reload_ok']}, IoUs {stats['train_golden']['ious']}; the "
        f"written .pt reloaded gives the in-memory candidate's {n_dets} "
        f"detections bit for bit ({golden_s:.1f} s)")

    q = exp["quantize"]["yolov5n"]
    int8 = TRAIN_DIR / "yolov5n_int8.pt"

    def quantize_and_gate():
        scales = QG.quantize_checkpoint(
            str(CW.CARD_WEIGHTS / q["file"]), str(int8), q["arch"],
            q["size"], str(TRAIN_DIR / "quantize"), n_calib=q["n_calib"],
            batch=q["batch"], seed=q["seed"], device=TRAIN_DEVICE,
            log=lambda s: None)
        entry = exp["nets"]["yolov5n-int8"]
        eng = FaceEngine(EngineConfig(
            detector=q["arch"], det_thres=0.5, detector_overrides={
                "input_size": (q["size"], q["size"]),
                "quantized": "static"}), device=TRAIN_DEVICE)
        eng.load_weights(str(int8))
        with torch.inference_mode():
            gate = CW.run_gate(eng, pos, neg, entry["gate"],
                               np.asarray(exp["golden_boxes"], np.float32))
        return scales, gate, CW.gate_failures(gate, entry["gate"])

    t = time.time()
    scales, gate, bad = win.run("quantize_golden", quantize_and_gate)
    diffs = CW.scale_differences(scales, q)
    stats["quantize_golden"] = {
        "s": time.time() - t, "n_scales": len(scales), **diffs,
        "gate_ok": gate["ok"], "ious": [round(i, 4) for i in gate["ious"]],
        "launches": win.parts["quantize_golden"]}
    say(f"  quantize_golden on the card: {len(scales)} activation scales, "
        f"largest relative difference {diffs['jax_cpu']:.3e} from the JAX "
        f"CPU calibration (tolerance {CW.JAX_SCALE_RTOL}) and "
        f"{diffs['committed']:.4f} from {q['int8_file']} (tolerance "
        f"{CW.COMMITTED_SCALE_RTOL}); int8 gate ok {gate['ok']}, "
        f"{gate['n_pos']} faces at IoU {stats['quantize_golden']['ious']}, "
        f"{gate['n_neg']} on the negative image")
    if bad:
        raise AssertionError(f"int8 gate: {bad}")

    stats["families"] = family_steps_card_vs_cpu()
    tm = stats["timing"]
    say(f"  {card}: yolov5s {TRAIN_SIZE}x{TRAIN_SIZE} B = {TRAIN_B} train "
        f"step {tm['step_ms']:.2f} ms between events = "
        f"{tm['steps_per_s']:.2f} steps/s; device "
        f"{tm['device_ms_per_step']:.2f} ms a step from the profiler "
        f"({tm['device_ops_per_step']:.0f} device operations a step); the "
        f"device idle "
        f"{100 * tm['idle_share']:.1f} % of a traced {TIMED_STEPS}-step "
        f"chunk ({tm['chunk_busy_ms']:.1f} busy of {tm['chunk_wall_ms']:.1f}"
        f" ms), {100 * tm['idle_share_untraced']:.1f} % of an untraced step")
    stats["s"] = time.time() - t_phase
    stats["windows"] = win.parts
    say(f"  training phase: {stats['s']:.1f} s")
    return win.total(), stats


REC_DIR = WORK_DIR / "recognition"
REC_DEVICE = "cuda"
ARC_B, ARC_IDS, ARC_S, ARC_CENTER = 48, 3, 16.0, 0.02
ARC_TIMED_STEPS = 5
# the card-against-CPU step runs on the batch's first STEP_B examples (all
# 16 took ~11 s of the CPU on the card's host)
STEP_B = 4
EMBED_STEPS, EMBED_PER_ID = 25, 96
AG_STEPS, AG_EVAL, AG_BUFFER, AG_B = 60, 20, 256, 64
MTCNN_IMAGES, MTCNN_CROPS, MTCNN_B, MTCNN_STEPS = 12, 512, 64, 20
GRAPH_STEPS, GRAPH_B = 3, 4
# card against CPU, one ArcFace step of MobileFaceNet (112 px, 512-d) from
# the same weights and batch, f32 with TF32 off: the loss, and each
# parameter's, BN statistic's and SGD momentum buffer's largest difference
# over the tensor's largest value (at least 0.01). At flax's init the
# MobileFaceNet gradient moves by percents of its largest value under 1e-5
# relative changes of an activation: on the CPU the f32 step against the
# same step in f64 parts by 4.2e-4 in a parameter (conv1.bn.bias, the
# 0.01 floor) and 2.7e-2 in a momentum buffer (the gradient after one
# step), and the card's convolutions differ from the CPU's by more than
# f32 rounding; hence 2e-3 and 0.1
ARC_LOSS_RTOL, ARC_TENSOR_RTOL, ARC_MOMENTUM_RTOL = 1e-4, 2e-3, 0.1
# the same step in f64 on both sides (MobileFaceNet at B = 6: the CPU's
# f64 depthwise convolutions are slow; and the FaceNet slot, 160 px, 128-d,
# B = 15, whose JAX step the CPU tests do not compile): the nets still
# round their embeddings to f32, as JAX's do, so an element a rounding
# apart moves a gradient by ~1e-7 of its scale (3.7e-7 measured on the
# H100); 1e-5
ARC_F64_RTOL = 1e-5
MOBILE_F64_B, FACENET_B = 6, 15
GRAPH_LOSS_RTOL = 1e-3      # res10-ssd and ov-0204, three steps


# the path's kernel wrappers, spied where the path calls them, by their
# launch counters' names
REC_COUNTS = {"nms_fixpoint": "nms_fixpoint",
              "candidate_decode": "rows_gather",
              "crop_resize": "crop_resize", "topk_gallery": "topk_gallery",
              "blaze_decode_blend": "blaze_decode_blend"}


def spied_part(win, part, fn, kernels):
    """``win.run(part, fn)`` with spies on the B1 / B2 / B3 / B4 / fused B5
    wrappers where the path calls them (outside inference mode: a part may
    train).
    Each of ``kernels`` must have launched in the part, and every launch
    must be a spied call; after the window each call is replayed against
    its plain version bit for bit (those launches are not the path's).
    Returns (fn's result, {kernel: calls replayed})."""
    from face_detection_and_recognition_tpu_torch.models import (
        blazeface, yolov5_face)
    from face_detection_and_recognition_tpu_torch.ops import crop as crop_ops
    from face_detection_and_recognition_tpu_torch.ops import nms as nms_ops
    from face_detection_and_recognition_tpu_torch.pipelines import \
        similarity

    with spied_calls([(yolov5_face, "nms_fixpoint"),
                      (yolov5_face, "candidate_decode")]) as yolo, \
            spied_calls([(nms_ops, "nms_fixpoint"),
                         (crop_ops, "crop_resize"),
                         (similarity, "topk_gallery"),
                         (blazeface, "blaze_decode_blend")]) as rest:
        out = win.run(part, fn)
    calls = {"nms_fixpoint": yolo["nms_fixpoint"] + rest["nms_fixpoint"],
             "candidate_decode": yolo["candidate_decode"],
             "crop_resize": rest["crop_resize"],
             "topk_gallery": rest["topk_gallery"],
             "blaze_decode_blend": rest["blaze_decode_blend"]}
    replayed = {}
    for name in kernels:
        launches, seen = win.parts[part][REC_COUNTS[name]], calls[name]
        if launches <= 0 or len(seen) < launches:
            raise AssertionError(f"{name} in {part}: {launches} launches, "
                                 f"{len(seen)} spied calls")
        check_on_path(f"{name} in {part}", getattr(ck, name),
                      getattr(ck, f"{name}_plain"), seen)
        replayed[name] = len(seen)
    return out, replayed


def arcface_batch(embedder="mobile_facenet", n=ARC_B):
    """The golden-embed recipe's first batch for ``embedder``: ``n`` crops
    of the three golden identities at its size (the trainer's crop sets,
    seed 1, aug 1.6), normalized as the slot normalizes them."""
    from face_detection_and_recognition_tpu_torch.models.embedders import (
        get_embedder, preprocess_crops)
    from face_detection_and_recognition_tpu_torch.train import \
        golden_embed as GE

    spec = get_embedder(embedder)
    sets = GE.make_identity_crops(SEED + 1, n // ARC_IDS,
                                  size=spec.input_size[0], aug_scale=1.6)
    x = torch.from_numpy(np.concatenate([np.stack(c) for c in sets]))
    y = torch.from_numpy(np.repeat(np.arange(ARC_IDS), n // ARC_IDS))
    return preprocess_crops(spec, x.float()), y


def arcface_steps(x, y, embedder="mobile_facenet", dim=512,
                  dtype=torch.float32):
    """One ArcFace step (three identities, s = 16, center gain 0.02) of
    ``embedder`` on the card and on the CPU from the same weights and
    batch, in ``dtype``. Returns ({device: state}, gaps): the loss's
    relative difference, and (largest difference over max(the tensor's
    largest value, 0.01), its name) of the parameters, the BN statistics
    and the SGD momentum buffers."""
    from face_detection_and_recognition_tpu_torch.train import arcface as A

    cfg = A.ArcFaceTrainConfig(num_classes=ARC_IDS, embedding_size=dim,
                               s=ARC_S, lr=0.01, center_gain=ARC_CENTER,
                               embedder=embedder)
    states, losses = {}, {}
    for dev in (REC_DEVICE, "cpu"):
        st = A.create_train_state(cfg, torch.Generator().manual_seed(SEED),
                                  device=dev)
        if dtype == torch.float64:
            st["net"].double()
            for mod in st["net"].modules():
                if hasattr(mod, "compute_dtype"):
                    mod.compute_dtype = dtype
            st["arcface_kernel"].data = st["arcface_kernel"].data.double()
        t = time.time()
        losses[dev] = float(A.make_train_step(st)(
            x.to(st["device"], dtype), y.to(st["device"])))
        say(f"  one {embedder} ArcFace step in {dtype} on {st['device']}: "
            f"loss {losses[dev]:.9f} ({time.time() - t:.1f} s)")
        states[dev] = st

    def tensors(st):
        net = st["net"]
        params, stats = split_state(net)
        params["arcface_kernel"] = st["arcface_kernel"].detach().cpu()
        named = dict(net.named_parameters(), arcface_kernel=st[
            "arcface_kernel"])
        mom = {k: st["opt"].state[p]["momentum_buffer"].detach().cpu()
               for k, p in named.items() if p in st["opt"].state}
        return params, stats, mom

    (cp, cs, cm), (rp, rs, rm) = tensors(states[REC_DEVICE]), \
        tensors(states["cpu"])
    return states, {"loss_rel": abs(losses[REC_DEVICE] - losses["cpu"])
                    / abs(losses["cpu"]), "params": tensor_gap(cp, rp),
                    "bn_stats": tensor_gap(cs, rs),
                    "momentum": tensor_gap(cm, rm), "n_momentum": len(rm)}


def arcface_step_card_vs_cpu(x, y):
    """The MobileFaceNet ArcFace step (512-d, 112 px, B = 48) card against
    CPU in f32 (the precision it trains in), the same net at B = 6 in f64,
    and the FaceNet slot's step (128-d, 160 px, B = 15) in f64. Returns (the card's f32
    MobileFaceNet state, numbers); raises when a difference exceeds its
    tolerance."""
    states, out = arcface_steps(x, y)
    say(f"  card against CPU, f32: loss relative difference "
        f"{out['loss_rel']:.3e} (tolerance {ARC_LOSS_RTOL}); largest "
        f"relative difference (over the tensor's largest value, at least "
        f"0.01; tolerance {ARC_TENSOR_RTOL}): parameters "
        f"{out['params'][0]:.3e} ({out['params'][1]}), BN statistics "
        f"{out['bn_stats'][0]:.3e} ({out['bn_stats'][1]}); momentum "
        f"buffers {out['momentum'][0]:.3e} ({out['momentum'][1]}) over "
        f"{out['n_momentum']} tensors (same measure, tolerance "
        f"{ARC_MOMENTUM_RTOL})")
    if out["loss_rel"] > ARC_LOSS_RTOL or max(
            out["params"][0], out["bn_stats"][0]) > ARC_TENSOR_RTOL \
            or out["momentum"][0] > ARC_MOMENTUM_RTOL:
        raise AssertionError(f"ArcFace step: card against CPU {out}")
    f64 = {"mobile_facenet": arcface_steps(
        *arcface_batch(n=MOBILE_F64_B), dtype=torch.float64)[1],
        "facenet": arcface_steps(*arcface_batch("facenet", FACENET_B),
                                 "facenet", 128, torch.float64)[1]}
    for name, g in f64.items():
        worst = max(g["loss_rel"], g["params"][0], g["bn_stats"][0],
                    g["momentum"][0])
        say(f"  card against CPU, f64, {name}: loss {g['loss_rel']:.3e}, "
            f"parameters {g['params'][0]:.3e}, BN statistics "
            f"{g['bn_stats'][0]:.3e}, momentum {g['momentum'][0]:.3e} "
            f"({g['momentum'][1]}) (tolerance {ARC_F64_RTOL})")
        if worst > ARC_F64_RTOL:
            raise AssertionError(f"{name} f64 ArcFace step: card against "
                                 f"CPU {g}")
    out["f64"] = f64
    return states[REC_DEVICE], out


def time_arcface(state, x, y):
    """The card's figures of the B = 48 MobileFaceNet step: ms a step
    between CUDA events over ``ARC_TIMED_STEPS`` steps, steps/s, device ms
    and operations a step (profiler), and the device's idle share over a
    traced chunk of steps."""
    from torch.profiler import record_function

    from face_detection_and_recognition_tpu_torch.train import arcface as A
    from face_detection_and_recognition_tpu_torch.utils import \
        trace_analysis as TA
    from face_detection_and_recognition_tpu_torch.utils.profiling import \
        device_trace

    dev = state["device"]
    x, y = x.to(dev), y.to(dev)
    step = A.make_train_step(state)

    def chunk():
        for _ in range(ARC_TIMED_STEPS):
            loss = step(x, y)
        return loss

    step_ms = cuda_ms(chunk, iters=1) / ARC_TIMED_STEPS
    dev_ms, dev_ops = device_ms(lambda: step(x, y), iters=3)
    trace_dir = REC_DIR / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with device_trace(str(trace_dir), with_stack=False):
        with record_function("chunk"):
            loss = chunk()
            torch.cuda.synchronize()
    busy_ms, wall_ms, idle = TA.idle_share(str(trace_dir), "chunk")
    out = {"step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
           "device_ms_per_step": dev_ms, "device_ops_per_step": dev_ops,
           "chunk_wall_ms": wall_ms, "chunk_busy_ms": busy_ms,
           "idle_share": idle, "chunk_loss": float(loss),
           "idle_share_untraced": 1.0 - dev_ms / step_ms}
    if not math.isfinite(out["chunk_loss"]):
        raise AssertionError(f"ArcFace timing: {out}")
    return out


def golden_embed_part(card):
    """``train_golden_embedder`` (MobileFaceNet, its recipe, 25 steps),
    the ``.pt`` reloaded into a fresh engine against the in-memory net's
    embeddings bit for bit. The gate's verdict is printed, not
    asserted."""
    from face_detection_and_recognition_tpu_torch.train import \
        golden_embed as GE

    lines = []
    t = time.time()
    r = GE.train_golden_embedder(
        str(REC_DIR / "golden_embed.pt"), batch_size=ARC_B,
        max_steps=EMBED_STEPS, eval_every=EMBED_STEPS,
        n_train_per_id=EMBED_PER_ID, seed=SEED, device=REC_DEVICE,
        log=lines.append)
    sec = time.time() - t
    for line in lines:
        say(f"  {line}")
    crops = np.stack(GE.make_identity_crops(SEED + 9, 16)[0])
    a, b = r["engine"].embed_crops(crops), r["embed"](crops)
    if not np.array_equal(a, b):
        raise AssertionError("golden_embed: the reloaded .pt's embeddings "
                             "differ from the in-memory net's")
    if not all(math.isfinite(v) for v in r["losses"]):
        raise AssertionError(f"golden_embed losses {r['losses']}")
    return r, {"s": sec, "steps": r["steps"], "losses": r["losses"],
               "gate_ok": r["ok"], "reload_ok": r["reload_ok"],
               "same_acc": r["same_acc"], "cross_acc": r["cross_acc"],
               "margin": r["margin"], "reload_bit_equal": True}


def retrieval_part(engine):
    """``evaluate_retrieval`` of the reloaded engine over the 16-identity
    population, the search through B4 (``use_pallas=True``) and the plain
    one: the same rank-1 lists."""
    from face_detection_and_recognition_tpu_torch.train import \
        golden_embed as GE

    out = {}
    for pallas in (True, False):
        t = time.time()
        out[pallas] = GE.evaluate_retrieval(engine.embed_crops,
                                            use_pallas=pallas,
                                            device=REC_DEVICE)
        out[pallas]["s"] = time.time() - t
    if not np.array_equal(out[True]["top1"], out[False]["top1"]):
        raise AssertionError("evaluate_retrieval: B4's rank-1 list differs "
                             "from the plain search's")
    r = out[True]
    return {"rank1": r["rank1"], "same_acc": r["same_acc"],
            "cross_acc": r["cross_acc"], "margin_min": r["margin_min"],
            "ok": r["ok"], "n_probes": int(len(r["top1"])),
            "s_b4": out[True]["s"], "s_plain": out[False]["s"],
            "same_rank1_lists": True}


def golden_ag_part():
    """``train_golden_ag`` from ``card_weights/yolov5n.pt`` for a few
    chunks; the reloaded heads' probabilities on the golden faces against
    the in-memory heads' bit for bit."""
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW
    from face_detection_and_recognition_tpu_torch.train import \
        golden_ag as AG

    lines = []
    t = time.time()
    r = AG.train_golden_ag(str(REC_DIR / "golden_ag.pt"),
                           str(CW.CARD_WEIGHTS / "yolov5n.pt"),
                           n_buffer=AG_BUFFER, batch_size=AG_B,
                           max_steps=AG_STEPS, eval_every=AG_EVAL, seed=SEED,
                           device=REC_DEVICE, log=lines.append)
    sec = time.time() - t
    for line in lines:
        say(f"  {line}")
    crops = AG.build_ag_buffer(8, seed=SEED + 5)[0]
    a = r["engine"].classify_crops_age_gender(crops)
    b = r["reload_engine"].classify_crops_age_gender(crops)
    if not all(np.array_equal(u, v) for u, v in zip(a, b)):
        raise AssertionError("golden_ag: the reloaded .pt classifies "
                             "otherwise than the in-memory heads")
    if not all(math.isfinite(v) for v in r["losses"]):
        raise AssertionError(f"golden_ag losses {r['losses']}")
    return {"s": sec, "steps": r["steps"], "losses": r["losses"],
            "gate_ok": r["ok"], "reload_ok": r["reload_ok"],
            "labels": r["labels"], "reload_bit_equal": True}


def golden_mtcnn_part(frames):
    """``train_golden_mtcnn`` at a few steps a stage on a small composite
    set, one bootstrap round; the reloaded cascade against the in-memory
    one bit for bit: its tensors, each stage's outputs on seeded crops, and
    the raw detections of the golden image and of 2 frames."""
    from face_detection_and_recognition_tpu_torch.train import golden as G
    from face_detection_and_recognition_tpu_torch.train import \
        golden_mtcnn as GM

    lines = []
    t = time.time()
    r = GM.train_golden_mtcnn(
        str(REC_DIR / "golden_mtcnn.pt"), str(REC_DIR / "mtcnn_work"),
        n_images=MTCNN_IMAGES, n_crops=MTCNN_CROPS, batch_size=MTCNN_B,
        max_steps=MTCNN_STEPS, eval_every=MTCNN_STEPS // 2, seed=SEED,
        device=REC_DEVICE, bootstrap_rounds=1, log=lines.append)
    sec = time.time() - t
    for line in lines:
        say(f"  {line}")
    n = 0
    for img in [G.imread(G.GOLDEN_IMG)] + list(frames[:2]):
        a = r["engine"].detect_raw(img)
        b = r["reload_engine"].detect_raw(img)
        if not np.array_equal(a, b):
            raise AssertionError("golden_mtcnn: the reloaded .pt detects "
                                 "otherwise than the in-memory cascade")
        n += len(a)
    # the cascade may detect nothing after a few steps: the weights, and
    # each stage's outputs on seeded crops, are compared too, never empty
    mem, disk = r["engine"].net, r["reload_engine"].net
    sa, sb = mem.state_dict(), disk.state_dict()
    if not sa or sa.keys() != sb.keys() or not all(
            same_bits(sa[k], sb[k]) for k in sa):
        raise AssertionError("golden_mtcnn: the reloaded .pt's tensors "
                             "differ from the in-memory cascade's")
    gen, rows = torch.Generator().manual_seed(SEED + 7), 0
    with torch.inference_mode():
        for name, size in GM.STAGE_SIZES.items():
            x = (torch.rand((MTCNN_B, 3, size, size), generator=gen) * 2
                 - 1).to(REC_DEVICE)
            outs = getattr(mem, name)(x), getattr(disk, name)(x)
            if not all(same_bits(u, v) for u, v in zip(*outs)):
                raise AssertionError(f"golden_mtcnn: the reloaded {name} "
                                     "answers otherwise than the in-memory "
                                     "one")
            rows += len(outs[0][0])
    if rows <= 0:
        raise AssertionError("golden_mtcnn: no stage rows compared")
    losses = {k: v for k, v in r["losses"].items()}
    if not all(math.isfinite(x) for v in losses.values() for x in v):
        raise AssertionError(f"golden_mtcnn losses {losses}")
    return {"s": sec, "losses": losses, "gate_ok": r["ok"],
            "reload_ok": r["reload_ok"], "n_pos": r["n_pos"],
            "n_neg": r["n_neg"], "reload_raw_rows": n,
            "reload_tensors": len(sa), "reload_stage_rows": rows,
            "reload_bit_equal": True}


def graph_batches(size):
    rng = np.random.RandomState(SEED)
    out = []
    for _ in range(GRAPH_STEPS):
        x = rng.randint(0, 255, (GRAPH_B, size, size, 3)).astype(np.uint8)
        t = np.zeros((GRAPH_B, 4, 14), np.float32)
        t[..., 4:] = -1.0
        t[:, 0, :4] = rng.uniform(0.3, 0.7, (GRAPH_B, 4)) * [
            size, size, 0.5 * size, 0.5 * size]
        out.append((x, t, t[..., 2] > 0))
    return out


def graph_steps_part(frames):
    """Three steps of the res10-ssd and ov-0204 trainers on the card and
    on the CPU from the same weights (the CPU state's LSUV'd / seeded init
    poured into the card's) and seeded batches, each loss against the
    CPU's; then the card's trained weights exported (``.caffemodel``,
    ``.xml`` + ``.bin``), reloaded by ``FaceEngine.load_weights`` and held
    to an engine with the same weights in memory, bit for bit, on the 8
    frames."""
    from face_detection_and_recognition_tpu_torch.models.ov_topologies \
        import export_trained_ir
    from face_detection_and_recognition_tpu_torch.train import \
        caffe_golden as CG
    from face_detection_and_recognition_tpu_torch.train import \
        ov_golden as OG
    from face_detection_and_recognition_tpu_torch.train.detection import \
        load_train_weights

    out = {}
    for name, cfg, create, make, ext in (
            ("res10-ssd", CG.CaffeGoldenConfig(max_targets=4),
             CG.create_res10_train_state, CG.make_res10_train_step_ema,
             ".caffemodel"),
            ("ov-0204", OG.OVGoldenConfig(max_targets=4),
             OG.create_ov_train_state, OG.make_ov_train_step_ema, ".xml")):
        size = cfg.input_size[0]
        batches = graph_batches(size)
        cpu = create(cfg, torch.Generator().manual_seed(SEED), "cpu")
        dev = create(cfg, torch.Generator().manual_seed(SEED), REC_DEVICE)
        init = {k: v.clone() for k, v in cpu["net"].state_dict().items()}
        load_train_weights(dev, init)
        losses = {}
        for tag, st in (("card", dev), ("cpu", cpu)):
            step = make(st)
            losses[tag] = [float(step(*(torch.from_numpy(a).to(
                st["device"]) for a in b))[0]) for b in batches]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                   losses["cpu"])]
        if max(rel) > GRAPH_LOSS_RTOL or not all(
                math.isfinite(v) for v in losses["card"]):
            raise AssertionError(f"{name} steps: card against CPU {losses}")
        frozen = 0
        if name == "res10-ssd":
            for s in dev["net"].steps:
                if s.op == "batchnorm":
                    for i, b in enumerate(dev["net"].layer_blobs(s.name)):
                        k = f"blobs.{s.name}.{i}"
                        if not torch.equal(b.detach().cpu(), init[k]):
                            raise AssertionError(f"{k} moved")
                        frozen += 1
        sd = {k: v.detach().cpu() for k, v in dev["net"].state_dict().items()}
        path = str(REC_DIR / f"{name}{ext}")
        if name == "res10-ssd":
            CG.export_trained_caffemodel(sd, path)
        else:
            export_trained_ir(name, sd, path)
        ecfg = EngineConfig(detector=name, det_thres=0.05)
        mem = FaceEngine(ecfg, device=REC_DEVICE)
        mem.load_state_dict(sd)
        disk = FaceEngine(ecfg, device=REC_DEVICE)
        disk.load_weights(path)
        a, b = mem.detect_batch(frames), disk.detect_batch(frames)
        for field in ("boxes", "scores", "valid"):
            if not torch.equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"{name}: the exported {ext} detects "
                                     "otherwise than the in-memory net")
        say(f"  {name} at {size}x{size}, B = {GRAPH_B}: losses card "
            f"{[round(v, 6) for v in losses['card']]}, CPU "
            f"{[round(v, 6) for v in losses['cpu']]}, relative differences "
            f"{[f'{r:.2e}' for r in rel]} (tolerance {GRAPH_LOSS_RTOL})"
            + (f"; {frozen} BN statistic blobs unmoved" if frozen else "")
            + f"; the exported {ext} reloaded gives the in-memory net's "
            f"{int(a.valid.sum())} detections of the 8 frames bit for bit")
        out[name] = {"card": losses["card"], "cpu": losses["cpu"],
                     "rel": rel, "frozen_bn_blobs": frozen,
                     "reload_detections": int(a.valid.sum())}
    return out


def run_recognition_training(frames, card):
    """The recognition-training main path: the ArcFace step card against
    CPU and its figures, ``train_golden_embedder`` with its reload and the
    retrieval through B4 and the plain search, ``train_golden_ag``,
    ``train_golden_mtcnn``, and three res10-ssd and ov-0204 steps with
    their exports. Each trainer is a part of the path. Returns
    (launches, numbers)."""
    t_phase = time.time()
    shutil.rmtree(REC_DIR, ignore_errors=True)
    REC_DIR.mkdir(parents=True)
    win, stats = Windows(), {}
    x, y = arcface_batch()
    state, stats["arcface_step"] = win.run(
        "arcface_step", lambda: arcface_step_card_vs_cpu(x, y))
    stats["arcface_timing"] = time_arcface(state, x, y)
    del state
    torch.cuda.empty_cache()
    res, stats["golden_embed"] = win.run("golden_embed",
                                         lambda: golden_embed_part(card))
    stats["retrieval"], replayed = spied_part(
        win, "retrieval", lambda: retrieval_part(res["engine"]),
        ("topk_gallery",))
    stats["replayed"] = {"retrieval": replayed}
    say(f"  retrieval over 16 identities through the reloaded engine: "
        f"rank-1 {stats['retrieval']['rank1']:.3f}, same "
        f"{stats['retrieval']['same_acc']:.3f}, cross "
        f"{stats['retrieval']['cross_acc']:.3f}, verdict (printed, not "
        f"asserted) {stats['retrieval']['ok']}; B4's and the plain "
        f"search's rank-1 lists of {stats['retrieval']['n_probes']} probes "
        f"equal")
    del res
    # each part's own kernels: B1 / B2 / B3 in the age/gender cascade's
    # gates, B1 / B3 in MTCNN's, B1 in the graph nets' reloads
    for part, fn, kernels in (
            ("golden_ag", golden_ag_part,
             ("nms_fixpoint", "candidate_decode", "crop_resize")),
            ("golden_mtcnn", lambda: golden_mtcnn_part(frames),
             ("nms_fixpoint", "crop_resize")),
            ("graph_steps", lambda: graph_steps_part(frames),
             ("nms_fixpoint",))):
        stats[part], stats["replayed"][part] = spied_part(win, part, fn,
                                                          kernels)
    ge, ag, mt = (stats["golden_embed"], stats["golden_ag"],
                  stats["golden_mtcnn"])
    say(f"  train_golden_embedder: {ge['steps']} steps, losses "
        f"{[round(v, 4) for v in ge['losses']]}, gate (printed, not "
        f"asserted) ok {ge['gate_ok']} same {ge['same_acc']:.2f} cross "
        f"{ge['cross_acc']:.2f} margin {ge['margin']:.3f}, reload ok "
        f"{ge['reload_ok']}; the .pt reloaded gives the in-memory net's "
        f"embeddings bit for bit ({ge['s']:.1f} s)")
    say(f"  train_golden_ag: {ag['steps']} steps, chunk losses "
        f"{[round(v, 4) for v in ag['losses']]}, gate ok {ag['gate_ok']}, "
        f"reload ok {ag['reload_ok']}, labels {ag['labels']}; the .pt "
        f"reloaded classifies bit for bit ({ag['s']:.1f} s)")
    say(f"  train_golden_mtcnn: gate ok {mt['gate_ok']} (pos {mt['n_pos']}"
        f", neg {mt['n_neg']}), reload ok {mt['reload_ok']}; the .pt "
        f"reloaded: {mt['reload_tensors']} tensors, the P/R/O-Net outputs "
        f"on {mt['reload_stage_rows']} seeded crops and "
        f"{mt['reload_raw_rows']} raw detection rows of 3 images bit for "
        f"bit ({mt['s']:.1f} s)")
    tm = stats["arcface_timing"]
    say(f"  {card}: MobileFaceNet 112x112 512-d B = {ARC_B} ArcFace step "
        f"{tm['step_ms']:.2f} ms between events = {tm['steps_per_s']:.2f} "
        f"steps/s; device {tm['device_ms_per_step']:.2f} ms a step from "
        f"the profiler ({tm['device_ops_per_step']} device operations a "
        f"step); the device idle {100 * tm['idle_share']:.1f} % of a traced "
        f"{ARC_TIMED_STEPS}-step chunk ({tm['chunk_busy_ms']:.1f} busy of "
        f"{tm['chunk_wall_ms']:.1f} ms), "
        f"{100 * tm['idle_share_untraced']:.1f} % of an untraced step")
    stats["s"] = time.time() - t_phase
    stats["windows"] = win.parts
    say(f"  recognition training phase: {stats['s']:.1f} s")
    return win.total(), stats


# the multi-device phase: single-process meshes over the card (its entries
# repeat it on a one-card host, and are dealt over the cards on a larger
# one), and mp_demo as one NCCL rank
MD_DEVICE = "cuda"           # where the unsharded calls run
MD_SHARDS = 2                # entries on "data" (and on "model")
MD_ITERS = 3                 # calls each path is timed over
MD_CLASSES = 4               # the DP + TP step's classes (3 identities),
#                              split over 2 "model" entries
MD_DIR = WORK_DIR / "multi_device"
# mp_demo's rank against the same job in this process: cuDNN's backward
# convolutions may sum in another order from one process to the next, so
# the trained loss and kernel sum are held within 1e-4 relative; the
# ensemble's summaries are inference and must be equal
MD_MP_RTOL = 1e-4
# the sharded call against the unsharded call on the whole batch: cuDNN
# picks a convolution's algorithm by its batch size, so the sums of a piece
# need not be those of the whole batch, and a box may move by a pixel. The
# valid masks must be equal; on the rows valid in both, each field's
# largest absolute difference is bounded here (boxes and landmarks in
# pixels); on the rows whose boxes are equal bit for bit, the crops must be
# equal and the embeddings and age / gender probabilities are bounded.
# Read on an H100 at B = 8 against B = 4 pieces: boxes and landmarks 1 px,
# scores 0, areas 1.7e-4, crops 0, embeddings 1.0e-7, age 4.2e-5, gender
# 1.6e-10; each bound is the pixel, or about ten times the reading.
MD_WHOLE_TOL = {"boxes": 1.0, "lmarks": 1.0, "scores": 1e-5, "areas": 1e-3,
                "crops": 0.0, "embeddings": 1e-5, "age_probs": 5e-4,
                "gender_probs": 1e-6}


def md_mesh(axes, shape):
    """A single-process mesh of ``shape`` whose entries are dealt over the
    cards in turn (on one card, that card repeated)."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    n = torch.cuda.device_count()
    return make_mesh(axes, shape, [torch.device("cuda", i % n)
                                   for i in range(int(np.prod(shape)))])


def md_leaves(tree):
    from face_detection_and_recognition_tpu_torch.parallel.collectives \
        import tree_map

    out = []
    tree_map(out.append, tree)
    return out


def md_cat(trees):
    """Results of the pieces of a batch joined along dim 0, field by
    field."""
    from face_detection_and_recognition_tpu_torch.parallel.collectives \
        import tree_map

    joined = iter([torch.cat(parts) for parts in
                   zip(*[md_leaves(t) for t in trees])])
    return tree_map(lambda _: next(joined), trees[0])


class ScaleTape:
    """A ``models.layers.global_batch`` reduction in one process: records
    each quantized layer's absmax on a whole batch, or hands the recorded
    ones, in order, to a run on a piece of it (the piece quantized with
    the whole batch's scales, as each shard of the sharded call is)."""

    def __init__(self, replay=None):
        self.maxes = list(replay or [])
        self.replay = replay is not None

    def __call__(self, t, op):
        if self.replay:
            return self.maxes.pop(0)
        self.maxes.append(t)
        return t


def md_gap(a, b):
    """The largest absolute difference of two tensors (0 when empty)."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def md_hold(label, got, pieces, whole):
    """The sharded result against the unsharded call on each piece of the
    batch (``pieces``, joined): every tensor bit for bit, or the run
    fails. Against the unsharded call on the whole batch (``whole``):
    within ``MD_WHOLE_TOL``, or the run fails. Returns (tensors, tensors
    not bit for bit against the whole batch's, the readings against it)."""
    a, p, w = md_leaves(got), md_leaves(pieces), md_leaves(whole)
    if not a or len(a) != len(p) or len(a) != len(w):
        raise AssertionError(f"{label}: {len(a)} tensors against "
                             f"{len(p)} / {len(w)}")
    for i, (x, y) in enumerate(zip(a, p)):
        if not same_bits(x, y):
            gap = md_gap(x, y) if x.shape == y.shape else float("nan")
            raise AssertionError(f"{label}: tensor {i} of {len(a)} "
                                 f"{tuple(x.shape)} differs from the "
                                 f"unsharded call on its piece (largest "
                                 f"difference {gap:.3e})")
    n_off = sum(not same_bits(x, y) for x, y in zip(a, w))
    det_got = got.det if hasattr(got, "det") else got
    det_whole = whole.det if hasattr(whole, "det") else whole
    valid = det_got.valid & det_whole.valid
    read = {"valid_rows": int(valid.sum()),
            "valid_rows_differ": int((det_got.valid
                                      != det_whole.valid).sum())}
    for f in ("boxes", "lmarks", "scores", "areas"):
        read[f] = md_gap(getattr(det_got, f)[valid],
                         getattr(det_whole, f)[valid])
    if hasattr(got, "det"):
        same = valid & (det_got.boxes == det_whole.boxes).all(-1)
        read["rows_same_box"] = int(same.sum())
        for f in ("crops", "embeddings", "age_probs", "gender_probs"):
            x, y = getattr(got, f), getattr(whole, f)
            if x is not None:
                read[f] = md_gap(x[same], y[same])
    over = {k: v for k, v in read.items()
            if k in MD_WHOLE_TOL and v > MD_WHOLE_TOL[k]}
    if read["valid_rows_differ"] or over:
        raise AssertionError(f"{label}: against the unsharded call on the "
                             f"whole batch {read}, past {MD_WHOLE_TOL}")
    return len(a), n_off, read


def md_arcface(win, stats, card):
    """The MobileFaceNet B = 48 ArcFace step, DP + TP on a 2 x 2 mesh of
    the card, against the unsharded step on the card from the same init
    and batch, within the recognition-training phase's tolerances (card
    against CPU): the loss, the parameters and BN statistics of the first
    replica, the class kernel and the momentum buffers, the kernel's
    joined from its shards."""
    from face_detection_and_recognition_tpu_torch.train import arcface as A

    x, y = arcface_batch()
    x, y = x.to(MD_DEVICE), y.to(MD_DEVICE)
    cfg = A.ArcFaceTrainConfig(num_classes=MD_CLASSES, embedding_size=512,
                               s=ARC_S, lr=0.01, center_gain=ARC_CENTER)
    plain, shard = (A.create_train_state(
        cfg, torch.Generator().manual_seed(SEED), device=MD_DEVICE)
        for _ in range(2))
    mesh = md_mesh(("data", "model"), (MD_SHARDS, MD_SHARDS))
    step, replicas = A.sharded_train_step(shard, mesh)
    loss = float(win.run("arcface_step", lambda: step(x, y)))
    want = float(A.make_train_step(plain)(x, y))
    whole = A.gather_train_state(replicas, mesh)
    got_p, got_s = split_state(shard["net"])
    ref_p, ref_s = split_state(plain["net"])
    got_p["arcface_kernel"] = whole["arcface_kernel"].cpu()
    ref_p["arcface_kernel"] = plain["arcface_kernel"].detach().cpu()
    named = dict(plain["net"].named_parameters())
    shard_named = dict(shard["net"].named_parameters())
    first = replicas[mesh.local_coords()[0]]
    ref_m = {k: plain["opt"].state[p]["momentum_buffer"].cpu()
             for k, p in named.items() if p in plain["opt"].state}
    got_m = {k: first["opt"].state[shard_named[k]]["momentum_buffer"].cpu()
             for k in ref_m}
    ref_m["arcface_kernel"] = plain["opt"].state[plain[A.KERNEL]][
        "momentum_buffer"].cpu()
    got_m["arcface_kernel"] = whole["kernel_momentum"].cpu()
    out = {"loss": loss, "loss_rel": abs(loss - want) / abs(want),
           "params": tensor_gap(got_p, ref_p),
           "bn_stats": tensor_gap(got_s, ref_s),
           "momentum": tensor_gap(got_m, ref_m),
           "kernel_shard": list(first[A.KERNEL].shape)}
    say(f"  arcface DP + TP (mesh {mesh.shape}, B = {x.shape[0]}, "
        f"{MD_CLASSES} classes, the kernel shard {out['kernel_shard']}) "
        f"against the unsharded step on the card: loss {loss:.6f}, "
        f"relative difference {out['loss_rel']:.3e} (tolerance "
        f"{ARC_LOSS_RTOL}); parameters {out['params'][0]:.3e} "
        f"({out['params'][1]}), BN statistics {out['bn_stats'][0]:.3e} "
        f"({out['bn_stats'][1]}) (tolerance {ARC_TENSOR_RTOL}); momentum "
        f"{out['momentum'][0]:.3e} ({out['momentum'][1]}) (tolerance "
        f"{ARC_MOMENTUM_RTOL})")
    if out["loss_rel"] > ARC_LOSS_RTOL or max(
            out["params"][0], out["bn_stats"][0]) > ARC_TENSOR_RTOL \
            or out["momentum"][0] > ARC_MOMENTUM_RTOL:
        raise AssertionError(f"DP + TP ArcFace step: {out}")
    out["ms"] = cuda_ms(lambda: step(x, y), MD_ITERS)
    plain_step = A.make_train_step(plain)
    out["plain_ms"] = cuda_ms(lambda: plain_step(x, y), MD_ITERS)
    say(f"  arcface step: {out['ms']:.2f} ms sharded against "
        f"{out['plain_ms']:.2f} ms unsharded, between events on {card}")
    stats["arcface_step"] = out


def md_mp_demo(stats):
    """mp_demo as one rank over NCCL (world size 1), both modes at once in
    processes of their own, each result against the same job on a
    one-entry single-process mesh in this process."""
    from face_detection_and_recognition_tpu_torch.parallel import \
        mp_demo as MP

    MD_DIR.mkdir(parents=True, exist_ok=True)
    repo = Path(__file__).resolve().parent
    procs = []
    t = time.time()
    for mode in ("train", "ensemble"):
        out = MD_DIR / f"mp_demo_{mode}.json"
        out.unlink(missing_ok=True)
        procs.append((mode, out, subprocess.Popen(
            [sys.executable, "-m",
             "face_detection_and_recognition_tpu_torch.parallel.mp_demo",
             "--procs", "1", "--pid", "0", "--coordinator",
             f"127.0.0.1:{free_port()}", "--mode", mode, "--out", str(out)],
            cwd=repo, env=dict(os.environ,
                               OMP_NUM_THREADS=str(torch.get_num_threads())),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    # the same jobs in this process while the ranks run
    try:
        wants = {mode: MP.run_local(1, mode, device=MD_DEVICE)
                 for mode, _, _ in procs}
    except BaseException:
        for _, _, proc in procs:
            proc.kill()
            proc.wait()
        raise
    for mode, out, proc in procs:
        try:
            log = proc.communicate(timeout=300)[0].decode(errors="replace")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"mp_demo --mode {mode} as one rank: exit "
                                 f"{proc.returncode}\n{log[-3000:]}")
        got = json.loads(out.read_text())
        want = wants[mode]
        rtol = MD_MP_RTOL if mode == "train" else 0.0
        for key, val in want.items():
            if abs(got[key] - val) > rtol * abs(val):
                raise AssertionError(f"mp_demo {mode}: {key} {got[key]} "
                                     f"against {val} in process")
        stats[f"mp_demo_{mode}"] = got
        say(f"  mp_demo --mode {mode}, one rank over "
            f"NCCL: {json.dumps(got)};"
            f" the one-entry mesh in process: {json.dumps(want)} "
            f"(relative tolerance {rtol})")
    stats["mp_demo_s"] = time.time() - t


def run_multi_device(frames, card, det, ens, blaze_front):
    """The multi-device main path over ``md_mesh``: yolov5s detect
    (``detect_batch_sharded``), the yolov5s + MobileFaceNet + age/gender
    ensemble (``mesh=``), BlazeFace-front detect, the search
    (``topk_similar(mesh=, use_pallas=True)``, B4 a shard) and the dynamic
    int8 yolov5n detect, each on a mesh of 2 entries of the card and each
    a part of the path, held bit for bit to the unsharded call on each
    piece of the batch on the same engine (int8: each piece with the whole
    batch's scales, ``ScaleTape``) and within ``MD_WHOLE_TOL`` to the
    unsharded call on the whole batch (``md_hold``; the search bit for bit
    to the whole search); the DP + TP ArcFace step on a 2 x 2 mesh
    (``md_arcface``); ``mp_demo`` as one NCCL rank in both modes. Each
    path's ms between events, sharded and unsharded. Returns (launches,
    numbers)."""
    from face_detection_and_recognition_tpu_torch.models.layers import \
        global_batch
    from face_detection_and_recognition_tpu_torch.parallel.sharding import \
        topk_gallery_sharded
    from face_detection_and_recognition_tpu_torch.pipelines import \
        similarity as S

    t_phase = time.time()
    win, stats = Windows(), {}
    data = md_mesh(("data",), (MD_SHARDS,))
    model = md_mesh(("model",), (MD_SHARDS,))
    q8 = FaceEngine(EngineConfig(detector="yolov5n", seed=SEED,
                                 detector_overrides={"quantized": True}),
                    device=MD_DEVICE)
    kw = dict(det_thres=0.0, bbox_area_thres=0.0)
    piece_call = {
        "detect": det.detect_batch,
        "ensemble": lambda x: ens.detect_embed_classify_batch(x, **kw),
        "blazeface": blaze_front.detect_batch}
    paths = {
        "detect": (lambda: det.detect_batch_sharded(frames, data),
                   lambda: det.detect_batch(frames)),
        "ensemble": (lambda: ens.detect_embed_classify_batch(
            frames, mesh=data, **kw),
            lambda: ens.detect_embed_classify_batch(frames, **kw)),
        "blazeface": (lambda: blaze_front.detect_batch_sharded(frames, data),
                      lambda: blaze_front.detect_batch(frames)),
        "int8": (lambda: q8.detect_batch_sharded(frames, data),
                 lambda: q8.detect_batch(frames)),
    }
    half = frames.shape[0] // MD_SHARDS
    pieces = [frames[i * half:(i + 1) * half] for i in range(MD_SHARDS)]
    for part, (sharded, plain) in paths.items():
        sharded()  # the workers' first call builds their cuDNN plans
        torch.cuda.synchronize()
        got = win.run(part, sharded)
        if part == "int8":  # each piece with the whole batch's scales
            tape = ScaleTape()
            with global_batch(tape, 1):
                q8.detect_batch(frames)
            ref = []
            for piece in pieces:
                with global_batch(ScaleTape(tape.maxes[:]), 1):
                    ref.append(q8.detect_batch(piece))
        else:
            ref = [piece_call[part](piece) for piece in pieces]
        n, n_off, read = md_hold(part, got, md_cat(ref), plain())
        stats[part] = {"ms": cuda_ms(sharded, MD_ITERS),
                       "plain_ms": cuda_ms(plain, MD_ITERS), "tensors": n,
                       "whole_batch_not_bitwise": n_off,
                       "whole_batch": read}
        say(f"  {part}: {B} x {frames.shape[1]}x{frames.shape[2]} frames "
            f"over {data.shape} ({', '.join(map(str, data.devices.flat))}),"
            f" {n} tensors equal bit for bit to the unsharded call on each "
            f"piece; against the call on the whole batch {n - n_off} of {n}"
            f" bit for bit, the largest differences {json.dumps(read)} "
            f"within {json.dumps(MD_WHOLE_TOL)}; {stats[part]['ms']:.2f} ms"
            f" sharded against {stats[part]['plain_ms']:.2f} ms unsharded, "
            f"between events on {card}")

    rng = np.random.default_rng(SEED + 5)
    queries = rng.standard_normal((TOPK_N, TOPK_D), dtype=np.float32)
    gallery = rng.standard_normal((TOPK_M, TOPK_D), dtype=np.float32)
    S.topk_similar(queries[:8], gallery[:4096], k=TOPK_K, use_pallas=True,
                   mesh=model)
    got = win.run("search", lambda: S.topk_similar(
        queries, gallery, k=TOPK_K, use_pallas=True, mesh=model))
    want = S.topk_similar(queries, gallery, k=TOPK_K, use_pallas=True,
                          device=MD_DEVICE)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("search: the sharded top-k differs from the "
                             "unsharded B4 search")
    qt = torch.as_tensor(S.normalize_rows(queries), device=MD_DEVICE)
    gt = torch.as_tensor(S.normalize_rows(gallery), device=MD_DEVICE)
    del gallery
    stats["search"] = {
        "ms": cuda_ms(lambda: topk_gallery_sharded(
            qt, gt, model, k=TOPK_K, use_pallas=True), MD_ITERS),
        "plain_ms": cuda_ms(lambda: ck.topk_gallery(qt, gt, TOPK_K),
                            MD_ITERS)}
    say(f"  search: {TOPK_N} queries x {TOPK_M} x {TOPK_D}, k = {TOPK_K}, "
        f"the gallery over {model.shape}, B4 a shard: scores and indices "
        f"equal to the unsharded B4 search bit for bit; on the card's "
        f"memory {stats['search']['ms']:.2f} ms sharded against "
        f"{stats['search']['plain_ms']:.2f} ms for B4 on the whole gallery,"
        f" between events on {card}")
    del qt, gt
    torch.cuda.empty_cache()

    md_arcface(win, stats, card)
    md_mp_demo(stats)
    launches = win.total()
    for part, names in (("detect", ("nms_fixpoint", "rows_gather")),
                        ("ensemble", ("nms_fixpoint", "rows_gather",
                                      "crop_resize")),
                        ("blazeface", ("blaze_decode_blend",)),
                        ("search", ("topk_gallery",)),
                        ("int8", ("conv_int8", "nms_fixpoint",
                                  "rows_gather"))):
        for name in names:
            if win.parts[part][name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"sharded {part} path")
    stats["windows"] = win.parts
    stats["s"] = time.time() - t_phase
    say(f"  multi-device phase: {stats['s']:.1f} s")
    return launches, stats




EXPORT_DIR = WORK_DIR / "export"
EXPORT_DEVICE = "cuda"       # where the exported programs run
EXPORT_ITERS = 3             # calls each program is timed over
# the exported ensemble runs its nets on all B x K slots, masked; the eager
# call on the slots before the last live column. cuDNN picks a
# convolution's algorithm by its batch size, so where the two batches
# differ the nets' sums may too: the boxes, scores, valid masks and crops
# must be equal bit for bit, the nets' outputs within these bounds, each
# about ten times the reading of the same effect in the multi-device phase
# on an H100 (embeddings 1.0e-7, age 4.2e-5, gender 1.6e-10; MD_WHOLE_TOL)
EXPORT_NET_TOL = {"embeddings": 1e-5, "age_probs": 5e-4,
                  "gender_probs": 1e-6}


def export_program(label, export, path, args, eager, expect, stats,
                   tol=None):
    """Export a program to ``path`` (``export(path)``), reload it with
    ``load_exported`` and call it on ``args``; its outputs against
    ``eager`` (the engine's outputs on the same inputs, a tuple), bit for
    bit or, where ``tol`` names an output's index, within its bound. The
    launch counts are zeroed after the export (which runs the program
    eagerly first) and the reload, and read after the reloaded call: each
    kernel in ``expect`` must have launched there. Records the export and
    reload seconds in ``stats[label]`` and returns the reloaded program
    and the reloaded call's counts."""
    from face_detection_and_recognition_tpu_torch.utils.export import \
        load_exported

    t = time.time()
    export(str(path))
    t_export = time.time() - t
    t = time.time()
    ex = load_exported(str(path))
    t_load = time.time() - t
    ck.reset_launches()
    out = ex.call(*args)
    sync()
    launches = dict(ck.LAUNCHES)
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"export {label}: the reloaded program "
                                 f"launched no {name}")
    if len(out) != len(eager):
        raise AssertionError(f"export {label}: {len(out)} outputs, eager "
                             f"{len(eager)}")
    gaps = []
    for i, (got, ref) in enumerate(zip(out, eager)):
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype \
                or got.device != ref.device:
            raise AssertionError(f"export {label}: output {i} is "
                                 f"{tuple(got.shape)} {got.dtype} on "
                                 f"{got.device}, eager {tuple(ref.shape)} "
                                 f"{ref.dtype} on {ref.device}")
        if tol and i in tol:
            gap = float((got - ref).abs().max()) if got.numel() else 0.0
            gaps.append(gap)
            if not gap <= tol[i]:
                raise AssertionError(f"export {label}: output {i} is "
                                     f"{gap:.3e} from the eager call's "
                                     f"(bound {tol[i]})")
        elif not same_bits(got, ref):
            raise AssertionError(f"export {label}: output {i} differs from "
                                 "the eager call's")
    stats[label] = {"export_s": round(t_export, 3),
                    "load_s": round(t_load, 3),
                    "file_mb": round(path.stat().st_size / 2**20, 2),
                    "launches": {k: v for k, v in launches.items() if v}}
    if gaps:
        stats[label]["gaps"] = gaps
    say(f"  {label}: exported in {t_export:.2f} s "
        f"({stats[label]['file_mb']} MiB), reloaded in {t_load:.2f} s, "
        f"{len(out)} outputs equal to the eager call's"
        + (f" (within bounds: {', '.join(f'{g:.2e}' for g in gaps)})"
           if gaps else " bit for bit")
        + f"; its call launched {stats[label]['launches']}")
    return ex, launches


def sync():
    if EXPORT_DEVICE == "cuda":
        torch.cuda.synchronize()


def run_export(frames, card, det, ens, blaze_front, queries, gallery):
    """The export main path (``utils/export.py``): the yolov5s detector
    (B1 + B2), BlazeFace-front (B5 fused), the dynamic int8 yolov5n (Q1 +
    B2 + B1) and ov-0204 (B1 at K = 400) through ``export_detector``, the
    yolov5s + MobileFaceNet + age/gender ensemble on the 576 x 1024 frames
    through ``export_ensemble`` (B1 + B2 + B3), a search of the similarity
    path's gallery (B4) and BlazeFace's ops-layer blend NMS (the
    standalone B5) through ``export_jitted``: each exported to
    ``build/chip_smoke/export/``, reloaded by ``load_exported`` and called
    on the phase's inputs, its outputs held to the eager call's. The
    launch counts are zeroed after each program's export and reload and
    read after its reloaded call (``export_program``); the path's counts
    are their sum (the eager references run before, their timings
    after). Returns the counts of this path alone and the numbers."""
    from face_detection_and_recognition_tpu_torch.ops.nms import \
        weighted_blend_nms
    from face_detection_and_recognition_tpu_torch.utils import export as X

    if EXPORT_DIR.exists():
        shutil.rmtree(EXPORT_DIR)
    EXPORT_DIR.mkdir(parents=True)
    dev = torch.device(EXPORT_DEVICE)
    t = time.time()
    int8 = FaceEngine(EngineConfig(detector="yolov5n", seed=SEED,
                                   detector_overrides={"quantized": True}),
                      device=dev)
    ov = FaceEngine(EngineConfig(detector="ov-0204", seed=SEED), device=dev)
    say(f"  int8 yolov5n and ov-0204 engines built in "
        f"{time.time() - t:.1f} s")
    frames_t = torch.from_numpy(frames).to(dev)
    dets_in, valid_in = blend_inputs(torch.Generator().manual_seed(SEED + 9),
                                     frames.shape[0], 896)
    dets_in, valid_in = dets_in.to(dev), valid_in.to(dev)
    thr = dict(det_thres=0.0, bbox_area_thres=0.0)

    def blend(d, v):
        return weighted_blend_nms(d, v, 0.3, 16)

    def search(q, g):
        return ck.topk_gallery(q, g, TOPK_K)

    # (label, export, inputs, eager function, the kernels its reloaded
    # call must launch); the detectors take their preprocessed input
    b1, b2 = "nms_fixpoint", "rows_gather"
    programs = []
    for label, eng, expect in (
            ("yolov5s detect", det, (b1, b2)),
            ("blazeface-front detect", blaze_front, ("blaze_decode_blend",)),
            ("int8 yolov5n detect", int8, ("conv_int8", b1, b2)),
            ("ov-0204 detect", ov, (b1,))):
        with torch.no_grad():  # an input export takes: no inference tensor
            x = eng._preprocess(frames_t)
        programs.append((label, lambda p, e=eng, n=x.shape[0]:
                         X.export_detector(e, p, batch=n), (x,), eng._detect,
                         expect))

    def ensemble(imgs):
        r = ens.detect_embed_classify_batch(imgs, **thr)
        return (r.det.boxes, r.det.scores, r.det.valid, r.crops,
                r.embeddings, r.age_probs, r.gender_probs)

    programs.append(("yolov5s + mobile_facenet + age/gender ensemble",
                     lambda p: X.export_ensemble(
                         ens, p, batch=frames.shape[0],
                         image_hw=frames.shape[1:3], **thr),
                     (frames_t,), ensemble, (b1, b2, "crop_resize")))
    programs.append(("topk_gallery search", lambda p: X.export_jitted(
        search, [queries, gallery], p, device=dev), (queries, gallery),
        search, ("topk_gallery",)))
    programs.append(("weighted_blend_nms", lambda p: X.export_jitted(
        blend, [dets_in, valid_in], p, device=dev), (dets_in, valid_in),
        blend, ("blend_nms",)))
    eager = {}
    for label, _, args, fn, _ in programs:
        with torch.inference_mode():
            out = fn(*args)
        eager[label] = tuple(out) if isinstance(out, tuple) else (out,)
    sync()
    stats, loaded = {}, {}
    tol = {4 + i: EXPORT_NET_TOL[n] for i, n in
           enumerate(("embeddings", "age_probs", "gender_probs"))}
    launches = dict.fromkeys(ck.LAUNCHES, 0)
    t_phase = time.time()
    for label, export, args, _, expect in programs:
        path = EXPORT_DIR / (re.sub(r"[^a-z0-9]+", "_", label) + ".pt2")
        loaded[label], counts = export_program(
            label, export, path, args, eager[label], expect, stats,
            tol=tol if "ensemble" in label else None)
        for name, n in counts.items():
            launches[name] += n
    say(f"  exported, reloaded and checked in {time.time() - t_phase:.1f} s")
    # after the counts are read: each program timed in turns with its eager
    # call (eager, reloaded, reloaded, eager), and its device time and
    # operations from the profiler
    for label, _, args, fn, _ in programs:
        def eager_call(fn=fn, args=args):
            with torch.inference_mode(), _full_f32(dev):
                return fn(*args)

        def reloaded(ex=loaded[label], args=args):
            return ex.call(*args)

        turns = [cuda_ms(f, EXPORT_ITERS) for f in (eager_call, reloaded,
                                                      reloaded, eager_call)]
        (dev_r, ops_r), (dev_e, ops_e) = (device_ms(f, 1) for f in
                                          (reloaded, eager_call))
        stats[label].update(ms=turns[1:3], eager_ms=[turns[0], turns[3]],
                            device_ms=dev_r, device_ops=ops_r,
                            eager_device_ms=dev_e, eager_device_ops=ops_e)
        say(f"  {label}: reloaded {turns[1]:.3f} / {turns[2]:.3f} ms, eager "
            f"{turns[0]:.3f} / {turns[3]:.3f} ms between CUDA events (in "
            f"turns); device {dev_r:.3f} ms in {ops_r} operations against "
            f"{dev_e:.3f} ms in {ops_e} on {card}")
    # the dispatcher hop a reloaded program adds to each kernel call: B1
    # through its operator against its wrapper, host us a call
    nms_args = (*nms_inputs(torch.Generator().manual_seed(SEED + 10)), 0.3,
                True, False, "union")
    nms_args = tuple(a.to(dev) if torch.is_tensor(a) else a
                     for a in nms_args)
    hop = {"operator_us": host_us(lambda: torch.ops.fdr.nms_fixpoint.default(
        *nms_args)), "wrapper_us": host_us(lambda: ck.nms_fixpoint(*nms_args))}
    stats["B1 host us a call"] = hop
    say(f"  B1 (8 x 1024) host us a call: {hop['operator_us']:.1f} through "
        f"fdr::nms_fixpoint, {hop['wrapper_us']:.1f} through its wrapper")
    shutil.rmtree(EXPORT_DIR)
    return launches, stats


VIDEO_DIR = WORK_DIR / "video"
VIDEO_FRAMES = 64              # frames of the clip (two blocks of 32)
VIDEO_FPS = 25
VIDEO_BATCHES = (8, 32)        # micro-batches timed file to annotated file
VIDEO_SAMPLED = [0, 25, 50]    # what 1 frame a second keeps of the clip
# (dx, top): frame i holds the golden image, scaled to the frame's width
# (1024 / 720, so that the letterbox gives it the golden gate's own scale),
# moved dx columns right and cut at row top, by VIDEO_PLACES[i % 8]. On
# this 8-pixel lattice the letterbox samples the image at the golden
# image's own phase, and (0, 96) is the golden letterbox itself. The gate's
# upper threshold, 0.75, is 0.03 under the third face's confidence there,
# and moving the image moves that confidence by up to 0.1 either way, so
# the gate does not hold everywhere on the lattice
# (``tools/video_gate_places.py`` scans it on the CPU); these eight places
# hold it with 0.025 or more to spare in confidence and in IoU.
VIDEO_PLACES = [(0, 96), (0, 80), (24, 80), (24, 56), (0, 56), (0, 128),
                (0, 184), (24, 184)]


def gate_images():
    """(golden image, negative image), each scaled to the frame's width,
    and the golden boxes at that scale."""
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW
    from face_detection_and_recognition_tpu_torch.ops.geometry import \
        host_resize

    pos, neg = CW.golden_images()
    scale = IO_HW[1] / pos.shape[1]
    size = (IO_HW[1], round(pos.shape[0] * scale))
    golden = np.asarray(CW.load_expected()["golden_boxes"], np.float32)
    return host_resize(pos, size), host_resize(neg, size), golden * scale


def placed(big, background, dx, top):
    """A 576 x 1024 frame of ``big`` (a scaled gate image) moved ``dx``
    columns right over ``background`` and cut at row ``top``."""
    h, w = IO_HW
    f = background.copy()
    f[:, dx:] = big[top:top + h, :w - dx]
    return f


def video_clip(path, big, n):
    """A clip written by the port's writer: ``n`` frames of 576 x 1024 at
    VIDEO_FPS, frame i ``big`` at VIDEO_PLACES[i % 8] over a seeded
    background. Returns (the frames, each frame's place, write ms a frame:
    the writer's encode on its threads and the file)."""
    from face_detection_and_recognition_tpu_torch.utils.video import \
        VideoWriter

    background = smooth_frame(SEED + 7)
    places = [VIDEO_PLACES[i % len(VIDEO_PLACES)] for i in range(n)]
    frames = [placed(big, background, dx, top) for dx, top in places]
    t = time.perf_counter()
    with VideoWriter(str(path), VIDEO_FPS, IO_HW[::-1]) as vw:
        for f in frames:
            vw.write(f)
    write_ms = (time.perf_counter() - t) * 1e3 / n
    return frames, places, write_ms


def same_posts(label, got, ref):
    """Two lists of per-frame results, bit for bit (boxes, confidences,
    areas, landmarks, labels)."""
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} frames against "
                             f"{len(ref)}")
    for i, (p, r) in enumerate(zip(got, ref)):
        for field in ("boxes", "bbox_confs", "bbox_areas", "bbox_lmarks"):
            a, b = getattr(p, field), getattr(r, field)
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"{label}: frame {i} {field} "
                                     f"{np.asarray(a).tolist()} against "
                                     f"{np.asarray(b).tolist()}")
        if list(p.bbox_labels or []) != list(r.bbox_labels or []):
            raise AssertionError(f"{label}: frame {i} labels "
                                 f"{p.bbox_labels} against {r.bbox_labels}")


def block_refs(eng, frames, mb, age_gender=False, det_thres=None):
    """The engine's own call on each block of ``mb`` decoded frames (the
    last padded with its last frame, as the loop pads it), at the engine's
    threshold or ``det_thres``: what the loop must hand back, frame by
    frame."""
    from face_detection_and_recognition_tpu_torch.models.age_gender import \
        labels_from_probs

    out = []
    for k in range(0, len(frames), mb):
        block = frames[k:k + mb]
        batch = np.stack(block + [block[-1]] * (mb - len(block)))
        if not age_gender:
            out += eng.detect_batch(batch, det_thres).to_numpy()[:len(block)]
            continue
        res = eng.detect_embed_classify_batch(batch, want_embed=False)
        posts = res.det.to_numpy()[:len(block)]
        valid = res.det.valid.cpu().numpy()
        ages, genders = res.age_probs.cpu().numpy(), \
            res.gender_probs.cpu().numpy()
        for i, p in enumerate(posts):
            p.bbox_labels = list(labels_from_probs(ages[i][valid[i]],
                                                   genders[i][valid[i]]))
        out += posts
    return out


def host_syncs(fn):
    """The synchronizing CUDA calls that ``fn()`` makes (a blocking copy
    between host and card, a synchronize), each as the file:line of the
    Python call that made it, from ``torch.cuda.set_sync_debug_mode``."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    root = Path(__file__).resolve().parent
    return [f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def place_gate(gate, want, boxes_at, negatives_at):
    """The golden gate of ``expected.json`` on one frame of the clip
    (``eval.card_weights.gate_failures``): ``boxes_at[t]``, the frame's
    boxes [N, 4] at each threshold ``t`` of the gate, held to ``want``,
    the golden boxes moved by the frame's place; ``negatives_at[t]``, the
    faces on the negative image's frame at the same place. Returns (the
    failures, the least IoU at the gate's threshold)."""
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    runs = []
    for t in CW.gate_thresholds(gate):
        ious = (CW.match_golden(boxes_at[t], want) if len(boxes_at[t])
                else [0.0] * len(want))
        runs.append((len(boxes_at[t]), ious, negatives_at[t]))
    ok = all(n == len(want) and min(ious) >= gate["iou_thres"]
             and n_neg == 0 for n, ious, n_neg in runs)
    bad = CW.gate_failures({"ok": ok, "n_pos": runs[0][0],
                            "n_neg": runs[0][2], "ious": runs[0][1]}, gate)
    return bad, min(runs[0][1])


def run_video(card):
    """The video main path (``utils/video.py``, ``core.inference
    .inference_vid``, the dataset's video items, ``detect_face -i
    clip.avi``), each part zeroing the launch counts before it and reading
    them after, with the B1 / B2 / B3 / fused B5 calls spied where the
    path makes them and replayed against their plain versions after the
    part (``spied_part``): yolov5s with ``card_weights/yolov5s.pt`` through
    ``inference_vid`` at the default micro-batch (B1, B2) on the clip and
    on a clip of the negative image, each frame bit for bit equal to
    ``detect_batch`` on its decoded block and passing the golden gate of
    ``expected.json`` (``place_gate``); the fused age/gender route on
    the yolov5s + seeded age/gender engine (B1, B2, B3), each frame equal
    to the ensemble call on its block and its labels to the staged
    ``detect_age_gender`` of the frame; BlazeFace-front through the CLI
    (B5 fused); ``extract_faces`` over a class tree holding the clip
    (frames 0, 25 and 50 sampled, a [45, D] ``.npy``). The written AVI is
    read back. Then the loop's frames/s file to annotated file at each of
    VIDEO_BATCHES, decode and write ms a frame, device ms a block, and the
    device's idle share over a traced loop. Returns (launches, numbers)."""
    from face_detection_and_recognition_tpu_torch.cli import detect_face
    from face_detection_and_recognition_tpu_torch.core.inference import (
        _default_micro_batch, _to_host, annotate, inference_vid)
    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW
    from face_detection_and_recognition_tpu_torch.pipelines import \
        dataset as PD
    from face_detection_and_recognition_tpu_torch.pipelines.extract_faces \
        import extract_faces_from_dataset
    from face_detection_and_recognition_tpu_torch.utils import \
        trace_analysis as TA
    from face_detection_and_recognition_tpu_torch.utils.native import (
        decode_jpeg_bgr, encode_jpeg_bgr)
    from face_detection_and_recognition_tpu_torch.utils.profiling import \
        device_trace
    from face_detection_and_recognition_tpu_torch.utils.video import (
        DECODE_WORKERS, ENCODE_WORKERS, VideoReader)

    shutil.rmtree(VIDEO_DIR, ignore_errors=True)
    (VIDEO_DIR / "tree" / "walker").mkdir(parents=True)
    clip = VIDEO_DIR / "tree" / "walker" / "clip.avi"
    neg_clip = VIDEO_DIR / "negative.avi"
    big, big_neg, golden = gate_images()
    src, places, write_ms = video_clip(clip, big, VIDEO_FRAMES)
    video_clip(neg_clip, big_neg, len(VIDEO_PLACES))
    reader = VideoReader(str(clip))
    chunks = list(reader.chunks())
    t = time.perf_counter()
    single = [decode_jpeg_bgr(c) for c in chunks]
    decode_ms = (time.perf_counter() - t) * 1e3 / len(single)
    t = time.perf_counter()
    for f in src:
        encode_jpeg_bgr(f)
    encode_ms = (time.perf_counter() - t) * 1e3 / len(src)
    t = time.perf_counter()
    decoded = list(reader.frames())
    decode_threads_ms = (time.perf_counter() - t) * 1e3 / len(decoded)
    if (len(chunks), reader.fps, len(decoded)) != (
            VIDEO_FRAMES, VIDEO_FPS, VIDEO_FRAMES) or any(
            not np.array_equal(a, b) for a, b in zip(decoded, single)):
        raise AssertionError("the clip does not read back whole")
    neg_decoded = list(VideoReader(str(neg_clip)).frames())
    stats = {"card": card, "frames": VIDEO_FRAMES, "hw": list(IO_HW),
             "decode_ms_a_frame": decode_ms,
             f"decode_ms_a_frame_{DECODE_WORKERS}_threads":
                 decode_threads_ms,
             "encode_ms_a_frame": encode_ms,
             f"write_ms_a_frame_{ENCODE_WORKERS}_threads": write_ms,
             "mae_vs_source": float(np.mean([np.abs(
                 a.astype(np.int16) - b).mean() for a, b in zip(decoded,
                                                                 src)]))}
    gate = CW.load_expected()["nets"]["yolov5s"]["gate"]
    thres = gate["det_thres"]
    y5_pt = str(CW.CARD_WEIGHTS / "yolov5s.pt")
    win, replayed = Windows(), {}

    # yolov5s at the default micro-batch (32 on the card), on the clip and
    # on the negative image's clip (one padded block)
    det = FaceEngine(EngineConfig(detector="yolov5s", det_thres=thres))
    det.load_weights(y5_pt)
    out_avi = VIDEO_DIR / "yolov5s.avi"
    (results, negatives), replayed["yolov5s"] = spied_part(
        win, "yolov5s", lambda: (
            inference_vid(det, str(clip), output=str(out_avi),
                          display=False),
            inference_vid(det, str(neg_clip), display=False)),
        ("nms_fixpoint", "candidate_decode"))
    mb = _default_micro_batch(det.device)
    same_posts("yolov5s loop against detect_batch a block", results,
               block_refs(det, decoded, mb))
    same_posts("yolov5s loop on the negative clip against detect_batch",
               negatives, block_refs(det, neg_decoded, mb))
    # the gate's other thresholds: detect_batch on the same blocks
    by_thres, neg_by_thres = {thres: results}, {thres: negatives}
    for t in CW.gate_thresholds(gate)[1:]:
        by_thres[t] = block_refs(det, decoded, mb, det_thres=t)
        neg_by_thres[t] = block_refs(det, neg_decoded, mb, det_thres=t)
    least = []
    for i, (dx, top) in enumerate(places):
        neg = i % len(VIDEO_PLACES)
        bad, iou = place_gate(
            gate, golden + np.array([dx, -top, dx, -top], np.float32),
            {t: np.asarray(r[i].boxes, np.float32).reshape(-1, 4)
             for t, r in by_thres.items()},
            {t: len(r[neg].boxes) for t, r in neg_by_thres.items()})
        if bad:
            raise AssertionError(f"frame {i} at {(dx, top)}: the golden "
                                 f"gate fails: {bad}")
        least.append(iou)
    stats["golden_min_iou"] = float(min(least))
    stats["detections"] = sum(len(p.boxes) for p in results)
    # the written AVI: the annotated frames, each JPEG-encoded once
    out = VideoReader(str(out_avi))
    written = list(out.frames())
    if (len(written), out.fps) != (VIDEO_FRAMES, float(VIDEO_FPS)):
        raise AssertionError(f"written AVI: {len(written)} frames at "
                             f"{out.fps} fps")
    for i, (frame, post) in enumerate(zip(decoded, results)):
        drawn = annotate(frame.copy(), post)
        if not np.array_equal(written[i],
                              decode_jpeg_bgr(encode_jpeg_bgr(drawn))):
            raise AssertionError(f"written frame {i} is not the annotated "
                                 "frame's JPEG")
    say(f"  yolov5s: {VIDEO_FRAMES} frames, {stats['detections']} "
        f"detections, each frame equal to detect_batch on its block of {mb} "
        "and passing the golden gate at "
        f"{', '.join(f'{t:.2f}' for t in CW.gate_thresholds(gate))} with "
        f"its place's boxes and negative frame (least IoU at {thres}: "
        f"{stats['golden_min_iou']:.4f}); the written AVI read back frame "
        "for frame")

    # the fused age/gender route
    ens = FaceEngine(EngineConfig(detector="yolov5s", det_thres=thres,
                                  with_age_gender=True, seed=SEED))
    ens.load_weights(y5_pt)
    labelled, replayed["age/gender"] = spied_part(
        win, "age/gender", lambda: inference_vid(
            ens, str(clip), display=False, age_gender=True),
        ("nms_fixpoint", "candidate_decode", "crop_resize"))
    same_posts("age/gender loop against the ensemble a block", labelled,
               block_refs(ens, decoded, mb, age_gender=True))
    for i, (p, frame) in enumerate(zip(labelled, decoded)):
        staged = ens.detect_age_gender(frame).bbox_labels
        if list(p.bbox_labels) != list(staged):
            raise AssertionError(f"age/gender frame {i}: labels "
                                 f"{p.bbox_labels} against the staged "
                                 f"call's {staged}")
    stats["labels"] = sum(len(p.bbox_labels) for p in labelled)
    if stats["labels"] != stats["detections"]:
        raise AssertionError(f"{stats['labels']} labels for "
                             f"{stats['detections']} faces")
    say(f"  age/gender: {stats['labels']} labels, each frame's equal to "
        "the staged detect_age_gender of the frame")

    # BlazeFace-front through the CLI
    blaze_avi = VIDEO_DIR / "blazeface.avi"
    (text, _), replayed["blazeface-front cli"] = spied_part(
        win, "blazeface-front cli", lambda: run_cli(detect_face, [
            "-i", str(clip), "--md", "blazeface-front", "--ckpt",
            str(CW.CARD_WEIGHTS / "blazeface_front.pt"), "-o",
            str(blaze_avi), "--no-display"]), ("blaze_decode_blend",))
    line = text.strip().splitlines()[-1]
    if not line.startswith(f"{VIDEO_FRAMES} frames, ") or \
            len(list(VideoReader(str(blaze_avi)).chunks())) != VIDEO_FRAMES:
        raise AssertionError(f"detect_face printed {text!r}")
    stats["blazeface_cli"] = line

    # curation: the clip as a video item of a class tree
    cur = FaceEngine(EngineConfig(detector="yolov5s", det_thres=thres,
                                  embedder="mobile_facenet"))
    cur.load_weights(y5_pt)
    cur.load_embed_weights(str(CW.CARD_WEIGHTS / "mobile_facenet.pt"))
    item, = PD.walk_class_tree(str(VIDEO_DIR / "tree"))
    sampled = [i for i, _ in PD.iter_media_frames(item)]
    ext, replayed["extract_faces"] = spied_part(
        win, "extract_faces", lambda: extract_faces_from_dataset(
            cur, str(VIDEO_DIR / "tree"), str(VIDEO_DIR / "faces"),
            num_workers=2, block_size=8),
        ("nms_fixpoint", "candidate_decode", "crop_resize"))
    feats = np.load(VIDEO_DIR / "faces" / "walker" / "clip.npy")
    n_rows = int((np.abs(feats).sum(1) > 0).sum())
    if sampled != VIDEO_SAMPLED or ext.failed or feats.shape != (
            PD.MAX_N_FRAME_FROM_VID * PD.MAX_N_FACES_PER_FRAME,
            cur.embed_spec.dim) or n_rows != 9:
        raise AssertionError(f"extract_faces: frames {sampled}, failed "
                             f"{ext.failed}, features {feats.shape} with "
                             f"{n_rows} rows set")
    stats["extract_faces"] = {"sampled": sampled, "npy": list(feats.shape),
                              "rows_set": n_rows}
    stats["replayed"] = replayed

    # the figures: the loop file to annotated file, then its parts
    for mb in VIDEO_BATCHES:
        run = lambda: inference_vid(det, str(clip), output=str(
            VIDEO_DIR / f"timed_{mb}.avi"), display=False, micro_batch=mb)
        run()  # cuDNN's picks for this batch size
        secs = []
        for _ in range(2):
            t = time.perf_counter()
            run()
            secs.append(time.perf_counter() - t)
        stats[f"frames_per_s_mb{mb}"] = VIDEO_FRAMES / min(secs)
        block = torch.from_numpy(np.stack(decoded[:mb])).to(det.device)
        stats[f"device_ms_a_block_mb{mb}"] = cuda_ms(
            lambda: det.detect_batch(block), iters=5)
    # host reads inside one block's dispatch (the loop's queued work and
    # the start of its copies to pinned memory): each stops the loop from
    # dispatching block k+1 before block k's work is done
    block = torch.from_numpy(np.stack(decoded[:mb])).to(det.device)
    fields = lambda d: [d.boxes, d.scores, d.lmarks, d.areas, d.valid]
    for name, call in (
            ("detect", lambda: _to_host(fields(det.detect_batch(block)))),
            ("fused_age_gender", lambda: _to_host(fields(
                ens.detect_embed_classify_batch(block, want_embed=False)
                .det)))):
        syncs = host_syncs(call)
        stats[f"host_syncs_a_dispatch_{name}"] = len(syncs)
        say(f"  {name} dispatch: {len(syncs)} synchronizing calls, at "
            f"{dict(sorted(collections.Counter(syncs).items()))}")
    trace_dir = VIDEO_DIR / "trace"
    with device_trace(str(trace_dir), with_stack=False):
        inference_vid(det, str(clip), output=str(VIDEO_DIR / "traced.avi"),
                      display=False)
        torch.cuda.synchronize()
    busy, wall, idle = TA.idle_share(str(trace_dir), "inference_vid")
    stats.update({"traced_loop_ms": wall, "traced_busy_ms": busy,
                  "idle_share": idle})
    for mb in VIDEO_BATCHES:
        say(f"  inference_vid micro-batch {mb}: "
            f"{stats[f'frames_per_s_mb{mb}']:.1f} frames/s file to "
            f"annotated file, device {stats[f'device_ms_a_block_mb{mb}']:.2f}"
            f" ms a block ({card})")
    say(f"  decode {decode_ms:.2f} ms a frame ({decode_threads_ms:.2f} with "
        f"{DECODE_WORKERS} threads), encode {encode_ms:.2f} ms a frame "
        f"(written at {write_ms:.2f} with {ENCODE_WORKERS} threads), idle "
        f"share {idle:.3f} over a traced loop of {wall:.1f} ms ({card})")
    stats["windows"] = win.parts
    return win.total(), stats


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
        " row gather, B3 crop + bilinear resize, B4 gallery top-k, B5"
        " weighted-blend NMS: standalone, and fused with BlazeFace's decode;"
        " Q1 the int8 convolution of the quantized yolov5 nets), CUDA C++ "
        "for sm_90a")
    phase_end("environment")

    say("[build]")
    cold = not ck.library_path().is_file()
    t = time.time()
    lib = ck.build_library()
    say(f"  {'built' if cold else 'found'} {lib.name} in "
        f"{time.time() - t:.1f} s")
    for name, regs, smem, stack in kernel_resources(
            ck.ptxas_report().read_text()):
        say(f"  ptxas: {name}: {regs} registers, {smem} bytes of static "
            f"shared memory, {stack}-byte stack frame"
            + ("" if stack == 0 else " (a stack frame: local memory)"))
    phase_end("build")

    say(f"[kernels] against their plain versions on {card}")
    gen = torch.Generator().manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    frames = rng.randint(0, 256, (B, 576, 1024, 3), np.uint8)
    singles = rng.randint(0, 256, (3, 540, 720, 3), np.uint8)
    kernels = [check_nms(gen), check_decode(gen),
               check_crop(gen, torch.from_numpy(frames).cuda()),
               check_topk(torch.Generator(device="cuda").manual_seed(SEED)),
               check_blend(gen), check_blaze_decode(gen)]
    for k in kernels:
        say(f"  {k['name']}: kernel {k['ms']:.5f} ms (device "
            f"{k['device_ms']:.5f} ms), plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.5f} ms "
            f"({k['bound_by']})")
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
    kernels[0].update(check_nms_on_path(engines[False], frames))
    phase_end("main path: detect")

    say("[tracing] device_trace of yolov5s detect_batch, read by "
        "utils.trace_analysis")
    tracing = run_tracing(engines[False], frames, card)
    say(f"  tracing numbers: {json.dumps(tracing)}")
    phase_end("tracing")

    say("[main path: ensemble] yolov5s + mobile_facenet + age/gender")
    t = time.time()
    ens = FaceEngine(EngineConfig(detector="yolov5s",
                                  embedder="mobile_facenet",
                                  with_age_gender=True, seed=SEED))
    say(f"  engine built in {time.time() - t:.1f} s")
    ensemble_launches, ens_result = run_ensemble(ens, frames, card)
    say(f"  launches on the ensemble path: {ensemble_launches}")
    for name in ("nms_fixpoint", "rows_gather", "crop_resize"):
        if ensemble_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: ensemble")

    say("[main path: similarity] the ensemble's embeddings against a "
        "gallery")
    emb = ens_result.embeddings[ens_result.det.valid].cpu().numpy()
    similarity_launches, gallery = run_similarity(emb, card)
    say(f"  launches on the similarity path: {similarity_launches}")
    if similarity_launches["topk_gallery"] <= 0:
        raise AssertionError("kernel topk_gallery never launched on the path")
    phase_end("main path: similarity")

    say("[main path: blazeface] BlazeFace back and front FaceEngines")
    blaze_launches, blaze = run_blazeface(frames, singles, card)
    say(f"  launches on the blazeface path: {blaze_launches}")
    if blaze_launches["blaze_decode_blend"] <= 0:
        raise AssertionError("kernel blaze_decode_blend never launched on "
                             "the path")
    kernels[-1].update(check_blaze_on_path(blaze, frames))
    phase_end("main path: blazeface")

    say("[main path: export] utils/export.py: yolov5s, BlazeFace-front, "
        "int8 yolov5n and ov-0204 detectors, the yolov5s ensemble, a "
        "gallery search and the blend NMS, exported, reloaded and called")
    queries = unit_rows(torch.from_numpy(emb)).cuda()
    export_launches, export_stats = run_export(
        frames, card, engines[False], ens, blaze["blazeface-front"], queries,
        gallery)
    del gallery, queries
    say(f"  launches on the export path: {export_launches}")
    say(f"  export numbers: {json.dumps(export_stats)}")
    for name in ck.LAUNCHES:
        if export_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "export path")
    phase_end("main path: export")

    say("[main path: yolov5 family + embedders] yolov5s6, yolov5s-official,"
        " facenet, facenet-512, reid-mnv2, demographics")
    family_launches, family, family_nets = run_family(frames, card)
    say(f"  launches on the yolov5 family + embedders path: "
        f"{family_launches}, by part {json.dumps(family['windows'])}")
    for name in ("nms_fixpoint", "rows_gather", "crop_resize"):
        if family_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: yolov5 family + embedders")

    say("[main path: cli + serving] JPEG route, detect_face CLI, HTTP "
        "front door of FaceService(ServiceConfig())")
    serving_launches, serving = run_cli_serving(card)
    say(f"  launches on the cli + serving path: {serving_launches}")
    say(f"  cli + serving numbers: {json.dumps(serving)}")
    say(f"  yolov5 family + embedders numbers: "
        f"{json.dumps({k: v for k, v in family.items() if k != 'windows'})}")
    phase_end("main path: cli + serving")

    say("[main path: pipelines] the dataset CLIs: extract_faces, "
        "extract_and_label, extract_features, extract_imdb_wiki")
    pipeline_launches, pipelines = run_pipelines(card)
    say(f"  launches on the pipelines path: {pipeline_launches}, by part "
        f"{json.dumps(pipelines['windows'])}")
    say(f"  pipelines numbers: {json.dumps(pipelines)}")
    phase_end("main path: pipelines")

    say("[main path: ssd + mtcnn] ssd-resnet10, ssd-mobilenetv2, "
        "ssd-squeezenet, mtcnn (default and full stages), /detect with "
        "mtcnn")
    ssd_launches, ssd_mtcnn = run_ssd_mtcnn(frames, card)
    say(f"  launches on the ssd + mtcnn path: {ssd_launches}")
    say(f"  ssd + mtcnn numbers: {json.dumps(ssd_mtcnn)}")
    for name in ("nms_fixpoint", "crop_resize"):
        if ssd_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: ssd + mtcnn")

    say("[main path: res10 + openvino] res10-ssd, ov-0204, "
        "ov-squeezenet-light, openvino-ir: detect_batch, detect_image, "
        "load_weights, detect_face --md openvino-ir, /detect with res10-ssd")
    r10ov_launches, r10ov = run_res10_openvino(frames, singles, card)
    say(f"  launches on the res10 + openvino path: {r10ov_launches}")
    say(f"  res10 + openvino numbers: {json.dumps(r10ov)}")
    if r10ov_launches["nms_fixpoint"] <= 0:
        raise AssertionError("kernel nms_fixpoint never launched on the path")
    phase_end("main path: res10 + openvino")

    say("[main path: int8 + keras + eval] yolov5n and yolov5s int8 "
        "(dynamic and static scales), a keras FaceNet SavedModel, "
        "eval_wider")
    ike_launches, ike, q1_kernel = run_int8_keras_eval(frames, card)
    kernels.append(q1_kernel)
    say(f"  launches on the int8 + keras + eval path: {ike_launches}, by "
        f"part {json.dumps(ike['windows'])}")
    say(f"  int8 + keras + eval numbers: "
        f"{json.dumps({k: v for k, v in ike.items() if k != 'windows'})}")
    for name in ("conv_int8", "nms_fixpoint", "rows_gather"):
        if ike_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: int8 + keras + eval")

    say("[main path: bf16] yolov5s bf16 detect (square, rect, "
        "detect_image) and the yolov5s + mobile_facenet + age/gender bf16 "
        "ensemble")
    bf16_launches, bf16_stats = run_bf16(frames, singles, card,
                                         engines[False], ens)
    say(f"  launches on the bf16 path: {bf16_launches}")
    say(f"  bf16 numbers: {json.dumps(bf16_stats)}")
    for name in ("nms_fixpoint", "rows_gather", "crop_resize"):
        if bf16_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: bf16")

    say("[main path: trained weights] card_weights/: yolov5s f32 and bf16, "
        "yolov5n f32 and int8 static, blazeface-front, mtcnn, mobile_facenet")
    tw_launches, tw = run_trained_weights(card)
    say(f"  launches on the trained weights path: {tw_launches}, by part "
        f"{json.dumps(tw['windows'])}")
    for name in ("nms_fixpoint", "rows_gather", "crop_resize",
                 "blaze_decode_blend", "conv_int8"):
        if tw_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: trained weights")

    say("[main path: bf16 families] blazeface, the SSDs, mtcnn, res10-ssd "
        "and the OpenVINO nets in bf16")
    bf16f_launches, bf16f = run_bf16_families(frames, card)
    say(f"  launches on the bf16 families path: {bf16f_launches}")
    say(f"  bf16 families numbers: {json.dumps(bf16f)}")
    for name in ("nms_fixpoint", "crop_resize", "blaze_decode_blend"):
        if bf16f_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    phase_end("main path: bf16 families")

    say("[main path: training] yolov5s train step (card against CPU), "
        "train_golden, quantize_golden, the BlazeFace and SSD trainers")
    train_launches, training = run_training(card)
    say(f"  launches on the training path: {train_launches}, by part "
        f"{json.dumps(training['windows'])}")
    say(f"  training numbers: {json.dumps(training)}")
    # each part's own kernels: B1 and B2 in train_golden's evals, Q1 in
    # quantize_golden's int8 engine
    for part, names in (("train_golden", ("nms_fixpoint", "rows_gather")),
                        ("quantize_golden", ("conv_int8",))):
        for name in names:
            if training["windows"][part][name] <= 0:
                raise AssertionError(f"kernel {name} never launched in "
                                     f"{part}")
    phase_end("main path: training")

    say("[main path: recognition training] the ArcFace step (card against "
        "CPU), train_golden_embedder and retrieval, train_golden_ag, "
        "train_golden_mtcnn, the res10-ssd and ov-0204 trainers")
    rec_launches, rec = run_recognition_training(frames, card)
    say(f"  launches on the recognition training path: {rec_launches}, by "
        f"part {json.dumps(rec['windows'])}")
    say(f"  recognition training numbers: {json.dumps(rec)}")
    phase_end("main path: recognition training")

    say("[multi-device] yolov5s detect, the ensemble, BlazeFace-front, "
        "the search (B4 a shard) and int8 yolov5n over 2 entries of the "
        "card, the DP + TP ArcFace step over 2 x 2, mp_demo as one NCCL "
        "rank")
    md_launches, md = run_multi_device(frames, card, engines[False], ens,
                                       blaze["blazeface-front"])
    say(f"  launches on the multi-device path: {md_launches}, by part "
        f"{json.dumps(md['windows'])}")
    say(f"  multi-device numbers: "
        f"{json.dumps({k: v for k, v in md.items() if k != 'windows'})}")
    phase_end("multi-device")

    say("[main path: video] a Motion-JPEG AVI of 64 576 x 1024 frames: "
        "inference_vid with yolov5s (card_weights) and on the fused "
        "age/gender route, detect_face -i clip.avi --md blazeface-front, "
        "extract_faces over the clip as a video item")
    video_launches, video = run_video(card)
    say(f"  launches on the video path: {video_launches}, by part "
        f"{json.dumps(video['windows'])}")
    say(f"  video numbers: "
        f"{json.dumps({k: v for k, v in video.items() if k != 'windows'})}")
    for part, names in (("yolov5s", ("nms_fixpoint", "rows_gather")),
                        ("age/gender", ("crop_resize",)),
                        ("blazeface-front cli", ("blaze_decode_blend",))):
        for name in names:
            if video["windows"][part][name] <= 0:
                raise AssertionError(f"kernel {name} never launched in the "
                                     f"video path's {part} part")
    phase_end("main path: video")

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
    for name, eng in blaze.items():
        side = eng.spec.input_size[0]
        check_reference(f"{name} raw heads", on(eng.net),
                        torch.rand((2, side, side, 3), generator=gen) * 2 - 1)
    for name in ("s6", "official"):
        check_reference(f"yolov5{name} raw maps", on(family_nets[name]),
                        torch.rand((2, 128, 192, 3), generator=gen))
    check_reference("facenet embeddings",
                    on(family_nets["facenet"], lambda m, x: [m(x)]),
                    torch.randn((4, 160, 160, 3), generator=gen))
    check_reference("reid-mnv2 embeddings",
                    on(family_nets["reid"], lambda m, x: [m(x)]),
                    torch.rand((4, 128, 128, 3), generator=gen) * 2 - 1)
    phase_end("reference")

    # each path's counts were zeroed just before it and read just after;
    # launches is their sum, launches_by_path keeps them apart (blend_nms,
    # the standalone B5, is on no main path: the engine calls the fused one)
    for k in kernels:
        by_path = {"detect": detect_launches[k["name"]],
                   "ensemble": ensemble_launches[k["name"]],
                   "similarity": similarity_launches[k["name"]],
                   "blazeface": blaze_launches[k["name"]],
                   "export": export_launches[k["name"]],
                   "yolov5 family + embedders": family_launches[k["name"]],
                   "cli + serving": serving_launches[k["name"]],
                   "pipelines": pipeline_launches[k["name"]],
                   "ssd + mtcnn": ssd_launches[k["name"]],
                   "res10 + openvino": r10ov_launches[k["name"]],
                   "int8 + keras + eval": ike_launches[k["name"]],
                   "bf16": bf16_launches[k["name"]],
                   "trained weights": tw_launches[k["name"]],
                   "bf16 families": bf16f_launches[k["name"]],
                   "training": train_launches[k["name"]],
                   "recognition training": rec_launches[k["name"]],
                   "multi-device": md_launches[k["name"]],
                   "video": video_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
