"""Q1 (``csrc/conv_int8.cu``) over one int8 forward, compared in turns on one
card between trees of this repository: this one and others (another commit
unpacked with ``git archive``).

    python3 tools/q1_compare.py [--tree DIR]... [--rounds 2]

Each tree runs in a process of its own (this file run as a script) that
imports the port from that directory and builds that tree's kernels there.
The trees (this one first) run in ``rounds`` passes, every other pass in
reverse order, so each side runs first once. For yolov5n with dynamic
scales and yolov5s with static ones (B = 8 seeded 576x1024 frames, square
640, seeded weights), a run prints one JSON line: Q1's calls a forward,
its device ms over them (profiler), its ms between events summed call by
call, the device operations, the host us to issue the calls once, the
int8 network's ms, and the calls whose pre-activation differs from the
plain version. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

NETS = (("yolov5n", True), ("yolov5s", "static"))


def measure() -> dict:
    """Q1 over one forward of each of NETS, in the port this process
    imports."""
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.ops import \
        cuda_kernels as ck
    from face_detection_and_recognition_tpu_torch.ops import int8_conv
    from face_detection_and_recognition_tpu_torch.utils.profiling import (
        captured_calls, cuda_ms, device_ms)

    frames = np.random.RandomState(0).randint(0, 256, (8, 576, 1024, 3),
                                              np.uint8)
    out = {}
    for arch, mode in NETS:
        eng = FaceEngine(EngineConfig(detector=arch, det_thres=0.0,
                                      bbox_area_thres=0.0,
                                      detector_overrides={"quantized": mode}))
        calls = [a for a, _ in captured_calls(
            ck, "conv_int8", lambda: eng.detect_batch(frames))]
        with torch.inference_mode():
            dev, ops = device_ms(lambda: [ck.conv_int8(*a) for a in calls], 5)
            events = sum(cuda_ms(lambda: ck.conv_int8(*a), 20)
                         for a in calls)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for a in calls:
                ck.conv_int8(*a)
            host_us = (time.perf_counter() - t) / len(calls) * 1e6
            torch.cuda.synchronize()
            x = eng._preprocess(torch.from_numpy(frames).cuda())
            net_ms = cuda_ms(lambda: eng._network(x), 20)
            differ = 0
            if hasattr(int8_conv, "conv_int8_packed_plain"):
                for a in calls:
                    lin = a[:8] + (None, a[9])
                    got = ck.conv_int8(*lin).contiguous()
                    ref = int8_conv.conv_int8_packed_plain(*lin).contiguous()
                    differ += not torch.equal(got.view(torch.int32),
                                              ref.view(torch.int32))
        out[f"{arch} {'static' if mode == 'static' else 'dynamic'}"] = dict(
            calls=len(calls), device_ms=dev, events_ms=events,
            device_ops=ops, host_us_a_call=host_us, network_ms=net_ms,
            calls_differing=differ if hasattr(
                int8_conv, "conv_int8_packed_plain") else None)
    return out


def _worker(tree: str) -> None:
    """Run as a script (this file's path), so that the port it imports is
    the one in ``tree``, which may not hold this file."""
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).parent:
        sys.path.pop(0)
    sys.path.insert(0, tree)
    print(json.dumps(dict(tree=tree, **measure())), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", action="append", default=[],
                   help="another tree of this repository")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker)
        return 0
    here = str(Path(__file__).resolve().parents[1])
    runs = [here] + [str(Path(t).resolve()) for t in args.tree]
    for r in range(args.rounds):
        for tree in (runs if r % 2 == 0 else runs[::-1]):
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 tree], cwd=here, capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stderr)
                return res.returncode
            print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
