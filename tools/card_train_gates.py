"""Train the port's golden trainers to their gates at the JAX recipes, on
the card, and regate what they write through fresh engines.

    python tools/card_train_gates.py [--seed 0] [--out build/card_train_gates]
        [--cap 900] [--only yolov5n,embed,mtcnn,res10,ov-0204] [-d cuda]

Each run is the port's CLI in a process of its own, stopped after
``--cap`` seconds (15 min):

1. ``cli/train_golden --arch yolov5n --steps 8000 --gate-dt 0.6
   --gate-margin 0.15``: the JAX ``Makefile`` ``accuracy`` recipe. It stops
   at the first eval whose gate passes (JAX ``train/golden.py:851-857``);
2. ``cli/train_golden_embed`` at the JAX defaults (600 steps, an eval
   every 50; JAX ``train/golden_embed.py:319-330``);
3. ``cli/train_golden_mtcnn`` at the JAX function's defaults (256 images,
   4096 crops, B = 128, 3000 steps a stage; JAX
   ``train/golden_mtcnn.py:193-203``);
4. ``cli/train_golden --arch res10-ssd --export-caffemodel`` and ``--arch
   ov-0204 --export-ir`` at the JAX recipes' sizes, batches and rates for
   ``--export-steps`` steps (300), resumed from the committed
   ``card_weights/`` weights so that the gate passes at the first eval and
   the CLI writes the file.

After each run a fresh engine loads what the run wrote and regates it
(the band gate; the filter gate for the embedder; MTCNN's gate); each
exported file is loaded by another fresh engine through
``FaceEngine.load_weights`` and its detections on both golden images,
at each of the gate's thresholds, are held to those of the engine that
loaded the trained ``.pt``. The script prints, for each run, the step at
which the gate passed (or the step it stopped at), its seconds and ms a
step (evals included), the gate's numbers and the reload's verdict, and
writes them as JSON to ``<out>/card_train_gates.json``; its last line is
that JSON. Exit code 0 when every run ran; a gate missed is reported,
not raised. Imports only the port; the data comes from ``--seed`` and
``card_weights/``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "face_detection_and_recognition_tpu_torch"
BAND = {"det_thres": 0.6, "margin": 0.15, "iou_thres": 0.5,
        "require_ok": True, "iou_bars": [0.5, 0.5, 0.5]}
MTCNN_GATE = {"det_thres": 0.5, "margin": 0.05, "iou_thres": 0.5,
              "require_ok": True, "iou_bars": [0.5, 0.5, 0.5]}
# name -> (CLI module, its arguments but --out / --seed / -d, weight file,
# what it trains: the detector's registry name, or "embed")
RUNS = {
    "yolov5n": ("train_golden", ["--arch", "yolov5n", "--steps", "8000",
                                 "--gate-dt", "0.6", "--gate-margin",
                                 "0.15"], "yolov5n.pt", "yolov5n"),
    "embed": ("train_golden_embed", [], "mobile_facenet.pt", "embed"),
    "mtcnn": ("train_golden_mtcnn", ["--images", "256", "--crops", "4096",
                                     "--batch", "128", "--steps", "3000"],
              "mtcnn.pt", "mtcnn"),
    "res10": ("train_golden", ["--arch", "res10-ssd", "--size", "300",
                               "--batch", "32", "--lr", "0.001",
                               "--gate-dt", "0.6", "--gate-margin", "0.15",
                               "--eval-every", "100", "--resume-from",
                               "card_weights/res10_ssd.pt"],
              "res10_ssd.pt", "res10-ssd"),
    "ov-0204": ("train_golden", ["--arch", "ov-0204", "--size", "448",
                                 "--batch", "16", "--lr", "0.001",
                                 "--gate-dt", "0.6", "--gate-margin", "0.15",
                                 "--eval-every", "100",
                                 "--resume-from", "card_weights/ov_0204.pt"],
                "ov_0204.pt", "ov-0204"),
}
# the export each run writes, by its flag
EXPORTS = {"res10": ("--export-caffemodel", "res10.caffemodel"),
           "ov-0204": ("--export-ir", "ov_0204.xml")}
PROGRESS = re.compile(r"\[(?:device-loop|golden-embed|golden-mtcnn)\] "
                      r"(?:\w+ )?step (\d+)")
EVAL = re.compile(r"\[golden(?:-embed)?\] eval@(\d+)")


def run_cli(name, args, out, cap):
    """Run the trainer ``name`` as ``python -m`` in a process group of its
    own, its output teed to ``<out>/<name>.log`` with arrival times;
    killed after ``cap`` seconds. Returns (exit code or None when it was
    stopped, [(seconds, line)])."""
    module, extra, _, _ = RUNS[name]
    cmd = [sys.executable, "-u", "-m", f"{PKG}.cli.{module}", *extra, *args]
    print(f"[{name}] {' '.join(cmd[2:])}", flush=True)
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = []

    def read():
        with open(out / f"{name}.log", "w") as log:
            for line in proc.stdout:
                lines.append((time.time() - t0, line.rstrip("\n")))
                log.write(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=cap)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = None
    reader.join(timeout=30)
    return rc, lines


def progress(lines):
    """(last step, ms a step between the first and last progress lines,
    evals included) of a trainer's log."""
    marks = [(t, int(m.group(1))) for t, line in lines
             for m in [PROGRESS.search(line)] if m]
    if len(marks) < 2 or marks[-1][1] <= marks[0][1]:
        return (marks[-1][1] if marks else 0), None
    (t0, s0), (t1, s1) = marks[0], marks[-1]
    return s1, (t1 - t0) / (s1 - s0) * 1e3


def final_line(lines, prefix):
    """The CLI's summary line (``prefix``...), or None."""
    return next((line for _, line in reversed(lines)
                 if line.startswith(prefix)), None)


def fresh_engine(detector, size, device):
    """The engine the trainer gates ``detector`` through: MTCNN at its
    native resolution, the others as ``train/golden.golden_engine``."""
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.train.golden import \
        golden_engine

    if detector == "mtcnn":
        return FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5),
                          device=device)
    return golden_engine(detector, size, device=device)


def detector_gate(detector, size, path, gate, device):
    """A fresh engine loading ``path`` (``load_weights``) through the
    golden gate ``gate``: (result, failures, engine)."""
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    eng = fresh_engine(detector, size, device)
    eng.load_weights(str(path))
    pos, neg = CW.golden_images()
    golden = np.asarray(CW.load_expected()["golden_boxes"], np.float32)
    with torch.inference_mode():
        res = CW.run_gate(eng, pos, neg, gate, golden)
    return res, CW.gate_failures(res, gate), eng


def embedder_gate(path, device):
    """A fresh MobileFaceNet engine loading ``path``
    (``load_embed_weights``) through the 3-identity filter gate."""
    import torch

    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.train.golden_embed import \
        evaluate_identity_filter

    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="mobile_facenet"), device=device)
    eng.load_embed_weights(str(path))
    with torch.inference_mode():
        r = evaluate_identity_filter(eng.embed_crops)
    return {k: r[k] for k in ("ok", "same_acc", "cross_acc", "margin")}


def same_detections(a, b, gate):
    """The largest box and confidence differences between two engines at
    each of the gate's thresholds on both golden images (None where the
    counts differ)."""
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu_torch.eval import \
        card_weights as CW

    px = conf = 0.0
    with torch.inference_mode():
        for t in CW.gate_thresholds(gate):
            for img in CW.golden_images():
                x, y = a.detect_image(img, det_thres=t), \
                    b.detect_image(img, det_thres=t)
                if len(x.boxes) != len(y.boxes):
                    return None, None
                if len(x.boxes):
                    px = max(px, float(np.abs(np.asarray(x.boxes)
                                              - np.asarray(y.boxes)).max()))
                    conf = max(conf, float(np.abs(
                        np.asarray(x.bbox_confs)
                        - np.asarray(y.bbox_confs)).max()))
    return px, conf


def run_one(name, out, seed, cap, device, export_steps):
    """One run and its reload: the numbers ``main`` prints."""
    _, _, file, what = RUNS[name]
    path = out / file
    args = ["--out", str(path), "--seed", str(seed), "-d", device]
    if what not in ("embed", "mtcnn"):
        args += ["--work-dir", str(out / f"{name}_work")]
    if name in EXPORTS:
        flag, exported = EXPORTS[name]
        args += ["--steps", str(export_steps), flag, str(out / exported)]
    t = time.time()
    rc, lines = run_cli(name, args, out, cap)
    rec = {"exit": rc, "s": time.time() - t, "stopped_at_cap": rc is None}
    rec["last_step"], rec["ms_a_step"] = progress(lines)
    rec["evals"] = len({int(m.group(1)) for _, line in lines
                        for m in [EVAL.search(line)] if m})
    summary = final_line(lines, {"embed": "golden-embed gate:",
                                 "mtcnn": "golden-mtcnn gate:"}.get(
                                     what, "golden gate:"))
    rec["summary"] = summary
    rec["passed"] = bool(summary and "ok=True" in summary)
    m = re.search(r"steps=(\d+)", summary or "")
    rec["step_at_pass"] = (int(m.group(1)) if rec["passed"] and m
                           else None)
    if what == "mtcnn":
        rounds = [line for _, line in lines if "[golden-mtcnn] gate r" in line]
        rec["bootstrap_rounds"] = len(rounds)
    ap = final_line(lines, "holdout AP50=")
    if ap:
        rec["holdout"] = ap
    if not path.is_file():
        rec["reload"] = "no checkpoint written"
        return rec
    if what == "embed":
        rec["reload"] = embedder_gate(path, device)
        return rec
    gate = MTCNN_GATE if what == "mtcnn" else BAND
    size = {"res10-ssd": 300, "ov-0204": 448}.get(what, 640)
    res, bad, eng = detector_gate(what, size, path, gate, device)
    rec["reload"] = {"ok": not bad, "failures": bad,
                     "ious": [round(i, 4) for i in res["ious"]],
                     "n_pos": res["n_pos"], "n_neg": res["n_neg"]}
    if name in EXPORTS:
        exported = out / EXPORTS[name][1]
        if not exported.is_file():
            rec["export"] = "not written"
            return rec
        other = fresh_engine(what, size, device)
        other.load_weights(str(exported))
        px, conf = same_detections(eng, other, gate)
        rec["export"] = {"file": exported.name, "max_px": px,
                         "max_conf": conf,
                         "equal": px is not None and px == 0.0
                         and conf == 0.0}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "card_train_gates"))
    ap.add_argument("--cap", type=float, default=900.0,
                    help="seconds a run may take")
    ap.add_argument("--only", default=",".join(RUNS))
    ap.add_argument("--export-steps", type=int, default=300)
    ap.add_argument("-d", "--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"card: {card}", flush=True)
    results = {"card": card, "seed": args.seed, "cap_s": args.cap}
    for name in args.only.split(","):
        rec = run_one(name, out, args.seed, args.cap, args.device,
                      args.export_steps)
        results[name] = rec
        print(f"[{name}] {json.dumps(rec)}", flush=True)
    with open(out / "card_train_gates.json", "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
