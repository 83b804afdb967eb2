"""The golden embedder trainer's gate over many seeds: how often
``train/golden_embed.train_golden_embedder`` at the JAX defaults (3
identities, 600 steps, an eval every 50) passes the 3-identity filter
gate, from the port's initialization of each seed and from the JAX
package's.

    python tools/embed_gate_seeds.py --jax-inits 0 1 2 3
    python tools/embed_gate_seeds.py --runs port:0 port:1 jax:0 jax:1 \\
        [--parallel 4] [--out build/embed_gate_seeds] [-d cuda]

``--jax-inits`` (a host with the JAX package, on its CPU) writes the JAX
``train/arcface.create_train_state`` of each seed, the net through the
port's bridge (``utils/weights.py``) and the class kernel, to
``<out>/jax_init_s<seed>.pt``. ``--runs`` trains each run in a process of
its own, ``--parallel`` at a time on one device: ``port:S`` from the
port's draw of seed S, ``jax:S`` from ``jax_init_s<S>.pt`` (the same
batches, the port's trainer); both take seed S's crops and batch order.
Each run prints one JSON line (passed, the step of the pass, the final
gate, the reload's verdict, seconds, each eval's line), and a last line
counts the passes by start. The run mode imports only the port.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def jax_inits(seeds, out: Path) -> None:
    """The JAX package's seeded ArcFace train states, as the port's."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu.train import arcface as JA
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    for s in seeds:
        # the golden recipe's config (train/golden_embed.py)
        st = JA.create_train_state(JA.ArcFaceTrainConfig(
            num_classes=3, lr=0.01, embedding_size=512, s=16.0,
            center_gain=0.02), jax.random.PRNGKey(s))
        v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
            "params": st["params"]["net"],
            "batch_stats": st["batch_stats"]})
        torch.save({"net": {k: torch.as_tensor(np.array(t)) for k, t in
                            W.mobile_facenet_state_dict(v).items()},
                    "kernel": torch.as_tensor(np.array(
                        st["params"]["arcface_kernel"], np.float32))},
                   out / f"jax_init_s{s}.pt")
        print(f"wrote {out / f'jax_init_s{s}.pt'}", flush=True)


def one_run(start: str, seed: int, out: Path, device) -> dict:
    """One trainer run from ``start`` ("port" or "jax") at ``seed``."""
    import torch

    from face_detection_and_recognition_tpu_torch.train import arcface as A
    from face_detection_and_recognition_tpu_torch.train import \
        golden_embed as G

    create = A.create_train_state
    if start == "jax":
        init = torch.load(out / f"jax_init_s{seed}.pt")

        def from_jax(cfg, generator=None, device=None):
            st = create(cfg, generator, device)
            st["net"].load_state_dict(init["net"])
            with torch.no_grad():
                st["arcface_kernel"].copy_(init["kernel"])
            return st

        A.create_train_state = from_jax
    evals = []
    t = time.time()
    ckpt = out / f"{start}{seed}.pt"
    try:
        r = G.train_golden_embedder(
            str(ckpt), seed=seed, device=device,
            log=lambda m: evals.append(m.split("] ", 1)[1])
            if "eval@" in m else None)
    finally:
        A.create_train_state = create
    ckpt.unlink()
    return {"run": f"{start}:{seed}", "ok": bool(r["ok"]),
            "steps": r.get("steps"), "same": r["same_acc"],
            "cross": r["cross_acc"], "margin": r["margin"],
            "reload_ok": bool(r["reload_ok"]), "s": time.time() - t,
            "evals": evals}


def run_all(runs, parallel: int, out: Path, device) -> None:
    """Each run in a process of its own, ``parallel`` at a time."""
    t0 = time.time()
    pending, live = list(runs), []
    while pending or live:
        while pending and len(live) < parallel:
            cmd = [sys.executable, __file__, "--one", pending.pop(0),
                   "--out", str(out)] + (["-d", device] if device else [])
            live.append(subprocess.Popen(cmd))
        live = [p for p in live if p.poll() is None]
        time.sleep(1)
    recs = []
    for run in runs:
        path = out / (run.replace(":", "") + ".json")
        if path.is_file():
            recs.append(json.loads(path.read_text()))
    counts = {}
    for r in recs:
        start = r["run"].split(":")[0]
        n, k = counts.get(start, (0, 0))
        counts[start] = (n + 1, k + r["ok"])
    print(json.dumps({"passed": {s: f"{k} of {n}" for s, (n, k) in
                                 counts.items()},
                      "s": time.time() - t0}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-inits", type=int, nargs="*")
    ap.add_argument("--runs", nargs="*")
    ap.add_argument("--one")
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "build" / "embed_gate_seeds"))
    ap.add_argument("-d", "--device", default=None,
                    help="the card unless the CPU is asked")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.jax_inits:
        jax_inits(args.jax_inits, out)
    if args.one:
        start, seed = args.one.split(":")
        rec = one_run(start, int(seed), out, args.device)
        (out / f"{start}{seed}.json").write_text(json.dumps(rec))
        print(json.dumps(rec), flush=True)
    if args.runs:
        run_all(args.runs, args.parallel, out, args.device)


if __name__ == "__main__":
    main()
