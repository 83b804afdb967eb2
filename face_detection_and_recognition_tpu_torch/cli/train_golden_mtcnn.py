"""Train the MTCNN P/R/O-Net cascade to the golden gate.

The counterpart of ``cli/train_golden_mtcnn.py`` in the JAX package
(``train/golden_mtcnn.train_golden_mtcnn``): the JAX flags, and
``-d/--device`` (the card unless ``-d cpu``); ``--out`` is the engine's
``.pt``.

    python -m face_detection_and_recognition_tpu_torch.cli.train_golden_mtcnn \\
        --out golden_mtcnn.pt

Exit code 0 only when the reloaded checkpoint passes the gate.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from ..utils.parser import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="checkpoint output (.pt)")
    ap.add_argument("--images", type=int, default=256)
    ap.add_argument("--crops", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work-dir", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..train.golden_mtcnn import train_golden_mtcnn

    work = args.work_dir or tempfile.mkdtemp(prefix="golden_mtcnn_")
    r = train_golden_mtcnn(
        args.out, work, n_images=args.images, n_crops=args.crops,
        batch_size=args.batch, max_steps=args.steps, lr=args.lr,
        seed=args.seed, device=args.device)
    print(f"golden-mtcnn gate: ok={r['ok']} reload_ok={r.get('reload_ok')} "
          f"ious={['%.3f' % i for i in r['ious']]}")
    return 0 if (r["ok"] and r.get("reload_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
