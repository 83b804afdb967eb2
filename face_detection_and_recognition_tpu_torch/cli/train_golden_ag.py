"""Train the age / gender heads to the reference's pinned golden labels.

The counterpart of ``cli/train_golden_ag.py`` in the JAX package:
``train/golden_ag.train_golden_ag`` trains both CaffeNet heads until the
cascade (trained detector -> crop -> classify -> "Male:...,(38-43):..."
strings) matches tests/image_tests/test_opencv_age_gender.py:47-48, then a
``.pt`` checkpoint, a fresh engine and the regate. ``--detector-ckpt``
takes the detector's ``.pt`` (``card_weights/yolov5n.pt`` for yolov5n).
The JAX flags, and ``-d/--device`` (the card unless ``-d cpu``).

    python -m face_detection_and_recognition_tpu_torch.cli.train_golden_ag \\
        --out golden_ag.pt --detector-ckpt card_weights/yolov5n.pt

Exit code 0 only when the reloaded checkpoint passes the cascade gate.
"""
from __future__ import annotations

import argparse
import sys

from ..utils.parser import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="checkpoint output (.pt)")
    ap.add_argument("--detector-ckpt", required=True,
                    help="trained golden detector checkpoint (.pt)")
    ap.add_argument("--detector", default="yolov5n")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..train.golden_ag import train_golden_ag

    r = train_golden_ag(
        args.out, args.detector_ckpt, detector=args.detector,
        batch_size=args.batch, max_steps=args.steps,
        eval_every=args.eval_every, lr=args.lr, seed=args.seed,
        device=args.device)
    print(f"golden-ag gate: ok={r['ok']} reload_ok={r.get('reload_ok')} "
          f"steps={r.get('steps')} labels={r.get('labels')}")
    return 0 if (r["ok"] and r.get("reload_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
