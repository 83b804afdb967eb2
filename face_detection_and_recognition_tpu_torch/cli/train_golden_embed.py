"""Train an embedder with ArcFace to its first recognition result.

The counterpart of ``cli/train_golden_embed.py`` in the JAX package:
``train/golden_embed.train_golden_embedder`` turns the three golden faces
into identities (or a population of synthetic ones with ``--identities``
> 3), trains on augmented crop sets, and gates on the similar-face filter's
own math (each class's mean and max-distance threshold,
``similar_face_filtering/filter_faces_using_reference.py:71-100``); then a
``.pt`` checkpoint with its ``golden_meta.json``, a fresh engine's
``load_embed_weights`` and the regate through its embed path. The JAX
flags, and ``-d/--device`` (the card unless ``-d cpu``).

    python -m face_detection_and_recognition_tpu_torch.cli.train_golden_embed \\
        --out golden_embed.pt --steps 600

Exit code 0 only when the reloaded checkpoint passes the gate.
"""
from __future__ import annotations

import argparse
import sys

from ..utils.parser import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True, help="checkpoint output (.pt)")
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--train-per-id", type=int, default=96)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--embedder", default="mobile_facenet",
                    choices=("mobile_facenet", "facenet", "facenet-512",
                             "reid-mnv2"),
                    help="facenet = the InceptionResNetV1 128-d slot; "
                         "facenet-512 = the 512-d one")
    ap.add_argument("--aug-scale", type=float, default=1.6)
    ap.add_argument("--center-gain", type=float, default=0.02)
    ap.add_argument("--identities", type=int, default=3,
                    help=">3 trains on the synthetic identity population "
                         "and also gates on rank-1 retrieval and the "
                         "N-class filter math")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..train.golden_embed import train_golden_embedder

    r = train_golden_embedder(
        args.out, batch_size=args.batch, max_steps=args.steps,
        eval_every=args.eval_every, n_train_per_id=args.train_per_id,
        lr=args.lr, seed=args.seed, embedder=args.embedder,
        aug_scale=args.aug_scale, center_gain=args.center_gain,
        n_identities=args.identities, device=args.device)
    print(f"golden-embed gate: ok={r['ok']} reload_ok={r.get('reload_ok')} "
          f"same={r['same_acc']:.2f} cross={r['cross_acc']:.2f} "
          f"margin={r['margin']:.3f} steps={r.get('steps')}")
    if "reload_retrieval" in r:
        rr = r["reload_retrieval"]
        print(f"retrieval@{rr['n_identities']}: rank1={rr['rank1']:.3f} "
              f"same={rr['same_acc']:.3f} cross={rr['cross_acc']:.3f} "
              f"margins min/med/max={rr['margin_min']:.3f}/"
              f"{rr['margin_median']:.3f}/{rr['margin_max']:.3f}")
    return 0 if (r["ok"] and r.get("reload_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
