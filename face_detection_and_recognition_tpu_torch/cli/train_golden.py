"""Train a detector to its first real detections on the golden image.

The counterpart of ``cli/train_golden.py`` in the JAX package:
``train/golden.train_golden`` builds synthetic composites from the
reference's pinned 3-face image, trains on the card with EMA, gates (3
faces at IoU >= the gate's bar against the pinned boxes of
tests/image_tests/test_yolov5_face.py:58-66, none on the 0-face image),
writes a ``.pt`` checkpoint, reloads it through a fresh engine and regates;
then the held-out composite AP. The JAX flags, and ``-d/--device`` (the card
unless ``-d cpu``). ``--resume-from`` takes a ``.pt``. With
``--export-caffemodel`` (res10-ssd) or ``--export-ir`` (ov-*), a passing
checkpoint is also written as a binary ``.caffemodel`` with the deploy
graph, or as an IR ``model.xml`` + ``.bin``, which ``FaceEngine.
load_weights`` reads.

    python -m face_detection_and_recognition_tpu_torch.cli.train_golden \\
        --out yolov5s_golden.pt --arch yolov5s --steps 4000

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
    ap.add_argument("--arch", default="yolov5n")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=200)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="continue from a previous golden checkpoint (.pt)")
    ap.add_argument("--gate-dt", type=float, default=0.5,
                    help="confidence center the golden gate holds at")
    ap.add_argument("--gate-margin", type=float, default=0.05,
                    help="gate must also hold at gate-dt +/- this")
    ap.add_argument("--gate-iou", type=float, default=0.5,
                    help="per-box IoU the gate requires")
    ap.add_argument("--export-caffemodel", default=None,
                    help="(res10-ssd only) also write the trained blobs "
                         "into a binary .caffemodel at this path")
    ap.add_argument("--export-ir", default=None,
                    help="(ov-* only) also write the trained weights into "
                         "a model.xml (+ sibling .bin) at this path")
    ap.add_argument("--face-px", default=None,
                    help="'lo,hi' pixel band for composite face sizes")
    ap.add_argument("--loss-override", action="append", default=[],
                    metavar="KEY=VAL",
                    help="family-config loss knob override (repeatable)")
    ap.add_argument("--crowded", action="store_true",
                    help="mix 16-48-face crowded composites into training")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.export_caffemodel and args.arch != "res10-ssd":
        ap.error("--export-caffemodel applies to --arch res10-ssd only")
    if args.export_ir and not args.arch.startswith("ov-"):
        ap.error("--export-ir applies to the ov-* topologies only")

    from ..train.golden import (evaluate_holdout_ap, golden_engine,
                                train_golden)

    work = args.work_dir or tempfile.mkdtemp(prefix="golden_")
    r = train_golden(
        args.out, work, arch=args.arch, input_size=args.size,
        batch_size=args.batch, max_steps=args.steps,
        eval_every=args.eval_every, n_images=args.images, lr=args.lr,
        seed=args.seed, resume_from=args.resume_from,
        gate_det_thres=args.gate_dt, gate_margin=args.gate_margin,
        gate_iou=args.gate_iou, crowded=args.crowded,
        face_px=(tuple(float(x) for x in args.face_px.split(","))
                 if args.face_px else None),
        loss_overrides={k: float(v) for k, v in
                        (s.split("=", 1) for s in args.loss_override)}
        or None, device=args.device)
    print(f"golden gate: ok={r['ok']} reload_ok={r.get('reload_ok')} "
          f"ious={['%.3f' % i for i in r['ious']]} steps={r.get('steps')}")
    if r["ok"] and r.get("reload_ok"):
        eng = golden_engine(args.arch, args.size, device=args.device)
        eng.load_weights(args.out)
        ap_ = evaluate_holdout_ap(eng, work, input_size=args.size,
                                  seed=args.seed + 7777)
        print(f"holdout AP50={ap_['AP50']:.3f} AP={ap_['AP']:.3f} "
              f"AR={ap_['AR']:.3f}")
        if args.export_caffemodel or args.export_ir:
            from ..core.engine import read_state_dict

            sd = read_state_dict(args.out)
        if args.export_caffemodel:
            from ..train.caffe_golden import export_trained_caffemodel

            export_trained_caffemodel(sd, args.export_caffemodel)
            print(f"trained .caffemodel written to "
                  f"{args.export_caffemodel}")
        if args.export_ir:
            from ..models.ov_topologies import export_trained_ir

            export_trained_ir(args.arch, sd, args.export_ir)
            print(f"trained IR written to {args.export_ir} (+ .bin)")
    return 0 if (r["ok"] and r.get("reload_ok")) else 1


if __name__ == "__main__":
    sys.exit(main())
