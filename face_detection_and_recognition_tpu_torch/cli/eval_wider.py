"""CLI: WIDER-FACE COCO-style evaluation of any registered detector.

The counterpart of ``cli/eval_wider.py`` in the JAX package, the
reference's ``eval/eval_face_detector.py`` (AP@[.5:.95] / AP50 / AP75 /
AR@100) without pycocotools: the same flags, and ``-d/--device`` (the card
unless ``-d cpu``). ``--ckpt`` takes what ``FaceEngine.load_weights``
reads (a torch ``.pt`` / ``.pth``, an int8 one included, a
``.caffemodel``, ``.pb`` or ``.xml``). The metrics are printed as one JSON
line.

    python -m face_detection_and_recognition_tpu_torch.cli.eval_wider \\
        --ann wider_face_split/wider_face_val_bbx_gt.txt \\
        --images WIDER_val/images --md yolov5s --ckpt weights.pt
"""
from __future__ import annotations

import argparse
import json

from ..core.engine import EngineConfig, FaceEngine
from ..eval.coco_eval import evaluate_engine_on_wider
from ..models import registry
from ..utils.parser import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--md", dest="model", default="yolov5s",
                    choices=registry.available())
    ap.add_argument("--dt", dest="det_thres", type=float, default=0.02,
                    help="low threshold for AP sweeps")
    ap.add_argument("--at", dest="bbox_area_thres", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--limit", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    engine = FaceEngine(EngineConfig(
        detector=args.model, det_thres=args.det_thres,
        bbox_area_thres=args.bbox_area_thres, max_det=300,
    ), device=args.device)
    if args.ckpt:
        engine.load_weights(args.ckpt)
    metrics = evaluate_engine_on_wider(engine, args.ann, args.images,
                                       limit=args.limit)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
