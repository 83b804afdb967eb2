"""CLI: labeled face extraction with cross-frame tracking.

The counterpart of ``cli/extract_and_label.py`` in the JAX package, the
reference's ``face_extraction/extract_and_label_faces_from_dataset.py``
entry point (flags ``-sd/-td/-ft`` at ``:432-452``): faces are tracked
across frames by embedding distance + IoU gating and annotated with
face_ids plus age/gender labels from the engine's age/gender heads
(``--labeler auto``, the default). The port has no window, so
``--labeler interactive`` (the reference's key-driven labeler) raises. It
runs on the card unless ``-d cpu`` is given; the ``--*ckpt`` flags take
torch ``.pt`` / ``.pth`` state dicts.

    python -m face_detection_and_recognition_tpu_torch.cli.extract_and_label \\
        -i dataset/ -o labeled_out/ --md yolov5s --fd mobile_facenet
"""
from __future__ import annotations

import argparse

from ..core.engine import EngineConfig, FaceEngine
from ..models import registry
from ..models.embedders import available_embedders
from ..pipelines.tracking import (auto_age_gender_labeler,
                                  extract_and_label_faces,
                                  interactive_labeler)
from ..utils.logging_utils import setup_job_logger
from ..utils.parser import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input_dir", "-sd", dest="input_dir",
                    required=True,
                    help="dataset root with one-level class dirs")
    ap.add_argument("-o", "--output_dir", "-td", dest="output_dir",
                    required=True)
    ap.add_argument("--md", "--model", dest="model", default="yolov5s",
                    choices=registry.available())
    ap.add_argument("--fd", "--feat_net", dest="feat_net",
                    default="reid-mnv2", choices=available_embedders(),
                    help="tracking embedder (reference -ft, default reid)")
    ap.add_argument("--dt", dest="det_thres", type=float, default=0.70)
    ap.add_argument("--at", dest="bbox_area_thres", type=float, default=0.12)
    ap.add_argument("--labeler", default="auto",
                    choices=("auto", "interactive", "none"),
                    help="age/gender source for new tracks (interactive "
                    "needs a window: not available)")
    ap.add_argument("--metric", default=None, choices=("l2", "cosine"),
                    help="embedding distance; default follows the reference "
                    "(:103-106): cosine for reid, l2 otherwise")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--ckpt", default=None, help="detector weights")
    ap.add_argument("--embed-ckpt", default=None, help="embedder weights")
    ap.add_argument("--ag-ckpt", default=None,
                    help="age/gender head weights for the auto labeler")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.labeler == "interactive":
        interactive_labeler()  # raises: the port has no window

    logger = setup_job_logger("face_extraction_labeled")
    metric = args.metric or (
        "cosine" if args.feat_net.startswith("reid") else "l2")
    engine = FaceEngine(EngineConfig(
        detector=args.model, det_thres=args.det_thres,
        bbox_area_thres=args.bbox_area_thres, embedder=args.feat_net,
        with_age_gender=args.labeler == "auto",
    ), device=args.device)
    if args.ckpt:
        engine.load_weights(args.ckpt)
    if args.embed_ckpt:
        engine.load_embed_weights(args.embed_ckpt)
    if args.ag_ckpt:
        engine.load_age_gender_weights(args.ag_ckpt)
    labeler = (auto_age_gender_labeler(engine) if args.labeler == "auto"
               else None)

    annotations = extract_and_label_faces(
        engine, args.input_dir, args.output_dir,
        labeler=labeler, metric=metric, num_workers=args.workers,
    )
    n_faces = sum(len(a["face_ids"]) for a in annotations.values())
    n_tracks = sum(len(set(a["face_ids"])) for a in annotations.values())
    logger.info("done: %d media, %d face detections, %d tracks",
                len(annotations), n_faces, n_tracks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
