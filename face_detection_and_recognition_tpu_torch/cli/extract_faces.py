"""CLI: batch face extraction from a class-organized dataset.

The counterpart of ``cli/extract_faces.py`` in the JAX package, the
reference's ``face_extraction/extract_faces_from_dataset.py`` entry point
(pluggable detector x embedder, crop + feature outputs, resume). It runs on
the card unless ``-d cpu`` is given; weights are random, drawn from a seed,
as the JAX CLI's are. ``--mesh`` splits each block over a device mesh's
"data" axis of every card.

    python -m face_detection_and_recognition_tpu_torch.cli.extract_faces \\
        -i dataset/ -o faces_out/ --md yolov5s --fd mobile_facenet
"""
from __future__ import annotations

import argparse

from ..core.engine import EngineConfig, FaceEngine
from ..models import registry
from ..models.embedders import available_embedders
from ..pipelines.extract_faces import extract_faces_from_dataset
from ..utils.logging_utils import setup_job_logger
from ..utils.parser import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input_dir", required=True,
                    help="dataset root with one-level class dirs")
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("--md", "--model", dest="model", default="yolov5s",
                    choices=registry.available())
    ap.add_argument("--fd", "--feat_net", dest="feat_net",
                    default="mobile_facenet",
                    choices=available_embedders() + ["none"])
    ap.add_argument("--dt", dest="det_thres", type=float, default=0.70)
    ap.add_argument("--at", dest="bbox_area_thres", type=float, default=0.12)
    ap.add_argument("--no-crops", action="store_true")
    ap.add_argument("--no-features", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--block", type=int, default=64,
                    help="frames per fused device block")
    ap.add_argument("--mesh", action="store_true",
                    help="shard blocks over all devices")
    ap.add_argument("--rect", action="store_true",
                    help="rect letterbox inference (yolov5 families)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    logger = setup_job_logger("face_extraction")
    embedder = None if (args.feat_net == "none" or args.no_features) else args.feat_net
    engine = FaceEngine(EngineConfig(
        detector=args.model, det_thres=args.det_thres,
        bbox_area_thres=args.bbox_area_thres, embedder=embedder,
        rect=args.rect,
    ), device=args.device)
    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_mesh, mesh_devices

        mesh = make_mesh(("data",), devices=mesh_devices(args.device))
    stats = extract_faces_from_dataset(
        engine, args.input_dir, args.output_dir,
        save_crops=not args.no_crops,
        save_features=embedder is not None,
        num_workers=args.workers,
        resume=not args.no_resume,
        block_size=args.block,
        mesh=mesh,
    )
    logger.info("done: %d faces, %d failures, %.1fs",
                stats.total_faces(), len(stats.failed), stats.wall_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
