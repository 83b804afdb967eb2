"""CLI: IMDB-WIKI face extraction + cleaning.

The counterpart of ``cli/extract_imdb_wiki.py`` in the JAX package, the
reference's ``face_extraction/extract_and_clean_imdb_wiki_faces.py`` entry
point (``:259-276``): parse the dataset's .mat metadata, apply the cleaning
filter (age in [0,100], gender non-nan, exactly one face, det_score >=
thres) with removal-reason counts, then detect + crop + embed the kept
images into one ``data.npy`` of per-image records. It runs on the card
unless ``-d cpu`` is given; ``--ckpt`` and ``--embed-ckpt`` take torch
``.pt`` / ``.pth`` state dicts.

    python -m face_detection_and_recognition_tpu_torch.cli.extract_imdb_wiki \\
        --mat wiki.mat --db wiki -i wiki_images/ -o wiki_out/ --md yolov5s
"""
from __future__ import annotations

import argparse
import json
import os

from ..core.engine import EngineConfig, FaceEngine
from ..models import registry
from ..models.embedders import available_embedders
from ..pipelines.imdb_wiki import (clean_imdb_wiki, extract_imdb_wiki_faces,
                                   load_imdb_wiki_metadata)
from ..utils.logging_utils import setup_job_logger
from ..utils.parser import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mat", required=True, help="wiki.mat / imdb.mat path")
    ap.add_argument("--db", default="wiki", choices=("wiki", "imdb"),
                    help="metadata key inside the .mat")
    ap.add_argument("-i", "--images", required=True,
                    help="image root the .mat's full_path entries resolve in")
    ap.add_argument("-o", "--output_dir", required=True)
    ap.add_argument("--md", "--model_det", dest="model", default="yolov5s",
                    choices=registry.available())
    ap.add_argument("--mf", "--model_feat", dest="feat_net",
                    default="mobile_facenet", choices=available_embedders())
    ap.add_argument("--dt", dest="det_thres", type=float, default=0.70)
    ap.add_argument("--score", dest="det_score_thres", type=float,
                    default=0.8, help="metadata face_score cleaning floor")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ckpt", default=None,
                    help="detector weights (a torch .pt/.pth state dict)")
    ap.add_argument("--embed-ckpt", default=None,
                    help="embedder weights (a torch .pt/.pth state dict)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    logger = setup_job_logger("imdb_wiki_extraction")
    meta = load_imdb_wiki_metadata(args.mat, db=args.db)
    keep_idx, report = clean_imdb_wiki(
        meta, det_score_thres=args.det_score_thres)
    logger.info("metadata: %d kept / %d total, removed: %s",
                report.kept, len(meta["full_path"]), report.removed)

    engine = FaceEngine(EngineConfig(
        detector=args.model, det_thres=args.det_thres,
        bbox_area_thres=0.0, embedder=args.feat_net,
    ), device=args.device)
    if args.ckpt:
        engine.load_weights(args.ckpt)
    if args.embed_ckpt:
        engine.load_embed_weights(args.embed_ckpt)

    n = extract_imdb_wiki_faces(
        engine, meta, keep_idx, args.images, args.output_dir,
        limit=args.limit, batch_size=args.batch,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    # removal-reason metadata next to data.npy (reference :183-255)
    with open(os.path.join(args.output_dir, "cleaning_metadata.json"),
              "w") as f:
        json.dump({"kept_metadata": report.kept, "removed": report.removed,
                   "records_written": n}, f, indent=2)
    logger.info("done: %d records -> %s/data.npy", n, args.output_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
