"""CLI: feature extraction from an already-cropped face dataset.

The counterpart of ``cli/extract_features.py`` in the JAX package, the
reference's ``face_extraction/extract_features_from_face_dataset.py`` entry
point (``:186-198``): a tree of face-crop images (JPEG, PNG, BMP) ->
per-image ``[D+1]`` feature records ``out/class/stem.npy`` (features +
class label), with the class map from a pickle/json or derived
alphabetically from the directory names (``modules/utils/files.py:51-59``).
It runs on the card unless ``-d cpu`` is given; ``--embed-ckpt`` takes a
torch ``.pt`` / ``.pth`` state dict.

    python -m face_detection_and_recognition_tpu_torch.cli.extract_features \\
        -i face_crops/ -o features_out/ --fd mobile_facenet
"""
from __future__ import annotations

import argparse

from ..core.engine import EngineConfig, FaceEngine
from ..models.embedders import available_embedders
from ..pipelines.extract_features import extract_features_from_face_dataset
from ..utils.logging_utils import setup_job_logger
from ..utils.parser import add_device_flag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input_dir", "-sd", dest="input_dir",
                    required=True, help="face-crop root with class dirs")
    ap.add_argument("-o", "--output_dir", "-td", dest="output_dir",
                    required=True)
    ap.add_argument("--fd", "--feat_net", "-ft", dest="feat_net",
                    default="mobile_facenet", choices=available_embedders())
    ap.add_argument("--class-map", default=None,
                    help="pickle/json class->label map; default: "
                    "alphabetical from dir names")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--embed-ckpt", default=None,
                    help="embedder weights (a torch .pt/.pth state dict)")
    add_device_flag(ap)
    args = ap.parse_args(argv)

    logger = setup_job_logger("feature_extraction")
    # inputs are pre-cropped faces: the embedder is the whole job; the tiny
    # fixed-128px blazeface keeps the (unused) detector slot's build cheap
    engine = FaceEngine(EngineConfig(
        detector="blazeface-front", embedder=args.feat_net,
    ), device=args.device)
    if args.embed_ckpt:
        engine.load_embed_weights(args.embed_ckpt)

    written = extract_features_from_face_dataset(
        engine, args.input_dir, args.output_dir,
        class_map_path=args.class_map, batch_size=args.batch,
        resume=not args.no_resume,
    )
    logger.info("done: %d feature records", written)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
