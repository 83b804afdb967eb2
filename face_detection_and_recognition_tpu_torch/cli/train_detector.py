"""CLI: fine-tune a yolov5-face detector on WIDER-format data.

The counterpart of ``cli/train_detector.py`` in the JAX package: the same
flags, and ``-d/--device`` (the card unless ``-d cpu``); batches stream
from the host (``train/data.wider_batches``) into ``make_det_train_step``.
``--out`` writes the net's state dict as a ``.pt`` (what
``FaceEngine.load_weights`` reads).

    python -m face_detection_and_recognition_tpu_torch.cli.train_detector \\
        --ann wider_face_split/wider_face_train_bbx_gt.txt \\
        --images WIDER_train/images --arch yolov5n --steps 500 \\
        --out yolov5n.pt
"""
from __future__ import annotations

import argparse
import time

import torch

from ..utils.parser import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--arch", default="yolov5n")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--max-targets", type=int, default=64)
    ap.add_argument("--out", default=None, help="checkpoint output path")
    ap.add_argument("--log-every", type=int, default=20)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..train.data import load_wider_index, wider_batches
    from ..train.detection import (DetTrainConfig, create_det_train_state,
                                   make_det_train_step)
    from ..utils.logging_utils import setup_job_logger

    logger = setup_job_logger("train_detector")
    cfg = DetTrainConfig(arch=args.arch, input_size=(args.size, args.size),
                         max_targets=args.max_targets, lr=args.lr)
    state = create_det_train_state(cfg, torch.Generator().manual_seed(0),
                                   args.device)
    step = make_det_train_step(state)
    dev = state["device"]

    index = load_wider_index(args.ann, args.images)
    logger.info("training %s on %d images", args.arch, len(index))
    it = wider_batches(index, args.batch, (args.size, args.size),
                       args.max_targets, epochs=args.epochs)
    t0 = time.time()
    for i, (images, targets, valid) in enumerate(it):
        if i >= args.steps:
            break
        loss, metrics = step(torch.from_numpy(images).to(dev),
                             torch.from_numpy(targets).to(dev),
                             torch.from_numpy(valid).to(dev))
        if i % args.log_every == 0:
            logger.info(
                "step %d loss %.4f (box %.3f obj %.3f lmk %.3f cls %.3f) "
                "%.1f img/s", i, float(loss), float(metrics["box"]),
                float(metrics["obj"]), float(metrics["lmk"]),
                float(metrics["cls"]),
                args.batch * (i + 1) / (time.time() - t0))
    if args.out:
        torch.save(state["net"].state_dict(), args.out)
        logger.info("saved checkpoint to %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
