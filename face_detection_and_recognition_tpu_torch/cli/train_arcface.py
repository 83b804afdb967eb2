"""CLI: train an embedder with ArcFace on a tree of face crops.

The counterpart of ``cli/train_arcface.py`` in the JAX package. Dataset
layout: ``data_dir/identity_x/*.jpg`` (a directory an identity; crops of
any size, resized to 112x112 with ``ops.geometry.host_resize``, the
cv2.resize slot, and normalized ``(x - 127.5) / 127.5``). The JAX flags,
and ``-d/--device`` (the card unless ``-d cpu``); ``--out`` writes a
``.pt`` holding the net's state dict (``state_dict``, what
``FaceEngine.load_embed_weights`` reads) and the class kernel
(``arcface_kernel``). ``--mesh`` trains data-parallel over "data" with
the class kernel split over "model" (2 when the card count is even)
across every card; with one device it is the plain step, as the JAX CLI's
rule has it.

    python -m face_detection_and_recognition_tpu_torch.cli.train_arcface \\
        -i identities/ --steps 1000 --batch 64 --out mobileface.pt
"""
from __future__ import annotations

import argparse
import glob
import itertools
import os
import random
import time

import numpy as np
import torch

from ..ops.geometry import host_resize
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr
from ..utils.parser import add_device_flag


def iter_crop_batches(data_dir: str, batch: int, epochs: int, seed: int = 0):
    """(crops [B, 112, 112, 3] normalized f32, labels [B], class count)
    batches over the tree, each epoch in a ``random.Random(seed)``
    shuffle; unreadable files are skipped."""
    classes = sorted(d for d in glob.glob(os.path.join(data_dir, "*"))
                     if os.path.isdir(d))
    samples = []
    for label, cls in enumerate(classes):
        for p in sorted(glob.glob(os.path.join(cls, "*"))):
            if os.path.splitext(p)[1].lower() in (".jpg", ".jpeg", ".png"):
                samples.append((p, label))
    rng = random.Random(seed)
    for _ in range(epochs):
        rng.shuffle(samples)
        xs, ys = [], []
        for p, label in samples:
            img = read_image_bgr(p, IMAGE_EXTENSIONS)
            if img is None:
                continue
            img = host_resize(img, (112, 112))
            xs.append((img.astype(np.float32) - 127.5) / 127.5)
            ys.append(label)
            if len(xs) == batch:
                yield np.stack(xs), np.asarray(ys), len(classes)
                xs, ys = [], []


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--data_dir", required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--embedding-size", type=int, default=512)
    ap.add_argument("--out", default=None, help="checkpoint output (.pt)")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--mesh", action="store_true",
                    help="DP + TP over all devices")
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..train.arcface import (ArcFaceTrainConfig, create_train_state,
                                 gather_train_state, make_train_step,
                                 sharded_train_step)
    from ..utils.logging_utils import setup_job_logger

    logger = setup_job_logger("train_arcface")
    it = iter_crop_batches(args.data_dir, args.batch, args.epochs)
    first = next(it, None)
    if first is None:
        logger.error("no training samples under %s", args.data_dir)
        return 2
    cfg = ArcFaceTrainConfig(num_classes=first[2],
                             embedding_size=args.embedding_size, lr=args.lr)
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device=args.device)
    devices = []
    if args.mesh:
        from ..parallel.mesh import make_mesh, mesh_devices

        devices = mesh_devices(args.device)
    mesh = None
    if len(devices) > 1:
        n = len(devices)
        model_axis = 2 if n % 2 == 0 else 1
        mesh = make_mesh(("data", "model"), (n // model_axis, model_axis),
                         devices)
        step, replicas = sharded_train_step(state, mesh)
    else:
        step = make_train_step(state)
    dev = state["device"]
    t0 = time.time()
    for i, (images, labels, _) in enumerate(itertools.chain([first], it)):
        if i >= args.steps:
            break
        loss = step(torch.from_numpy(images).to(dev),
                    torch.from_numpy(labels).to(dev))
        if i % args.log_every == 0:
            logger.info("step %d loss %.4f %.1f img/s", i, float(loss),
                        args.batch * (i + 1) / (time.time() - t0))
    if args.out:
        kernel = state["arcface_kernel"]
        if mesh is not None:  # the net trained in place; the kernel shards
            kernel = gather_train_state(replicas, mesh)["arcface_kernel"]
        torch.save({"state_dict": state["net"].state_dict(),
                    "arcface_kernel": kernel.detach().cpu()}, args.out)
        logger.info("saved %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
