"""Executed int8 accuracy: quantize the trained golden checkpoint and
regate.

The counterpart of ``cli/quantize_golden.py`` in the JAX package: the f32
golden detector (a ``.pt``) is folded and quantized per channel to int8
(``utils/quantize.py``), its static per-tensor activation scales calibrated
on golden composites preprocessed as the engine feeds yolov5 (a square
canvas: BGR -> RGB, / 255), the int8 ``.pt`` written, and the golden gate
(3 faces at IoU >= 0.5 against the pinned boxes, none on the 0-face image)
and the held-out composite AP run again through a ``quantized="static"``
engine. The JAX flags, and ``-d/--device`` (the card unless ``-d cpu``).

    python -m face_detection_and_recognition_tpu_torch.cli.quantize_golden \\
        --ckpt card_weights/yolov5n.pt --out yolov5n_int8.pt

Exit code 0 only when the int8 gate passes.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile

import numpy as np
import torch

from ..eval.card_weights import CARD_WEIGHTS
from ..utils.parser import add_device_flag


def calibration_batches(work_dir: str, input_size: int, n_images: int,
                        batch: int, seed: int):
    """Golden composites preprocessed as the engine feeds yolov5: [B, S, S,
    3] f32 RGB in [0, 1] host tensors."""
    from ..train.data import imread
    from ..train.golden import make_composite_dataset

    _, images_root = make_composite_dataset(
        os.path.join(work_dir, "calib_ds"), n_images=n_images,
        out_wh=(input_size, input_size), seed=seed)
    paths = sorted(glob.glob(
        os.path.join(images_root, "**", "*.jpg"), recursive=True))[:n_images]
    if not paths:
        raise FileNotFoundError(f"no calibration jpgs under {images_root}")
    imgs = np.stack([imread(p)[..., ::-1].astype(np.float32) / 255.0
                     for p in paths])
    return [torch.from_numpy(imgs[i:i + batch])
            for i in range(0, len(imgs), batch)]


def quantize_checkpoint(ckpt_in: str, ckpt_out: str, arch: str,
                        input_size: int, work_dir: str, n_calib: int = 32,
                        batch: int = 8, seed: int = 515, device=None,
                        log=print):
    """f32 golden ``.pt`` -> static-calibrated int8 ``.pt``; returns the
    calibrated scales ({quantized module path: scale})."""
    from ..core.engine import _full_f32, read_state_dict
    from ..models.yolov5_face import YoloV5FaceNet
    from ..ops.platform import resolve_device
    from ..utils.quantize import (calibrate_activation_scales,
                                  pour_activation_scales, quantize_state_dict)

    dev = resolve_device(device)
    sd = {k: v for k, v in read_state_dict(ckpt_in).items()
          if not k.endswith((".anchors", ".anchor_grid"))}
    net = YoloV5FaceNet(arch)
    net.load_state_dict(sd)
    net = net.to(device=dev, memory_format=torch.channels_last).eval()
    batches = calibration_batches(work_dir, input_size, n_calib, batch, seed)
    log(f"[int8] calibrating activation scales on {n_calib} composites")
    with _full_f32(dev):
        scales = calibrate_activation_scales(net, batches)
    torch.save(pour_activation_scales(quantize_state_dict(sd), scales),
               ckpt_out)
    log(f"[int8] wrote {ckpt_out} ({len(scales)} calibrated ConvBN scales)")
    return scales


def evaluate_int8(ckpt: str, arch: str, input_size: int, work_dir: str,
                  device=None, log=print):
    """Golden gate + holdout AP through a quantized="static" engine."""
    from ..core.engine import EngineConfig, FaceEngine
    from ..train.golden import evaluate_golden, evaluate_holdout_ap

    eng = FaceEngine(EngineConfig(
        detector=arch, det_thres=0.5,
        detector_overrides={"input_size": (input_size, input_size),
                            "quantized": "static"}), device=device)
    eng.load_weights(ckpt)
    r = evaluate_golden(eng)
    log(f"[int8] golden gate: ok={r['ok']} n_pos={r['n_pos']} "
        f"n_neg={r['n_neg']} ious={['%.3f' % i for i in r['ious']]}")
    ap = None
    if r["ok"]:
        ap = evaluate_holdout_ap(eng, work_dir, input_size=input_size)
        log(f"[int8] holdout AP50={ap['AP50']:.3f} AP={ap['AP']:.3f} "
            f"AR={ap['AR']:.3f}")
    return r, ap


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", default=str(CARD_WEIGHTS / "yolov5n.pt"),
                    help="trained f32 golden checkpoint (.pt)")
    ap.add_argument("--out", default="yolov5n_int8.pt")
    ap.add_argument("--arch", default="yolov5n")
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--calib-images", type=int, default=32)
    ap.add_argument("--work-dir", default=None)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    work = args.work_dir or tempfile.mkdtemp(prefix="int8_golden_")
    quantize_checkpoint(args.ckpt, args.out, args.arch, args.size, work,
                        n_calib=args.calib_images, device=args.device)
    r, _ = evaluate_int8(args.out, args.arch, args.size, work,
                         device=args.device)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
