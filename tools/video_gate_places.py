"""Where on an 8-pixel lattice the golden gate holds for ``chip_smoke.py``'s
video clip, on the CPU.

    python tools/video_gate_places.py [--dx 0 8 16 24] [--threads 4]

``chip_smoke.py``'s video phase places the golden image, scaled to the
576x1024 frame's width (the golden gate's own letterbox scale), moved
``dx`` columns right and cut at row ``top`` (0 to 192, in steps of 8), over
its seeded background, and the negative image the same way. This script
runs yolov5s with ``card_weights/yolov5s.pt`` through the port on the CPU
on each place's frame after a JPEG round trip (as the clip stores it), and
prints one line a place: whether the gate of ``expected.json`` holds (at
its three thresholds, 3 faces at its IoU and none on the negative frame;
at its centre, the IoU bars), the least IoU at the centre, and the third
face's confidence, which the gate's upper threshold must not pass. The
phase's ``VIDEO_PLACES`` are places where it holds with room to spare.
Then a count of the places where it holds.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from face_detection_and_recognition_tpu_torch.core.engine import (  # noqa
    EngineConfig, FaceEngine)
from face_detection_and_recognition_tpu_torch.eval import \
    card_weights as CW  # noqa: E402
from face_detection_and_recognition_tpu_torch.utils.native import (  # noqa
    decode_jpeg_bgr, encode_jpeg_bgr)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dx", type=int, nargs="+", default=[0, 8, 16, 24])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    gate = CW.load_expected()["nets"]["yolov5s"]["gate"]
    lowest = min(CW.gate_thresholds(gate))
    eng = FaceEngine(EngineConfig(detector="yolov5s", det_thres=lowest),
                     device="cpu")
    eng.load_weights(str(CW.CARD_WEIGHTS / "yolov5s.pt"))
    big, big_neg, golden = cs.gate_images()
    background = cs.smooth_frame(cs.SEED + 7)
    places = [(dx, top) for top in range(0, 193, 8) for dx in args.dx]

    def detect(image):
        frames = [decode_jpeg_bgr(encode_jpeg_bgr(
            cs.placed(image, background, dx, top))) for dx, top in places]
        return [p for k in range(0, len(frames), 8)
                for p in eng.detect_batch(np.stack(frames[k:k + 8]))
                .to_numpy()]

    # the engine ran at the lowest threshold: a higher one keeps the faces
    # whose confidence reaches it (NMS keeps a box by higher scores only)
    def at(post, t):
        conf = np.asarray(post.bbox_confs, np.float32).reshape(-1)
        return np.asarray(post.boxes, np.float32).reshape(-1, 4)[conf >= t]

    held = 0
    for (dx, top), pos, neg in zip(places, detect(big), detect(big_neg)):
        thresholds = CW.gate_thresholds(gate)
        bad, iou = cs.place_gate(
            gate, golden + np.array([dx, -top, dx, -top], np.float32),
            {t: at(pos, t) for t in thresholds},
            {t: len(at(neg, t)) for t in thresholds})
        held += not bad
        conf = np.sort(np.asarray(pos.bbox_confs, np.float32))[::-1]
        third = float(conf[2]) if len(conf) > 2 else 0.0
        print(f"dx {dx:3d} top {top:3d}: {'holds' if not bad else 'fails'}"
              f"  least IoU {iou:.3f}  third confidence {third:.3f}  "
              f"{'; '.join(bad)}")
    print(f"the gate holds at {held} of {len(places)} places")


if __name__ == "__main__":
    main()
