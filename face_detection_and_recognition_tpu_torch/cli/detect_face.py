"""Face detection on an image file: the port's ``detect_face`` CLI.

The counterpart of ``cli/detect_face.py`` in the JAX package, for the
detectors the port registers (yolov5s, yolov5n, yolov5n-0.5,
blazeface-front, blazeface-back) and JPEG images:

    python -m face_detection_and_recognition_tpu_torch.cli.detect_face \\
        -i img.jpg --md yolov5s --dt 0.7 --at 0.12 --no-display -o out.jpg

It prints ``N face(s)``, then one ``[x1,y1,x2,y2] conf=...`` line a face,
with the age/gender label (``--age-gender``) and ``emb[Dd]``
(``--embedder``) appended, as the JAX CLI does. It runs on the card unless
``-d cpu`` is given. ``--ckpt`` loads detector weights from a torch ``.pt``
/ ``.pth`` state dict; ``--embed-ckpt`` and ``--ag-ckpt`` load the
embedder's and the age/gender heads'. Without them the weights are random,
drawn from a seed. There is no display window (``--no-display`` is
required) and no video or camera input.
"""
from __future__ import annotations

import sys

from ..core.engine import EngineConfig, FaceEngine
from ..core.inference import NO_VIDEO, NO_WINDOW, inference_img
from ..models import registry
from ..utils.files import get_file_type
from ..utils.native import read_image_bgr
from ..utils.parser import get_argparse


def build_engine(args) -> FaceEngine:
    cfg = EngineConfig(
        detector=args.model,
        det_thres=args.det_thres,
        bbox_area_thres=args.bbox_area_thres,
        with_age_gender=getattr(args, "age_gender", False),
        embedder=getattr(args, "embedder", None),
        rect=getattr(args, "rect", False),
    )
    engine = FaceEngine(cfg, device=args.device)
    if getattr(args, "ckpt", None):
        engine.load_weights(args.ckpt)
    if getattr(args, "embed_ckpt", None):
        engine.load_embed_weights(args.embed_ckpt)
    if getattr(args, "ag_ckpt", None):
        engine.load_age_gender_weights(args.ag_ckpt)
    return engine


def main(argv=None) -> int:
    parser = get_argparse(
        description="Face detection on the card (PyTorch/CUDA port)")
    parser.add_argument("--age-gender", dest="age_gender",
                        action="store_true",
                        help="Attach age+gender labels.")
    parser.add_argument("--ckpt", "--weights", dest="ckpt", default=None,
                        help="Detector weights: a torch .pt/.pth state "
                             "dict.")
    parser.add_argument("--embedder", dest="embedder", default=None,
                        help="Also embed each detected face (registry name, "
                             "e.g. mobile_facenet) and report the vector "
                             "dim.")
    parser.add_argument("--embed-ckpt", dest="embed_ckpt", default=None,
                        help="Embedder weights: a torch .pt/.pth state "
                             "dict.")
    parser.add_argument("--ag-ckpt", dest="ag_ckpt", default=None,
                        help="Age/gender weights: a torch .pt/.pth state "
                             "dict of both heads.")
    parser.add_argument("--rect", action="store_true",
                        help="Rect letterbox inference (yolov5 families): "
                             "the smallest stride-multiple canvas per "
                             "source resolution.")
    args = parser.parse_args(argv)

    if args.model not in registry.available():
        print(f"unknown model '{args.model}'. available: "
              f"{', '.join(registry.available())}", file=sys.stderr)
        return 2
    ftype = get_file_type(args.input_src)
    if ftype in ("video", "camera"):
        print(f"cannot read {args.input_src}: {NO_VIDEO}", file=sys.stderr)
        return 2
    if ftype != "image":
        print(f"cannot determine input type of {args.input_src}",
              file=sys.stderr)
        return 2
    if not args.no_display:
        print(NO_WINDOW, file=sys.stderr)
        return 2

    engine = build_engine(args)
    post = inference_img(engine, args.input_src, output=args.output,
                         display=False, age_gender=args.age_gender)
    print(f"{len(post.boxes)} face(s)")
    emb = None
    if args.embedder and len(post.boxes):
        emb = engine.embed_faces(read_image_bgr(args.input_src), post.boxes)
    for i, (box, conf) in enumerate(zip(post.boxes, post.bbox_confs)):
        lbl = f" {post.bbox_labels[i]}" if post.bbox_labels else ""
        if emb is not None:
            lbl += f" emb[{emb.shape[1]}d]"
        print(f"  [{int(box[0])},{int(box[1])},{int(box[2])},{int(box[3])}]"
              f" conf={conf:.3f}{lbl}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
