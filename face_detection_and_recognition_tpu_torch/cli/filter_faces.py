"""CLI: similar-face filtering against per-class reference images.

The counterpart of ``cli/filter_faces.py`` in the JAX package, the
reference's ``similar_face_filtering/filter_faces_using_reference.py``:
builds a mean embedding + max-distance threshold per class from reference
images and routes unfiltered images into clean/unclean. Images of one size
are resized to the embedder's input on the device (``resize_bilinear``, as
the JAX CLI's jit does); a batch of mixed sizes is first resized on the
host (``host_resize``, cv2's INTER_LINEAR). A file that does not decode
embeds as a blank image, as in the JAX CLI. It runs on the card unless
``-d cpu`` is given.

``-m`` takes the embedder's weights as the JAX CLI does: a keras FaceNet
SavedModel directory (the reference's ``models/facenet/facenet_keras_p38``)
or ``.h5`` file, or, in place of the JAX CLI's orbax checkpoint, a torch
``.pt`` / ``.pth`` state dict (``FaceEngine.load_embed_weights``).

    python -m face_detection_and_recognition_tpu_torch.cli.filter_faces \\
        --data_dir data/ -r refs/ -t out/ --embedder facenet
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.engine import EngineConfig, FaceEngine
from ..ops.geometry import host_resize
from ..pipelines.similarity import SimilarFaceFilter
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr
from ..utils.parser import add_device_flag

def _read(path: str):
    """The image at ``path``, or None where cv2.imread would give None."""
    try:
        return read_image_bgr(path, formats=IMAGE_EXTENSIONS)
    except ValueError:  # a format the port does not read
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    # -d is the JAX CLI's --data_dir; the device flag is --device alone
    ap.add_argument("-d", "--data_dir", required=True)
    ap.add_argument("-r", "--ref_dir", required=True)
    ap.add_argument("-t", "--target_dir", required=True)
    ap.add_argument("--embedder", default="facenet",
                    help="embedder registry name (reference uses 128-d facenet)")
    ap.add_argument("-m", "--savedmodel_path", default=None,
                    help="embedder weights: a keras SavedModel dir (the "
                         "reference's models/facenet/facenet_keras_p38), a "
                         ".h5, or a torch .pt/.pth state dict")
    ap.add_argument("--batch", type=int, default=32)
    add_device_flag(ap, ("--device",))
    args = ap.parse_args(argv)

    path = args.savedmodel_path
    engine = FaceEngine(EngineConfig(detector="blazeface-front",
                                     embedder=args.embedder),
                        device=args.device)
    if path:
        engine.load_embed_weights(path)
    ew, eh = engine.embed_spec.input_size

    def embed_paths(paths):
        imgs = []
        for p in paths:
            img = _read(p)
            imgs.append(img if img is not None
                        else np.zeros_like(imgs[0]) if imgs
                        else np.zeros((eh, ew, 3), np.uint8))
        if len({i.shape for i in imgs}) > 1:  # mixed sizes: host resize once
            imgs = [host_resize(i, (ew, eh)) for i in imgs]
        return engine.embed_crops(np.stack(imgs))

    job = SimilarFaceFilter(embed_paths, batch_size=args.batch,
                            device=args.device)
    res = job.run(args.data_dir, args.ref_dir, args.target_dir)
    for cls, (clean, total) in sorted(res.items()):
        print(f"{cls}: {clean}/{total} clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
