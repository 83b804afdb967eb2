"""Inference entry points: one image through a FaceEngine, annotated and
written.

The counterpart of ``core/inference.py`` in the JAX package (the reference's
``modules/utils/inference.py``), with the image path only: decode (the
port's JPEG codec, ``utils/native.py``), detect or detect + age/gender,
draw, write. The port has no display window, and no video or camera
decoder: ``display=True`` raises, and so do ``inference_vid`` and
``inference_webcam``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.draw import draw_bbox_on_image
from ..utils.native import read_image_bgr, write_image_bgr
from .detections import PostProcessedDetection
from .engine import FaceEngine

NO_WINDOW = ("the port has no display window: pass display=False "
             "(--no-display on the command line) and write the result with "
             "output= (-o)")
NO_VIDEO = ("the port has no video or camera decoder (the JAX package reads "
            "frames with cv2.VideoCapture); only JPEG images are supported")


def annotate(img: np.ndarray, post: PostProcessedDetection) -> np.ndarray:
    return draw_bbox_on_image(img, post)


def inference_img(
    engine: FaceEngine,
    img,
    wname: str = "Output",
    waitKey_val: int = 0,
    output: Optional[str] = None,
    display: bool = True,
    age_gender: bool = False,
) -> PostProcessedDetection:
    """Run detection (+ optional age/gender) on one image (a JPEG path or a
    BGR uint8 array, drawn on in place), draw, and write ``output``.
    ``wname`` and ``waitKey_val`` are the JAX signature's window arguments;
    ``display`` must be False."""
    if display:
        raise RuntimeError(NO_WINDOW)
    if isinstance(img, str):
        if not os.path.exists(img):
            raise FileNotFoundError(f"{img} does not exist")
        image = read_image_bgr(img)
        if image is None:  # exists but not a JPEG the route decodes
            raise ValueError(f"cannot decode image: {img}")
    elif isinstance(img, np.ndarray):
        image = img
    else:
        raise ValueError("image cannot be read")

    post = (engine.detect_age_gender(image) if age_gender
            else engine.detect_image(image))
    annotate(image, post)
    if output:
        write_image_bgr(output, image)
    return post


def inference_vid(engine: FaceEngine, vid, *args, **kwargs):
    """Not available: the port has no video decoder."""
    raise NotImplementedError(NO_VIDEO)


def inference_webcam(engine: FaceEngine, cam_index: int, *args, **kwargs):
    """Not available: the port has no camera decoder."""
    raise NotImplementedError(NO_VIDEO)
