"""Drawing without cv2: boxes, landmarks and labels on BGR uint8 images, in
numpy.

The counterpart of ``utils/draw.py`` in the JAX package (the reference's
``draw_bbox_on_image``): red boxes, red landmark circles of radius 3, and a
label per box over an alpha-blended dark background, at the JAX version's
pixel coordinates. What differs:

- lines are drawn solid, without cv2's anti-aliasing;
- the label is drawn in a 5x7 bitmap font of the port's own (digits and
  the characters of the confidence and age/gender labels; others leave a
  blank cell), in place of cv2's anti-aliased Hershey font, so the label
  background's width and height follow this font's metrics; its corner
  at (box x1 - 1, box y1) is the JAX version's.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

RED = (0, 0, 255)      # BGR
WHITE = (255, 255, 255)

# cv2.circle(radius=3, thickness=1)'s pixels, as offsets from the centre
_RING3 = tuple((dx, dy) for dx, dy in (
    (0, -3), (-1, -2), (1, -2), (-2, -2), (2, -2), (-2, -1), (2, -1),
    (-3, 0), (3, 0), (-2, 1), (2, 1), (-2, 2), (2, 2), (-1, 2), (1, 2),
    (0, 3)))

# 5x7 glyphs, one string of 7 rows of 5 bits each
_FONT = {
    "0": "01110 10001 10011 10101 11001 10001 01110",
    "1": "00100 01100 00100 00100 00100 00100 01110",
    "2": "01110 10001 00001 00010 00100 01000 11111",
    "3": "11110 00001 00001 01110 00001 00001 11110",
    "4": "00010 00110 01010 10010 11111 00010 00010",
    "5": "11111 10000 11110 00001 00001 10001 01110",
    "6": "00110 01000 10000 11110 10001 10001 01110",
    "7": "11111 00001 00010 00100 01000 01000 01000",
    "8": "01110 10001 10001 01110 10001 10001 01110",
    "9": "01110 10001 10001 01111 00001 00010 01100",
    ".": "00000 00000 00000 00000 00000 01100 01100",
    ",": "00000 00000 00000 00000 01100 00100 01000",
    ":": "00000 01100 01100 00000 01100 01100 00000",
    "_": "00000 00000 00000 00000 00000 00000 11111",
    "-": "00000 00000 00000 11111 00000 00000 00000",
    "(": "00010 00100 01000 01000 01000 00100 00010",
    ")": "01000 00100 00010 00010 00010 00100 01000",
    "M": "10001 11011 10101 10101 10001 10001 10001",
    "F": "11111 10000 10000 11110 10000 10000 10000",
    "a": "00000 00000 01110 00001 01111 10001 01111",
    "e": "00000 00000 01110 10001 11111 10000 01110",
    "l": "01100 00100 00100 00100 00100 00100 01110",
}
_GLYPHS = {c: np.array([[b == "1" for b in row] for row in rows.split()])
           for c, rows in _FONT.items()}
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def text_size(label: str, scale: int) -> Tuple[int, int]:
    """(width, height) in pixels of ``label`` at integer ``scale``."""
    return ADVANCE * scale * len(label), GLYPH_H * scale


def put_text(img: np.ndarray, label: str, org: Tuple[int, int], scale: int,
             color=WHITE) -> None:
    """Draw ``label`` with its baseline's left end at ``org`` = (x, y),
    clipped to the image."""
    h, w = img.shape[:2]
    x0, y0 = org[0], org[1] - GLYPH_H * scale + 1
    for i, ch in enumerate(label):
        glyph = _GLYPHS.get(ch)
        if glyph is None:
            continue
        mask = np.kron(glyph, np.ones((scale, scale), bool))
        gx = x0 + i * ADVANCE * scale
        ys, xs = np.nonzero(mask)
        ys, xs = ys + y0, xs + gx
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color


def _rectangle(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
               thickness: int, color=RED) -> None:
    """Outline of [x1, x2] x [y1, y2], each edge a band of
    ``thickness // 2`` pixels either side, clipped to the image."""
    h, w = img.shape[:2]
    r = thickness // 2

    def fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h - 1)
        xa, xb = max(xa, 0), min(xb, w - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    fill(y1 - r, y1 + r, x1 - r, x2 + r)
    fill(y2 - r, y2 + r, x1 - r, x2 + r)
    fill(y1 - r, y2 + r, x1 - r, x1 + r)
    fill(y1 - r, y2 + r, x2 - r, x2 + r)


def _circle3(img: np.ndarray, cx: int, cy: int, color=RED) -> None:
    h, w = img.shape[:2]
    for dx, dy in _RING3:
        x, y = cx + dx, cy + dy
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def draw_bbox_on_image(img: np.ndarray, post_dets,
                       line_thickness: int = None,
                       text_bg_alpha: float = 0.5) -> np.ndarray:
    """Draw ``post_dets`` (a ``PostProcessedDetection``) on the BGR uint8
    ``img`` in place and return it: a red box per detection, its landmarks
    as red circles, and a 'conf_area' label (with the age/gender label
    appended when there is one) over a background darkened by
    ``text_bg_alpha`` (0: a black box)."""
    boxes = post_dets.boxes
    confs = post_dets.bbox_confs
    areas = post_dets.bbox_areas
    lmarks = post_dets.bbox_lmarks
    labels = post_dets.bbox_labels
    h, w = img.shape[:2]
    tl = line_thickness or round(0.002 * (w + h) / 2) + 1
    scale = max(1, round(tl / 2))

    for i, box in enumerate(boxes):
        label = (f"{confs[i]:.2f}" if areas is None
                 else f"{confs[i]:.2f}_{areas[i]:.2f}")
        x1, y1, x2, y2 = (int(v) for v in box[:4])
        x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
        _rectangle(img, x1, y1, x2, y2, max(int((w + h) / 600), 1))
        if lmarks is not None and len(lmarks) and np.asarray(lmarks[i]).size:
            lm = np.asarray(lmarks[i])
            for li in range(0, lm.size - 1, 2):
                _circle3(img, int(lm[li]), int(lm[li + 1]))
        if labels:
            label += str(labels[i])
        tw, th = text_size(label, scale)
        y_min = max(0, int(y1 - th - 3))
        x_max = min(w, int(x1 + tw))
        x_min = max(0, int(x1 - 1))
        roi = img[y_min:y1, x_min:x_max]
        img[y_min:y1, x_min:x_max] = (roi * text_bg_alpha).astype(img.dtype)
        put_text(img, label, (x1 + 3, y1 - 4), scale)
    return img


_COLOR_STEPS = (255, 128, 192, 64, 32, 96, 160, 224)


def get_distinct_rgb_color(index: int) -> Tuple[int, int, int]:
    """The 56-color distinct palette, cycling: for each intensity step v,
    (v,0,0), (0,v,0), (0,0,v), (v,v,0), (v,0,v), (0,v,v), (v,v,v)."""
    patterns = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
                (0, 1, 1), (1, 1, 1))
    total = len(_COLOR_STEPS) * len(patterns)
    index %= total
    v = _COLOR_STEPS[index // len(patterns)]
    p = patterns[index % len(patterns)]
    return (v * p[0], v * p[1], v * p[2])
