"""Training data pipeline: WIDER-format annotations -> padded batches, with
the reference recipe's augmentation, on the host in numpy.

The counterpart of ``train/data.py`` in the JAX package, without cv2:
images decode through the port's codec (``utils/native.py``, cv2.imread's
pixels), resize through ``ops.geometry.host_resize`` (cv2.resize's), and
the HSV jitter converts colours as cv2's uint8 ``cvtColor`` does, bit for
bit (``bgr_to_hsv``, ``hsv_to_bgr``). Every random draw comes from an
explicit ``random.Random``, in the JAX package's order, so the same seed
gives the same examples byte for byte.

Images are letterboxed to the train resolution, GT boxes transformed with
the same geometry and padded to ``max_targets`` rows [cx, cy, w, h, lmk
x10] (landmarks -1 = invisible); horizontal flips mirror the landmarks and
swap the left/right eye and mouth slots (face_datasets.py:419-442).
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..eval.coco_eval import parse_wider_annotations
from ..ops.geometry import host_resize, letterbox_params
from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr

GRAY = 125   # the inference letterbox fill (ops/geometry.GRAY_FILL)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Train-time augmentation knobs (reference hyp.scratch defaults)."""
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    fliplr: float = 0.5
    flipud: float = 0.0
    mosaic: float = 1.0
    scale: float = 0.5        # mosaic per-tile scale jitter: U(1-s, 1+s)
    min_box: float = 2.0      # drop GT smaller than this many pixels post-aug


def imread(path: str) -> Optional[np.ndarray]:
    """The ``cv2.imread`` slot: BGR uint8, or None when the file is missing,
    does not decode or is a format the port does not read."""
    try:
        return read_image_bgr(path, formats=IMAGE_EXTENSIONS)
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# cv2's uint8 HSV conversions
# ---------------------------------------------------------------------------

# cv2's division tables (color_hsv: hsv_shift 12, rounded to nearest)
_I = np.arange(256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << 12) / _I[1:])]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << 12) / (6.0 * _I[1:]))]) \
    .astype(np.int64)
# HSV -> BGR: for each sector, the table entries of (b, g, r)
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])
# cv2 converts HSV -> BGR in vector blocks of 32 pixels a row (its x86
# AVX2 build: 4 registers of 8 floats), then the rest of the row one pixel
# at a time, and the two forms round differently
HSV_BLOCK = 32


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` on uint8 BGR [..., 3]: cv2's
    integer arithmetic (H in [0, 180), S and V in [0, 255])."""
    b, g, r = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once (exact in float64 for these operands)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _hsv_tables(h: np.ndarray, s: np.ndarray, v: np.ndarray,
                vector: bool):
    """(the four candidate values [..., 4], the sector) of cv2's HSV -> RGB
    for f32 h (degrees / 2), s and v in [0, 1]: its vector form (truncated
    sector, the sector taken modulo 6 by a multiply) or its per-pixel form
    (``fmod``, ``floor``)."""
    f32, one = np.float32, np.float32(1)
    hs = h * f32(6.0 / 180.0)
    if vector:
        pre = np.trunc(hs).astype(f32)
        f = hs - pre
        sector = pre - np.trunc(pre * f32(1.0 / 6.0)).astype(f32) * f32(6.0)
    else:
        hs = np.fmod(hs, f32(6.0))
        sector = np.floor(hs)
        f = hs - sector
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one),
                    v * _fma(-s, one - f, one)], -1)
    sector = sector.astype(np.int64)
    return tab, np.where((sector < 0) | (sector >= 6), 0, sector)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2BGR)`` on uint8 HSV [H, W, 3], bit for
    bit: f32 arithmetic with fused multiply-adds, s and v scaled by
    f32(1/255); each row's first ``HSV_BLOCK``-multiple of pixels in cv2's
    vector form (truncated to uint8), the rest in its per-pixel form
    (rounded to nearest, s == 0 giving v)."""
    f32 = np.float32
    h = img[..., 0].astype(f32)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    width = img.shape[1]
    nv = width // HSV_BLOCK * HSV_BLOCK
    out = np.empty(img.shape, np.uint8)
    for cols, vector in ((slice(0, nv), True), (slice(nv, width), False)):
        if cols.start == cols.stop:
            continue
        tab, sector = _hsv_tables(h[:, cols], s[:, cols], v[:, cols], vector)
        bgr = np.take_along_axis(tab, _SECTOR[sector], -1) * f32(255.0)
        if vector:
            bgr = np.trunc(bgr)
        else:
            bgr = np.rint(np.where((s[:, cols] == 0)[..., None],
                                   (v[:, cols] * f32(255.0))[..., None], bgr))
        out[:, cols] = np.clip(bgr, 0, 255).astype(np.uint8)
    return out


def augment_hsv(img_bgr: np.ndarray, rng: random.Random,
                hgain: float, sgain: float, vgain: float) -> np.ndarray:
    """Random HSV jitter on a uint8 BGR image (face_datasets.augment_hsv):
    per-channel LUT with gains U(-g, g)+1 applied in HSV space."""
    if hgain == sgain == vgain == 0.0:
        return img_bgr
    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) \
        * np.array([hgain, sgain, vgain]) + 1.0
    hsv = bgr_to_hsv(img_bgr)
    x = np.arange(256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    return hsv_to_bgr(np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]],
                                lut_val[hsv[..., 2]]], -1))


# landmark column pairs to swap on horizontal flip: (left eye <-> right eye),
# (left mouth corner <-> right mouth corner), into the 10-wide lmk block
_LR_SWAP = [((0, 1), (2, 3)), ((6, 7), (8, 9))]


def flip_lr_targets(rows: np.ndarray, img_w: float) -> np.ndarray:
    """Mirror target rows for a horizontal flip: cx -> W - cx, visible
    landmark x -> W - x (invisible -1 kept), then the left/right eye and
    mouth-corner landmarks exchange slots."""
    out = rows.copy()
    out[:, 0] = img_w - rows[:, 0]
    lmk = out[:, 4:14]
    xs = lmk[:, 0::2]
    lmk[:, 0::2] = np.where(xs < 0, -1.0, img_w - xs)
    for (a, b) in _LR_SWAP:
        tmp = lmk[:, [a[0], a[1]]].copy()
        lmk[:, [a[0], a[1]]] = lmk[:, [b[0], b[1]]]
        lmk[:, [b[0], b[1]]] = tmp
    out[:, 4:14] = lmk
    return out


def flip_ud_targets(rows: np.ndarray, img_h: float) -> np.ndarray:
    """Mirror target rows for a vertical flip (no index swap)."""
    out = rows.copy()
    out[:, 1] = img_h - rows[:, 1]
    lmk = out[:, 4:14]
    ys = lmk[:, 1::2]
    lmk[:, 1::2] = np.where(ys < 0, -1.0, img_h - ys)
    out[:, 4:14] = lmk
    return out


def _shift_rows(rows: np.ndarray, s: float, dx: float, dy: float
                ) -> np.ndarray:
    """Scale pixel rows by ``s`` and shift them by (dx, dy); invisible
    landmarks stay -1."""
    r = rows.astype(np.float32).copy()
    r[:, 0] = r[:, 0] * s + dx
    r[:, 1] = r[:, 1] * s + dy
    r[:, 2:4] *= s
    lmk = r[:, 4:14]
    vis = lmk >= 0
    lmk[:, 0::2] = np.where(vis[:, 0::2], lmk[:, 0::2] * s + dx, -1.0)
    lmk[:, 1::2] = np.where(vis[:, 1::2], lmk[:, 1::2] * s + dy, -1.0)
    r[:, 4:14] = lmk
    return r


def mosaic4(items: Sequence[Tuple[np.ndarray, np.ndarray]],
            out_wh: Tuple[int, int], rng: random.Random, scale: float = 0.5
            ) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic (face_datasets.load_mosaic_face redesigned): paste 4
    scaled images quadrant-wise around a random center on a 2x canvas
    filled with the inference letterbox gray, then crop the central
    ``out_wh`` window. items: 4 of (img BGR u8, rows [N, 14]). Returns
    (canvas [oh, ow, 3] u8, rows [M, 14]) with off-canvas GT dropped."""
    ow, oh = out_wh
    canvas = np.full((oh * 2, ow * 2, 3), GRAY, np.uint8)
    xc = int(rng.uniform(ow * 0.5, ow * 1.5))
    yc = int(rng.uniform(oh * 0.5, oh * 1.5))
    all_rows = []
    for i, (img, rows) in enumerate(items):
        h, w = img.shape[:2]
        s = min(ow / w, oh / h) * rng.uniform(1.0 - scale, 1.0 + scale)
        sw, sh = max(int(w * s), 1), max(int(h * s), 1)
        img = host_resize(img, (sw, sh))
        if i == 0:    # top-left of center
            x1, y1, x2, y2 = max(xc - sw, 0), max(yc - sh, 0), xc, yc
            sx1, sy1 = sw - (x2 - x1), sh - (y2 - y1)
        elif i == 1:  # top-right
            x1, y1, x2, y2 = xc, max(yc - sh, 0), min(xc + sw, ow * 2), yc
            sx1, sy1 = 0, sh - (y2 - y1)
        elif i == 2:  # bottom-left
            x1, y1, x2, y2 = max(xc - sw, 0), yc, xc, min(yc + sh, oh * 2)
            sx1, sy1 = sw - (x2 - x1), 0
        else:         # bottom-right
            x1, y1 = xc, yc
            x2, y2 = min(xc + sw, ow * 2), min(yc + sh, oh * 2)
            sx1, sy1 = 0, 0
        canvas[y1:y2, x1:x2] = img[sy1:sy1 + (y2 - y1), sx1:sx1 + (x2 - x1)]
        if len(rows):
            all_rows.append(_shift_rows(rows, s, x1 - sx1, y1 - sy1))
    rows = (np.concatenate(all_rows, axis=0) if all_rows
            else np.zeros((0, 14), np.float32))
    cx0, cy0 = ow // 2, oh // 2
    out = canvas[cy0:cy0 + oh, cx0:cx0 + ow]
    if len(rows):
        rows = _shift_rows(rows, 1.0, -cx0, -cy0)
        half_w, half_h = rows[:, 2] / 2, rows[:, 3] / 2
        bx1 = np.clip(rows[:, 0] - half_w, 0, ow)
        by1 = np.clip(rows[:, 1] - half_h, 0, oh)
        bx2 = np.clip(rows[:, 0] + half_w, 0, ow)
        by2 = np.clip(rows[:, 1] + half_h, 0, oh)
        nw, nh = bx2 - bx1, by2 - by1
        keep = (nw > 2) & (nh > 2) & (nw * nh > 0.2 * rows[:, 2] * rows[:, 3])
        boxes = np.stack([(bx1 + bx2) / 2, (by1 + by2) / 2, nw, nh], axis=1)
        # landmarks survive only if still inside the crop
        lmk = rows[:, 4:14]
        inside = ((lmk[:, 0::2] >= 0) & (lmk[:, 0::2] < ow)
                  & (lmk[:, 1::2] >= 0) & (lmk[:, 1::2] < oh))
        lmk[:, 0::2] = np.where(inside, lmk[:, 0::2], -1.0)
        lmk[:, 1::2] = np.where(inside, lmk[:, 1::2], -1.0)
        rows = np.concatenate([boxes, lmk], axis=1)[keep]
    return out, rows.astype(np.float32)


def load_wider_index(ann_file: str, images_root: str
                     ) -> List[Tuple[str, np.ndarray]]:
    """[(image path, [M, 4] xywh GT)] of a WIDER-format annotation file,
    sorted by relative path."""
    gt = parse_wider_annotations(ann_file)
    return [(os.path.join(images_root, rel), boxes)
            for rel, boxes in sorted(gt.items())]


def boxes_to_rows(boxes_xywh: np.ndarray) -> np.ndarray:
    """[N, 4] or [N, 14+] xywh GT -> [N, 14] pixel rows [cx, cy, w, h, lmk
    x10] (landmark columns pass through if present, else -1)."""
    n = len(boxes_xywh)
    rows = np.full((n, 14), -1.0, np.float32)
    if n:
        b = np.asarray(boxes_xywh, np.float32)
        rows[:, 0] = b[:, 0] + b[:, 2] / 2.0
        rows[:, 1] = b[:, 1] + b[:, 3] / 2.0
        rows[:, 2:4] = b[:, 2:4]
        if b.shape[1] >= 14:
            rows[:, 4:14] = b[:, 4:14]
    return rows


def letterbox_example(img: np.ndarray, rows: np.ndarray,
                      out_wh: Tuple[int, int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Letterbox a BGR u8 image and transform its pixel target rows to
    match. Returns (canvas [oh, ow, 3] u8, rows [N, 14] in canvas
    pixels)."""
    h, w = img.shape[:2]
    ow, oh = out_wh
    scale, sh, sw, top, left = letterbox_params((h, w), (oh, ow))
    canvas = np.full((oh, ow, 3), GRAY, np.uint8)
    canvas[top:top + sh, left:left + sw] = host_resize(img, (sw, sh))
    out = rows.astype(np.float32).copy()
    if len(out):
        out = _shift_rows(out, scale, left, top)
    return canvas, out


def rows_to_padded(rows: np.ndarray, max_targets: int, min_box: float = 2.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad [N, 14] rows to ([T, 14], valid [T]); tiny boxes are padded in
    but marked invalid (the reference's min-size filter)."""
    t = np.zeros((max_targets, 14), np.float32)
    t[:, 4:] = -1.0
    v = np.zeros((max_targets,), bool)
    n = min(len(rows), max_targets)
    if n:
        t[:n] = rows[:n]
        v[:n] = (rows[:n, 2] >= min_box) & (rows[:n, 3] >= min_box)
    return t, v


def make_example(img: np.ndarray, boxes_xywh: np.ndarray,
                 out_wh: Tuple[int, int], max_targets: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Letterbox an image and transform its GT to padded target rows.
    Returns (image [h, w, 3] f32 RGB in [0, 1], targets [T, 14], valid
    [T])."""
    canvas, rows = letterbox_example(img, boxes_to_rows(boxes_xywh), out_wh)
    x = canvas[..., ::-1].astype(np.float32) / 255.0
    t, v = rows_to_padded(rows, max_targets)
    return x, t, v


def augment_example(canvas: np.ndarray, rows: np.ndarray, rng: random.Random,
                    aug: AugmentConfig) -> Tuple[np.ndarray, np.ndarray]:
    """HSV jitter and flips on a composed (canvas u8 BGR, pixel rows)
    example."""
    oh, ow = canvas.shape[:2]
    canvas = augment_hsv(canvas, rng, aug.hsv_h, aug.hsv_s, aug.hsv_v)
    if rng.random() < aug.flipud:
        canvas = np.flipud(canvas)
        rows = flip_ud_targets(rows, float(oh))
    if rng.random() < aug.fliplr:
        canvas = np.fliplr(canvas)
        rows = flip_lr_targets(rows, float(ow))
    return np.ascontiguousarray(canvas), rows


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a daemon thread feeding a bounded queue, so host
    batch assembly overlaps the device step and the upload. Exceptions
    from the source re-raise at the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    end = object()

    def run():
        try:
            for x in it:
                q.put(x)
            q.put(end)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            q.put(e)

    threading.Thread(target=run, daemon=True).start()
    while True:
        got = q.get()
        if got is end:
            return
        if isinstance(got, BaseException):
            raise got
        yield got


def wider_batches(index: List[Tuple[str, np.ndarray]], batch_size: int,
                  out_wh: Tuple[int, int], max_targets: int,
                  shuffle: bool = True, seed: int = 0, epochs: int = 1,
                  augment: Optional[AugmentConfig] = None,
                  as_uint8: bool = False, cache_mb: float = 0.0,
                  to_rgb: bool = True
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (images [B, h, w, 3], targets [B, T, 14], valid [B, T]).

    With ``augment``, each example goes through mosaic (probability
    ``augment.mosaic``, pulling 3 extra random images), HSV jitter and flips
    with the landmark left/right swap. ``as_uint8`` yields uint8 images
    (normalized on the device); ``to_rgb=False`` keeps BGR (the OpenCV-SSD
    convention). ``cache_mb`` bounds an in-memory cache of decoded images.
    A batch may span an epoch boundary."""
    rng = random.Random(seed)
    cache: dict = {}
    cache_bytes = [0]
    budget = int(cache_mb * 1e6)

    def load(i):
        img = cache.get(i)
        if img is None:
            img = imread(index[i][0])
            if img is not None and cache_bytes[0] + img.nbytes <= budget:
                cache[i] = img
                cache_bytes[0] += img.nbytes
        if img is None:
            return None
        return img, boxes_to_rows(index[i][1])

    batch_x, batch_t, batch_v = [], [], []
    for _ in range(epochs):
        order = list(range(len(index)))
        if shuffle:
            rng.shuffle(order)
        for i in order:
            item = load(i)
            if item is None:
                continue
            if augment is not None and rng.random() < augment.mosaic:
                extra = [load(rng.randrange(len(index))) for _ in range(3)]
                items = [item] + [e for e in extra if e is not None]
                while len(items) < 4:
                    items.append(items[rng.randrange(len(items))])
                canvas, rows = mosaic4(items, out_wh, rng, augment.scale)
            else:
                canvas, rows = letterbox_example(item[0], item[1], out_wh)
            if augment is not None:
                canvas, rows = augment_example(canvas, rows, rng, augment)
            out = np.ascontiguousarray(canvas[..., ::-1]) if to_rgb else canvas
            x = out if as_uint8 else out.astype(np.float32) / 255.0
            t, v = rows_to_padded(
                rows, max_targets,
                augment.min_box if augment is not None else 2.0)
            batch_x.append(x)
            batch_t.append(t)
            batch_v.append(v)
            if len(batch_x) == batch_size:
                yield np.stack(batch_x), np.stack(batch_t), np.stack(batch_v)
                batch_x, batch_t, batch_v = [], [], []
