"""The golden accuracy loop for the MTCNN cascade: train P-, R- and O-Net
on crops sampled from the composites, gate the whole cascade on the golden
pair, checkpoint, reload and regate.

The counterpart of ``train/golden_mtcnn.py`` in the JAX package, the
classic recipe (Zhang et al. 2016): square crops around a ground-truth face
are positives (IoU > 0.65, with box regression and landmark targets),
parts (0.4-0.65, regression only) or negatives (IoU < 0.3, random squares
and hard ones hugging a face), at each stage's input size (12, 24, 48).
The regression targets invert the cascade's decode: P-Net's offsets by
w = x2 - x1, R- and O-Net's by the +1 widths; the landmarks are
pseudo-targets at canonical places in the face box. The crops are built in
numpy from the JAX package's ``random.Random`` draws (``host_resize`` for
cv2.resize), byte for byte.

Each stage trains alone under optax's ``adamw(lr, weight_decay=1e-4)``
(``train.optim.OptaxAdam``) on its device-resident buffer with the masked
CE + 0.5 box + 0.5 landmark loss; batch indices are drawn on the device
from a ``torch.Generator``. Up to three bootstrap rounds then mine the
trained cascade's false positives on the training images and retrain R-
and O-Net with them as negatives. The gate is ``train.golden.
evaluate_golden`` through an mtcnn ``FaceEngine`` (B1 and B3 on the card);
the checkpoint is the engine's ``.pt``.
"""
from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..eval.card_weights import bbox_iou_xyxy
from ..ops.geometry import host_resize
from .data import imread
from .golden import evaluate_golden, make_composite_dataset

# canonical landmark places in a face box (x_frac, y_frac): left eye, right
# eye, nose, left and right mouth corners
_CANON_LMK = np.array([[0.31, 0.38], [0.69, 0.38], [0.50, 0.58],
                       [0.35, 0.78], [0.65, 0.78]], np.float32)
STAGE_SIZES = {"pnet": 12, "rnet": 24, "onet": 48}
BUFFER_KEYS = ("x", "cls", "cls_mask", "reg", "reg_mask", "lmk", "lmk_mask")


def _square_jitter(rng: random.Random, box: np.ndarray,
                   pos: bool) -> np.ndarray:
    """A jittered square crop box around (``pos``) or loosely near (a part
    face) a ground-truth box."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    side = max(w, h)
    cx, cy = x1 + w / 2, y1 + h / 2
    if pos:
        s = side * rng.uniform(0.9, 1.15)
        cx += rng.uniform(-0.1, 0.1) * side
        cy += rng.uniform(-0.1, 0.1) * side
    else:
        s = side * rng.uniform(0.7, 1.5)
        cx += rng.uniform(-0.3, 0.3) * side
        cy += rng.uniform(-0.3, 0.3) * side
    return np.array([cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2],
                    np.float32)


def _crop_norm(img: np.ndarray, box: np.ndarray, size: int,
               pad_crop: bool = False) -> np.ndarray:
    """A (possibly out-of-frame) box cropped with zeros outside the frame,
    resized to [size, size, 3], RGB, ``(x - 127.5) / 128``. ``pad_crop``
    takes R/O-Net's geometry (facenet's 1-based ``pad``: origin (x1 - 1,
    y1 - 1), size (x2 - x1 + 1, y2 - y1 + 1)); P-Net's patches are the
    plain [x1, x2) crop."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    if pad_crop:
        side_x, side_y = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        ox, oy = x1 - 1, y1 - 1
    else:
        side_x, side_y = max(x2 - x1, 1), max(y2 - y1, 1)
        ox, oy = x1, y1
    canvas = np.zeros((side_y, side_x, 3), np.uint8)
    sx1, sy1 = max(ox, 0), max(oy, 0)
    sx2, sy2 = min(ox + side_x, w), min(oy + side_y, h)
    if sx2 > sx1 and sy2 > sy1:
        canvas[sy1 - oy:sy2 - oy, sx1 - ox:sx2 - ox] = img[sy1:sy2, sx1:sx2]
    crop = host_resize(canvas, (size, size))
    rgb = crop[..., ::-1].astype(np.float32)
    return (rgb - 127.5) * 0.0078125


def _reg_target(crop_box: np.ndarray, gt: np.ndarray,
                plus1: bool) -> np.ndarray:
    """Offsets matching the cascade's decode: P-Net normalizes by w = x2 -
    x1 (``plus1`` False), R/O-Net by w = x2 - x1 + 1."""
    w = crop_box[2] - crop_box[0] + (1.0 if plus1 else 0.0)
    h = crop_box[3] - crop_box[1] + (1.0 if plus1 else 0.0)
    return np.array([(gt[0] - crop_box[0]) / w, (gt[1] - crop_box[1]) / h,
                     (gt[2] - crop_box[2]) / w, (gt[3] - crop_box[3]) / h],
                    np.float32)


def _lmk_target(crop_box: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pseudo landmark targets in O-Net's decode convention (lx = (w + 1)
    * lmk + x1 - 1): ``(px - x1 + 1) / (w + 1)``."""
    w = crop_box[2] - crop_box[0] + 1.0
    h = crop_box[3] - crop_box[1] + 1.0
    gw, gh = gt[2] - gt[0], gt[3] - gt[1]
    px = gt[0] + _CANON_LMK[:, 0] * gw
    py = gt[1] + _CANON_LMK[:, 1] * gh
    return np.concatenate([(px - crop_box[0] + 1.0) / w,
                           (py - crop_box[1] + 1.0) / h]).astype(np.float32)


def build_stage_buffer(index: List[Tuple[str, np.ndarray]], size: int,
                       n: int, seed: int = 0, neg_frac: float = 0.5
                       ) -> Dict[str, np.ndarray]:
    """``n`` crops for one stage: x [n, S, S, 3] f32 normalized RGB, cls
    [n] (1 face / 0 not), cls_mask [n] (parts excluded), reg [n, 4],
    reg_mask [n], lmk [n, 10], lmk_mask [n]."""
    rng = random.Random(seed)
    imgs: Dict[str, np.ndarray] = {}

    def load(i):
        p, boxes = index[i]
        if p not in imgs:
            imgs[p] = imread(p)
        return imgs[p], boxes

    xs = np.zeros((n, size, size, 3), np.float32)
    cls = np.zeros((n,), np.int32)
    cls_mask = np.ones((n,), np.float32)
    reg = np.zeros((n, 4), np.float32)
    reg_mask = np.zeros((n,), np.float32)
    lmk = np.zeros((n, 10), np.float32)
    lmk_mask = np.zeros((n,), np.float32)
    plus1 = size != 12
    i = guard = 0
    while i < n and guard < n * 60:
        guard += 1
        img, boxes_xywh = load(rng.randrange(len(index)))
        if img is None:
            continue
        h, w = img.shape[:2]
        gts = np.asarray(boxes_xywh, np.float32).reshape(-1, 4).copy()
        if len(gts):
            gts[:, 2:] += gts[:, :2]
        r = rng.random()
        if r < neg_frac or not len(gts):
            # half random squares, half hard negatives next to a face
            if len(gts) and rng.random() < 0.5:
                g = gts[rng.randrange(len(gts))]
                gl = max(g[2] - g[0], g[3] - g[1])
                side = gl * rng.uniform(0.3, 1.2)
                cx = (g[0] + g[2]) / 2 + rng.uniform(-1.0, 1.0) * gl
                cy = (g[1] + g[3]) / 2 + rng.uniform(-1.0, 1.0) * gl
                cb = np.array([cx - side / 2, cy - side / 2,
                               cx + side / 2, cy + side / 2], np.float32)
            else:
                side = rng.uniform(12, max(min(h, w) / 2.0, 13))
                x0 = rng.uniform(0, max(w - side, 1))
                y0 = rng.uniform(0, max(h - side, 1))
                cb = np.array([x0, y0, x0 + side, y0 + side], np.float32)
            if len(gts) and max(bbox_iou_xyxy(cb, g) for g in gts) >= 0.3:
                continue
            xs[i] = _crop_norm(img, cb, size, pad_crop=plus1)
            cls[i] = 0
            i += 1
            continue
        g = gts[rng.randrange(len(gts))]
        want_pos = r < neg_frac + (1.0 - neg_frac) * 0.6
        cb = _square_jitter(rng, g, pos=want_pos)
        iou = bbox_iou_xyxy(cb, g)
        if iou > 0.65:
            xs[i] = _crop_norm(img, cb, size, pad_crop=plus1)
            cls[i] = 1
            reg[i] = _reg_target(cb, g, plus1)
            reg_mask[i] = 1.0
            lmk[i] = _lmk_target(cb, g)
            lmk_mask[i] = 1.0
            i += 1
        elif 0.4 <= iou <= 0.65:
            xs[i] = _crop_norm(img, cb, size, pad_crop=plus1)
            cls_mask[i] = 0.0
            reg[i] = _reg_target(cb, g, plus1)
            reg_mask[i] = 1.0
            i += 1
    if i < n:
        raise RuntimeError(f"stage-{size} sampler starved at {i}/{n}")
    return {"x": xs, "cls": cls, "cls_mask": cls_mask, "reg": reg,
            "reg_mask": reg_mask, "lmk": lmk, "lmk_mask": lmk_mask}


def stage_loss(name: str, net, x, c, cm, r, rm, lm_t, lm_m
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """A stage's loss on NHWC crops: the class CE over the face
    probability (clipped at 1e-7) masked to non-parts, plus 0.5 x the
    masked squared box error, plus (O-Net) 0.5 x the masked squared
    landmark error; each masked mean over the mask's sum (at least 1).
    Returns (loss, (cls loss, box loss))."""
    out = net(x.permute(0, 3, 1, 2))
    prob, reg = out[0], out[1]
    b = prob.shape[0]
    p = torch.clamp(prob.reshape(b, -1)[:, -2:], 1e-7, 1.0)
    reg = reg.reshape(b, -1)[:, -4:]
    cf = c.float()
    ce = -(cf * torch.log(p[:, 1]) + (1 - cf) * torch.log(p[:, 0]))
    l_cls = torch.sum(ce * cm) / torch.clamp(cm.sum(), min=1.0)
    l_reg = torch.sum(torch.sum((reg - r) ** 2, -1) * rm) \
        / torch.clamp(rm.sum(), min=1.0)
    loss = l_cls + 0.5 * l_reg
    if name == "onet":
        l_lmk = torch.sum(torch.sum((out[2] - lm_t) ** 2, -1) * lm_m) \
            / torch.clamp(lm_m.sum(), min=1.0)
        loss = loss + 0.5 * l_lmk
    return loss, (l_cls, l_reg)


def make_stage_trainer(name: str, net, lr: float, batch_size: int,
                       eval_every: int, device, log=print) -> Callable:
    """``train(data, steps_total, generator, tag="")``: a fresh optimizer
    (optax's adamw), then ``steps_total`` updates of ``net`` in chunks of
    ``eval_every``, each step's batch indices drawn from ``generator`` on
    the device. Returns the chunks' mean losses."""
    from .detection import train_precision
    from .optim import OptaxAdam

    def train(data: Dict[str, np.ndarray], steps_total: int,
              generator: Optional[torch.Generator] = None, tag: str = ""
              ) -> List[float]:
        args = [torch.from_numpy(np.ascontiguousarray(data[k])).to(device)
                for k in BUFFER_KEYS]
        opt = OptaxAdam(net.parameters(), lr=lr, weight_decay=1e-4)
        losses, done = [], 0
        with train_precision(device):
            while done < steps_total:
                steps = min(eval_every, steps_total - done)
                total = None
                for _ in range(steps):
                    idx = torch.randint(0, args[0].shape[0], (batch_size,),
                                        generator=generator, device=device)
                    loss, _ = stage_loss(name, net, *[
                        a.index_select(0, idx) for a in args])
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                    total = loss.detach() if total is None \
                        else total + loss.detach()
                done += steps
                losses.append(float(total / steps))
                log(f"[golden-mtcnn] {name}{tag} step {done} "
                    f"loss {losses[-1]:.4f}")
        return losses

    return train


def mine_false_positives(engine, index: List[Tuple[str, np.ndarray]],
                         max_fp: int = 1024
                         ) -> List[Tuple[str, np.ndarray]]:
    """Boxes the cascade keeps on the 640x640 training images at IoU < 0.3
    to every ground truth: the bootstrapped hard negatives."""
    fps: List[Tuple[str, np.ndarray]] = []
    for p, boxes_xywh in index:
        if len(fps) >= max_fp:
            break
        img = imread(p)
        if img is None or img.shape[:2] != (640, 640):
            continue
        pred = np.asarray(engine.detect_image(img).boxes,
                          np.float32).reshape(-1, 4)
        gts = np.asarray(boxes_xywh, np.float32).reshape(-1, 4).copy()
        if len(gts):
            gts[:, 2:] += gts[:, :2]
        for b in pred:
            if not len(gts) or max(bbox_iou_xyxy(b, g) for g in gts) < 0.3:
                fps.append((p, b))
    return fps


def extend_with_fps(data: Dict[str, np.ndarray],
                    fps: List[Tuple[str, np.ndarray]], size: int
                    ) -> Dict[str, np.ndarray]:
    """``data`` with each false positive's square crop appended as a
    negative."""
    imgs: Dict[str, np.ndarray] = {}
    xs = []
    for p, b in fps:
        if p not in imgs:
            imgs[p] = imread(p)
        w, h = b[2] - b[0], b[3] - b[1]
        side = max(w, h)
        cx, cy = b[0] + w / 2, b[1] + h / 2
        sq = np.array([cx - side / 2, cy - side / 2, cx + side / 2,
                       cy + side / 2], np.float32)
        xs.append(_crop_norm(imgs[p], sq, size, pad_crop=size != 12))
    n = len(xs)
    if n == 0:
        return data
    zeros = {"cls": np.zeros((n,), np.int32),
             "cls_mask": np.ones((n,), np.float32),
             "reg": np.zeros((n, 4), np.float32),
             "reg_mask": np.zeros((n,), np.float32),
             "lmk": np.zeros((n, 10), np.float32),
             "lmk_mask": np.zeros((n,), np.float32)}
    out = {"x": np.concatenate([data["x"], np.stack(xs)])}
    for k, v in zeros.items():
        out[k] = np.concatenate([data[k], v])
    return out


def train_golden_mtcnn(ckpt_out: str, work_dir: str, n_images: int = 256,
                       n_crops: int = 4096, batch_size: int = 128,
                       max_steps: int = 3000, eval_every: int = 500,
                       lr: float = 1e-3, seed: int = 0, device=None,
                       bootstrap_rounds: int = 3, log=print
                       ) -> Dict[str, object]:
    """Composites -> a crop buffer a stage -> P, R and O-Net trained on
    ``device`` (the card unless the CPU is asked) from flax's
    initialization -> up to ``bootstrap_rounds`` rounds of mined false
    positives for R and O-Net (``max_steps // 2`` each) until the gate
    passes -> the gate -> the engine's ``.pt`` -> a fresh engine loading
    it -> regate. Returns the gate's result plus ``reload_ok``,
    ``reload_ious``, ``losses`` and the two engines."""
    from ..core.engine import EngineConfig, FaceEngine
    from .data import load_wider_index
    from .detection import flax_init_

    ann, images_root = make_composite_dataset(
        os.path.join(work_dir, "golden_ds"), n_images=n_images,
        out_wh=(640, 640), seed=seed)
    index = load_wider_index(ann, images_root)
    log(f"[golden-mtcnn] dataset: {len(index)} images")

    engine = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5),
                        device=device)
    dev = engine.device
    cascade = engine.net
    gen0 = torch.Generator().manual_seed(seed)
    losses: Dict[str, List[float]] = {}
    trainers, stage_data = {}, {}
    for name, size in STAGE_SIZES.items():
        net = getattr(cascade, name)
        flax_init_(net, gen0)
        net.train()
        stage_data[name] = build_stage_buffer(index, size, n_crops,
                                              seed=seed + size)
        trainers[name] = make_stage_trainer(name, net, lr, batch_size,
                                            eval_every, dev, log)
        gen = torch.Generator(device=dev).manual_seed(seed + size)
        losses[name] = trainers[name](stage_data[name], max_steps, gen)
    cascade.eval()

    result = evaluate_golden(engine)
    for round_i in range(bootstrap_rounds):
        log(f"[golden-mtcnn] gate r{round_i}: pos={result['n_pos']} "
            f"neg={result['n_neg']} "
            f"ious={['%.2f' % x for x in result['ious']]}")
        if result["ok"]:
            break
        fps = mine_false_positives(engine, index)
        log(f"[golden-mtcnn] bootstrap r{round_i}: {len(fps)} hard FPs")
        if not fps:
            break
        for name in ("rnet", "onet"):
            size = STAGE_SIZES[name]
            stage_data[name] = extend_with_fps(stage_data[name], fps, size)
            net = getattr(cascade, name).train()
            gen = torch.Generator(device=dev).manual_seed(
                seed + size + 101 * (round_i + 1))
            losses[f"{name}+fp{round_i}"] = trainers[name](
                stage_data[name], max_steps // 2, gen, tag=f"+fp{round_i}")
            net.eval()
        result = evaluate_golden(engine)
    log(f"[golden-mtcnn] gate: pos={result['n_pos']} neg={result['n_neg']} "
        f"ious={['%.2f' % x for x in result['ious']]}")
    engine.save_weights(ckpt_out)
    log(f"[golden-mtcnn] checkpoint saved to {ckpt_out}")
    engine2 = FaceEngine(EngineConfig(detector="mtcnn", det_thres=0.5),
                         device=dev)
    engine2.load_weights(ckpt_out)
    rr = evaluate_golden(engine2)
    result.update(reload_ok=rr["ok"], reload_ious=rr["ious"], losses=losses,
                  engine=engine, reload_engine=engine2)
    log(f"[golden-mtcnn] reload gate: {rr['ok']} "
        f"ious={['%.2f' % x for x in rr['ious']]}")
    return result
