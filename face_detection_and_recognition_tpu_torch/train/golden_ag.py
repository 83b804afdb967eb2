"""The golden age / gender accuracy loop: train the two CaffeNet heads until
the full cascade gives the reference's pinned labels on the golden image,
then checkpoint, reload and regate.

The counterpart of ``train/golden_ag.py`` in the JAX package. The reference
pins each face's labels on the golden 3-face image
(``tests/image_tests/test_opencv_age_gender.py:47-48``): all "Male", ages
"38-43", "25-32", "38-43" in ``GOLDEN_BOXES_3`` order. The heads
(``models/age_gender.py``) train on augmented 227x227 crops of the golden
faces (the crops built in numpy from the JAX package's ``random.Random``
draws through ``ops.geometry.host_resize``, byte for byte), with dropout,
under optax's ``adamw(lr, weight_decay=1e-4)`` (``train.optim.OptaxAdam``;
every parameter decays). The crop buffer lives on the device as uint8; the
batch indices and the dropout masks of every step are drawn there from a
``torch.Generator`` (the CPU tests feed the step JAX's dropout masks). The
gate is the whole cascade through ``FaceEngine.detect_age_gender``:
detector, +-5 px crops (B3), batched classification, label strings.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.card_weights import bbox_iou_xyxy
from ..ops.geometry import host_resize
from .data import imread
from .golden import GOLDEN_BOXES_3, GOLDEN_IMG, NEGATIVE_IMG

# (age bucket, gender) of each GOLDEN_BOXES_3 row, from the reference's
# pinned labels: box@408 -> "38-43" (5), box@283 -> "25-32" (4), box@511 ->
# "38-43" (5); all "Male" (0)
GOLDEN_AG = ((5, 0), (4, 0), (5, 0))
AG_MEAN = (78.4263377603, 87.7689143744, 114.895847746)  # BGR


def sample_face_crop(rng: random.Random, img: np.ndarray, box: np.ndarray,
                     jitter: float = 0.18, out: int = 227) -> np.ndarray:
    """One augmented 227x227 BGR crop: the cascade's +-5 px pad with the
    centre and scale jittered, a horizontal flip half the time, and a
    contrast / brightness jitter."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = box
    bw, bh = x2 - x1, y2 - y1
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    s = rng.uniform(1.0 - jitter, 1.0 + jitter)
    cx += rng.uniform(-jitter, jitter) * bw
    cy += rng.uniform(-jitter, jitter) * bh
    nw, nh = bw * s + 10, bh * s + 10
    nx1 = int(max(cx - nw / 2, 0))
    ny1 = int(max(cy - nh / 2, 0))
    nx2 = int(min(cx + nw / 2, w))
    ny2 = int(min(cy + nh / 2, h))
    crop = host_resize(np.ascontiguousarray(img[ny1:ny2, nx1:nx2]),
                       (out, out))
    if rng.random() < 0.5:
        crop = np.ascontiguousarray(crop[:, ::-1])
    a = rng.uniform(0.75, 1.25)
    b = rng.uniform(-20, 20)
    return np.clip(crop.astype(np.float32) * a + b, 0, 255).astype(np.uint8)


def build_ag_buffer(n: int, seed: int = 0, img_path: str = GOLDEN_IMG
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[n, 227, 227, 3] uint8 BGR crops, age labels [n], gender labels
    [n]."""
    rng = random.Random(seed)
    img = imread(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    xs, ya, yg = [], [], []
    for _ in range(n):
        j = rng.randrange(len(GOLDEN_BOXES_3))
        xs.append(sample_face_crop(rng, img, GOLDEN_BOXES_3[j]))
        ya.append(GOLDEN_AG[j][0])
        yg.append(GOLDEN_AG[j][1])
    return np.stack(xs), np.asarray(ya, np.int32), np.asarray(yg, np.int32)


def evaluate_golden_ag(engine, iou_thres: float = 0.5) -> Dict[str, object]:
    """The cascade gate: ``detect_age_gender`` on the golden image finds
    exactly the 3 faces (a one-to-one greedy match on descending IoU) and
    labels each with its pinned age bucket and gender; the 0-face image,
    resized to the golden image's size, gives nothing."""
    from ..models.age_gender import AGE_BUCKETS, GENDERS

    img = imread(GOLDEN_IMG)
    post = engine.detect_age_gender(img)
    boxes = np.asarray(post.boxes, np.float32).reshape(-1, 4)
    labels = list(post.bbox_labels)
    iou_mat = np.zeros((len(GOLDEN_BOXES_3), len(boxes)), np.float32)
    for gi, g in enumerate(GOLDEN_BOXES_3):
        for j, p in enumerate(boxes):
            iou_mat[gi, j] = bbox_iou_xyxy(g, p)
    assign: Dict[int, int] = {}
    if boxes.size:
        order = np.dstack(np.unravel_index(
            np.argsort(-iou_mat, axis=None), iou_mat.shape))[0]
        used: set = set()
        for gi, pj in order:
            if gi in assign or pj in used or iou_mat[gi, pj] < iou_thres:
                continue
            assign[int(gi)] = int(pj)
            used.add(int(pj))
    ok_labels: List[bool] = []
    for gi in range(len(GOLDEN_BOXES_3)):
        pj = assign.get(gi)
        if pj is None:
            ok_labels.append(False)
            continue
        got = labels[pj]
        ok_labels.append(AGE_BUCKETS[GOLDEN_AG[gi][0]] in got
                         and GENDERS[GOLDEN_AG[gi][1]] in got)
    neg = imread(NEGATIVE_IMG)
    if neg.shape != img.shape:
        neg = host_resize(neg, (img.shape[1], img.shape[0]))
    n_neg = len(np.asarray(engine.detect_age_gender(neg).boxes)
                .reshape(-1, 4))
    ok = (len(assign) == len(GOLDEN_BOXES_3)
          and len(boxes) == len(GOLDEN_BOXES_3) and all(ok_labels)
          and n_neg == 0)
    return {"ok": bool(ok), "matched": len(assign), "labels_ok": ok_labels,
            "n_pos": int(len(boxes)), "n_neg": int(n_neg), "labels": labels}


def make_ag_step(net, opt, mean: torch.Tensor) -> Callable:
    """``step(x_u8 [B, 227, 227, 3], ya, yg, keep_age, keep_gender) ->
    (loss, (ca, cg))``: both heads' mean cross-entropies on the
    mean-subtracted batch, with each head's (fc6, fc7) dropout keep masks,
    and one optimizer update; the losses stay on the device."""
    def step(x_u8, ya, yg, keep_age, keep_gender):
        x = (x_u8.float() - mean).permute(0, 3, 1, 2)
        ca = F.cross_entropy(net.age(x, keep_age), ya.long())
        cg = F.cross_entropy(net.gender(x, keep_gender), yg.long())
        loss = ca + cg
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), (ca.detach(), cg.detach())

    return step


def create_ag_train_state(lr: float = 3e-4, seed: int = 0, device=None
                          ) -> Dict[str, object]:
    """Both heads with flax's initialization drawn from ``seed``, in train
    mode on ``device``, and optax's adamw (weight decay 1e-4 on every
    parameter)."""
    from ..models.age_gender import AgeGenderNet
    from ..ops.platform import resolve_device
    from .detection import flax_init_
    from .optim import OptaxAdam

    dev = resolve_device(device)
    net = flax_init_(AgeGenderNet(), torch.Generator().manual_seed(seed))
    net = net.to(device=dev, memory_format=torch.channels_last).train()
    opt = OptaxAdam(net.parameters(), lr=lr, weight_decay=1e-4)
    mean = torch.tensor(AG_MEAN, dtype=torch.float32, device=dev)
    return {"net": net, "opt": opt, "device": dev, "mean": mean,
            "step": make_ag_step(net, opt, mean)}


def run_ag_chunk(state: Dict[str, object], data, batch_size: int,
                 steps: int, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """``steps`` updates on the device-resident ``data`` (x, ya, yg); each
    step's batch indices and dropout masks drawn from ``generator`` on the
    device. Returns the chunk's mean loss, on the device."""
    from .detection import train_precision

    dx, da, dg = data
    total = None
    dev = dx.device
    with train_precision(state["device"]):
        for _ in range(steps):
            idx = torch.randint(0, dx.shape[0], (batch_size,),
                                generator=generator, device=dev)
            keep_a, keep_g = [tuple(
                torch.rand((batch_size, 512), generator=generator,
                           device=dev) < 0.5 for _ in range(2))
                for _ in range(2)]
            loss, _ = state["step"](dx.index_select(0, idx),
                                    da.index_select(0, idx),
                                    dg.index_select(0, idx), keep_a, keep_g)
            total = loss if total is None else total + loss
    return total / steps


def ag_engine(detector: str, detector_ckpt: str, device=None):
    """A cascade engine over ``detector`` with its weights loaded."""
    from ..core.engine import EngineConfig, FaceEngine

    eng = FaceEngine(EngineConfig(detector=detector, det_thres=0.5,
                                  with_age_gender=True), device=device)
    eng.load_weights(detector_ckpt)
    return eng


def train_golden_ag(ckpt_out: str, detector_ckpt: str,
                    detector: str = "yolov5n", n_buffer: int = 1536,
                    batch_size: int = 64, max_steps: int = 3000,
                    eval_every: int = 250, lr: float = 3e-4, seed: int = 0,
                    device=None, log=print) -> Dict[str, object]:
    """Train both heads on ``device`` (the card unless the CPU is asked) in
    chunks of ``eval_every`` steps, gate the cascade after each through an
    engine over the trained detector (``detector_ckpt``, a ``.pt``), save
    the heads' state dict (``age.*``, ``gender.*``) as a ``.pt``, reload it
    into a fresh engine (``load_age_gender_weights``) and regate. Returns
    the gate's result plus ``steps``, ``losses``, ``reload_ok`` and
    ``engine`` / ``reload_engine``."""
    state = create_ag_train_state(lr, seed, device)
    dev = state["device"]
    engine = ag_engine(detector, detector_ckpt, dev)
    x, ya, yg = build_ag_buffer(n_buffer, seed=seed)
    data = (torch.from_numpy(x).to(dev), torch.from_numpy(ya).to(dev),
            torch.from_numpy(yg).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0xA6)
    net = state["net"]
    result: Dict[str, object] = {"ok": False}
    losses: List[float] = []
    done = 0
    while done < max_steps:
        steps = min(eval_every, max_steps - done)
        loss = run_ag_chunk(state, data, batch_size, steps, gen)
        done += steps
        losses.append(float(loss))
        engine.load_age_gender_state_dict(net.state_dict())
        r = evaluate_golden_ag(engine)
        log(f"[golden-ag] step {done} loss {losses[-1]:.4f} "
            f"matched={r['matched']} labels_ok={r['labels_ok']} "
            f"neg={r['n_neg']}")
        if r["ok"]:
            result = dict(r, steps=done)
            break
    if not result.get("ok"):
        result = dict(evaluate_golden_ag(engine), steps=max_steps)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               ckpt_out)
    log(f"[golden-ag] checkpoint saved to {ckpt_out}")
    engine2 = ag_engine(detector, detector_ckpt, dev)
    engine2.load_age_gender_weights(ckpt_out)
    rr = evaluate_golden_ag(engine2)
    result.update(reload_ok=rr["ok"], reload_labels=rr["labels"],
                  losses=losses, engine=engine, reload_engine=engine2)
    log(f"[golden-ag] reload gate: {rr['ok']} labels={rr['labels']}")
    return result
