"""The recognition accuracy loop: train an embedder with ArcFace until the
similar-face filter separates the golden identities, then checkpoint,
reload into a fresh engine and regate.

The counterpart of ``train/golden_embed.py`` in the JAX package. The
reference's strongest recognition contract is the similar-face filter: a
class's mean reference embedding and its threshold, the largest distance of
the references from that mean, route images by ``||f - mean|| <= thres``
(``similar_face_filtering/filter_faces_using_reference.py:71-100, 183-197``).
The three golden faces of ``test2_faces_3.jpg`` become three identities
(or, with ``n_identities`` > 3, a population of synthetic identities, each
a donor face under a fixed flip, rotation and gamma); augmented crop sets
are drawn for each, an embedder trains with ArcFace
(``train/arcface.py``), and the gate demands that the filter's math route
held-out probes perfectly.

The crops are built in numpy from the JAX package's ``random.Random``
draws, through the port's cv2 slots (``ops.geometry.host_resize`` for
cv2.resize, ``rotation_matrix_2d`` + ``warp_affine`` for the rotation with
a replicated border, ``train.data.augment_hsv``, a numpy LUT for cv2.LUT),
so a seed gives the JAX package's crops byte for byte. The training buffer
lives on the device as uint8; each step's batch is gathered and normalized
there. The checkpoint is a ``.pt`` state dict of the slot's net with a
``golden_meta.json`` sidecar beside it; ``FaceEngine.load_embed_weights``
reads it back.
"""
from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List

import numpy as np
import torch

from ..ops.geometry import host_resize, rotation_matrix_2d, warp_affine
from .data import augment_hsv
from .golden import GOLDEN_IMG, extract_golden_faces

N_IDENTITIES = 3


def _window(rng: random.Random, f: Dict[str, np.ndarray], size: int,
            a: float, zoom: float, shift: float) -> np.ndarray:
    """One jittered crop window around a donor's face box, resized to
    ``size``: the side scaled by U(1, 1 + zoom * a), the centre moved by
    U(-shift * a, shift * a) of it."""
    patch, box = f["patch"], f["box"]
    ph, pw = patch.shape[:2]
    cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
    side0 = max(box[2] - box[0], box[3] - box[1])
    s = side0 * rng.uniform(1.0, 1.0 + zoom * a)
    jx = cx + rng.uniform(-shift * a, shift * a) * s
    jy = cy + rng.uniform(-shift * a, shift * a) * s
    half = s / 2
    x1 = int(np.clip(jx - half, 0, pw - 2))
    y1 = int(np.clip(jy - half, 0, ph - 2))
    x2 = int(np.clip(jx + half, x1 + 2, pw))
    y2 = int(np.clip(jy + half, y1 + 2, ph))
    return host_resize(np.ascontiguousarray(patch[y1:y2, x1:x2]),
                       (size, size))


def _sensor_noise(rng: random.Random, crop: np.ndarray,
                  max_sigma: float) -> np.ndarray:
    """Gaussian sensor noise of a U(0, max_sigma) sigma (none under 0.5),
    from a numpy stream seeded by ``rng``."""
    sigma = rng.uniform(0.0, max_sigma)
    if sigma > 0.5:
        noise = np.random.RandomState(
            rng.randrange(1 << 31)).normal(0, sigma, crop.shape)
        crop = np.clip(crop.astype(np.float32) + noise,
                       0, 255).astype(np.uint8)
    return crop


def make_identity_crops(seed: int, n_per_id: int, size: int = 112,
                        img_path: str = GOLDEN_IMG, aug_scale: float = 1.0
                        ) -> List[List[np.ndarray]]:
    """``n_per_id`` augmented BGR uint8 crops of each golden identity: the
    crop window jittered around the face box, resized to ``size``, HSV
    jitter, a horizontal flip half the time, sensor noise. Distinct seeds
    give disjoint ref / probe / train sets; ``aug_scale`` > 1 widens every
    jitter range."""
    rng = random.Random(seed)
    a = aug_scale
    out: List[List[np.ndarray]] = []
    for f in extract_golden_faces(img_path):
        crops = []
        for _ in range(n_per_id):
            crop = _window(rng, f, size, a, 0.45, 0.08)
            crop = augment_hsv(crop, rng, 0.015 * a, min(0.5 * a, 0.9),
                               min(0.3 * a, 0.9))
            if rng.random() < 0.5:
                crop = np.ascontiguousarray(np.fliplr(crop))
            crops.append(_sensor_noise(rng, crop, 6.0 * a))
        out.append(crops)
    return out


# each synthetic identity: a donor (identity % 3) under the fixed transform
# of its variant (identity // 3); variant 0 is the donor itself
_ID_FLIPS = (False, True, False, False, True, True)
_ID_ROTATIONS = (0.0, 0.0, -14.0, 14.0, -14.0, 14.0)
_ID_GAMMAS = (1.0, 1.0, 1.0, 1.0, 0.85, 1.2)
MAX_IDENTITIES = len(_ID_FLIPS) * 3


def apply_identity_transform(crop_u8: np.ndarray, identity: int
                             ) -> np.ndarray:
    """The fixed appearance of synthetic identity ``identity``: a
    horizontal flip, a rotation about the centre (the border replicated)
    and a gamma, each by the identity's variant."""
    v = identity // 3
    crop = crop_u8
    if _ID_FLIPS[v]:
        crop = np.fliplr(crop)
    if _ID_ROTATIONS[v]:
        h, w = crop.shape[:2]
        m = rotation_matrix_2d((w / 2, h / 2), _ID_ROTATIONS[v], 1.0)
        crop = warp_affine(np.ascontiguousarray(crop), m, (w, h))
    if _ID_GAMMAS[v] != 1.0:
        lut = np.clip(((np.arange(256) / 255.0) ** _ID_GAMMAS[v]) * 255.0,
                      0, 255).astype(np.uint8)
        crop = lut[np.ascontiguousarray(crop)]
    return np.ascontiguousarray(crop)


def make_multi_identity_crops(seed: int, n_per_id: int, size: int = 112,
                              n_identities: int = 16,
                              img_path: str = GOLDEN_IMG,
                              aug_scale: float = 1.0
                              ) -> List[List[np.ndarray]]:
    """Augmented BGR uint8 crop sets for ``n_identities`` synthetic
    identities (at most ``MAX_IDENTITIES``): window jitter, the identity's
    transform, a small HSV jitter and sensor noise, no flip."""
    if n_identities > MAX_IDENTITIES:
        raise ValueError(f"{n_identities} > {MAX_IDENTITIES} identities")
    rng = random.Random(seed)
    faces = extract_golden_faces(img_path)
    a = aug_scale
    out: List[List[np.ndarray]] = []
    for identity in range(n_identities):
        f = faces[identity % len(faces)]
        crops = []
        for _ in range(n_per_id):
            crop = apply_identity_transform(
                _window(rng, f, size, a, 0.4, 0.07), identity)
            crop = augment_hsv(crop, rng, 0.006 * a, min(0.25 * a, 0.6),
                               min(0.2 * a, 0.6))
            crops.append(_sensor_noise(rng, crop, 5.0 * a))
        out.append(crops)
    return out


def evaluate_retrieval(embed_u8_fn: Callable[[np.ndarray], np.ndarray],
                       n_identities: int = 16, gallery_seed: int = 303,
                       probe_seed: int = 404, n_gallery: int = 32,
                       n_probe: int = 8, size: int = 112,
                       use_pallas: bool = False, mesh=None, device=None
                       ) -> Dict[str, object]:
    """Rank-1 retrieval and the N-class filter math over the synthetic
    population: gallery and probe crops of disjoint draws, rank-1 through
    ``pipelines.similarity.topk_similar`` on ``device`` (the card unless
    the CPU is asked; ``use_pallas`` streams the gallery through the B4
    kernel), each class's mean and max-distance threshold, the probes
    routed same / cross, and each identity's margin (nearest other mean
    less farthest own probe). ``ok``: rank-1 1.0, cross 1.0, every margin
    positive and same-id routing >= 0.93."""
    from ..pipelines.similarity import ref_mean_and_threshold, topk_similar

    gal_sets = make_multi_identity_crops(gallery_seed, n_gallery, size=size,
                                         n_identities=n_identities)
    probe_sets = make_multi_identity_crops(probe_seed, n_probe, size=size,
                                           n_identities=n_identities)
    gal = np.concatenate([embed_u8_fn(np.stack(c)) for c in gal_sets])
    gal_ids = np.repeat(np.arange(n_identities), n_gallery)
    probes = np.concatenate([embed_u8_fn(np.stack(c)) for c in probe_sets])
    probe_ids = np.repeat(np.arange(n_identities), n_probe)

    _, idx = topk_similar(probes, gal, k=1, use_pallas=use_pallas,
                          mesh=mesh, device=device)
    rank1 = float((gal_ids[idx[:, 0]] == probe_ids).mean())
    means, thres = [], []
    for cid in range(n_identities):
        m, t = ref_mean_and_threshold(gal[gal_ids == cid])
        means.append(m)
        thres.append(t)
    means = np.stack(means)
    thres = np.asarray(thres, np.float32)
    d = np.linalg.norm(probes[:, None] - means[None], axis=-1)  # [P, N]
    same = d[np.arange(len(probes)), probe_ids]
    same_acc = float((same <= thres[probe_ids]).mean())
    cross_mask = probe_ids[:, None] != np.arange(n_identities)[None]
    cross_acc = float((d > thres[None])[cross_mask].mean())
    margins = np.asarray([
        float(d[probe_ids == cid][:, np.arange(n_identities) != cid].min()
              - same[probe_ids == cid].max())
        for cid in range(n_identities)])
    ok = rank1 == 1.0 and same_acc >= 0.93 and cross_acc == 1.0 \
        and margins.min() > 0
    return {"ok": bool(ok), "rank1": rank1, "same_acc": same_acc,
            "cross_acc": cross_acc, "n_identities": n_identities,
            "margin_min": float(margins.min()),
            "margin_median": float(np.median(margins)),
            "margin_max": float(margins.max()),
            "margins": [float(x) for x in margins],
            "top1": idx[:, 0].copy()}


def evaluate_identity_filter(embed_u8_fn: Callable[[np.ndarray],
                                                   np.ndarray],
                             ref_seed: int = 101, probe_seed: int = 202,
                             n_ref: int = 64, n_probe: int = 16,
                             size: int = 112) -> Dict[str, object]:
    """Score an embedder (uint8 BGR crops -> [N, D]) with the similar-face
    filter's math: each identity's mean and max-distance threshold from the
    first 32 (``MAX_N_REF_IMGS``) of ``n_ref`` reference crops (all are
    drawn, so that later identities get the same crops), held-out probes
    routed by ``||f - mean|| <= thres``. ``ok``: every same-identity probe
    accepted, every cross-identity probe rejected, and a positive margin
    (nearest other mean less farthest own probe)."""
    from ..pipelines.similarity import MAX_N_REF_IMGS, ref_mean_and_threshold

    refs = make_identity_crops(ref_seed, n_ref, size=size)
    probes = make_identity_crops(probe_seed, n_probe, size=size)
    means, thres = [], []
    for crops in refs:
        m, t = ref_mean_and_threshold(
            embed_u8_fn(np.stack(crops[:MAX_N_REF_IMGS])))
        means.append(m)
        thres.append(t)
    n_same_ok = n_cross_ok = 0
    margins = []
    for cid in range(N_IDENTITIES):
        emb = embed_u8_fn(np.stack(probes[cid]))  # [P, D]
        d = np.linalg.norm(emb[:, None] - np.stack(means)[None], axis=-1)
        same = d[:, cid]
        cross = np.delete(d, cid, axis=1)
        n_same_ok += int((same <= thres[cid]).sum())
        other_thres = np.delete(np.asarray(thres), cid)[None]
        n_cross_ok += int((cross > other_thres).sum())
        margins.append(float(cross.min() - same.max()))
    n_same = N_IDENTITIES * n_probe
    n_cross = N_IDENTITIES * n_probe * (N_IDENTITIES - 1)
    ok = n_same_ok == n_same and n_cross_ok == n_cross and min(margins) > 0
    return {"ok": bool(ok), "same_acc": n_same_ok / n_same,
            "cross_acc": n_cross_ok / n_cross,
            "margin": float(min(margins)),
            "thresholds": [float(t) for t in thres]}


def identity_train_sets(embedder_size: int, n_identities: int,
                        n_train_per_id: int, seed: int, aug_scale: float
                        ) -> List[List[np.ndarray]]:
    """The training crops: the three golden identities, or the synthetic
    population with the three donors given 1.5x the samples."""
    if n_identities <= N_IDENTITIES:
        return make_identity_crops(seed + 1, n_train_per_id,
                                   size=embedder_size, aug_scale=aug_scale)
    sets = make_multi_identity_crops(seed + 1, n_train_per_id,
                                     size=embedder_size,
                                     n_identities=n_identities,
                                     aug_scale=aug_scale)
    extra = make_multi_identity_crops(seed + 7, n_train_per_id // 2,
                                      size=embedder_size,
                                      n_identities=N_IDENTITIES,
                                      aug_scale=aug_scale)
    for cid in range(N_IDENTITIES):
        sets[cid] = list(sets[cid]) + list(extra[cid])
    return sets


def meta_path(ckpt_out: str) -> str:
    """The ``golden_meta.json`` sidecar beside a checkpoint."""
    return os.path.join(os.path.dirname(os.path.abspath(ckpt_out)),
                        "golden_meta.json")


def train_golden_embedder(ckpt_out: str, batch_size: int = 48,
                          max_steps: int = 600, eval_every: int = 50,
                          n_train_per_id: int = 96, lr: float = 0.01,
                          seed: int = 0, embedder: str = "mobile_facenet",
                          aug_scale: float = 1.6, center_gain: float = 0.02,
                          n_identities: int = 3, device=None,
                          log=print) -> Dict[str, object]:
    """Identity crops -> ArcFace training on ``device`` (the card unless
    the CPU is asked) -> the filter gate every ``eval_every`` steps (and
    retrieval with ``n_identities`` > 3) -> a ``.pt`` checkpoint of the
    slot's net and its ``golden_meta.json`` -> a fresh engine's
    ``load_embed_weights`` -> regate through ``FaceEngine.embed_crops``.

    ArcFace's s is 16 (at 64 the CE saturates to 0 on three identities and
    the center term alone collapses the classes). Returns the gate's
    result plus ``steps``, ``losses``, ``reload_ok``, ``reload_margin``
    (and the retrieval results) and ``embed``, the in-memory net's uint8
    embed function."""
    from ..core.engine import EngineConfig, FaceEngine, _full_f32
    from ..models.embedders import get_embedder, preprocess_crops
    from ..ops.platform import resolve_device
    from .arcface import (ArcFaceTrainConfig, create_train_state,
                          make_train_step)

    dev = resolve_device(device)
    spec = get_embedder(embedder)
    size = spec.input_size[0]
    train_sets = identity_train_sets(size, n_identities, n_train_per_id,
                                     seed, aug_scale)
    xs = torch.from_numpy(np.concatenate(
        [np.stack(c) for c in train_sets]).astype(np.uint8)).to(dev)
    ys = torch.from_numpy(np.concatenate(
        [np.full(len(c), cid, np.int64)
         for cid, c in enumerate(train_sets)])).to(dev)
    log(f"[golden-embed] train crops: {len(xs)} over {len(train_sets)} ids "
        f"({embedder}, {size}px, {spec.dim}-d, u8 device-resident)")

    cfg = ArcFaceTrainConfig(num_classes=len(train_sets), lr=lr,
                             embedder=embedder, embedding_size=spec.dim,
                             s=16.0, center_gain=center_gain)
    state = create_train_state(cfg, torch.Generator().manual_seed(seed),
                               device=dev)
    step = make_train_step(state)
    net = state["net"]

    def embed_u8(crops_u8: np.ndarray) -> np.ndarray:
        net.eval()
        try:
            with torch.inference_mode(), _full_f32(dev):
                x = torch.as_tensor(np.ascontiguousarray(crops_u8)).to(dev)
                return net(preprocess_crops(spec, x.float())).cpu().numpy()
        finally:
            net.train()

    def gate() -> Dict[str, object]:
        r = evaluate_identity_filter(embed_u8, size=size)
        if n_identities > N_IDENTITIES:
            rr = evaluate_retrieval(embed_u8, size=size,
                                    n_identities=n_identities, device=dev)
            r["retrieval"] = rr
            r["ok"] = r["ok"] and rr["ok"]
        return r

    rng = np.random.RandomState(seed)
    result: Dict[str, object] = {"ok": False}
    losses: List[float] = []
    for i in range(max_steps):
        sel = torch.from_numpy(rng.choice(len(xs), batch_size,
                                          replace=False)).to(dev)
        bx = preprocess_crops(spec, xs.index_select(0, sel).float())
        loss = step(bx, ys.index_select(0, sel))
        if (i + 1) % 25 == 0:
            losses.append(float(loss))
            log(f"[golden-embed] step {i + 1} loss {losses[-1]:.4f}")
        if (i + 1) % eval_every == 0 or i + 1 == max_steps:
            r = gate()
            log(f"[golden-embed] eval@{i + 1}: same={r['same_acc']:.2f} "
                f"cross={r['cross_acc']:.2f} margin={r['margin']:.3f}")
            if r["ok"]:
                result = dict(r, steps=i + 1)
                break
    if not result.get("ok"):
        result = dict(gate(), steps=max_steps)

    net.eval()
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
               ckpt_out)
    with open(meta_path(ckpt_out), "w") as fh:
        json.dump({"embedder": embedder, "n_identities": n_identities,
                   "steps": int(result.get("steps", max_steps))}, fh)
    log(f"[golden-embed] checkpoint saved to {ckpt_out}")

    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder=embedder), device=dev)
    eng.load_embed_weights(ckpt_out)
    reload = evaluate_identity_filter(eng.embed_crops, size=size)
    result.update(reload_ok=reload["ok"], reload_margin=reload["margin"],
                  losses=losses, embed=embed_u8, engine=eng)
    if n_identities > N_IDENTITIES:
        rr = evaluate_retrieval(eng.embed_crops, size=size,
                                n_identities=n_identities, device=dev)
        result["reload_retrieval"] = rr
        result["reload_ok"] = result["reload_ok"] and rr["ok"]
    log(f"[golden-embed] reload gate: {result['reload_ok']} "
        f"margin={reload['margin']:.3f}")
    return result
