"""The plain versions of the port's CUDA kernels against the Pallas kernels
they replace (interpret mode, CPU) and the JAX package's jnp paths, and the
wrappers' CPU path.

The kernels themselves run only on the card; ``chip_smoke.py`` holds each
against its plain version there."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.ops import nms as JN
from face_detection_and_recognition_tpu.ops.pallas_kernels import (
    candidate_rows_gather_pallas, nms_fixpoint_pallas, topk_gallery_pallas,
    weighted_blend_nms_pallas)
from face_detection_and_recognition_tpu_torch.models.blazeface import \
    generate_anchors
from face_detection_and_recognition_tpu_torch.models.yolov5_face import \
    FACE_ANCHORS
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from tests.test_nms import random_boxes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_SETS = [(False, True, "union"), (True, False, "union"),
               (True, False, "min")]


def _sorted_case(rng, n):
    """Score-sorted pixel boxes with duplicate boxes, score ties and
    invalid rows."""
    boxes = random_boxes(rng, n, size=300.0)
    boxes[10:14] = boxes[2:6]
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    scores[30:36] = scores[3]
    order = np.argsort(-scores, kind="stable")
    valid = rng.uniform(size=n) > 0.2
    return boxes[order], valid[order], boxes, scores, valid, order


@pytest.mark.parametrize("plus1,strict,mode", OPTION_SETS)
def test_nms_plain_equals_pallas_and_jnp(rng, plus1, strict, mode):
    cases = [_sorted_case(rng, 96) for _ in range(2)]
    sboxes = np.stack([c[0] for c in cases])
    svalid = np.stack([c[1] for c in cases])
    keep = ck.nms_fixpoint_plain(torch.from_numpy(sboxes),
                                 torch.from_numpy(svalid), 0.3, plus1,
                                 strict, mode).numpy()
    for i, (sb, sv, boxes, scores, valid, order) in enumerate(cases):
        # keep masks are decisions: exactly equal
        ref = np.asarray(nms_fixpoint_pallas(sb, sv, 0.3, plus1=plus1,
                                             strict=strict, mode=mode,
                                             interpret=True))
        np.testing.assert_array_equal(keep[i], ref)
        # the unsorted jnp path keeps the same boxes
        ref_mask = np.asarray(JN.greedy_nms_mask(
            boxes, scores, valid, 0.3, plus1=plus1, strict=strict, mode=mode))
        np.testing.assert_array_equal(keep[i], ref_mask[order])
    assert not keep[~svalid].any()


# ---------------- B1: the blocked sweep of csrc/nms.cu ----------------

SWEEP_WARPS = 8  # nms_sweep_kernel's CTA: 256 threads


def _overlap_words(boxes, thr, plus1, strict, mode, rng):
    """Phase 1 of csrc/nms.cu in numpy float32, the IoU in the kernel's
    operation order: [K, W] uint32 words, bit j of word w of row i set when
    j = 32 w + bit > i overlaps row i. The words left of the diagonal are
    never written by the kernel: they hold noise here, which the sweep
    must never read."""
    k = boxes.shape[0]
    n_words = (k + 31) // 32
    off = np.float32(1.0 if plus1 else 0.0)
    x1, y1, x2, y2 = (boxes[:, c] for c in range(4))
    iw = np.maximum(np.minimum(x2[:, None], x2[None]) -
                    np.maximum(x1[:, None], x1[None]) + off, np.float32(0))
    ih = np.maximum(np.minimum(y2[:, None], y2[None]) -
                    np.maximum(y1[:, None], y1[None]) + off, np.float32(0))
    inter = iw * ih
    area = (x2 - x1 + off) * (y2 - y1 + off)
    if mode == "min":
        denom = np.minimum(area[:, None], area[None])
    else:
        denom = area[:, None] + area[None] - inter
        if plus1:
            denom = denom + np.float32(1e-16)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / denom
    hit = (iou > np.float32(thr)) if strict else (iou >= np.float32(thr))
    hit = np.triu(hit, 1)
    bits = np.zeros((k, n_words * 32), bool)
    bits[:, :k] = hit
    words = (bits.reshape(k, n_words, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    noise = rng.randint(0, 2 ** 32, (k, n_words), dtype=np.uint64)
    left = np.arange(n_words)[None] < (np.arange(k) // 32)[:, None]
    return np.where(left, noise.astype(np.uint32), words)


def _blocked_sweep(words, valid):
    """Phase 2 of csrc/nms.cu: blocks of 32 rows, the block's removed word
    resolved against its 32 diagonal words by the unrolled recurrence, then
    the kept rows' words right of the diagonal ORed into removed as the
    CTA's threads split them: warp g over rows g, g + 8, g + 16, g + 24,
    lane over words blk + 1 + lane + 32 m, one OR a (warp, word)."""
    k, n_words = words.shape
    full = 0xFFFFFFFF
    removed = []
    for w in range(n_words):
        bits = sum(1 << b for b in range(32)
                   if w * 32 + b < k and valid[w * 32 + b])
        removed.append(~bits & full)
    keep = np.zeros(k, bool)
    for blk in range(n_words):
        # the block's loads: rows < K, words blk .. W-1
        rows = {l: words[blk * 32 + l] for l in range(min(32, k - blk * 32))}
        r = removed[blk]
        for l in range(32):
            if not (r >> l) & 1:
                r |= int(rows[l][blk])
        kept = ~r & full
        for l in range(min(32, k - blk * 32)):
            keep[blk * 32 + l] = (kept >> l) & 1
        if kept:
            for g in range(SWEEP_WARPS):
                for w in range(blk + 1, n_words):
                    acc = 0
                    for l in range(g, 32, SWEEP_WARPS):
                        if (kept >> l) & 1:
                            acc |= int(rows[l][w])
                    removed[w] |= acc
    return keep


def _chain_boxes(k):
    """Boxes 8 px apart on a row of 20 px boxes: each overlaps its
    neighbours (IoU >= 0.43 in every option set) but not the box two along
    (<= 0.24), so suppression runs down the chain and the keep mask
    alternates across every 32-row block boundary."""
    x = 8.0 * np.arange(k, dtype=np.float32)
    return np.stack([x, np.zeros(k, np.float32), x + 20.0,
                     np.full(k, 20.0, np.float32)], -1)


def _sweep_case(name, rng):
    """(boxes [B, K, 4], valid [B, K]), score-sorted."""
    if name == "k1000":  # K not a multiple of 32
        boxes = random_boxes(rng, 1000, size=600.0)[None]
        valid = rng.uniform(size=(1, 1000)) > 0.1
    elif name == "chains":  # suppression chains across block boundaries
        boxes = np.stack([_chain_boxes(100), _chain_boxes(100)[::-1].copy()])
        valid = np.ones((2, 100), bool)
        valid[0, [31, 64, 65]] = False
    elif name == "identical":  # groups of identical boxes, interleaved
        base = random_boxes(rng, 10, size=200.0)
        boxes = np.stack([base[rng.randint(0, 10, 70)] for _ in range(8)])
        valid = rng.uniform(size=(8, 70)) > 0.1
    elif name == "all_invalid":
        boxes = np.stack([random_boxes(rng, 33, size=100.0)
                          for _ in range(8)])
        valid = np.zeros((8, 33), bool)
    else:  # "b8": 8 images of overlapping boxes with duplicates
        boxes = np.stack([random_boxes(rng, 200, size=150.0)
                          for _ in range(8)])
        boxes[:, 40:60] = boxes[:, 0:20]
        valid = rng.uniform(size=(8, 200)) > 0.2
    return boxes.astype(np.float32), valid


@pytest.mark.parametrize("plus1,strict,mode", OPTION_SETS)
@pytest.mark.parametrize("case", ["k1000", "chains", "identical",
                                  "all_invalid", "b8"])
def test_nms_blocked_sweep_model_equals_plain_and_jnp(case, plus1, strict,
                                                      mode):
    """A numpy model of the kernel's two phases (32-row blocks, the
    diagonal word resolved in registers, kept rows ORed into removed) keeps
    exactly what nms_fixpoint_plain and the JAX package's greedy_nms_mask
    keep, never reading a word left of the diagonal."""
    rng = np.random.RandomState(sum(map(ord, case)))
    boxes, valid = _sweep_case(case, rng)
    plain = ck.nms_fixpoint_plain(torch.from_numpy(boxes),
                                  torch.from_numpy(valid), 0.3, plus1,
                                  strict, mode).numpy()
    k = boxes.shape[1]
    scores = np.linspace(1.0, 0.01, k, dtype=np.float32)  # already sorted
    for b in range(boxes.shape[0]):
        words = _overlap_words(boxes[b], 0.3, plus1, strict, mode, rng)
        model = _blocked_sweep(words, valid[b])
        np.testing.assert_array_equal(model, plain[b])
        ref = np.asarray(JN.greedy_nms_mask(boxes[b], scores, valid[b], 0.3,
                                            plus1=plus1, strict=strict,
                                            mode=mode))
        np.testing.assert_array_equal(model, ref)
    if case == "chains":  # the chain really alternates across blocks
        assert plain[1, 30:36].tolist() == [True, False] * 3
    if case == "all_invalid":
        assert not plain.any()


def _levels(rng, b, hw=256):
    """Head maps of a yolov5 P5 net at hw x hw: 3 anchors x (hw/s)^2 rows of
    16 per level, flattened, with saturated logits for ties."""
    levels = []
    for s in (8, 16, 32):
        n = 3 * (hw // s) ** 2
        m = rng.normal(0, 3, (b, n, 16)).astype(np.float32)
        m[:, ::7, 4] = 30.0
        levels.append(m)
    return levels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_gather_plain_equals_pallas(rng, dtype):
    b, k = 2, 64
    levels_np = _levels(rng, b)
    n = sum(m.shape[1] for m in levels_np)
    idx = np.stack([rng.permutation(n)[:k] for _ in range(b)]).astype(np.int32)
    idx[:, :4] = [0, n - 1, levels_np[0].shape[1], levels_np[0].shape[1] - 1]
    jlevels = [jnp.asarray(m, getattr(jnp, dtype)) for m in levels_np]
    ref = np.asarray(candidate_rows_gather_pallas(
        tuple(jlevels), jnp.asarray(idx), interpret=True).astype(jnp.float32))
    # bf16 values cross over through f32 exactly
    tlevels = [torch.from_numpy(np.array(m.astype(jnp.float32)))
               .to(getattr(torch, dtype)) for m in jlevels]
    got = ck.rows_gather_plain(tlevels, torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)  # a copy: exact


def test_wrappers_take_plain_path_on_cpu(rng):
    ck.reset_launches()
    sb, sv = _sorted_case(rng, 64)[:2]
    boxes, valid = torch.from_numpy(sb)[None], torch.from_numpy(sv)[None]
    np.testing.assert_array_equal(
        ck.nms_fixpoint(boxes, valid, 0.3, plus1=True, strict=False).numpy(),
        ck.nms_fixpoint_plain(boxes, valid, 0.3, plus1=True,
                              strict=False).numpy())
    levels = [torch.from_numpy(m) for m in _levels(rng, 1, hw=64)]
    idx = torch.arange(0, 250, 3, dtype=torch.int32)[None]
    args = (levels, idx, FACE_ANCHORS, (8, 16, 32), (64, 64), 0.4)
    for got, ref in zip(ck.candidate_decode(*args),
                        ck.candidate_decode_plain(*args)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    q = torch.from_numpy(rng.normal(0, 1, (3, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (50, 8)).astype(np.float32))
    for got, ref in zip(ck.topk_gallery(q, g, 4),
                        ck.topk_gallery_plain(q, g, 4)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    sd, sv = (torch.from_numpy(a)[None] for a in _blend_case(rng, 32))
    for got, ref in zip(ck.blend_nms(sd, sv, 0.3, 8),
                        ck.blend_nms_plain(sd, sv, 0.3, 8)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    raw = [torch.from_numpy(a) for a in _blaze_heads(rng, 2, 0.65)]
    args = (*raw, torch.from_numpy(_ANCHORS), 256.0, 100.0, 0.65, 0.3, 16)
    for got, ref in zip(ck.blaze_decode_blend(*args),
                        ck.blaze_decode_blend_plain(*args)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    from face_detection_and_recognition_tpu_torch.ops import int8_conv

    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 9, 7)).astype(np.float32))
    kq = torch.from_numpy(rng.randint(-127, 128, (6, 3, 3, 8))
                          .astype(np.int8))
    ws, bias = torch.full((6,), 0.01), torch.zeros(6)
    torch.testing.assert_close(
        int8_conv.conv_int8(x, kq, ws, bias, 2, 1, 1, "silu"),
        int8_conv.conv_int8_plain(x, kq, ws, bias, 2, 1, 1, "silu"),
        rtol=0, atol=0)
    # the CPU path launches nothing and builds nothing
    assert ck.LAUNCHES == {"nms_fixpoint": 0, "rows_gather": 0,
                           "crop_resize": 0, "topk_gallery": 0,
                           "blend_nms": 0, "blaze_decode_blend": 0,
                           "conv_int8": 0}
    assert ck._LIB == []
    # the wrapper's k cap holds on every device
    with pytest.raises(ValueError, match="outside"):
        ck.topk_gallery(q, g, ck.TOPK_MAX_K + 1)


# ---------------- B4: streaming gallery top-k ----------------


def _gallery_case(rng, n, m, d, negative=False, dup=False):
    q = rng.normal(0, 1, (n, d)).astype(np.float32)
    g = rng.normal(0, 1, (m, d)).astype(np.float32)
    if negative:  # every score below 0: pad rows (0) must not displace them
        q = np.abs(q)
        g = -np.abs(g)
    if dup:  # exact ties: the smaller gallery index must come first
        g[m // 2] = g[3]
        g[m - 1] = g[3]
        g[m // 3] = g[m // 4]
    return q, g


# (n, m, d, k, block_m, case): several block sizes, M not a block
# multiple, negative scores, M < k, exact ties
TOPK_CASES = [
    (8, 1024, 32, 8, 256, {}),
    (5, 1000, 24, 5, 128, {"dup": True}),
    (4, 300, 16, 5, 64, {"dup": True}),
    (2, 100, 8, 4, 64, {"negative": True}),
    (3, 3, 16, 5, 64, {}),
    (6, 777, 40, 1, 512, {"dup": True}),
]


@pytest.mark.parametrize("n,m,d,k,block_m,case", TOPK_CASES)
def test_topk_gallery_plain_equals_pallas(n, m, d, k, block_m, case):
    q, g = _gallery_case(np.random.RandomState(n * m), n, m, d, **case)
    ref_s, ref_i = topk_gallery_pallas(q, g, k=k, block_m=block_m,
                                       interpret=True)
    got_s, got_i = ck.topk_gallery_plain(torch.from_numpy(q),
                                         torch.from_numpy(g), k, chunk=256)
    assert got_i.dtype == torch.int32 and tuple(got_s.shape) == (n, k)
    # decisions exactly; scores are d-term f32 sums in another order
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-6,
                               atol=1e-5)
    if m < k:  # the tail of the Pallas kernel: (-1e30, 0)
        assert (got_s.numpy()[:, m:] == np.float32(-1e30)).all()
        assert (got_i.numpy()[:, m:] == 0).all()


def test_topk_gallery_plain_chunks_do_not_change_it():
    """The streaming chunk is not part of the function: any chunk gives the
    same scores bit for bit, and the same indices."""
    q, g = _gallery_case(np.random.RandomState(5), 4, 500, 16, dup=True)
    q, g = torch.from_numpy(q), torch.from_numpy(g)
    ref = ck.topk_gallery_plain(q, g, 7, chunk=500)
    for chunk in (1, 64, 333):
        got = ck.topk_gallery_plain(q, g, 7, chunk=chunk)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)


def test_topk_gallery_plain_is_the_fma_chain():
    """Every score of the plain version is the float32 FMA chain from 0 over
    d = 0 .. D-1: float32 rounding, step by step, of a float64 chain whose
    products are exact, each step checked against ``_fma_f32`` (so no step
    is a double-rounding case). Bit for bit, at every listed rank."""
    rng = np.random.RandomState(11)
    q = rng.normal(0, 1, (3, 48)).astype(np.float32)
    g = rng.normal(0, 1, (40, 48)).astype(np.float32)
    k = ck.TOPK_MAX_K
    s, i = ck.topk_gallery_plain(torch.from_numpy(q), torch.from_numpy(g), k)
    s, i = s.numpy(), i.numpy()
    for n in range(q.shape[0]):
        for r in range(k):
            row = g[i[n, r]]
            acc = np.float32(0.0)
            for d in range(q.shape[1]):
                # a float32 product is exact in float64 (24 + 24 bits)
                step = np.float32(np.float64(q[n, d]) * np.float64(row[d])
                                  + np.float64(acc))
                fma = ck._fma_f32(*(torch.tensor(v) for v in
                                    (q[n, d], row[d], acc)))
                assert step.view(np.int32) == fma.numpy().view(np.int32)
                acc = step
            assert acc.view(np.int32) == s[n, r].view(np.int32), (n, r)


# ---------------- B5: weighted-blend NMS ----------------


def _blend_case(rng, k, d=17):
    """Score-sorted BlazeFace rows [ymin, xmin, ymax, xmax, 12 kps, score]:
    clusters of overlapping boxes, singletons, an inverted box and invalid
    rows."""
    base = rng.uniform(0.1, 0.7, (k, 2)).astype(np.float32)
    wh = rng.uniform(0.05, 0.3, (k, 2)).astype(np.float32)
    dets = np.zeros((k, d), np.float32)
    dets[:, 0:2] = base
    dets[:, 2:4] = base + wh
    dets[5] = dets[4]
    dets[5, :4] += 0.01
    dets[6] = dets[4]
    dets[6, :4] += 0.02
    dets[9, 2:4] = dets[9, 0:2] - 0.1  # inverted: self-IoU is not 1
    dets[:, 4:d - 1] = rng.standard_normal((k, d - 5)).astype(np.float32)
    dets[:, d - 1] = rng.uniform(0.3, 1.0, k).astype(np.float32)
    valid = np.ones(k, bool)
    valid[-5:] = False
    order = np.argsort(-np.where(valid, dets[:, -1], -1e30), kind="stable")
    return dets[order], valid[order]


def pallas_slots(sdets, svalid, max_out):
    """The Pallas kernel's rows and keep mask compacted into max_out slots,
    as ``ops/nms.py`` does on the TPU (zero slots past K when K <
    max_out)."""
    rows, keep = weighted_blend_nms_pallas(sdets, svalid, 0.3,
                                           interpret=True)
    rows, keep = np.asarray(rows), np.asarray(keep)
    order = np.argsort(np.where(keep, 0, 1), kind="stable")[:max_out]
    order = np.pad(order, (0, max_out - len(order)))
    valid = keep[order] & (np.arange(max_out) < len(keep))
    return np.where(valid[:, None], rows[order], 0.0), valid


@pytest.mark.parametrize("k,max_out,none_valid", [
    (64, 16, False), (128, 16, False), (40, 40, False), (12, 16, False),
    (48, 16, True)])
def test_blend_nms_plain_equals_fori_and_pallas(k, max_out, none_valid):
    sdets, svalid = _blend_case(np.random.RandomState(k), k)
    if none_valid:
        svalid[:] = False
    got, got_v = ck.blend_nms_plain(torch.from_numpy(sdets)[None],
                                    torch.from_numpy(svalid)[None], 0.3,
                                    max_out)
    got, got_v = got[0].numpy(), got_v[0].numpy()
    assert got.shape == (max_out, 17) and got_v.shape == (max_out,)
    # the fori loop of ops/nms.py: picks exactly, rows to f32 rounding of
    # sums over up to k rows taken in another order
    ref, ref_v = JN.weighted_blend_nms(jnp.asarray(sdets),
                                       jnp.asarray(svalid), 0.3, max_out)
    np.testing.assert_array_equal(got_v, np.asarray(ref_v))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert (got[~got_v] == 0).all()
    # the Pallas kernel: the same keep set, rows as its own test holds them
    p_rows, p_keep = pallas_slots(sdets, svalid, max_out)
    np.testing.assert_array_equal(got_v, p_keep)
    np.testing.assert_allclose(got, p_rows, rtol=1e-5, atol=1e-5)
    assert got_v.any() != none_valid


def test_blend_nms_plain_nothing_valid_and_batches():
    rng = np.random.RandomState(6)
    cases = [_blend_case(rng, 48) for _ in range(3)]
    sdets = torch.from_numpy(np.stack([c[0] for c in cases]))
    svalid = torch.from_numpy(np.stack([c[1] for c in cases]))
    svalid[1] = False
    out, ov = ck.blend_nms_plain(sdets, svalid, 0.3, 16)
    assert not ov[1].any() and (out[1] == 0).all()
    for i in (0, 2):  # each image of the batch as it is alone
        one, one_v = ck.blend_nms_plain(sdets[i:i + 1], svalid[i:i + 1],
                                        0.3, 16)
        torch.testing.assert_close(out[i], one[0], rtol=0, atol=0)
        torch.testing.assert_close(ov[i], one_v[0], rtol=0, atol=0)


# ---------------- B5: the picks and blends of csrc/blend_nms.cu ---------------

BLEND_SLOT_CHUNK = 32  # kSlotChunk: slots picked before a blend pass
F32 = np.float32
_ANCHORS = generate_anchors()


def _blaze_heads(rng, b, thr, case="ties"):
    """Raw BlazeFace heads ([B, 896, 16], [B, 896, 1] f32): box offsets in
    input pixels and logits spread around the score threshold, some at
    +-150 (ties at sigmoid 1.0), as tests/test_torch_blazeface.py's
    ``_raw_heads``. "none" puts every logit below the threshold, "all"
    every one above it, "inverted" gives anchor 10 a box of negative width
    and height at score 1.0, "identical" gives the two anchors of each
    16 x 16 cell one raw row, so they decode to one box and one score."""
    logit = np.log(thr / (1 - thr))
    raw_boxes = rng.normal(0, 6, (b, 896, 16)).astype(F32)
    raw_boxes[..., 2:4] = rng.uniform(10, 30, (b, 896, 2))
    noise = rng.normal(0, 1.5, (b, 896, 1))
    raw_scores = (logit + noise).astype(F32)
    raw_scores[:, ::97] = 150.0
    raw_scores[:, 5::101] = -150.0
    if case == "none":
        raw_scores = (logit - 0.01 - np.abs(noise)).astype(F32)
    elif case == "all":
        raw_scores = (logit + 0.01 + np.abs(noise)).astype(F32)
        raw_scores[:, ::97] = 150.0
    elif case == "inverted":
        raw_boxes[:, 10, 2:4] = -20.0
        raw_scores[:, 10] = 150.0
    elif case == "identical":
        raw_boxes[:, 1:512:2] = raw_boxes[:, 0:512:2]
        raw_scores[:, 1:512:2] = raw_scores[:, 0:512:2]
    return raw_boxes, raw_scores


def _order_keys(scores, idx):
    """The fused kernel's 64-bit sort keys: the complement of each f32
    score's order bits, above its row index. Ascending keys are descending
    scores, ties in row order."""
    u = scores.astype(F32).view(np.uint32).astype(np.uint64)
    ordb = np.where(u >> 31 == 1, ~u & 0xFFFFFFFF, u | 0x80000000)
    return ((~ordb & 0xFFFFFFFF) << 32) | idx.astype(np.uint64)


def _bitonic(keys):
    """The kernel's bitonic network, ascending, over the keys padded to a
    power of two >= 32 with the largest key: at stage (k, j) element t
    keeps the smaller of itself and t ^ j where (t & j == 0) equals
    (t & k == 0), else the larger."""
    n, p = len(keys), 32
    while p < n:
        p *= 2
    a = np.full(p, np.iinfo(np.uint64).max, np.uint64)
    a[:n] = keys
    t = np.arange(p)
    k = 2
    while k <= p:
        j = k // 2
        while j:
            other = a[t ^ j]
            keep_min = ((t & j) == 0) == ((t & k) == 0)
            a = np.where(keep_min == (other < a), other, a)
            j //= 2
        k *= 2
    return a[:n]


def _words(bits):
    """A bool row mask as the kernel's 32-bit words (bit l of word w: row
    32 w + l), Python ints."""
    n_words = (len(bits) + 31) // 32
    padded = np.zeros(n_words * 32, bool)
    padded[:len(bits)] = bits
    return [int(sum(1 << l for l in range(32) if padded[32 * w + l]))
            for w in range(n_words)]


def _pick_and_blend(rows, alive, thr, max_out, reorder=False,
                    chunk=BLEND_SLOT_CHUNK):
    """``pick_and_blend`` of csrc/blend_nms.cu on one frame, in numpy f32.

    rows: [n, D] in score order, score last, cols 0:4 [ymin, xmin, ymax,
    xmax]; alive: the rows' alive words. For each slot the first set bit of
    the words is the pick; each word's taken bits are its alive rows whose
    IoU with the pick (the kernel's operation order) is above ``thr``, and
    the pick itself; they leave "alive". After a chunk of slots, each
    (slot, column) chain walks its taken bits in ascending order, adding
    score and coord * score one row at a time. Returns (out [max_out, D],
    valid [max_out])."""
    n, d = rows.shape
    alive = list(alive)
    x1, y1, x2, y2 = rows[:, 1], rows[:, 0], rows[:, 3], rows[:, 2]
    area = (x2 - x1) * (y2 - y1)
    cols = [c ^ 1 if reorder and c < 4 else c for c in range(d)]
    out = np.zeros((max_out, d), F32)
    out_valid = np.zeros(max_out, bool)
    for s0 in range(0, max_out, chunk):
        taken = []
        for _ in range(min(chunk, max_out - s0)):
            live = [w for w, a in enumerate(alive) if a]
            if not live:
                break
            w0 = live[0]
            first = 32 * w0 + (alive[w0] & -alive[w0]).bit_length() - 1
            iw = np.maximum(np.minimum(x2[first], x2)
                            - np.maximum(x1[first], x1), F32(0))
            ih = np.maximum(np.minimum(y2[first], y2)
                            - np.maximum(y1[first], y1), F32(0))
            inter = iw * ih
            with np.errstate(divide="ignore", invalid="ignore"):
                over = inter / ((area[first] + area) - inter) > F32(thr)
            over[first] = True
            words = _words(over)
            taken.append([a & t for a, t in zip(alive, words)])
            alive = [a & ~t for a, t in zip(alive, taken[-1])]
        for s, tw in enumerate(taken):
            picked = [32 * w + l for w, word in enumerate(tw)
                      for l in range(32) if word >> l & 1]
            total, num = F32(0), np.zeros(d, F32)
            for r in picked:
                sc = rows[r, d - 1]
                total = F32(total + sc)
                num = num + rows[r] * sc
            if len(picked) == 1:
                v = rows[picked[0]]
            else:
                v = num / total
                v[d - 1] = total / F32(len(picked))
            out[s0 + s] = v[cols]
            out_valid[s0 + s] = True
        if len(taken) < min(chunk, max_out - s0):
            break  # nothing alive: the rest stay zero
    return out, out_valid


def _fused_model(raw_boxes, raw_scores, anchors, scale, clip, score_thr,
                 iou_thr, max_out):
    """The fused entry point of csrc/blend_nms.cu, frame by frame: clip and
    sigmoid (ATen's, which the kernel's form matches on the card), the
    valid anchors compacted in anchor order and bitonic-sorted by
    ``_order_keys``, each decoded into its sorted row in f32 with the
    kernel's separate operations, then ``_pick_and_blend`` with the
    contract's column order."""
    outs, valids = [], []
    sc = F32(scale)
    for rb, rs in zip(raw_boxes, raw_scores):
        score = torch.sigmoid(torch.from_numpy(
            np.clip(rs[:, 0], F32(-clip), F32(clip)))).numpy()
        idx = np.nonzero(score >= F32(score_thr))[0]
        order = (_bitonic(_order_keys(score[idx], idx))
                 & 0xFFFFFFFF).astype(np.int64)
        r, a = rb[order], anchors[order]
        xc = r[:, 0] / sc * a[:, 2] + a[:, 0]
        yc = r[:, 1] / sc * a[:, 3] + a[:, 1]
        hw = r[:, 2] / sc * a[:, 2] / F32(2)
        hh = r[:, 3] / sc * a[:, 3] / F32(2)
        cols = [yc - hh, xc - hw, yc + hh, xc + hw]
        for k in range(6):
            cols.append(r[:, 4 + 2 * k] / sc * a[:, 2] + a[:, 0])
            cols.append(r[:, 5 + 2 * k] / sc * a[:, 3] + a[:, 1])
        rows = np.stack(cols + [score[order]], -1).astype(F32)
        out, ov = _pick_and_blend(rows, _words(np.ones(len(idx), bool)),
                                  iou_thr, max_out, reorder=True)
        outs.append(out)
        valids.append(ov)
    return np.stack(outs), np.stack(valids)


def _assert_bits_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if got.dtype == np.float32:
        got, ref = got.view(np.uint32), ref.view(np.uint32)
    np.testing.assert_array_equal(got, ref)


def _standalone_case(case, rng):
    """(sdets [B, K, 17], svalid [B, K], max_out), score-sorted."""
    if case == "k2048":
        cases = [_blend_case(rng, 2048) for _ in range(2)]
        return np.stack([c[0] for c in cases]), \
            np.stack([c[1] for c in cases]), 16
    if case == "k12_max16":  # fewer rows than slots
        sd, sv = _blend_case(rng, 12)
        return sd[None], sv[None], 16
    if case == "none_valid":
        sd, sv = _blend_case(rng, 64)
        return sd[None], np.zeros_like(sv)[None], 16
    if case == "max40":  # more slots than a chunk: 40 picks of singletons
        sd = np.zeros((100, 17), np.float32)
        sd[:, 0] = sd[:, 1] = np.arange(100, dtype=np.float32)
        sd[:, 2:4] = sd[:, 0:2] + 0.5
        sd[:, 4:16] = rng.standard_normal((100, 12))
        sd[:, 16] = np.linspace(1.0, 0.5, 100, dtype=np.float32)
        return sd[None], np.ones((1, 100), bool), 40
    # "identical_tied": groups of identical boxes, tied scores, invalid
    # rows between the valid ones
    sd, _ = _blend_case(rng, 300)
    sd[:, :4] = sd[rng.randint(0, 20, 300), :4]
    sd[:, 16] = np.sort(np.round(sd[:, 16] * 8) / 8)[::-1]
    sv = rng.uniform(size=300) > 0.3
    return sd[None], sv[None], 16


@pytest.mark.parametrize("case,back", [
    ("ties", True), ("ties", False), ("none", True), ("all", False),
    ("all", True), ("inverted", True), ("identical", False)])
def test_blaze_fused_model_equals_plain(case, back):
    """A numpy model of the fused kernel (64-bit-key bitonic sort of the
    compacted valid anchors, decode into sorted rows, the alive and taken
    bit masks, the chains in ascending bit order) equals
    ``blaze_decode_blend_plain`` bit for bit, and its picks and blends
    equal ``blend_nms_plain`` on the plain chain's own sorted rows."""
    rng = np.random.RandomState(sum(map(ord, case)) + back)
    scale, thr = (256.0, 0.65) if back else (128.0, 0.75)
    raw_boxes, raw_scores = _blaze_heads(rng, 2, thr, case)
    model = _fused_model(raw_boxes, raw_scores, _ANCHORS, scale, 100.0, thr,
                         0.3, 16)
    plain = ck.blaze_decode_blend_plain(
        torch.from_numpy(raw_boxes), torch.from_numpy(raw_scores),
        torch.from_numpy(_ANCHORS), scale, 100.0, thr, 0.3, 16)
    for m, p in zip(model, plain):
        _assert_bits_equal(m, p.numpy())
    n_valid = model[1].sum(1)
    if case == "none":
        assert not model[1].any()
    else:
        assert (n_valid == 16).all(), n_valid
    if case == "inverted":  # score 1.0, the lowest anchor of its tie
        scores = torch.sigmoid(torch.from_numpy(raw_scores[..., 0])
                               .clamp(-100, 100))
        assert (scores[:, 10] == scores.max(1).values).all()


@pytest.mark.parametrize("case", ["k2048", "k12_max16", "none_valid",
                                  "max40", "identical_tied"])
def test_blend_core_model_equals_plain(case):
    """The standalone entry point's model (alive words from the valid
    bytes, then ``_pick_and_blend``) equals ``blend_nms_plain`` bit for
    bit."""
    rng = np.random.RandomState(sum(map(ord, case)))
    sdets, svalid, max_out = _standalone_case(case, rng)
    out, ov = ck.blend_nms_plain(torch.from_numpy(sdets),
                                 torch.from_numpy(svalid), 0.3, max_out)
    for b in range(sdets.shape[0]):
        m_out, m_v = _pick_and_blend(sdets[b], _words(svalid[b]), 0.3,
                                     max_out)
        _assert_bits_equal(m_out, out[b].numpy())
        _assert_bits_equal(m_v, ov[b].numpy())
    if case == "none_valid":
        assert not ov.any()
    if case == "max40":  # the second chunk of slots ran
        assert ov.all()
    if case in ("k2048", "identical_tied"):  # some slots blended rows
        assert ov.all()
        assert not np.isin(out[..., -1].numpy(), sdets[..., -1]).all()


def test_blaze_decode_blend_refuses_other_scales():
    """The kernel divides by ``scale`` exactly only for a power of two; the
    wrapper refuses any other on every device."""
    raw = [torch.from_numpy(a) for a in
           _blaze_heads(np.random.RandomState(1), 1, 0.65)]
    with pytest.raises(ValueError, match="power of two"):
        ck.blaze_decode_blend(*raw, torch.from_numpy(_ANCHORS), 200.0, 100.0,
                              0.65, 0.3, 16)


def test_kernel_module_imports_without_nvcc():
    """Importing the kernels module needs neither nvcc nor a card: the build
    and the ctypes binding happen at the first CUDA launch."""
    code = ("from face_detection_and_recognition_tpu_torch.ops import "
            "cuda_kernels as ck\n"
            "assert ck._LIB == [] and not ck.BUILD_DIR.joinpath("
            "'never').exists()\n"
            "print('IMPORTED')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED" in out.stdout
