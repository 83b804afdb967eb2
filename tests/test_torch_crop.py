"""The port's crop + bilinear resize (the plain version of the B3 kernel, as
the CPU runs it) against the JAX package's ``crop_and_resize`` /
``crop_and_resize_padded`` and its Pallas crop kernel in interpret mode, on
the same frames and boxes (CPU)."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import face_detection_and_recognition_tpu.ops.pallas_kernels as PK
from face_detection_and_recognition_tpu.ops import crop as JC
from face_detection_and_recognition_tpu_torch.ops import crop as TC
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck

H, W = 60, 80


def _boxes(rng, k=12):
    """Face-sized boxes plus every edge case: 1-px, inverted, crossing the
    frame's edge, fully outside, the full frame, fractional corners."""
    xy = rng.uniform(0, [W, H], (k, 2))
    wh = rng.uniform(2, 40, (k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:7] = [[5.5, 7.25, 6.0, 8.0],          # 1 px
                 [50.0, 40.0, 20.0, 10.0],       # inverted
                 [-20.0, -10.0, 30.0, 25.0],     # crosses 0
                 [W - 10, H - 10, W + 30, H + 30],
                 [-50.0, -50.0, -10.0, -5.0],    # fully outside
                 [0.0, 0.0, W, H],               # the full frame
                 [5.5, 7.2, W - 3.1, H - 4.9]]
    return boxes


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    boxes = np.stack([_boxes(rng), _boxes(rng)[::-1].copy()])
    valid = rng.rand(2, 12) > 0.25
    valid[:, :7] = True
    valid[0, 8] = False
    return frames, boxes, valid


SEMANTICS = [(TC.crop_and_resize, JC.crop_and_resize, True),
             (TC.crop_and_resize_padded, JC.crop_and_resize_padded, False)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("out_hw", [(112, 112), (227, 227), (7, 13)])
@pytest.mark.parametrize("port_fn,jax_fn,clamp", SEMANTICS)
def test_crop_equals_jax_gather(case, port_fn, jax_fn, clamp, out_hw, dtype):
    frames, boxes, valid = case
    frames = frames.astype(dtype)
    got = port_fn(torch.from_numpy(frames), torch.from_numpy(boxes), out_hw,
                  torch.from_numpy(valid)).numpy()
    assert got.shape == (2, 12) + out_hw + (3,) and got.dtype == np.float32
    for b in range(2):
        ref = np.asarray(jax_fn(jnp.asarray(frames[b]), jnp.asarray(boxes[b]),
                                out_hw, jnp.asarray(valid[b]),
                                method="gather"))
        # the same coordinate rounding; the interpolation's products may
        # fuse differently: 1e-3 on the 0-255 scale
        np.testing.assert_allclose(got[b], ref, atol=1e-3, rtol=0)
        # one frame alone, [H, W, C] with [K, 4]: the same crops
        one = port_fn(torch.from_numpy(frames[b]), torch.from_numpy(boxes[b]),
                      out_hw, torch.from_numpy(valid[b])).numpy()
        np.testing.assert_array_equal(one, got[b])
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("out_hw", [(112, 112), (24, 24)])
@pytest.mark.parametrize("port_fn,jax_fn,clamp", SEMANTICS)
def test_crop_equals_pallas_interpret(case, port_fn, jax_fn, clamp, out_hw):
    """The Pallas kernel builds its coordinates as (o + 0.5) / oh * ch, the
    gather path as (o + 0.5) * ch / oh; on a noise frame the two JAX paths
    themselves differ by an ulp of a coordinate times a 255-step edge. The
    port is held to the Pallas kernel as tightly as the JAX gather path is,
    to within 1e-3."""
    frames, boxes, valid = case
    frame = frames[0].astype(np.float32)
    img_cm = jnp.asarray(frame).transpose(2, 0, 1).reshape(-1, W)
    pal = np.asarray(PK.crop_gemm_pallas(
        img_cm, jnp.asarray(boxes[0]), jnp.asarray(valid[0], jnp.float32),
        out_hw, clamp, True))
    pal = pal.reshape(12, 3, *out_hw).transpose(0, 2, 3, 1)
    got = port_fn(torch.from_numpy(frames[0]), torch.from_numpy(boxes[0]),
                  out_hw, torch.from_numpy(valid[0])).numpy()
    gather = np.asarray(jax_fn(jnp.asarray(frame), jnp.asarray(boxes[0]),
                               out_hw, jnp.asarray(valid[0]),
                               method="gather"))
    assert (np.abs(got - pal) <= np.abs(gather - pal) + 1e-3).all()
    assert (pal[~valid[0]] == 0).all() and (got[~valid[0]] == 0).all()


def test_fma_is_rounded_once():
    """The plain version's fused multiply-add equals the exactly rounded
    a * b + c, ties and tiny products next to large addends included."""
    rng = np.random.RandomState(3)
    n = 2000
    a = (rng.randint(1, 1400, n) * np.float32(0.5)).astype(np.float32)
    a[:500] = rng.uniform(-700, 700, 500).astype(np.float32)
    b = (np.float32(1) / rng.randint(1, 300, n).astype(np.float32))
    c = np.floor(rng.uniform(-2000, 2000, n)).astype(np.float32)
    got = ck._fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(abs(Fraction(float(v)) - exact) for v in cands)
        assert abs(Fraction(float(got[i])) - exact) == best, i


def test_pad_boxes_and_extraction_region_equal_jax(case):
    _, boxes, _ = case
    for offsets, wh in (((-5.0, -5.0, 5.0, 5.0), (W, H)),
                        (TC.EXTRACTION_OFFSETS, (W, H)),
                        ((-6.0, -1.0, 4.0, 5.0), None)):
        got = TC.pad_boxes(torch.from_numpy(boxes), offsets, wh).numpy()
        ref = np.asarray(JC.pad_boxes(jnp.asarray(boxes), offsets, wh))
        np.testing.assert_array_equal(got, ref)
    assert TC.EXTRACTION_OFFSETS == JC.EXTRACTION_OFFSETS
    for box in boxes.reshape(-1, 4):
        assert TC.extraction_crop_region(box, W, H) == \
            JC.extraction_crop_region(box, W, H)


def test_crop_wrapper_takes_plain_path_on_cpu(case):
    frames, boxes, valid = case
    before = dict(ck.LAUNCHES)
    args = (torch.from_numpy(frames), torch.from_numpy(boxes),
            torch.from_numpy(valid), (16, 16), False)
    assert torch.equal(ck.crop_resize(*args), ck.crop_resize_plain(*args))
    assert ck.LAUNCHES == before


# ---------------- the fused epilogue: clip, then mean ----------------

AG_MEAN = (78.4263377603, 87.7689143744, 114.895847746)  # AGE_GENDER.mean
EPILOGUES = [(True, None), (True, AG_MEAN), (False, AG_MEAN)]


def _frames_for(case, dtype):
    """The case's frames; float frames are stretched past [0, 255] so that
    the clip has values to cut on both sides."""
    frames = case[0]
    if dtype == np.uint8:
        return frames
    return frames.astype(np.float32) * np.float32(1.5) - np.float32(100.0)


@pytest.mark.parametrize("clip,mean", EPILOGUES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("clamp", [True, False])
def test_crop_epilogue_equals_unfused(case, clamp, dtype, clip, mean):
    """crop_resize_plain with the epilogue equals the crop, the clamp and
    the mean subtraction run apart, as the engine ran them, bit for bit;
    also at 7 x 13, whose rows (39 floats) are odd."""
    _, boxes, valid = case
    img = torch.from_numpy(_frames_for(case, dtype))
    args = (img, torch.from_numpy(boxes), torch.from_numpy(valid))
    for out_hw in ((7, 13), (24, 24)):
        ref = ck.crop_resize_plain(*args, out_hw, clamp)
        if clip:
            ref.clamp_(0.0, 255.0)
        if mean is not None:
            ref -= torch.tensor(mean)
        got = ck.crop_resize_plain(*args, out_hw, clamp, clip, mean)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert torch.equal(got, ref)
        if dtype == np.float32 and clip:  # the clip did cut values
            raw = ck.crop_resize_plain(*args, out_hw, clamp)
            assert bool((raw < 0).any()) and bool((raw > 255).any())
            lo = -torch.tensor(mean) if mean is not None else torch.zeros(3)
            assert bool((got >= lo).all()) and bool((got <= 255 + lo).all())


@pytest.mark.parametrize("clamp", [True, False])
def test_crop_epilogue_invalid_slots_hold_minus_mean(case, clamp):
    """An invalid slot samples 0, so after clip and mean it holds -mean,
    what the engine's crop -> clamp_ -> -= sequence left there."""
    frames, boxes, valid = case
    args = (torch.from_numpy(frames), torch.from_numpy(boxes),
            torch.from_numpy(valid), (9, 11), clamp)
    got = ck.crop_resize_plain(*args, clip=True, mean=AG_MEAN)
    want = -torch.tensor(AG_MEAN, dtype=torch.float32)
    assert (~valid).any()
    assert torch.equal(got[torch.from_numpy(~valid)],
                       want.expand_as(got[torch.from_numpy(~valid)]))
    assert torch.equal(ck.crop_resize_plain(*args, clip=True)[
        torch.from_numpy(~valid)].abs().max(), torch.tensor(0.0))


def test_crop_for_net_is_crop_clamp_subtract(case):
    """The engine's fused entry point equals crop_and_resize followed by
    the clamp and the mean subtraction, on one frame and on the batch."""
    frames, boxes, valid = case
    img, bx, vd = (torch.from_numpy(a) for a in (frames, boxes, valid))
    for sl in (slice(None), 0):
        ref = TC.crop_and_resize(img[sl], bx[sl], (20, 16), vd[sl])
        ref = ref.clamp_(0.0, 255.0) - torch.tensor(AG_MEAN)
        got = TC.crop_for_net(img[sl], bx[sl], (20, 16), vd[sl], clip=True,
                              mean=AG_MEAN)
        assert torch.equal(got, ref)


def test_crop_wrapper_epilogue_takes_plain_path_on_cpu(case):
    """On CPU tensors the wrapper runs the plain version, epilogue and
    all: nothing is built and nothing launched."""
    frames, boxes, valid = case
    before = dict(ck.LAUNCHES)
    lib_before = list(ck._LIB)
    args = (torch.from_numpy(frames), torch.from_numpy(boxes),
            torch.from_numpy(valid), (13, 7), True)
    for clip, mean in EPILOGUES:
        assert torch.equal(ck.crop_resize(*args, clip, mean),
                           ck.crop_resize_plain(*args, clip, mean))
    assert ck.LAUNCHES == before and ck._LIB == lib_before
