"""The plain versions of the port's two CUDA kernels against the Pallas
kernels they replace (interpret mode, CPU), and the wrappers' CPU path.

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
    candidate_rows_gather_pallas, nms_fixpoint_pallas)
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
    torch.testing.assert_close(ck.rows_gather(levels, idx),
                               ck.rows_gather_plain(levels, idx),
                               rtol=0, atol=0)
    # the CPU path launches nothing and builds nothing
    assert ck.LAUNCHES == {"nms_fixpoint": 0, "rows_gather": 0,
                           "crop_resize": 0}
    assert ck._LIB == []


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
