"""The port's multi-device layer (``parallel/``) and its sharded paths
against the JAX package's unsharded functions, on the CPU.

Single-process meshes repeat the ``"cpu"`` device, as the JAX tests put
eight virtual CPU devices in one process; each shard runs in its own
thread and the shards meet at every collective. Held here:

- the mesh, its groups and the collectives (ordered, differentiable);
- BlazeFace-front ``detect_batch_sharded`` on golden weights against the
  JAX engine's ``detect_batch`` on the whole batch: ``valid`` equal, boxes
  within 1e-3 (the JAX sharded test's tolerance), and equal bit for bit to
  the port's unsharded detect;
- the fused ensemble (BlazeFace-front + MobileFaceNet + age/gender, golden
  weights) with ``mesh=`` against the JAX ensemble: ``valid`` equal, boxes
  within 1e-3, crops within 2 f32 ulps of 255, embeddings 1e-5 and
  age/gender probabilities 2e-4 (``tests/test_torch_ensemble.py``'s);
- ``topk_similar(mesh=)`` against the JAX unsharded search at gallery sizes
  that do not divide the axis: indices equal, scores within 1e-5; the JAX
  ``topk_gallery_sharded`` itself, in a process of four virtual devices;
- (training over a mesh: ``tests/test_torch_parallel_train.py``);
- the dynamic int8 detect over a mesh against the unsharded int8 detect,
  bit for bit: every piece quantized with the whole batch's absmax;
- ``mp_demo`` as two gloo ranks, in both modes, against the
  single-process mesh.
"""
import json
import os
import socket
import subprocess
import sys
import threading

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.pipelines import similarity as JS
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.parallel import \
    collectives as C
from face_detection_and_recognition_tpu_torch.parallel import mp_demo as MP
from face_detection_and_recognition_tpu_torch.parallel.mesh import (
    init_distributed, make_mesh, mesh_devices)
from face_detection_and_recognition_tpu_torch.parallel.sharding import (
    data_parallel, put_global, replicate_to_mesh, shard_reference_matrix,
    topk_gallery_sharded)
from face_detection_and_recognition_tpu_torch.pipelines import \
    similarity as TS
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, blazeface_state_dict, mobile_facenet_state_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh(axes, shape):
    return make_mesh(axes, shape, ["cpu"] * int(np.prod(shape)))


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


def _frames(n, size=None):
    """``n`` frames of the golden image: mirrored, darkened and shifted
    copies, so that the pieces of the batch differ."""
    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    if size is not None:
        img = cv2.resize(img, size)
    out = []
    for i in range(n):
        f = img[:, ::-1] if i % 2 else img
        f = np.roll(f, 7 * i, axis=1)
        out.append((f.astype(np.float32) * (1.0 - 0.08 * i)).astype(np.uint8))
    return np.ascontiguousarray(np.stack(out))


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------

def test_mesh_shape_groups_and_devices():
    mesh = cpu_mesh(("data", "model"), (4, 2))
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert not mesh.distributed and len(mesh.local_coords()) == 8
    assert mesh.group_coords((2, 1), "data") == [(0, 1), (1, 1), (2, 1),
                                                 (3, 1)]
    assert mesh.group_coords((2, 1), "model") == [(2, 0), (2, 1)]
    assert mesh.index((2, 1), "data") == 2
    assert mesh.axis_size(("model", "data")) == 8
    assert make_mesh(("data",), devices=["cpu"] * 3).shape == {"data": 3}
    assert mesh_devices("cpu") == [torch.device("cpu")]
    # the card is the default; without one the mesh is asked for by name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_mesh(("data",))
    with pytest.raises(ValueError, match="one device"):
        init_distributed("localhost:1", 2, 0, local_cpu_devices=4)
    assert init_distributed() is None


def test_each_shard_runs_with_its_card_current(monkeypatch):
    """On a mesh over several cards each shard's thread, a worker's or a
    nested call's, has its coordinate's card as the current CUDA device
    while it runs (the kernels launch on the current device's streams),
    and the device is put back after it. The CUDA calls are stood in for
    by a per-thread record."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import Mesh

    current = threading.local()

    class FakeDevice:
        def __init__(self, dev):
            self.idx = torch.device(dev).index

        def __enter__(self):
            self.prev = getattr(current, "idx", 0)
            current.idx = self.idx

        def __exit__(self, *exc):
            current.idx = self.prev

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: getattr(current, "idx", 0))

    def cards(*shape):
        arr = np.empty(int(np.prod(shape)), dtype=object)
        arr[:] = [torch.device("cuda", i) for i in range(arr.size)]
        return Mesh(arr.reshape(shape), ("data", "model")[:len(shape)])

    outer, inner = cards(2, 2), cards(3)

    def nested(coord):
        return (torch.cuda.current_device(),
                C.run_spmd(inner, lambda c: torch.cuda.current_device()),
                torch.cuda.current_device())

    out = C.run_spmd(outer, nested)
    for coord, (mine, theirs, after) in out.items():
        assert mine == after == 2 * coord[0] + coord[1]
        assert theirs == {(i,): i for i in range(3)}
    assert C.run_spmd(cards(1), lambda c: torch.cuda.current_device()) == {
        (0,): 0}
    assert torch.cuda.current_device() == 0


def test_each_shard_runs_with_the_callers_cpu_thread_count():
    """The shards' long-lived worker threads, and a nested call's new ones,
    take the caller's intra-op thread count at every call: a result on the
    CPU does not depend on the count in force when a worker was made."""
    mesh = cpu_mesh(("data",), (2,))
    outer = torch.get_num_threads()

    def nested(coord):
        return (torch.get_num_threads(),
                C.run_spmd(mesh, lambda c: torch.get_num_threads()))

    try:
        for n in (1, 2, 1):
            torch.set_num_threads(n)
            assert C.run_spmd(mesh, nested) == {
                (i,): (n, {(0,): n, (1,): n}) for i in range(2)}
    finally:
        torch.set_num_threads(outer)


def test_collectives_gather_reduce_and_fail_cleanly():
    mesh = cpu_mesh(("data", "model"), (2, 2))

    def fn(coord):
        t = torch.tensor([float(10 * coord[0] + coord[1])])
        return (torch.cat(C.all_gather(t, "data")).tolist(),
                float(C.all_reduce(t, "model")),
                float(C.all_reduce(t, ("data", "model"), "max")),
                C.axis_index("model"))

    out = C.run_spmd(mesh, fn)
    assert out[(1, 1)] == ([1.0, 11.0], 21.0, 11.0, 1)
    assert out[(0, 0)] == ([0.0, 10.0], 1.0, 11.0, 0)

    # gradients cross the exchange: over a column, sum_d x_d * (x_0 + x_1)
    # = (x_0 + x_1)^2, whose derivative is 2 (x_0 + x_1) = 6 at (1, 2)
    xs = {c: torch.tensor(float(c[0] + 1), requires_grad=True)
          for c in mesh.local_coords()}
    losses = C.run_spmd(mesh, lambda c: xs[c] * C.all_reduce(xs[c], "data"))
    C.sum_across(list(losses.values()), torch.device("cpu")).backward()
    assert all(float(x.grad) == 6.0 for x in xs.values())

    def bad(coord):
        if coord == (1, 0):
            raise KeyError("shard fault")
        return C.all_reduce(torch.ones(1), "data")

    with pytest.raises(KeyError, match="shard fault"):
        C.run_spmd(mesh, bad)


def test_collectives_hold_with_more_shards_than_cores():
    """32 shards, the interpreter switching threads every microsecond: 20
    rounds of exchanges keep every sum right, in bounded time, and a
    second call reuses the workers."""
    import sys
    import time

    mesh = cpu_mesh(("data", "model"), (8, 4))

    def fn(coord):
        return sum(float(C.all_reduce(torch.tensor([float(coord[0] + r)]),
                                      "data")) for r in range(20))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            t = time.time()
            out = C.run_spmd(mesh, fn)
            assert time.time() - t < 120
            # sum over d of (d + r) = 28 + 8 r, summed over r < 20
            assert len(out) == 32 and all(v == 2080.0 for v in out.values())
    finally:
        sys.setswitchinterval(old)


def test_data_parallel_replicate_and_shard_reference():
    mesh = cpu_mesh(("data",), (8,))
    imgs = np.random.RandomState(0).uniform(0, 1, (16, 8, 8, 3)) \
        .astype(np.float32)
    fn = data_parallel(lambda v, x: x.mean((1, 2, 3)) + v["b"], mesh)
    out = fn({"b": torch.tensor(1.0)}, imgs)
    np.testing.assert_allclose(out.numpy(), imgs.mean((1, 2, 3)) + 1.0,
                               rtol=1e-6)
    placed = replicate_to_mesh({"w": torch.ones(4, 4)}, mesh)
    assert len(placed) == 8 and all(
        torch.equal(p["w"], torch.ones(4, 4)) for p in placed.values())
    refs = np.arange(32, dtype=np.float32).reshape(16, 2)
    tp = cpu_mesh(("data", "model"), (4, 2))
    sh = shard_reference_matrix(refs, tp)
    assert tuple(sh[(3, 1)].shape) == (8, 2)
    np.testing.assert_array_equal(sh[(0, 1)].numpy(), refs[8:])
    with pytest.raises(ValueError, match="does not divide"):
        put_global(np.zeros((5, 2)), shard_reference_matrix(refs, tp)
                   .sharding)


# ---------------------------------------------------------------------------
# sharded inference against the JAX package's unsharded functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blaze_engines():
    """(JAX, port) BlazeFace-front + MobileFaceNet + age/gender, golden
    weights on both (max_det 8)."""
    blaze, embed, ag = (_load("golden_blaze_ckpt"),
                        _load("golden_embed_ckpt"), _load("golden_ag_ckpt"))
    kw = dict(detector="blazeface-front", det_thres=0.3, max_det=8,
              embedder="mobile_facenet", with_age_gender=True)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables = blaze
    jeng.embed_vars = embed
    jeng.ag_vars = (ag["age"], ag["gender"])
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(blazeface_state_dict(blaze, False))
    teng.load_embed_state_dict(mobile_facenet_state_dict(embed))
    teng.load_age_gender_state_dict(age_gender_state_dict(ag["age"],
                                                          ag["gender"]))
    return jeng, teng


def test_blazeface_detect_sharded_matches_jax_unsharded(blaze_engines):
    jeng, teng = blaze_engines
    frames = _frames(8, (320, 240))
    mesh = cpu_mesh(("data",), (4,))
    got = teng.detect_batch_sharded(frames, mesh)
    ref = jeng.detect_batch(frames)
    valid = np.asarray(ref.valid)
    assert valid.sum() >= 8
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(ref.boxes)[valid], atol=1e-3,
                               rtol=0)
    whole = teng.detect_batch(frames)
    for f in ("boxes", "scores", "lmarks", "areas", "valid"):
        torch.testing.assert_close(getattr(got, f), getattr(whole, f),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        teng.detect_batch_sharded(frames[:6], mesh)


def test_ensemble_sharded_matches_jax_unsharded(blaze_engines):
    jeng, teng = blaze_engines
    frames = _frames(4, (320, 240))
    got = teng.detect_embed_classify_batch(
        frames, mesh=cpu_mesh(("data",), (2,)))
    ref = jeng.detect_embed_classify_batch(frames)
    valid = np.asarray(ref.det.valid)
    assert valid.sum() >= 4
    np.testing.assert_array_equal(got.det.valid.numpy(), valid)
    np.testing.assert_allclose(got.det.boxes.numpy()[valid],
                               np.asarray(ref.det.boxes)[valid], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got.crops.numpy(), np.asarray(ref.crops),
                               rtol=0, atol=3.1e-5)
    np.testing.assert_allclose(got.embeddings.numpy(),
                               np.asarray(ref.embeddings), rtol=0, atol=1e-5)
    for g, r in ((got.age_probs, ref.age_probs),
                 (got.gender_probs, ref.gender_probs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-4)


def test_quantized_layer_copies_without_its_packed_weights():
    """A replica of an int8 net for another card is a deep copy: Q1's packed
    weights, a cache that carries the kernel's ctypes launch record, are
    left behind (the copy packs its own), and the original keeps them."""
    import copy
    import ctypes

    from face_detection_and_recognition_tpu_torch.models.layers import \
        QConvBN

    class Record(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p)]

    layer = QConvBN(4, 8, 3)
    layer._wpack = torch.zeros(3, dtype=torch.int8)
    layer._wpack._q1_layer = Record()
    layer._wpack_of = (layer.kernel_q, layer.kernel_q._version)
    twin = copy.deepcopy(layer)
    assert twin._wpack is None and twin._wpack_of is None
    assert layer._wpack is not None
    torch.testing.assert_close(twin.kernel_q, layer.kernel_q, rtol=0, atol=0)
    x = torch.rand(1, 4, 6, 6)
    torch.testing.assert_close(twin(x), layer(x), rtol=0, atol=0)


def test_int8_dynamic_sharded_uses_the_whole_batch_scale():
    eng = FaceEngine(EngineConfig(
        detector="yolov5n", det_thres=0.0,
        detector_overrides={"quantized": True, "input_size": (128, 128)}),
        device="cpu")
    frames = _frames(4, (128, 96))
    frames[2:] //= 3      # the second piece's absmax is not the batch's
    mesh = cpu_mesh(("data",), (2,))
    got = eng.detect_batch_sharded(frames, mesh)
    whole = eng.detect_batch(frames)
    for f in ("boxes", "scores", "lmarks", "areas", "valid"):
        torch.testing.assert_close(getattr(got, f), getattr(whole, f),
                                   rtol=0, atol=0)
    # the piece alone, on its own scale, gives other heads
    leaves = []
    with torch.inference_mode():
        x = eng._preprocess(torch.from_numpy(frames))
        for out in (eng._network(x), eng._network(x[2:])):
            C.tree_map(leaves.append, out)
    n = len(leaves) // 2
    assert any(not torch.equal(a[2:], b)
               for a, b in zip(leaves[:n], leaves[n:]))


@pytest.mark.parametrize("m,k", [(1003, 7), (64, 9), (24, 24)])
def test_topk_similar_sharded_matches_jax(m, k):
    rng = np.random.RandomState(3)
    q = rng.randn(16, 64).astype(np.float32)
    g = rng.randn(m, 64).astype(np.float32)
    mesh = cpu_mesh(("model",), (8,))
    js, ji = JS.topk_similar(q, g, k=k)
    s, i = TS.topk_similar(q, g, k=k, mesh=mesh)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)
    if k <= 16:  # B4's plain version a shard
        s2, i2 = TS.topk_similar(q, g, k=k, mesh=mesh, use_pallas=True)
        np.testing.assert_array_equal(i2, np.asarray(ji))
        np.testing.assert_allclose(s2, np.asarray(js), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds gallery"):
        topk_gallery_sharded(q, g[:3], mesh, k=5)


_JAX_SHARDED = r"""
import json, sys
import numpy as np
import jax
from face_detection_and_recognition_tpu.parallel.mesh import make_mesh
from face_detection_and_recognition_tpu.parallel.sharding import (
    topk_gallery_sharded)
assert len(jax.devices()) == 4, jax.devices()
rng = np.random.RandomState(9)
q = rng.randn(6, 32).astype(np.float32)
g = rng.randn(203, 32).astype(np.float32)
s, i = topk_gallery_sharded(q, g, make_mesh(("model",)), k=6)
print(json.dumps({"s": np.asarray(s).tolist(), "i": np.asarray(i).tolist()}))
"""


def test_jax_topk_gallery_sharded_matches_the_port():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_SHARDED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    rng = np.random.RandomState(9)
    q = rng.randn(6, 32).astype(np.float32)
    g = rng.randn(203, 32).astype(np.float32)
    s, i = topk_gallery_sharded(q, g, cpu_mesh(("model",), (4,)), k=6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref["i"]))
    np.testing.assert_allclose(s.numpy(), np.asarray(ref["s"]), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# mp_demo across processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["train", "ensemble"])
def test_mp_demo_two_gloo_ranks_match_single_process(tmp_path, mode):
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    outs = [str(tmp_path / f"r{i}.json") for i in range(2)]
    ranks = [subprocess.Popen(
        [sys.executable, "-m",
         "face_detection_and_recognition_tpu_torch.parallel.mp_demo",
         "--procs", "2", "--pid", str(i), "--coordinator", coordinator,
         "--mode", mode, "--device", "cpu", "--out", outs[i]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    logs = [r.communicate(timeout=300)[0].decode(errors="replace")
            for r in ranks]
    assert all(r.returncode == 0 for r in ranks), "\n".join(logs)
    results = [json.load(open(p)) for p in outs]
    local = MP.run_local(2, mode, device="cpu")
    assert results[0]["n_devices"] == 2
    for key, val in local.items():
        # the same ordered reductions: equal on both ranks and locally
        assert results[0][key] == results[1][key] == val, key
