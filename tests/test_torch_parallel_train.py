"""The port's training over a device mesh (``parallel/training.py``,
``train.arcface.sharded_train_step``, ``train.detection.
sharded_det_train_step``, the device loop's ``mesh=``) against the JAX
package's unsharded steps, on the CPU, on single-process meshes of
repeated ``"cpu"`` entries (``tests/test_torch_parallel.py`` holds the
mesh, the collectives and the sharded inference paths):

- the DP + TP ArcFace step (mesh 2 x 2, B = 2) against the JAX unsharded
  step, both in f64 (``tests/test_torch_train_arcface.py``'s comparison
  and bounds: the loss within 1e-6 relative a step, each tensor's change
  within 1e-3 of JAX's after one step and 1e-2 after two, plus 8 f32
  ulps): the net's tensors, the BatchNorms' running statistics (the whole
  batch's: per-shard statistics move them outside the bound) and the class
  kernel; the kernel and its momentum stay split by classes, matched by
  name, not shape;
- the data-parallel yolov5n step with its EMA (two "data" entries, B =
  2) against the JAX unsharded step, both in f64 (the JAX program's loss
  and metrics stay f32, which its code fixes): the loss and metrics within
  1e-6 relative a step, each tensor's change within 1e-5 of JAX's after
  one step and 1e-4 after two (an order above the largest gaps read,
  under 1e-7 and 1e-5), plus 8 f32 ulps; ``sharded_det_train_step``
  against the port's unsharded step; the device loop over a mesh against
  the unsharded loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu_torch.parallel.mesh import make_mesh
from face_detection_and_recognition_tpu_torch.parallel.training import \
    data_parallel_step
from face_detection_and_recognition_tpu_torch.train import arcface as A
from face_detection_and_recognition_tpu_torch.train import detection as D
from face_detection_and_recognition_tpu_torch.train import device_loop as DL
from face_detection_and_recognition_tpu_torch.utils.weights import \
    yolov5_face_state_dict
from tests.test_torch_train_arcface import (JA, _SLOTS, _f64, _jax_state,
                                            _port_f64, _port_state)
from tests.test_torch_train_detection import (HEADS, JD, SCHED, SIZE,
                                              _batch, _np, _targets,
                                              change_gaps)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh(axes, shape):
    return make_mesh(axes, shape, ["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def arcface_runs():
    """Two MobileFaceNet ArcFace steps (B = 2, 16-d, 4 classes, center
    term on: the batches and JAX program of ``test_torch_train_arcface.
    step_runs``), JAX unsharded and the port's DP + TP step on a 2 x 2 mesh
    (one crop a "data" entry), both in f64 from the same weights."""
    cfg = JA.ArcFaceTrainConfig(num_classes=4, embedding_size=16, s=16.0,
                                lr=0.05, center_gain=0.02)
    jst, variables = _jax_state(cfg)
    kernel0 = np.asarray(jst["params"]["arcface_kernel"])
    rng = np.random.RandomState(5)
    batches = [(rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32),
                rng.randint(0, 4, 2).astype(np.int32)) for _ in range(3)][:2]
    to_port = _SLOTS["mobile_facenet"][1]
    with jax.enable_x64(True):
        cfg64 = JA.ArcFaceTrainConfig(**{**cfg.__dict__,
                                         "dtype": jnp.float64})
        st64 = dict(jst, cfg=cfg64, net=type(jst["net"])(
            embedding_size=16, dtype=jnp.float64))
        p = _f64({"net": variables["params"], "arcface_kernel": kernel0})
        bs = _f64(variables["batch_stats"])
        opt = st64["tx"].init(p)
        jstep = jax.jit(JA.make_train_step(st64))
        ref = []
        for x, y in batches:
            p, bs, opt, loss = jstep(p, bs, opt, jnp.asarray(x, jnp.float64),
                                     y)
            sd = yolo_free_sd(p, bs)
            ref.append({"loss": float(loss), "sd": sd,
                        "kernel": torch.tensor(np.asarray(
                            p["arcface_kernel"]))})
    pst = _port_f64(_port_state(cfg, to_port, variables, kernel0))
    init = {k: v.clone() for k, v in pst["net"].state_dict().items()}
    mesh = cpu_mesh(("data", "model"), (2, 2))
    step, replicas = A.sharded_train_step(pst, mesh)
    got = []
    for x, y in batches:
        loss = step(torch.tensor(x, dtype=torch.float64), torch.tensor(y))
        whole = A.gather_train_state(replicas, mesh)
        got.append({"loss": float(loss),
                    "sd": {k: v.clone() for k, v in whole["net"].items()},
                    "kernel": whole["arcface_kernel"].clone()})
    return (init, torch.tensor(kernel0, dtype=torch.float64), ref, got,
            replicas, mesh)


def yolo_free_sd(p, bs):
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    return W.mobile_facenet_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        {"params": p["net"], "batch_stats": bs}))


@pytest.mark.parametrize("n_steps,rtol", [(1, 1e-3), (2, 1e-2)])
def test_arcface_dp_tp_step_matches_jax_unsharded(arcface_runs, n_steps,
                                                  rtol):
    init, kernel0, ref, got, replicas, mesh = arcface_runs
    for r, g in zip(ref[:n_steps], got[:n_steps]):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-6 * n_steps)
    r, g = ref[n_steps - 1], got[n_steps - 1]
    # the running statistics are among the tensors: the whole batch's
    assert any("running_mean" in k for k in r["sd"])
    assert not change_gaps(g["sd"], r["sd"], init, rtol)
    assert not change_gaps({"k": g["kernel"]}, {"k": r["kernel"]},
                           {"k": kernel0}, rtol)
    assert float((g["kernel"] - kernel0).abs().max()) > 0


def test_arcface_kernel_and_momentum_stay_class_sharded(arcface_runs):
    _, kernel0, _, _, replicas, mesh = arcface_runs
    for (d, m), rep in replicas.items():
        shard = rep[A.KERNEL]
        assert tuple(shard.shape) == (16, 2) and rep["col0"] == 2 * m
        mom = rep["opt"].state[shard]["momentum_buffer"]
        assert tuple(mom.shape) == (16, 2)
    # the copies over "data" agree; the net's replicas are equal everywhere
    for m in range(2):
        torch.testing.assert_close(replicas[(0, m)][A.KERNEL],
                                   replicas[(1, m)][A.KERNEL], rtol=0,
                                   atol=0)
    sd0 = replicas[(0, 0)]["net"].state_dict()
    for k, v in replicas[(1, 1)]["net"].state_dict().items():
        torch.testing.assert_close(v, sd0[k], rtol=0, atol=0)


def test_arcface_sharding_matches_momentum_by_name_not_shape():
    """A state whose optimizer already holds momentum: each tensor's copies
    are matched by name, the kernel's split by classes like the kernel."""
    cfg = A.ArcFaceTrainConfig(num_classes=4, embedding_size=16, s=16.0)
    st = A.create_train_state(cfg, device="cpu")
    A.make_train_step(st)(torch.rand(2, 112, 112, 3) * 2 - 1,
                          torch.tensor([0, 2]))
    reps = A.shard_train_state(st, cpu_mesh(("data", "model"), (1, 2)))
    full = st["opt"].state[st[A.KERNEL]]["momentum_buffer"]
    for (_, m), rep in reps.items():
        torch.testing.assert_close(
            rep["opt"].state[rep[A.KERNEL]]["momentum_buffer"],
            full[:, 2 * m:2 * m + 2], rtol=0, atol=0)
        names = dict(rep["net"].named_parameters())
        for n, p in st["net"].named_parameters():
            if p in st["opt"].state:
                torch.testing.assert_close(
                    rep["opt"].state[names[n]]["momentum_buffer"],
                    st["opt"].state[p]["momentum_buffer"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="do not split"):
        A.shard_train_state(st, cpu_mesh(("data", "model"), (1, 3)))


def _det_batches(n, b=4):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        x = rng.randint(0, 255, (b, SIZE, SIZE, 3)).astype(np.uint8)
        t, v = _targets(rng, b, SCHED["max_targets"], SIZE)
        out.append((x, t, v))
    return out


def _jax_det_run64(steps):
    """``test_torch_train_detection._jax_run``'s program in f64: the face
    head's init, then ``steps`` jitted _ema steps on its seeded batches
    with the net, the parameters, the BN statistics, the momentum and the
    EMA in f64."""
    cfg = JD.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS["face"])
    st = JD.create_det_train_state(cfg, jax.random.PRNGKey(0))
    init = _np({"params": st["params"], "batch_stats": st["batch_stats"]})
    out = []
    with jax.enable_x64(True):
        net = type(st["net"])(arch=cfg.arch, nc=cfg.nc,
                              with_landmarks=cfg.with_landmarks,
                              dtype=jnp.float64)
        p, bs = _f64(st["params"]), _f64(st["batch_stats"])
        opt, ema = st["tx"].init(p), jax.tree_util.tree_map(jnp.copy, p)
        step = jax.jit(JD.make_det_train_step_ema(dict(st, net=net)))
        n = jnp.int32(0)
        rng = np.random.RandomState(3)
        for _ in range(steps):
            x, t, v = _batch(rng)
            p, bs, opt, ema, n, loss, met = step(
                p, bs, opt, ema, n, jnp.asarray(x), jnp.asarray(t),
                jnp.asarray(v))
            out.append({"loss": float(loss),
                        "live": _np({"params": p, "batch_stats": bs}),
                        "ema": _np({"params": ema, "batch_stats": bs}),
                        "metrics": {k: float(m) for k, m in met.items()}})
    return init, out


def _sd64(sd):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in yolov5_face_state_dict(sd, "yolov5n").items()}


@pytest.fixture(scope="module")
def det_runs():
    """Two _ema steps of the yolov5n face head at B = 2 (the batches of
    ``test_torch_train_detection._jax_run``), both in f64: JAX unsharded,
    the port data-parallel over two "data" entries, one example each."""
    init, ref = _jax_det_run64(2)
    ref = [dict(r, live=_sd64(r["live"]), ema=_sd64(r["ema"])) for r in ref]
    state = D.create_det_train_state(
        D.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS["face"]),
        device="cpu")
    D.load_train_weights(state, yolov5_face_state_dict(init, "yolov5n"))
    for key in ("net", "ema"):
        state[key].double()
        for mod in state[key].modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
    step, replicas = data_parallel_step(state, D.make_det_train_step_ema,
                                        cpu_mesh(("data",), (2,)))
    rng = np.random.RandomState(3)
    got = []
    for _ in range(2):
        loss, met = step(*map(torch.from_numpy, _batch(rng)))
        got.append({"loss": float(loss),
                    "live": {k: v.clone() for k, v in
                             state["net"].state_dict().items()},
                    "ema": {k: v.clone() for k, v in
                            state["ema"].state_dict().items()},
                    "metrics": {k: float(m) for k, m in met.items()}})
    return _sd64(init), ref, got, replicas


@pytest.mark.parametrize("n_steps,rtol", [(1, 1e-5), (2, 1e-4)])
def test_detector_dp_step_matches_jax_unsharded(det_runs, n_steps, rtol):
    init, ref, got, _ = det_runs
    assert all(v.dtype == torch.float64 for v in got[0]["live"].values()
               if v.is_floating_point())
    for r, g in zip(ref[:n_steps], got[:n_steps]):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-6 * n_steps)
        for k, val in r["metrics"].items():
            assert g["metrics"][k] == pytest.approx(val, rel=1e-6 * n_steps,
                                                    abs=1e-6), k
    r, g = ref[n_steps - 1], got[n_steps - 1]
    assert not change_gaps(g["live"], r["live"], init, rtol)
    assert not change_gaps(g["ema"], r["ema"], init, rtol, skip_stats=True)


def test_detector_replicas_stay_equal(det_runs):
    replicas = det_runs[3]
    sd0 = replicas[(0,)]["net"].state_dict()
    for rep in list(replicas.values())[1:]:
        for k, v in rep["net"].state_dict().items():
            torch.testing.assert_close(v, sd0[k], rtol=0, atol=0)
        assert int(rep["n_updates"]) == 2 and rep["updates"] == 2


def test_sharded_det_train_step_equals_the_unsharded_port_step():
    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS["face"])
    one = D.create_det_train_state(cfg, device="cpu")
    two = D.create_det_train_state(cfg, device="cpu")
    init = {k: v.clone() for k, v in one["net"].state_dict().items()}
    plain = D.make_det_train_step(one)
    step, _ = D.sharded_det_train_step(two, cpu_mesh(("data",), (2,)))
    for x, t, v in _det_batches(1):
        a = plain(*map(torch.from_numpy, (x, t, v)))
        b = step(*map(torch.from_numpy, (x, t, v)))
        assert float(b[0]) == pytest.approx(float(a[0]), rel=1e-6)
    assert not change_gaps(two["net"].state_dict(), one["net"].state_dict(),
                           init, 1e-3)


def test_device_loop_over_a_mesh_matches_the_unsharded_loop():
    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS["face"])
    data = tuple(np.concatenate(a) for a in zip(*_det_batches(3, 2)))
    states = [D.create_det_train_state(cfg, device="cpu") for _ in range(2)]
    init = {k: v.clone() for k, v in states[0]["net"].state_dict().items()}
    mesh = cpu_mesh(("data",), (2,))
    for st, m in zip(states, (None, mesh)):
        DL.run_device_training(st, D.make_det_train_step_ema, data, 4, 4,
                               chunk_steps=2, mesh=m, log=lambda s: None)
    a, b = (st["chunk_losses"] for st in states)
    np.testing.assert_allclose(b, a, rtol=1e-4)
    assert not change_gaps(states[1]["ema"].state_dict(),
                           states[0]["ema"].state_dict(), init, 1.5e-2)
    with pytest.raises(ValueError, match="does not divide"):
        DL.make_chunk_trainer(lambda *a: None, states[1], 3, 1, mesh=mesh)
