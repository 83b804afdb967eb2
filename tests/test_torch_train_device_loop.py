"""The port's device-resident training loop (``train/device_loop.py``)
against the JAX package's, on the CPU.

The JAX loop draws its batch indices, flip masks and brightness gains from
threefry keys, which a torch generator cannot reproduce; the tests replay
the JAX chunk's key splits on the host and feed the same draws to the port
(``make_chunk_trainer(draws=...)``, ``device_flip_lr(mask=...)``,
``device_brightness(gains=...)``).

Flip and brightness on the same draws are exact. A port chunk of three
steps against the JAX chunk (``lax.scan``) from the same yolov5n weights
at 64x64, with the learning rate full from the first step: the mean loss
within 1e-4 relative, and each tensor's change from the init (the
parameters, the BatchNorm statistics, the EMA'd parameters and the EMA'd
statistics) within 5e-2 of JAX's change's largest value plus 8 ulps of
the tensor's largest value (at least 0.05). The form is
``tests/test_torch_train_detection.py``'s and so is the reason: a
random-init BatchNorm net at B = 2, whose deepest maps are 2x2 (eight
values a channel), grows the frameworks' rounding step by step. The chunk's
three full-rate steps put the changes 8.6e-4, 2.3e-3 and 2.2e-2 of their
size apart (the detection file's decaying rates, 2e-3 and 5e-3). A Nesterov
or damped momentum or a decayed BatchNorm scale is still outside.
Then the JAX test's checks
(``tests/test_device_loop.py:51-94``) on the port: two chunks of ten steps
lower the loss, the counter reaches 20, the EMA moves and its statistics lag
the live ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.train import detection as JD
from face_detection_and_recognition_tpu.train import device_loop as JDL
from face_detection_and_recognition_tpu_torch.train import detection as D
from face_detection_and_recognition_tpu_torch.train import device_loop as DL
from face_detection_and_recognition_tpu_torch.train.data import \
    flip_lr_targets
from face_detection_and_recognition_tpu_torch.utils.weights import \
    yolov5_face_state_dict
from tests.test_torch_train_detection import change_gaps

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _data(k=6, t_rows=2):
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (k, SIZE, SIZE, 3)).astype(np.uint8)
    t = np.full((k, t_rows, 14), -1.0, np.float32)
    t[:, :, :4] = 0.0
    v = np.zeros((k, t_rows), bool)
    t[:, 0, :4] = [28, 30, 22, 26]
    t[::2, 0, 4:14] = rng.uniform(12, 50, (k // 2 + k % 2, 10))
    t[1::2, 1, :4] = [12, 44, 10, 12]
    v[:, 0] = True
    v[1::2, 1] = True
    return x, t, v


def _jax_draws(key, steps, b, k, flip, bright):
    """The JAX chunk's draws, replayed from its key: (idx, mask, gains)
    a step, as numpy."""
    out = []
    for _ in range(steps):
        key, k_idx, k_flip, k_bri = jax.random.split(key, 4)
        idx = jax.random.randint(k_idx, (b,), 0, k)
        mask = jax.random.uniform(k_flip, (b,)) < flip
        gains = jax.random.uniform(k_bri, (b, 1, 1, 1), minval=1.0 - bright,
                                   maxval=1.0 + bright)
        out.append(tuple(np.asarray(a) for a in (idx, mask, gains)))
    return out


def test_flip_and_brightness_equal_jax_on_the_same_draws():
    rng = np.random.RandomState(1)
    b, h, w = 6, 16, 24
    x = rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8)
    t = np.full((b, 3, 14), -1.0, np.float32)
    t[..., 0] = rng.uniform(2, w - 2, (b, 3))
    t[..., 1] = rng.uniform(2, h - 2, (b, 3))
    t[..., 2:4] = rng.uniform(2, 6, (b, 3, 2))
    t[:, 0, 4:14] = rng.uniform(1, w - 1, (b, 10))
    key = jax.random.PRNGKey(3)
    mask = np.asarray(jax.random.uniform(key, (b,)) < 0.5)
    assert mask.any() and not mask.all()
    xj, tj = JDL.device_flip_lr(key, jnp.asarray(x), jnp.asarray(t), 0.5)
    xp, tp = DL.device_flip_lr(None, torch.from_numpy(x), torch.from_numpy(t),
                               0.5, mask=torch.from_numpy(mask.copy()))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    for i in np.flatnonzero(mask):     # the host augmenter's convention
        np.testing.assert_allclose(tp[i].numpy(),
                                   flip_lr_targets(t[i], float(w)), atol=1e-4)
    gains = np.asarray(jax.random.uniform(key, (b, 1, 1, 1), minval=0.7,
                                          maxval=1.3))
    yj = JDL.device_brightness(key, jnp.asarray(x), 0.3)
    yp = DL.device_brightness(None, torch.from_numpy(x), 0.3,
                              gains=torch.from_numpy(gains.copy()))
    np.testing.assert_array_equal(yp.numpy(), np.asarray(yj))
    # drawn from a torch generator: the same shapes and bounds
    g = torch.Generator().manual_seed(0)
    yg = DL.device_brightness(g, torch.full((2, 4, 4, 3), 128,
                                            dtype=torch.uint8), 0.3)
    assert yg.dtype == torch.uint8
    assert int(yg.min()) >= int(128 * 0.7) - 1
    assert int(yg.max()) <= int(128 * 1.3) + 1


def test_chunk_with_fed_draws_matches_the_jax_chunk():
    steps, b = 3, 2
    cfg_kw = dict(arch="yolov5n", nc=1, input_size=(SIZE, SIZE),
                  max_targets=2, lr=0.01, total_steps=0, ema_decay=0.99,
                  ema_tau=10.0)
    st = JD.create_det_train_state(JD.DetTrainConfig(**cfg_kw),
                                   jax.random.PRNGKey(0))
    init = _np({"params": st["params"], "batch_stats": st["batch_stats"]})
    x, t, v = _data()
    chunk = JDL.make_chunk_trainer(JD.make_det_train_step_ema(st),
                                   batch_size=b, chunk_steps=steps,
                                   flip_lr=0.5, brightness=0.2,
                                   ema_stats_cfg=(0.99, 10.0))
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, steps, b, len(x), 0.5, 0.2)
    bs = st["batch_stats"]
    p, bs, _, ema, ema_bs, n, _, loss, _ = chunk(
        st["params"], bs, st["opt_state"], st["ema_params"],
        jax.tree_util.tree_map(jnp.copy, bs), jnp.int32(0), key,
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(v))
    live = yolov5_face_state_dict(_np({"params": p, "batch_stats": bs}),
                                  "yolov5n")
    shadow = yolov5_face_state_dict(
        _np({"params": ema, "batch_stats": ema_bs}), "yolov5n")

    state = D.create_det_train_state(D.DetTrainConfig(**cfg_kw),
                                     device="cpu")
    init = yolov5_face_state_dict(init, "yolov5n")
    D.load_train_weights(state, init)
    fed = [tuple(torch.from_numpy(np.array(a)) for a in d) for d in draws]
    pchunk = DL.make_chunk_trainer(
        D.make_det_train_step_ema(state), state, b, steps, flip_lr=0.5,
        brightness=0.2, ema_stats_cfg=(0.99, 10.0),
        draws=lambda i: (fed[i][0].long(), fed[i][1], fed[i][2]))
    ploss, metrics = pchunk(*map(torch.from_numpy, (x, t, v)))
    assert int(state["n_updates"]) == int(n) == steps
    assert float(ploss) == pytest.approx(float(loss), rel=1e-4)
    assert set(metrics) == {"box", "obj", "lmk", "cls"}
    assert not change_gaps(state["net"].state_dict(), live, init, 5e-2)
    assert not change_gaps(state["ema"].state_dict(), shadow, init, 5e-2)


def test_chunks_lower_the_loss_and_move_the_ema():
    """tests/test_device_loop.py:51-94 on the port: two chunks of ten
    steps on a tiny fixed buffer."""
    cfg = D.DetTrainConfig(arch="yolov5n", nc=1, input_size=(SIZE, SIZE),
                           max_targets=2, lr=0.01, total_steps=0,
                           ema_decay=0.99, ema_tau=10.0)
    state = D.create_det_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    x, t, v = _data()
    t[:, 1, :4] = 0.0
    v[:, 1] = False
    chunk = DL.make_chunk_trainer(D.make_det_train_step_ema(state), state,
                                  batch_size=3, chunk_steps=10, flip_lr=0.5,
                                  brightness=0.1, ema_stats_cfg=(0.99, 10.0))
    leaf0 = next(state["ema"].parameters()).detach().clone()
    gen = torch.Generator().manual_seed(7)
    data = tuple(map(torch.from_numpy, (x, t, v)))
    loss1, _ = chunk(*data, gen)
    loss2, _ = chunk(*data, gen)
    assert int(state["n_updates"]) == 20
    assert float(loss2) < float(loss1)
    assert not torch.allclose(next(state["ema"].parameters()), leaf0)
    live = D.bn_statistics(state["net"])[0]
    shadow = D.bn_statistics(state["ema"])[0]
    assert live.shape == shadow.shape
    assert not torch.allclose(live, shadow)      # lags, not equal


def test_mesh_raises_naming_the_roadmap():
    """``mesh=`` is ported: the chunk trainer refuses a batch the "data"
    axis does not divide and a step that is not data-parallel (a
    ``parallel.training.data_parallel_step``)."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    mesh = make_mesh(("data",), devices=["cpu"] * 2)
    state = {"net": None, "ema": None}
    with pytest.raises(ValueError, match="does not divide"):
        DL.make_chunk_trainer(lambda *a: None, state, 3, 2, mesh=mesh)
    with pytest.raises(ValueError, match="data_parallel_step"):
        DL.make_chunk_trainer(lambda *a: None, state, 2, 2, mesh=mesh)
