"""The port's yolov5-face training (``train/detection.py``) against the JAX
package's, on the CPU.

CIoU, the Wing loss, ``build_targets`` (per-level tensors equal),
``detection_loss`` and its gradient with respect to the maps on seeded maps;
the learning-rate sequence against optax's; one and three ``_ema`` steps of
yolov5n at 64x64, B = 2, from the JAX init poured in through
``utils/weights.yolov5_face_state_dict``, for the face head and the official
head (loss, parameters, BatchNorm statistics, EMA); the SGD / AdamW decay
groups against flax's ``decay_mask``; flax's BatchNorm update
(the biased variance) against ``nn.BatchNorm2d``'s; the init's per-layer
statistics against flax's.

Tolerances: the losses and the maps' gradient are sums of the same f32
terms in another order (relative 1e-5, and 1e-6 of the largest gradient).
The steps run without warmup (the first update's learning rate is full;
the warmed-up sequence is held to optax's by the lr test) on a cosine over
four updates, so each update has its own rate. Each tensor's change from
the poured init is held to JAX's change: within 5e-3 of the change's
largest value after one step, 1.5e-2 after three, plus 8 ulps of the
tensor's largest value (at least 0.05). A random-init BatchNorm net at
B = 2 amplifies the two frameworks' rounding into gradients that differ by
up to 2e-3 of their size after one step and 5e-3 after three; a tensor near
1 (a BatchNorm scale) loses an ulp in the subtraction, and a statistic
that is zero but for rounding (the running mean after a BatchNorm and a 1x1
convolution) moves by ~2e-8. A misplaced decay (5e-6 a step on a
BatchNorm scale that moves 2e-5), a Nesterov or damped momentum, or a rate
taken at the wrong count (12 % apart) is outside these bounds; the decay
groups are also checked against flax's mask directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.train import detection as JD
from face_detection_and_recognition_tpu_torch.models.layers import ConvBN
from face_detection_and_recognition_tpu_torch.models.yolov5_face import ARCHS
from face_detection_and_recognition_tpu_torch.train import detection as D
from face_detection_and_recognition_tpu_torch.utils.weights import (
    _bn, yolov5_face_state_dict)

SIZE = 64
SCHED = dict(lr=0.01, warmup_steps=0, total_steps=4, ema_decay=0.99,
             ema_tau=5.0, max_targets=4)
HEADS = {"face": dict(arch="yolov5n", nc=1, with_landmarks=True),
         "official": dict(arch="yolov5n", nc=80, with_landmarks=False)}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _targets(rng, b, t, size):
    """Padded target rows: boxes of several sizes (some sharing a cell),
    landmarks on some rows, a padded invalid row."""
    rows = np.zeros((b, t, 14), np.float32)
    rows[..., 4:] = -1.0
    valid = np.zeros((b, t), bool)
    for i in range(b):
        for j in range(t - 1):
            cx, cy = rng.uniform(4, size - 4, 2)
            w, h = rng.uniform(3, size / 2, 2)
            rows[i, j, :4] = [cx, cy, w, h]
            if j % 2 == 0:
                rows[i, j, 4:14] = rng.uniform(1, size - 1, 10)
            valid[i, j] = True
    rows[0, 1, :4] = rows[0, 0, :4] + [0.3, -0.2, 1.0, 0.5]  # a shared cell
    return rows, valid


def _batch(rng, b=2):
    x = rng.randint(0, 255, (b, SIZE, SIZE, 3)).astype(np.uint8)
    t, v = _targets(rng, b, SCHED["max_targets"], SIZE)
    return x, t, v


def test_ciou_and_wing_loss_match_jax():
    rng = np.random.RandomState(0)
    a = rng.uniform(0.5, 20, (64, 4)).astype(np.float32)
    b = rng.uniform(0.5, 20, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        D.ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(JD.ciou(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)
    p, t = rng.uniform(-30, 30, (2, 40, 10)).astype(np.float32)
    m = (rng.uniform(size=(40, 10)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(D.wing_loss(*map(torch.from_numpy, (p, t, m)))),
        float(JD.wing_loss(*map(jnp.asarray, (p, t, m)))), rtol=1e-6)


@pytest.mark.parametrize("head", ["face", "official"])
def test_build_targets_match_jax(head):
    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **HEADS[head])
    rng = np.random.RandomState(1)
    t, v = _targets(rng, 3, 6, SIZE)
    strides = ARCHS["yolov5n"]["strides"]
    grid = [(SIZE // s, SIZE // s) for s in strides]
    got = D.build_targets(torch.from_numpy(t), torch.from_numpy(v),
                          D.anchors_for(cfg), strides, grid, cfg.anchor_t)
    ref = JD.build_targets(jnp.asarray(t), jnp.asarray(v),
                           JD.anchors_for(JD.DetTrainConfig(**HEADS[head])),
                           strides, grid, cfg.anchor_t)
    assert sum(float(g["tobj"].sum()) for g in got) > 0
    for g, r in zip(got, ref):
        for k in ("tobj", "tbox", "tlmk", "lmk_mask", "anchors"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]),
                                          err_msg=k)


@pytest.mark.parametrize("head", ["face", "official"])
def test_detection_loss_and_map_gradient_match_jax(head):
    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **HEADS[head])
    jcfg = JD.DetTrainConfig(input_size=(SIZE, SIZE), **HEADS[head])
    no = cfg.nc + 5 + (10 if cfg.with_landmarks else 0)
    rng = np.random.RandomState(2)
    strides = ARCHS["yolov5n"]["strides"]
    grid = [(SIZE // s, SIZE // s) for s in strides]
    maps = [rng.normal(0, 1.5, (2, 3, gh, gw, no)).astype(np.float32)
            for gh, gw in grid]
    t, v = _targets(rng, 2, 5, SIZE)

    tm = [torch.from_numpy(m).requires_grad_(True) for m in maps]
    tpl = D.build_targets(torch.from_numpy(t), torch.from_numpy(v),
                          D.anchors_for(cfg), strides, grid, cfg.anchor_t)
    loss, metrics = D.detection_loss(tm, tpl, cfg)
    loss.backward()

    def jloss(ms):
        jt = JD.build_targets(jnp.asarray(t), jnp.asarray(v),
                              JD.anchors_for(jcfg), strides, grid,
                              jcfg.anchor_t)
        return JD.detection_loss(ms, jt, jcfg)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(m) for m in maps])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("box", "obj", "lmk", "cls"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for g, r in zip(tm, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(g.grad.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("warmup,total", [(3, 12), (0, 12), (0, 0)])
def test_lr_sequence_matches_optax(warmup, total):
    cfg = D.DetTrainConfig(lr=0.01, lrf=0.2, warmup_steps=warmup,
                           total_steps=total)
    ours = D.lr_schedule(cfg)
    theirs = JD.lr_schedule(JD.DetTrainConfig(
        lr=0.01, lrf=0.2, warmup_steps=warmup, total_steps=total))
    for count in range(total + 6):
        ref = float(theirs(count)) if callable(theirs) else theirs
        assert ours(count) == pytest.approx(ref, rel=1e-6, abs=1e-12), count
    if warmup:
        assert ours(0) == 0.0


def _jax_run(head, steps):
    """JAX: init, then ``steps`` jitted _ema steps on seeded batches; the
    variables after step 1 and after the last step."""
    cfg = JD.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS[head])
    st = JD.create_det_train_state(cfg, jax.random.PRNGKey(0))
    step = jax.jit(JD.make_det_train_step_ema(st))
    init = _np({"params": st["params"], "batch_stats": st["batch_stats"]})
    p, bs, opt, ema = (st["params"], st["batch_stats"], st["opt_state"],
                       st["ema_params"])
    n = jnp.int32(0)
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        x, t, v = _batch(rng)
        p, bs, opt, ema, n, loss, met = step(p, bs, opt, ema, n,
                                             jnp.asarray(x), jnp.asarray(t),
                                             jnp.asarray(v))
        out.append({"loss": float(loss), "n": int(n),
                    "live": _np({"params": p, "batch_stats": bs}),
                    "ema": _np({"params": ema, "batch_stats": bs}),
                    "metrics": {k: float(m) for k, m in met.items()}})
    return init, out


@pytest.fixture(scope="module", params=["face", "official"])
def ema_runs(request):
    """Both packages' three _ema steps of one head from the same weights
    and batches: (head, the init as a port state dict, JAX's steps, the
    port's)."""
    head = request.param
    init, ref = _jax_run(head, 3)
    init = yolov5_face_state_dict(init, "yolov5n")
    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS[head])
    state = D.create_det_train_state(cfg, device="cpu")
    D.load_train_weights(state, init)
    step = D.make_det_train_step_ema(state)
    rng = np.random.RandomState(3)
    got = []
    for _ in range(3):
        x, t, v = _batch(rng)
        loss, met = step(*map(torch.from_numpy, (x, t, v)))
        got.append({"loss": float(loss), "n": int(state["n_updates"]),
                    "live": {k: v.clone() for k, v in
                             state["net"].state_dict().items()},
                    "ema": {k: v.clone() for k, v in
                            state["ema"].state_dict().items()},
                    "metrics": {k: float(m) for k, m in met.items()}})
    return head, init, ref, got


def change_gaps(got, ref, init, rtol, skip_stats=False):
    """The float tensors whose change from ``init`` differs from the
    reference's change by more than ``rtol`` of that change's largest value
    plus 8 ulps of the tensor's largest value (at least 0.05)."""
    bad = []
    for k, r in ref.items():
        if not r.dtype.is_floating_point or (skip_stats and "running" in k):
            continue
        d = float((got[k] - r).abs().max())
        moved = float((r - init[k]).abs().max())
        ulps = 8 * float(np.finfo(np.float32).eps) * max(
            float(r.abs().max()), float(init[k].abs().max()), 0.05)
        if d > rtol * moved + ulps:
            bad.append((k, d, moved))
    return bad


@pytest.mark.parametrize("n_steps,rtol", [(1, 5e-3), (3, 1.5e-2)])
def test_ema_steps_match_jax(ema_runs, n_steps, rtol):
    head, init, ref, got = ema_runs
    for r, g in zip(ref[:n_steps], got[:n_steps]):
        assert g["n"] == r["n"]
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-4 * n_steps)
        for k, val in r["metrics"].items():
            assert g["metrics"][k] == pytest.approx(val, rel=1e-4 * n_steps,
                                                    abs=1e-6), k
    r, g = ref[n_steps - 1], got[n_steps - 1]
    live = yolov5_face_state_dict(r["live"], "yolov5n")
    assert not change_gaps(g["live"], live, init, rtol)
    # the EMA copy's statistics are the device loop's business; its
    # parameters are the step's
    ema = yolov5_face_state_dict(r["ema"], "yolov5n")
    assert not change_gaps(g["ema"], ema, init, rtol, skip_stats=True)
    # every update moved the weights: the first one too
    for sd in (g["live"], g["ema"]):
        assert max(float((sd[k] - init[k]).abs().max()) for k in init
                   if "conv.weight" in k) > 1e-4


def _decay_flags(family):
    """flax's ``decay_mask`` of the family's JAX net as a port state dict:
    each parameter all ones where the mask decays it, zeros elsewhere."""
    import functools

    from face_detection_and_recognition_tpu.models.blazeface import \
        BlazeFaceNet
    from face_detection_and_recognition_tpu.models.ssd import (SSDConfig,
                                                               SSDFaceNet)
    from face_detection_and_recognition_tpu.models.yolov5_face import \
        YoloV5FaceNet
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    if family == "blazeface":
        net, size = BlazeFaceNet(back_model=False, zero_head_init=True), 128
        init = net.init
    elif family == "ssd":
        net, size = SSDFaceNet(cfg=SSDConfig(backbone="resnet10",
                                             input_size=(300, 300))), 300
        init = functools.partial(net.init, train=True)
    else:
        net, size = YoloV5FaceNet(arch="yolov5n", nc=HEADS[family]["nc"],
                                  with_landmarks=HEADS[family][
                                      "with_landmarks"]), SIZE
        init = net.init
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    mask = JD.decay_mask(shapes["params"])
    flags = {"params": jax.tree_util.tree_map(
        lambda m, s: np.full(s.shape, float(m), np.float32), mask,
        shapes["params"])}
    flags["batch_stats"] = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes.get("batch_stats",
                                                            {}))
    if family == "blazeface":
        return W.blazeface_state_dict(flags, False)
    if family == "ssd":
        return W.ssd_state_dict(flags, "resnet10")
    return yolov5_face_state_dict(flags, "yolov5n")


@pytest.mark.parametrize("family", ["face", "official", "ssd", "blazeface"])
def test_decay_groups_are_flax_decay_mask(family):
    """The port's decayed parameter group holds exactly the parameters that
    flax's ``decay_mask`` decays (the ``kernel`` leaves), at the config's
    weight decay; the other group, every other parameter, at none."""
    from face_detection_and_recognition_tpu_torch.train import blazeface as B
    from face_detection_and_recognition_tpu_torch.train import ssd as S

    if family == "blazeface":
        state = B.create_blaze_train_state(B.BlazeTrainConfig(),
                                           device="cpu")
    elif family == "ssd":
        state = S.create_ssd_train_state(S.SSDTrainConfig(), device="cpu")
    else:
        state = D.create_det_train_state(D.DetTrainConfig(
            input_size=(SIZE, SIZE), **HEADS[family]), device="cpu")
    flags = _decay_flags(family)
    names = {id(p): k for k, p in state["net"].named_parameters()}
    assert set(names.values()) <= set(flags)
    for k in names.values():
        assert float(flags[k].min()) == float(flags[k].max()), k
    want = {k for k in names.values() if float(flags[k].max()) == 1.0}
    decay, rest = state["opt"].param_groups
    assert {names[id(p)] for p in decay["params"]} == want
    assert {names[id(p)] for p in rest["params"]} == set(
        names.values()) - want
    assert decay["weight_decay"] == state["cfg"].weight_decay > 0
    assert rest["weight_decay"] == 0.0
    assert want and want != set(names.values())


def test_batchnorm_train_step_is_flax_biased_update():
    """A ConvBN in train mode at a 4x4 map, B = 2 (n = 32 values a
    channel): the output and running statistics are flax's; the running
    variance moved toward the biased variance, which nn.BatchNorm2d's
    unbiased update misses by n / (n - 1)."""
    from face_detection_and_recognition_tpu.models.layers import \
        ConvBN as JConvBN

    rng = np.random.RandomState(4)
    x = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    mod = JConvBN(16, 3, 1)
    var = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_ref, upd = mod.apply(var, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    port = ConvBN(8, 16, 3, 1)
    state = {"conv.weight": torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(var["params"]["Conv_0"]["kernel"]),
                     (3, 2, 0, 1))))}
    _bn(state, "bn", _np(var["params"]["BatchNorm_0"]),
       _np(var["batch_stats"]["BatchNorm_0"]))
    port.load_state_dict(state)
    port.train()
    y = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    ref_var = np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"])
    np.testing.assert_allclose(port.bn.running_var.numpy(), ref_var,
                               rtol=1e-5)
    np.testing.assert_allclose(
        port.bn.running_mean.numpy(),
        np.asarray(upd["batch_stats"]["BatchNorm_0"]["mean"]),
        rtol=1e-5, atol=1e-7)
    # nn.BatchNorm2d's own update on the same input misses it
    plain = torch.nn.BatchNorm2d(16, eps=1e-3, momentum=0.03)
    plain.train()
    plain(port.conv(torch.from_numpy(x).permute(0, 3, 1, 2)))
    moved_ref = ref_var - 0.97
    moved_plain = plain.running_var.detach().numpy() - 0.97
    assert np.abs(moved_plain / moved_ref - 32 / 31).max() < 1e-3


def test_init_statistics_match_flax():
    """flax's default init (lecun_normal conv kernels, zero biases, BN
    scale 1): each conv's mean and std against flax's draw of the same
    layer, within 4 standard errors; biases, BN parameters and statistics
    exactly."""
    cfg = JD.DetTrainConfig(arch="yolov5s", input_size=(SIZE, SIZE))
    st = JD.create_det_train_state(cfg, jax.random.PRNGKey(0))
    ref = yolov5_face_state_dict(_np({"params": st["params"],
                                      "batch_stats": st["batch_stats"]}),
                                 "yolov5s")
    state = D.create_det_train_state(
        D.DetTrainConfig(arch="yolov5s", input_size=(SIZE, SIZE)),
        torch.Generator().manual_seed(1), device="cpu")
    got = state["net"].state_dict()
    assert set(got) == set(ref)
    n_conv = 0
    for k, r in ref.items():
        g = got[k].float()
        if k.endswith("weight") and r.dim() == 4:
            n = r.numel()
            std = float(r.std())
            assert abs(float(g.mean()) - float(r.mean())) <= 4 * std * (
                2 / n) ** 0.5, k
            assert abs(float(g.std()) / std - 1) <= 4 * (1 / n) ** 0.5 + \
                1e-3, k
            n_conv += 1
        elif not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(g, r, rtol=0, atol=0, msg=k)
    assert n_conv > 50


def test_sharded_step_raises_naming_the_roadmap():
    """The data-parallel step is ported: yolov5n over two repeated CPU
    entries, B = 2 split one a piece, gives the unsharded step's loss and
    moves the weights as it does (BatchNorm statistics of the whole
    batch)."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    cfg = D.DetTrainConfig(input_size=(SIZE, SIZE), **SCHED, **HEADS["face"])
    one, two = (D.create_det_train_state(cfg, device="cpu")
                for _ in range(2))
    init = {k: v.clone() for k, v in one["net"].state_dict().items()}
    step, replicas = D.sharded_det_train_step(
        two, make_mesh(("data",), devices=["cpu"] * 2))
    assert len(replicas) == 2 and next(iter(replicas.values())) is two
    x, t, v = map(torch.from_numpy, _batch(np.random.RandomState(8)))
    want, got = D.make_det_train_step(one)(x, t, v), step(x, t, v)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert not change_gaps(two["net"].state_dict(), one["net"].state_dict(),
                           init, 1e-3)
