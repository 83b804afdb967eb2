"""The port's recognition-side golden trainers (``train/golden_embed.py``,
``train/golden_ag.py``, ``train/golden_mtcnn.py``) against the JAX
package's, on the CPU.

- ``make_identity_crops``, ``make_multi_identity_crops`` (all 18 identity
  transforms: flips, +-14 degree rotations with a replicated border,
  gammas), ``build_ag_buffer`` and each MTCNN stage's
  ``build_stage_buffer`` byte-equal to the JAX package's (same
  ``random.Random`` draws; ``host_resize`` and ``warp_affine`` are cv2's
  bit for bit);
- ``evaluate_retrieval`` (the plain search) and ``evaluate_identity_filter``
  on one embed function (a seeded port engine's ``embed_crops``) give the
  JAX functions' results;
- one age / gender step (both heads, B = 2, dropout on) from the same
  weights and batch, the port fed JAX's dropout masks (read off the JAX
  heads' Dropout outputs): the loss within 1e-5 relative, each gradient
  (in f64) within 1e-5 of its largest value plus 8 f32 ulps, and
  ``train.optim.
  OptaxAdam`` given JAX's gradients within 4 ulps of optax's adamw update
  (Adam's first update is the sign of the gradient, so a change held
  across the two libraries' gradients would test the rounding of
  near-zero ones);
- one step of each MTCNN stage (B = 8, the masked CE + box + landmark loss
  of the JAX trainer, optax's adamw) held the same way;
- tiny ``train_golden_embedder``, ``train_golden_ag`` and
  ``train_golden_mtcnn`` runs on the CPU: finite losses, and the written
  ``.pt`` reloaded into a fresh engine gives the in-memory net's
  embeddings, labels or detections bit for bit.
"""
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from face_detection_and_recognition_tpu.train import golden_ag as JAG
from face_detection_and_recognition_tpu.train import golden_embed as JGE
from face_detection_and_recognition_tpu.train import golden_mtcnn as JGM
from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine)
from face_detection_and_recognition_tpu_torch.eval.card_weights import \
    CARD_WEIGHTS
from face_detection_and_recognition_tpu_torch.train import golden as G
from face_detection_and_recognition_tpu_torch.train import golden_ag as AG
from face_detection_and_recognition_tpu_torch.train import golden_embed as GE
from face_detection_and_recognition_tpu_torch.train import \
    golden_mtcnn as GM
from face_detection_and_recognition_tpu_torch.train.data import \
    load_wider_index
from face_detection_and_recognition_tpu_torch.utils import weights as W


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def grad_gaps(got, ref, rtol):
    """Parameters whose gradient differs from the reference's by more than
    ``rtol`` of the reference's largest value plus 8 ulps of it."""
    eps = float(np.finfo(np.float32).eps)
    bad = []
    for k, r in ref.items():
        scale = float(r.abs().max())
        d = float((got[k] - r).abs().max())
        if d > (rtol + 8 * eps) * scale + 1e-12:
            bad.append((k, d, scale))
    return bad


def adam_parity(params, grads, ref, init, lr):
    """Feed the reference's gradients to ``OptaxAdam`` (adamw) over
    ``params`` and return the tensors whose update differs from optax's by
    more than 4 ulps of the tensor's scale: the two optimizers on the same
    gradients."""
    from face_detection_and_recognition_tpu_torch.train.optim import \
        OptaxAdam

    named = dict(params)
    opt = OptaxAdam(named.values(), lr=lr, weight_decay=1e-4)
    for k, p in named.items():
        p.grad = grads[k].clone()
    opt.step()
    eps = float(np.finfo(np.float32).eps)
    return [k for k, p in named.items()
            if float((p.detach() - ref[k]).abs().max())
            > 4 * eps * max(float(ref[k].abs().max()),
                            float(init[k].abs().max()))]


# ---------------------------------------------------------------------------
# the crops and buffers
# ---------------------------------------------------------------------------

def test_identity_crops_byte_equal_jax():
    for got, ref in ((GE.make_identity_crops(11, 3, aug_scale=1.6),
                      JGE.make_identity_crops(11, 3, aug_scale=1.6)),
                     (GE.make_multi_identity_crops(
                         12, 1, n_identities=GE.MAX_IDENTITIES),
                      JGE.make_multi_identity_crops(
                          12, 1, n_identities=JGE.MAX_IDENTITIES))):
        assert len(got) == len(ref)
        for g_set, r_set in zip(got, ref):
            assert len(g_set) == len(r_set)
            for g, r in zip(g_set, r_set):
                assert g.dtype == np.uint8 and g.shape == r.shape
                np.testing.assert_array_equal(g, r)
    for v in range(GE.MAX_IDENTITIES):
        crop = np.random.RandomState(v).randint(0, 255, (40, 37, 3)) \
            .astype(np.uint8)
        np.testing.assert_array_equal(GE.apply_identity_transform(crop, v),
                                      JGE.apply_identity_transform(crop, v))


def test_ag_buffer_byte_equal_jax():
    got, ref = AG.build_ag_buffer(5, seed=3), JAG.build_ag_buffer(5, seed=3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def composite_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtcnn_ds")
    ann, root = G.make_composite_dataset(str(d), n_images=3,
                                         out_wh=(160, 160), seed=2)
    return load_wider_index(ann, root)


@pytest.mark.parametrize("size", [12, 24, 48])
def test_stage_buffer_byte_equal_jax(composite_index, size):
    got = GM.build_stage_buffer(composite_index, size, 24, seed=size)
    ref = JGM.build_stage_buffer(composite_index, size, 24, seed=size)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the gates' math
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def embed_engine():
    return FaceEngine(EngineConfig(detector="blazeface-front",
                                   embedder="mobile_facenet"), device="cpu")


def test_evaluate_retrieval_and_filter_match_jax(embed_engine):
    fn = embed_engine.embed_crops
    kw = dict(n_identities=4, n_gallery=4, n_probe=2)
    got = GE.evaluate_retrieval(fn, device="cpu", **kw)
    ref = JGE.evaluate_retrieval(fn, **kw)
    for k in ("ok", "rank1", "same_acc", "cross_acc", "n_identities"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["margins"], ref["margins"], atol=1e-6)
    got = GE.evaluate_identity_filter(fn, n_ref=4, n_probe=2)
    ref = JGE.evaluate_identity_filter(fn, n_ref=4, n_probe=2)
    for k in ("ok", "same_acc", "cross_acc"):
        assert got[k] == ref[k], k
    assert got["margin"] == pytest.approx(ref["margin"], abs=1e-6)


# ---------------------------------------------------------------------------
# one age / gender step, JAX's dropout masks replayed
# ---------------------------------------------------------------------------

def _ag_jax(dtype, x, ya, yg):
    """The JAX heads' loss, gradients and optax adamw update at ``dtype``
    (the weights drawn in f32 by numpy and cast; biases too), and the
    dropout masks its draw gave (read off the Dropout outputs)."""
    from face_detection_and_recognition_tpu.models.age_gender import \
        CaffeNetHead as JHead

    age_net = JHead(num_classes=8, dtype=dtype)
    gen_net = JHead(num_classes=2, dtype=dtype)
    x0 = jnp.zeros((1, 227, 227, 3), jnp.float32)
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(  # lecun-normal-scaled, drawn in numpy
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)
                              / np.sqrt(np.prod(a.shape[:-1]) or 1), dtype),
        tuple(jax.eval_shape(net.init, jax.random.PRNGKey(0), x0)["params"]
              for net in (age_net, gen_net)))
    def loss_fn(p, key):
        masks = []

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if type(context.module).__name__ == "Dropout":
                masks.append(jax.lax.stop_gradient(out) != 0)
            return out

        ka, kg = jax.random.split(key)
        with flax.linen.intercept_methods(grab):
            la = age_net.apply({"params": p[0]}, jnp.asarray(x, dtype),
                               train=True, rngs={"dropout": ka})
            lg = gen_net.apply({"params": p[1]}, jnp.asarray(x, dtype),
                               train=True, rngs={"dropout": kg})
        return (optax.softmax_cross_entropy_with_integer_labels(
            la, ya).mean() + optax.softmax_cross_entropy_with_integer_labels(
            lg, yg).mean()), masks

    (loss, masks), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jax.random.PRNGKey(9))
    masks = [np.asarray(m) for m in masks]
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    upd, _ = tx.update(grads, tx.init(params), params)
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), t)
    return (float(loss), to_np(params), to_np(grads),
            to_np(optax.apply_updates(params, upd)), masks)


def _port_ag_grads(params, x_u8, ya, yg, masks, dtype):
    state = AG.create_ag_train_state(lr=1e-3, device="cpu")
    net = state["net"].to(dtype)
    net.load_state_dict(W.age_gender_state_dict(
        *({"params": p} for p in params)))
    keep = [torch.tensor(m) for m in masks]
    x = (torch.tensor(x_u8).to(dtype) - state["mean"].to(dtype)) \
        .permute(0, 3, 1, 2)
    loss = (torch.nn.functional.cross_entropy(
        net.age(x, tuple(keep[:2])), torch.tensor(ya).long())
        + torch.nn.functional.cross_entropy(
        net.gender(x, tuple(keep[2:])), torch.tensor(yg).long()))
    loss.backward()
    return state, float(loss), {k: p.grad for k, p in
                                net.named_parameters()}


def test_ag_step_matches_jax():
    """The loss in f32; the gradients in f64 (the JAX heads widen their
    logits to f32, so their gradients start from f32 cotangents: 1e-5 of
    each tensor's largest value; in f32 the two libraries' gradients part
    by up to 0.5% at this init); optax's adamw update against
    ``OptaxAdam`` on JAX's f32 gradients, in f32."""
    x_u8, ya, yg = JAG.build_ag_buffer(2, seed=1)
    x = x_u8.astype(np.float64) - np.asarray(JAG.AG_MEAN, np.float64)
    loss, params, grads, new, masks = _ag_jax(jnp.float32, x, ya, yg)
    assert len(masks) == 4 and all(m.shape == (2, 512) for m in masks)
    state, got_loss, _ = _port_ag_grads(params, x_u8, ya, yg, masks,
                                        torch.float32)
    assert got_loss == pytest.approx(loss, rel=1e-5)
    init = W.age_gender_state_dict(*({"params": p} for p in params))
    ref_g = W.age_gender_state_dict(*({"params": g} for g in grads))
    ref = W.age_gender_state_dict(*({"params": p} for p in new))
    net = state["net"]
    net.load_state_dict(init)
    assert not adam_parity(net.named_parameters(), ref_g, ref, init, 1e-3)
    # the trainer's own step: the same loss on the same masks
    net.load_state_dict(init)
    keep = [torch.tensor(m) for m in masks]
    step_loss, _ = state["step"](torch.tensor(x_u8), torch.tensor(ya),
                                 torch.tensor(yg), tuple(keep[:2]),
                                 tuple(keep[2:]))
    assert float(step_loss) == pytest.approx(got_loss, rel=1e-6)
    with jax.enable_x64(True):
        _, p64, g64, _, m64 = _ag_jax(jnp.float64, x, ya, yg)
    _, _, got_g = _port_ag_grads(p64, x_u8, ya, yg, m64, torch.float64)
    ref_g = W.age_gender_state_dict(*({"params": g} for g in g64))
    assert not grad_gaps(got_g, {k: v.double() for k, v in ref_g.items()},
                         1e-5)


def test_caffenet_inference_ignores_dropout():
    from face_detection_and_recognition_tpu_torch.models.age_gender import \
        make_age_gender

    net = make_age_gender(torch.Generator().manual_seed(0), "cpu")
    x = torch.rand((2, 227, 227, 3)) * 50
    a1, g1 = net(x)
    a2, g2 = net(x)
    assert torch.equal(a1, a2) and torch.equal(g1, g2)
    net.train()
    keep = tuple(torch.ones((2, 512), dtype=torch.bool) for _ in range(2))
    logits = net.age(x.permute(0, 3, 1, 2), keep)
    # all kept: the train forward is the eval forward with the kept
    # activations doubled
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# one step of each MTCNN stage
# ---------------------------------------------------------------------------

def _jax_stage_loss(name, net, params, x, c, cm, r, rm, lm_t, lm_m):
    """The JAX trainer's loss (``train/golden_mtcnn.py:232-248``)."""
    out = net.apply({"params": params}, x)
    prob, reg = out[0], out[1]
    p = jnp.clip(prob, 1e-7, 1.0)
    if name == "pnet":
        p = p.reshape(p.shape[0], -1)[:, -2:]
        reg = reg.reshape(reg.shape[0], -1)[:, -4:]
    ce = -(c * jnp.log(p[:, 1]) + (1 - c) * jnp.log(p[:, 0]))
    l_cls = jnp.sum(ce * cm) / jnp.maximum(jnp.sum(cm), 1.0)
    l_reg = jnp.sum(jnp.sum((reg - r) ** 2, -1) * rm) \
        / jnp.maximum(jnp.sum(rm), 1.0)
    l_lmk = 0.0
    if name == "onet":
        l_lmk = jnp.sum(jnp.sum((out[2] - lm_t) ** 2, -1) * lm_m) \
            / jnp.maximum(jnp.sum(lm_m), 1.0)
    return l_cls + 0.5 * l_reg + 0.5 * l_lmk


@pytest.fixture(scope="module")
def mtcnn_jax():
    """The JAX stage nets and their initial variables (all three: the
    port's state dict holds the whole cascade)."""
    from face_detection_and_recognition_tpu.models import mtcnn as JM

    nets = {"pnet": JM.PNet(), "rnet": JM.RNet(), "onet": JM.ONet()}
    keys = dict(zip(nets, jax.random.split(jax.random.PRNGKey(6), 3)))
    return nets, {n: {"params": nets[n].init(
        keys[n], jnp.zeros((1, s, s, 3)))["params"]}
        for n, s in GM.STAGE_SIZES.items()}


@pytest.mark.parametrize("name", ["pnet", "rnet", "onet"])
def test_mtcnn_stage_step_matches_jax(composite_index, mtcnn_jax, name):
    from face_detection_and_recognition_tpu_torch.models.mtcnn import (
        MTCNN, MTCNNConfig)

    size = GM.STAGE_SIZES[name]
    nets, variables = mtcnn_jax
    data = GM.build_stage_buffer(composite_index, size, 8, seed=size + 1)
    args = [data[k] for k in GM.BUFFER_KEYS]
    jargs = [a.astype(np.float32) if k == "cls" else a
             for k, a in zip(GM.BUFFER_KEYS, args)]
    lr = 1e-3
    tx = optax.adamw(lr, weight_decay=1e-4)
    p0 = variables[name]["params"]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_stage_loss(name, nets[name], p, *jargs)))(p0)
    upd, _ = tx.update(grads, tx.init(p0), p0)
    new = dict(variables, **{name: {"params": optax.apply_updates(p0, upd)}})

    cascade = MTCNN(MTCNNConfig())
    init = W.mtcnn_state_dict(_np(variables))
    cascade.load_state_dict(init)
    net = getattr(cascade, name).train()
    got_loss, _ = GM.stage_loss(name, net, *[torch.tensor(a) for a in args])
    got_loss.backward()
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    ref_g = {k: v for k, v in W.mtcnn_state_dict(_np(dict(
        variables, **{name: {"params": grads}}))).items()
        if k.startswith(name + ".")}
    named = {f"{name}.{k}": p for k, p in net.named_parameters()}
    assert set(named) == set(ref_g)
    assert not grad_gaps({k: p.grad for k, p in named.items()}, ref_g, 1e-4)
    ref = W.mtcnn_state_dict(_np(new))
    cascade.load_state_dict(init)
    assert not adam_parity(named.items(), ref_g, ref, init, lr)


# ---------------------------------------------------------------------------
# tiny runs of the three loops
# ---------------------------------------------------------------------------

def test_train_golden_embedder_tiny_run(tmp_path):
    out = str(tmp_path / "embed.pt")
    r = GE.train_golden_embedder(out, batch_size=6, max_steps=2,
                                 eval_every=2, n_train_per_id=4, seed=1,
                                 device="cpu", log=lambda s: None)
    assert r["steps"] == 2 and "reload_ok" in r
    meta = GE.meta_path(out)
    assert os.path.exists(meta)
    crops = np.stack(GE.make_identity_crops(5, 2)[0])
    np.testing.assert_array_equal(r["engine"].embed_crops(crops),
                                  r["embed"](crops))


def test_train_golden_ag_tiny_run(tmp_path):
    out = str(tmp_path / "ag.pt")
    r = AG.train_golden_ag(out, str(CARD_WEIGHTS / "yolov5n.pt"),
                           n_buffer=6, batch_size=3, max_steps=2,
                           eval_every=2, device="cpu", log=lambda s: None)
    assert r["steps"] == 2 and np.isfinite(r["losses"]).all()
    assert r["reload_labels"] == r["labels"]
    sd1 = r["engine"].ag_net.state_dict()
    sd2 = r["reload_engine"].ag_net.state_dict()
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)


def test_train_golden_mtcnn_tiny_run(tmp_path):
    out = str(tmp_path / "mtcnn.pt")
    r = GM.train_golden_mtcnn(out, str(tmp_path / "work"), n_images=3,
                              n_crops=12, batch_size=4, max_steps=2,
                              eval_every=2, device="cpu",
                              bootstrap_rounds=1, log=lambda s: None)
    assert all(np.isfinite(v).all() for v in r["losses"].values())
    img = G.imread(G.GOLDEN_IMG)
    a = r["engine"].detect_raw(img)
    b = r["reload_engine"].detect_raw(img)
    np.testing.assert_array_equal(a, b)
    assert r["reload_ok"] == r["ok"]
