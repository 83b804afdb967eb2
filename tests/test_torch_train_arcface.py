"""The port's ArcFace training (``models/mobile_facenet.arcface_logits``,
the embedders in train mode, ``train/arcface.py``) against the JAX
package's, on the CPU.

- ``arcface_logits`` and its gradient against JAX's on seeded rows and on
  rows at the clip bounds (cos = +1 and -1 exactly, where the gradient is
  inf or NaN, and the fallback below cos(pi - m)): the logits within 1e-5,
  the gradients within 1e-4 of their scale, with the same inf and NaN
  positions;
- each embedder slot (mobile_facenet, facenet, facenet-512, reid-mnv2) in
  train mode, from the JAX init carried across by ``utils/weights.py``:
  the embeddings within 1e-4 and every BatchNorm's running statistics
  after one forward within 1e-4 of their scale (flax's update: the biased
  variance, momentum 0.99 in flax's sense, 0.97 for reid's ConvBN);
- one MobileFaceNet ArcFace step and three (center term on), from the same
  weights and batches, both sides in f64 (at flax's init the gradient
  moves by percents under the 1e-5 relative differences of the two
  libraries' f32 convolutions): the loss within 1e-6 relative a step, and
  each tensor's change from the init within 1e-3 (one step) and 1e-2
  (three) of JAX's change's largest value plus 8 f32 ulps
  (``test_torch_train_detection.change_gaps``), the class kernel included;
  PReLU's slopes change, but by no decay (the decay groups hold them out,
  as flax's leaf-name mask holds ``alpha`` out);
- the decay mask: conv and Dense kernels and the class kernel decay,
  PReLU slopes, BatchNorm scales and shifts do not, and FaceNet's
  scale-less BatchNorm weights have no gradient at all.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models import \
    mobile_facenet as JMF
from face_detection_and_recognition_tpu.train import arcface as JA
from face_detection_and_recognition_tpu_torch.models import \
    mobile_facenet as MF
from face_detection_and_recognition_tpu_torch.train import arcface as A
from face_detection_and_recognition_tpu_torch.utils import weights as W
from tests.test_torch_train_detection import change_gaps


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _logit_inputs():
    rng = np.random.RandomState(0)
    d, c = 8, 6
    kernel = rng.uniform(-1, 1, (d, c)).astype(np.float32)
    # columns 0 and 1 unit vectors: an embedding equal to one (or to its
    # negative) gives cos = +1 (-1) exactly on both sides
    kernel[:, 0] = 0.0
    kernel[0, 0] = 1.0
    kernel[:, 1] = 0.0
    kernel[1, 1] = 1.0
    emb = rng.normal(size=(7, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[0] = kernel[:, 0]
    emb[1] = -kernel[:, 1]
    emb[2] = kernel[:, 0]
    labels = np.array([0, 1, 1, 3, 4, 5, 2], np.int32)
    # row 3: pushed toward -column 3 so that cos falls below cos(pi - m)
    col = kernel[:, 3] / np.linalg.norm(kernel[:, 3])
    emb[3] = -0.99 * col + 0.01 * emb[3]
    emb[3] /= np.linalg.norm(emb[3])
    return emb, labels, kernel


def test_arcface_logits_and_gradient_match_jax():
    emb, labels, kernel = _logit_inputs()
    s, m = 16.0, 0.5
    w = np.random.RandomState(1).normal(size=(7, 6)).astype(np.float32)

    def jf(e, k):
        return jnp.sum(JMF.arcface_logits(e, jnp.asarray(labels), k, s, m)
                       * w)

    ref = np.asarray(JMF.arcface_logits(jnp.asarray(emb),
                                        jnp.asarray(labels),
                                        jnp.asarray(kernel), s, m))
    ge_ref, gk_ref = [np.asarray(g) for g in jax.grad(jf, (0, 1))(
        jnp.asarray(emb), jnp.asarray(kernel))]
    e = torch.tensor(emb, requires_grad=True)
    k = torch.tensor(kernel, requires_grad=True)
    got = MF.arcface_logits(e, torch.tensor(labels), k, s, m)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    # the fallback row and the +-1 rows are in the test
    assert np.asarray(emb[3] @ (kernel[:, 3] / np.linalg.norm(
        kernel[:, 3]))) < math.cos(math.pi - m)
    assert not np.isfinite(ge_ref).all()
    for g, r in ((e.grad.numpy(), ge_ref), (k.grad.numpy(), gk_ref)):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
        np.testing.assert_array_equal(np.isinf(g), np.isinf(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin],
                                   atol=1e-4 * np.abs(r[fin]).max())


# ---------------------------------------------------------------------------
# the embedder slots in train mode
# ---------------------------------------------------------------------------

_SLOTS = {
    "mobile_facenet": (512, lambda v, d: W.mobile_facenet_state_dict(v)),
    "facenet": (128, lambda v, d: W.facenet_state_dict(v, d)),
    "facenet-512": (512, lambda v, d: W.facenet_state_dict(v, d)),
    "reid-mnv2": (256, lambda v, d: W.reid_mnv2_state_dict(v)),
}


def _jax_state(cfg):
    st = JA.create_train_state(cfg, jax.random.PRNGKey(3))
    return st, _np({"params": st["params"]["net"],
                    "batch_stats": st["batch_stats"]})


def _port_state(cfg, to_port, variables, kernel):
    st = A.create_train_state(A.ArcFaceTrainConfig(**{
        f.name: getattr(cfg, f.name) for f in
        __import__("dataclasses").fields(cfg) if f.name != "dtype"}),
        device="cpu")
    st["net"].load_state_dict(to_port(variables, cfg.embedding_size))
    with torch.no_grad():
        st["arcface_kernel"].copy_(torch.tensor(np.asarray(kernel)))
    return st


@pytest.mark.parametrize("slot", sorted(_SLOTS))
def test_train_mode_forward_and_statistics_match_jax(slot):
    dim, to_port = _SLOTS[slot]
    cfg = JA.ArcFaceTrainConfig(num_classes=4, embedding_size=dim,
                                embedder=slot)
    jst, variables = _jax_state(cfg)
    hw = {"mobile_facenet": 112, "reid-mnv2": 128}.get(slot, 160)
    x = np.random.RandomState(2).uniform(-1, 1, (4, hw, hw, 3)) \
        .astype(np.float32)
    emb_ref, upd = jax.jit(lambda v, x: jst["net"].apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    pst = _port_state(cfg, to_port, variables,
                      jst["params"]["arcface_kernel"])
    emb = pst["net"](torch.tensor(x))
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(emb_ref),
                               atol=1e-4)
    ref_sd = to_port(_np({"params": variables["params"],
                          "batch_stats": upd["batch_stats"]}), dim)
    got_sd = pst["net"].state_dict()
    for k, r in ref_sd.items():
        if "running" in k:
            d = float((got_sd[k] - r).abs().max())
            assert d <= 1e-4 * max(float(r.abs().max()), 1.0), (k, d)


# ---------------------------------------------------------------------------
# the ArcFace step
# ---------------------------------------------------------------------------

def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _port_f64(st):
    """The port state in f64: the net's tensors, its compute dtype and the
    class kernel (the optimizer keeps the same parameter objects)."""
    st["net"].double()
    for mod in st["net"].modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    st["arcface_kernel"].data = st["arcface_kernel"].data.double()
    return st


@pytest.fixture(scope="module")
def step_runs():
    """Three MobileFaceNet steps (B = 2, 16-d, 4 classes, center term on),
    JAX and the port from the same weights and batches, both in f64: at
    flax's init the step's gradient moves by a few percent under a 1e-5
    relative change of an activation (the two libraries' f32 convolutions
    differ by that much), so the tensors are compared where rounding is
    not amplified into the result (the f32 train-mode forward is held
    above). Both nets round their embeddings to f32, so the gradients
    start from f32 cotangents: the tolerance is ``change_gaps``' (8 f32
    ulps of the tensor's scale), with 1e-3 of the change at one step and
    1e-2 at three."""
    cfg = JA.ArcFaceTrainConfig(num_classes=4, embedding_size=16, s=16.0,
                                lr=0.05, center_gain=0.02)
    jst, variables = _jax_state(cfg)
    kernel0 = np.asarray(jst["params"]["arcface_kernel"])
    rng = np.random.RandomState(5)
    batches = [(rng.uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32),
                rng.randint(0, 4, 2).astype(np.int32)) for _ in range(3)]
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
            sd = W.mobile_facenet_state_dict(jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64),
                {"params": p["net"], "batch_stats": bs}))
            ref.append({"loss": float(loss), "sd": sd,
                        "kernel": torch.tensor(np.asarray(
                            p["arcface_kernel"]))})
    pst = _port_f64(_port_state(cfg, to_port, variables, kernel0))
    init = {k: v.clone() for k, v in pst["net"].state_dict().items()}
    step = A.make_train_step(pst)
    got = []
    for x, y in batches:
        loss = step(torch.tensor(x, dtype=torch.float64), torch.tensor(y))
        got.append({"loss": float(loss),
                    "sd": {k: v.clone() for k, v in
                           pst["net"].state_dict().items()},
                    "kernel": pst["arcface_kernel"].detach().clone()})
    return (init, torch.tensor(kernel0, dtype=torch.float64), ref, got,
            pst)


@pytest.mark.parametrize("n_steps,rtol", [(1, 1e-3), (3, 1e-2)])
def test_arcface_steps_match_jax(step_runs, n_steps, rtol):
    init, kernel0, ref, got, _ = step_runs
    for r, g in zip(ref[:n_steps], got[:n_steps]):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-6 * n_steps)
    r, g = ref[n_steps - 1], got[n_steps - 1]
    assert not change_gaps(g["sd"], r["sd"], init, rtol)
    assert not change_gaps({"k": g["kernel"]}, {"k": r["kernel"]},
                           {"k": kernel0}, rtol)
    # the slopes moved (they train) and the class kernel moved
    prelu = [k for k in init if k.endswith("prelu.weight")]
    assert prelu and any(
        float((g["sd"][k] - init[k]).abs().max()) > 0 for k in prelu)
    assert float((g["kernel"] - kernel0).abs().max()) > 0


def test_decay_mask_is_flax_leaf_mask(step_runs):
    pst = step_runs[4]
    net = pst["net"]
    decay, rest = pst["opt"].param_groups
    assert decay["weight_decay"] == pst["cfg"].weight_decay
    assert rest["weight_decay"] == 0.0
    ids = {id(p) for p in decay["params"]}
    names = {id(p): n for n, p in net.named_parameters()}
    assert id(pst["arcface_kernel"]) in ids
    for p in decay["params"]:
        if p is not pst["arcface_kernel"]:
            assert names[id(p)].endswith(("conv.weight", "linear.weight"))
    for n, p in net.named_parameters():
        if n.endswith(("prelu.weight", "bn.weight", "bn.bias")):
            assert id(p) not in ids, n
    fn = A.create_train_state(A.ArcFaceTrainConfig(
        num_classes=3, embedding_size=128, embedder="facenet"),
        device="cpu")
    frozen = [n for n, p in fn["net"].named_parameters()
              if not p.requires_grad]
    assert frozen and all(n.endswith("bn.weight") for n in frozen)
    in_opt = {id(p) for g in fn["opt"].param_groups for p in g["params"]}
    assert not any(id(p) in in_opt for p in fn["net"].parameters()
                   if not p.requires_grad)


def test_sharded_step_waits_for_a12c():
    """The class-sharded step is ported: one step of the f64 state's
    config on a 1 x 2 mesh (the kernel over "model") from the same init
    and batch gives the unsharded step's loss and kernel (rounding of f64
    sums in another order)."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    cfg = A.ArcFaceTrainConfig(num_classes=4, embedding_size=16, s=16.0,
                               lr=0.05)
    one, two = (_port_f64(A.create_train_state(cfg, device="cpu"))
                for _ in range(2))
    mesh = make_mesh(("data", "model"), (1, 2), ["cpu"] * 2)
    step, replicas = A.sharded_train_step(two, mesh)
    assert A.shard_train_state(two, mesh).keys() == replicas.keys()
    x = torch.rand(2, 112, 112, 3, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(4)) * 2 - 1
    y = torch.tensor([1, 3])
    want = A.make_train_step(one)(x, y)
    got = step(x, y)
    assert float(got) == pytest.approx(float(want), rel=1e-12)
    kernel = A.gather_train_state(replicas, mesh)["arcface_kernel"]
    torch.testing.assert_close(kernel, one["arcface_kernel"].detach(),
                               rtol=0, atol=1e-12)
