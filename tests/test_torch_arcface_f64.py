"""The port's ArcFace trainer against the JAX package's in exact f64, at
the golden embedder recipe's head (``train/golden_embed.py``: three
classes, 512-d, s = 16, m = 0.5, center gain 0.02, lr 0.01), on the CPU.

``tests/test_torch_train_arcface.py`` holds the step with both nets
rounding their embeddings to f32, as they do in use, so its tolerance is
that rounding's. Here the one f32 cast of each net (the embeddings before
their L2 normalization) is lifted, and what is left is the two libraries'
f64 arithmetic: over four MobileFaceNet steps from the JAX init and the
same batches, each step's loss within 1e-12 relative, the class kernel
within 1e-12, and the eval-mode embeddings after the steps (the running
statistics the filter gate reads) within 1e-10. So the trainer is JAX's;
where a run of the golden embedder takes another path than JAX's (its
filter gate at one eval and not the other), the cause is the f32 rounding
the two libraries' convolutions differ in, which training amplifies, and
the draws of the init: the port's init of a seed has JAX's distributions
(each weight flax's lecun_normal, the constant tensors equal), not JAX's
values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models import \
    mobile_facenet as JMF
from face_detection_and_recognition_tpu.train import arcface as JA
from face_detection_and_recognition_tpu_torch.train import arcface as A
from face_detection_and_recognition_tpu_torch.utils import weights as W
from tests.test_torch_train_arcface import _f64, _port_f64

RECIPE = dict(num_classes=3, lr=0.01, embedding_size=512, s=16.0,
              center_gain=0.02)


class _F64Names:
    """``jnp`` for the JAX MobileFaceNet's module, ``float32`` read as
    float64: its embeddings' cast keeps f64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@pytest.fixture(scope="module")
def exact_runs():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(JMF, "jnp", _F64Names())
    to_f32 = torch.Tensor.float
    mp.setattr(torch.Tensor, "float", lambda t, *a, **k: t
               if t.dtype == torch.float64 else to_f32(t, *a, **k))
    try:
        yield _runs()
    finally:
        mp.undo()
        torch.set_num_threads(n)


def _runs():
    rng = np.random.RandomState(7)
    batches = [(rng.uniform(-1, 1, (4, 112, 112, 3)),
                rng.randint(0, 3, 4).astype(np.int32)) for _ in range(4)]
    probe = rng.uniform(-1, 1, (3, 112, 112, 3))
    jst = JA.create_train_state(JA.ArcFaceTrainConfig(**RECIPE),
                                jax.random.PRNGKey(1))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), {
        "params": jst["params"]["net"], "batch_stats": jst["batch_stats"]})
    kernel0 = np.asarray(jst["params"]["arcface_kernel"], np.float32)
    pst = A.create_train_state(A.ArcFaceTrainConfig(**RECIPE),
                               device="cpu")
    pst["net"].load_state_dict(W.mobile_facenet_state_dict(v))
    with torch.no_grad():
        pst["arcface_kernel"].copy_(torch.tensor(kernel0))
    pst = _port_f64(pst)
    pstep = A.make_train_step(pst)
    with jax.enable_x64(True):
        cfg = JA.ArcFaceTrainConfig(**RECIPE, dtype=jnp.float64)
        net = type(jst["net"])(embedding_size=512, dtype=jnp.float64)
        st = dict(jst, cfg=cfg, net=net)
        p = _f64({"net": v["params"], "arcface_kernel": kernel0})
        bs = _f64(v["batch_stats"])
        opt = st["tx"].init(p)
        jstep = jax.jit(JA.make_train_step(st))
        losses = []
        for x, y in batches:
            p, bs, opt, loss = jstep(p, bs, opt, jnp.asarray(x), y)
            got = pstep(torch.tensor(x), torch.tensor(y))
            losses.append((float(loss), float(got)))
        ref_emb = np.asarray(net.apply(
            {"params": p["net"], "batch_stats": bs}, jnp.asarray(probe)))
        ref_kernel = np.asarray(p["arcface_kernel"])
    pst["net"].eval()
    with torch.no_grad():
        emb = pst["net"](torch.tensor(probe)).numpy()
    return {"losses": losses, "kernel": (
        ref_kernel, pst["arcface_kernel"].detach().numpy()),
        "emb": (ref_emb, emb)}


def test_losses_are_jaxs_to_f64(exact_runs):
    for i, (ref, got) in enumerate(exact_runs["losses"]):
        assert abs(got - ref) <= 1e-12 * abs(ref), (i, ref, got)


def test_class_kernel_and_eval_embeddings_are_jaxs_to_f64(exact_runs):
    ref, got = exact_runs["kernel"]
    assert got.dtype == np.float64 and ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    ref, got = exact_runs["emb"]
    assert got.dtype == np.float64 and ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_init_has_jaxs_distributions():
    """Each conv and Dense weight of both inits follows flax's lecun_normal
    (a normal truncated at two of its standard deviations, scaled to a
    standard deviation of sqrt(1 / fan_in)): the sample's spread within
    5 / sqrt(2 n) of it, every value inside the truncation; the constant
    tensors (BatchNorm, PReLU) equal; the class kernel uniform(-1, 1)."""
    jst = JA.create_train_state(JA.ArcFaceTrainConfig(**RECIPE),
                                jax.random.PRNGKey(0))
    ref = W.mobile_facenet_state_dict(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        {"params": jst["params"]["net"], "batch_stats": jst["batch_stats"]}))
    pst = A.create_train_state(A.ArcFaceTrainConfig(**RECIPE),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    got = pst["net"].state_dict()
    assert set(got) == set(ref)
    n_weights = 0
    for k, r in ref.items():
        g = got[k]
        if not r.dtype.is_floating_point:
            continue
        if float(r.std()) == 0.0:
            assert torch.equal(g.float(), r), k
            continue
        n_weights += 1
        std = (1.0 / r[0].numel()) ** 0.5
        for t in (r, g.float()):
            assert abs(float(t.std()) / std - 1.0) < 5 / (2 * t.numel()) \
                ** 0.5, k
            assert float(t.abs().max()) <= 2 * std / 0.87962566 * 1.0001, k
        assert not torch.equal(g, r), k
    assert n_weights == 50  # 49 convolutions and the Dense
    kr = np.asarray(jst["params"]["arcface_kernel"])
    kg = pst["arcface_kernel"].detach().numpy()
    for k in (kr, kg):
        assert k.shape == (512, 3) and -1.0 <= k.min() and k.max() <= 1.0
        assert abs(k.std() * 3 ** 0.5 - 1.0) < 5 / (2 * k.size) ** 0.5
