"""The port's graph trainers (``train/caffe_golden.py``,
``train/ov_golden.py``), their exporters and the protobuf writers against
the JAX package's, on the CPU.

- ``utils/model_formats.write_caffemodel`` (V2 and V1) and
  ``write_graphdef`` (f32, f16, int32, uint8, int64 and bool constants)
  byte-equal to the JAX writers on the same layers, and read back by the
  port's ``read_caffemodel`` / ``read_tf_graphdef``;
- two res10-ssd steps and two ov-0204 steps (B = 2) from the JAX package's
  train state (its LSUV-rescaled, prior-biased res10 blobs; ov-0204's
  seeded constants) carried across by ``utils/weights.py``: each step's
  loss within 1e-4 relative (the first) and 1e-3 (the second), the first
  step's gradients within 2e-3 of each tensor's largest value plus 8 ulps
  (the OpenVINO Clamp takes ``jnp.clip``'s gradient,
  ``models.layers.jax_clip``), and the optimizer (block-RMS clip, masked L2
  decay, Adam) given JAX's gradients within 4 ulps of optax's chain (Adam's
  first update is near the sign of the gradient, so parameter changes held
  across the two libraries' gradients would test the rounding of near-zero
  ones); res10's BatchNorm statistics take no gradient and stay unmoved,
  bit for bit;
- the port's LSUV: each convolution's output std on the LSUV batch is 1
  after the rescale (within 1e-3);
- ``export_trained_caffemodel`` and ``export_trained_ir`` byte-equal to the
  JAX exporters on the same weights, and the files reloaded by
  ``FaceEngine.load_weights`` give the raw detections of an engine holding
  the same weights in memory, bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.train import caffe_golden as JCG
from face_detection_and_recognition_tpu.train import ov_golden as JOG
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine)
from face_detection_and_recognition_tpu_torch.train import caffe_golden as CG
from face_detection_and_recognition_tpu_torch.train import ov_golden as OG
from face_detection_and_recognition_tpu_torch.train.detection import \
    load_train_weights
from face_detection_and_recognition_tpu_torch.utils import model_formats as MF
from face_detection_and_recognition_tpu_torch.utils import weights as W


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the writers
# ---------------------------------------------------------------------------

def test_write_caffemodel_byte_equal_jax():
    rng = np.random.RandomState(0)
    layers = [("conv1", "Convolution", [rng.normal(size=(4, 3, 3, 3)),
                                        rng.normal(size=(4,))]),
              ("relu1", "ReLU", []),
              ("fc", "InnerProduct", [rng.normal(size=(5, 36))]),
              ("prob", "Softmax", [])]
    for v1 in (False, True):
        ours = MF.write_caffemodel(
            [MF.CaffeLayer(n, t, [np.asarray(b, np.float32) for b in bl])
             for n, t, bl in layers], v1=v1)
        theirs = JMF.write_caffemodel(
            [JMF.CaffeLayer(n, t, [np.asarray(b, np.float32) for b in bl])
             for n, t, bl in layers], v1=v1)
        assert ours == theirs
        back = MF.read_caffemodel(ours)
        assert [(L.name, L.type) for L in back] == \
            [(n, t) for n, t, _ in layers]
        for L, (_, _, bl) in zip(back, layers):
            for got, ref in zip(L.blobs, bl):
                np.testing.assert_array_equal(
                    got.reshape(np.shape(ref)), np.float32(ref))


def test_write_graphdef_byte_equal_jax():
    rng = np.random.RandomState(1)
    values = {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
              "h": rng.normal(size=(5,)).astype(np.float16),
              "i": rng.randint(-9, 9, (2, 3)).astype(np.int32),
              "u": rng.randint(0, 255, (7,)).astype(np.uint8),
              "l": rng.randint(-9, 9, (4,)).astype(np.int64),
              "b": rng.rand(3) > 0.5,
              "s": np.float32(2.5).reshape(())}
    ours = MF.write_graphdef([MF.GraphConst(k, v) for k, v in values.items()])
    theirs = JMF.write_graphdef([JMF.GraphConst(k, v)
                                 for k, v in values.items()])
    assert ours == theirs
    back = MF.read_tf_graphdef(ours)
    assert [c.name for c in back] == list(values)
    for c in back:
        np.testing.assert_array_equal(c.value, values[c.name])
        assert c.value.dtype == values[c.name].dtype


# ---------------------------------------------------------------------------
# res10-ssd and ov-0204 steps
# ---------------------------------------------------------------------------

def _batch(size, seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (2, size, size, 3)).astype(np.uint8)
    targets = np.zeros((2, 4, 14), np.float32)
    valid = np.zeros((2, 4), bool)
    for b in range(2):
        for t in range(1 + b):
            w = rng.uniform(0.15, 0.4) * size
            targets[b, t, :4] = [rng.uniform(0.3, 0.7) * size,
                                 rng.uniform(0.3, 0.7) * size, w, w * 1.2]
            valid[b, t] = True
    return images, targets, valid


def _jax_grads(jstate, images, targets, valid, family):
    """The gradients of the JAX step's loss (its ``loss_fn``, written out
    from ``train/caffe_golden.py`` / ``train/ov_golden.py``: the net's
    taps, ``encode_ssd_targets``, ``ssd_multibox_loss``) at the state's
    parameters."""
    import jax.numpy as jnp

    from face_detection_and_recognition_tpu.train.ssd import (
        OPENCV_SSD_MEAN, encode_ssd_targets, ssd_multibox_loss)

    net, cfg, priors = jstate["net"], jstate["cfg"], jstate["priors"]
    w, h = cfg.input_size
    scale = jnp.asarray([w, h, w, h], jnp.float32)
    n = priors.shape[0]
    b = images.shape[0]

    def loss_fn(params):
        if family == "res10":
            x = images.astype(jnp.float32) - jnp.asarray(OPENCV_SSD_MEAN,
                                                         jnp.float32)
            env = net.apply(params, x, taps=("mbox_loc", "mbox_conf_reshape"))
            locs, conf = env["mbox_loc"], env["mbox_conf_reshape"]
        else:
            env = net.apply(params, images.astype(jnp.float32),
                            taps=("mbox_loc_flat", "mbox_conf_reshape"))
            locs, conf = env["mbox_loc_flat"], env["mbox_conf_reshape"]
        loc_t, pos = encode_ssd_targets(priors, targets[..., :4] / scale,
                                        valid, jstate["variances"],
                                        cfg.iou_pos)
        return ssd_multibox_loss(
            locs.astype(jnp.float32).reshape(b, n, 4),
            conf.astype(jnp.float32).reshape(b, n, 2), loc_t, pos,
            cfg.neg_ratio, cfg.loc_gain)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(jstate["params"])


def _run_steps(jstate, jstep, to_sd, pstate, batches, family):
    """Two steps on each side, the first step's gradients of each, and
    optax's first update against ``OptaxAdam`` on JAX's gradients."""
    p, bs, opt = jstate["params"], jstate["batch_stats"], \
        jstate["opt_state"]
    ema, n = jstate["ema_params"], jax.numpy.zeros((), jax.numpy.int32)
    init = to_sd(jax.device_get(p))
    load_train_weights(pstate, init)
    step = pstate["make_step"](pstate)
    named = dict(pstate["net"].named_parameters())
    out = {"init": init, "ref": [], "got": []}
    for i, (images, targets, valid) in enumerate(batches):
        p, bs, opt, ema, n, loss, _ = jstep(p, bs, opt, ema, n, images,
                                            targets, valid)
        out["ref"].append((to_sd(jax.device_get(p)), float(loss)))
        loss, _ = step(torch.tensor(images), torch.tensor(targets),
                       torch.tensor(valid))
        out["got"].append(({k: v.detach().clone() for k, v in
                            pstate["net"].state_dict().items()},
                           float(loss)))
        if i == 0:
            out["got_grads"] = {k: v.grad.clone() for k, v in named.items()
                                if v.grad is not None}
            jloss, jg = _jax_grads(jstate, images, targets, valid, family)
            out["ref_grads"] = to_sd(jax.device_get(jg))
            out["ref_loss0"] = float(jloss)
            upd, _ = jstate["tx"].update(jg, jstate["tx"].init(
                jstate["params"]), jstate["params"])
            import optax
            out["ref_update"] = to_sd(jax.device_get(
                optax.apply_updates(jstate["params"], upd)))
    return out


def _hold(runs, lr):
    """The losses of both steps, the first step's gradients (2e-3 of each
    tensor's largest plus 8 ulps: the trunks have no batch statistics, so
    the two libraries' f32 gradients stay close, but a ReLU6 input that is
    0 in one library and a rounding away from it in the other takes the
    bound's half gradient on one side only, which moves a depthwise bias's
    sum by ~1e-3) and the optimizer on JAX's gradients (4 ulps)."""
    from face_detection_and_recognition_tpu_torch.train.optim import \
        OptaxAdam
    from tests.test_torch_train_recognition import grad_gaps

    ref, got = runs["ref"], runs["got"]
    assert runs["ref_loss0"] == pytest.approx(ref[0][1], rel=1e-6)
    for i, ((_, r_loss), (_, g_loss)) in enumerate(zip(ref, got)):
        assert g_loss == pytest.approx(r_loss, rel=1e-4 if i == 0 else 1e-3)
    ref_g = {k: runs["ref_grads"][k] for k in runs["got_grads"]}
    assert not grad_gaps(runs["got_grads"], ref_g, 2e-3)
    init = runs["init"]
    params = {k: torch.nn.Parameter(init[k].clone()) for k in ref_g}
    decay = [p for k, p in params.items() if p.dim() >= 2
             and not k.endswith("%2Fbias")]
    rest = [p for k, p in params.items() if not any(p is d for d in decay)]
    opt = OptaxAdam([{"params": decay, "weight_decay": 5e-4},
                     {"params": rest, "weight_decay": 0.0}], lr=lr,
                    decoupled=False, clip_rms=1.0)
    for k, p in params.items():
        p.grad = ref_g[k].clone()
    opt.step()
    eps = float(np.finfo(np.float32).eps)
    for k, p in params.items():
        r = runs["ref_update"][k]
        assert float((p.detach() - r).abs().max()) <= 4 * eps * max(
            float(r.abs().max()), float(init[k].abs().max())), k


@pytest.fixture(scope="module")
def res10_runs():
    cfg = JCG.CaffeGoldenConfig(lr=0.002)
    jstate = JCG.create_res10_train_state(cfg, jax.random.PRNGKey(0))
    jstep = jax.jit(JCG.make_res10_train_step_ema(jstate))
    pstate = CG.create_res10_train_state(CG.CaffeGoldenConfig(lr=0.002),
                                         device="cpu")
    pstate["make_step"] = CG.make_res10_train_step_ema
    batches = [_batch(300, s) for s in (1, 2)]
    runs = _run_steps(jstate, jstep, W.caffe_graph_state_dict, pstate,
                      batches, "res10")
    return runs, pstate


def test_res10_steps_match_jax_with_frozen_statistics(res10_runs):
    runs, pstate = res10_runs
    _hold(runs, 0.002)
    init, got, ref = runs["init"], runs["got"], runs["ref"]
    bn = [k for k in init if any(
        k.startswith(f"blobs.{s.name}.") for s in pstate["net"].steps
        if s.op == "batchnorm")]
    assert bn and not any(k in runs["got_grads"] for k in bn)
    for k in bn:
        assert torch.equal(got[-1][0][k], init[k]), k
        assert torch.equal(ref[-1][0][k], init[k]), k


def test_res10_lsuv_rescales_every_convolution():
    from face_detection_and_recognition_tpu_torch.models.res10 import \
        build_res10

    net, _ = build_res10(torch.Generator().manual_seed(3))
    CG.lsuv_rescale(net, (300, 300))
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (2, 300, 300, 3)).astype(np.float32)
        - np.asarray(CG.OPENCV_SSD_MEAN, np.float32))
    convs = [s.output for s in net.steps if s.op == "conv"]
    with torch.no_grad():
        env = net(x, taps=convs)
    for k in convs:
        assert float(env[k].std(unbiased=False)) == pytest.approx(1.0,
                                                                  abs=1e-3)


@pytest.fixture(scope="module")
def ov_runs():
    cfg = JOG.OVGoldenConfig(lr=0.002)
    jstate = JOG.create_ov_train_state(cfg, jax.random.PRNGKey(0))
    jstep = jax.jit(JOG.make_ov_train_step_ema(jstate))
    pstate = OG.create_ov_train_state(OG.OVGoldenConfig(lr=0.002),
                                      device="cpu")
    pstate["make_step"] = OG.make_ov_train_step_ema
    batches = [_batch(448, s) for s in (3, 4)]
    return _run_steps(jstate, jstep, W.ov_graph_state_dict, pstate,
                      batches, "ov")


def test_ov0204_steps_match_jax(ov_runs):
    _hold(ov_runs, 0.002)


# ---------------------------------------------------------------------------
# the exporters, reloaded
# ---------------------------------------------------------------------------

def _golden_small():
    from face_detection_and_recognition_tpu_torch.train.golden import (
        GOLDEN_IMG, imread)

    return imread(GOLDEN_IMG)


def test_export_trained_caffemodel_reloads(res10_runs, tmp_path):
    from face_detection_and_recognition_tpu.train.caffe_golden import \
        export_trained_caffemodel as jax_export

    sd = res10_runs[0]["got"][-1][0]
    ours, theirs = str(tmp_path / "ours.caffemodel"), \
        str(tmp_path / "theirs.caffemodel")
    CG.export_trained_caffemodel(sd, ours)
    jax_export({k: v for k, v in CG.blobs_by_layer(sd).items()}, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    cfg = EngineConfig(detector="res10-ssd", det_thres=0.1)
    mem = FaceEngine(cfg, device="cpu")
    mem.load_state_dict(sd)
    eng = FaceEngine(cfg, device="cpu")
    eng.load_weights(ours)
    img = _golden_small()
    np.testing.assert_array_equal(eng.detect_raw(img), mem.detect_raw(img))


def test_export_trained_ir_reloads(ov_runs, tmp_path):
    from face_detection_and_recognition_tpu.models.ov_topologies import \
        export_trained_ir as jax_export
    from face_detection_and_recognition_tpu_torch.models.layers import \
        param_unkey
    from face_detection_and_recognition_tpu_torch.models.ov_topologies \
        import export_trained_ir

    sd = ov_runs["got"][-1][0]
    ours, theirs = str(tmp_path / "ours.xml"), str(tmp_path / "theirs.xml")
    export_trained_ir("ov-0204", sd, ours)
    jax_export("ov-0204", {param_unkey(k[len("consts."):]): v.numpy()
                           for k, v in sd.items()}, theirs)
    for a, b in ((ours, theirs), (ours[:-4] + ".bin", theirs[:-4] + ".bin")):
        assert open(a, "rb").read() == open(b, "rb").read()
    cfg = EngineConfig(detector="ov-0204", det_thres=0.1)
    mem = FaceEngine(cfg, device="cpu")
    mem.load_state_dict(sd)
    eng = FaceEngine(cfg, device="cpu")
    eng.load_weights(ours)
    img = _golden_small()
    np.testing.assert_array_equal(eng.detect_raw(img), mem.detect_raw(img))
    assert os.path.exists(ours[:-4] + ".bin")
