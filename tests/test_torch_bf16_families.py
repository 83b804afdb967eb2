"""bfloat16 for the BlazeFace, SSD, MTCNN, res10 and OpenVINO families
(``EngineConfig(dtype=torch.bfloat16)``) against the JAX package's bf16
nets on the same weights (CPU).

The JAX nets are compiled, and the port computes what XLA compiles (the
rounding points of each family's module, read from the optimized HLO):
every bf16 op rounded, a convolution with a bias rounded after its sums and
after the bias, but a result cast to f32 at once left unrounded (MTCNN's
heads, the sums of a softmax's ``exp``); the OpenVINO interpreter promotes
a bf16 tensor that meets an f32 constant to f32, as JAX does, so the
reference's IRs run in bf16 up to their first bias. What is left between
the two is the order of f32 sums, which now and then moves a bf16
rounding by one ulp. The tolerances, stated at each test:

- a layer on the input it had inside the jitted JAX net (captured with
  ``flax.linen.intercept_methods``; the port's layers run in flax's call
  order, so the n-th call of a kind is the n-th module of that kind): at
  least 99 % of its elements bit for bit and every element within 1 bf16
  ulp of its largest output (``_assert_close``); MTCNN's nets, whose
  heads come out as unrounded f32 sums of a bf16 term and the bias, the
  same within 1 bf16 ulp of the largest output and 99.9 % bit for bit;
  the graph interpreters, whose layers are not flax modules, on their
  heads only;
- a whole net's heads, where a flipped rounding compounds over 10-40
  layers: within 4 bf16 ulps of the largest head (``HEADS``); the
  OpenVINO IRs' heads, f32 from the first bias on, within 2e-5 of the
  largest;
- detections of the engines on the golden image and the negative one at
  thresholds 0.3, 0.5 and 0.7: the same counts, boxes within 1 px;
- the JAX package's own bf16 checks (``tests/test_mtcnn.py:132-150``,
  ``tests/test_caffe_ssd.py:385-395``) on the port, and the golden gates
  of BlazeFace and MTCNN through the bf16 engines, which the JAX bf16
  engines pass too (checked here).

The checkpoints are f32-cast, as in the f32 tests.
"""
import functools
import os

import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.models import blazeface as JB
from face_detection_and_recognition_tpu.models import mtcnn as JM
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.models import ssd as JS
from face_detection_and_recognition_tpu.models.res10 import \
    build_res10 as jbuild_res10
from face_detection_and_recognition_tpu.ops import preprocess as JP
from face_detection_and_recognition_tpu.ops.geometry import \
    resize_bilinear as jresize
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import layers as TL
from face_detection_and_recognition_tpu_torch.models import mtcnn as TM
from face_detection_and_recognition_tpu_torch.models.res10 import \
    build_res10
from face_detection_and_recognition_tpu_torch.ops.geometry import \
    resize_bilinear
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
BF = jnp.bfloat16
# a net's heads after 10-40 layers, where a flipped rounding compounds
HEADS = dict(min_equal=0.0, max_scale_ulp=4)
# registry name -> (checkpoint, bridge, detector overrides)
FAMILIES = {
    "blazeface-front": ("golden_blaze_ckpt",
                        lambda v: TW.blazeface_state_dict(v, False)),
    "blazeface-back": ("golden_blaze_back_ckpt",
                       lambda v: TW.blazeface_state_dict(v, True)),
    "ssd-resnet10": ("golden_ssd_ckpt",
                     lambda v: TW.ssd_state_dict(v, "resnet10")),
    "ssd-mobilenetv2": ("golden_ssd_mnv2_ckpt",
                        lambda v: TW.ssd_state_dict(v, "mobilenetv2")),
    "ssd-squeezenet": ("golden_ssd_sq_ckpt",
                       lambda v: TW.ssd_state_dict(v, "squeezenet")),
    "mtcnn": ("golden_mtcnn_ckpt", TW.mtcnn_state_dict),
    "res10-ssd": ("golden_res10_ckpt",
                  lambda v: TW.caffe_graph_state_dict(v["params"])),
    "ov-0204": ("golden_ov_0204_ckpt",
                lambda v: TW.ov_graph_state_dict(v["params"])),
    "ov-squeezenet-light": ("golden_ov_sq_ckpt",
                            lambda v: TW.ov_graph_state_dict(v["params"])),
}


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work (the tier-1 run
    puts several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _load(name):
    """A checkpoint's floats as f32 numpy."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def frames():
    """The golden image and the negative one at the golden image's size,
    as ``evaluate_golden`` feeds them."""
    pos = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    neg = cv2.imread(os.path.join(DATA, "test1_faces_0.jpg"))
    return pos, cv2.resize(neg, (pos.shape[1], pos.shape[0]))


def _ordered(a: np.ndarray) -> np.ndarray:
    """bf16 bit patterns of an f32 array's bf16 values, mapped to integers
    in value order, so that a difference counts ulps."""
    i = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).int().numpy()
    return np.where(i < 0, -32768 - i, i)


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def _assert_close(got, ref, min_equal=0.99, max_scale_ulp=1):
    """got / ref: f32 arrays of bf16 values: at least ``min_equal`` of the
    elements bit for bit, every difference within ``max_scale_ulp`` bf16
    ulps of max|ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    equal = (_ordered(got) == _ordered(ref)).mean()
    assert equal >= min_equal, equal
    scale = _ulp(np.abs(ref).max())
    assert np.abs(got - ref).max() <= max_scale_ulp * scale, \
        np.abs(got - ref).max() / scale


def _capture(net, tree, x, kinds):
    """The (input, output) of every call of a flax module whose type name
    is in ``kinds``, in call order, inside the one compiled JAX program:
    [(type name, input, output)] as f32 numpy."""
    meta = []

    def run(tree, x):
        caps = []

        def icpt(next_fn, args, kwargs, ctx):
            out = next_fn(*args, **kwargs)
            name = type(ctx.module).__name__
            if ctx.method_name == "__call__" and name in kinds:
                caps.append((name, args[0], out))
            return out

        with fnn.intercept_methods(icpt):
            y = net.apply(tree, x)
        meta[:] = [c[0] for c in caps]
        return y, [c[1:] for c in caps]

    _, io = jax.jit(run)(tree, x)
    return [(m, np.asarray(i.astype(jnp.float32)),
             np.asarray(o.astype(jnp.float32))) for m, (i, o) in zip(meta, io)]


def _nchw(a) -> torch.Tensor:
    """An NHWC f32 array of bf16 values -> a bf16 NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _port_engine(name, **kw):
    ckpt, bridge = FAMILIES[name]
    eng = FaceEngine(EngineConfig(detector=name, det_thres=0.5,
                                  dtype="bfloat16", **kw), device="cpu")
    eng.load_state_dict(bridge(_load(ckpt)))
    return eng


@functools.lru_cache(maxsize=None)
def _jax_engine(name):
    """The JAX bf16 engine of ``name`` on its golden checkpoint (the
    interpreters take the checkpoint's ``params``)."""
    eng = JFaceEngine(JEngineConfig(detector=name, det_thres=0.5, dtype=BF))
    v = _load(FAMILIES[name][0])
    eng.variables = v["params"] if name.startswith(("res10", "ov-")) else v
    return eng


# ---------------- layers ----------------


def _mtcnn_pair():
    v = _load("golden_mtcnn_ckpt")
    port = TM.MTCNN()
    port.load_state_dict(TW.mtcnn_state_dict(v))
    return v, TL.set_compute_dtype(port.eval(), torch.bfloat16)


def test_mtcnn_pyramid_and_nets_match_jax_bf16(frames):
    """A pyramid level of the golden image resampled in bf16 (bit for bit),
    P-Net on it, and R-Net and O-Net on crops of the normalized frame, each
    on JAX's own bf16 input: every output within 1 bf16 ulp of its own
    size, at least 99.9 % bit for bit."""
    v, port = _mtcnn_pair()
    img = frames[0]
    h, w = img.shape[:2]
    norm = (img.astype(np.float32)[..., ::-1] - 127.5) * 0.0078125
    scale = JM.pyramid_scales(h, w, 40, 0.7)[2]
    hw = (int(np.ceil(h * scale)), int(np.ceil(w * scale)))
    level = jax.jit(lambda x: jresize(x, hw, dtype=BF))(jnp.asarray(norm))
    got = resize_bilinear(torch.from_numpy(norm.copy())[None], hw,
                          dtype=torch.bfloat16)[0]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(level.astype(jnp.float32)))
    rng = np.random.RandomState(5)
    inputs = {"pnet": level[None],
              "rnet": jnp.asarray(rng.uniform(-1, 1, (16, 24, 24, 3))
                                  .astype(np.float32)).astype(BF),
              "onet": jnp.asarray(rng.uniform(-1, 1, (16, 48, 48, 3))
                                  .astype(np.float32)).astype(BF)}
    nets = {"pnet": JM.PNet(dtype=BF), "rnet": JM.RNet(dtype=BF),
            "onet": JM.ONet(dtype=BF)}
    for stage, x in inputs.items():
        ref = jax.jit(nets[stage].apply)(v[stage], x)
        xt = torch.from_numpy(np.asarray(x.astype(jnp.float32)))
        with torch.no_grad():
            out = getattr(port, stage)(xt.permute(0, 3, 1, 2))
        for r, g in zip(ref, out):
            r = np.asarray(r)
            g = (g.permute(0, 2, 3, 1) if g.dim() == 4 else g).numpy()
            assert g.dtype == r.dtype == np.float32
            assert np.abs(g - r).max() <= _ulp(np.abs(r).max()), stage
            assert (g == r).mean() >= 0.999, (stage, (g == r).mean())


SSD_SIDES = {"resnet10": 300, "mobilenetv2": 448, "squeezenet": 300}


@pytest.mark.parametrize("backbone", list(SSD_SIDES))
def test_ssd_convbns_and_heads_match_jax_bf16(backbone, frames):
    """Each ConvBN of the trunk (golden weights, the golden image
    letterboxed by the JAX engine's preprocess) on the input it had in the
    jitted JAX bf16 net, and the net's heads on the same input."""
    name = f"ssd-{backbone}"
    v = _load(FAMILIES[name][0])
    side = SSD_SIDES[backbone]
    net = JS.SSDFaceNet(cfg=JS.SSDConfig(backbone=backbone,
                                         input_size=(side, side)), dtype=BF)
    x = _jax_preprocess(name, frames[0])
    calls = _capture(net, v, x, {"ConvBN"})
    port = _port_engine(name).net
    convbns = [m for m in port.modules() if isinstance(m, TL.ConvBN)]
    assert len(convbns) == len(calls)
    with torch.no_grad():
        for m, (_, i, o) in zip(convbns, calls):
            _assert_close(_nhwc(m(_nchw(i))), o)
        heads = port(torch.from_numpy(np.asarray(x.astype(jnp.float32))))
    for g, r in zip(heads, jax.jit(net.apply)(v, x)):
        _assert_close(g.numpy(), np.asarray(r), **HEADS)


def _jax_preprocess(name, img):
    """The JAX bf16 engine's preprocess of one frame for the detector
    ``name``: [1, h, w, 3] bf16."""
    return JP.apply_preprocess_batch(jnp.asarray(img[None]),
                                     JR.get(name).preprocess, BF)


@pytest.mark.parametrize("back", [False, True], ids=["front", "back"])
def test_blaze_blocks_and_heads_match_jax_bf16(back, frames):
    """Each BlazeBlock (and the back net's final block) on the input it had
    in the jitted JAX bf16 net, and the heads on the same input."""
    name = "blazeface-back" if back else "blazeface-front"
    v = _load(FAMILIES[name][0])
    net = JB.BlazeFaceNet(back_model=back, dtype=BF)
    x = _jax_preprocess(name, frames[0])
    calls = _capture(net, v, x, {"BlazeBlock", "FinalBlazeBlock"})
    port = _port_engine(name).net
    blocks = [m for m in port.modules()
              if isinstance(m, (TL.BlazeBlock, TL.FinalBlazeBlock))]
    assert [type(m).__name__ for m in blocks] == [c[0] for c in calls]
    with torch.no_grad():
        for m, (_, i, o) in zip(blocks, calls):
            _assert_close(_nhwc(m(_nchw(i))), o)
        heads = port(torch.from_numpy(np.asarray(x.astype(jnp.float32))))
    for g, r in zip(heads, jax.jit(net.apply)(v, x)):
        _assert_close(g.numpy(), np.asarray(r), **HEADS)


@pytest.mark.parametrize("name", ["res10-ssd", "ov-0204",
                                  "ov-squeezenet-light"])
def test_graph_heads_match_jax_bf16(name, frames):
    """The interpreters' heads on the golden image as the JAX bf16 engine
    preprocesses it: res10 runs in bf16 throughout; the OpenVINO IRs in
    bf16 up to their first bias, f32 after (JAX's promotion)."""
    jeng = _jax_engine(name)
    x = _jax_preprocess(name, frames[0])
    port = _port_engine(name).net
    if name == "res10-ssd":
        ref = jeng.net.apply(jeng.variables, x)["detection_out"]
    else:
        ref = jeng.net.apply(jeng.variables, x)[jeng.net.outputs[0]]
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(x.astype(jnp.float32))))
    for g, r in zip(got, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert str(g.dtype).endswith("bfloat16" if name == "res10-ssd"
                                     else "float32")
        g = g.float().numpy()
        if name == "res10-ssd":
            _assert_close(g, r, **HEADS)
        else:  # f32 from the first bias on: f32 sums in another order
            np.testing.assert_allclose(g, r, atol=2e-5 * np.abs(r).max(),
                                       rtol=0)


def test_res10_build_respects_dtype():
    """tests/test_caffe_ssd.py:385-395 on the port: ``build_res10(dtype=
    bf16)`` runs the graph in bf16 (bf16 heads) and its decode stays f32;
    its heads equal the JAX bf16 graph's on the same weights."""
    net, decode = build_res10(torch.Generator().manual_seed(0),
                              torch.device("cpu"), torch.bfloat16)
    x = np.random.RandomState(42).randn(1, 300, 300, 3).astype(np.float32)
    with torch.no_grad():
        loc, conf = net(torch.from_numpy(x))
        dets, valid = decode((loc, conf), (300, 300))
    assert loc.dtype == conf.dtype == torch.bfloat16
    assert dets.dtype == torch.float32
    assert np.isfinite(dets.numpy()).all()
    jnet, _, _ = jbuild_res10(dtype=BF)
    weights = {name: [t.detach().numpy() for t in blobs]
               for name, blobs in _res10_blobs(net).items()}
    jloc, jconf = jnet.apply(weights, jnp.asarray(x).astype(BF))[
        "detection_out"]
    assert jloc.dtype == BF
    _assert_close(loc.float().numpy(), np.asarray(jloc.astype(jnp.float32)),
                  **HEADS)
    _assert_close(conf.float().numpy(),
                  np.asarray(jconf.astype(jnp.float32)), **HEADS)


def _res10_blobs(net):
    """{layer name: [blobs]} of a port res10 net."""
    return {name: net.layer_blobs(name) for name in net.blob_layers()}
