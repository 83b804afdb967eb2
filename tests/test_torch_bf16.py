"""The port's bfloat16 engines (``EngineConfig(dtype=torch.bfloat16)``)
against the JAX package's bf16 engines (CPU).

The JAX layers are compiled with ``jax.jit``, and the port computes what
XLA compiles (``models/layers.py`` sets out the rounding points, read from
the optimized HLO): a convolution's f32 sums go into its BatchNorm
unrounded, the BatchNorm rounds once, SiLU rounds each of its four ops, a
convolution with a bias rounds its sums and then the sum with the bias.
What is left between the two is the order of f32 sums and the platforms'
``exp`` / ``rsqrt`` (an f32 ulp that now and then moves a bf16 rounding).
So a single layer on JAX's own bf16 input agrees element by element to
the bf16 ulps stated at each test, nearly every element bit for bit, and a
block of several layers compounds those ulps, which the block tests bound
in ulps of the block's largest output. The checkpoints are f32-cast, as in
the f32 tests (``golden_embed_ckpt`` and ``golden_ag_ckpt`` are stored in
bf16). The tolerances are stated at each test.
"""
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
from face_detection_and_recognition_tpu.models import age_gender as JAG
from face_detection_and_recognition_tpu.models import layers as JL
from face_detection_and_recognition_tpu.models import yolov5_face as JY
from face_detection_and_recognition_tpu.models.facenet import \
    InceptionResNetV1 as JFaceNet
from face_detection_and_recognition_tpu.models.mobile_facenet import \
    MobileFaceNet as JMobileFaceNet
from face_detection_and_recognition_tpu.ops import crop as JC
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils import quantize as JQ
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import age_gender as TAG
from face_detection_and_recognition_tpu_torch.models import layers as TL
from face_detection_and_recognition_tpu_torch.models import yolov5_face as TY
from face_detection_and_recognition_tpu_torch.models.facenet import \
    InceptionResNetV1
from face_detection_and_recognition_tpu_torch.models.mobile_facenet import \
    MobileFaceNet
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
BF = jnp.bfloat16
AG_MEAN = (78.4263377603, 87.7689143744, 114.895847746)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work (the Tier-1 run
    puts several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(name):
    """A checkpoint's floats as f32 numpy (int8 codes stay int8)."""
    def cast(a):
        a = np.asarray(a)
        return a if a.dtype == np.int8 else a.astype(np.float32)
    return jax.tree_util.tree_map(cast,
                                  load_variables(os.path.join(DATA, name)))


def _frames(w, h):
    """The golden image and the negative one, resized to w x h: RGB in
    [0, 1], bf16 (the JAX bf16 engine's preprocess dtype)."""
    f = np.stack([cv2.resize(cv2.imread(os.path.join(DATA, n)), (w, h))
                  for n in ("test2_faces_3.jpg", "test1_faces_0.jpg")])
    return jnp.asarray((f[..., ::-1] / 255.0).astype(np.float32)).astype(BF)


def _ordered(a: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (of f32 values rounded to bf16) mapped to integers
    in value order, so that a difference counts ulps."""
    i = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).int().numpy()
    return np.where(i < 0, -32768 - i, i)


def _assert_bf16_close(got, ref, max_ulp=None, max_scale_ulp=None,
                       min_equal=0.999):
    """got / ref: f32 arrays holding bf16 values. ``max_ulp``: every
    element within that many bf16 ulps of its own; ``max_scale_ulp``:
    every difference within that many bf16 ulps of max|ref| (where a block
    compounds a flipped rounding into a value near zero); ``min_equal``:
    the share of elements equal bit for bit."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    ulps = np.abs(_ordered(got) - _ordered(ref))
    assert (ulps == 0).mean() >= min_equal, (ulps == 0).mean()
    if max_ulp is not None:
        assert ulps.max() <= max_ulp, ulps.max()
    if max_scale_ulp is not None:
        scale = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        assert np.abs(got - ref).max() <= max_scale_ulp * scale, \
            np.abs(got - ref).max() / scale


def _capture(net, tree, x, keep):
    """The jitted JAX net's output and the (input, output) of every
    submodule call that ``keep(path, module)`` selects, captured inside the
    one compiled program: (out, [(path, type name, in, out)]) as f32."""
    meta = []

    def run(tree, x):
        caps = []

        def icpt(next_fn, args, kwargs, ctx):
            out = next_fn(*args, **kwargs)
            path = tuple(ctx.module.path)
            if ctx.method_name == "__call__" and keep(path, ctx.module):
                caps.append((path, type(ctx.module).__name__, args[0],
                             out))
            return out

        with fnn.intercept_methods(icpt):
            y = net.apply(tree, x)
        meta[:] = [c[:2] for c in caps]
        return y, [c[2:] for c in caps]

    y, io = jax.jit(run)(tree, x)
    f32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a.astype(jnp.float32)), t)
    return f32(y), [m + f32(t) for m, t in zip(meta, io)]


def _nchw(a) -> torch.Tensor:
    """An NHWC f32 array of bf16 values -> a bf16 NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


# ---------------- single layers ----------------


CONVBN = [  # (c_in, c_out, k, stride, groups, act)
    pytest.param(16, 32, 3, 2, 1, "silu", id="k3-s2"),
    pytest.param(24, 40, 1, 1, 1, "silu", id="k1"),
    pytest.param(3, 16, 3, 2, 1, "silu", id="stem-c3"),
    pytest.param(24, 24, 3, 1, 24, None, id="depthwise-linear"),
    pytest.param(32, 48, 3, 1, 1, "relu6", id="relu6"),
]


@pytest.mark.parametrize("c_in,c_out,k,stride,groups,act", CONVBN)
def test_convbn_matches_jax_bf16(c_in, c_out, k, stride, groups, act):
    """The port's ConvBN on a bf16 input against the jitted JAX
    ``ConvBN(dtype=bf16)`` with the same f32 weights and running
    statistics: every element within 2 bf16 ulps (an f32 ulp of the sums
    or of rsqrt can move the BatchNorm's rounding by one, which SiLU's
    four roundings may carry to two), 99.9 % equal bit for bit."""
    rng = np.random.RandomState(c_in * 7 + k)
    x = jnp.asarray(rng.uniform(-3, 3, (2, 20, 18, c_in))
                    .astype(np.float32)).astype(BF)
    jact = {"silu": jax.nn.silu, "relu6": jax.nn.relu6, None: None}[act]
    m = JL.ConvBN(c_out, k, stride, groups=groups, act=jact, dtype=BF)
    v = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(k), x))
    v["batch_stats"]["BatchNorm_0"]["mean"] = \
        rng.uniform(-0.5, 0.5, c_out).astype(np.float32)
    v["batch_stats"]["BatchNorm_0"]["var"] = \
        rng.uniform(0.3, 2.0, c_out).astype(np.float32)
    v["params"]["BatchNorm_0"]["scale"] = \
        rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    v["params"]["BatchNorm_0"]["bias"] = \
        rng.uniform(-0.5, 0.5, c_out).astype(np.float32)
    ref = np.asarray(jax.jit(m.apply)(v, x).astype(jnp.float32))
    t = TL.ConvBN(c_in, c_out, k, stride, None, groups, act).eval()
    sd = {"conv.weight": TW.f2t_conv(v["params"]["Conv_0"]["kernel"])}
    TW._bn(sd, "bn", v["params"]["BatchNorm_0"],
           v["batch_stats"]["BatchNorm_0"])
    t.load_state_dict(sd)
    with torch.no_grad():
        got = t(_nchw(np.asarray(x.astype(jnp.float32))))
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(_nhwc(got), ref, max_ulp=2)


def test_silu_and_lrn_forms_match_jax_bf16():
    """The elementwise forms on every bf16 value in [-40, 40] whose SiLU is
    a normal number (XLA flushes subnormals to zero on the CPU, PyTorch
    keeps them; 0 included): the port's
    SiLU equals the jitted ``jax.nn.silu`` on bf16 bit for bit but where
    the platforms' f32 exp differ by an ulp (at most 0.1 % of the values,
    1 bf16 ulp); the LRN of the CaffeNet heads likewise on a seeded
    tensor."""
    allv = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    a = allv.float().abs()
    allv = allv[torch.isfinite(allv) & (a < 40)
                & ((a == 0) | (a >= 2.0 ** -120))]
    ref = np.asarray(jax.jit(jax.nn.silu)(
        jnp.asarray(allv.float().numpy()).astype(BF)).astype(jnp.float32))
    _assert_bf16_close(TL.silu_bf16(allv).float().numpy(), ref, max_ulp=1)
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.uniform(0, 60, (2, 7, 9, 96))
                    .astype(np.float32)).astype(BF)
    ref = np.asarray(jax.jit(JAG._lrn)(x).astype(jnp.float32))
    got = TAG._lrn(_nchw(np.asarray(x.astype(jnp.float32))))
    _assert_bf16_close(_nhwc(got), ref, max_ulp=1)


# ---------------- the yolov5 blocks inside the jitted nets ----------------


@pytest.fixture(scope="module")
def yolov5_io():
    """{arch: (maps, captures)}: the jitted JAX bf16 net's maps and each
    graph layer's (and Detect conv's) input and output, on the golden
    frames: yolov5n at 320 x 320, yolov5s (its SPP and shortcut C3s) at
    128 x 128, golden weights."""
    out = {}
    for arch, side in (("yolov5n", 320), ("yolov5s", 128)):
        v = _load(f"golden_{arch}_ckpt")
        net = JY.YoloV5FaceNet(arch=arch, dtype=BF)
        maps, io = _capture(net, v, _frames(side, side),
                            lambda p, m: len(p) == 1)
        port = TY.YoloV5FaceNet(arch).eval()
        port.load_state_dict(TW.yolov5_face_state_dict(v, arch))
        port = port.to(memory_format=torch.channels_last)
        out[arch] = (maps, io, TL.set_compute_dtype(port, torch.bfloat16))
    return out


def _port_layer(port, name):
    """The port module of a flax graph-layer name ('layer4_3', 'layer10',
    'detect_m0')."""
    if name.startswith("detect_m"):
        conv = port.model[-1].m[int(name[8:])]
        return lambda x: TL.conv_bias_bf16(conv, x)
    idx, _, rep = name[5:].partition("_")
    m = port.model[int(idx)]
    return m[int(rep)] if rep and isinstance(m, torch.nn.Sequential) else m


BLOCKS = [  # (arch, flax type, share of elements equal bit for bit)
    pytest.param("yolov5n", "StemBlock", 0.999, id="yolov5n-StemBlock"),
    pytest.param("yolov5n", "ShuffleV2Block", 0.999, id="yolov5n-ShuffleV2"),
    pytest.param("yolov5n", "ConvBN", 0.999, id="yolov5n-ConvBN"),
    pytest.param("yolov5n", "C3", 0.999, id="yolov5n-C3"),
    pytest.param("yolov5n", "Conv", 0.999, id="yolov5n-Detect"),
    pytest.param("yolov5s", "ConvBN", 0.999, id="yolov5s-ConvBN"),
    pytest.param("yolov5s", "C3", 0.95, id="yolov5s-C3-shortcut"),
    pytest.param("yolov5s", "SPP", 0.999, id="yolov5s-SPP"),
    pytest.param("yolov5s", "Conv", 0.999, id="yolov5s-Detect"),
]


@pytest.mark.parametrize("arch,kind,min_equal", BLOCKS)
def test_yolov5_blocks_match_jax_bf16(yolov5_io, arch, kind, min_equal):
    """Each graph layer of the kind, run by the port on the input that
    layer had inside the jitted JAX bf16 net: every difference within 2
    bf16 ulps of the layer's largest output, and 99.9 % of the elements
    equal bit for bit (95 % in yolov5s's C3s, whose three chained
    shortcut Bottlenecks carry a flipped rounding down the residual sum).
    A block chains several ConvBNs, so a rounding that one moves reaches
    values near zero as many of their own ulps; a single ConvBN holds each
    element within 2 ulps. The Detect convolutions add their bias after
    rounding their sums, so an element near zero can be many of its own
    ulps off while it stays within 2 of the layer's largest."""
    _, io, port = yolov5_io[arch]
    layers = [c for c in io if c[1] == kind]
    assert layers
    with torch.no_grad():
        for path, _, x, ref in layers:
            got = _port_layer(port, path[0])(_nchw(x))
            assert got.dtype == torch.bfloat16, path
            _assert_bf16_close(_nhwc(got), ref, max_scale_ulp=2,
                               min_equal=min_equal)
            if kind == "ConvBN":
                _assert_bf16_close(_nhwc(got), ref, max_ulp=2)


@pytest.mark.parametrize("hw", [(320, 320), (256, 320)], ids=["320x320",
                                                              "320x256"])
def test_detect_maps_on_jax_bf16_maps(yolov5_io, hw):
    """``yolov5_face_detect_maps`` on the JAX bf16 net's own bf16 maps of
    yolov5n (golden weights, the golden frames; 320 x 320 and 320 wide by
    256 high) against the JAX candidates-first path with
    ``rows_bf16_exact`` (its bf16 route): the same valid mask and kept
    rows bit for bit, every value within 1e-6 relative (the platforms'
    f32 exp differ by an ulp on 11 of the 33,856 bf16 values in [-40, 40],
    which moves a sigmoid by an f32 ulp), at two thresholds."""
    h, w = hw
    v = _load("golden_yolov5n_ckpt")
    if hw == (320, 320):
        maps = yolov5_io["yolov5n"][0]
    else:
        net = JY.YoloV5FaceNet(arch="yolov5n", dtype=BF)
        maps = jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)),
            jax.jit(net.apply)(v, _frames(w, h)))
    jmaps = [jnp.asarray(m).astype(BF) for m in maps]
    tmaps = [torch.from_numpy(m).to(torch.bfloat16) for m in maps]
    for conf in (0.4, 0.02):
        kw = dict(input_size=(w, h), conf_thres=conf)
        rd, rv = jax.jit(lambda m: JY.yolov5_face_detect_maps(
            m, JY.FACE_ANCHORS, (8, 16, 32), JY.YoloV5FaceConfig(**kw),
            rows_bf16_exact=True))(jmaps)
        rd, rv = np.asarray(rd), np.asarray(rv)
        gd, gv = TY.yolov5_face_detect_maps(
            tmaps, TY.FACE_ANCHORS, (8, 16, 32), TY.YoloV5FaceConfig(**kw))
        np.testing.assert_array_equal(gv.numpy(), rv)
        assert rv.sum() >= 1
        np.testing.assert_allclose(gd.numpy()[rv], rd[rv], rtol=1e-6,
                                   atol=0)


# ---------------- the embedders' and heads' layers ----------------


def test_mobile_facenet_blocks_match_jax_bf16():
    """MobileFaceNet (golden weights): each conv block (MFConvBlock,
    MFLinearBlock) on its input inside the jitted JAX bf16 net within 1
    bf16 ulp element by element, each depthwise unit (MFDepthWise) 99.9 %
    bit for bit and within 1 ulp of its largest output; the embeddings of
    the whole net within cosine 0.9999 of JAX's."""
    v = _load("golden_embed_ckpt")
    x = jnp.asarray(np.random.RandomState(11).uniform(-1, 1, (4, 112, 112, 3))
                    .astype(np.float32))
    kinds = ("MFConvBlock", "MFLinearBlock", "MFDepthWise")
    y, io = _capture(JMobileFaceNet(dtype=BF), v, x,
                     lambda p, m: type(m).__name__ in kinds)
    port = MobileFaceNet().eval()
    port.load_state_dict(TW.mobile_facenet_state_dict(v))
    port = TL.set_compute_dtype(port.to(memory_format=torch.channels_last),
                                torch.bfloat16)
    sub = {"MFConvBlock_0": "conv", "MFConvBlock_1": "conv_dw",
           "MFLinearBlock_0": "project"}
    seen = set()
    with torch.no_grad():
        for path, kind, xi, ref in io:
            m = getattr(port, path[0])
            for p in path[1:]:
                m = (m.model[int(p.split("_")[1])] if p.startswith(
                    "MFDepthWise") else getattr(m, sub[p]))
            got = _nhwc(m(_nchw(xi)))
            if kind == "MFDepthWise":
                _assert_bf16_close(got, ref, max_scale_ulp=1)
            else:
                _assert_bf16_close(got, ref, max_ulp=1)
            seen.add(kind)
        emb = port(torch.from_numpy(np.asarray(x))).numpy()
    assert seen == set(kinds) and len(io) > 60
    assert emb.dtype == np.float32
    assert ((emb * y).sum(-1) >= 0.9999).all(), (emb * y).sum(-1)


def _facenet_module(port, name):
    """The port module of a top-level flax FaceNet name: the stem CB_0..5,
    reduction-A CB_6..9, reduction-B CB_10..16, the blocks."""
    kind, i = name.rsplit("_", 1)
    i = int(i)
    if kind == "Block35":
        return port.repeat_1[i]
    if kind == "Block17":
        return port.repeat_2[i]
    if kind == "Block8":
        return port.repeat_3[i] if i < 5 else port.block8
    a, b = port.mixed_6a, port.mixed_7a
    return [port.conv2d_1a, port.conv2d_2a, port.conv2d_2b, port.conv2d_3b,
            port.conv2d_4a, port.conv2d_4b, a.branch0, a.branch1[0],
            a.branch1[1], a.branch1[2], b.branch0[0], b.branch0[1],
            b.branch1[0], b.branch1[1], b.branch2[0], b.branch2[1],
            b.branch2[2]][i]


def test_facenet_blocks_match_jax_bf16():
    """FaceNet (Inception-ResNet-V1, seeded weights and BatchNorm
    statistics, 2 x 80 x 80: the smallest input its VALID reductions
    take): each conv block (CB) on its input inside the jitted JAX bf16
    net within 2 bf16 ulps element by element, each residual block
    (Block35 / 17 / 8: four to six convolutions, the scaled up-projection
    and the residual sum) 99 % bit for bit and within 2 ulps of its
    largest output; the embeddings within cosine 0.9999 of JAX's."""
    rng = np.random.RandomState(12)
    net = JFaceNet(dtype=BF)
    x = jnp.asarray(rng.randn(2, 80, 80, 3).astype(np.float32))
    v = jax.tree_util.tree_map(np.asarray, jax.jit(net.init)(
        jax.random.PRNGKey(0), x))

    def stats(d):
        for sub in d.values():
            if isinstance(sub, dict):
                stats(sub)
        if "var" in d:
            d["var"] = rng.uniform(0.5, 2, d["var"].shape).astype(np.float32)
            d["mean"] = rng.uniform(-0.2, 0.2, d["mean"].shape).astype(
                np.float32)

    stats(v["batch_stats"])
    y, io = _capture(net, v, x, lambda p, m: len(p) == 1 and type(
        m).__name__ in ("CB", "Block35", "Block17", "Block8"))
    port = InceptionResNetV1().eval()
    port.load_state_dict(TW.facenet_state_dict(v))
    port = TL.set_compute_dtype(port.to(memory_format=torch.channels_last),
                                torch.bfloat16)
    with torch.no_grad():
        for path, kind, xi, ref in io:
            got = _nhwc(_facenet_module(port, path[0])(_nchw(xi)))
            if kind == "CB":
                _assert_bf16_close(got, ref, max_ulp=2)
            else:
                _assert_bf16_close(got, ref, max_scale_ulp=2, min_equal=0.99)
        emb = port(torch.from_numpy(np.asarray(x))).numpy()
    assert len(io) == 17 + 5 + 10 + 6
    assert ((emb * y).sum(-1) >= 0.9999).all(), (emb * y).sum(-1)


def test_caffenet_layers_match_jax_bf16():
    """Both heads (golden weights): each convolution and Dense layer (its
    sums rounded, then its bias added and rounded) on its input inside the
    jitted JAX bf16 head, 99.99 % of the elements bit for bit and every
    difference within 1 bf16 ulp of the layer's largest output (an
    element where the bias cancels the sums can be more of its own ulps
    off); the bf16 logits, widened to f32, each within 1 bf16 ulp and 80 %
    of them bit for bit."""
    ag = _load("golden_ag_ckpt")
    x = jnp.asarray((np.random.RandomState(13).uniform(0, 255, (3, 227, 227,
                                                                3))
                     - 100.0).astype(np.float32))
    heads = TAG.AgeGenderNet().eval()
    heads.load_state_dict(TW.age_gender_state_dict(ag["age"], ag["gender"]))
    heads = TL.set_compute_dtype(
        heads.to(memory_format=torch.channels_last), torch.bfloat16)
    for name, port in (("age", heads.age), ("gender", heads.gender)):
        y, io = _capture(JAG.CaffeNetHead(len(getattr(TAG, {
            "age": "AGE_BUCKETS", "gender": "GENDERS"}[name])), dtype=BF),
            ag[name], x, lambda p, m: len(p) == 1 and type(
                m).__name__ in ("Conv", "Dense"))
        layers = {"Conv_0": port.conv1, "Conv_1": port.conv2,
                  "Conv_2": port.conv3, "Dense_0": port.fc6,
                  "Dense_1": port.fc7, "Dense_2": port.fc8}
        with torch.no_grad():
            for path, kind, xi, ref in io:
                mod = layers[path[0]]
                if kind == "Conv":
                    got = _nhwc(TL.conv_bias_bf16(mod, _nchw(xi)))
                else:
                    if path[0] == "Dense_0":  # flax flattens (H, W, C)
                        xi = xi.reshape(-1, 7, 7, 384).transpose(
                            0, 3, 1, 2).reshape(len(xi), -1)
                    got = TL.linear_bias_bf16(mod, torch.from_numpy(
                        np.ascontiguousarray(xi))).float().numpy()
                _assert_bf16_close(got, ref, max_scale_ulp=1,
                                   min_equal=0.9999)
            logits = port(_nchw(np.asarray(x.astype(BF).astype(
                jnp.float32))))
        assert logits.dtype == torch.float32 and len(io) == 6
        _assert_bf16_close(logits.numpy(), y, max_ulp=1, min_equal=0.8)


# ---------------- B3's bf16 store ----------------


def test_b3_bf16_store_matches_jax_rounding():
    """B3's plain version with ``out_dtype`` bfloat16 is the JAX bf16
    ensemble's age/gender input: the clipped crop ``astype(bf16)``, then
    ``astype(f32) - mean``, ``astype(bf16)`` (jitted), bit for bit on the
    same f32 crop, for uint8 and f32 frames, with the mean and without;
    invalid slots hold bf16(-mean). Against the JAX package's own gather
    crop the bf16 crops agree 99 % bit for bit and within 2 bf16 ulps of
    the largest (its f32 crop sums its products in another order, within
    1e-3, which can move the first rounding by an ulp of up to 1.0; less
    the mean, that is many ulps of a result near zero)."""
    rng = np.random.RandomState(14)
    frames = rng.randint(0, 256, (2, 60, 80, 3)).astype(np.uint8)
    xy = rng.uniform(-10, 70, (2, 9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 50, (2, 9, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(2, 9) > 0.2
    valid[:, 0] = False
    jround = jax.jit(lambda c, m: (jnp.clip(c, 0.0, 255.0).astype(BF)
                                   .astype(jnp.float32) - m).astype(BF))
    for fr in (frames, frames.astype(np.float32) * 1.1 - 10.0):
        args = (torch.from_numpy(fr), torch.from_numpy(boxes),
                torch.from_numpy(valid), (227, 227))
        f32 = ck.crop_resize_plain(*args, clamp=True, clip=True)
        for mean in (AG_MEAN, None):
            got = ck.crop_resize_plain(*args, clamp=True, clip=True,
                                       mean=mean, out_dtype=torch.bfloat16)
            assert got.dtype == torch.bfloat16
            m = jnp.asarray(mean if mean else (0.0, 0.0, 0.0), jnp.float32)
            ref = np.asarray(jround(jnp.asarray(f32.numpy()), m)
                             .astype(jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), ref)
            if mean:
                inv = got[~torch.from_numpy(valid)].float()
                assert (inv == torch.tensor(mean).to(torch.bfloat16)
                        .float().neg()).all()
        if fr.dtype == np.uint8:
            for b in range(2):
                jcrop = JC.crop_and_resize(
                    jnp.asarray(fr[b]), jnp.asarray(boxes[b]), (227, 227),
                    jnp.asarray(valid[b]), method="gather")
                ref = np.asarray(jround(jcrop, jnp.asarray(AG_MEAN))
                                 .astype(jnp.float32))
                got = ck.crop_resize_plain(
                    *args, clamp=True, clip=True, mean=AG_MEAN,
                    out_dtype=torch.bfloat16)[b].float().numpy()
                _assert_bf16_close(got, ref, max_scale_ulp=2, min_equal=0.99)


# ---------------- the engines ----------------


@pytest.fixture(scope="module")
def golden():
    ag = _load("golden_ag_ckpt")
    return {"det": _load("golden_yolov5s_ckpt"),
            "embed": _load("golden_embed_ckpt"),
            "age": ag["age"], "gender": ag["gender"]}


@pytest.fixture(scope="module")
def engines(golden):
    """(JAX, port) bf16 engines: yolov5s + mobile_facenet + age/gender,
    golden weights on both."""
    kw = dict(detector="yolov5s", embedder="mobile_facenet",
              with_age_gender=True, max_det=16)
    jeng = JFaceEngine(JEngineConfig(dtype=BF, **kw))
    jeng.variables = golden["det"]
    jeng.embed_vars = golden["embed"]
    jeng.ag_vars = (golden["age"], golden["gender"])
    teng = FaceEngine(EngineConfig(dtype=torch.bfloat16, **kw), device="cpu")
    teng.load_state_dict(TW.yolov5_face_state_dict(golden["det"], "yolov5s"))
    teng.load_embed_state_dict(TW.mobile_facenet_state_dict(golden["embed"]))
    teng.load_age_gender_state_dict(TW.age_gender_state_dict(
        golden["age"], golden["gender"]))
    return jeng, teng


def test_bf16_engine_passes_golden_gate(engines):
    """The golden gate of tests/test_golden_accuracy.py, unchanged,
    through the port's bf16 engine (3 faces at IoU >= 0.8, none on the
    negative image), and the net's heads bf16. Its boxes, landmarks and
    scores against the JAX bf16 engine's: ``test_bf16_ensemble_matches_jax``
    (the same engines and image)."""
    teng = engines[1]
    r = evaluate_golden(teng, det_thres=0.6, margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]
    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    with torch.inference_mode():
        frames = torch.from_numpy(img[None]).contiguous()
        maps = teng._network(teng._preprocess(frames))
    assert all(m.dtype == torch.bfloat16 for m in maps)


def test_bf16_ensemble_matches_jax(engines):
    """The fused bf16 ensemble on the golden image: the same valid slots,
    boxes and landmarks within 1 px (rounded pixels: a sub-ulp difference
    can flip a .5) and scores within 1e-3 of the JAX bf16 engine's,
    embeddings within cosine 0.9999 (a row whose box floors to another
    pixel than JAX's is held to the JAX nets on the port's box, as the f32
    test does), the same age and gender labels, f32 outputs; and the
    staged entry points (``embed_crops``, ``classify_crops_age_gender``)
    against the JAX engine's, and ``detect_age_gender``'s genders against
    the JAX ensemble's."""
    jeng, teng = engines
    img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
    h, w = img.shape[:2]
    ref = jeng.detect_embed_classify_batch(img[None], det_thres=0.3)
    got = teng.detect_embed_classify_batch(img[None], det_thres=0.3)
    valid = np.asarray(ref.det.valid)[0]
    np.testing.assert_array_equal(got.det.valid.numpy()[0], valid)
    assert valid.sum() == 3
    for t in (got.det.boxes, got.embeddings, got.age_probs,
              got.gender_probs, got.crops):
        assert t.dtype == torch.float32
    gb = got.det.boxes.numpy()[0][valid]
    rb = np.asarray(ref.det.boxes)[0][valid]
    np.testing.assert_allclose(gb, rb, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.det.lmarks.numpy()[0][valid],
                               np.asarray(ref.det.lmarks)[0][valid],
                               atol=1.0, rtol=0)
    np.testing.assert_allclose(got.det.scores.numpy()[0][valid],
                               np.asarray(ref.det.scores)[0][valid],
                               atol=1e-3, rtol=0)
    emb = np.asarray(ref.embeddings)[0][valid]
    age = np.asarray(ref.age_probs)[0][valid]
    gender = np.asarray(ref.gender_probs)[0][valid]
    spec = jeng.embed_spec
    from face_detection_and_recognition_tpu.models.embedders import \
        preprocess_crops as j_preprocess_crops
    for j in np.nonzero((np.floor(gb) != np.floor(rb)).any(-1))[0]:
        crop = np.clip(np.asarray(JC.crop_and_resize(
            jnp.asarray(img), jnp.asarray(gb[j][None]), (112, 112))), 0, 255)
        emb[j] = np.asarray(jeng._embed(jeng.embed_vars, j_preprocess_crops(
            spec, crop)))[0]
        pb = np.asarray(JC.pad_boxes(jnp.asarray(gb[j]), (-5, -5, 5, 5),
                                     (w, h)))
        c = jnp.clip(JC.crop_and_resize(jnp.asarray(img),
                                        jnp.asarray(pb[None]), (227, 227)),
                     0.0, 255.0).astype(BF)
        a, g = jeng._classify_ag(*jeng.ag_vars, c.astype(jnp.float32)
                                 - jnp.asarray(AG_MEAN, jnp.float32))
        age[j], gender[j] = np.asarray(a)[0], np.asarray(g)[0]
    cos = (got.embeddings.numpy()[0][valid] * emb).sum(-1)
    assert (cos >= 0.9999).all(), cos
    np.testing.assert_array_equal(got.age_probs.numpy()[0][valid].argmax(-1),
                                  age.argmax(-1))
    np.testing.assert_array_equal(
        got.gender_probs.numpy()[0][valid].argmax(-1), gender.argmax(-1))
    faces = np.random.RandomState(15).randint(0, 256, (3, 96, 96, 3)) \
        .astype(np.uint8)
    cos = (teng.embed_crops(faces) * jeng.embed_crops(faces)).sum(-1)
    assert (cos >= 0.9999).all(), cos
    for g, r in zip(teng.classify_crops_age_gender(faces),
                    jeng.classify_crops_age_gender(faces)):
        np.testing.assert_array_equal(g.argmax(-1), np.asarray(r).argmax(-1))
        np.testing.assert_allclose(g, r, atol=2e-2, rtol=0)
    # the two-stage cascade (f32 crops less the mean, cast by the heads):
    # the genders of the JAX ensemble's rows, in score order
    got = teng.detect_age_gender(img)
    assert [s.split(":")[0] for s in got.bbox_labels] == \
        [JAG.GENDERS[i] for i in gender.argmax(-1)]


def test_int8_bf16_net_matches_jax():
    """A yolov5n int8 static net with dtype bf16 (golden weights, quantized
    by the JAX package, its scales calibrated on the two frames at 128 x
    128): its ConvBNs widen their bf16 input to f32 and its Detect
    convolutions are bf16, as JAX's are; the port's detections on the
    golden frames at 320 x 320, through ``yolov5_face_detect_maps`` on its
    bf16 maps, against the JAX bf16 int8 net's: the same valid rows, boxes
    within 1 px."""
    v = _load("golden_yolov5n_ckpt")
    x = _frames(320, 320)
    # JQ.calibrate_activation_scales' scales (each ConvBN input's absmax /
    # 127), its inputs captured in one compiled f32 program
    _, io = _capture(JY.YoloV5FaceNet(arch="yolov5n"), v,
                     _frames(128, 128).astype(jnp.float32),
                     lambda p, m: type(m).__name__ == "ConvBN")
    scales = {p: max(float(np.abs(xi).max()), 1e-6) / 127.0
              for p, _, xi, _ in io}
    assert len(scales) == 82
    tree = JQ.pour_activation_scales(JQ.quantize_variables(v), scales)
    cfg = JY.YoloV5FaceConfig(arch="yolov5n", input_size=(320, 320))
    _, _, detect = JY.make_yolov5_face(cfg, dtype=BF, quantized="static")
    rd, rv = (np.asarray(a) for a in detect(tree, x))
    port = TY.YoloV5FaceNet("yolov5n", quantized="static").eval()
    port.load_state_dict(TW.yolov5_face_state_dict(tree, "yolov5n"))
    port = TL.set_compute_dtype(port.to(memory_format=torch.channels_last),
                                torch.bfloat16)
    with torch.no_grad():
        tmaps = port(torch.from_numpy(np.asarray(x.astype(jnp.float32)))
                     .to(torch.bfloat16))
    assert all(m.dtype == torch.bfloat16 for m in tmaps)
    gd, gv = TY.yolov5_face_detect_maps(
        tmaps, TY.FACE_ANCHORS, (8, 16, 32),
        TY.YoloV5FaceConfig(arch="yolov5n", input_size=(320, 320)))
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert rv[0].sum() >= 1 and rv[1].sum() == 0
    np.testing.assert_allclose(gd.numpy()[rv][:, :4], rd[rv][:, :4],
                               atol=1.0, rtol=0)


def test_face_service_runs_a_bf16_engine(engines, golden):
    """``ServiceConfig(dtype=torch.bfloat16)`` builds a bf16 engine, and
    the service's contract calls give what the bf16 engine gives."""
    from face_detection_and_recognition_tpu_torch.serving.service import (
        FaceService, ServiceConfig)

    teng = engines[1]
    svc = FaceService(ServiceConfig(detector="yolov5s", max_det=16,
                                    dtype=torch.bfloat16, device="cpu"))
    try:
        assert svc.engine.cfg.dtype == torch.bfloat16
        svc.engine.load_state_dict(TW.yolov5_face_state_dict(golden["det"],
                                                             "yolov5s"))
        svc.engine.load_embed_state_dict(
            TW.mobile_facenet_state_dict(golden["embed"]))
        svc.engine.load_age_gender_state_dict(TW.age_gender_state_dict(
            golden["age"], golden["gender"]))
        img = cv2.imread(os.path.join(DATA, "test2_faces_3.jpg"))
        got = svc.detect_embed_classify(img)
        c = svc.cfg
        ref = teng.detect_embed_classify_batch(
            img[None], det_thres=c.det_thres, bbox_area_thres=c.bbox_area_thres)
        valid = ref.det.valid[0]
        assert int(valid.sum()) == 3
        np.testing.assert_array_equal(got["bboxes"],
                                      ref.det.to_numpy()[0].boxes)
        np.testing.assert_array_equal(got["embeddings"],
                                      ref.embeddings[0][valid].numpy())
    finally:
        svc.close()
