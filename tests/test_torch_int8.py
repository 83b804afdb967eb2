"""The port's int8 yolov5-face path against the JAX package (CPU).

``utils/quantize.py`` (the BN fold, the per-channel int8 weights, the
calibration and its scales), the quantized ConvBN (``QConvBN``, whose CPU
route is Q1's plain version) against the JAX ``ConvBN(quantized=True |
"static")`` compiled with ``jax.jit``, a quantized yolov5n at 128x128 in
both modes, and the int8 golden gate of
``tests/test_golden_accuracy.py:397-424`` through the port's engine.

The JAX layer is compiled: XLA computes its ``max(absmax, 1e-6) / 127.0``
as a product with the f32 reciprocal and its ``acc * (s * wscale) + bias``
as one fused multiply-add, and the port computes the same forms
(``ops/int8_conv.py``), so the codes and the pre-activations are equal and
the tolerances below only cover SiLU (the two frameworks' forms differ by
an ulp or so) and what such an ulp does downstream.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.models.layers import \
    ConvBN as JConvBN
from face_detection_and_recognition_tpu.models.yolov5_face import \
    YoloV5FaceConfig as JYoloV5FaceConfig
from face_detection_and_recognition_tpu.models.yolov5_face import \
    make_yolov5_face
from face_detection_and_recognition_tpu.utils import quantize as JQ
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.models.layers import QConvBN
from face_detection_and_recognition_tpu_torch.models.yolov5_face import (
    ARCHS, YoloV5FaceConfig, YoloV5FaceNet, yolov5_face_detect_maps)
from face_detection_and_recognition_tpu_torch.ops.int8_conv import (
    act_scale, quantize_codes)
from face_detection_and_recognition_tpu_torch.utils import quantize as Q
from face_detection_and_recognition_tpu_torch.utils.weights import (
    _qconvbn, yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
SIDE = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the Tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    """A checkpoint's floats as f32 numpy (int8 codes stay int8)."""
    def cast(a):
        a = np.asarray(a)
        return a if a.dtype == np.int8 else a.astype(np.float32)
    return jax.tree_util.tree_map(cast,
                                  load_variables(os.path.join(DATA, name)))


@jax.jit
def _jax_codes(x, ascale):
    """The codes of JAX ``ConvBN`` (models/layers.py:92-98), compiled:
    the dynamic scale where ``ascale`` is NaN, else ``ascale``."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-6) / 127.0
    s = jnp.where(jnp.isnan(ascale), s, ascale)
    return jnp.clip(jnp.round(xf / s), -127, 127).astype(jnp.int8)


HW = (20, 18)
LAYERS = [  # (c_in, c_out, k, stride, groups, silu, batch, frame h x w)
    pytest.param(16, 32, 3, 2, 1, True, 1, HW, id="k3-s2"),
    pytest.param(24, 40, 1, 1, 1, True, 1, HW, id="k1-s1"),
    pytest.param(20, 16, 3, 1, 1, True, 1, HW, id="k3-s1-c20"),
    pytest.param(24, 24, 3, 2, 24, False, 1, HW, id="depthwise-s2"),
    pytest.param(3, 16, 3, 2, 1, True, 1, HW, id="stem-c3"),
    pytest.param(8, 16, 3, 1, 1, True, 2, HW, id="batch2"),
    # the edges of Q1's tiling: ragged C_in (12, 92, 5: words of fewer
    # than 4 channels past the stem), C_out off the N tile (40, and 360
    # over two tiles), M off the M tile (odd frames), depthwise at a C
    # that is no multiple of its 16-channel blocks
    pytest.param(12, 40, 1, 1, 1, True, 2, (17, 23), id="c12-cout40"),
    pytest.param(12, 24, 3, 2, 1, True, 1, (17, 23), id="c12-k3-s2-ragged-m"),
    pytest.param(92, 360, 3, 1, 1, True, 1, (13, 11), id="c92-cout360"),
    pytest.param(5, 7, 3, 1, 1, False, 3, (9, 14), id="c5-cout7"),
    pytest.param(20, 20, 3, 1, 20, True, 2, (19, 17), id="depthwise-c20"),
]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("c_in,c_out,k,stride,groups,silu,b,hw", LAYERS)
def test_qconvbn_matches_jax(c_in, c_out, k, stride, groups, silu, b, hw,
                             static):
    """QConvBN against the jitted JAX ConvBN on the same folded weights:
    the same int8 codes, the pre-activation equal, SiLU outputs within
    rtol 1e-5 and atol 1e-5 * max|ref|. The batch of 2 holds two frames
    of different ranges: the dynamic scale is the absmax of both."""
    rng = np.random.RandomState(c_in * 100 + k * 10 + b)
    x = rng.uniform(-1, 1, (b,) + hw + (c_in,)).astype(np.float32)
    if b == 2:
        x[1] *= 6.0  # frame 1 sets the batch's scale
    act = jax.nn.silu if silu else None
    m = JConvBN(c_out, k, stride, groups=groups, act=act)
    v = jax.tree_util.tree_map(np.asarray,
                               m.init(jax.random.PRNGKey(b), x))
    v["batch_stats"]["BatchNorm_0"]["mean"] = \
        rng.uniform(-0.2, 0.2, c_out).astype(np.float32)
    v["batch_stats"]["BatchNorm_0"]["var"] = \
        rng.uniform(0.5, 2.0, c_out).astype(np.float32)
    v["params"]["BatchNorm_0"]["scale"] = \
        rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    vq = JQ.quantize_variables(v)
    ascale = np.float32(np.abs(x).max() * 0.8 / 127.0)  # clips the tail
    if static:
        vq["params"]["ascale"] = ascale
    mode = "static" if static else True
    jm = JConvBN(c_out, k, stride, groups=groups, act=act, quantized=mode)
    jm_lin = JConvBN(c_out, k, stride, groups=groups, act=None,
                     quantized=mode)
    ref = np.asarray(jax.jit(jm.apply)(vq, x))
    ref_pre = np.asarray(jax.jit(jm_lin.apply)(vq, x))
    codes = np.asarray(_jax_codes(x, ascale if static else np.nan))

    t = QConvBN(c_in, c_out, k, stride, None, groups,
                "silu" if silu else None, static=static)
    sd = {}
    _qconvbn(sd, "q", vq["params"])
    t.load_state_dict({n[2:]: a for n, a in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    s = t.ascale if static else act_scale(xt)
    np.testing.assert_array_equal(
        quantize_codes(xt, s).permute(0, 2, 3, 1).numpy(), codes)
    with torch.no_grad():
        got = t(xt).permute(0, 2, 3, 1).numpy()
        t.act = None
        got_pre = t(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got_pre, ref_pre)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# ---------------- Q1's packed weights ----------------


PACKS = [  # (c_out, k, c_in / g, groups)
    pytest.param(32, 3, 3, 1, id="stem-ohwi4"),
    pytest.param(40, 1, 12, 1, id="c12"),
    pytest.param(360, 3, 92, 1, id="c92"),
    pytest.param(7, 5, 5, 1, id="c5-k5"),
    pytest.param(20, 3, 1, 20, id="depthwise-c20"),
]


@pytest.mark.parametrize("cout,k,cg,groups", PACKS)
def test_pack_kernel_q_round_trips(cout, k, cg, groups):
    """``pack_kernel_q`` (the layout Q1 reads) and back: ``unpack_kernel_q``
    gives kernel_q again; every code past the real ones is zero; a dense
    row is the OHWI4 codes flattened tap-major, padded to KSTEP."""
    from face_detection_and_recognition_tpu_torch.ops import int8_conv as IC

    g = torch.Generator().manual_seed(cout + k + cg)
    kq = torch.randint(-127, 128, (cout, k, k, cg), generator=g,
                       dtype=torch.int8)
    wp = IC.pack_kernel_q(kq, groups)
    assert wp.dtype == torch.int8 and wp.is_contiguous()
    assert torch.equal(IC.unpack_kernel_q(wp, k, cg, cout, groups), kq)
    if groups == 1:
        c4 = cg + (-cg) % 4
        assert wp.shape[0] == cout and wp.shape[1] % IC.KSTEP == 0
        ohwi4 = IC.pad_channels4(kq)
        assert ohwi4.shape == (cout, k, k, c4)
        assert torch.equal(wp[:, :k * k * c4], ohwi4.reshape(cout, -1))
        assert not wp[:, k * k * c4:].any() and not ohwi4[..., cg:].any()
    else:
        assert wp.shape == (k * k, cout + (-cout) % 4)
        assert not wp[:, cout:].any()
    assert int(wp.abs().sum()) == int(kq.abs().sum())


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_padded_codes_add_nothing(static):
    """The stem's C_in = 3 padded to 4: the plain convolution of the input
    with a zero fourth channel against the OHWI4 weights equals the
    unpadded one bit for bit (the zero codes add nothing to the int32
    sums, and a zero channel leaves the absmax alone), as does the plain
    version called on the packed weights (``conv_int8_packed_plain``, Q1's
    arguments)."""
    from face_detection_and_recognition_tpu_torch.ops import int8_conv as IC

    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 3, 21, 19), generator=g) * 3
    kq = torch.randint(-127, 128, (16, 3, 3, 3), generator=g,
                       dtype=torch.int8)
    ws = torch.rand(16, generator=g) * 1e-2
    bias = torch.randn(16, generator=g)
    ascale = (x.abs().amax() * 0.7 / 127).reshape(()) if static else None
    ref = IC.conv_int8_plain(x, kq, ws, bias, 2, 1, 1, "silu", ascale)
    x4 = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
    got = IC.conv_int8_plain(x4, IC.pad_channels4(kq), ws, bias, 2, 1, 1,
                             "silu", ascale)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    packed = IC.conv_int8_packed_plain(x, IC.pack_kernel_q(kq), ws, bias,
                                       3, 2, 1, 1, "silu", ascale)
    assert torch.equal(packed.view(torch.int32), ref.view(torch.int32))


# ---------------- the yolov5n net ----------------


@pytest.fixture(scope="module")
def golden_n():
    """golden_yolov5n_ckpt (f32) and two 128x128 frames: the golden image
    and the negative one, resized."""
    v = _load("golden_yolov5n_ckpt")
    frames = np.stack([
        cv2.resize(cv2.imread(os.path.join(DATA, name)), (SIDE, SIDE))
        for name in ("test2_faces_3.jpg", "test1_faces_0.jpg")])
    x = (frames[..., ::-1] / 255.0).astype(np.float32)
    return v, x


def test_quantize_variables_bit_equal(golden_n):
    """The port's fold + quantize on its own f32 state dict equals the JAX
    package's quantize_variables bit for bit (kernel_q, wscale, bias), and
    its copy of quantize_variables gives the same tree."""
    v, _ = golden_n
    jq = JQ.quantize_variables(v)
    ref = yolov5_face_state_dict(jq, "yolov5n")
    got = Q.quantize_state_dict(yolov5_face_state_dict(v, "yolov5n"))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), k)
    mine = Q.quantize_variables(v)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(mine),
            jax.tree_util.tree_leaves_with_path(jq)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the net built quantized takes the state dict as it is
    YoloV5FaceNet("yolov5n", quantized=True).load_state_dict(got)


@pytest.fixture(scope="module")
def calibrated(golden_n):
    """Both packages' calibrated scales on the two frames, each poured into
    its own quantized tree / state dict."""
    v, x = golden_n
    cfg = JYoloV5FaceConfig(arch="yolov5n", input_size=(SIDE, SIDE))
    jnet, _, _ = make_yolov5_face(cfg)
    jscales = JQ.calibrate_activation_scales(jnet, v, [jnp.asarray(x)])
    jtree = JQ.pour_activation_scales(JQ.quantize_variables(v), jscales)
    net = YoloV5FaceNet("yolov5n")
    net.load_state_dict(yolov5_face_state_dict(v, "yolov5n"))
    scales = Q.calibrate_activation_scales(net, [torch.from_numpy(x)])
    sd = Q.pour_activation_scales(Q.quantize_state_dict(net.state_dict()),
                                  scales)
    return jtree, sd, scales


def test_calibrated_scales_match_jax(calibrated):
    """calibrate_activation_scales + pour_activation_scales against the
    JAX package's on the same frames: the same ConvBN slots, the net
    input's scale (the stem's first conv) equal, and every deeper one
    within rtol 1e-5 (its input passed through f32 convolutions that the
    two frameworks sum in different orders)."""
    jtree, sd, scales = calibrated
    ref = yolov5_face_state_dict(jtree, "yolov5n")
    keys = sorted(k for k in ref if k.endswith(".ascale"))
    assert keys == sorted(k for k in sd if k.endswith(".ascale"))
    assert len(keys) == len(scales) == 82
    assert float(sd["model.0.stem_1.ascale"]) == \
        float(ref["model.0.stem_1.ascale"])
    got = np.array([float(sd[k]) for k in keys])
    want = np.array([float(ref[k]) for k in keys])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _jax_convbn_io(net, tree, x):
    """The jitted JAX net's raw maps and every ConvBN's input and output,
    captured inside the one compiled program: {flax path: (in, out)}."""
    import flax.linen as fnn

    paths = []

    def run(tree, x):
        caps = []

        def icpt(next_fn, args, kwargs, ctx):
            out = next_fn(*args, **kwargs)
            if type(ctx.module).__name__ == "ConvBN" \
                    and ctx.method_name == "__call__":
                caps.append((tuple(ctx.module.path), args[0], out))
            return out

        with fnn.intercept_methods(icpt):
            maps = net.apply(tree, x)
        paths[:] = [c[0] for c in caps]
        return maps, [c[1:] for c in caps]

    maps, io = jax.jit(run)(tree, jnp.asarray(x))
    return maps, {p: tuple(map(np.asarray, t)) for p, t in zip(paths, io)}


def _port_paths(jtree):
    """{flax ConvBN path: the port's QConvBN module path}, read off the
    weight bridge: each ConvBN's wscale set to its own index."""
    tagged = jax.tree_util.tree_map(lambda a: a, jtree)
    order = []

    def tag(node, path):
        for k, sub in node.items():
            if isinstance(sub, dict) and "kernel_q" in sub:
                sub["wscale"] = np.full_like(sub["wscale"], len(order))
                order.append(path + (k,))
            elif isinstance(sub, dict):
                tag(sub, path + (k,))

    tag(tagged["params"], ())
    sd = yolov5_face_state_dict(tagged, "yolov5n")
    return {order[int(t[0])]: k[:-len(".wscale")] for k, t in sd.items()
            if k.endswith(".wscale")}


@pytest.mark.parametrize("mode", [True, "static"], ids=["dynamic", "static"])
def test_quantized_yolov5n_matches_jax(golden_n, calibrated, mode):
    """A quantized yolov5n at 128x128 on a batch of 2, both modes, on the
    JAX package's int8 tree (the static scales JAX's own), layer by layer
    and end to end. Each of the 82 QConvBNs, given the input its JAX
    ConvBN had inside the compiled net: the same int8 codes and outputs
    within rtol 1e-5, atol 1e-5 * max|ref|. End to end: the detections
    (conf 0.01) the same count a frame and rows within 1e-4 of the input
    size. The deeper maps are not held end to end: the two frameworks'
    SiLU (XLA's exp polynomial against libm's expf) differ by an ulp, and
    an ulp that moves an input across a rounding boundary flips its int8
    code, which moves the layer's output by one quantization step
    (ROADMAP.md, known quirks)."""
    v, x = golden_n
    jtree = calibrated[0] if mode == "static" else JQ.quantize_variables(v)
    cfg = JYoloV5FaceConfig(arch="yolov5n", input_size=(SIDE, SIDE),
                            conf_thres=0.01, max_det=32)
    jnet, _, jdetect = make_yolov5_face(cfg, quantized=mode)
    _, io = _jax_convbn_io(jnet, jtree, x)
    jdets, jvalid = jdetect(jtree, jnp.asarray(x))

    net = YoloV5FaceNet("yolov5n", quantized=mode)
    net.load_state_dict(yolov5_face_state_dict(jtree, "yolov5n"))
    net = net.to(memory_format=torch.channels_last).eval()
    mods = dict(net.named_modules())
    paths = _port_paths(jtree)
    assert len(io) == len(paths) == 82
    for jpath, (xin, ref) in io.items():
        m = mods[paths[jpath]]
        xt = torch.from_numpy(xin).permute(0, 3, 1, 2)
        s = m.ascale if mode == "static" else act_scale(xt)
        asc = np.float32(m.ascale) if mode == "static" else np.nan
        np.testing.assert_array_equal(
            quantize_codes(xt, s).permute(0, 2, 3, 1).numpy(),
            np.asarray(_jax_codes(xin, asc)), str(jpath))
        with torch.no_grad():
            got = m(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=str(jpath))

    tcfg = YoloV5FaceConfig(arch="yolov5n", input_size=(SIDE, SIDE),
                            conf_thres=0.01, max_det=32)
    with torch.no_grad():
        dets, valid = yolov5_face_detect_maps(
            net(torch.from_numpy(x)), ARCHS["yolov5n"]["anchors"],
            ARCHS["yolov5n"]["strides"], tcfg)
    jvalid, valid = np.asarray(jvalid), valid.numpy()
    np.testing.assert_array_equal(valid.sum(1), jvalid.sum(1))
    assert valid.sum() > 0
    for i in range(len(x)):
        np.testing.assert_allclose(dets[i][valid[i]].numpy(),
                                   np.asarray(jdets)[i][jvalid[i]],
                                   atol=1e-4 * SIDE)


def test_int8_golden_gate_through_the_port(tmp_path):
    """The int8 gate of tests/test_golden_accuracy.py:397-424 through the
    port: golden_yolov5n_int8_ckpt written as a .pt, loaded by a CPU
    engine built with {"quantized": "static"}, through
    train.golden.evaluate_golden(det_thres=0.575, margin=0.125): 3 faces
    at IoU >= 0.75, none on the negative image, boxes within 1 px of the
    JAX int8 engine's."""
    from face_detection_and_recognition_tpu.core.engine import \
        EngineConfig as JEngineConfig
    from face_detection_and_recognition_tpu.core.engine import \
        FaceEngine as JFaceEngine
    from face_detection_and_recognition_tpu.train.golden import (
        GOLDEN_IMG, evaluate_golden)
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)

    v = _load("golden_yolov5n_int8_ckpt")
    path = str(tmp_path / "yolov5n_int8.pt")
    torch.save(yolov5_face_state_dict(v, "yolov5n"), path)
    eng = FaceEngine(EngineConfig(detector="yolov5n", det_thres=0.5,
                                  detector_overrides={"quantized": "static"}),
                     device="cpu")
    eng.load_weights(path)
    r = evaluate_golden(eng, det_thres=0.575, margin=0.125)
    assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= 0.75 for iou in r["ious"]), r["ious"]

    jeng = JFaceEngine(JEngineConfig(
        detector="yolov5n", det_thres=0.5,
        detector_overrides={"quantized": "static"}))
    jeng.variables = load_variables(os.path.join(DATA,
                                                 "golden_yolov5n_int8_ckpt"))
    ref = jeng.detect_image(cv2.imread(GOLDEN_IMG), det_thres=0.575)
    ref = np.asarray(ref.boxes, np.float32)
    got = np.asarray(r["pred_boxes"], np.float32)
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(np.sort(got, 0), np.sort(ref, 0), atol=1.0)


def test_int8_pt_rebuilds_an_f32_engine(tmp_path):
    """An int8 .pt given to an f32 yolov5 engine (the CLI's --ckpt, the
    service's ckpt) rebuilds the detector in the file's mode; an f32 .pt
    brings it back; a detector without an int8 build refuses the file."""
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)
    from face_detection_and_recognition_tpu_torch.models.layers import \
        ConvBN

    eng = FaceEngine(EngineConfig(detector="yolov5n-0.5",
                                  detector_overrides={"input_size":
                                                      (64, 64)}),
                     device="cpu")
    f32 = {k: t.clone() for k, t in eng.net.state_dict().items()}
    q = Q.quantize_state_dict(f32)
    static = Q.pour_activation_scales(q, {})
    for sd, mode in ((q, True), (static, "static"), (f32, False)):
        path = str(tmp_path / f"{mode}.pt")
        torch.save(sd, path)
        eng.load_weights(path)
        assert eng.net.quantized == mode
        assert any(isinstance(m, QConvBN) for m in eng.net.modules()) \
            == bool(mode)
        assert any(isinstance(m, ConvBN) for m in eng.net.modules()) \
            != bool(mode)
        det = eng.detect_batch(np.zeros((1, 48, 64, 3), np.uint8), 0.0, 0.0)
        assert det.boxes.shape == (1, 64, 4)
    blaze = FaceEngine(EngineConfig(detector="blazeface-front"),
                       device="cpu")
    with pytest.raises(ValueError, match="int8"):
        blaze.load_weights(str(tmp_path / "True.pt"))
