"""The port's SSD family (ssd-resnet10, ssd-mobilenetv2, ssd-squeezenet)
against the JAX package (CPU): each backbone's ``SSDFaceNet`` heads and
``ssd_postprocess`` on the same weights and inputs (f32, within 1e-4, the
same row counts), the registry entries, the three golden gates run through
the port (the bars and overrides of ``tests/test_golden_accuracy.py``), and
``.caffemodel`` / ``.pb`` files written by the JAX package's writers from the
golden weights, loaded by both engines' ``load_weights``: the same
detections."""
import functools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.models import ssd as JS
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu.utils import weights as JW
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.models import ssd as TS
from face_detection_and_recognition_tpu_torch.utils.weights import \
    ssd_state_dict

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
TOL = 1e-4  # detections: normalized coordinates and scores
# (checkpoint, registry name, backbone, input side, gate bar, band gate):
# tests/test_golden_accuracy.py:108 (0.8), :245 (band, 0.7), :262 (band, 0.5)
GATES = (("golden_ssd_ckpt", "ssd-resnet10", "resnet10", 300, 0.8, False),
         ("golden_ssd_mnv2_ckpt", "ssd-mobilenetv2", "mobilenetv2", 448, 0.7,
          True),
         ("golden_ssd_sq_ckpt", "ssd-squeezenet", "squeezenet", 300, 0.5,
          True))
BY_ARCH = {g[1]: g for g in GATES}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    """{registry name: f32 flax variables of its golden checkpoint}."""
    return {arch: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        load_variables(os.path.join(DATA, ckpt)))
        for ckpt, arch, *_ in GATES}


def _port_engine(arch, variables=None):
    _, _, backbone, side, _, _ = BY_ARCH[arch]
    eng = FaceEngine(EngineConfig(detector=arch, det_thres=0.5,
                                  detector_overrides={"input_size":
                                                      (side, side)}),
                     device="cpu")
    if variables is not None:
        eng.load_state_dict(ssd_state_dict(variables, backbone))
    return eng


@functools.lru_cache(maxsize=None)
def _jax_engine(arch):
    """One JAX engine an arch for the file (its init and detect compiles
    are the cost): every use sets its variables first."""
    side = BY_ARCH[arch][3]
    return JFaceEngine(JEngineConfig(
        detector=arch, det_thres=0.5,
        detector_overrides={"input_size": (side, side)}))


def _same_rows(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.size:
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_registry_matches_the_jax_family():
    for name in ("ssd-resnet10", "ssd-mobilenetv2", "ssd-squeezenet",
                 "mtcnn"):
        j, t = JR.get(name), TR.get(name)
        assert (t.input_size, t.n_landmark_cols, t.rect_stride) == \
            (j.input_size, j.n_landmark_cols, j.rect_stride), name
        for field in ("size", "resize", "bgr_to_rgb", "scale", "mean",
                      "std", "fill"):
            assert getattr(t.preprocess, field) == \
                getattr(j.preprocess, field), (name, field)
    with pytest.raises(ValueError, match="native"):
        FaceEngine(EngineConfig(detector="mtcnn", detector_overrides={
            "input_size": (320, 320)}), device="cpu")


def _seeded_variables(net_j, side, seed=3):
    """Seeded numpy variables in the shapes of ``net_j``'s tree, from its
    abstract init (no init program to compile): kernels N(0, 1/fan_in),
    biases, BN shifts and means N(0, 0.1), BN scales and variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(net_j.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3)))
    rng = np.random.RandomState(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(sd.shape[:-1]))
            return (rng.standard_normal(sd.shape) / np.sqrt(fan_in)) \
                .astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("backbone", ["resnet10", "mobilenetv2",
                                      "squeezenet"])
def test_heads_and_postprocess_match_jax(backbone):
    """Seeded weights at a 96x96 input in [-2, 2] (the heads stay within a
    few units, as a trained net's do): the raw heads, then
    softmax -> decode -> top-k -> NMS -> keep_top_k, on the same logits;
    a second case with tied scores (saturated softmax) holds the tie
    order."""
    side = 96
    cfg_j = JS.SSDConfig(backbone=backbone, input_size=(side, side))
    net_j = JS.SSDFaceNet(cfg=cfg_j)
    variables = _seeded_variables(net_j, side)
    cfg_t = TS.SSDConfig(backbone=backbone, input_size=(side, side))
    net_t = TS.SSDFaceNet(cfg_t)
    net_t.load_state_dict(ssd_state_dict(variables, backbone))
    net_t.eval()
    x = np.random.RandomState(7).uniform(-2, 2, (2, side, side, 3)) \
        .astype(np.float32)
    locs_j, conf_j = jax.jit(net_j.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        locs_t, conf_t = net_t(torch.from_numpy(x))
    priors = TS.generate_priors(cfg_t)
    np.testing.assert_array_equal(priors, JS.generate_priors(cfg_j))
    assert priors.shape[0] == locs_t.shape[1]  # a prior a head row
    for got, ref in ((locs_t, locs_j), (conf_t, conf_j)):
        _same_rows(got.numpy(), np.asarray(ref))
    # the postprocess of both on the same (JAX) heads
    locs = np.array(locs_j)
    tied = np.array(conf_j)
    tied[..., 1] = np.round(tied[..., 1] * 2) * 20  # saturates to 0 / 1
    for conf in (np.array(conf_j), tied):
        dj, vj = JS.ssd_postprocess(jnp.asarray(locs), jnp.asarray(conf),
                                    jnp.asarray(priors), cfg_j)
        dt, vt = TS.ssd_postprocess(torch.from_numpy(locs),
                                    torch.from_numpy(conf),
                                    torch.from_numpy(priors), cfg_t)
        vj = np.asarray(vj)
        np.testing.assert_array_equal(vt.numpy(), vj)
        _same_rows(dt.numpy()[vt.numpy()], np.asarray(dj)[vj])


@pytest.mark.parametrize("arch", list(BY_ARCH))
def test_golden_gate_through_the_port(golden, arch):
    """The JAX package's golden gate on the port's engine, at the bar and
    band of tests/test_golden_accuracy.py (the JAX engine's detections on
    these weights: ``test_protobuf_weights_load_like_jax``, whose files
    carry them exactly)."""
    _, _, _, _, bar, band = BY_ARCH[arch]
    eng = _port_engine(arch, golden[arch])
    r = (evaluate_golden(eng, det_thres=0.6, margin=0.15) if band
         else evaluate_golden(eng))
    if band:
        assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= bar for iou in r["ious"]), (r["ious"], bar)


def _stream_layers(variables, order):
    """The flax tree as a caffemodel streams it in execution order:
    Convolution (OIHW kernel, bias), BatchNorm (mean, var, scale factor 1)
    + Scale (gamma, beta), from ``JW.ordered_slots``."""
    slots = JW.ordered_slots(variables, order)

    def leaf(path, name, stat=False):
        node = variables["batch_stats" if stat else "params"]
        for k in path:
            node = node[k]
        return np.asarray(node[name], np.float32)

    layers, i = [], 0
    while i < len(slots):
        path, name, shape, _ = slots[i]
        if name == "kernel":
            blobs = [leaf(path, "kernel").transpose(3, 2, 0, 1)]
            if i + 1 < len(slots) and slots[i + 1][:2] == (path, "bias"):
                blobs.append(leaf(path, "bias"))
                i += 1
            layers.append(JMF.CaffeLayer(f"conv{len(layers)}", "Convolution",
                                         blobs))
        elif name == "scale":
            layers.append(JMF.CaffeLayer(
                f"bn{len(layers)}", "BatchNorm",
                [leaf(path, "mean", True), leaf(path, "var", True),
                 np.ones(1, np.float32)]))
            layers.append(JMF.CaffeLayer(f"scale{len(layers)}", "Scale",
                                         [leaf(path, "scale"),
                                          leaf(path, "bias")]))
            i += 3  # bias, mean, var
        i += 1
    return layers


def _stream_consts(variables, order):
    """The same stream as a frozen GraphDef's consts (flax layouts, as TF
    keeps them): the first kernel as a uint8 quantize_weights triplet, and
    an int32 shape vector the importers must skip."""
    consts = [JMF.GraphConst("ssd/input_shape",
                             np.asarray([1, 300, 300, 3], np.int32))]
    for n, (path, name, _, stat) in enumerate(
            JW.ordered_slots(variables, order)):
        node = variables["batch_stats" if stat else "params"]
        for k in path:
            node = node[k]
        arr = np.asarray(node[name], np.float32)
        stem = f"ssd/{'/'.join(path)}/{name}"
        if n == 0:
            lo, hi = float(arr.min()), float(arr.max())
            q = np.round((arr - lo) / (hi - lo) * 255).astype(np.uint8)
            consts += [JMF.GraphConst(stem + "_quantized_const", q),
                       JMF.GraphConst(stem + "_quantized_min",
                                      np.asarray(lo, np.float32)),
                       JMF.GraphConst(stem + "_quantized_max",
                                      np.asarray(hi, np.float32))]
        else:
            consts.append(JMF.GraphConst(stem, arr))
    return consts


@pytest.mark.parametrize("arch,fmt", [("ssd-resnet10", ".caffemodel"),
                                      ("ssd-mobilenetv2", ".caffemodel"),
                                      ("ssd-squeezenet", ".pb")])
def test_protobuf_weights_load_like_jax(golden, tmp_path, arch, fmt):
    """The golden weights written by the JAX package's writers in
    execution order, then loaded by both engines' ``load_weights``: every
    slot of the port's net holds what the JAX engine's tree holds there
    (through the bridge), and on ssd-resnet10 the two engines' raw
    detections on the golden frame agree (the port's engine matches the
    JAX engine on the golden weights; a JAX compile a detector is the cost
    of the others)."""
    jeng = _jax_engine(arch)
    jeng.variables = golden[arch]
    order = jeng._execution_order()
    path = str(tmp_path / f"w{fmt}")
    with open(path, "wb") as f:
        if fmt == ".caffemodel":
            f.write(JMF.write_caffemodel(_stream_layers(golden[arch], order)))
        else:
            f.write(JMF.write_graphdef(_stream_consts(golden[arch], order)))
    jeng.load_weights(path)
    eng = _port_engine(arch)
    eng.load_weights(path)
    want = ssd_state_dict(jax.tree_util.tree_map(np.asarray, jeng.variables),
                          BY_ARCH[arch][2])
    for k, v in eng.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)
    if arch == "ssd-resnet10":
        img = cv2.imread(IMG)
        got, ref = eng.detect_raw(img), jeng.detect_raw(img)
        _same_rows(got, ref)
        assert len(got) > 0


IR_NETS = ("openvino-ir", "ov-0204", "ov-squeezenet-light")


@pytest.mark.parametrize("name", TR.available())
def test_weight_importers_sit_on_the_spec(name):
    """``load_weights`` calls the spec's importer for the file's extension
    and tests no detector name: every detector but the cascade and the IR
    nets reads a caffemodel by structure, res10-ssd by layer name; the
    SSD family, res10-ssd and the cascade read a .pb; the IR nets rebuild
    themselves from an .xml, every other detector pours its consts by
    structure."""
    spec = TR.get(name)
    want_caffe = (None if name == "mtcnn" or name in IR_NETS else
                  TR.import_res10_caffemodel if name == "res10-ssd" else
                  TR.import_caffemodel_structural)
    assert spec.import_caffemodel is want_caffe
    want_pb = {"mtcnn": TR.import_mtcnn_graphdef,
               "res10-ssd": TR.import_res10_graphdef}.get(
        name, TR.import_graphdef_structural if name.startswith("ssd-")
        else None)
    assert spec.import_pb is want_pb
    assert spec.import_xml is (TR.import_ir_net if name in IR_NETS
                               else TR.import_xml_structural)


def test_load_weights_follows_the_spec_not_the_name(golden, tmp_path):
    """An SSD spec under another name still reads its .pb, and one whose
    importer is taken away refuses it, naming the detector."""
    import dataclasses

    order = _jax_engine("ssd-squeezenet")._execution_order()
    path = str(tmp_path / "w.pb")
    with open(path, "wb") as f:
        f.write(JMF.write_graphdef(_stream_consts(golden["ssd-squeezenet"],
                                                  order)))
    named = _port_engine("ssd-squeezenet")
    named.load_weights(path)
    eng = _port_engine("ssd-squeezenet")
    eng.spec = dataclasses.replace(eng.spec, name="renamed")
    eng.load_weights(path)
    for k, v in eng.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      named.net.state_dict()[k].numpy(),
                                      err_msg=k)
    eng.spec = dataclasses.replace(eng.spec, import_pb=None)
    with pytest.raises(ValueError, match="no .pb importer for detector "
                       "'renamed'"):
        eng.load_weights(path)


def test_structural_import_names_the_slot_and_counts():
    eng = _port_engine("ssd-resnet10")
    from face_detection_and_recognition_tpu_torch.utils import weights as TW

    example = TR.example_input(eng.spec.input_size)
    slots = TW.execution_slots(eng.net, example)
    arrays = [np.zeros(s, np.float32) for _, _, s in slots]
    TW.structural_import(arrays, eng.net, example)
    bad = list(arrays)
    bad[0] = np.zeros((3, 3, 3, 32), np.float32)
    with pytest.raises(ValueError, match="backbone.stem.conv.weight"):
        TW.structural_import(bad, eng.net, example)
    with pytest.raises(ValueError, match="leaves"):
        TW.structural_import(arrays[:-1], eng.net, example)
    # the first slots follow the call order: stem conv, then its BN
    assert [n for n, _, _ in slots[:5]] == [
        "backbone.stem.conv.weight", "backbone.stem.bn.weight",
        "backbone.stem.bn.bias", "backbone.stem.bn.running_mean",
        "backbone.stem.bn.running_var"]
