"""The port's res10-ssd (the exact res10_300x300 Caffe deploy graph) against
the JAX package (CPU): the caffemodel graph reader and writer, the table
net's heads, priors and DetectionOutput on the same seeded blobs (f32), the
file-graph build against the table build, ``pour_blobs``' diagnostics, the
registry entry, and the golden gates through the port: the golden
``.caffemodel`` and a quantized uint8 GraphDef of the golden blobs, each
loaded by both engines' ``load_weights``, with boxes within 1 px of the JAX
engine's."""
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
from face_detection_and_recognition_tpu.models import caffe_ssd as JC
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.models import res10 as JRES
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils import caffe_graph as JG
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import caffe_ssd as TC
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.models import res10 as TRES
from face_detection_and_recognition_tpu_torch.utils import caffe_graph as TG
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
CAFFEMODEL = os.path.join(DATA, "golden_res10.caffemodel")
TOL = 1e-4       # raw heads
ROW_TOL = 1e-5   # detections on the same heads, normalized


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_net():
    return JC.CaffeGraphNet(JRES.res10_deploy_defs(), input_size=(300, 300))


def _seeded_blobs(seed=3):
    """Seeded blobs in the res10 table's shapes: kernels N(0, 1/fan_in),
    biases and BN means N(0, 0.1), BN variances and Scale gammas in
    [0.5, 1.5], BN scale factors 1, Normalize scales in [5, 20]."""
    rng = np.random.RandomState(seed)
    ops = {s.name: s.op for s in _jax_net().steps}
    out = {}
    for name, blobs in _jax_net().weights.items():
        new = []
        for i, b in enumerate(blobs):
            if b.ndim == 4:
                v = rng.standard_normal(b.shape) / np.sqrt(b[0].size)
            elif ops[name] == "normalize":
                v = rng.uniform(5, 20, b.shape)
            elif ops[name] == "batchnorm":
                v = ([0.1 * rng.standard_normal(b.shape),
                      rng.uniform(0.5, 1.5, b.shape), np.ones(b.shape)][i])
            elif ops[name] == "scale" and i == 0:
                v = rng.uniform(0.5, 1.5, b.shape)
            else:
                v = 0.1 * rng.standard_normal(b.shape)
            new.append(np.asarray(v, np.float32))
        out[name] = new
    return out


def _table_defs_with(blobs):
    defs = JRES.res10_deploy_defs()
    for d in defs:
        d.blobs = [np.asarray(b) for b in blobs.get(d.name, [])]
    return defs


def _port_engine(**kw):
    return FaceEngine(EngineConfig(detector="res10-ssd", **kw), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_engine():
    """One JAX res10-ssd engine for the file, loaded from the golden
    caffemodel: every use that changes its weights reloads them after."""
    eng = JFaceEngine(JEngineConfig(detector="res10-ssd", det_thres=0.5))
    eng.load_weights(CAFFEMODEL)
    return eng


def _close_boxes(got, ref, tol=1.0):
    got = np.asarray(got, np.float32).reshape(-1, 4)
    ref = np.asarray(ref, np.float32).reshape(-1, 4)
    assert got.shape == ref.shape, (got, ref)
    if ref.size:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_caffemodel_graph_reader_and_writer_match_jax(tmp_path):
    """A res10 caffemodel written by the JAX writer (the table's layers
    and seeded blobs): the port's reader gives what the JAX reader gives,
    layer for layer, and the port's writer writes the same bytes, which
    read back the same."""
    defs = _table_defs_with(_seeded_blobs())
    data = JG.write_caffemodel_graph(defs)
    mine, ref = TG.read_caffemodel_graph(data), JG.read_caffemodel_graph(data)
    assert len(mine) == len(ref) == len(defs)
    for a, b in zip(mine, ref):
        assert (a.name, a.type, a.bottoms, a.tops, a.params) == \
            (b.name, b.type, b.bottoms, b.tops, b.params)
        assert len(a.blobs) == len(b.blobs)
        for x, y in zip(a.blobs, b.blobs):
            np.testing.assert_array_equal(x, y)
    assert TG.write_caffemodel_graph(mine) == data
    path = tmp_path / "res10.caffemodel"
    path.write_bytes(TG.write_caffemodel_graph(mine))
    again = TG.read_caffemodel_graph(str(path))
    assert [(a.name, a.params) for a in again] == \
        [(b.name, b.params) for b in ref]


def test_table_net_heads_priors_and_detections_match_jax():
    """The deploy-table net on the same seeded blobs (bridged) at B = 2:
    loc / conf within 1e-4, priors and variances equal, and the
    DetectionOutput (decode, top-k, B1, keep_top_k) on the same heads
    within 1e-5 with the same valid rows."""
    blobs = _seeded_blobs()
    jnet = _jax_net()
    net = TC.CaffeGraphNet(TRES.res10_deploy_defs(), (300, 300)).eval()
    net.load_state_dict(TW.caffe_graph_state_dict(blobs))
    np.testing.assert_array_equal(net.priors, jnet.priors)
    np.testing.assert_array_equal(net.prior_variances, jnet.prior_variances)
    assert net.priors.shape == (8732, 4)
    boxes = [d.params["prior_box"] for d in TRES.res10_deploy_defs()
             if d.type == "PriorBox"]
    assert [TC.priors_per_cell(p) for p in boxes] == \
        [JC.priors_per_cell(p) for p in boxes] == \
        [npc for *_, npc in TRES.RES10_PRIOR_LADDER]
    # inputs in [-2, 2]: the heads stay within a few units, as a trained
    # net's do
    x = np.random.RandomState(7).uniform(-2, 2, (2, 300, 300, 3)) \
        .astype(np.float32)
    jloc, jconf = jax.jit(jnet.apply)(blobs, jnp.asarray(x))["detection_out"]
    with torch.no_grad():
        loc, conf = net(torch.from_numpy(x))
    for got, ref in ((loc, jloc), (conf, jconf)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)
    jdets, jvalid = jax.jit(JC.make_caffe_ssd_detect(jnet))(
        blobs, jnp.asarray(x))
    dets, valid = TC.make_caffe_ssd_detect(net)(
        (torch.from_numpy(np.array(jloc)), torch.from_numpy(np.array(jconf))),
        (300, 300))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().sum() > 0
    np.testing.assert_allclose(dets.numpy()[valid.numpy()],
                               np.asarray(jdets)[np.asarray(jvalid)],
                               rtol=0, atol=ROW_TOL)


def test_file_graph_build_equals_table_build(tmp_path):
    """A caffemodel that embeds the graph runs as its own graph
    (``strict_table=False``) and gives what the table net with the same
    blobs poured by name gives (JAX ``tests/test_caffe_golden.py:80-91``)."""
    blobs = _seeded_blobs(5)
    path = str(tmp_path / "res10.caffemodel")
    with open(path, "wb") as f:
        f.write(TG.write_caffemodel_graph(_table_defs_with(blobs)))
    table, dec1 = TRES.build_res10_from_caffemodel(path)
    graph, dec2 = TRES.build_res10_from_caffemodel(path, strict_table=False)
    assert graph.layer_defs[0].blobs  # the file's own layers
    for name, bl in blobs.items():
        for a, b in zip(bl, table.layer_blobs(name)):
            np.testing.assert_array_equal(a, b.numpy())
    x = torch.from_numpy((np.random.RandomState(1).uniform(0, 255, (
        2, 300, 300, 3)) - 117.0).astype(np.float32))
    with torch.no_grad():
        r1, v1 = dec1(table(x), (300, 300))
        r2, v2 = dec2(graph(x), (300, 300))
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", ["renamed", "reshaped"])
def test_pour_blobs_names_the_layer_like_jax(fault):
    """A caffemodel with a renamed or a reshaped layer: both packages
    refuse it with the same per-layer diff, which names the layer."""
    from face_detection_and_recognition_tpu_torch.utils.model_formats import \
        CaffeLayer

    blobs = _seeded_blobs()
    layers = [CaffeLayer(name, "", [np.asarray(b) for b in bl])
              for name, bl in blobs.items()]
    if fault == "renamed":
        layers[3].name = "conv1_renamed"
    else:
        layers[2].blobs[0] = np.zeros((7, 3, 7, 7), np.float32)
    net = TC.CaffeGraphNet(TRES.res10_deploy_defs(), (300, 300))
    with pytest.raises(ValueError) as mine:
        net.pour_blobs(layers)
    with pytest.raises(ValueError) as ref:
        _jax_net().pour_blobs(layers)
    assert str(mine.value) == str(ref.value)
    assert "per-layer diff" in str(mine.value)
    name = list(blobs)[3 if fault == "renamed" else 2]
    assert f"  {name}" in str(mine.value)


def test_registry_entry_and_size_refusal_match_jax():
    j, t = JR.get("res10-ssd"), TR.get("res10-ssd")
    assert (t.input_size, t.n_landmark_cols, t.rect_stride) == \
        (j.input_size, j.n_landmark_cols, j.rect_stride)
    for field in ("size", "resize", "bgr_to_rgb", "scale", "mean", "std",
                  "fill"):
        assert getattr(t.preprocess, field) == getattr(j.preprocess, field)
    assert t.import_caffemodel is TR.import_res10_caffemodel
    assert t.import_pb is TR.import_res10_graphdef
    ov = {"input_size": (320, 320)}
    with pytest.raises(ValueError, match="fixed 300x300") as mine:
        _port_engine(detector_overrides=ov)
    with pytest.raises(ValueError, match="fixed 300x300") as ref:
        j.build(**ov)
    assert str(mine.value) == str(ref.value)
    assert _port_engine(detector_overrides={
        "input_size": (300, 300)}).input_size == (300, 300)


def test_golden_caffemodel_gate_through_the_port():
    """The golden caffemodel through ``load_weights(".caffemodel")`` (the
    by-name pour): the reference bar 0.5 gate holds, 3 / 0, each IoU at
    least 0.8, and the boxes are the JAX engine's within 1 px."""
    eng = _port_engine(det_thres=0.5)
    eng.load_weights(CAFFEMODEL)
    r = evaluate_golden(eng, det_thres=0.5, margin=0.0)
    assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    assert all(iou >= 0.8 for iou in r["ious"]), r["ious"]
    img = cv2.imread(IMG)
    _close_boxes(eng.detect_image(img).boxes,
                 _jax_engine().detect_image(img).boxes)


def _quantized_graphdef(blobs, net):
    """The opencv_face_detector_uint8.pb artifact class, with the JAX
    package's writer: kernels HWIO as uint8 quantize_weights triplets,
    biases f32, Scale affines as gamma / beta, no BatchNorm statistics,
    '<layer>/...' names, consts shuffled out of pour order (the fixture of
    JAX ``tests/test_graphdef_ssd.py:64-99``)."""
    bn = {s.name for s in net.steps if s.op == "batchnorm"}
    scale = {s.name for s in net.steps if s.op == "scale"}
    consts = []
    for layer, bl in blobs.items():
        if layer in bn:
            continue
        for i, b in enumerate(bl):
            b = np.asarray(b, np.float32)
            if layer in scale:
                consts.append(JMF.GraphConst(
                    f"{layer}/{'beta' if i else 'gamma'}", b))
            elif b.ndim == 4:
                w = np.transpose(b, (2, 3, 1, 0))
                lo, hi = float(w.min()), float(w.max())
                hi = hi if hi > lo else lo + 1e-6
                q = np.clip(np.round((w - lo) * (255.0 / (hi - lo))), 0,
                            255).astype(np.uint8)
                stem = f"{layer}/weights"
                consts += [JMF.GraphConst(stem + "_quantized_const", q),
                           JMF.GraphConst(stem + "_quantized_min",
                                          np.asarray(lo, np.float32)),
                           JMF.GraphConst(stem + "_quantized_max",
                                          np.asarray(hi, np.float32))]
            else:
                consts.append(JMF.GraphConst(f"{layer}/bias", b))
    np.random.RandomState(3).shuffle(consts)
    return JMF.write_graphdef(consts)


def test_quantized_graphdef_gate_through_the_port(tmp_path):
    """``golden_res10_ckpt``'s blobs as a quantized uint8 GraphDef,
    through both engines' ``load_weights(".pb")``: the port's blobs are
    the JAX engine's exactly, the gate of JAX
    ``tests/test_graphdef_ssd.py:146-177`` holds through the port, and
    the boxes are the JAX engine's within 1 px."""
    golden = load_variables(os.path.join(DATA, "golden_res10_ckpt"))["params"]
    blobs = {k: [np.asarray(b, np.float32) for b in v]
             for k, v in golden.items()}
    pb = str(tmp_path / "opencv_face_detector_uint8.pb")
    with open(pb, "wb") as f:
        f.write(_quantized_graphdef(blobs, _jax_net()))
    eng = _port_engine(det_thres=0.5)
    eng.load_weights(pb)
    jeng = _jax_engine()
    jeng.load_weights(pb)
    try:
        for name, bl in jeng.variables.items():
            for a, b in zip(bl, eng.net.layer_blobs(name)):
                np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                              err_msg=name)
        k = next(n for n, bl in blobs.items() if bl[0].ndim == 4)
        diff = float(np.abs(blobs[k][0]
                            - eng.net.layer_blobs(k)[0].numpy()).max())
        assert 0 < diff < float(np.abs(blobs[k][0]).max())  # dequantized
        r = evaluate_golden(eng, det_thres=0.5, margin=0.0)
        assert r["ok"], r
        assert r["n_pos"] == 3 and r["n_neg"] == 0, r
        img = cv2.imread(IMG)
        _close_boxes(eng.detect_image(img).boxes,
                     jeng.detect_image(img).boxes)
    finally:
        jeng.load_weights(CAFFEMODEL)
