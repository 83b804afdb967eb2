"""The port's OpenVINO IR detectors (openvino-ir, ov-0204,
ov-squeezenet-light) against the JAX package (CPU): the IR graph reader and
writer on the golden IRs (and on one rewritten with f16 consts behind
Convert layers), both topologies' heads, priors and DetectionOutput on the
same seeded constants at B = 2 (the IRs' reshape targets are batch-1
literals), the golden band gates through the port (the IR files through
openvino-ir, the checkpoints through the topologies) with boxes within 1 px
of the JAX engine's, ``load_weights(".xml")`` (the IR nets rebuilt, another
detector poured by structure), the registry entries and the CLI."""
import contextlib
import functools
import io
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.cli.detect_face import main as jmain
from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.models import ov_graph as JOV
from face_detection_and_recognition_tpu.models import ov_topologies as JTOP
from face_detection_and_recognition_tpu.models import registry as JR
from face_detection_and_recognition_tpu.train.golden import evaluate_golden
from face_detection_and_recognition_tpu.utils import ir_graph as JIR
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu.utils import weights as JW
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.cli.detect_face import main
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.models import ov_graph as TOV
from face_detection_and_recognition_tpu_torch.models import \
    ov_topologies as TTOP
from face_detection_and_recognition_tpu_torch.models import registry as TR
from face_detection_and_recognition_tpu_torch.utils import ir_graph as TIR
from face_detection_and_recognition_tpu_torch.utils import weights as TW
from face_detection_and_recognition_tpu_torch.utils.parser import get_argparse

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
XML = {"ov-squeezenet-light": os.path.join(DATA, "golden_ov_sq.xml"),
       "ov-0204": os.path.join(DATA, "golden_ov_0204.xml")}
CKPT = {"ov-squeezenet-light": "golden_ov_sq_ckpt",
        "ov-0204": "golden_ov_0204_ckpt"}
SIDE = {"ov-squeezenet-light": 300, "ov-0204": 448}
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


def _bin(xml):
    return os.path.splitext(xml)[0] + ".bin"


@functools.lru_cache(maxsize=None)
def _jax_engine(topology):
    """One JAX openvino-ir engine a golden IR for the file."""
    return JFaceEngine(JEngineConfig(detector="openvino-ir", det_thres=0.5,
                                     detector_overrides={
                                         "xml": XML[topology]}))


def _port_ir_engine(xml, **kw):
    return FaceEngine(EngineConfig(detector="openvino-ir", det_thres=0.5,
                                   detector_overrides={"xml": xml}, **kw),
                      device="cpu")


def _close_boxes(got, ref, tol=1.0):
    got = np.asarray(got, np.float32).reshape(-1, 4)
    ref = np.asarray(ref, np.float32).reshape(-1, 4)
    assert got.shape == ref.shape, (got, ref)
    if ref.size:
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _same_graph(a, b):
    assert len(a.layers) == len(b.layers)
    for x, y in zip(a.layers, b.layers):
        assert (x.id, x.name, x.type, x.attrs, x.input_ports,
                x.output_ports, x.port_dims) == \
            (y.id, y.name, y.type, y.attrs, y.input_ports, y.output_ports,
             y.port_dims)
        assert (x.value is None) == (y.value is None)
        if x.value is not None:
            assert x.value.dtype == y.value.dtype
            np.testing.assert_array_equal(x.value, y.value)
    assert a.edges == b.edges


def _f16_convert_ir(xml):
    """The IR with every float Const of more than one dimension stored
    in f16 behind a Convert (destination_type f32), as the IR v10/v11
    compressed-weights format stores them: (layers, edges)."""
    g = JIR.parse_ir_graph(xml, _bin(xml))
    layers, edges = [], dict(g.edges)
    next_id = max(la.id for la in g.layers) + 1
    for la in g.layers:
        if la.type == "Const" and la.value.dtype == np.float32 \
                and la.value.ndim > 1:
            half = JIR.IRLayer(id=la.id, name=la.name + "/f16", type="Const",
                               value=la.value.astype(np.float16),
                               output_ports=[0],
                               port_dims={0: list(la.value.shape)})
            conv = JIR.IRLayer(id=next_id, name=la.name, type="Convert",
                               attrs={"destination_type": "f32"},
                               input_ports=[0], output_ports=[1],
                               port_dims={1: list(la.value.shape)})
            for to, src in edges.items():
                if src == (la.id, 0):
                    edges[to] = (next_id, 1)
            edges[(next_id, 0)] = (la.id, 0)
            layers += [half, conv]
            next_id += 1
        else:
            layers.append(la)
    return layers, edges


@pytest.mark.parametrize("topology", list(XML))
def test_ir_graph_reader_and_writer_match_jax(topology, tmp_path):
    """The golden IR parsed by both packages: the same layers, attributes,
    ports, dims, constants (dtype and value) and edges; the port's writer
    round-trips it."""
    xml = XML[topology]
    mine, ref = TIR.parse_ir_graph(xml, _bin(xml)), \
        JIR.parse_ir_graph(xml, _bin(xml))
    _same_graph(mine, ref)
    assert {la.value.dtype for la in mine.layers if la.value is not None} \
        == {np.dtype(np.float32), np.dtype(np.int64)}
    x, b = TIR.write_ir_graph(mine.layers, mine.edges)
    _same_graph(TIR.parse_ir_graph(x, b), ref)


def test_f16_consts_behind_convert_read_and_run_like_jax(tmp_path):
    """The SqueezeNet-light IR rewritten with f16 kernels behind Convert
    layers (written by the JAX writer): both readers give the same graph
    (f16 payloads), the port's net keys each weight by its Convert's
    name, holds the f16 values in f32, and its heads equal the JAX net's
    on the same file within 1e-4."""
    layers, edges = _f16_convert_ir(XML["ov-squeezenet-light"])
    x, b = JIR.write_ir_graph(layers, edges)
    xml, bn = str(tmp_path / "f16.xml"), str(tmp_path / "f16.bin")
    with open(xml, "wb") as f:
        f.write(x)
    with open(bn, "wb") as f:
        f.write(b)
    mine, ref = TIR.parse_ir_graph(xml, bn), JIR.parse_ir_graph(xml, bn)
    _same_graph(mine, ref)
    assert any(la.value is not None and la.value.dtype == np.float16
               for la in mine.layers)
    net, jnet = TOV.OVGraphNet(mine).eval(), JOV.OVGraphNet(ref)
    assert set(net.weight_names) == set(jnet.weights)
    for name, v in jnet.weights.items():
        np.testing.assert_array_equal(net.weight(name).numpy(), v)
    img = np.random.RandomState(2).uniform(0, 255, (2, 300, 300, 3)) \
        .astype(np.float32)
    jloc, jconf = jax.jit(jnet.apply)(jnet.init_variables(),
                                      jnp.asarray(img))[jnet.outputs[0]]
    with torch.no_grad():
        loc, conf = net(torch.from_numpy(img))
    for got, want in ((loc, jloc), (conf, jconf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
            got.shape), rtol=0, atol=TOL)


@pytest.mark.parametrize("topology", list(XML))
def test_topology_net_matches_jax(topology):
    """A topology at seed 5 in both packages (the same constants, then
    the JAX net's bridged in), on B = 2 raw BGR frames at its own size:
    loc / conf within 1e-4, priors and variances equal, the parameter
    count the JAX package's, and the DetectionOutput on the same heads
    within 1e-5 with the same valid rows."""
    side = SIDE[topology]
    jnet = JOV.OVGraphNet(JTOP.build_ov_topology(topology, seed=5))
    net = TOV.OVGraphNet(TTOP.build_ov_topology(topology, seed=5)).eval()
    weights = jnet.init_variables()
    for name, v in weights.items():
        np.testing.assert_array_equal(net.weight(name).numpy(), v)
    net.load_state_dict(TW.ov_graph_state_dict(weights))
    assert TTOP.count_params(topology) == JTOP.count_params(topology)
    np.testing.assert_array_equal(net.priors, jnet.priors)
    np.testing.assert_array_equal(net.prior_variances, jnet.prior_variances)
    assert net.input_dims == jnet.input_dims == [1, 3, side, side]
    img = np.random.RandomState(7).uniform(0, 255, (2, side, side, 3)) \
        .astype(np.float32)
    jdets, jvalid = jax.jit(JOV.make_ov_detect(jnet))(weights,
                                                      jnp.asarray(img))
    jloc, jconf = jax.jit(jnet.apply)(weights, jnp.asarray(img))[
        jnet.outputs[0]]
    with torch.no_grad():
        loc, conf = net(torch.from_numpy(img))
    assert loc.shape == (2, len(net.priors) * 4)
    for got, ref in ((loc, jloc), (conf, jconf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(
            got.shape), rtol=0, atol=TOL)
    # the JAX heads come batch-folded ([1, B * N * 4]): unfolded here
    dets, valid = TOV.make_ov_detect(net)(
        (torch.from_numpy(np.array(jloc).reshape(2, -1)),
         torch.from_numpy(np.array(jconf).reshape(2, -1))), (side, side))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.numpy().sum() > 0
    np.testing.assert_allclose(dets.numpy()[valid.numpy()],
                               np.asarray(jdets)[np.asarray(jvalid)],
                               rtol=0, atol=ROW_TOL)


@pytest.mark.parametrize("route", ["ir", "checkpoint"])
@pytest.mark.parametrize("topology", list(XML))
def test_golden_band_gate_through_the_port(topology, route):
    """The gate of JAX ``tests/test_ov_topologies.py:85-139`` through the
    port: the golden IR through openvino-ir, or the golden checkpoint
    (read by the JAX package, bridged) through the topology's registry
    name; the band holds (det_thres 0.6, margin 0.15), 3 / 0, and the
    boxes are the JAX engine's on the IR within 1 px (the checkpoint holds
    the IR's constants)."""
    if route == "ir":
        eng = _port_ir_engine(XML[topology])
    else:
        eng = FaceEngine(EngineConfig(detector=topology, det_thres=0.5),
                         device="cpu")
        v = load_variables(os.path.join(DATA, CKPT[topology]))["params"]
        eng.load_state_dict(TW.ov_graph_state_dict(
            {k: np.asarray(a, np.float32) for k, a in v.items()}))
    assert eng.input_size == (SIDE[topology],) * 2
    r = evaluate_golden(eng, det_thres=0.6, margin=0.15)
    assert r["ok"], r
    assert r["n_pos"] == 3 and r["n_neg"] == 0, r
    img = cv2.imread(IMG)
    _close_boxes(eng.detect_image(img).boxes,
                 _jax_engine(topology).detect_image(img).boxes)


def test_registry_entries_and_ir_retarget_match_jax():
    """The three names' sizes and recipes (raw BGR, letterbox, no mean),
    openvino-ir's refusal without an IR, and the IR's Parameter shape
    retargeting the engine's preprocess, as in the JAX package."""
    for name in ("openvino-ir", "ov-0204", "ov-squeezenet-light"):
        j, t = JR.get(name), TR.get(name)
        assert (t.input_size, t.n_landmark_cols, t.rect_stride) == \
            (j.input_size, j.n_landmark_cols, j.rect_stride), name
        for field in ("size", "resize", "bgr_to_rgb", "scale", "mean",
                      "std", "fill"):
            assert getattr(t.preprocess, field) == \
                getattr(j.preprocess, field), (name, field)
    with pytest.raises(ValueError) as mine:
        FaceEngine(EngineConfig(detector="openvino-ir"), device="cpu")
    with pytest.raises(ValueError) as ref:
        JR.get("openvino-ir").build()
    assert str(mine.value) == str(ref.value)
    assert "detector_overrides={'xml': 'model.xml'}" in str(mine.value)
    eng = _port_ir_engine(XML["ov-squeezenet-light"])
    jeng = _jax_engine("ov-squeezenet-light")
    assert eng.spec.input_size == jeng.spec.input_size == (300, 300)
    assert eng.spec.preprocess.size == jeng.spec.preprocess.size


def test_xml_reload_rebuilds_the_ir_net(tmp_path):
    """``load_weights(".xml")`` on an IR net builds the file's net: the
    ov-squeezenet-light engine reloaded from the golden IR runs what an
    openvino-ir engine built from it runs, and forgets the input shapes
    it has run; an IR of another input size raises, naming both sizes
    (the JAX engine takes it and fails at its next detect, when the
    prior count no longer fits its heads)."""
    img = cv2.imread(IMG)
    eng = FaceEngine(EngineConfig(detector="ov-squeezenet-light",
                                  det_thres=0.5), device="cpu")
    eng.detect_image(img)
    assert eng.compiled_pipelines == 1
    eng.load_weights(XML["ov-squeezenet-light"])
    assert eng.compiled_pipelines == 0
    ref = _port_ir_engine(XML["ov-squeezenet-light"])
    got, want = eng.detect_raw(img), ref.detect_raw(img)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="448x448 input, the engine was "
                       "built for 300x300"):
        eng.load_weights(XML["ov-0204"])
    with pytest.raises(ValueError, match="no .caffemodel importer"):
        eng.load_weights(str(tmp_path / "w.caffemodel"))


def test_structural_xml_import_matches_jax(tmp_path):
    """An IR holding ssd-resnet10's golden weights as consts, in execution
    order with OIHW kernels (the JAX package's writer): both engines'
    ``load_weights(".xml")`` pour the same values into the same slots."""
    from face_detection_and_recognition_tpu_torch.utils.weights import \
        ssd_state_dict

    golden = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        load_variables(os.path.join(DATA, "golden_ssd_ckpt")))
    jeng = JFaceEngine(JEngineConfig(detector="ssd-resnet10"))
    consts = []
    for path, name, _, stat in JW.ordered_slots(golden,
                                                jeng._execution_order()):
        node = golden["batch_stats" if stat else "params"]
        for k in path:
            node = node[k]
        arr = np.asarray(node[name], np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> the IR's OIHW
        consts.append(JMF.GraphConst(f"{'/'.join(path)}/{name}", arr))
    xml, blob = JMF.write_openvino_ir(consts)
    path = str(tmp_path / "ssd.xml")
    with open(path, "wb") as f:
        f.write(xml)
    with open(_bin(path), "wb") as f:
        f.write(blob)
    jeng.load_weights(path)
    eng = FaceEngine(EngineConfig(detector="ssd-resnet10"), device="cpu")
    eng.load_weights(path)
    want = ssd_state_dict(jax.tree_util.tree_map(np.asarray, jeng.variables),
                          "resnet10")
    for k, v in eng.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(),
                                          err_msg=k)


def _run(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    return rc, buf.getvalue()


def test_cli_openvino_ir_like_jax(tmp_path):
    """``detect_face --md openvino-ir``: without ``--ckpt`` both CLIs exit
    with the same message; with the golden IR the port prints the faces
    the JAX engine finds on it at the CLI's thresholds, boxes within
    1 px."""
    base = ["-i", IMG, "--md", "openvino-ir", "-d", "cpu", "--no-display",
            "-o", str(tmp_path / "out.jpg")]
    with pytest.raises(SystemExit) as mine:
        main(base)
    with pytest.raises(SystemExit) as ref:
        jmain(base)
    assert str(mine.value) == str(ref.value) == \
        "--md openvino-ir requires --ckpt model.xml"
    rc, out = _run(main, base + ["--ckpt", XML["ov-squeezenet-light"]])
    assert rc == 0
    args = get_argparse().parse_args(["-i", IMG])
    want = _jax_engine("ov-squeezenet-light").detect_image(
        cv2.imread(IMG), det_thres=args.det_thres,
        bbox_area_thres=args.bbox_area_thres)
    lines = [li.split()[0].strip("[]") for li in out.splitlines()
             if li.strip().startswith("[")]
    assert out.splitlines()[0] == f"{len(want.boxes)} face(s)"
    got = np.array([[float(v) for v in li.split(",")] for li in lines])
    _close_boxes(got, np.floor(np.asarray(want.boxes)))
