"""The port's protobuf weight readers (``utils/model_formats.py``) against
the JAX package's on the same bytes: caffemodels in the V2 and the legacy V1
encoding, frozen GraphDefs with packed, splat, half-precision and negative
integer tensors, and garbage; the age/gender heads loaded from the
reference's two CaffeNet caffemodels (written from ``golden_ag_ckpt``) by
``load_age_gender_weights``, giving the JAX engine's probabilities; the
refusals of ``read_state_dict``."""
import os
import struct

import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.utils import model_formats as JMF
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine, read_state_dict)
from face_detection_and_recognition_tpu_torch.utils import model_formats as TMF
from face_detection_and_recognition_tpu_torch.utils import weights as TW

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.05).astype(np.float32)


def _same_layers(got, ref):
    assert [(x.name, x.type, len(x.blobs)) for x in got] == \
        [(x.name, x.type, len(x.blobs)) for x in ref]
    for a, b in zip(got, ref):
        for x, y in zip(a.blobs, b.blobs):
            assert x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("v1", [False, True], ids=["V2", "V1"])
def test_caffemodel_reader_matches_jax(v1):
    rng = np.random.RandomState(0)
    layers = [JMF.CaffeLayer("conv1", "Convolution",
                             [_rand(rng, 8, 3, 3, 3), _rand(rng, 8)]),
              JMF.CaffeLayer("relu1", "ReLU", []),
              JMF.CaffeLayer("bn1", "BatchNorm",
                             [_rand(rng, 8), _rand(rng, 8) + 1.0,
                              np.ones(1, np.float32)]),
              JMF.CaffeLayer("pool1", "Pooling", []),
              JMF.CaffeLayer("fc", "InnerProduct",
                             [_rand(rng, 4, 32), _rand(rng, 4)])]
    data = JMF.write_caffemodel(layers, v1=v1)
    _same_layers(TMF.read_caffemodel(data), JMF.read_caffemodel(data))


def test_caffemodel_legacy_blob_dims_and_unpacked_floats():
    """A V1 blob with the legacy num/channels/height/width fields and its
    floats written one by one (unpacked), as old caffe wrote them."""
    blob = (JMF._varint_field(1, 2) + JMF._varint_field(2, 3)
            + JMF._varint_field(3, 1) + JMF._varint_field(4, 2)
            + b"".join(JMF._field(5, JMF._I32, struct.pack("<f", v))
                       for v in np.arange(12, dtype=np.float32) * 0.5))
    layer = (JMF._len_field(4, b"ip") + JMF._varint_field(5, 14)
             + JMF._len_field(6, blob))
    data = JMF._len_field(1, b"net") + JMF._len_field(2, layer)
    got, ref = TMF.read_caffemodel(data), JMF.read_caffemodel(data)
    _same_layers(got, ref)
    assert got[0].type == "InnerProduct" and got[0].blobs[0].shape == \
        (2, 3, 1, 2)


def _tensor_node(name, dtype_code, shape, **fields):
    """A Const NodeDef whose TensorProto carries ``fields`` (number ->
    payload bytes) instead of tensor_content."""
    shape_payload = b"".join(JMF._len_field(2, JMF._varint_field(1, d))
                             for d in shape)
    tensor = JMF._varint_field(1, dtype_code) + JMF._len_field(2,
                                                               shape_payload)
    for field, payload in fields.items():
        tensor += payload
    attr = JMF._len_field(1, b"value") + JMF._len_field(
        2, JMF._len_field(8, tensor))
    node = (JMF._len_field(1, name.encode()) + JMF._len_field(2, b"Const")
            + JMF._len_field(5, attr))
    return JMF._len_field(1, node)


def test_graphdef_reader_matches_jax():
    """tensor_content of several dtypes (the JAX writer), and by hand:
    half_val bit patterns, negative int_val / int64_val varints, a packed
    float_val splat over a shape, and a non-Const node."""
    rng = np.random.RandomState(1)
    consts = [JMF.GraphConst("w", _rand(rng, 3, 3, 3, 4)),
              JMF.GraphConst("ids", np.asarray([-3, 0, 7], np.int32)),
              JMF.GraphConst("big", np.asarray([-(2 ** 40), 5], np.int64)),
              JMF.GraphConst("q", np.arange(6, dtype=np.uint8))]
    data = bytearray(JMF.write_graphdef(consts))
    halves = np.asarray([1.5, -2.25, 65504.0], np.float16).view(np.uint16)
    data += _tensor_node("half", 19, [3], h=JMF._len_field(
        13, b"".join(JMF._write_varint(int(v)) for v in halves)))
    data += _tensor_node("neg32", 3, [2], i=JMF._len_field(
        7, JMF._write_varint(-5) + JMF._write_varint(9)))
    data += _tensor_node("neg64", 9, [1], i=JMF._varint_field(
        10, -123456789012 & ((1 << 64) - 1)))
    data += _tensor_node("splat", 1, [2, 3], f=JMF._len_field(
        5, struct.pack("<f", 0.25)))
    data += JMF._len_field(1, JMF._len_field(1, b"add")
                           + JMF._len_field(2, b"Add"))
    data = bytes(data)
    got, ref = TMF.read_tf_graphdef(data), JMF.read_tf_graphdef(data)
    assert [c.name for c in got] == [c.name for c in ref] == [
        "w", "ids", "big", "q", "half", "neg32", "neg64", "splat"]
    for a, b in zip(got, ref):
        assert a.value.dtype == b.value.dtype, a.name
        np.testing.assert_array_equal(a.value, b.value, err_msg=a.name)
    by = {c.name: c.value for c in got}
    assert by["neg32"].tolist() == [-5, 9]
    assert by["neg64"].tolist() == [-123456789012]
    assert by["half"].tolist() == [1.5, -2.25, 65504.0]
    assert by["splat"].shape == (2, 3)


def test_readers_reject_garbage_like_jax():
    rng = np.random.RandomState(2)
    for _ in range(30):
        blob = rng.bytes(rng.randint(1, 200))
        for tfn, jfn in ((TMF.read_caffemodel, JMF.read_caffemodel),
                         (TMF.read_tf_graphdef, JMF.read_tf_graphdef)):
            outs = []
            for fn in (tfn, jfn):
                try:
                    outs.append(("ok", len(fn(blob))))
                except ValueError:
                    outs.append(("error", None))
            assert outs[0] == outs[1]


def _caffenet_layers(tree):
    """A flax ``CaffeNetHead`` tree as the reference's CaffeNet caffemodel:
    OIHW kernels, fc6 over conv3's (C, H, W) flatten, [out, in] fc
    weights, with the blob-less ReLU / Pooling / LRN layers between."""
    p = tree["params"]
    layers = []
    for i in range(3):
        conv = p[f"Conv_{i}"]
        layers += [JMF.CaffeLayer(f"conv{i + 1}", "Convolution", [
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1),
            np.asarray(conv["bias"], np.float32)]),
            JMF.CaffeLayer(f"relu{i + 1}", "ReLU", []),
            JMF.CaffeLayer(f"pool{i + 1}", "Pooling", [])]
        if i < 2:
            layers.append(JMF.CaffeLayer(f"norm{i + 1}", "LRN", []))
    w6 = np.asarray(p["Dense_0"]["kernel"], np.float32)      # [H*W*C, out]
    w6 = w6.reshape(7, 7, 384, -1).transpose(3, 2, 0, 1).reshape(
        w6.shape[1], -1)
    for i, w in enumerate((w6, np.asarray(p["Dense_1"]["kernel"]).T,
                           np.asarray(p["Dense_2"]["kernel"]).T)):
        layers.append(JMF.CaffeLayer(f"fc{i + 6}", "InnerProduct", [
            np.ascontiguousarray(w, np.float32),
            np.asarray(p[f"Dense_{i}"]["bias"], np.float32)]))
    return layers


def test_age_gender_caffemodels_load_like_jax(tmp_path):
    """age_net / gender_net caffemodels written from golden_ag_ckpt (f32),
    loaded by both engines' ``load_age_gender_weights(age_caffemodel=...,
    gender_caffemodel=...)``: the same probabilities on the same crops."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(
                                      DATA, "golden_ag_ckpt")))
    paths = {}
    for head in ("age", "gender"):
        paths[head] = str(tmp_path / f"{head}_net.caffemodel")
        with open(paths[head], "wb") as f:
            f.write(JMF.write_caffemodel(_caffenet_layers(tree[head])))
    # the cascade: the cheapest detector for the JAX engine to build
    jeng = JFaceEngine(JEngineConfig(detector="mtcnn", with_age_gender=True))
    jeng.load_age_gender_weights(age_caffemodel=paths["age"],
                                 gender_caffemodel=paths["gender"])
    eng = FaceEngine(EngineConfig(detector="mtcnn", with_age_gender=True),
                     device="cpu")
    eng.load_age_gender_weights(age_caffemodel=paths["age"],
                                gender_caffemodel=paths["gender"])
    faces = np.random.RandomState(3).randint(0, 256, (3, 150, 130, 3),
                                             np.uint8)
    got = eng.classify_crops_age_gender(faces)
    ref = jeng.classify_crops_age_gender(faces)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-4)
    # the same weights as the bridge's from the checkpoint itself
    want = TW.age_gender_state_dict(tree["age"], tree["gender"])
    for k, v in eng.ag_net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=0, err_msg=k)
    with pytest.raises(ValueError, match="output classes"):
        eng.load_age_gender_weights(age_caffemodel=paths["gender"],
                                    gender_caffemodel=paths["gender"])


@pytest.mark.parametrize("ext", [".caffemodel", ".pb", ".xml", ""])
def test_read_state_dict_refusals(tmp_path, ext):
    path = tmp_path / f"weights{ext}"
    path.write_bytes(b"\x00")
    match = {".caffemodel": "load_weights", ".pb": "load_weights",
             ".xml": "OpenVINO", "": "orbax"}[ext]
    with pytest.raises(ValueError, match=match):
        read_state_dict(str(path))
    eng = FaceEngine(EngineConfig(detector="yolov5n"), device="cpu")
    if ext == ".pb":  # no GraphDef importer for a yolov5 detector
        with pytest.raises(ValueError, match="no .pb importer"):
            eng.load_weights(str(path))
