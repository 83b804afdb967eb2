"""The port's weight-file loaders (``FaceEngine.load_weights`` /
``save_weights`` / ``load_embed_weights`` / ``load_age_gender_weights``)
against the JAX package (CPU).

The golden checkpoints are read by the JAX package, bridged into port state
dicts and written as torch ``.pt`` files, which the port's loaders and the
JAX engine's ``.pt`` importer both read. Engines are built once a module
and reloaded between tests.
"""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, blazeface_state_dict, mobile_facenet_state_dict,
    yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
DETECTORS = ("yolov5s", "yolov5n", "blazeface-front", "blazeface-back")


def _load(name):
    """A golden checkpoint as float32 numpy arrays (golden_embed_ckpt and
    golden_ag_ckpt are stored in bf16: both packages get the f32 cast)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The golden checkpoints as port state dicts in .pt files:
    {name: path}."""
    d = tmp_path_factory.mktemp("weights")
    sds = {}
    for arch in ("yolov5s", "yolov5n"):
        sds[arch] = yolov5_face_state_dict(_load(f"golden_{arch}_ckpt"), arch)
    for name, ckpt in (("blazeface-front", "golden_blaze_ckpt"),
                       ("blazeface-back", "golden_blaze_back_ckpt")):
        sds[name] = blazeface_state_dict(_load(ckpt),
                                         name == "blazeface-back")
    sds["embed"] = mobile_facenet_state_dict(_load("golden_embed_ckpt"))
    ag = _load("golden_ag_ckpt")
    sds["ag"] = age_gender_state_dict(ag["age"], ag["gender"])
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(d / f"{name}.pt")
        torch.save(sd, paths[name])
    return paths


@pytest.fixture(scope="module")
def engines():
    """One port engine a detector (det_thres 0.5), built once."""
    return {name: FaceEngine(EngineConfig(detector=name, det_thres=0.5),
                             device="cpu") for name in DETECTORS}


@pytest.fixture(scope="module")
def full_engine():
    return FaceEngine(EngineConfig(detector="yolov5n",
                                   embedder="mobile_facenet",
                                   with_age_gender=True), device="cpu")


@pytest.mark.parametrize("name", DETECTORS)
def test_save_then_load_weights_round_trip(weights, engines, tmp_path,
                                            name):
    """load_weights then save_weights writes the file's tensors back, and
    a fresh net (other seed) loads them all."""
    eng = engines[name]
    eng.load_weights(weights[name])
    path = str(tmp_path / "saved.pth")
    eng.save_weights(path)
    saved, ref = torch.load(path), torch.load(weights[name])
    assert saved.keys() == eng.net.state_dict().keys()
    assert all(torch.equal(saved[k], ref[k]) for k in ref)
    other = FaceEngine(EngineConfig(detector=name, seed=7), device="cpu")
    other.load_weights(path)
    got = other.net.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_load_weights_unwraps_a_reference_checkpoint(weights, engines,
                                                     tmp_path):
    """A reference-style file: the state dict under "model", saved from a
    DataParallel module ("module." prefix), with the Detect layer's anchor
    buffers."""
    sd = torch.load(weights["yolov5n"])
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.model.24.anchors"] = torch.zeros(3, 3, 2)
    ref["module.model.24.anchor_grid"] = torch.zeros(3, 1, 3, 1, 1, 2)
    path = str(tmp_path / "ref.pt")
    torch.save({"model": ref, "epoch": 3}, path)
    eng = engines["yolov5n"]
    eng.net.load_state_dict({k: torch.zeros_like(v) for k, v in sd.items()})
    eng.load_weights(path)
    got = eng.net.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


@pytest.mark.parametrize("name", ["blazeface-front", "blazeface-back"])
def test_blazeface_pt_detects_what_jax_detects(weights, engines, name):
    """The JAX engine and the port's read the same .pt: same detections on
    the golden image (boxes within 1 px, scores to 1e-4)."""
    img = cv2.imread(IMG)
    jeng = JFaceEngine(JEngineConfig(detector=name, det_thres=0.5))
    jeng.load_weights(weights[name])
    teng = engines[name]
    teng.load_weights(weights[name])
    ref, got = jeng.detect_image(img), teng.detect_image(img)
    assert len(got) == len(ref) >= 1
    np.testing.assert_allclose(got.boxes, ref.boxes, atol=1.0, rtol=0)
    np.testing.assert_allclose(got.bbox_confs, ref.bbox_confs, atol=1e-4,
                               rtol=0)


def test_load_embed_and_age_gender_weights(weights, full_engine):
    """load_embed_weights reads a MobileFaceNet .pt (the JAX engine reads
    the same file: embeddings to 1e-5); load_age_gender_weights reads the
    heads'."""
    eng = full_engine
    eng.load_embed_weights(weights["embed"])
    eng.load_age_gender_weights(weights["ag"])
    for net, key in ((eng.embed_net, "embed"), (eng.ag_net, "ag")):
        sd = torch.load(weights[key])
        got = net.state_dict()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    faces = np.random.RandomState(3).randint(0, 256, (2, 112, 112, 3),
                                             np.uint8)
    jeng = JFaceEngine(JEngineConfig(detector="yolov5n",
                                     embedder="mobile_facenet"))
    jeng.load_embed_weights(weights["embed"])
    np.testing.assert_allclose(eng.embed_crops(faces),
                               np.asarray(jeng.embed_crops(faces)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("ext", [".caffemodel", ".pb", ".xml", ""])
def test_unsupported_weight_files_raise(full_engine, tmp_path, ext):
    """Orbax checkpoints raise from every loader. A .caffemodel, .pb or
    OpenVINO .xml is read against a net: the embedder and age/gender
    loaders refuse it as a state dict, naming ``load_weights``; a yolov5
    detector has no .pb importer, and an unreadable caffemodel or IR
    raises as one."""
    path = tmp_path / f"weights{ext}"
    path.write_bytes(b"\x00")
    eng = full_engine
    if ext in (".caffemodel", ".pb", ".xml"):
        with pytest.raises(ValueError, match={
                ".caffemodel": "not a valid caffemodel",
                ".pb": "no .pb importer",
                ".xml": "not a valid OpenVINO IR"}[ext]):
            eng.load_weights(str(path))
        for load in (eng.load_embed_weights, eng.load_age_gender_weights):
            with pytest.raises(ValueError, match="load_weights"):
                load(str(path))
        return
    for load in (eng.load_weights, eng.load_embed_weights,
                 eng.load_age_gender_weights):
        with pytest.raises(ValueError, match="not supported yet"):
            load(str(path))
