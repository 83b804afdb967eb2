"""``expected.json``'s JAX numbers for the regate rows, rerun (CPU): one
net a family, since each JAX engine compiles its own programs.

The rows rerun: ``yolov5n-crowded`` (the yolov5-face family: n6, the
crowded n and s6 run the same decode), ``yolov5n-official`` (the official
head's own decode), ``blazeface-back``, ``ssd-squeezenet`` (the SSD
family's postprocess), ``res10-ssd-caffemodel`` (the Caffe graph
interpreter, through the reference file) and ``ov-squeezenet-light-ir``
(the IR interpreter, through the reference file); and the reid
embedder's embeddings and filter gate. The stored numbers are compared
with the tolerances of a rerun on another CPU (XLA may vectorize the
sums in another order), as ``tests/test_torch_card_weights.py`` does:
the same counts and gate verdicts, boxes within 1 px, scores within
1e-4, embeddings at cosine >= 1 - 1e-6, the filter gate's accuracies
equal and its margin within 1e-4.
"""
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.train.golden import GOLDEN_BOXES_3
from face_detection_and_recognition_tpu_torch.eval import card_weights as CW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = CW.load_expected()
RERUN = ("yolov5n-crowded", "yolov5n-official", "blazeface-back",
         "ssd-squeezenet", "res10-ssd-caffemodel", "ov-squeezenet-light-ir")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_card_weights", os.path.join(ROOT, "tools",
                                          "make_card_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def frames():
    data = os.path.join(ROOT, "tests", "data")
    pos = cv2.imread(os.path.join(data, "test2_faces_3.jpg"))
    neg = cv2.imread(os.path.join(data, "test1_faces_0.jpg"))
    return pos, cv2.resize(neg, (pos.shape[1], pos.shape[0]))


@pytest.mark.parametrize("name", RERUN)
def test_expected_regate_rows_are_the_jax_engines(tool, frames, name):
    stored = EXPECTED["nets"][name]
    now = tool.net_entry(name, *frames)
    assert {k: v for k, v in now.items() if k != "jax"} == \
        {k: v for k, v in stored.items() if k != "jax"}
    assert now["jax"]["gate_passes"] == stored["jax"]["gate_passes"]
    assert now["jax"]["ok"] == stored["jax"]["ok"]
    for a, b in zip(now["jax"]["runs"], stored["jax"]["runs"]):
        assert a["thres"] == pytest.approx(b["thres"], abs=1e-12)
        for tag in ("pos", "neg"):
            assert len(a[tag]) == len(b[tag]), (a["thres"], tag)
            np.testing.assert_allclose(np.reshape(a[tag], (-1, 4)),
                                       np.reshape(b[tag], (-1, 4)),
                                       atol=1.0, rtol=0)
            np.testing.assert_allclose(a[tag + "_conf"], b[tag + "_conf"],
                                       atol=1e-4, rtol=0)


def test_expected_reid_embeddings_and_filter_are_the_jax_engines(tool,
                                                                  frames):
    stored = EXPECTED["embedders"]["reid-mnv2"]
    eng = tool._jax_embed_engine("reid-mnv2")
    now = eng.embed_faces(frames[0], GOLDEN_BOXES_3)
    assert CW.cosines(now, stored["jax"]["embeddings"]).min() >= 1 - 1e-6
    gate = tool.jax_filter_gate(eng, stored["filter_size"])
    ref = stored["jax"]["filter"]
    assert (gate["ok"], gate["same_acc"], gate["cross_acc"]) == \
        (ref["ok"], ref["same_acc"], ref["cross_acc"])
    assert gate["margin"] == pytest.approx(ref["margin"], abs=1e-4)
