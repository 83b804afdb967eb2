"""``card_weights/``, the trained nets the card runs (CPU): each ``.pt``
equals the bridge's conversion of its orbax checkpoint tensor for tensor,
``expected.json`` holds what the JAX CPU engines give now, and the port,
loading the ``.pt`` files on the CPU through ``eval/card_weights.py``,
passes every gate and matches the JAX detections there.

``tools/make_card_weights.py`` writes the folder; its functions compute
what is compared here. The port's ``quantize_golden`` calibration of the
golden yolov5n gives the JAX CPU scales stored in ``expected.json``. The JAX numbers are compared to the stored ones
with the tolerances of a rerun on another CPU (XLA may vectorize the sums
in another order): the same counts and gate verdicts, boxes (rounded
pixels) within 1 px, scores within 1e-4, embeddings at cosine >= 1 -
1e-6. The port's check is ``eval.card_weights.check_detector``: the gate
of each net's JAX test where the JAX engine passes it, and its boxes
within ``max_px`` of JAX's at each of the gate's thresholds (int8: the
same counts only).
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


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_card_weights", os.path.join(ROOT, "tools",
                                          "make_card_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
# the first golden nets; the regate's other rows are held in
# tests/test_torch_card_weights_families.py and _jax.py
NETS = sorted(TOOL.BASE_NETS)
FILES = sorted({e["file"] for e in EXPECTED["nets"].values()}
               | {e["file"] for e in EXPECTED["embedders"].values()}
               | set(TOOL.copied_files()))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work (the tier-1 run
    puts several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tool():
    return TOOL


@pytest.fixture(scope="module")
def frames():
    data = os.path.join(ROOT, "tests", "data")
    pos = cv2.imread(os.path.join(data, "test2_faces_3.jpg"))
    neg = cv2.imread(os.path.join(data, "test1_faces_0.jpg"))
    return pos, cv2.resize(neg, (pos.shape[1], pos.shape[0]))


def test_folder_lists_its_files_and_fits():
    """Every file expected.json names is there (an IR with its .bin),
    the golden images are copies of tests/data's, and the folder stays
    under 180 MB, so a checkout of the repo stays small."""
    names = set(os.listdir(CW.CARD_WEIGHTS))
    assert set(FILES) | {CW.EXPECTED, CW.POS_IMAGE, CW.NEG_IMAGE} == names
    for img in (CW.POS_IMAGE, CW.NEG_IMAGE):
        with open(os.path.join(ROOT, "tests", "data", img), "rb") as a, \
                open(CW.CARD_WEIGHTS / img, "rb") as b:
            assert a.read() == b.read()
    assert sum((CW.CARD_WEIGHTS / n).stat().st_size for n in names) < 180e6
    np.testing.assert_array_equal(np.asarray(EXPECTED["golden_boxes"],
                                             np.float32), GOLDEN_BOXES_3)


def test_weight_files_equal_the_bridge(tool):
    """Each .pt holds the bridge's conversion of its checkpoint, tensor
    for tensor (int8 codes and static scales included)."""
    for file, sd in tool.port_files(NETS, ["mobile_facenet"]).items():
        got = torch.load(CW.CARD_WEIGHTS / file, map_location="cpu")
        assert sorted(got) == sorted(sd), file
        for k, v in sd.items():
            assert got[k].dtype == v.dtype, (file, k)
            assert torch.equal(got[k], v), (file, k)


@pytest.mark.parametrize("name", NETS)
def test_expected_detections_are_the_jax_engines(tool, frames, name):
    ckpt, file, settings, gate, max_px = tool.NETS[name]
    stored = EXPECTED["nets"][name]
    assert (stored["checkpoint"], stored["file"], stored["gate"],
            stored["max_px"]) == (ckpt, file, gate, max_px)
    assert stored["detector"] == settings["detector"]
    now = tool.jax_runs(tool.jax_engine(settings, ckpt), gate, *frames)
    assert now["gate_passes"] == stored["jax"]["gate_passes"]
    assert now["ok"] == stored["jax"]["ok"]
    for a, b in zip(now["runs"], stored["jax"]["runs"]):
        assert a["thres"] == pytest.approx(b["thres"], abs=1e-12)
        for tag in ("pos", "neg"):
            assert len(a[tag]) == len(b[tag]), (a["thres"], tag)
            np.testing.assert_allclose(np.reshape(a[tag], (-1, 4)),
                                       np.reshape(b[tag], (-1, 4)),
                                       atol=1.0, rtol=0)
            np.testing.assert_allclose(a[tag + "_conf"], b[tag + "_conf"],
                                       atol=1e-4, rtol=0)


def test_expected_embeddings_are_the_jax_engines(tool, frames):
    stored = EXPECTED["embedders"]["mobile_facenet"]
    now = tool._jax_embeddings(frames[0], GOLDEN_BOXES_3)
    assert CW.cosines(now, stored["jax"]["embeddings"]).min() >= 1 - 1e-6


@pytest.fixture(scope="module")
def images():
    return CW.golden_images()


@pytest.mark.parametrize("name", NETS)
def test_port_passes_the_gates_from_the_files(images, name):
    """The port on the CPU, from the .pt files: each gate and JAX's boxes
    (``check_detector`` raises naming what fails)."""
    entry = EXPECTED["nets"][name]
    eng = CW.build_engine(entry, "cpu")
    golden = np.asarray(EXPECTED["golden_boxes"], np.float32)
    s = CW.check_detector(name, entry, eng, *images, golden)
    assert s["n_pos"] == 3 and s["n_neg"] == 0


def test_port_embeds_the_pinned_crops_from_the_file(images):
    entry = EXPECTED["embedders"]["mobile_facenet"]
    eng = CW.build_engine(entry, "cpu")
    s = CW.check_embedder("mobile_facenet", entry, eng, images[0])
    assert min(s["cosines"]) >= entry["cos_min"]


def test_port_decodes_the_golden_images_as_cv2(frames, images):
    """The card's inputs: the port's codec and host_resize give cv2's
    pixels, so the gate sees the frames JAX saw."""
    for a, b in zip(images, frames):
        np.testing.assert_array_equal(a, b)


def test_port_quantizer_calibrates_the_stored_scales(tmp_path):
    """The port's ``quantize_golden`` calibration of ``yolov5n.pt`` on the
    CPU (32 composites, seed 515) gives the stored JAX CPU scales within
    ``JAX_SCALE_RTOL`` and the committed int8 file's within
    ``COMMITTED_SCALE_RTOL``; its codes, weight scales and biases are the
    committed file's."""
    from face_detection_and_recognition_tpu_torch.cli import \
        quantize_golden as Q

    q = EXPECTED["quantize"]["yolov5n"]
    out = str(tmp_path / "int8.pt")
    scales = Q.quantize_checkpoint(
        str(CW.CARD_WEIGHTS / q["file"]), out, q["arch"], q["size"],
        str(tmp_path), n_calib=q["n_calib"], batch=q["batch"],
        seed=q["seed"], device="cpu", log=lambda s: None)
    diffs = CW.scale_differences(scales, q)
    assert diffs["jax_cpu"] <= CW.JAX_SCALE_RTOL
    got = torch.load(out)
    ref = torch.load(CW.CARD_WEIGHTS / q["int8_file"])
    assert set(got) == set(ref)
    for k in ref:
        if not k.endswith(".ascale"):
            assert torch.equal(got[k], ref[k]), k
