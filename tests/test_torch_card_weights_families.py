"""``card_weights/``'s rows of the JAX regate beyond the first golden nets
(CPU): the yolov5 n6, official and crowded nets, BlazeFace back, the three
SSDs, res10-ssd and the OpenVINO nets as ``.pt`` files, the reference's
res10 ``.caffemodel`` and two OpenVINO IRs copied as they are, and the
reid embedder.

Each new ``.pt`` equals the bridge's conversion of its orbax checkpoint
tensor for tensor; each reference-format file is a byte copy of its
``tests/data`` file; the port, loading the folder on the CPU through
``eval/card_weights.py``, passes every row's gate and holds its boxes
within the row's ``max_px`` of the stored JAX CPU detections
(``check_detector``); a ``.caffemodel`` or IR row gives the detections of
the checkpoint row with the same weights, bit for bit, and so does JAX's
stored run; both embedders pass the 3-identity filter gate from their
files with JAX's accuracies and a margin within ``FILTER_MARGIN_TOL``.
The JAX side of these rows is rerun in
``tests/test_torch_card_weights_jax.py``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

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
ROWS = sorted(TOOL.REGATE_NETS)
NEW_FILES = sorted({f for _, f, _, _, _ in TOOL.REGATE_NETS.values()
                    if not TOOL.reference_format(f)}
                   - {f for _, f, _, _, _ in TOOL.BASE_NETS.values()})


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for this file's torch work (the tier-1 run
    puts several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    return CW.golden_images()


@pytest.fixture(scope="module")
def golden():
    return np.asarray(EXPECTED["golden_boxes"], np.float32)


def test_rows_mirror_the_tool():
    """expected.json holds every row of the tool, with its settings, gate
    and tolerance; each embedder with its filter gate's size."""
    assert set(EXPECTED["nets"]) == set(TOOL.NETS)
    for name, (ckpt, file, settings, gate, max_px) in TOOL.NETS.items():
        e = EXPECTED["nets"][name]
        assert (e["checkpoint"], e["file"], e["gate"], e["max_px"]) == \
            (ckpt, file, gate, max_px), name
        assert {k: e[k] for k in settings} == settings, name
    assert set(EXPECTED["embedders"]) == set(TOOL.EMBEDDERS)
    for name, (ckpt, file, size) in TOOL.EMBEDDERS.items():
        e = EXPECTED["embedders"][name]
        assert (e["checkpoint"], e["file"], e["filter_size"]) == \
            (ckpt, file, size), name


@pytest.mark.parametrize("file", NEW_FILES + ["reid_mnv2.pt"])
def test_family_weight_files_equal_the_bridge(file):
    """Each new .pt holds the bridge's conversion of its checkpoint,
    tensor for tensor."""
    nets = [n for n in ROWS if TOOL.REGATE_NETS[n][1] == file][:1]
    embedders = [n for n, e in TOOL.EMBEDDERS.items() if e[1] == file]
    sd = TOOL.port_files(nets, embedders)[file]
    got = torch.load(CW.CARD_WEIGHTS / file, map_location="cpu")
    assert sorted(got) == sorted(sd), file
    for k, v in sd.items():
        assert got[k].dtype == v.dtype, (file, k)
        assert torch.equal(got[k], v), (file, k)


@pytest.mark.parametrize("file", TOOL.copied_files())
def test_reference_files_are_copies(file):
    with open(os.path.join(ROOT, "tests", "data", file), "rb") as a, \
            open(CW.CARD_WEIGHTS / file, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ROWS)
def test_port_passes_the_regate_from_the_files(images, golden, name):
    """The port on the CPU, from the folder's files: each row's gate
    (where the JAX engine passes it: every row here) and JAX's boxes
    within the row's max_px (``check_detector`` raises naming what
    fails)."""
    entry = EXPECTED["nets"][name]
    assert entry["jax"]["gate_passes"], name
    eng = CW.build_engine(entry, "cpu")
    s = CW.check_detector(name, entry, eng, *images, golden)
    assert s["n_pos"] == 3 and s["n_neg"] == 0


@pytest.mark.parametrize("name", sorted(TOOL.SAME_WEIGHTS))
def test_reference_format_rows_equal_their_checkpoint_rows(images, name):
    """A .caffemodel or IR row gives its checkpoint row's detections bit
    for bit through the port, at each of the gate's thresholds on both
    images; JAX's stored runs of the two rows are equal too."""
    entry = EXPECTED["nets"][name]
    twin = EXPECTED["nets"][TOOL.SAME_WEIGHTS[name]]
    assert entry["gate"] == twin["gate"]
    a, b = CW.build_engine(entry, "cpu"), CW.build_engine(twin, "cpu")
    with torch.inference_mode():
        for t in CW.gate_thresholds(entry["gate"]):
            for img in images:
                x, y = a.detect_image(img, det_thres=t), \
                    b.detect_image(img, det_thres=t)
                np.testing.assert_array_equal(x.boxes, y.boxes)
                np.testing.assert_array_equal(x.bbox_confs, y.bbox_confs)
    for r, s in zip(entry["jax"]["runs"], twin["jax"]["runs"]):
        for tag in ("pos", "neg"):
            np.testing.assert_allclose(np.reshape(r[tag], (-1, 4)),
                                       np.reshape(s[tag], (-1, 4)),
                                       atol=1e-4, rtol=0)


def test_ir_rows_run_the_file_as_the_net():
    """An IR row's engine is openvino-ir with the folder's .xml as its
    net (the JAX regate's real-IR rows), at the IR's input size."""
    for name in ("ov-0204-ir", "ov-squeezenet-light-ir"):
        entry = EXPECTED["nets"][name]
        eng = CW.build_engine(entry, "cpu")
        assert eng.spec.name == "openvino-ir"
        assert CW.engine_overrides(entry, CW.CARD_WEIGHTS)["xml"] == \
            str(CW.CARD_WEIGHTS / entry["file"])
        twin = EXPECTED["nets"][TOOL.SAME_WEIGHTS[name]]
        assert eng.input_size == CW.build_engine(twin, "cpu").input_size


@pytest.mark.parametrize("name", sorted(TOOL.EMBEDDERS))
def test_port_embedders_pass_the_filter_gate_from_the_files(images, name):
    """Each embedder from its file: the pinned crops' embeddings at cosine
    >= 0.999 to JAX's, the 3-identity filter gate passed with JAX's
    accuracies and margin (``check_embedder``)."""
    entry = EXPECTED["embedders"][name]
    assert entry["jax"]["filter"]["ok"], name
    s = CW.check_embedder(name, entry, CW.build_engine(entry, "cpu"),
                          images[0])
    assert s["filter_ok"] and min(s["cosines"]) >= entry["cos_min"]
