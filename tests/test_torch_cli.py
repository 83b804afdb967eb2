"""The port's ``detect_face`` CLI against the JAX package (CPU).

The golden checkpoints are read by the JAX package, bridged into port state
dicts and written as torch ``.pt`` files: the port's CLI reads them with
``--ckpt``, and so does the JAX CLI (its ``.pt`` importer maps the
reference's torch names), which shows the port's state-dict names are the
reference's. The golden gate of ``tests/test_golden_accuracy.py`` then runs
on the port's printed boxes. Each distinct CLI run is made once and shared
by the tests that read it (``cli``).
"""
import contextlib
import io
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.cli.detect_face import main as jmain
from face_detection_and_recognition_tpu.core.engine import \
    EngineConfig as JEngineConfig
from face_detection_and_recognition_tpu.core.engine import \
    FaceEngine as JFaceEngine
from face_detection_and_recognition_tpu.train.golden import (GOLDEN_BOXES_3,
                                                             match_golden)
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.cli.detect_face import main
from face_detection_and_recognition_tpu_torch.models import registry
from face_detection_and_recognition_tpu_torch.utils import native as N
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, mobile_facenet_state_dict, yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")


def _load(name):
    """A golden checkpoint as float32 numpy arrays (golden_embed_ckpt and
    golden_ag_ckpt are stored in bf16: both packages get the f32 cast)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Port state dicts of the golden checkpoints, each written as .pt:
    {name: (variables, path)}."""
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for arch in ("yolov5s", "yolov5n"):
        v = _load(f"golden_{arch}_ckpt")
        out[arch] = (v, yolov5_face_state_dict(v, arch))
    v = _load("golden_embed_ckpt")
    out["embed"] = (v, mobile_facenet_state_dict(v))
    v = _load("golden_ag_ckpt")
    out["ag"] = (v, age_gender_state_dict(v["age"], v["gender"]))
    paths = {}
    for name, (v, sd) in out.items():
        paths[name] = str(d / f"{name}.pt")
        torch.save(sd, paths[name])
    return {name: (out[name][0], paths[name]) for name in out}


@pytest.fixture(scope="module")
def cli(weights, tmp_path_factory):
    """run(arch, *flags, jax=False) -> (rc, stdout, output image path): the
    port's (or the JAX package's) CLI on the golden image with the golden
    .pt of ``arch`` on the CPU, run once for each distinct call."""
    d = tmp_path_factory.mktemp("cli")
    runs = {}

    def run(arch, *flags, jax=False):
        key = (arch, flags, jax)
        if key not in runs:
            out = str(d / f"out{len(runs)}.jpg")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = (jmain if jax else main)(
                    ["-i", IMG, "--md", arch, "--ckpt", weights[arch][1],
                     "-d", "cpu", "--no-display", "-o", out, *flags])
            runs[key] = (rc, buf.getvalue(), out)
        return runs[key]

    return run


def _printed(out):
    lines = out.strip().splitlines()
    boxes = np.array(
        [[float(v) for v in li.strip().split()[0].strip("[]").split(",")]
         for li in lines if li.strip().startswith("[")], np.float32)
    rest = [li.strip().split(maxsplit=1)[1] for li in lines
            if li.strip().startswith("[")]
    return lines, boxes.reshape(-1, 4), rest


@pytest.mark.parametrize("dt_args", [["--dt", "0.5"], []],
                         ids=["reference-bar-0.5", "cli-default-0.70"])
@pytest.mark.parametrize("arch", ["yolov5s", "yolov5n"])
def test_port_cli_passes_golden_gate(cli, arch, dt_args):
    """The gate of tests/test_golden_accuracy.py:73 on the port's CLI."""
    rc, text, out = cli(arch, *dt_args)
    assert rc == 0
    drawn = N.read_image_bgr(out)
    assert drawn is not None and drawn.shape == cv2.imread(IMG).shape
    assert cv2.imread(out) is not None
    lines, boxes, _ = _printed(text)
    assert any(li.strip() == "3 face(s)" for li in lines), lines
    assert boxes.shape == (3, 4), lines
    ious = match_golden(boxes, GOLDEN_BOXES_3)
    assert all(i >= 0.5 for i in ious), ious


@pytest.mark.parametrize("arch", ["yolov5s", "yolov5n"])
def test_port_cli_prints_what_the_jax_cli_prints(cli, arch):
    """The JAX CLI reads the same .pt file: the same faces, within 1 px
    (rounded pixel boxes: an f32 difference can flip a .5 rounding), and
    confidences to 1e-3 (printed with 3 decimals)."""
    (rc, port_text, _), (jrc, jax_text, _) = \
        cli(arch, "--dt", "0.5"), cli(arch, "--dt", "0.5", jax=True)
    assert rc == jrc == 0
    port_lines, port_boxes, port_rest = _printed(port_text)
    jax_lines, jax_boxes, jax_rest = _printed(jax_text)
    assert port_lines[0] == jax_lines[0]
    np.testing.assert_allclose(port_boxes, jax_boxes, atol=1.0, rtol=0)
    port_conf = [float(r.split("=")[1]) for r in port_rest]
    jax_conf = [float(r.split("=")[1]) for r in jax_rest]
    np.testing.assert_allclose(port_conf, jax_conf, atol=1e-3, rtol=0)


def test_port_cli_rect_matches_square(cli):
    """yolov5s: the rect canvas finds the golden faces the square one finds
    (tests/test_golden_accuracy.py:331)."""
    _, b_sq, _ = _printed(cli("yolov5s", "--dt", "0.5")[1])
    rc, text, _ = cli("yolov5s", "--dt", "0.5", "--rect")
    assert rc == 0
    _, b_rc, _ = _printed(text)
    assert len(b_rc) == 3 == len(b_sq)
    assert all(iou >= 0.5 for iou in match_golden(b_rc, GOLDEN_BOXES_3))
    assert all(iou >= 0.8 for iou in match_golden(b_rc, b_sq))


def test_port_cli_age_gender_labels_equal_jax(weights, capsys):
    """--age-gender on the yolov5n cascade with the golden heads: the labels
    the JAX engine's detect_age_gender attaches, string for string, and the
    reference's golden genders and ages."""
    rc = main(["-i", IMG, "--md", "yolov5n", "--ckpt", weights["yolov5n"][1],
               "--age-gender", "--ag-ckpt", weights["ag"][1],
               "--embedder", "mobile_facenet",
               "--embed-ckpt", weights["embed"][1],
               "-d", "cpu", "--no-display", "--dt", "0.5"])
    assert rc == 0
    lines, boxes, rest = _printed(capsys.readouterr().out)
    assert boxes.shape == (3, 4), lines
    assert all(r.endswith(" emb[512d]") for r in rest), rest
    labels = [r.split()[1] for r in rest]
    jeng = JFaceEngine(JEngineConfig(detector="yolov5n", det_thres=0.5,
                                     with_age_gender=True))
    jeng.variables = weights["yolov5n"][0]
    ag = weights["ag"][0]
    jeng.ag_vars = (ag["age"], ag["gender"])
    ref = jeng.detect_age_gender(cv2.imread(IMG))
    np.testing.assert_allclose(boxes, ref.boxes, atol=1.0, rtol=0)
    assert labels == list(ref.bbox_labels)
    assert all(lbl.startswith("Male:") for lbl in labels), labels


def test_port_cli_refuses_what_it_cannot_do(capsys, tmp_path):
    assert main(["-i", IMG, "--md", "nope", "-d", "cpu",
                 "--no-display"]) == 2
    err = capsys.readouterr().err
    assert "unknown model 'nope'" in err
    assert ", ".join(registry.available()) in err
    assert "yolov5s" in registry.available()
    assert main(["-i", "notes.txt", "-d", "cpu", "--no-display"]) == 2
    assert "cannot determine input type" in capsys.readouterr().err
    for src in ("clip.mp4", "0"):
        assert main(["-i", src, "-d", "cpu", "--no-display"]) == 2
        assert "no video or camera decoder" in capsys.readouterr().err
    assert main(["-i", IMG, "-d", "cpu"]) == 2
    assert "no display window" in capsys.readouterr().err
    png = str(tmp_path / "a.png")
    cv2.imwrite(png, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="only JPEG"):
        main(["-i", png, "-d", "cpu", "--no-display", "--md", "yolov5n"])
