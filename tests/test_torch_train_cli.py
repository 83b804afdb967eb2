"""The port's training CLIs (``cli/train_golden.py``,
``cli/train_detector.py``, ``cli/quantize_golden.py``) against the JAX
package's, on the CPU.

Each CLI takes the JAX CLI's flags (the same option strings, destinations
and defaults; ``quantize_golden``'s checkpoint paths default to ``.pt``
files) and ``-d/--device``; ``--export-caffemodel`` / ``--export-ir`` raise
naming ROADMAP A12b. ``train_detector -d cpu`` trains on a tiny WIDER tree
and writes a ``.pt`` an engine loads. ``quantize_checkpoint`` on the golden
yolov5n (``card_weights/yolov5n.pt``) with two calibration composites gives
JAX ``quantize_checkpoint``'s int8 codes, weight scales and biases exactly,
and its activation scales within 1e-5 relative (each is an absmax of an
activation the two frameworks compute with sums in another order).
"""
import argparse
import os

import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu_torch.cli import quantize_golden as Q
from face_detection_and_recognition_tpu_torch.cli import train_detector as TD
from face_detection_and_recognition_tpu_torch.cli import train_golden as TG
from face_detection_and_recognition_tpu_torch.core.engine import (
    EngineConfig, FaceEngine)
from face_detection_and_recognition_tpu_torch.eval.card_weights import \
    CARD_WEIGHTS
from face_detection_and_recognition_tpu_torch.utils.native import \
    write_image_bgr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Parsed(Exception):
    pass


def _jax_parser(module, argv, monkeypatch):
    """The argparse parser the JAX CLI ``module`` builds in ``main``."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            module.main(argv)
    return e.value.args[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     a.required) for a in parser._actions
            if a.dest != "help"}


@pytest.mark.parametrize("name", ["train_golden", "train_detector",
                                  "quantize_golden"])
def test_flags_are_the_jax_clis(name, monkeypatch):
    import importlib

    jax_cli = importlib.import_module(
        f"face_detection_and_recognition_tpu.cli.{name}")
    ours = _options({"train_golden": TG, "train_detector": TD,
                     "quantize_golden": Q}[name].build_parser())
    theirs = _options(_jax_parser(jax_cli, [], monkeypatch))
    assert ours.pop("device")[0] == ("-d", "--device")
    assert set(ours) == set(theirs)
    for dest, spec in theirs.items():
        if name == "quantize_golden" and dest in ("ckpt", "out"):
            assert ours[dest][0] == spec[0]
            assert str(ours[dest][1]).endswith(".pt")
            continue
        assert ours[dest] == spec, dest


def test_export_flags_raise_naming_the_roadmap(tmp_path):
    for flag in ("--export-caffemodel", "--export-ir"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12b"):
            TG.main(["--out", str(tmp_path / "x.pt"), flag,
                     str(tmp_path / "y"), "-d", "cpu"])


def test_train_detector_on_a_tiny_wider_tree(tmp_path):
    rng = np.random.RandomState(0)
    img_dir = tmp_path / "images" / "0--Scene"
    img_dir.mkdir(parents=True)
    lines = []
    for i in range(4):
        write_image_bgr(str(img_dir / f"im{i}.jpg"),
                        rng.randint(0, 255, (90, 120, 3)).astype(np.uint8))
        lines.append(f"0--Scene/im{i}.jpg\n1\n30 20 40 50 0 0 0 0 0 0\n")
    (tmp_path / "gt.txt").write_text("".join(lines))
    out = str(tmp_path / "det.pt")
    rc = TD.main(["--ann", str(tmp_path / "gt.txt"), "--images",
                  str(tmp_path / "images"), "--arch", "yolov5n", "--size",
                  "64", "--batch", "2", "--steps", "2", "--max-targets", "4",
                  "--out", out, "--log-every", "1", "-d", "cpu"])
    assert rc == 0
    eng = FaceEngine(EngineConfig(detector="yolov5n", detector_overrides={
        "input_size": (64, 64)}), device="cpu")
    before = {k: v.clone() for k, v in eng.net.state_dict().items()}
    eng.load_weights(out)
    after = eng.net.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values()
               if v.dtype.is_floating_point)


def test_quantize_checkpoint_equals_jax(tmp_path):
    from face_detection_and_recognition_tpu.cli import quantize_golden as JQ
    from face_detection_and_recognition_tpu.utils.checkpoint import \
        load_variables
    from face_detection_and_recognition_tpu_torch.utils.weights import \
        yolov5_face_state_dict

    out = str(tmp_path / "int8.pt")
    scales = Q.quantize_checkpoint(str(CARD_WEIGHTS / "yolov5n.pt"), out,
                                   "yolov5n", 640, str(tmp_path / "pw"),
                                   n_calib=2, batch=2, device="cpu",
                                   log=lambda s: None)
    jout = str(tmp_path / "jax_int8")
    JQ.quantize_checkpoint(os.path.join(ROOT, "tests", "data",
                                        "golden_yolov5n_ckpt"), jout,
                           "yolov5n", 640, str(tmp_path / "jw"), n_calib=2,
                           batch=2, log=lambda s: None)
    ref = yolov5_face_state_dict(load_variables(jout), "yolov5n")
    got = torch.load(out)
    assert set(got) == set(ref)
    n_scales = 0
    for k, r in ref.items():
        if k.endswith(".ascale"):
            assert float(got[k]) == pytest.approx(float(r), rel=1e-5), k
            n_scales += 1
        else:
            assert torch.equal(got[k], r.to(got[k].dtype)), k
    assert n_scales == len(scales) == 82
    # the written file builds the static int8 engine
    eng = FaceEngine(EngineConfig(detector="yolov5n", detector_overrides={
        "input_size": (640, 640)}), device="cpu")
    eng.load_weights(out)
    assert eng.net.quantized == "static"
