"""The port's training CLIs (``cli/train_golden.py``,
``cli/train_detector.py``, ``cli/quantize_golden.py``,
``cli/train_arcface.py``, ``cli/train_golden_embed.py``,
``cli/train_golden_ag.py``, ``cli/train_golden_mtcnn.py``) against the JAX
package's, on the CPU.

Each CLI takes the JAX CLI's flags (the same option strings, destinations
and defaults; ``quantize_golden``'s checkpoint paths default to ``.pt``
files) and ``-d/--device``; ``--export-caffemodel`` / ``--export-ir`` are
refused for another arch, and for res10-ssd / ov-0204 write a
``.caffemodel`` / ``.xml`` that ``FaceEngine.load_weights`` reads into the
checkpoint's detections, bit for bit (the golden loop stubbed by one that
writes a seeded checkpoint and passes). ``train_detector -d cpu`` trains on
a tiny WIDER tree and writes a ``.pt`` an engine loads; ``train_arcface -d
cpu`` trains on a tiny identity tree and writes a ``.pt`` whose
``state_dict`` an engine's embed slot loads; ``train_golden_embed -d cpu``
runs two steps end to end; ``train_arcface --mesh -d cpu``, its devices
four repeated CPU entries, trains DP + TP and writes the same layout.
``quantize_checkpoint`` on the golden yolov5n
(``card_weights/yolov5n.pt``) with two calibration composites gives JAX
``quantize_checkpoint``'s int8 codes, weight scales and biases exactly, and
its activation scales within 1e-5 relative (each is an absmax of an
activation the two frameworks compute with sums in another order).
"""
import argparse
import os

import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu_torch.cli import quantize_golden as Q
from face_detection_and_recognition_tpu_torch.cli import train_arcface as TA
from face_detection_and_recognition_tpu_torch.cli import train_detector as TD
from face_detection_and_recognition_tpu_torch.cli import train_golden as TG
from face_detection_and_recognition_tpu_torch.cli import \
    train_golden_ag as TGA
from face_detection_and_recognition_tpu_torch.cli import \
    train_golden_embed as TGE
from face_detection_and_recognition_tpu_torch.cli import \
    train_golden_mtcnn as TGM
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


_CLIS = {"train_golden": TG, "train_detector": TD, "quantize_golden": Q,
         "train_arcface": TA, "train_golden_embed": TGE,
         "train_golden_ag": TGA, "train_golden_mtcnn": TGM}


@pytest.mark.parametrize("name", sorted(_CLIS))
def test_flags_are_the_jax_clis(name, monkeypatch):
    import importlib

    jax_cli = importlib.import_module(
        f"face_detection_and_recognition_tpu.cli.{name}")
    ours = _options(_CLIS[name].build_parser())
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
    """The export flags, which waited for the graph trainers, now refuse
    only an arch they do not apply to."""
    for flag, arch in (("--export-caffemodel", "yolov5n"),
                       ("--export-ir", "res10-ssd")):
        with pytest.raises(SystemExit):
            TG.main(["--out", str(tmp_path / "x.pt"), "--arch", arch, flag,
                     str(tmp_path / "y"), "-d", "cpu"])


@pytest.mark.parametrize("arch,size,flag,ext", [
    ("res10-ssd", 300, "--export-caffemodel", ".caffemodel"),
    ("ov-0204", 448, "--export-ir", ".xml")])
def test_export_flags_write_files_an_engine_loads(arch, size, flag, ext,
                                                  tmp_path, monkeypatch):
    from face_detection_and_recognition_tpu_torch.train import golden as G

    def passing_loop(ckpt_out, work_dir, arch, input_size, **kw):
        eng = G.golden_engine(arch, input_size, device="cpu")
        with torch.no_grad():
            for v in eng.net.parameters():
                v.mul_(1.01)
        eng.save_weights(ckpt_out)
        return {"ok": True, "reload_ok": True, "ious": [0.9] * 3,
                "steps": 1}

    monkeypatch.setattr(G, "train_golden", passing_loop)
    monkeypatch.setattr(G, "evaluate_holdout_ap",
                        lambda *a, **k: {"AP50": 0.0, "AP": 0.0, "AR": 0.0})
    out, exported = str(tmp_path / "ck.pt"), str(tmp_path / f"model{ext}")
    assert TG.main(["--out", out, "--arch", arch, "--size", str(size),
                    flag, exported, "-d", "cpu"]) == 0
    mem = FaceEngine(EngineConfig(detector=arch, det_thres=0.1),
                     device="cpu")
    mem.load_weights(out)
    eng = FaceEngine(EngineConfig(detector=arch, det_thres=0.1),
                     device="cpu")
    eng.load_weights(exported)
    img = G.imread(G.GOLDEN_IMG)
    np.testing.assert_array_equal(eng.detect_raw(img), mem.detect_raw(img))


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


def test_train_arcface_on_a_tiny_identity_tree(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    for c in range(2):
        d = tmp_path / "ids" / f"person{c}"
        d.mkdir(parents=True)
        for i in range(3):
            write_image_bgr(str(d / f"{i}.jpg"), rng.randint(
                0, 255, (60 + 7 * i, 50, 3)).astype(np.uint8))
    out = str(tmp_path / "arc.pt")
    assert TA.main(["-i", str(tmp_path / "ids"), "--batch", "2", "--steps",
                    "2", "--embedding-size", "512", "--out", out,
                    "--log-every", "1", "-d", "cpu"]) == 0
    ck = torch.load(out)
    assert ck["arcface_kernel"].shape == (512, 2)
    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="mobile_facenet"), device="cpu")
    eng.load_embed_state_dict(ck["state_dict"])
    emb = eng.embed_crops(rng.randint(0, 255, (2, 112, 112, 3))
                          .astype(np.uint8))
    assert emb.shape == (2, 512) and np.isfinite(emb).all()
    # --mesh over four devices (here repeated CPU entries standing in for
    # four cards): DP + TP on 2 x 2, the two classes one a "model" shard,
    # writes the same checkpoint layout, the kernel joined from its shards
    # (the step's values are held to the JAX step in f64 by
    # tests/test_torch_parallel_train.py: in f32 a 2-crop batch's
    # BatchNorm variance cancels to a few digits)
    from face_detection_and_recognition_tpu_torch.parallel import mesh as PM

    asked = []
    monkeypatch.setattr(PM, "mesh_devices", lambda device=None: (
        asked.append(device) or [torch.device("cpu")] * 4))
    sharded = str(tmp_path / "arc_mesh.pt")
    assert TA.main(["-i", str(tmp_path / "ids"), "--batch", "2", "--steps",
                    "2", "--embedding-size", "512", "--out", sharded,
                    "--log-every", "1", "--mesh", "-d", "cpu"]) == 0
    assert asked == ["cpu"]
    ms = torch.load(sharded)
    assert ms["arcface_kernel"].shape == (512, 2)
    assert torch.isfinite(ms["arcface_kernel"]).all()
    assert ms["state_dict"].keys() == ck["state_dict"].keys()
    moved = (ms["arcface_kernel"] - ck["arcface_kernel"]).abs().max()
    assert float(moved) < 0.05   # the same init, two close steps


def test_train_golden_embed_runs_end_to_end(tmp_path, capsys):
    out = str(tmp_path / "embed.pt")
    rc = TGE.main(["--out", out, "--batch", "6", "--steps", "2",
                   "--eval-every", "2", "--train-per-id", "4", "-d", "cpu"])
    assert rc in (0, 1)
    assert "golden-embed gate:" in capsys.readouterr().out
    assert os.path.exists(out)
    assert os.path.exists(os.path.join(str(tmp_path), "golden_meta.json"))
