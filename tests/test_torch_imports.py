"""Import hygiene of the PyTorch port: it and ``chip_smoke.py`` load with
jax, flax, optax, orbax, cv2, PIL, grpc and h5py made unimportable (the gRPC
front door imports grpc inside its functions, the keras ``.h5`` reader
h5py inside its own), and pull in no module of the JAX package; its entry
points refuse to fall back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "grpc",
             "h5py"):
    sys.modules[name] = None  # any import of these now raises ImportError
import face_detection_and_recognition_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "face_detection_and_recognition_tpu"
                or m.startswith("face_detection_and_recognition_tpu."))
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("LEAKED", leaked)
"""


def test_port_imports_without_jax_cv2_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    # ops, models, core, utils, pipelines, cli, serving and their modules
    # were all imported
    n = int(out.stdout.split("MODULES ")[1].split()[0])
    assert n >= 64, out.stdout
    names = out.stdout.split("NAMES ")[1].split()
    for mod in ("ops.crop", "models.mobile_facenet", "models.age_gender",
                "models.embedders", "models.blazeface", "models.facenet",
                "models.ssd", "models.yolov5_face", "models.registry",
                "ops.nms", "ops.geometry", "utils.weights", "pipelines",
                "pipelines.similarity", "utils.native", "utils.files",
                "utils.parser", "utils.draw", "core.config", "core.inference",
                "cli.detect_face", "serving.batcher", "serving.service",
                "serving.http_server", "serving.grpc_server",
                "utils.logging_utils", "pipelines.dataset",
                "pipelines.extract_faces", "pipelines.extract_features",
                "pipelines.tracking", "pipelines.imdb_wiki",
                "cli.extract_faces", "cli.extract_features",
                "cli.extract_and_label", "cli.extract_imdb_wiki",
                "cli.filter_faces", "models.mtcnn",
                "utils.model_formats", "utils.caffe_graph",
                "utils.ir_graph", "models.caffe_ssd", "models.res10",
                "models.ov_graph", "models.ov_topologies",
                "ops.int8_conv", "utils.quantize", "utils.tensor_bundle",
                "eval", "eval.coco_eval", "cli.eval_wider",
                "eval.card_weights", "utils.trace_analysis",
                "utils.profiling", "train", "train.detection", "train.data",
                "train.device_loop", "train.golden", "train.blazeface",
                "train.ssd", "cli.train_golden", "cli.train_detector",
                "cli.quantize_golden", "train.arcface", "train.optim",
                "train.golden_embed", "train.golden_ag",
                "train.golden_mtcnn", "train.caffe_golden",
                "train.ov_golden", "cli.train_arcface",
                "cli.train_golden_embed", "cli.train_golden_ag",
                "cli.train_golden_mtcnn", "parallel", "parallel.mesh",
                "parallel.sharding", "parallel.collectives",
                "parallel.training", "parallel.mp_demo", "utils.export",
                "utils.video"):
        assert f"face_detection_and_recognition_tpu_torch.{mod}" in names


def test_make_mesh_raises_when_the_shape_does_not_fit_the_devices():
    """As the JAX ``make_mesh`` does: the axis sizes' product must be the
    device count (repeated ``"cpu"`` entries count one each)."""
    from face_detection_and_recognition_tpu_torch.parallel.mesh import \
        make_mesh

    with pytest.raises(ValueError, match="device count"):
        make_mesh(("data", "model"), (2, 2), ["cpu"] * 3)
    with pytest.raises(ValueError, match="device count"):
        make_mesh(("data",), (4,), ["cpu"] * 2)
    assert make_mesh(("data", "model"), (2, 2), ["cpu"] * 4).shape == {
        "data": 2, "model": 2}


def test_parallel_entry_points_raise_without_cuda(monkeypatch):
    """The mesh, the ``--mesh`` entries and ``mp_demo`` run on the card
    unless the caller names the CPU."""
    from face_detection_and_recognition_tpu_torch.parallel import \
        mp_demo as MP
    from face_detection_and_recognition_tpu_torch.parallel.mesh import (
        make_mesh, mesh_devices)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh(("data",)), lambda: mesh_devices(),
                 lambda: MP.run_local(1), lambda: MP.run_local(2, "ensemble"),
                 lambda: MP.main(["--procs", "1", "--pid", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert mesh_devices("cpu") == [torch.device("cpu")]


def test_engine_raises_without_cuda(monkeypatch):
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceEngine(EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceEngine(EngineConfig(), device="cuda")
    assert FaceEngine(EngineConfig(), device="cpu").device.type == "cpu"


def test_service_and_cli_raise_without_cuda(monkeypatch):
    from face_detection_and_recognition_tpu_torch.cli.detect_face import main
    from face_detection_and_recognition_tpu_torch.serving import (
        FaceService, ServiceConfig)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceService(ServiceConfig(detector="yolov5n", with_embedder=False,
                                  with_age_gender=False))
    img = os.path.join(REPO, "tests", "data", "test2_faces_3.jpg")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-i", img, "--md", "yolov5n", "--no-display"])


def test_similarity_entry_points_raise_without_cuda(monkeypatch):
    import numpy as np

    from face_detection_and_recognition_tpu_torch.pipelines import \
        similarity as S

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.eye(4, dtype=np.float32)
    refs = [S.ClassReference("a", e[0], 0.5)]
    for call in (lambda: S.topk_similar(e, e, k=2),
                 lambda: S.topk_similar(e, e, k=2, use_pallas=True),
                 lambda: S.filter_embeddings(e, refs),
                 lambda: S.SimilarFaceFilter(lambda p: e)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert S.topk_similar(e, e, k=2, device="cpu")[1].shape == (4, 2)


@pytest.mark.parametrize("cli", ["extract_faces", "extract_features",
                                 "extract_and_label", "extract_imdb_wiki",
                                 "filter_faces"])
def test_dataset_clis_raise_without_cuda_unless_cpu(monkeypatch, tmp_path,
                                                    cli):
    """Each dataset CLI builds its engine on the card by default: without
    CUDA it raises, and with the CPU flag it runs (on an empty tree)."""
    import importlib

    main = importlib.import_module(
        f"face_detection_and_recognition_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    data, out = str(tmp_path / "data"), str(tmp_path / "out")
    os.makedirs(data)
    if cli == "extract_imdb_wiki":
        import numpy as np
        from scipy.io import savemat

        empty = np.empty((1, 0))
        savemat(str(tmp_path / "w.mat"), {"wiki": {
            k: empty for k in ("full_path", "dob", "photo_taken", "gender",
                               "face_score", "second_face_score")}})
        argv = ["--mat", str(tmp_path / "w.mat"), "-i", data, "-o", out,
                "--md", "blazeface-front"]
    elif cli == "filter_faces":
        argv = ["-d", data, "-r", data, "-t", out]
    else:
        argv = ["-i", data, "-o", out] + (
            ["--md", "blazeface-front"] if cli != "extract_features" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    cpu = ["--device", "cpu"] if cli == "filter_faces" else ["-d", "cpu"]
    assert main(argv + cpu) == 0
