"""The port's keras FaceNet readers against the JAX package (CPU).

TensorFlow's TensorBundle written by one package and read by the other,
both ways; a keras SavedModel directory and a keras ``.h5`` written from
one seeded JAX FaceNet (the recipe of ``tests/test_facenet_import.py``),
loaded by the port's ``FaceEngine.load_embed_weights``: embeddings within
1e-5 of the JAX engine's holding the same weights; and ``filter_faces -m
<savedmodel>`` through both packages' CLIs, which must keep the same
files. The JAX FaceNet, its weight stream and the fixture files are built
once for the module.
"""
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.utils import tensor_bundle as JTB
from face_detection_and_recognition_tpu_torch.utils import tensor_bundle as TB

EMB_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the Tier-1 run puts
    several pytest workers on the host's cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tensor_bundle_round_trip_across_packages(tmp_path, writer):
    """A bundle written by one package's writer reads back equal through
    the other's reader: names, dtypes, shapes (0-d included), values."""
    rng = np.random.RandomState(5)
    tensors = [
        ("a/kernel", rng.randn(3, 3, 4, 8).astype(np.float32)),
        ("a/bias", rng.randn(8).astype(np.float32)),
        ("z/step", np.asarray(7, np.int64).reshape(())),
        ("m/int32", np.arange(6, dtype=np.int32).reshape(2, 3)),
        ("h/half", rng.randn(5).astype(np.float16)),
        ("d/f64", rng.randn(2, 2)),
    ]
    prefix = str(tmp_path / "variables" / "variables")
    write, read = ((TB.write_tensor_bundle, JTB.read_tensor_bundle)
                   if writer == "port" else
                   (JTB.write_tensor_bundle, TB.read_tensor_bundle))
    write(prefix, tensors)
    back = read(prefix)
    assert [n for n, _ in back] == sorted(n for n, _ in tensors)
    back = dict(back)
    for name, arr in tensors:
        assert back[name].dtype == arr.dtype and back[name].shape == arr.shape
        np.testing.assert_array_equal(back[name], arr)


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    """A seeded JAX FaceNet (the donor, its final BatchNorm given seeded
    moving statistics) written as a keras SavedModel directory by the
    recipe of tests/test_facenet_import.py:60-96 (the JAX package's stream,
    which carries no statistics for the final BatchNorm: 488 arrays) and
    as a keras .h5 in a keras FaceNet's own layout (that BatchNorm's
    moving mean and variance too: 490 arrays). Returns (donor variables,
    savedmodel dir, h5 path)."""
    h5py = pytest.importorskip("h5py")
    from face_detection_and_recognition_tpu.models.facenet import \
        make_facenet
    from face_detection_and_recognition_tpu.utils.weights import (
        execution_module_order, ordered_slots)

    net, donor, embed = make_facenet(rng=jax.random.PRNGKey(7))
    donor = jax.tree_util.tree_map(np.array, donor)
    rng = np.random.RandomState(3)
    last = donor["batch_stats"]["bottleneck_bn"]
    last["mean"] = rng.uniform(-0.1, 0.1, 128).astype(np.float32)
    last["var"] = rng.uniform(0.5, 2.0, 128).astype(np.float32)
    order = execution_module_order(net, donor, (1, 160, 160, 3))
    groups = []  # (module path, [(keras attribute, array)])
    for p, n, _, st in ordered_slots(donor, order):
        node = donor["batch_stats" if st else "params"]
        for k in p:
            node = node[k]
        attr = {"kernel": "kernel", "bias": "bias", "scale": "gamma",
                "mean": "moving_mean", "var": "moving_variance"}[n]
        if not st and n in ("bias", "scale") and any(
                x.startswith("BatchNorm") or x.endswith("_bn")
                for x in p[-1:]):
            attr = {"bias": "beta", "scale": "gamma"}[n]
        if groups and groups[-1][0] == p:
            groups[-1][1].append((attr, np.asarray(node[n])))
        else:
            groups.append((p, [(attr, np.asarray(node[n]))]))

    d = tmp_path_factory.mktemp("keras")
    sm = d / "facenet_keras_p38"
    (sm / "variables").mkdir(parents=True)
    (sm / "saved_model.pb").write_bytes(b"\x08\x01")
    named = [(f"layer_with_weights-{i}/{attr}/.ATTRIBUTES/VARIABLE_VALUE",
              arr) for i, (_, attrs) in enumerate(groups)
             for attr, arr in attrs]
    named.append(("save_counter/.ATTRIBUTES/VARIABLE_VALUE",
                  np.asarray(1, np.int64)))
    TB.write_tensor_bundle(str(sm / "variables" / "variables"), named)

    h5 = str(d / "facenet_keras.h5")
    groups[-1][1].extend([("moving_mean", last["mean"]),
                          ("moving_variance", last["var"])])
    with h5py.File(h5, "w") as f:
        mw = f.create_group("model_weights")
        layer_names = []
        for i, (p, attrs) in enumerate(groups):
            lname = f"layer_{i}_{'_'.join(p) or 'root'}"
            layer_names.append(lname)
            lg = mw.create_group(lname)
            wnames = []
            for attr, arr in attrs:
                wn = f"{lname}/{attr}:0"
                lg.create_dataset(wn, data=arr)
                wnames.append(wn)
            lg.attrs["weight_names"] = np.array([w.encode() for w in wnames])
        mw.attrs["layer_names"] = np.array([n.encode() for n in layer_names])
    return net, donor, embed, str(sm), h5


@pytest.fixture(scope="module")
def jax_embeddings(keras_files):
    """3 seeded prewhitened 160x160 crops and the JAX FaceNet's embeddings
    of them: {"h5": with the donor's weights, "savedmodel": with what the
    JAX import (``convert_facenet_keras``, as ``load_embed_weights``
    calls it) makes of the SavedModel in a new engine, whose final
    BatchNorm statistics the file does not carry (flax's init: mean 0,
    var 1)}."""
    from face_detection_and_recognition_tpu.utils import weights as JW

    net, donor, embed, sm, _ = keras_files
    x = np.random.RandomState(9).randn(3, 160, 160, 3).astype(np.float32)
    fresh = jax.tree_util.tree_map(np.array, donor)
    fresh["batch_stats"]["bottleneck_bn"] = {
        "mean": np.zeros(128, np.float32), "var": np.ones(128, np.float32)}
    imported = JW.convert_facenet_keras(
        JW.keras_bundle_stream(JTB.read_tensor_bundle(
            os.path.join(sm, "variables", "variables"))), net, fresh)
    return x, {"h5": np.asarray(embed(donor, x)),
               "savedmodel": np.asarray(embed(imported, x))}


@pytest.mark.parametrize("kind", ["savedmodel", "h5"])
def test_load_embed_weights_reads_keras_facenet(keras_files, jax_embeddings,
                                                kind):
    """The port's engine loads the SavedModel directory and the .h5 into
    its FaceNet slot: every slot filled (the BN weights, which keras does
    not store, stay 1; the first conv's, the last block's, the
    bottleneck's and the final BatchNorm's statistics all replaced), and
    the slot's embeddings within 1e-5 of the JAX FaceNet's holding what
    the JAX engine would load."""
    from face_detection_and_recognition_tpu_torch.core.engine import (
        EngineConfig, FaceEngine)

    sm, h5 = keras_files[3:]
    x, refs = jax_embeddings
    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="facenet"), device="cpu")
    before = {k: v.clone() for k, v in eng.embed_net.state_dict().items()}
    eng.load_embed_weights(sm if kind == "savedmodel" else h5)
    after = eng.embed_net.state_dict()
    bn_weights = [k for k in after if k.endswith("bn.weight")]
    assert bn_weights and all(torch.all(after[k] == 1) for k in bn_weights)
    for k in ("conv2d_1a.conv.weight", "block8.conv2d.weight",
              "last_linear.weight", "last_bn.running_var"):
        assert not torch.equal(after[k], before[k]), k
    with torch.no_grad():
        got = eng.embed_net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, refs[kind], atol=EMB_TOL)


def test_keras_stream_shape_mismatch_names_the_slot(keras_files):
    """A stream that does not fit the net (one array short, one array of
    the wrong shape) raises, naming the count or the slot."""
    from face_detection_and_recognition_tpu_torch.models.facenet import \
        InceptionResNetV1
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    stream = W.read_keras_h5_stream(keras_files[4])
    assert len(stream) == 490
    net = InceptionResNetV1().eval()
    with pytest.raises(ValueError, match="leaves"):
        W.convert_facenet_keras(stream[:-1], net)
    bad = list(stream)
    bad[0] = bad[0][:, :, :, :-1]
    with pytest.raises(ValueError, match="conv2d_1a"):
        W.convert_facenet_keras(bad, net)


def test_filter_faces_savedmodel_matches_jax_cli(keras_files, tmp_path,
                                                 capsys):
    """filter_faces -m <SavedModel> through the port's CLI (--device cpu)
    and the JAX CLI on the same tree: the same files clean and unclean in
    every class, and the same report. Four references and four images a
    class: every embedding batch has one shape (one JAX compile)."""
    from face_detection_and_recognition_tpu.cli.filter_faces import \
        main as jmain
    from face_detection_and_recognition_tpu_torch.cli.filter_faces import \
        main

    rng = np.random.RandomState(11)
    for cls in ("person_a", "person_b"):
        base = rng.randint(0, 256, (160, 160, 3))
        for d in ("data", "refs"):
            (tmp_path / d / cls).mkdir(parents=True)
        refs = [np.clip(base + rng.randint(-30, 30, base.shape), 0, 255)
                .astype(np.uint8) for _ in range(4)]
        for i, ref in enumerate(refs):
            cv2.imwrite(str(tmp_path / "refs" / cls / f"r{i}.png"), ref)
        # the references' centre and a near copy of it, two far from them
        data = [np.clip(base + rng.randint(-n, n + 1, base.shape), 0, 255)
                .astype(np.uint8) for n in (0, 5, 160, 160)]
        for i, img in enumerate(data):
            cv2.imwrite(str(tmp_path / "data" / cls / f"d{i}.png"), img)
    sm = keras_files[3]
    args = ["-d", str(tmp_path / "data"), "-r", str(tmp_path / "refs"),
            "-m", sm, "--batch", "4"]
    assert jmain(args + ["-t", str(tmp_path / "jax")]) == 0
    jprinted = capsys.readouterr().out
    assert main(args + ["-t", str(tmp_path / "port"), "--device",
                        "cpu"]) == 0
    printed = capsys.readouterr().out
    assert printed == jprinted
    kept = 0
    for cls in ("person_a", "person_b"):
        for split in ("clean", "unclean"):
            got = sorted(os.listdir(tmp_path / "port" / cls / split))
            assert got == sorted(os.listdir(tmp_path / "jax" / cls / split))
            kept += len(got) if split == "clean" else 0
    assert 0 < kept < 8, printed


def test_h5_reader_names_h5py_when_it_is_missing(monkeypatch, tmp_path):
    """h5py is imported by the .h5 reader alone: on a machine without it
    (the card's) the reader raises ImportError naming it."""
    import sys

    from face_detection_and_recognition_tpu_torch.utils import weights as W

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        W.read_keras_h5_stream(str(tmp_path / "facenet_keras.h5"))
