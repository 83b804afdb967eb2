"""The port's five dataset CLIs on the CPU (``-d cpu``) and the
extract_features and IMDB-WIKI pipelines against the JAX package.

The CLIs run on ``tests/test_cli_pipelines.py``'s trees (random-noise
64x64 JPEGs, two classes of two) with random weights and pass that file's
assertions; the flags the port does not serve (``--mesh``, ``--labeler
interactive``) raise, and so do unreadable keras FaceNet weights. The pipelines run the same
inputs through both packages on the golden checkpoints (golden_blaze_ckpt,
golden_embed_ckpt), cast to f32 for both.

Tolerances: records, labels, ages, age groups and the cleaning report equal;
embeddings within 1e-4 absolute (the host resize equals cv2.resize bit for
bit, so the nets see the same pixels).
"""
import json
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
from face_detection_and_recognition_tpu.pipelines import \
    extract_features as JF
from face_detection_and_recognition_tpu.pipelines import imdb_wiki as JW
from face_detection_and_recognition_tpu.train.golden import (
    GOLDEN_IMG, extract_golden_faces)
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.pipelines import \
    extract_features as TF
from face_detection_and_recognition_tpu_torch.pipelines import imdb_wiki as TW
from face_detection_and_recognition_tpu_torch.pipelines.similarity import \
    filter_embeddings, ref_mean_and_threshold, ClassReference
from face_detection_and_recognition_tpu_torch.utils.weights import (
    blazeface_state_dict, mobile_facenet_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
EMB_TOL = 1e-4


@pytest.fixture
def rng():
    return np.random.RandomState(4242)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: the Tier-1 run puts
    several pytest workers on the host's cores. The previous count is
    restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def image_tree(tmp_path, rng):
    """tests/test_cli_pipelines.py's tree."""
    for cls in ("class_a", "class_b"):
        d = tmp_path / "data" / cls
        d.mkdir(parents=True)
        for i in range(2):
            img = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
            cv2.imwrite(str(d / f"img{i}.jpg"), img)
    return tmp_path / "data"


# ---------------- the CLIs ----------------


def test_extract_and_label_cli(image_tree, tmp_path):
    from face_detection_and_recognition_tpu_torch.cli.extract_and_label \
        import main

    out = str(tmp_path / "labeled")
    rc = main(["-i", str(image_tree), "-o", out, "--md", "blazeface-front",
               "--dt", "0.1", "--fd", "reid-mnv2", "--labeler", "none",
               "--workers", "2", "-d", "cpu"])
    assert rc == 0
    ann = json.load(open(os.path.join(out, "annotations.json")))
    assert len(ann) == 4  # one entry per media
    for rec in ann.values():
        n = len(rec["face_ids"])
        assert len(rec["boxes"]) == n
        assert len(rec["ages"]) == n == len(rec["genders"])


def test_extract_and_label_cli_auto_labeler(image_tree, tmp_path):
    """The default labeler: the engine's age/gender heads label every
    detection (random weights at --dt 0.1 find some on noise)."""
    from face_detection_and_recognition_tpu_torch.cli.extract_and_label \
        import main

    out = str(tmp_path / "labeled")
    assert main(["-i", str(image_tree), "-o", out, "--md", "blazeface-front",
                 "--dt", "0.1", "--at", "0", "--workers", "2",
                 "-d", "cpu"]) == 0
    ann = json.load(open(os.path.join(out, "annotations.json")))
    n = sum(len(a["face_ids"]) for a in ann.values())
    assert n > 0
    for rec in ann.values():
        assert all(a and a.startswith("(") for a in rec["ages"])
        assert set(rec["genders"]) <= {"Male", "Female"}


def test_extract_features_cli(tmp_path, rng):
    from face_detection_and_recognition_tpu_torch.cli.extract_features import \
        main

    for cls in ("id_x", "id_y"):
        d = tmp_path / "crops" / cls
        d.mkdir(parents=True)
        for i in range(2):
            img = rng.randint(0, 255, (50, 60, 3)).astype(np.uint8)
            cv2.imwrite(str(d / f"f{i}.jpg"), img)
        cv2.imwrite(str(d / "f2.png"), rng.randint(0, 255, (30, 40, 3)))
    out = str(tmp_path / "feats")
    rc = main(["-i", str(tmp_path / "crops"), "-o", out,
               "--fd", "mobile_facenet", "--batch", "4", "-d", "cpu"])
    assert rc == 0
    for cls, label in (("id_x", 0.0), ("id_y", 1.0)):
        for i in range(3):
            rec = np.load(os.path.join(out, cls, f"f{i}.npy"))
            assert rec.shape == (513,)  # 512-d features + class label
            assert rec[-1] == label  # alphabetical class map


def _wiki_mat(path, paths, face_score=None):
    from scipy.io import savemat

    n = len(paths)
    full_path = np.empty((1, n), object)
    for i, p in enumerate(paths):
        full_path[0, i] = np.array([p])
    if face_score is None:
        face_score = np.full((1, n), 2.0)
    savemat(str(path), {"wiki": {
        "full_path": full_path,
        "dob": np.full((1, n), 715876.0),
        "photo_taken": np.full((1, n), 2000.0),
        "gender": np.ones((1, n)),
        "face_score": face_score,
        "second_face_score": np.full((1, n), np.nan),
    }})


def test_extract_imdb_wiki_cli(tmp_path, rng):
    from face_detection_and_recognition_tpu_torch.cli.extract_imdb_wiki \
        import main

    img_root = tmp_path / "imgs"
    img_root.mkdir()
    n = 4
    paths = []
    for i in range(n):
        cv2.imwrite(str(img_root / f"p{i}.jpg"),
                    rng.randint(0, 255, (80, 100, 3)).astype(np.uint8))
        paths.append(f"p{i}.jpg")
    face_score = np.full((1, n), 2.0)
    face_score[0, -1] = 0.1  # one metadata reject -> low_det_score
    _wiki_mat(tmp_path / "wiki.mat", paths, face_score)
    out = str(tmp_path / "wiki_out")
    rc = main(["--mat", str(tmp_path / "wiki.mat"), "--db", "wiki",
               "-i", str(img_root), "-o", out, "--md", "blazeface-front",
               "--mf", "mobile_facenet", "--dt", "0.2", "--batch", "2",
               "-d", "cpu"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "data.npy"))
    meta = json.load(open(os.path.join(out, "cleaning_metadata.json")))
    assert meta["kept_metadata"] == n - 1
    assert meta["removed"] == {"low_det_score": 1}
    recs = np.load(os.path.join(out, "data.npy"), allow_pickle=True)
    assert meta["records_written"] == len(recs)


def test_extract_faces_cli(image_tree, tmp_path):
    from face_detection_and_recognition_tpu_torch.cli.extract_faces import \
        main

    out = tmp_path / "out"
    rc = main(["-i", str(image_tree), "-o", str(out), "--md",
               "blazeface-front", "--dt", "0.1", "--at", "0", "--block", "4",
               "--workers", "2", "-d", "cpu"])
    assert rc == 0
    for cls in ("class_a", "class_b"):
        for i in range(2):
            feats = np.load(out / cls / f"img{i}.npy")
            assert feats.shape == (45, 512)
            crops = sorted(os.listdir(out / cls / f"img{i}"))
            norms = np.linalg.norm(feats, axis=1)
            # a crop a detection (at most 3 a frame), a unit row for each
            assert len(crops) == int((norms > 0.5).sum()) > 0
            np.testing.assert_allclose(norms[norms > 0.5], 1.0, atol=1e-3)
            assert all(cv2.imread(str(out / cls / f"img{i}" / c))
                       is not None for c in crops)


def test_filter_faces_cli_with_a_state_dict(tmp_path, rng, capsys):
    """filter_faces -m <.pt>: every data image is routed, and the routing
    equals the port's own embed + filter on the same weights (a mixed-size
    class resized on the host, a same-size class on the device)."""
    from face_detection_and_recognition_tpu_torch.cli.filter_faces import main

    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="facenet", seed=3), device="cpu")
    pt = str(tmp_path / "facenet.pt")
    torch.save(eng.embed_net.state_dict(), pt)
    sizes = {"person_a": [(160, 160)] * 3, "person_b": [(150, 170),
                                                        (90, 120), (160, 160)]}
    for cls, shapes in sizes.items():
        for d in ("data", "refs"):
            (tmp_path / d / cls).mkdir(parents=True)
        for i, (h, w) in enumerate(shapes):
            img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
            cv2.imwrite(str(tmp_path / "refs" / cls / f"r{i}.png"), img)
            cv2.imwrite(str(tmp_path / "data" / cls / f"d{i}.jpg"),
                        np.clip(img.astype(int) + rng.randint(-40, 40,
                                                              img.shape),
                                0, 255).astype(np.uint8))
    rc = main(["-d", str(tmp_path / "data"), "-r", str(tmp_path / "refs"),
               "-t", str(tmp_path / "out"), "-m", pt, "--batch", "4",
               "--embedder", "facenet", "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    from face_detection_and_recognition_tpu_torch.ops.geometry import \
        host_resize
    from face_detection_and_recognition_tpu_torch.utils.native import (
        IMAGE_EXTENSIONS, read_image_bgr)

    def embed(paths):
        imgs = [read_image_bgr(p, formats=IMAGE_EXTENSIONS) for p in paths]
        if len({i.shape for i in imgs}) > 1:
            imgs = [host_resize(i, (160, 160)) for i in imgs]
        return eng.embed_crops(np.stack(imgs))

    for cls in sizes:
        refs = sorted(str(p) for p in (tmp_path / "refs" / cls).iterdir())
        data = sorted(str(p) for p in (tmp_path / "data" / cls).iterdir())
        mean, thr = ref_mean_and_threshold(embed(refs))
        keep = filter_embeddings(embed(data), [ClassReference(cls, mean, thr)],
                                 np.zeros(len(data), int), device="cpu")
        clean = sorted(os.listdir(tmp_path / "out" / cls / "clean"))
        unclean = sorted(os.listdir(tmp_path / "out" / cls / "unclean"))
        assert clean == [os.path.basename(p) for p, k in zip(data, keep) if k]
        assert len(clean) + len(unclean) == 3
        assert f"{cls}: {len(clean)}/3 clean" in printed


@pytest.mark.parametrize("case", ["mesh", "interactive", "savedmodel", "h5"])
def test_cli_flags_the_port_does_not_serve_raise(image_tree, tmp_path, case,
                                                monkeypatch):
    from face_detection_and_recognition_tpu_torch.cli import (
        extract_and_label, extract_faces, filter_faces)

    out = str(tmp_path / "out")
    if case == "mesh":
        # served now: each block split over two devices (here repeated
        # CPU entries standing in for two cards), the files those of the
        # run without the mesh
        from face_detection_and_recognition_tpu_torch.parallel import \
            mesh as PM

        asked = []
        monkeypatch.setattr(PM, "mesh_devices", lambda device=None: (
            asked.append(device) or [torch.device("cpu")] * 2))
        flags = ["-i", str(image_tree), "--md", "blazeface-front",
                 "--block", "2", "-d", "cpu"]
        assert extract_faces.main(flags + ["-o", out + "_plain"]) == 0
        assert extract_faces.main(flags + ["-o", out, "--mesh"]) == 0
        assert asked == ["cpu"]
        tree = sorted((os.path.relpath(d, out), sorted(fs))
                      for d, _, fs in os.walk(out))
        assert tree == sorted((os.path.relpath(d, out + "_plain"), sorted(fs))
                              for d, _, fs in os.walk(out + "_plain"))
        return
    elif case == "interactive":
        with pytest.raises(RuntimeError, match="no display window"):
            extract_and_label.main(["-i", str(image_tree), "-o", out,
                                    "--labeler", "interactive", "-d", "cpu"])
    else:
        # the keras readers are ported (tests/test_torch_keras.py): a
        # SavedModel without its variables bundle and a missing .h5 raise
        # before anything is written
        sm = tmp_path / "facenet_keras_p38"
        sm.mkdir()
        (sm / "saved_model.pb").write_bytes(b"\x08\x01")
        path = str(sm) if case == "savedmodel" else str(tmp_path / "w.h5")
        with pytest.raises(OSError):
            filter_faces.main(["-d", str(image_tree), "-r", str(image_tree),
                               "-t", out, "-m", path, "--device", "cpu"])
    assert not os.path.exists(out)


# ---------------- the pipelines against the JAX package ----------------


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def engines():
    """(JAX, port) at blazeface-front + mobile_facenet, golden weights on
    both; det_thres 0.5, no area floor, as the IMDB-WIKI CLI builds it."""
    blaze, emb = _load("golden_blaze_ckpt"), _load("golden_embed_ckpt")
    kw = dict(detector="blazeface-front", det_thres=0.5, bbox_area_thres=0.0,
              embedder="mobile_facenet", max_det=8)
    jeng = JFaceEngine(JEngineConfig(**kw))
    jeng.variables, jeng.embed_vars = blaze, emb
    teng = FaceEngine(EngineConfig(**kw), device="cpu")
    teng.load_state_dict(blazeface_state_dict(blaze, False))
    teng.load_embed_state_dict(mobile_facenet_state_dict(emb))
    return jeng, teng


@pytest.fixture(scope="module")
def face_patches():
    """The golden image's three faces with context, one face a patch."""
    return [f["patch"] for f in extract_golden_faces(GOLDEN_IMG)]


def test_extract_features_matches_jax(engines, face_patches, tmp_path):
    """Face crops of mixed sizes as JPEG, PNG and BMP, with a json class
    map: the same records and labels, features within EMB_TOL."""
    jeng, teng = engines
    sizes = ((112, 112), (70, 90), (150, 120), (45, 61))
    for c, cls in enumerate(("id_a", "id_b")):
        d = tmp_path / "crops" / cls
        d.mkdir(parents=True)
        for i, ((h, w), ext) in enumerate(zip(sizes, (".jpg", ".png", ".bmp",
                                                      ".png"))):
            cv2.imwrite(str(d / f"f{i}{ext}"),
                        cv2.resize(face_patches[(c + i) % 3], (w, h)))
    cmap = tmp_path / "classes.json"
    cmap.write_text(json.dumps({"id_b": 7, "id_a": 3}))
    kw = dict(class_map_path=str(cmap), batch_size=3)
    nj = JF.extract_features_from_face_dataset(jeng, str(tmp_path / "crops"),
                                               str(tmp_path / "jax"), **kw)
    nt = TF.extract_features_from_face_dataset(teng, str(tmp_path / "crops"),
                                               str(tmp_path / "port"), **kw)
    assert nt == nj == 8
    for cls, label in (("id_a", 3.0), ("id_b", 7.0)):
        names = sorted(os.listdir(tmp_path / "jax" / cls))
        assert sorted(os.listdir(tmp_path / "port" / cls)) == names
        for f in names:
            got = np.load(tmp_path / "port" / cls / f)
            ref = np.load(tmp_path / "jax" / cls / f)
            assert got.shape == (513,) and got[-1] == ref[-1] == label
            np.testing.assert_allclose(got, ref, atol=EMB_TOL, rtol=0)
    assert TF.load_class_map(None, str(tmp_path / "crops")) == \
        JF.load_class_map(None, str(tmp_path / "crops"))


def test_extract_imdb_wiki_matches_jax(engines, face_patches, tmp_path):
    """Single-face images of mixed sizes (JPEG, PNG, BMP) and one missing
    file, letterboxed on the host into blocks of 4: the same records (path,
    age, age group, gender) in the same order, embeddings within
    EMB_TOL."""
    jeng, teng = engines
    root = tmp_path / "imgs"
    root.mkdir()
    sizes = ((200, 160), (150, 190), (240, 240), (120, 100), (300, 260))
    paths = []
    for i, ((h, w), ext) in enumerate(zip(sizes, (".jpg", ".png", ".bmp",
                                                  ".jpg", ".png"))):
        name = f"{i:02d}/p{i}{ext}"
        (root / f"{i:02d}").mkdir()
        cv2.imwrite(str(root / name), cv2.resize(face_patches[i % 3], (w, h)))
        paths.append(name)
    paths.append("missing.jpg")
    meta = {"full_path": np.array(paths), "dob": np.full(6, 715876.0),
            "photo_taken": np.array([2000.0, 1990, 2010, 2001, 1999, 2000]),
            "gender": np.array([1.0, 0, 1, 0, 1, 1])}
    keep = np.arange(6)
    nj = JW.extract_imdb_wiki_faces(jeng, meta, keep, str(root),
                                    str(tmp_path / "jax"), batch_size=4)
    nt = TW.extract_imdb_wiki_faces(teng, meta, keep, str(root),
                                    str(tmp_path / "port"), batch_size=4)
    assert nt == nj >= 3
    got = np.load(tmp_path / "port" / "data.npy", allow_pickle=True)
    ref = np.load(tmp_path / "jax" / "data.npy", allow_pickle=True)
    for g, r in zip(got, ref):
        assert {k: g[k] for k in ("path", "age", "age_group", "gender")} == \
            {k: r[k] for k in ("path", "age", "age_group", "gender")}
        np.testing.assert_allclose(g["embedding"], r["embedding"],
                                   atol=EMB_TOL, rtol=0)


def test_imdb_wiki_metadata_and_cleaning_match_jax(tmp_path):
    n = 7
    paths = [f"im{i}.jpg" for i in range(n)]
    _wiki_mat(tmp_path / "wiki.mat", paths)
    assert set(TW.load_imdb_wiki_metadata(str(tmp_path / "wiki.mat"))) == \
        set(JW.load_imdb_wiki_metadata(str(tmp_path / "wiki.mat")))
    meta = {
        "full_path": np.array(paths),
        "dob": np.array([715876.0] * 5 + [np.nan, 1e12]),
        "photo_taken": np.array([2000.0, 2000, 2000, 2000, 1900, 2000, 2000]),
        "gender": np.array([1.0, np.nan, 1.0, 0.0, 1.0, 1.0, 1.0]),
        "face_score": np.array([1.5, 1.5, 0.2, 1.5, 1.5, 1.5, 1.5]),
        "second_face_score": np.array([np.nan, np.nan, np.nan, 2.0, np.nan,
                                       np.nan, np.nan]),
    }
    tkeep, trep = TW.clean_imdb_wiki(meta)
    jkeep, jrep = JW.clean_imdb_wiki(meta)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert (trep.kept, trep.removed) == (jrep.kept, jrep.removed)
    assert trep.removed["bad_age"] == 3 and trep.kept == 1
    for age in (-1, 0, 5, 13.5, 14, 30, 59.9, 60, 100, 150):
        assert TW.age_to_group(age) == JW.age_to_group(age)
    for dn in (715876.0, 730000.5, 1.0, np.nan):
        assert np.array_equal(TW.matlab_datenum_to_year(dn),
                              JW.matlab_datenum_to_year(dn), equal_nan=True)
