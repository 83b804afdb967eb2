"""The port's similarity slice against the JAX package (CPU): the gallery
top-k on both paths, the distance and filter math, the directory-level
filter, and the 16-identity retrieval and filter gates on
``golden_embed_ckpt`` run through the port's embedder and search."""
import os

import jax
import numpy as np
import pytest
import torch

from face_detection_and_recognition_tpu.pipelines import similarity as JS
from face_detection_and_recognition_tpu.train import golden_embed as GE
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.core.engine import (EngineConfig,
                                                                   FaceEngine)
from face_detection_and_recognition_tpu_torch.pipelines import \
    similarity as TS
from face_detection_and_recognition_tpu_torch.utils.weights import \
    mobile_facenet_state_dict

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def rng():
    """A fresh generator a test: the state of conftest's shared one
    depends on which tests ran before on the worker."""
    return np.random.RandomState(606)
EMBED_CKPT = os.path.join(DATA, "golden_embed_ckpt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work. The Tier-1 run puts
    several pytest workers on the host's cores, and torch's default pool
    (a thread a core, in every worker) then spends most of its time
    waiting; the previous count is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def embedder():
    """The port's engine with the golden MobileFaceNet, f32-cast (the
    checkpoint is bf16; see tests/test_torch_ensemble.py's ``_load``)."""
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       load_variables(EMBED_CKPT))
    eng = FaceEngine(EngineConfig(detector="blazeface-front",
                                  embedder="mobile_facenet"), device="cpu")
    eng.load_embed_state_dict(mobile_facenet_state_dict(variables))
    return eng


def _embeddings(rng, n, d, dup_of=None):
    e = rng.normal(0, 1, (n, d)).astype(np.float32)
    if dup_of is not None:  # exact ties after normalisation
        for dst, src in dup_of:
            e[dst] = 2.0 * e[src]
    return e


@pytest.mark.parametrize("use_pallas", [False, True])
def test_topk_similar_matches_jax(rng, use_pallas):
    emb = _embeddings(rng, 12, 64)
    gal = _embeddings(rng, 3000, 64, dup_of=[(2000, 17), (2500, 40)])
    emb[3] = gal[17]  # its top hit is tied between rows 17 and 2000
    ref_s, ref_i = JS.topk_similar(emb, gal, k=5, use_pallas=use_pallas)
    got_s, got_i = TS.topk_similar(emb, gal, k=5, use_pallas=use_pallas,
                                   device="cpu")
    assert got_i.dtype == np.int32 and got_s.shape == (12, 5)
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    # cosines: 64-term f32 sums in another order
    np.testing.assert_allclose(got_s, np.asarray(ref_s), rtol=0, atol=1e-6)
    assert got_i[3, 0] == 17 and got_i[3, 1] == 2000


def test_topk_similar_paths_agree_and_mesh_waits(rng):
    emb, gal = _embeddings(rng, 6, 32), _embeddings(rng, 700, 32)
    a = TS.topk_similar(emb, gal, k=3, device="cpu")
    b = TS.topk_similar(emb, gal, k=3, use_pallas=True, device="cpu")
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
    # M < k: the kernel path's tail is (-1e30, 0), as in the JAX package
    s, i = TS.topk_similar(emb, gal[:2], k=4, use_pallas=True, device="cpu")
    js, ji = JS.topk_similar(emb, gal[:2], k=4, use_pallas=True)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="mesh"):
        TS.topk_similar(emb, gal, mesh=object(), device="cpu")


def _wide_gap_threshold(d):
    """A threshold in the widest gap of the middle half of the sorted
    distances ``d``: many decisions each way, none near a tie."""
    s = np.sort(d)[len(d) // 4:3 * len(d) // 4]
    j = int(np.argmax(np.diff(s)))
    return float((s[j] + s[j + 1]) / 2)


def test_distance_and_filter_math_match_jax():
    rng = np.random.RandomState(21)
    emb = rng.normal(0, 1, (40, 32)).astype(np.float32)
    refs = []
    for c in range(4):
        ref = rng.normal(c, 1, (40, 32)).astype(np.float32)
        mean, thr = TS.ref_mean_and_threshold(ref)
        jmean, jthr = JS.ref_mean_and_threshold(ref)
        np.testing.assert_array_equal(mean, jmean)  # the same numpy code
        assert thr == jthr
        assert TS.MAX_N_REF_IMGS == JS.MAX_N_REF_IMGS == 32
        refs.append(TS.ClassReference(f"c{c}", mean, thr))
    means = np.stack([r.mean_vec for r in refs])
    got = TS.distance_matrix(torch.from_numpy(emb),
                             torch.from_numpy(means)).numpy()
    ref = np.asarray(JS.distance_matrix(emb, means))
    # distances ~8 from ||a||^2 + ||b||^2 - 2ab summed in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    refs = [TS.ClassReference(r.name, r.mean_vec,
                              _wide_gap_threshold(got[:, i]))
            for i, r in enumerate(refs)]
    jrefs = [JS.ClassReference(r.name, r.mean_vec, r.threshold) for r in refs]
    assert np.abs(got - np.array([r.threshold for r in refs])).min() > 1e-3
    ids = rng.randint(0, 4, 40)
    for class_ids in (None, ids):
        keep = TS.filter_embeddings(emb, refs, class_ids, device="cpu")
        np.testing.assert_array_equal(
            keep, JS.filter_embeddings(emb, jrefs, class_ids))
    assert 0 < TS.filter_embeddings(emb, refs, ids, device="cpu").sum() < 40


def _tree(root, rng, classes, n_ref, n_data):
    """ref_dir / data_dir trees of files whose names carry their class and
    an outlier flag; ``embed_fn`` reads an embedding off the name."""
    for cls in classes:
        for kind, n in (("ref", n_ref), ("data", n_data)):
            d = os.path.join(root, kind, cls)
            os.makedirs(d)
            for j in range(n):
                outlier = kind == "data" and j % 3 == 0
                with open(os.path.join(d, f"{j:03d}_{int(outlier)}.jpg"),
                          "w") as f:
                    f.write(str(rng.randint(1 << 30)))
    os.makedirs(os.path.join(root, "ref", "lonely"))  # no images: skipped


def _embed_fn(paths):
    out = []
    for p in paths:
        cls = ord(os.path.basename(os.path.dirname(p))[-1])
        name = os.path.basename(p)
        with open(p) as f:
            seed = int(f.read())
        v = np.random.RandomState(seed).normal(0, 0.1, 16)
        v[cls % 16] += 3.0
        if name.endswith("_1.jpg"):
            v += 2.0  # far from its class
        out.append(v.astype(np.float32))
    return np.stack(out)


def test_similar_face_filter_matches_jax(tmp_path, rng):
    root = str(tmp_path)
    _tree(root, rng, ("ca", "cb", "cc"), n_ref=40, n_data=25)
    got = TS.SimilarFaceFilter(_embed_fn, batch_size=8, device="cpu").run(
        os.path.join(root, "data"), os.path.join(root, "ref"),
        os.path.join(root, "out_port"))
    ref = JS.SimilarFaceFilter(_embed_fn, batch_size=8).run(
        os.path.join(root, "data"), os.path.join(root, "ref"),
        os.path.join(root, "out_jax"))
    assert got == ref and set(got) == {"ca", "cb", "cc"}
    for cls, (n_clean, n) in got.items():
        assert n == 25 and 0 < n_clean < n
        for sub in ("clean", "unclean"):
            files = sorted(os.listdir(os.path.join(root, "out_port", cls,
                                                   sub)))
            assert files == sorted(os.listdir(
                os.path.join(root, "out_jax", cls, sub)))
        # every outlier was routed to unclean
        assert all(f.endswith("_0.jpg") for f in os.listdir(
            os.path.join(root, "out_port", cls, "clean")))


@pytest.fixture(scope="module")
def identity_embeddings(embedder):
    """16-identity gallery (32 each) and probes (8 each), the split of
    ``GE.evaluate_retrieval``, embedded by the port."""
    gal = GE.make_multi_identity_crops(303, 32, size=112, n_identities=16)
    probes = GE.make_multi_identity_crops(404, 8, size=112, n_identities=16)
    return (np.concatenate([embedder.embed_crops(np.stack(c)) for c in gal]),
            np.concatenate([embedder.embed_crops(np.stack(c))
                            for c in probes]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_port_retrieval_gate_16_identities(identity_embeddings, use_pallas):
    """The bar of tests/test_retrieval_accuracy.py for golden_embed_ckpt,
    with the port's embedder, ``topk_similar`` and filter math: rank-1 1.0,
    cross 1.0, same >= 0.93, a positive margin on every identity."""
    gal, probes = identity_embeddings
    gal_ids, probe_ids = np.repeat(np.arange(16), 32), np.repeat(
        np.arange(16), 8)
    _, idx = TS.topk_similar(probes, gal, k=1, use_pallas=use_pallas,
                             device="cpu")
    assert (gal_ids[idx[:, 0]] == probe_ids).mean() == 1.0
    refs = [TS.ClassReference(str(c), *TS.ref_mean_and_threshold(
        gal[gal_ids == c])) for c in range(16)]
    means = torch.from_numpy(np.stack([r.mean_vec for r in refs]))
    d = TS.distance_matrix(torch.from_numpy(probes), means).numpy()
    thres = np.array([r.threshold for r in refs], np.float32)
    same = d[np.arange(len(probes)), probe_ids]
    assert (same <= thres[probe_ids]).mean() >= 0.93
    cross = probe_ids[:, None] != np.arange(16)[None]
    assert (d > thres[None])[cross].mean() == 1.0
    for c in range(16):
        rows = probe_ids == c
        assert d[rows][:, np.arange(16) != c].min() - same[rows].max() > 0
    # filter_embeddings routes each probe as the thresholds say
    keep = TS.filter_embeddings(probes, refs, probe_ids, device="cpu")
    np.testing.assert_array_equal(keep, same <= thres[probe_ids])


def test_port_filter_pipeline_gate(embedder):
    """The filter gate of tests/test_golden_embed.py through the port:
    references of identity 0 route identity-0 probes to clean and every
    other identity to unclean."""
    refs = GE.make_identity_crops(seed=911, n_per_id=64)
    probes = GE.make_identity_crops(seed=912, n_per_id=12)
    ref = TS.ClassReference("0", *TS.ref_mean_and_threshold(
        embedder.embed_crops(np.stack(refs[0]))))
    for cid in range(GE.N_IDENTITIES):
        keep = TS.filter_embeddings(
            embedder.embed_crops(np.stack(probes[cid])), [ref],
            class_ids=np.zeros(12, int), device="cpu")
        assert keep.all() if cid == 0 else not keep.any(), (cid, keep)
