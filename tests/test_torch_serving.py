"""The port's serving stack against the JAX service (CPU): FaceService's
ensemble contract, the dynamic batcher, and the HTTP and gRPC front doors
on 127.0.0.1.

Both services run yolov5n at ``max_det`` 8 on the golden checkpoints
(golden_yolov5n_ckpt, golden_embed_ckpt and golden_ag_ckpt, f32-cast for
both packages). Tolerances: boxes within 1 px (rounded pixels), confs to
1e-4, embeddings to 1e-5, labels equal, and faces to 3.1e-5 / 127.5 plus
one ulp of 1.0: the port's crops come from the crop kernel's plain version
with the clip, the JAX service's from its gather path, which differ by at
most 3.1e-5 of 255 (ROADMAP §C), and (x - 127.5) / 127.5 maps that onto
the (-1, 1) scale.
"""
import collections
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import cv2
import jax
import numpy as np
import pytest

from face_detection_and_recognition_tpu.serving import \
    FaceService as JFaceService
from face_detection_and_recognition_tpu.serving import \
    ServiceConfig as JServiceConfig
from face_detection_and_recognition_tpu.utils.checkpoint import load_variables
from face_detection_and_recognition_tpu_torch.ops import cuda_kernels as ck
from face_detection_and_recognition_tpu_torch.serving import (FaceService,
                                                              ServiceConfig)
from face_detection_and_recognition_tpu_torch.serving.batcher import \
    DynamicBatcher
from face_detection_and_recognition_tpu_torch.serving.service import \
    NO_FACE_SENTINEL
from face_detection_and_recognition_tpu_torch.utils import native as N
from face_detection_and_recognition_tpu_torch.utils.weights import (
    age_gender_state_dict, mobile_facenet_state_dict, yolov5_face_state_dict)

DATA = os.path.join(os.path.dirname(__file__), "data")
IMG = os.path.join(DATA, "test2_faces_3.jpg")
FACE_TOL = 3.1e-5 / 127.5 + np.spacing(np.float32(1.0))
SMALL = dict(detector="yolov5n", max_det=8)


def _load(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  load_variables(os.path.join(DATA, name)))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The golden weights: JAX trees and the port's .pt files."""
    import torch

    d = tmp_path_factory.mktemp("svc")
    det, emb, ag = (_load("golden_yolov5n_ckpt"), _load("golden_embed_ckpt"),
                    _load("golden_ag_ckpt"))
    paths = {"ckpt": str(d / "det.pt"), "embed_ckpt": str(d / "emb.pt"),
             "ag_ckpt": str(d / "ag.pt")}
    torch.save(yolov5_face_state_dict(det, "yolov5n"), paths["ckpt"])
    torch.save(mobile_facenet_state_dict(emb), paths["embed_ckpt"])
    torch.save(age_gender_state_dict(ag["age"], ag["gender"]),
               paths["ag_ckpt"])
    return {"det": det, "embed": emb, "ag": ag, "paths": paths}


@pytest.fixture(scope="module")
def services(ckpts):
    """(JAX, port) services with the ensemble, golden weights on both."""
    jsvc = JFaceService(JServiceConfig(**SMALL))
    jsvc.engine.variables = ckpts["det"]
    jsvc.engine.embed_vars = ckpts["embed"]
    jsvc.engine.ag_vars = (ckpts["ag"]["age"], ckpts["ag"]["gender"])
    svc = FaceService(ServiceConfig(**SMALL, **ckpts["paths"],
                                    device="cpu"))
    assert svc.ready()
    yield jsvc, svc
    svc.close()


@pytest.fixture(scope="module")
def frame():
    return cv2.imread(IMG)


def _same_contract(got, ref):
    (gf, gb, gc), (rf, rb, rc) = got, ref
    assert gf.dtype == gb.dtype == gc.dtype == np.float32
    assert gf.shape == rf.shape and gb.shape == rb.shape \
        and gc.shape == rc.shape
    np.testing.assert_allclose(gb, rb, atol=1.0, rtol=0)
    np.testing.assert_allclose(gc, rc, atol=1e-4, rtol=0)
    np.testing.assert_allclose(gf, rf, atol=FACE_TOL, rtol=0)


@pytest.mark.parametrize("thres", [(None, None), (0.5, 0.0), (0.0, 0.0)],
                         ids=["config", "dt0.5", "all"])
def test_detect_faces_matches_jax(services, frame, thres):
    jsvc, svc = services
    got = svc.detect_faces(frame, *thres)
    ref = jsvc.detect_faces(frame, *thres)
    _same_contract(got, ref)
    faces, bboxes, confs = got
    assert faces.shape[1:] == (3, 112, 112) and bboxes.shape[1] == 4
    assert confs.shape == (len(bboxes), 1)
    assert -1.0 <= faces.min() and faces.max() <= 1.0
    if thres == (0.5, 0.0):
        assert faces.shape[0] == 3


def test_blank_frame_gives_the_sentinel(services):
    jsvc, svc = services
    blank = np.zeros((120, 160, 3), np.uint8)
    got = svc.detect_faces(blank)
    faces, bboxes, confs = got
    assert faces.shape == (0, 3, 112, 112) and confs.shape == (0, 1)
    np.testing.assert_array_equal(bboxes, NO_FACE_SENTINEL)
    _same_contract(got, jsvc.detect_faces(blank))
    out = svc.detect_embed_classify(blank)
    np.testing.assert_array_equal(out["bboxes"], NO_FACE_SENTINEL)
    assert out["embeddings"].shape == (0, 512) and out["labels"] == []


def test_call_time_thresholds_narrow(services, frame):
    _, svc = services
    strict = svc.detect_faces(frame, det_thres=0.999)[0].shape[0]
    loose = svc.detect_faces(frame, det_thres=0.0,
                             bbox_area_thres=0.0)[0].shape[0]
    assert strict <= 3 <= loose <= 8


def test_detect_embed_classify_matches_jax(services, frame):
    jsvc, svc = services
    got, ref = svc.detect_embed_classify(frame), \
        jsvc.detect_embed_classify(frame)
    assert set(got) == {"bboxes", "confs", "embeddings", "labels"}
    np.testing.assert_allclose(got["bboxes"], ref["bboxes"], atol=1.0,
                               rtol=0)
    np.testing.assert_allclose(got["confs"], ref["confs"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["embeddings"], np.asarray(
        ref["embeddings"]), atol=1e-5, rtol=0)
    assert got["labels"] == list(ref["labels"])
    assert len(got["labels"]) == len(got["embeddings"]) == 3


def test_embed_and_age_gender_match_jax(services, frame):
    """The staged entry points on crops of the golden faces and noise."""
    jsvc, svc = services
    boxes = svc.detect_faces(frame, 0.5)[1].astype(int)
    faces = np.stack([cv2.resize(frame[y1:y2, x1:x2], (112, 112))
                      for x1, y1, x2, y2 in boxes])
    noise = np.random.RandomState(9).randint(0, 256, (2, 96, 96, 3),
                                             np.uint8)
    for crops in (faces, noise):
        np.testing.assert_allclose(svc.embed(crops),
                                   np.asarray(jsvc.embed(crops)), atol=1e-5,
                                   rtol=0)
        (a, g), (ja, jg) = svc.age_gender(crops), jsvc.age_gender(crops)
        np.testing.assert_allclose(a, np.asarray(ja), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g, np.asarray(jg), atol=1e-5, rtol=0)
    assert svc.embed(np.zeros((0, 112, 112, 3), np.uint8)).shape == (0, 512)


def test_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="A12"):
        FaceService(ServiceConfig(**SMALL, mesh=object(), device="cpu"))


# ---------------- the dynamic batcher ----------------


def _concurrently(fn, args):
    out = [None] * len(args)
    errs = []

    def run(i):
        try:
            out[i] = fn(*args[i])
        except Exception as e:  # reported below, not swallowed
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def test_batched_detect_faces_equal_unbatched(services, frame):
    """Concurrent calls share dispatches and return what the unbatched path
    returns, within the contract's tolerances; frames of another shape or
    other thresholds group apart."""
    _, svc = services
    small = np.ascontiguousarray(frame[100:420, 200:680])
    calls = [(frame, 0.5, 0.0), (frame[:, ::-1].copy(), 0.5, 0.0),
             (small, 0.5, 0.0), (frame, 0.0, 0.0),
             (np.zeros_like(frame), 0.5, 0.0), (frame, 0.5, 0.0),
             (small, 0.5, 0.0), (frame, 0.5, 0.0)]
    want = [svc.detect_faces(*c) for c in calls]
    batcher = svc.enable_dynamic_batching(max_batch=8, max_delay_ms=200.0)
    try:
        got = _concurrently(svc.detect_faces, calls)
    finally:
        batcher.shutdown()
        svc._batcher = None
    assert batcher.requests == len(calls)
    # three groups at least: the frame at 0.5, the small frame, the frame
    # at 0.0; fewer dispatches than requests
    assert 3 <= batcher.dispatches < len(calls)
    # a batch's convolutions may sum in another order than one frame's (an
    # ulp of a conf here): the contract's tolerances
    for g, w in zip(got, want):
        _same_contract(g, w)


def test_batcher_groups_by_shape_and_key():
    seen = []

    def run_batch(imgs, key):
        seen.append((imgs.shape, key))
        return [int(im.sum()) + len(key) for im in imgs]

    b = DynamicBatcher(run_batch, max_batch=3, max_delay_ms=300.0)
    try:
        imgs = [np.full((2, 3, 3), i, np.uint8) for i in range(5)] + \
            [np.full((4, 3, 3), 1, np.uint8)]
        keys = [("a",)] * 5 + [("a",)]
        got = _concurrently(lambda im, k: b.submit(im, k),
                            list(zip(imgs, keys)))
    finally:
        b.shutdown()
    assert got == [int(im.sum()) + 2 for im in imgs]
    assert b.requests == 6
    for shape, key in seen:
        assert shape[0] <= 3 and key[0] == shape[1:]
    assert sum(s[0] for s, _ in seen) == 6 and b.dispatches == len(seen)
    assert b.dispatch_sizes == collections.Counter(s[0] for s, _ in seen)
    assert {s[1:] for s, _ in seen} == {(2, 3, 3), (4, 3, 3)}


def test_batcher_errors_and_shutdown():
    def boom(imgs, key):
        raise ValueError("bad batch")

    b = DynamicBatcher(boom, max_batch=4, max_delay_ms=1.0)
    with pytest.raises(ValueError, match="bad batch"):
        b.submit(np.zeros((2, 2, 3), np.uint8))
    b.shutdown()
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(np.zeros((2, 2, 3), np.uint8))

    release = threading.Event()

    def slow(imgs, key):
        release.wait(timeout=10)
        return [0] * len(imgs)

    b = DynamicBatcher(slow, max_batch=1, max_delay_ms=0.0)
    first = threading.Thread(target=b.submit,
                             args=(np.zeros((1, 1, 3), np.uint8),))
    first.start()
    time.sleep(0.1)          # the worker is now inside the first dispatch
    errors = []

    def queued():
        try:
            b.submit(np.zeros((1, 1, 3), np.uint8))
        except RuntimeError as e:
            errors.append(e)

    waiting = threading.Thread(target=queued)
    waiting.start()
    time.sleep(0.1)
    stopper = threading.Thread(target=b.shutdown)
    stopper.start()
    deadline = time.monotonic() + 10
    while not b._stop.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)  # the stop is set before the dispatch returns
    release.set()
    for t in (first, waiting, stopper):
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(errors) == 1 and "shut down" in str(errors[0])


# ---------------- the front doors ----------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/jpeg"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


def _status(url, body):
    try:
        _post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)
    return 200, None


def test_http_front_door(ckpts, services, frame):
    from face_detection_and_recognition_tpu_torch.serving.http_server import \
        serve

    _, svc = services
    port = _free_port()
    httpd = serve(ServiceConfig(**SMALL, **ckpts["paths"], device="cpu"),
                  host="127.0.0.1", port=port, block=False,
                  warmup_shapes=((64, 96),))
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.load(r) == {"ready": True}
        jpeg = N.encode_jpeg_bgr(frame)
        decoded = N.decode_jpeg_bgr(jpeg)
        out = _post(base + "/detect?det_thres=0.5&bbox_area_thres=0", jpeg)
        faces, bboxes, confs = svc.detect_faces(decoded, 0.5, 0.0)
        assert out["num_faces"] == faces.shape[0] == 3
        np.testing.assert_allclose(out["bboxes"], bboxes, atol=1e-4)
        np.testing.assert_allclose(out["confs"], confs.ravel(), atol=1e-4)
        ens = _post(base + "/ensemble", jpeg)
        ref = svc.detect_embed_classify(decoded)
        np.testing.assert_allclose(ens["bboxes"], ref["bboxes"], atol=1e-4)
        np.testing.assert_allclose(ens["embeddings"], ref["embeddings"],
                                   atol=1e-5)
        assert ens["labels"] == ref["labels"]
        # the 400 cases of tests/test_serving.py
        assert _status(base + "/detect", b"not an image")[0] == 400
        assert _status(base + "/detect", b"")[0] == 400
        code, body = _status(base + "/detect?det_thres=abc", jpeg)
        assert code == 400 and "bad request" in body["error"]
        assert _status(base + "/nope", jpeg)[0] == 404
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
        # every key of the JAX package's /stats (serving/http_server.py),
        # and the port's kernel launch counts besides
        assert {"dynamic_batching", "requests", "dispatches",
                "compiled_pipelines", "detector"} <= set(stats)
        assert stats["dynamic_batching"] is False
        assert stats["compiled_pipelines"] >= 1
        assert set(stats["kernel_launches"]) == set(ck.LAUNCHES)
        assert stats["detector"] == "yolov5n"
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.service.close()


def test_grpc_front_door(services, frame):
    grpc = pytest.importorskip("grpc")
    from face_detection_and_recognition_tpu_torch.serving.grpc_server import (
        grpc_call, grpc_detect, make_grpc_server)

    _, svc = services
    port = _free_port()
    server = make_grpc_server(svc, "127.0.0.1", port, max_workers=4)
    server.start()
    addr = f"127.0.0.1:{port}"
    try:
        assert json.loads(grpc_call(addr, "Health")) == {"ready": True}
        jpeg = N.encode_jpeg_bgr(frame)
        decoded = N.decode_jpeg_bgr(jpeg)
        out = grpc_detect(addr, jpeg, det_thres=0.5, bbox_area_thres=0.0)
        _, bboxes, confs = svc.detect_faces(decoded, 0.5, 0.0)
        assert out["num_faces"] == 3
        np.testing.assert_allclose(out["bboxes"], bboxes, atol=1e-4)
        ens = json.loads(grpc_call(addr, "DetectEmbedClassify", jpeg))
        assert ens["labels"] == svc.detect_embed_classify(decoded)["labels"]
        for body, md in ((b"not an image", None), (b"", None),
                         (jpeg, [("det-thres", "abc")])):
            with pytest.raises(grpc.RpcError) as err:
                grpc_call(addr, "Detect", body, md)
            assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        server.stop(None)
