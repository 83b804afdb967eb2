"""The port's ``utils/trace_analysis.py`` and the profiling helpers
(``force_completion``, ``device_trace``, ``StageTimer``, ``throughput``):
the cases of ``tests/test_trace_analysis.py`` on traces in
``torch.profiler``'s Chrome format (CPU)."""
import gzip
import json
import os

import pytest
import torch

from face_detection_and_recognition_tpu_torch.utils import profiling as PR
from face_detection_and_recognition_tpu_torch.utils import \
    trace_analysis as TA

SITE = "/opt/venv/lib/python3.12/site-packages"


def _write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)


def _py(name, ts, dur, tid=11):
    return {"ph": "X", "cat": "python_function", "name": name, "pid": 100,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _launch(corr, ts, tid=11):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "pid": 100, "tid": tid, "ts": ts, "dur": 4,
            "args": {"correlation": corr, "External id": 0}}


def _kernel(name, corr, ts, dur, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7, **args}}


@pytest.fixture()
def synthetic_trace(tmp_path):
    """Two steps of a conv kernel launched under a project frame and a
    site-packages frame, a top-k kernel under a project frame only, a
    copy with its bytes, a kernel whose launch record is missing but whose
    aten op is known, and one with neither; host events that must not
    count as device ops."""
    events = [
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7"}},
        {"ph": "M", "pid": 100, "tid": 11, "name": "thread_name",
         "args": {"name": "thread 11 (python)"}},
        # host: the project frame, the library frame inside it, the aten
        # op and the launches
        _py("/repo/pkg/models/layers.py(92): forward", 0, 1000),
        _py(f"{SITE}/torch/nn/modules/conv.py(549): forward", 10, 400),
        _py("<built-in method conv2d of type object at 0x1>", 20, 300),
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 100,
         "tid": 11, "ts": 30, "dur": 200, "args": {"External id": 5}},
        _launch(1, 40),
        _py(f"{SITE}/torch/nn/modules/conv.py(549): forward", 500, 400),
        _launch(2, 520),
        _py("/repo/pkg/models/yolov5_face.py(467): decode", 2000, 300),
        _launch(3, 2100),
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 100,
         "tid": 11, "ts": 2200, "dur": 50, "args": {"External id": 9}},
        _launch(4, 2210),
        # a host event of great length that is no device op
        {"ph": "X", "cat": "cpu_op", "name": "hostwork", "pid": 100,
         "tid": 11, "ts": 5000, "dur": 99999, "args": {}},
        # the device
        _kernel("implicit_convolve_sgemm", 1, 3000, 1000),
        _kernel("implicit_convolve_sgemm", 2, 4000, 1400),
        _kernel("topk_kernel", 3, 5400, 600),
        _kernel("Memcpy HtoD (Pageable -> Device)", 4, 6000, 200,
                cat="gpu_memcpy", bytes=2_000_000),
        # no launch record: placed by its aten op's External id
        _kernel("fdr_copy_kernel", 40, 6300, 100, **{"External id": 9}),
        # no launch record, no aten op
        _kernel("orphan_kernel", 41, 6500, 100),
    ]
    d = tmp_path / "tr"
    _write_trace(str(d / "host_100.1.pt.trace.json.gz"), events)
    return str(d)


def test_load_and_aggregate(synthetic_trace):
    ops = TA.load_device_ops(synthetic_trace)
    assert len(ops) == 6  # host events excluded
    assert {o.name for o in ops} == {
        "implicit_convolve_sgemm", "topk_kernel",
        "Memcpy HtoD (Pageable -> Device)", "fdr_copy_kernel",
        "orphan_kernel"}
    conv = [o for o in ops if o.name == "implicit_convolve_sgemm"]
    # innermost frame first; the built-in has no source line
    assert conv[0].source_stack.splitlines() == [
        f"{SITE}/torch/nn/modules/conv.py:549",
        "/repo/pkg/models/layers.py:92"]
    assert conv[0].tf_op == "aten::conv2d"
    assert conv[1].tf_op == ""  # launched outside the aten op

    # per-step aggregation over 2 steps
    top = TA.top_ops(ops, n=10, steps=2)
    assert top[0].name == "implicit_convolve_sgemm"
    assert top[0].ms == pytest.approx(1.2)          # (1000 + 1400) / 2 us
    assert top[0].occurrences == 2
    copy = [o for o in top if o.name.startswith("Memcpy")][0]
    assert copy.bytes_accessed == 1_000_000

    groups = TA.summarize_by(ops, TA.source_file_key, steps=2)
    by = {g[0]: g[1] for g in groups}
    assert "/repo/pkg/models/layers.py" in by        # not the torch frame
    assert by["/repo/pkg/models/layers.py"] == pytest.approx(1.2)
    assert by["/repo/pkg/models/yolov5_face.py"] == pytest.approx(
        (600 + 200 + 100) / 2e3)
    assert by[TA.UNATTRIBUTED] == pytest.approx(0.05)
    gb = {g[0]: g[2] for g in groups}
    assert gb["/repo/pkg/models/yolov5_face.py"] == pytest.approx(1e-3)


def test_print_report_runs(synthetic_trace, capsys):
    TA.print_report(synthetic_trace, steps=2, n=5)
    out = capsys.readouterr().out
    assert "ms/step" in out and "implicit_convolve_sgemm" in out
    # a group without bytes prints no rate
    assert "--" in out.split("-- top ops --")[0]


def test_idle_share_over_an_annotation(tmp_path):
    """The device's busy time inside a ``record_function`` span: events
    clipped to the span, two streams' overlap counted once, host events
    and a second annotation of the same name ignored."""
    path = str(tmp_path / "tr" / "w.pt.trace.json.gz")

    def window(ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": "chunk",
                "pid": 100, "tid": 11, "ts": ts, "dur": dur, "args": {}}

    _write_trace(path, [
        window(100, 1000), window(5000, 10),
        _kernel("before", 1, 50, 100),            # 50 us inside
        _kernel("a", 2, 300, 200),                # 300-500
        dict(_kernel("b", 3, 400, 200), tid=8),   # 400-600, another stream
        _kernel("copy", 4, 700, 50, cat="gpu_memcpy"),
        _kernel("after", 5, 1050, 100),           # 50 us inside
        _kernel("later", 6, 4000, 100),
        _launch(2, 290), _py("/repo/pkg/x.py(1): f", 0, 2000)])
    busy, wall, idle = TA.idle_share(str(tmp_path / "tr"), "chunk")
    assert (busy, wall) == pytest.approx((0.05 + 0.3 + 0.05 + 0.05, 1.0))
    assert idle == pytest.approx(1 - 0.45)
    with pytest.raises(ValueError, match="no 'step'"):
        TA.idle_share(path, "step")


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TA.find_trace_file(str(tmp_path))


def test_real_device_trace(tmp_path):
    """End to end: ``device_trace`` around a small computation on the CPU
    writes a trace that parses to a list (no device lanes on the CPU);
    ``StageTimer`` and ``throughput`` time it, ``force_completion`` takes
    nested results."""
    w = torch.ones(4, 3, 3, 3)

    def f(x):
        return {"y": [torch.nn.functional.conv2d(x, w).sum()]}

    x = torch.ones(1, 3, 16, 16)
    with PR.device_trace(str(tmp_path)):
        for _ in range(2):
            PR.force_completion(f(x))
    fname = TA.find_trace_file(str(tmp_path))
    assert fname.endswith(".pt.trace.json")
    ops = TA.load_device_ops(str(tmp_path))
    assert isinstance(ops, list)
    TA.main([str(tmp_path), "--steps", "2"])

    timer = PR.StageTimer()
    for _ in range(3):
        with timer.stage("conv", result=f(x)):
            f(x)
    assert timer.counts == {"conv": 3} and timer.totals["conv"] > 0
    assert timer.summary()[0].startswith("conv: total")
    rate = PR.throughput(f, x, iters=4, items_per_call=2)
    assert rate > 0
