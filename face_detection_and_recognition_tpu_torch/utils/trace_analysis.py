"""Device-side profile analysis of ``torch.profiler`` traces.

The counterpart of ``utils/trace_analysis.py`` in the JAX package, on the
Chrome trace that ``torch.profiler`` writes (``*.pt.trace.json``, or
gzipped; ``utils.profiling.device_trace`` writes one). It turns the file
into numbers without TensorBoard:

- ``load_device_ops``: the device's events, one ``DeviceOp`` each: the
  kernels, copies and memsets (categories ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``) with their duration, the bytes a copy or memset moved,
  the aten ops that enclosed the launch (``tf_op``), and the Python frames
  that did (``source_stack``, innermost first). Host events (``cpu_op``,
  ``cuda_runtime``, ``python_function``...) are not device ops.
- ``summarize_by``: device ms (and GB) grouped by any key, for example
  ``source_file_key``, the innermost project file of the launch.
- ``top_ops``: the heaviest kernels by name.
- ``idle_share``: the device's busy time inside a host annotation
  (``record_function``) and its idle share of that span.

A kernel's frames are those of the ``python_function`` spans (traced with
``with_stack=True``) open on the launching thread when its runtime launch
(``cuda_runtime`` / ``cuda_driver``, the same ``correlation``) ran. A
kernel without such a launch record is placed by the aten op whose
``External id`` it carries; one with neither is ``<unattributed>``. The
trace holds no bytes or operation counts of a kernel: those stay 0, and
the report prints ``--``.

Usage:

    with utils.profiling.device_trace("/tmp/tr"):  # run a few steps
        ...
    python -m face_detection_and_recognition_tpu_torch.utils.trace_analysis \\
        /tmp/tr --steps 3
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import glob
import gzip
import importlib.util
import json
import os
import re
import sys
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "<unattributed>"
# a python_function span's name: "path(line): function"
_FRAME = re.compile(r"^(.+)\((\d+)\): (.*)$")


@dataclasses.dataclass
class DeviceOp:
    """One kernel, copy or memset on the device timeline."""

    name: str
    duration_us: float
    occurrences: int = 1
    bytes_accessed: int = 0
    flops: int = 0
    tf_op: str = ""         # the aten ops open at the launch, outermost first
    source: str = ""        # the innermost Python frame, "path:line"
    source_stack: str = ""  # the Python frames, innermost first, a line each

    @property
    def ms(self) -> float:
        return self.duration_us / 1e3


def find_trace_file(path: str) -> str:
    """A trace file given as such, or the newest ``*.pt.trace.json`` /
    ``*.pt.trace.json.gz`` under the directory ``path`` (as passed to
    ``device_trace``)."""
    if os.path.isfile(path):
        return path
    hits = [h for pat in ("*.pt.trace.json", "*.pt.trace.json.gz")
            for h in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}")
    return max(hits, key=os.path.getmtime)


def _read_trace(fname: str) -> dict:
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "rt") as f:
        return json.load(f)


class _Spans:
    """The nested spans of one host thread: the chain of spans open over
    an interval, outermost first, found through each span's parent."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        # a longer span first where two start together: it encloses
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (ts, dur, _) in enumerate(self.spans):
            while stack and self._end(stack[-1]) < ts + dur:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def _end(self, i: int) -> float:
        return self.spans[i][0] + self.spans[i][1]

    def open_at(self, t: float, end: float) -> List[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self._end(i) < end:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i][2])
            i = self.parent[i]
        return out[::-1]


def _frame_line(name: str) -> Optional[str]:
    """A python_function span's name as "path:line", None for a built-in
    (no source file)."""
    m = _FRAME.match(name)
    return f"{m.group(1)}:{m.group(2)}" if m else None


def load_device_ops(path: str) -> List[DeviceOp]:
    """Every kernel, copy and memset of a trace, each execution an event
    of its own (several profiled steps stay apart; ``summarize_by`` and
    ``top_ops`` aggregate them)."""
    trace = _read_trace(find_trace_file(path))
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launches, by_external = {}, {}
    py, aten = defaultdict(list), defaultdict(list)
    for e in events:
        cat, a = e.get("cat"), e.get("args") or {}
        key = (e.get("pid"), e.get("tid"))
        span = (float(e.get("ts", 0)), float(e.get("dur", 0)),
                e.get("name", ""))
        if cat in LAUNCH_CATEGORIES and "correlation" in a:
            launches[a["correlation"]] = (key, span)
        elif cat == "python_function":
            py[key].append(span)
        elif cat in ("cpu_op", "user_annotation"):
            aten[key].append(span)
            if "External id" in a:
                by_external[a["External id"]] = (key, span)
    py = {k: _Spans(v) for k, v in py.items()}
    aten = {k: _Spans(v) for k, v in aten.items()}
    ops: List[DeviceOp] = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = e.get("args") or {}
        host = launches.get(a.get("correlation"))
        if host is None:
            host = by_external.get(a.get("External id"))
        frames, enclosing = [], []
        if host is not None:
            key, (ts, dur, _) = host
            if key in py:
                frames = [f for f in map(_frame_line,
                                         reversed(py[key].open_at(ts,
                                                                  ts + dur)))
                          if f]
            if key in aten:
                enclosing = aten[key].open_at(ts, ts + dur)
        ops.append(DeviceOp(
            name=e.get("name", ""),
            duration_us=float(e.get("dur", 0)),
            bytes_accessed=int(a.get("bytes", 0) or 0),
            flops=int(a.get("flops", 0) or 0),
            tf_op="/".join(enclosing),
            source=frames[0] if frames else "",
            source_stack="\n".join(frames)))
    return ops


def idle_share(path: str, window: str) -> Tuple[float, float, float]:
    """(busy device ms, wall ms, idle share) of the first ``window``
    annotation (a ``record_function`` span) of a trace: the union of the
    device's kernels, copies and memsets, clipped to the annotation's host
    span, against that span. Overlapping device events (several streams)
    count once."""
    events = [e for e in _read_trace(find_trace_file(path)).get(
        "traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == window]
    if not spans:
        raise ValueError(f"the trace holds no '{window}' annotation")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    busy, end = 0.0, t0
    for a, b in sorted((max(float(e["ts"]), t0),
                        min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                       for e in events
                       if e.get("cat") in DEVICE_CATEGORIES):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy / 1e3, (t1 - t0) / 1e3, 1.0 - busy / (t1 - t0)


def summarize_by(ops: List[DeviceOp], key: Callable[[DeviceOp], str],
                 steps: int = 1) -> List[Tuple[str, float, float]]:
    """[(group, ms a step, GB a step)] of the ops grouped by ``key``, by
    time, the largest first; ``steps`` divides the totals by the profiled
    iterations."""
    time_us: Counter = Counter()
    nbytes: Counter = Counter()
    for op in ops:
        k = key(op)
        time_us[k] += op.duration_us
        nbytes[k] += op.bytes_accessed
    return [(k, time_us[k] / 1e3 / steps, nbytes[k] / 1e9 / steps)
            for k, _ in time_us.most_common()]


@functools.lru_cache(maxsize=None)
def _library_root(top: str) -> bool:
    """Whether a frame path's first component names the standard library
    or a package installed in site-packages / dist-packages (the profiler
    writes paths relative to ``sys.path``)."""
    name = top[:-3] if top.endswith(".py") else top
    if name in sys.stdlib_module_names or name.startswith("<"):
        return True
    try:
        spec = importlib.util.find_spec(name)
    except (ImportError, ValueError):
        return False
    origin = (spec.origin or "") if spec else ""
    return "site-packages" in origin or "dist-packages" in origin


def _library_frame(path: str) -> bool:
    if "site-packages" in path or "dist-packages" in path:
        return True
    return not os.path.isabs(path) and _library_root(path.split("/")[0])


def source_file_key(op: DeviceOp) -> str:
    """Attribution by the innermost project file of the launch: the first
    frame of the stack outside the standard library and the installed
    packages; else the innermost frame, else the outermost aten op, else
    ``<unattributed>``."""
    for line in op.source_stack.splitlines():
        path = line.split(":")[0].strip()
        if path and not _library_frame(path):
            return path
    if op.source:
        return op.source.split(":")[0]
    return op.tf_op.split("/")[0] if op.tf_op else UNATTRIBUTED


def top_ops(ops: List[DeviceOp], n: int = 20, steps: int = 1
            ) -> List[DeviceOp]:
    """The ``n`` heaviest ops, aggregated by name, a profiled step."""
    by_name: Dict[str, DeviceOp] = {}
    for op in ops:
        cur = by_name.get(op.name)
        if cur is None:
            by_name[op.name] = dataclasses.replace(op)
        else:
            cur.duration_us += op.duration_us
            cur.bytes_accessed += op.bytes_accessed
            cur.occurrences += 1
    out = sorted(by_name.values(), key=lambda o: -o.duration_us)[:n]
    for o in out:
        o.duration_us /= steps
        o.bytes_accessed //= steps
    return out


def print_report(path: str, steps: int = 1, n: int = 15) -> None:
    ops = load_device_ops(path)
    total = sum(o.duration_us for o in ops) / 1e3 / steps
    print(f"device time: {total:.3f} ms/step ({len(ops)} op executions, "
          f"{steps} step(s))")
    print("\n-- by source file --")
    for k, ms, gb in summarize_by(ops, source_file_key, steps)[:n]:
        bw = (f"{gb / (ms / 1e3):6.0f} GB/s" if ms > 0 and gb > 0
              else "      --  ")
        print(f"{ms:8.3f} ms  {gb:6.3f} GB  {bw}  {k}")
    print("\n-- top ops --")
    for o in top_ops(ops, n, steps):
        src = o.source.split("/")[-1] if o.source else ""
        print(f"{o.ms:8.3f} ms  {o.name[:32]:32} {o.tf_op[:48]:48} {src}")


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace directory (from "
                                  "utils.profiling.device_trace) or a "
                                  "*.pt.trace.json[.gz] file")
    ap.add_argument("--steps", type=int, default=1,
                    help="profiled iterations to divide totals by")
    ap.add_argument("-n", type=int, default=15, help="rows per section")
    args = ap.parse_args(argv)
    print_report(args.trace, steps=args.steps, n=args.n)


if __name__ == "__main__":
    main()
