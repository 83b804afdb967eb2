"""Dynamic request batching: the Triton scheduler's ``dynamic_batching``.

The counterpart of ``serving/batcher.py`` in the JAX package. Concurrent
single-image calls are coalesced into one batched engine call: a worker
thread drains the request queue, groups requests by (shape, key) (only
frames of one shape stack into a batch), and runs ONE call per group.
Callers block on a per-request event and get what the unbatched path would
have returned.

Groups run at their own size. The JAX batcher pads each group up to a
"preferred" bucket so that it hits an already compiled XLA program; eager
PyTorch has no such programs, so padding would only add work.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

_SHUT = "batcher is shut down"


class _Request:
    __slots__ = ("img", "key", "done", "result", "error")

    def __init__(self, img: np.ndarray, key: Tuple):
        self.img = img
        self.key = key
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class DynamicBatcher:
    """Coalesce concurrent single-image calls into batched dispatches.

    Args:
        run_batch: fn(imgs [B, H, W, 3], key) -> list of B per-image results
            (key is the grouping tuple the requests were submitted with:
            the frame shape, then e.g. the thresholds).
        max_batch: coalescing limit (requests beyond it dispatch in the
            next window).
        max_delay_ms: how long the worker waits for co-travellers after the
            first request of a group arrives.
        preferred_batch_sizes: kept from the JAX signature and not used to
            pad: it names the batch sizes a later version would capture as
            CUDA graphs, one a bucket.
    """

    def __init__(self, run_batch: Callable, max_batch: int = 8,
                 max_delay_ms: float = 4.0,
                 preferred_batch_sizes: Optional[List[int]] = None):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.preferred_batch_sizes = preferred_batch_sizes
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stop = threading.Event()
        # written by the worker thread alone
        self.dispatches = 0          # batched engine calls made
        self.requests = 0            # requests they served
        # dispatches by size, {size: count}: bounded by max_batch entries
        self.dispatch_sizes: Counter = Counter()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ---- caller side ----

    def submit(self, img: np.ndarray, key: Tuple = ()) -> Any:
        """Blocking: returns this image's result from a shared dispatch."""
        if self._stop.is_set():
            raise RuntimeError(_SHUT)
        req = _Request(np.asarray(img), (tuple(img.shape),) + tuple(key))
        self._q.put(req)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=2.0)
        self._fail_queued()  # anything enqueued after the worker exited

    def _fail_queued(self) -> None:
        while True:
            try:
                got = self._q.get_nowait()
            except queue.Empty:
                return
            if got is not None:
                got.error = RuntimeError(_SHUT)
                got.done.set()

    # ---- worker side ----

    def _loop(self) -> None:
        pending: List[_Request] = []
        try:
            while not self._stop.is_set():
                if not pending:
                    got = self._q.get()
                    if got is None:
                        continue
                    pending.append(got)
                # wait for same-group co-travellers until max_delay after
                # the window opened (an absolute deadline: a timeout a get
                # would let trickling arrivals hold the first caller up to
                # max_delay * (max_batch - 1))
                deadline = time.monotonic() + self.max_delay
                group_key = pending[0].key
                group = [r for r in pending if r.key == group_key]
                rest = [r for r in pending if r.key != group_key]
                while len(group) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        got = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if got is None:
                        break
                    (group if got.key == group_key else rest).append(got)
                # a group is at most max_batch; the rest waits its turn
                self._dispatch(group[:self.max_batch])
                pending = group[self.max_batch:] + rest
        finally:
            # never strand a caller: fail whatever is still waiting
            for r in pending:
                r.error = RuntimeError(_SHUT)
                r.done.set()
            self._fail_queued()

    def _dispatch(self, group: List[_Request]) -> None:
        self.requests += len(group)
        self.dispatches += 1
        self.dispatch_sizes[len(group)] += 1
        try:
            results = self.run_batch(np.stack([r.img for r in group]),
                                     group[0].key)
            for r, res in zip(group, results):
                r.result = res
                r.done.set()
        except BaseException as e:  # propagate to every waiting caller
            for r in group:
                r.error = e
                r.done.set()
