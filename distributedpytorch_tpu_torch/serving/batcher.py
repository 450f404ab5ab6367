"""The dynamic micro-batcher: a bounded queue that coalesces requests.

A copy of ``distributedpytorch_tpu/serving/batcher.py`` (stdlib only).

Two latency regimes, one rule.  Under load the queue always holds at
least the largest bucket, so every dispatch is a full batch at maximum
throughput.  At low traffic a lone request must not wait for
neighbors that never come: the OLDEST queued request carries a flush
deadline (``max_latency_s`` after admission), and when it expires the
dispatcher dispatches whatever is pending, padded to the smallest bucket.

Backpressure is explicit and load is SHED, never queued unboundedly:
``admit()`` refuses once ``max_queue`` requests are waiting, and the
HTTP front end turns that refusal into a 503 the client sees
immediately — a saturated tier answers "try elsewhere" in
milliseconds instead of timing everyone out seconds later
(a bounded queue is the contract for any future handler code).

Threading model: HTTP handler threads call ``admit()``; ONE dispatcher
thread calls ``next_batch()``.  All queue state is guarded by a single
condition variable.  Requests are host-side numpy payloads plus a
``threading.Event`` the handler thread waits on — so queued requests
survive an elastic reconfigure (no device state), and ``requeue()``
can put a batch back at the FRONT when the world changes mid-dispatch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

from .planner import plan_batch


class QueueFullError(RuntimeError):
    """Raised by admit(block=False) callers that prefer an exception to
    a bool — the 503 signal."""


class Request:
    """One in-flight request: payload in, result or error out.  ``trace``
    is the request's span chain (tracing.RequestTrace) when tracing is
    on — the batcher stamps the queue-side transitions, the server the
    infer/respond ones."""

    __slots__ = ("payload", "enqueued_mono", "result", "error", "_done",
                 "trace")

    def __init__(self, payload: Any, trace: Any = None):
        self.payload = payload
        self.enqueued_mono = time.monotonic()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self.trace = trace

    def complete(self, result: Any) -> None:
        self.result = result
        self._done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self._done.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block the handler thread until the dispatcher answers.  False =
        still pending at the timeout (the front end's 504)."""
        return self._done.wait(timeout_s)

    def age_s(self) -> float:
        return time.monotonic() - self.enqueued_mono


class MicroBatcher:
    """Bounded coalescing queue between handler threads and the dispatcher."""

    def __init__(self, buckets: Sequence[int], max_queue: int,
                 max_latency_s: float):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_latency_s <= 0:
            raise ValueError(
                f"max_latency_s must be > 0, got {max_latency_s}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_queue = int(max_queue)
        self.max_latency_s = float(max_latency_s)
        # deque growth is bounded by the explicit admit() check below —
        # deque(maxlen=...) would silently DROP requests instead of
        # shedding them with an answer, the exact failure mode the
        # backpressure contract exists to prevent.
        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

    # -- handler side --------------------------------------------------

    def admit(self, req: Request) -> bool:
        """Enqueue, or refuse (False) when the bound is hit / closing.
        The refusal IS the backpressure: the caller answers 503 now."""
        with self._cond:
            if self._closed or len(self._queue) >= self.max_queue:
                return False
            req.enqueued_mono = time.monotonic()
            if req.trace is not None:
                req.trace.mark_admitted()  # queue_wait starts HERE
            self._queue.append(req)
            self._cond.notify()
            return True

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # -- dispatcher side ---------------------------------------------------

    def next_batch(self, timeout_s: float
                   ) -> Optional[Tuple[List[Request], int]]:
        """Block until a batch is READY, at most ``timeout_s``.

        Ready means: a full largest bucket is pending, or the oldest
        request's flush deadline passed.  Returns (requests, bucket) —
        ``len(requests) <= bucket``, the difference is padding — or
        None on timeout (the dispatcher's chance to tick health/shutdown
        checks; pending-but-not-due requests stay queued and flush on
        a later call, so polling never loses the deadline)."""
        end = time.monotonic() + timeout_s
        with self._cond:
            while True:
                now = time.monotonic()
                if self._queue:
                    if len(self._queue) >= self.buckets[-1]:
                        break  # a full largest bucket: dispatch now
                    flush_at = (self._queue[0].enqueued_mono
                                + self.max_latency_s)
                    if now >= flush_at:
                        break  # oldest request's deadline: flush
                    wake = min(end, flush_at)
                else:
                    if self._closed:
                        return None
                    wake = end
                if wake - now <= 0:
                    return None
                self._cond.wait(wake - now)
            take, bucket, _pad = plan_batch(len(self._queue), self.buckets)
            reqs = [self._queue.popleft() for _ in range(take)]
            for r in reqs:
                if r.trace is not None:
                    r.trace.mark_dequeued()  # queue_wait ends, batch_form starts
            return reqs, bucket

    def requeue(self, reqs: List[Request]) -> None:
        """Put a dispatched-but-unanswered batch back at the FRONT (in
        order) — the elastic reconfigure path: the batch outlives the
        world that was about to compute it.  Ignores the bound on
        purpose: these requests were already admitted once."""
        with self._cond:
            for r in reversed(reqs):
                self._queue.appendleft(r)
            self._cond.notify()

    def close(self) -> List[Request]:
        """Refuse new admissions and drain the queue; the caller fails
        the drained requests (shutdown answers, never silence)."""
        with self._cond:
            self._closed = True
            drained = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        return drained
