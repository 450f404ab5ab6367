"""Structured telemetry: per-rank JSONL counters, gauges, histograms,
spans and events.

Counterpart of ``distributedpytorch_tpu/telemetry.py`` (the emitter,
:65-468), in the same JSONL schema, so the JAX package's ``telemetry``
report reads the port's files.  The rank is passed explicitly to
``configure`` (the JAX version reads ``jax.process_index()``).  The
offline report functions are not ported yet.

Zero-cost when disabled: ``get()`` returns a no-op instance until
``configure()`` installs an enabled one.  Every line carries ``ts``
(wall clock, for humans), ``mono`` (the ordering clock) and ``rank``.
Event kinds: counter, gauge, histogram, event, span (a timed context
manager; nested spans carry their parent's name).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

_FLUSH_EVERY = 1024  # buffered events before an automatic flush


# -- record schema factories ------------------------------------------
#
# The JSONL line shape is a CONTRACT shared with the JAX package's
# emitter and its readers: every record goes through these two functions
# so the schema cannot fork.

def stamp_record(payload: Dict[str, Any], *, ts: float, mono: float,
                 rank: int) -> Dict[str, Any]:
    """One telemetry record: the caller's payload plus the paired
    ``ts``/``mono`` stamps and the emitting rank.  Pure — the clocks
    are arguments, so the simulator stamps virtual time through the
    exact code path the live emitter uses."""
    out = dict(payload)
    out["ts"] = ts
    out["mono"] = mono
    out["rank"] = rank
    return out


def encode_line(payload: Dict[str, Any]) -> str:
    """The canonical JSONL serialization (sorted keys, floats for
    anything exotic) — byte-stable for identical payloads, which is
    what makes same-seed simulator runs byte-identical."""
    return json.dumps(payload, sort_keys=True, default=float)


class Counter:
    """Monotonic accumulator; summarized as one event at flush time."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-value metric; every ``set`` emits an event (time series)."""

    __slots__ = ("name", "value", "_tel")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self.value: Optional[float] = None
        self._tel = tel

    def set(self, value: Optional[float], **attrs: Any) -> None:
        """``None`` is a recorded null — the event documents the gauge
        was considered but unavailable (e.g. MFU on an unknown chip)."""
        self.value = None if value is None else float(value)
        self._tel._emit({"kind": "gauge", "name": self.name,
                         "value": self.value,
                         **({"attrs": attrs} if attrs else {})})


class Histogram:
    """Streaming timing histogram: log-bucketed quantile sketch with
    exact count/sum/min/max, summarized at flush with p50/p90/p95/p99.

    The previous implementation kept the FIRST 4096 raw samples, so on
    long runs the quantiles described the warmup, not the run — and
    they only existed at close time.  The sketch keeps one counter per
    geometric bucket (2% growth => <=1% representative error, far under
    the report's precision), is O(1) per observe with bounded memory
    regardless of run length, covers every observation, and is
    queryable at any moment — ``quantile()`` backs the close-time
    summary event.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_buckets",
                 "_nonpos")

    _GROWTH_LOG = math.log(1.02)  # bucket boundaries grow 2% per index

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._nonpos = 0  # observations <= 0 (durations shouldn't, but)

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value <= 0.0:
            self._nonpos += 1
            return
        idx = math.floor(math.log(value) / self._GROWTH_LOG)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Streaming quantile (bucket geometric midpoint, clamped to the
        exact observed range).  Safe to call from a scrape thread while
        the dispatcher observes: the snapshot below is a single C-level op."""
        if not self.count:
            return 0.0
        target = min(self.count - 1, int(q * self.count))
        cum = self._nonpos
        if cum > target:
            return self.min
        for idx, n in sorted(self._buckets.items()):
            cum += n
            if cum > target:
                rep = math.exp((idx + 0.5) * self._GROWTH_LOG)
                return min(self.max, max(self.min, rep))
        return self.max

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count, "sum": self.sum}
        if not self.count:
            return out
        out.update(min=self.min, max=self.max, mean=self.sum / self.count)
        for q, label in ((0.5, "p50"), (0.9, "p90"), (0.95, "p95"),
                         (0.99, "p99")):
            out[label] = self.quantile(q)
        return out


class _Span:
    """Context manager recording one timed span; nests via a per-instance
    stack so the event carries its parent's name."""

    __slots__ = ("_tel", "name", "attrs", "_start", "_parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.attrs = attrs
        self._start = 0.0
        self._parent: Optional[str] = None

    def __enter__(self) -> "_Span":
        stack = self._tel._span_stack
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._start
        stack = self._tel._span_stack
        if stack and stack[-1] == self.name:
            stack.pop()
        self._tel._emit({"kind": "span", "name": self.name,
                         "dur_s": dur, "parent": self._parent,
                         **({"attrs": self.attrs} if self.attrs else {})})
        return False


class _NullSpan:
    """The disabled span: nothing measured, nothing emitted."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Telemetry:
    """Process-local registry + JSONL sink.

    One instance per process; the file is ``telemetry/rank<N>.jsonl``
    under the run's RSL_PATH.  Disabled instances never touch the
    filesystem: every method is a cheap no-op.
    """

    def __init__(self, enabled: bool = False, rsl_path: str = ".",
                 rank: int = 0):
        self.enabled = enabled
        self.rank = rank
        self._dir = os.path.join(rsl_path, "telemetry")
        self._path = os.path.join(self._dir, f"rank{rank}.jsonl")
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._span_stack: List[str] = []
        self._buffer: List[str] = []
        # REENTRANT on purpose: the preempt signal handler
        # (utils.GracefulShutdown) calls event() on the main thread and
        # may interrupt a frame that already holds this lock — a plain
        # Lock self-deadlocks there, hanging the run the handler exists
        # to stop cleanly.
        self._lock = threading.RLock()
        self._file = None
        self.write_errors = 0
        self._sink_dead = False

    # -- registry -----------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def span(self, name: str, **attrs: Any):
        """Timed context manager; emits a span event on exit.  The
        disabled instance returns a shared no-op (no clock reads)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Point event (preemption, run metadata, ...)."""
        self._emit({"kind": "event", "name": name,
                    **({"attrs": attrs} if attrs else {})})

    # -- sink ---------------------------------------------------------

    def _emit(self, payload: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        # Paired stamps — see the module-docstring timestamp contract.
        line = encode_line(stamp_record(payload, ts=time.time(),
                                        mono=time.monotonic(),
                                        rank=self.rank))
        with self._lock:
            self._buffer.append(line)
            if len(self._buffer) >= _FLUSH_EVERY:
                self._write_locked()

    def _write_locked(self) -> None:
        if not self._buffer:
            return
        if self._sink_dead:
            # An earlier write failed: telemetry is observability, not
            # training state — drop events rather than retry a dead disk
            # on every flush (the report shows the write_errors count).
            self._buffer.clear()
            return
        try:
            from . import faults

            faults.fire("telemetry.write")
            if self._file is None:
                os.makedirs(self._dir, exist_ok=True)
                self._file = open(self._path, "a", encoding="utf-8")
            self._file.write("\n".join(self._buffer) + "\n")
            self._file.flush()
        except OSError as e:
            # A full/unwritable disk must never kill the run: count it,
            # disable this rank's sink, carry on.
            self.write_errors += 1
            self._sink_dead = True
            logging.error(
                f"telemetry: cannot write {self._path!r} ({e}); "
                f"disabling further telemetry writes for rank "
                f"{self.rank} — training continues")
        self._buffer.clear()

    def flush(self) -> None:
        """Write buffered events to disk (epoch boundaries; cheap when
        nothing is pending)."""
        if not self.enabled:
            return
        with self._lock:
            self._write_locked()

    def close(self) -> None:
        """Emit counter/histogram summaries, flush, close the file.
        Idempotent: the instance is disabled afterwards, so a second
        close (or a late emit) is a no-op rather than a duplicate
        summary block."""
        if not self.enabled:
            return
        if self.write_errors:
            self.counter("telemetry/write_errors").add(self.write_errors)
            # One last attempt for the summaries below: the condition
            # (disk full, quota) may have cleared since the failure, and
            # the write_errors counter is how the report learns events
            # were dropped.  Failing again just re-kills the sink.
            self._sink_dead = False
        for c in self._counters.values():
            self._emit({"kind": "counter", "name": c.name,
                        "value": c.value})
        for h in self._histograms.values():
            self._emit({"kind": "histogram", "name": h.name, **h.summary()})
        with self._lock:
            self._write_locked()
            if self._file is not None:
                self._file.close()
                self._file = None
        self.enabled = False


_active = Telemetry(enabled=False)


def get() -> Telemetry:
    """The process's active telemetry (a disabled no-op by default)."""
    return _active


def configure(rsl_path: str, enabled: bool, rank: int) -> Telemetry:
    """Install the process's telemetry instance; the caller passes its
    rank (runtime.process_index()).  A previous enabled instance is
    closed first."""
    global _active
    if _active.enabled:
        _active.close()
    _active = Telemetry(enabled=enabled, rsl_path=rsl_path, rank=rank)
    return _active
