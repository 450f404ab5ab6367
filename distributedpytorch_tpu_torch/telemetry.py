"""Structured telemetry: per-rank JSONL counters, gauges, histograms,
spans and events.

Counterpart of ``distributedpytorch_tpu/telemetry.py`` (the emitter,
:65-468), in the same JSONL schema, so the JAX package's ``telemetry``
report reads the port's files.  The rank is passed explicitly to
``configure`` (the JAX version reads ``jax.process_index()``).  The
offline readers (``load_events``, ``aggregate``, ``render_report``,
``report``, ``json_report``, JAX :474-789) are copied, so the
``telemetry`` subcommand prints what the JAX one prints for the same
files.

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
from typing import Any, Dict, Iterable, List, Optional

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

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another sketch into this one, in place.  Bucket-wise
        addition is EXACT for the sketch: both sides bucket values by
        the same geometric boundaries, so the merged sketch is
        identical to one that observed both streams directly — the
        merged quantile carries the same <=1% representative error as
        a single-rank sketch, never more.  This is what makes fleet
        p95s possible at all: raw per-rank quantiles don't merge, the
        sketches they came from do (fleet.py's core primitive)."""
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self._nonpos += other._nonpos
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        return self

    @classmethod
    def from_parts(cls, name: str, count: int, total: float,
                   lo: float, hi: float, buckets: Dict[int, int],
                   nonpos: int = 0) -> "Histogram":
        """Rebuild a sketch from its serialized state (the fleet
        collector reconstructs per-rank sketches from the Prometheus
        ``_bucket{le=...}`` exposition, then merge()s them)."""
        h = cls(name)
        h.count = int(count)
        h.sum = float(total)
        h.min = float(lo) if count else math.inf
        h.max = float(hi) if count else -math.inf
        h._nonpos = int(nonpos)
        h._buckets = {int(k): int(v) for k, v in buckets.items()
                      if int(v) > 0}
        return h


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

    def metrics_snapshot(self):
        """Stable views of the live registries for out-of-band readers
        (the /metrics exporter's scrape threads): each list() copy is one
        C-level operation, atomic under the GIL."""
        return (list(self._counters.values()), list(self._gauges.values()),
                list(self._histograms.values()))

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


# -- report: aggregate per-rank JSONL into a human-readable summary ----


def load_events(telemetry_dir: str) -> List[Dict[str, Any]]:
    """All events from every ``rank*.jsonl`` under ``telemetry_dir``.
    Lines that fail to parse are skipped (a run killed mid-write leaves
    at most one torn last line per file)."""
    events: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(telemetry_dir))
    except OSError as e:
        raise ValueError(
            f"no telemetry directory at {telemetry_dir!r} "
            f"({e.strerror or e}); run with --telemetry first") from e
    for fn in names:
        if not (fn.startswith("rank") and fn.endswith(".jsonl")):
            continue
        with open(os.path.join(telemetry_dir, fn), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    if not events:
        raise ValueError(f"no telemetry events under {telemetry_dir!r}")
    return events


def aggregate(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-rank aggregation: span stats by name, per-rank epoch means
    (straggler view), counter totals, latest gauges, starvation fraction.
    Pure data-in/data-out so tests (and notebooks) can assert on it."""
    spans: Dict[str, Dict[str, Any]] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, Dict[int, float]] = {}
    histograms: Dict[str, List[Dict[str, Any]]] = {}
    point_events: List[Dict[str, Any]] = []
    rank_epoch: Dict[int, List[float]] = {}
    ranks = set()
    skipped = 0
    for ev in events:
        # A rank file can be torn mid-write or hand-edited: an event
        # with a missing name or a non-numeric value must degrade to a
        # skipped line, never crash the whole report.
        try:
            rank = int(ev.get("rank", 0))
            kind, name = ev.get("kind"), ev.get("name")
            if not isinstance(name, str):
                skipped += 1
                continue
            if kind == "span":
                dur = float(ev.get("dur_s", 0.0))
                s = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                            "max_s": 0.0})
                s["count"] += 1
                s["total_s"] += dur
                s["max_s"] = max(s["max_s"], dur)
                if name == "epoch":
                    rank_epoch.setdefault(rank, []).append(dur)
            elif kind == "counter":
                counters[name] = counters.get(name, 0.0) \
                    + float(ev.get("value", 0.0))
            elif kind == "gauge":
                if ev.get("value") is not None:  # null = unavailable
                    gauges.setdefault(name, {})[rank] = float(ev["value"])
            elif kind == "histogram":
                histograms.setdefault(name, []).append(ev)
            elif kind == "event":
                point_events.append(ev)
            else:
                skipped += 1
                continue
            ranks.add(rank)
        except (TypeError, ValueError):
            skipped += 1
            continue
    for s in spans.values():
        s["mean_s"] = s["total_s"] / max(s["count"], 1)

    # Data-starvation fraction: host time blocked waiting on batches as a
    # share of the train passes it stalled (both from the same rank set).
    train_total = (spans.get("train_pass", {}).get("total_s", 0.0)
                   or spans.get("train_dispatch", {}).get("total_s", 0.0))
    wait = counters.get("data/wait_s", 0.0)
    starvation = wait / train_total if train_total > 0 else None

    return {
        "ranks": sorted(ranks),
        "skipped_events": skipped,
        "spans": spans,
        "counters": counters,
        "gauges": {name: {"latest_per_rank": per,
                          "mean": sum(per.values()) / len(per)}
                   for name, per in gauges.items()},
        "histograms": histograms,
        "events": point_events,
        "epoch_s_per_rank": {r: sum(v) / len(v)
                             for r, v in rank_epoch.items()},
        "data_starvation_fraction": starvation,
    }


def render_report(agg: Dict[str, Any]) -> str:
    """The human-readable summary the ``telemetry`` subcommand prints."""
    lines = []
    lines.append(f"telemetry report — {len(agg['ranks'])} rank(s): "
                 f"{agg['ranks']}")
    if agg.get("skipped_events"):
        lines.append(f"({agg['skipped_events']} malformed event(s) "
                     f"skipped)")
    # Writer-failure visibility (ISSUE 5 satellite): a rank whose JSONL
    # sink died mid-run reports a write_errors counter if its final
    # close-time write landed — and if it didn't, the rank is simply
    # missing from the files, which the run_start processes attr exposes.
    werr = agg["counters"].get("telemetry/write_errors")
    if werr:
        lines.append(f"WARNING: {int(werr)} telemetry write error(s) — "
                     f"some events were dropped (see run log)")
    expected = max((int(e.get("attrs", {}).get("processes", 0))
                    for e in agg["events"]
                    if e.get("name") == "run_start"), default=0)
    # A mid-run joiner announces itself with elastic/join: its stream
    # starting late (or reusing a departed rank's file) is by design.
    joined = sorted({int(e["attrs"]["new_rank"]) for e in agg["events"]
                     if e.get("name") == "elastic/join"
                     and isinstance(e.get("attrs"), dict)
                     and isinstance(e["attrs"].get("new_rank"), int)})
    if joined:
        lines.append(f"note: rank(s) {joined} joined mid-run in an "
                     f"elastic grow; their streams starting late is "
                     f"expected")
    if expected > len(agg["ranks"]):
        missing = sorted(set(range(expected)) - set(agg["ranks"]))
        # An elastic run changes membership by design: every member
        # emits an elastic/reconfigure (and a joiner an elastic/join)
        # event carrying its generation's new_world.  The current
        # world is the NEWEST generation's size — not the minimum over
        # the run, which a shrink-then-grow history would underread,
        # mislabeling readmitted rank slots as departed.  Missing rank
        # slots at/above the current world departed in a reconfigure —
        # a note, not a writer failure; anything below it really is a
        # lost/disabled writer.
        gens: Dict[int, int] = {}
        for e in agg["events"]:
            if e.get("name") not in ("elastic/reconfigure",
                                     "elastic/join"):
                continue
            attrs = e.get("attrs")
            if not isinstance(attrs, dict):
                continue
            g, w = attrs.get("generation"), attrs.get("new_world")
            if isinstance(g, int) and isinstance(w, int):
                gens[g] = w
        final_world = gens[max(gens)] if gens else expected
        departed = [r for r in missing if r >= final_world]
        missing = [r for r in missing if r < final_world]
        if departed:
            lines.append(f"note: rank(s) {departed} departed in an "
                         f"elastic reconfigure (world now "
                         f"{final_world}); their files ending early — "
                         f"or never landing — is expected, not loss")
        if missing:
            lines.append(f"WARNING: {expected} process(es) ran but only "
                         f"{len(agg['ranks'])} rank file(s) readable — "
                         f"rank(s) {missing} skipped (telemetry writer "
                         f"disabled or file lost)")

    spans = agg["spans"]
    if spans:
        lines.append("")
        lines.append("slowest spans (by total time):")
        lines.append(f"  {'span':<16} {'count':>6} {'total_s':>10} "
                     f"{'mean_s':>10} {'max_s':>10}")
        for name, s in sorted(spans.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {name:<16} {s['count']:>6} "
                         f"{s['total_s']:>10.3f} {s['mean_s']:>10.3f} "
                         f"{s['max_s']:>10.3f}")

    hists = agg["histograms"]
    if hists:
        lines.append("")
        lines.append("hot-path duration percentiles (per-step histograms; "
                     "count-weighted across ranks):")
        lines.append(f"  {'histogram':<20} {'count':>8} {'p50':>10} "
                     f"{'p95':>10} {'p99':>10} {'max':>10}")
        for name in sorted(hists):
            summaries = [h for h in hists[name] if h.get("count")]
            if not summaries:
                continue
            n = sum(int(h["count"]) for h in summaries)

            def _wq(label, summaries=summaries, n=n):
                # Exact per-rank quantiles don't merge; the count-weighted
                # mean is the documented approximation (single-rank runs —
                # the common case — are exact).  Live sketches DO merge
                # (Histogram.merge, the fleet collector's path) but the
                # JSONL summary events here carry only the quantiles, not
                # the buckets, so the report keeps the approximation.
                vals = [(float(h.get(label, 0.0)), int(h["count"]))
                        for h in summaries if label in h]
                if not vals:
                    return 0.0
                return sum(v * c for v, c in vals) / sum(c for _, c in vals)

            mx = max(float(h.get("max", 0.0)) for h in summaries)
            lines.append(f"  {name:<20} {n:>8} {_wq('p50'):>10.4f} "
                         f"{_wq('p95'):>10.4f} {_wq('p99'):>10.4f} "
                         f"{mx:>10.4f}")

    per_rank = agg["epoch_s_per_rank"]
    if len(per_rank) > 1:
        slowest = max(per_rank, key=per_rank.get)
        fastest = min(per_rank, key=per_rank.get)
        lines.append("")
        lines.append("stragglers (mean epoch seconds per rank):")
        for r in sorted(per_rank):
            tag = (" <- slowest" if r == slowest else
                   " <- fastest" if r == fastest else "")
            lines.append(f"  rank {r}: {per_rank[r]:.3f}s{tag}")

    frac = agg["data_starvation_fraction"]
    if frac is not None:
        lines.append("")
        lines.append(f"data starvation: {frac * 100:.1f}% of train time "
                     f"spent waiting on batches "
                     f"({agg['counters'].get('data/wait_s', 0.0):.3f}s)")
    starved = agg["counters"].get("data/starved_steps")
    batches = agg["counters"].get("data/batches")
    if starved is not None and batches:
        lines.append(f"prefetch: {int(starved)}/{int(batches)} steps found "
                     f"the queue empty")
    warm = agg["counters"].get("data/warmup_s")
    if warm is not None:
        lines.append(f"prefetch warmup (initial fill): {warm:.3f}s "
                     f"(excluded from wait_s)")

    gauges = agg["gauges"]
    tput = gauges.get("throughput/samples_per_sec_per_chip")
    if tput:
        lines.append("")
        lines.append(f"throughput: {tput['mean']:,.0f} samples/s/chip "
                     f"(latest per rank: "
                     f"{ {r: round(v, 1) for r, v in sorted(tput['latest_per_rank'].items()) } })")
    mfu = gauges.get("throughput/mfu")
    if mfu:
        lines.append(f"MFU: {mfu['mean'] * 100:.1f}%")

    warmup = gauges.get("compile/warmup_s")
    if warmup:
        hit = gauges.get("compile/cache_hit", {}).get("mean")
        lines.append(f"compile warmup: {warmup['mean']:.3f}s"
                     + (f" (persistent-cache hit: "
                        f"{'yes' if hit else 'no'})"
                        if hit is not None else ""))

    ckpt = {n: s for n, s in spans.items()
            if n in ("ckpt_save", "ckpt_restore", "ckpt_save_blocking",
                     "ckpt_save_background")}
    for name, s in sorted(ckpt.items()):
        lines.append(f"{name}: {s['count']}x, total {s['total_s']:.3f}s, "
                     f"mean {s['mean_s']:.3f}s")
    blocking = spans.get("ckpt_save_blocking")
    background = spans.get("ckpt_save_background")
    if blocking and background:
        total = blocking["total_s"] + background["total_s"]
        if total > 0:
            lines.append(
                f"async checkpointing: {blocking['total_s']:.3f}s of "
                f"{total:.3f}s save time on the critical path "
                f"({blocking['total_s'] / total * 100:.1f}%)")

    # Serving saturation (ISSUE 15): the tier's one-look health — how
    # much load arrived, how much was shed at the bounded queue (the
    # saturation fraction), and how well the micro-batcher filled its
    # buckets (padding is paid compute).  The latency percentiles are
    # already in the histogram table above (serve/request_latency_ms).
    requests = agg["counters"].get("serve/requests")
    if requests:
        shed = agg["counters"].get("serve/shed", 0.0)
        answered = agg["counters"].get("serve/answered", 0.0)
        failed = agg["counters"].get("serve/failed", 0.0)
        lines.append("")
        lines.append(f"serving: {int(requests)} requests — "
                     f"{int(answered)} answered, {int(failed)} failed, "
                     f"{int(shed)} shed at the full queue "
                     f"(saturation {shed / requests * 100:.1f}%)")
        sbatches = agg["counters"].get("serve/batches")
        rows = agg["counters"].get("serve/batch_rows", 0.0)
        padded = agg["counters"].get("serve/padded_rows", 0.0)
        if sbatches and rows:
            lines.append(
                f"  micro-batches: {int(sbatches)} dispatched, mean "
                f"fill {(rows - padded) / sbatches:.1f} rows, padding "
                f"overhead {padded / rows * 100:.1f}% of batch rows")

    preempts = [e for e in agg["events"] if e.get("name") == "preempt"]
    if preempts:
        lines.append(f"preemption events: {len(preempts)}")
    return "\n".join(lines)


def report(rsl_path: str) -> str:
    """Load + aggregate + render for a run directory (CLI entry)."""
    return render_report(aggregate(load_events(
        os.path.join(rsl_path, "telemetry"))))


def json_report(rsl_path: str) -> str:
    """The same aggregate render_report formats, as JSON — the
    machine-readable face gate scripts and bench_trend consume instead
    of scraping the human text (ISSUE 12 satellite)."""
    agg = aggregate(load_events(os.path.join(rsl_path, "telemetry")))
    return json.dumps(agg, indent=2, sort_keys=True, default=float)
