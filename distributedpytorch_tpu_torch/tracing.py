"""Per-request tracing for the serving tier.

A verbatim copy of ``distributedpytorch_tpu/tracing.py`` (stdlib only),
kept in the port so the port imports nothing of the JAX package.

The serving tier's aggregate surface (``serve/request_latency_ms``
p95s, shed counters) answers "is the tier healthy"; this module answers
the next question an incident asks: "WHICH request, and where did its
time go?"  Every valid ``/predict`` request gets a deterministic id —
``r<rank>-<seq>``, the rank's admission sequence number, no randomness
— returned to the client as an ``X-DPT-Request-Id`` header and threaded
through the micro-batcher, so the request accumulates a span chain:

  queue_wait   admit() -> the dispatcher pops it from the queue
  batch_form   pop -> the padded batch is assembled, infer dispatching
  infer        the injected predict program (per-batch, shared by every
               request in the bucket)
  respond      infer done -> the 200/500 is written back to the socket

Shed (503) and timeout (504) requests get a terminal ``shed`` /
``timeout`` span instead, so badput is traceable per request, not just
counted.  Spans are measured as a CHAIN of ``perf_counter`` stamps —
each span starts where the previous ended — so by construction
``sum(spans) == total_s`` (admission to answer), and the sum of the
pre-respond spans reconciles against the ``serve/request_latency_ms``
histogram observation for the same request (same contract discipline
as the goodput ledger's >=99% wall reconciliation; pinned by
tests/test_tracing.py and the serve gate).

One JSON record per request is appended to
``RSL_PATH/trace-rank<N>.jsonl`` at terminal time (the handler thread
answering the client writes it — exactly-once, guarded by the tracer
lock).  Record schema:

  {"kind": "request", "id": "r0-000007", "rank": 0, "seq": 7,
   "ts": <wall at finish>, "mono": <monotonic at finish>,
   "ts_admit": <wall at admission>, "mono_admit": <monotonic>,
   "status": 200, "outcome": "answered",      # answered|shed|timeout|failed
   "bucket": 4,                               # answered/failed only
   "spans": {"queue_wait": s, "batch_form": s, "infer": s, "respond": s},
   "total_s": <sum of spans>, "latency_ms": <histogram observation>,
   "lineage": "<sha256[:12]>"}   # serving lineage id, when set — the
                                 # checkpoint version that answered
                                 # (set_lineage; updated per hot-swap)

Clock contract (telemetry.py): ``ts`` stamps are wall clock and never
subtracted; ``mono`` orders records; every duration is a perf_counter
difference.  ``main.py timeline`` renders the records as a per-request
track, ``main.py fleet`` mines them for the offending ids in SLO
incident bundles, and the disabled default (``Tracer(enabled=False)``)
keeps train/test paths at zero cost, same shape as telemetry.get().
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

#: span names in chain order — rendering and reconciliation walk this.
SPAN_ORDER = ("queue_wait", "batch_form", "infer", "respond", "shed",
              "timeout")

#: outcomes that did not answer a 200 — the badput set incident bundles
#: and gates mine for offending request ids.
BAD_OUTCOMES = ("failed", "shed", "timeout")

_ID_RE = re.compile(r"^r(\d+)-(\d+)$")


def request_id(rank: int, seq: int) -> str:
    """The deterministic request id: ``r<rank>-<seq>`` (no randomness —
    the id IS the rank + admission order)."""
    return "r%d-%06d" % (rank, seq)


def build_request_record(*, rank: int, seq: int, ts_admit: float,
                         mono_admit: float, status: int, outcome: str,
                         spans: Dict[str, float], ts: float, mono: float,
                         bucket: Optional[int] = None,
                         latency_ms: Optional[float] = None,
                         attrs: Optional[Dict[str, Any]] = None,
                         lineage: Optional[str] = None) -> Dict[str, Any]:
    """One trace record, schema-factory form (shared with the fleet
    simulator, which passes virtual clocks): the rounding rules and the
    ``total_s == sum(spans)`` chain invariant live HERE, once, so the
    simulated stream reconciles through :func:`reconcile` by the same
    construction the live stream does."""
    record: Dict[str, Any] = {
        "kind": "request", "id": request_id(rank, seq), "seq": int(seq),
        "rank": int(rank),
        "ts_admit": ts_admit, "mono_admit": mono_admit,
        "status": int(status), "outcome": outcome,
        "spans": {k: round(float(v), 6) for k, v in spans.items()},
        "total_s": round(sum(float(v) for v in spans.values()), 6),
        "ts": ts, "mono": mono,
    }
    if bucket is not None:
        record["bucket"] = int(bucket)
    if latency_ms is not None:
        record["latency_ms"] = round(float(latency_ms), 3)
    if attrs:
        record["attrs"] = attrs
    if lineage is not None:
        record["lineage"] = lineage
    return record


def encode_record(record: Dict[str, Any]) -> str:
    """Canonical serialization (sorted keys) — the byte-stable form
    both the live writer and the simulator append."""
    return json.dumps(record, sort_keys=True, default=float)


class RequestTrace:
    """One request's span chain.  The handler thread creates it and
    finishes it; the dispatcher thread marks the dequeue/infer boundaries in
    between — the phases are sequenced by the batcher handoff and the
    request's done-event, so each stamp has a single writer."""

    __slots__ = ("id", "seq", "ts_admit", "mono_admit", "spans", "bucket",
                 "latency_ms", "_tracer", "_mark", "_finished")

    def __init__(self, tracer: "Tracer", seq: int):
        self.id = request_id(tracer.rank, seq)
        self.seq = seq
        self.ts_admit = time.time()
        self.mono_admit = time.monotonic()
        self.spans: Dict[str, float] = {}
        self.bucket: Optional[int] = None
        self.latency_ms: Optional[float] = None
        self._tracer = tracer
        self._mark = time.perf_counter()
        self._finished = False

    # -- span chain (each closes the span since the previous mark) -----

    def _close(self, name: str) -> None:
        now = time.perf_counter()
        self.spans[name] = self.spans.get(name, 0.0) + (now - self._mark)
        self._mark = now

    def mark_admitted(self) -> None:
        """The batcher accepted the request: restart the chain so
        ``queue_wait`` measures queue time, not parse time."""
        self.ts_admit = time.time()
        self.mono_admit = time.monotonic()
        self._mark = time.perf_counter()

    def mark_dequeued(self) -> None:
        self._close("queue_wait")

    def mark_infer_start(self, bucket: int) -> None:
        self.bucket = int(bucket)
        self._close("batch_form")

    def mark_infer_end(self) -> None:
        self._close("infer")

    def note_latency(self, latency_ms: float) -> None:
        """The dispatcher's serve/request_latency_ms observation for this
        request — the value the span sum reconciles against."""
        self.latency_ms = round(float(latency_ms), 3)

    # -- terminal ------------------------------------------------------

    def finish(self, status: int, outcome: str, **attrs: Any) -> None:
        """Close the terminal span and write the record (exactly once —
        a 504'd request whose batch later completes must not write a
        second record)."""
        terminal = {"shed": "shed", "timeout": "timeout"}.get(outcome,
                                                              "respond")
        self._close(terminal)
        self._tracer._write(self, status=int(status), outcome=outcome,
                            attrs=attrs or None)


class Tracer:
    """Per-rank trace sink: id allocation + the JSONL writer.  Disabled
    instances allocate nothing and write nothing (``start()`` returns
    None), so the train/test paths stay at zero cost."""

    def __init__(self, enabled: bool = False, rsl_path: str = ".",
                 rank: int = 0):
        self.enabled = enabled
        self.rank = int(rank)
        self.path = os.path.join(rsl_path, f"trace-rank{self.rank}.jsonl")
        self.write_errors = 0
        self.lineage: Optional[str] = None
        self._seq = 0
        self._lock = threading.Lock()
        self._file = None
        self._sink_dead = False

    def set_lineage(self, sha256: Optional[str]) -> None:
        """The serving lineage id (the served checkpoint's sha256): stamped into every subsequent record so an
        incident can say WHICH model version answered each request —
        updated at startup and at every /admin/reload hot-swap."""
        self.lineage = str(sha256)[:12] if sha256 else None

    def start(self) -> Optional[RequestTrace]:
        """Allocate the next request id and its trace (None when
        disabled — callers guard with ``if trace is not None``)."""
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            return RequestTrace(self, self._seq)

    def _write(self, trace: RequestTrace, *, status: int, outcome: str,
               attrs: Optional[Dict[str, Any]]) -> None:
        # Paired stamps at terminal time — the clock contract's
        # stamp-only wall time plus the ordering clock.
        record = build_request_record(
            rank=self.rank, seq=trace.seq,
            ts_admit=trace.ts_admit, mono_admit=trace.mono_admit,
            status=status, outcome=outcome, spans=trace.spans,
            ts=time.time(), mono=time.monotonic(),
            bucket=trace.bucket, latency_ms=trace.latency_ms,
            attrs=attrs, lineage=self.lineage)
        with self._lock:
            if trace._finished:
                return  # the 504-then-late-complete race: first wins
            trace._finished = True
            if self._sink_dead:
                return
            try:
                if self._file is None:
                    os.makedirs(os.path.dirname(self.path) or ".",
                                exist_ok=True)
                    self._file = open(self.path, "a", encoding="utf-8")
                self._file.write(encode_record(record) + "\n")
                # Requests are orders of magnitude rarer than train
                # steps: flush per record so gates and the fleet
                # collector read complete records mid-run.
                self._file.flush()
            except OSError as e:
                # Observability must never take the tier down: count,
                # kill this sink, keep serving.
                self.write_errors += 1
                self._sink_dead = True
                logging.error(
                    f"tracing: cannot write {self.path!r} ({e}); "
                    f"disabling request traces for rank {self.rank} — "
                    f"serving continues")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
        self.enabled = False


_active = Tracer(enabled=False)


def get() -> Tracer:
    """The process's active tracer (a disabled no-op by default)."""
    return _active


def configure(rsl_path: str, enabled: bool, rank: int = 0) -> Tracer:
    """Install the process's tracer (run_serve calls this once, after
    runtime init so the rank is the global process index)."""
    global _active
    _active.close()
    _active = Tracer(enabled=enabled, rsl_path=rsl_path, rank=rank)
    return _active


# -- offline readers (timeline, incidents, gates) ----------------------

def load_records(rsl_path: str) -> List[Dict[str, Any]]:
    """Every request record under ``rsl_path/trace-rank*.jsonl``, torn
    tails tolerated (a record interrupted mid-write parses as garbage
    and is skipped, same stance as telemetry.load_events)."""
    records: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(rsl_path,
                                              "trace-rank*.jsonl"))):
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail mid-write
                    if isinstance(rec, dict) \
                            and rec.get("kind") == "request":
                        records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("rank", 0), r.get("seq", 0)))
    return records


def span_sum_s(record: Dict[str, Any],
               through: Optional[str] = None) -> float:
    """Sum of a record's spans in chain order, optionally only through
    the named span (``through="infer"`` gives the portion the
    serve/request_latency_ms observation covers)."""
    spans = record.get("spans", {})
    total = 0.0
    for name in SPAN_ORDER:
        if name in spans:
            total += float(spans[name])
        if name == through:
            break
    return total


def reconcile(records: List[Dict[str, Any]],
              tolerance_ms: float = 50.0,
              rel_tolerance: float = 0.2) -> List[str]:
    """The trace contract check, shared by tests and gates: every
    record's span sum equals its total, and for answered requests the
    pre-respond span sum matches the latency the histogram observed
    (within ``max(tolerance_ms, rel_tolerance * latency)``).  Returns
    one actionable line per violation — empty means reconciled."""
    problems: List[str] = []
    for rec in records:
        rid = rec.get("id", "?")
        total = float(rec.get("total_s", 0.0))
        sum_all = span_sum_s(rec)
        if abs(sum_all - total) > 1e-3:
            problems.append(
                f"{rid}: span sum {sum_all:.6f}s != total_s "
                f"{total:.6f}s — the span chain is torn")
        if rec.get("outcome") != "answered" \
                or rec.get("latency_ms") is None:
            continue
        latency_ms = float(rec["latency_ms"])
        core_ms = span_sum_s(rec, through="infer") * 1000.0
        tol = max(tolerance_ms, rel_tolerance * latency_ms)
        if abs(core_ms - latency_ms) > tol:
            problems.append(
                f"{rid}: pre-respond span sum {core_ms:.1f}ms vs "
                f"serve/request_latency_ms observation "
                f"{latency_ms:.1f}ms — off by more than {tol:.1f}ms")
    return problems


def rank_of_id(request_id: str) -> Optional[int]:
    """The rank encoded in a request id (``r1-000007`` -> 1), or None
    for a malformed id — incident bundles use this to name the replica
    an offending request died on."""
    m = _ID_RE.match(request_id or "")
    return int(m.group(1)) if m else None
