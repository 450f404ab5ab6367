"""Goodput ledger + live Prometheus exporter.

Counterpart of ``distributedpytorch_tpu/goodput.py``, copied: the JAX
module is framework-free, and the port keeps its own copy (the port
imports nothing of the JAX package).  The ledger's document, ``report``
and the exporter's ``/metrics`` and ``/healthz`` are the JAX ones, so
the JAX package's ``goodput`` report reads the port's files.  One
change: the exporter's listener sizes its accept backlog
(``EXPORTER_BACKLOG``) instead of socketserver's 5, as the port's serving
listener does (``serving/server.py``), so a burst of scrapes is answered
rather than reset.

Attributes 100% of the main thread's wall clock to a closed set of
non-overlapping categories:

  ``compute``              step / eval dispatch (device work the main thread
                           is blocked on)
  ``compile``              the kernels' build and the AOT warmup
  ``data_wait``            consumer-side input starvation (the step
                           loop's inter-step wait window)
  ``ckpt_blocking``        main-thread-blocking checkpoint windows
  ``retry_backoff``        retry sleeps on the main thread
  ``elastic_reconfigure``  park -> rendezvous -> reinit -> restore
  ``anomaly_capture``      flightrec profiler start/stop overhead
  ``collective_skew``      health-boundary straggler wait
  ``other``                the explicit residual — reported, not hidden

Accounting contract: at every ``reconcile()`` (epoch boundary) and at
``close()``, ``sum(categories) + other == wall clock`` exactly, with the
residual fraction recorded per window.  ``timed()`` windows subtract
time already attributed by nested hooks, and the step loop's ``step()``
charge does the same for its inter-step wait window.  Durations come
from ``time.perf_counter``; the rows carry ``mono`` END stamps for the
timeline and a ``ts`` wall stamp for humans.

Persistence: rank 0 writes ``RSL_PATH/goodput.json``; other ranks write
``goodput-rank<N>.json``.  ``python -m distributedpytorch_tpu_torch
goodput`` aggregates whatever subset exists.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

from . import telemetry

# The closed category set. "other" is the reconciliation residual and is
# never the target of an add() — it exists so the ledger sums to wall
# clock by construction instead of silently losing time.
CATEGORIES = (
    "compute",
    "compile",
    "data_wait",
    "ckpt_blocking",
    "retry_backoff",
    "elastic_reconfigure",
    "anomaly_capture",
    "collective_skew",
)
RESIDUAL = "other"


# -- ledger schema factories ------------------------------------------
#
# The persisted document shape is a CONTRACT shared by the live ledger
# below and the fleet simulator (sim/artifacts.py), which writes the
# same schema from a virtual clock.  Both go through these builders so
# the goodput report / the timeline category track render simulated
# fleets unchanged.

def build_epoch_row(*, epoch: Optional[int], wall_s: float, mono: float,
                    ts: float, residual_s: float,
                    categories: Dict[str, float]) -> Dict[str, Any]:
    """One reconcile-window row of the ledger's ``epochs`` list; the
    rounding rules live here, once."""
    return {
        "epoch": epoch,
        "wall_s": round(wall_s, 6),
        "mono": mono,               # END stamp for timeline
        "ts": ts,                   # stamp only, for humans
        "residual_s": round(residual_s, 6),
        "residual_frac": (round(residual_s / wall_s, 6)
                          if wall_s > 0 else 0.0),
        "categories": {c: round(v, 6) for c, v in categories.items()},
    }


def build_ledger_doc(*, rank: int, world: int, started_ts: float,
                     wall_s: float, totals: Dict[str, float],
                     epochs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The persisted ledger document (also what /metrics reads live)."""
    accounted = sum(totals.values())
    return {
        "version": 1,
        "rank": int(rank),
        "world": int(world),
        "started_ts": started_ts,
        "wall_s": round(wall_s, 6),
        "accounted_s": round(accounted, 6),
        "residual_frac": (round((wall_s - accounted) / wall_s, 6)
                          if wall_s > 0 else 0.0),
        "categories": {c: round(v, 6) for c, v in totals.items()},
        "epochs": list(epochs),
    }


def ledger_filename(rank: int) -> str:
    """Rank 0 owns the canonical ``goodput.json``; other ranks write
    rank-suffixed files (no shared-file write races)."""
    return ("goodput.json" if rank == 0
            else "goodput-rank%d.json" % rank)


def write_ledger_doc(rsl_path: str, doc: Dict[str, Any]) -> Optional[str]:
    """Atomically persist one ledger document under ``rsl_path``;
    returns the path, or None on an unwritable disk (never raises —
    the ledger is observability, not training state)."""
    path = os.path.join(rsl_path, ledger_filename(int(doc.get("rank", 0))))
    tmp = path + ".tmp"
    try:
        os.makedirs(rsl_path, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:  # pragma: no cover - disk-full etc.
        logging.warning("goodput: write failed (%s) — ledger lost", e)
        return None
    return path


class GoodputLedger:
    """Per-process wall-clock attribution ledger.

    Disabled instances are no-ops on every path (the zero-cost contract
    shared with telemetry/flightrec).  Only main-thread contributions
    are recorded: a sleep on a producer thread is not main-thread wall time
    — the main thread sees it (if at all) as data_wait through its own wait
    window, and counting both would break the sums-to-wall invariant.
    """

    def __init__(self, enabled: bool = False, rsl_path: Optional[str] = None,
                 rank: int = 0, world: int = 1):
        self.enabled = bool(enabled)
        self.rsl_path = rsl_path
        self.rank = int(rank)
        self.world = int(world)
        self._t0 = time.perf_counter()
        self._started_ts = time.time()  # stamp only, never subtracted
        self._totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._totals[RESIDUAL] = 0.0
        self._last: str = RESIDUAL
        # Nested-attribution bookkeeping (main thread only — no lock):
        # stack of accumulators for open timed() windows, plus one
        # optional accumulator for the step loop's inter-step window.
        self._frames: List[float] = []
        self._step_nested: Optional[float] = None
        self._epochs: List[Dict[str, Any]] = []
        self._mark_wall = 0.0
        self._mark_totals: Dict[str, float] = dict(self._totals)
        self._closed = False

    # -- attribution --------------------------------------------------

    def add(self, category: str, seconds: float) -> None:
        """Attribute ``seconds`` of main-thread wall clock to ``category``.

        Off-main-thread calls are dropped (see class docstring); the
        innermost open window absorbs the charge so enclosing windows
        don't count it twice.
        """
        if not self.enabled or seconds <= 0.0:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        self._totals[category] += seconds
        self._last = category
        if self._frames:
            self._frames[-1] += seconds
        elif self._step_nested is not None:
            self._step_nested += seconds

    @contextmanager
    def timed(self, category: str) -> Iterator[None]:
        """Charge the body's elapsed time to ``category``, minus any
        time nested hooks already attributed (retry sleeps inside a
        checkpoint save count once, as retry_backoff)."""
        if not self.enabled:
            yield
            return
        self._frames.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            nested = self._frames.pop()
            self.add(category, max(0.0, dt - nested))

    def begin_steps(self) -> None:
        """Open the step loop's inter-step accounting window.  Call once
        at the top of each streaming step loop."""
        if self.enabled:
            self._step_nested = 0.0

    def step(self, dispatch_s: float, wait_s: float) -> str:
        """Per-step charge: dispatch -> compute, inter-step wait ->
        data_wait (minus time nested hooks already claimed from the
        wait window).  Returns the step's dominant category — this is
        what the flight recorder stores per ring slot."""
        if not self.enabled:
            return "compute" if dispatch_s >= wait_s else "data_wait"
        nested = self._step_nested or 0.0
        self._step_nested = 0.0
        wait = max(0.0, wait_s - nested)
        self.add("data_wait", wait)
        self.add("compute", max(0.0, dispatch_s))
        # The adds above landed in _step_nested; reset so the next
        # step's wait window is measured from zero.
        self._step_nested = 0.0
        return "compute" if dispatch_s >= wait else "data_wait"

    def end_steps(self) -> None:
        """Close the step loop's accounting window (end of epoch)."""
        self._step_nested = None

    def current(self) -> str:
        """The category this rank most recently spent time in — what a
        crash dump should say the rank was doing when it died."""
        return self._last

    # -- reconciliation & persistence ---------------------------------

    def reconcile(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """Close the accounting window since the previous reconcile:
        the window's unattributed time becomes an explicit ``other``
        charge so categories sum to wall clock exactly.  Returns the
        per-window row (also persisted)."""
        if not self.enabled:
            return {}
        wall = time.perf_counter() - self._t0
        window = wall - self._mark_wall
        deltas = {c: self._totals[c] - self._mark_totals.get(c, 0.0)
                  for c in self._totals}
        accounted = sum(deltas.values())
        residual = window - accounted
        # Attribute the residual explicitly; clamp tiny negative skew
        # (float rounding across thousands of adds) at zero.
        self._totals[RESIDUAL] += max(0.0, residual)
        deltas[RESIDUAL] += max(0.0, residual)
        row = build_epoch_row(epoch=epoch, wall_s=window,
                              mono=time.monotonic(), ts=time.time(),
                              residual_s=residual, categories=deltas)
        self._epochs.append(row)
        self._mark_wall = wall
        self._mark_totals = dict(self._totals)
        self._step_nested = None
        return row

    def snapshot(self) -> Dict[str, Any]:
        """The persisted document (also what /metrics reads live)."""
        wall = time.perf_counter() - self._t0
        return build_ledger_doc(rank=self.rank, world=self.world,
                                started_ts=self._started_ts,
                                wall_s=wall, totals=self._totals,
                                epochs=self._epochs)

    def write(self) -> Optional[str]:
        """Atomically persist the ledger under rsl_path (see
        :func:`write_ledger_doc` for the filename convention)."""
        if not self.enabled or not self.rsl_path:
            return None
        return write_ledger_doc(self.rsl_path, self.snapshot())

    def close(self) -> None:
        """Final reconcile (tail window after the last epoch) + write +
        disable.  Idempotent — elastic.quiesce_exit and the run_train
        finally block may both reach it."""
        if not self.enabled or self._closed:
            return
        self._closed = True
        self.reconcile(epoch=None)
        self.write()
        self.enabled = False


# -- module-level singleton (mirrors telemetry/flightrec) -------------

_active = GoodputLedger(enabled=False)


def get() -> GoodputLedger:
    return _active


def configure(rsl_path: Optional[str], enabled: bool, rank: int = 0,
              world: int = 1) -> GoodputLedger:
    global _active
    if _active.enabled:
        _active.close()
    _active = GoodputLedger(enabled=enabled, rsl_path=rsl_path, rank=rank,
                            world=world)
    return _active


# -- reading & summarizing persisted ledgers --------------------------

def load_ledgers(rsl_path: str) -> Dict[int, Dict[str, Any]]:
    """All persisted ledgers under ``rsl_path``, keyed by rank."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(rsl_path))
    except OSError:
        return out
    for name in names:
        if name != "goodput.json" and not (
                name.startswith("goodput-rank") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(rsl_path, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            logging.warning("goodput: skipping unreadable %s (%s)", name, e)
            continue
        out[int(doc.get("rank", 0))] = doc
    return out


def report(rsl_path: str) -> str:
    """Human summary: per-rank attribution plus a fleet aggregate with
    the top badput cause called out.  Raises ValueError when no ledger
    exists (mirrors telemetry.report)."""
    ledgers = load_ledgers(rsl_path)
    if not ledgers:
        raise ValueError("no goodput ledger under %s — run with --telemetry "
                         "or --metrics-port" % rsl_path)
    lines: List[str] = ["goodput — wall-clock attribution (%s)" % rsl_path]
    fleet: Dict[str, float] = {}
    fleet_wall = 0.0
    order = list(CATEGORIES) + [RESIDUAL]
    for rank in sorted(ledgers):
        doc = ledgers[rank]
        wall = float(doc.get("wall_s", 0.0)) or 1e-9
        cats = doc.get("categories", {})
        fleet_wall += wall
        for c, v in cats.items():
            fleet[c] = fleet.get(c, 0.0) + float(v)
        lines.append("  rank %d — wall %.2fs, residual %.2f%%" % (
            rank, wall, 100.0 * float(doc.get("residual_frac", 0.0))))
        for c in order:
            v = float(cats.get(c, 0.0))
            if v > 0.0005:
                lines.append("    %-20s %8.2fs  %5.1f%%" % (
                    c, v, 100.0 * v / wall))
    fleet_wall = fleet_wall or 1e-9
    goodput = fleet.get("compute", 0.0)
    lines.append("  fleet — %d rank(s), wall %.2fs, goodput (compute) %.1f%%"
                 % (len(ledgers), fleet_wall, 100.0 * goodput / fleet_wall))
    badput = {c: v for c, v in fleet.items() if c != "compute" and v > 0}
    if badput:
        top = max(badput, key=lambda c: badput[c])
        lines.append("  top badput cause: %s (%.2fs, %.1f%% of wall)" % (
            top, badput[top], 100.0 * badput[top] / fleet_wall))
    # The ledger says WHERE the wall clock went; the roofline report
    # (when this run profiled) says WHICH op the compute share went to
    # — point at it so the two layers read as one story.
    rl_path = os.path.join(rsl_path, "roofline.json")
    try:
        with open(rl_path) as f:
            rl = json.load(f)
        tops = [r.get("name") for r in (rl.get("ops") or [])[:3]]
        lines.append(
            "  op-level blame: %s — top ops %s "
            "(%.1f%% of step time attributed; see `main.py roofline`)"
            % (rl_path, ", ".join(t for t in tops if t) or "-",
               100.0 * float(rl.get("coverage") or 0.0)))
    except (OSError, ValueError):
        pass
    return "\n".join(lines)


# -- live exporter (/metrics + /healthz) ------------------------------

# The exporter's accept backlog: a fleet collector or a burst of
# dashboards scraping every rank at once must queue, not be reset (the
# JAX exporter keeps socketserver's 5).
EXPORTER_BACKLOG = 128

def _prom_name(name: str) -> str:
    """Telemetry names are slash/dot-spaced ("data/wait_s"); Prometheus
    wants [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "dpt_" + s


class MetricsExporter:
    """Per-rank daemon-thread HTTP server: ``/metrics`` (Prometheus
    text exposition of all telemetry counters/gauges, histogram
    quantiles, and goodput category totals) and ``/healthz`` (rank,
    world size, elastic generation, last-step age as JSON).

    Scrape threads only read; the training loop's only write is the
    ``note_step`` stamp, guarded by ``_lock``.  ``close()`` shuts the
    listener down and joins the serve thread — no leaked sockets or
    threads after run_train's finally block or elastic.quiesce_exit.
    """

    def __init__(self, port: int, rank: int = 0,
                 world_size_fn: Optional[Callable[[], int]] = None,
                 generation_fn: Optional[Callable[[], int]] = None):
        import http.server

        self.port = int(port)
        self.rank = int(rank)
        self._world_size_fn = world_size_fn or (lambda: 1)
        self._generation_fn = generation_fn or (lambda: 0)
        self._health_extra_fn: Optional[Callable[[], Dict[str, Any]]] \
            = None
        self._lock = threading.Lock()
        self._last_step_mono: Optional[float] = None  # guarded by _lock
        exporter = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.startswith("/metrics"):
                    body = exporter.render_metrics().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/healthz"):
                    body = json.dumps(exporter.health()).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes are high-frequency; keep the run log clean

        class _Listener(http.server.ThreadingHTTPServer):
            request_queue_size = EXPORTER_BACKLOG

        self._server = _Listener(("0.0.0.0", self.port), _Handler)
        self.port = self._server.server_address[1]  # resolve port=0
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.25},
            name="metrics-exporter", daemon=True)
        self._thread.start()

    # -- training-loop updates ------------------------------------------

    def note_step(self) -> None:
        """Stamp 'a train step just finished' for /healthz freshness."""
        with self._lock:
            self._last_step_mono = time.monotonic()

    # -- rendering (called from scrape threads) -----------------------

    def render_metrics(self) -> str:
        tel = telemetry.get()
        gp = get()
        lines: List[str] = []
        if tel.enabled:
            counters, gauges, histograms = tel.metrics_snapshot()
            for c in sorted(counters, key=lambda c: c.name):
                m = _prom_name(c.name) + "_total"
                lines.append("# TYPE %s counter" % m)
                lines.append("%s %.17g" % (m, c.value))
            for g in sorted(gauges, key=lambda g: g.name):
                if g.value is None:  # recorded-null gauge: nothing to scrape
                    continue
                m = _prom_name(g.name)
                lines.append("# TYPE %s gauge" % m)
                lines.append("%s %.17g" % (m, g.value))
            for h in sorted(histograms, key=lambda h: h.name):
                m = _prom_name(h.name)
                lines.append("# TYPE %s summary" % m)
                for q in (0.5, 0.95, 0.99):
                    lines.append('%s{quantile="%g"} %.17g'
                                 % (m, q, h.quantile(q)))
                lines.append("%s_count %d" % (m, h.count))
                lines.append("%s_sum %.17g" % (m, h.sum))
                if h.count:
                    # The sketch itself, as cumulative Prometheus-style
                    # buckets: le = the geometric upper boundary
                    # exp((idx+1)*log(1.02)).  Summary quantiles don't
                    # merge across ranks; these buckets do — the fleet
                    # collector reconstructs the sketch from this block
                    # (telemetry.Histogram.from_parts) and merge()s it
                    # bucket-wise, which is exact.
                    lines.append("%s_min %.17g" % (m, h.min))
                    lines.append("%s_max %.17g" % (m, h.max))
                    cum = h._nonpos
                    if cum:
                        lines.append('%s_bucket{le="0"} %d' % (m, cum))
                    growth = telemetry.Histogram._GROWTH_LOG
                    for idx in sorted(h._buckets):
                        cum += h._buckets[idx]
                        lines.append(
                            '%s_bucket{le="%.17g"} %d'
                            % (m, math.exp((idx + 1) * growth), cum))
                    lines.append('%s_bucket{le="+Inf"} %d'
                                 % (m, h.count))
        if gp.enabled:
            m = "dpt_goodput_seconds_total"
            lines.append("# TYPE %s counter" % m)
            for c, v in gp.snapshot()["categories"].items():
                lines.append('%s{category="%s"} %.17g' % (m, c, v))
        lines.append("# TYPE dpt_up gauge")
        lines.append("dpt_up 1")
        return "\n".join(lines) + "\n"

    def health(self) -> Dict[str, Any]:
        with self._lock:
            last = self._last_step_mono
        age = (time.monotonic() - last) if last is not None else None
        try:
            world = int(self._world_size_fn())
            generation = int(self._generation_fn())
        except Exception:  # runtime may be mid-reconfigure
            world, generation = -1, -1
        doc = {
            "status": "ok",
            "rank": self.rank,
            "world_size": world,
            "elastic_generation": generation,
            "last_step_age_s": round(age, 3) if age is not None else None,
        }
        extra = self._health_extra_fn
        if extra is not None:
            try:
                doc["serve"] = extra()
            # broad on purpose: a failing stats callback must not break
            # /healthz
            except Exception:
                pass
        return doc

    def close(self) -> None:
        """Stop serving and release the socket.  Idempotent."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        self._thread.join(timeout=5.0)


_exporter: Optional[MetricsExporter] = None


def exporter() -> Optional[MetricsExporter]:
    return _exporter


def start_exporter(port: int, rank: int = 0,
                   world_size_fn: Optional[Callable[[], int]] = None,
                   generation_fn: Optional[Callable[[], int]] = None,
                   ) -> Optional[MetricsExporter]:
    """Bind ``port + rank`` (per-rank servers coexist on one host) and
    start serving.  A bind failure degrades to a warning — monitoring
    must never kill training."""
    global _exporter
    stop_exporter()
    try:
        _exporter = MetricsExporter(port + rank, rank=rank,
                                    world_size_fn=world_size_fn,
                                    generation_fn=generation_fn)
    except OSError as e:
        logging.warning("goodput: /metrics exporter disabled — cannot bind "
                        "port %d (%s)", port + rank, e)
        _exporter = None
    else:
        logging.info("goodput: serving /metrics and /healthz on :%d",
                     port + rank)
    return _exporter


def stop_exporter() -> None:
    global _exporter
    if _exporter is not None:
        _exporter.close()
        _exporter = None


def set_health_extra(fn: Optional[Callable[[], Dict[str, Any]]]) -> None:
    """Attach an extra payload callable to /healthz (the serving tier
    reports queue depth, answered count and the served lineage there,
    as the ``serve`` block).  No-op when the exporter is disabled."""
    if _exporter is not None:
        _exporter._health_extra_fn = fn
