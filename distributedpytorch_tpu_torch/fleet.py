"""The fleet metrics collector: one view over every rank's exporter.

A copy of ``distributedpytorch_tpu/fleet.py`` (stdlib and the port's
``deadline``, ``slo``, ``telemetry`` and ``tracing``), kept in the port so
that the port imports nothing of the JAX package.  One change: the
re-export listener sizes its accept backlog (``FLEET_BACKLOG``) instead
of socketserver's 5, as the port's serving listener and exporter do, so a
burst of dashboards or front doors polling it is answered, not reset.

Every other observability surface is per-rank (telemetry JSONL, the
goodput ledger, the /metrics+/healthz exporter each rank binds at
metrics_port + rank).  ``python -m distributedpytorch_tpu_torch
fleet`` runs this module as a standalone process — no device, no
membership in the world — that turns
those N scrape targets into ONE fleet-level surface:

  scrape    every cycle, GET /metrics + /healthz from every candidate
            port (base..base+ranks-1).  Elastic-aware by construction:
            a joiner's exporter answers and appears within one
            interval; a departed rank fails ``stale_after`` consecutive
            scrapes and ages OUT of the merged series — the fleet view
            never re-exports a dead rank's frozen counters as live.
  merge     counters and gauges sum across alive ranks (keys carry
            their Prometheus labels, so dpt_goodput_seconds_total
            merges per category); histograms merge SKETCH-wise — each
            exporter now publishes its log-bucket occupancy as
            cumulative ``_bucket{le=...}`` lines, this module
            reconstructs the per-rank sketches (telemetry.Histogram
            .from_parts) and folds them (Histogram.merge), which is
            exact, so the fleet p95 carries the same <=1% sketch error
            as a single rank's.
  persist   one JSONL record per cycle (fleet-metrics.jsonl): merged
            series + per-target counters/health from the SAME cycle.
  re-export /metrics (Prometheus text, ``dpt_up <alive-count>``) and
            /fleet (the full cycle record as JSON) on fleet_port — the
            surface a front door and an autoscaler poll.
  alert     with --slo-spec, each cycle's sample window feeds the PURE
            evaluator (slo.py); an objective that transitions to
            firing writes one self-contained incident-*.json bundle:
            the triggering windows, per-rank healthz snapshots, the
            suspect ranks (whose bad counters moved in the window),
            and the offending request ids mined from the serving
            tier's trace records (tracing.py).

The collector holds no lifetime state beyond its sample deque: kill it
and restart it mid-run and the fleet series continue from the next
scrape (counters are cumulative at the source).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import re
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from . import deadline as dl
from . import slo, telemetry, tracing

#: how many cycles of samples the SLO window can look back over, as a
#: multiple of the longest declared window (bounded memory, plural so a
#: baseline sample older than the window always exists).
_WINDOW_SLACK = 3.0

_SCRAPE_TIMEOUT_S = 2.0

# The re-export listener's accept backlog (the JAX collector keeps
# socketserver's 5): a burst of pollers must queue, not be reset.
FLEET_BACKLOG = 128

_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)$")
_LE_RE = re.compile(r'le="([^"]+)"')


# -- Prometheus text parsing ------------------------------------------

def parse_metrics(text: str) -> Dict[str, Any]:
    """Parse one exporter's /metrics body back into mergeable state:

      {"counters": {key: value},   # key includes labels when present
       "gauges":   {key: value},
       "histograms": {name: {"count","sum","min","max","nonpos",
                             "buckets": {idx: n}}}}

    Histogram sketches are reconstructed from the ``_bucket{le=...}``
    lines goodput.render_metrics emits: le is the geometric upper
    boundary exp((idx+1)*log(1.02)), so idx = round(ln(le)/g) - 1 and
    the cumulative counts difference back to per-bucket occupancy
    exactly.  Summary ``{quantile=...}`` lines are deliberately
    ignored: quantiles don't merge, sketches do."""
    growth = telemetry.Histogram._GROWTH_LOG
    types: Dict[str, str] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    raw_buckets: Dict[str, List[Tuple[float, int]]] = {}

    def _hist(name: str) -> Dict[str, Any]:
        return hists.setdefault(name, {
            "count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
            "nonpos": 0, "buckets": {}})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, labels, raw = m.group(1), m.group(2) or "", m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        kind = types.get(name)
        if kind == "counter":
            counters[name + labels] = value
        elif kind == "gauge":
            gauges[name + labels] = value
        # kind == "summary" lines are the per-rank quantiles: skipped,
        # they don't merge.  The sketch lines (_count/_sum/_min/_max/
        # _bucket) carry no TYPE of their own: route by suffix back to
        # the summary they extend.
        if kind is None:
            for suffix in ("_count", "_sum", "_min", "_max", "_bucket"):
                if not name.endswith(suffix):
                    continue
                base = name[: -len(suffix)]
                if types.get(base) != "summary":
                    break
                h = _hist(base)
                if suffix == "_count":
                    h["count"] = int(value)
                elif suffix == "_sum":
                    h["sum"] = value
                elif suffix == "_min":
                    h["min"] = value
                elif suffix == "_max":
                    h["max"] = value
                else:
                    le = _LE_RE.search(labels)
                    if le:
                        raw_buckets.setdefault(base, []).append(
                            (math.inf if le.group(1) == "+Inf"
                             else float(le.group(1)), int(value)))
                break
    for base, pairs in raw_buckets.items():
        h = _hist(base)
        prev = 0
        for le, cum in sorted(pairs, key=lambda p: p[0]):
            n = cum - prev
            prev = cum
            if n <= 0:
                continue
            if le == 0.0:
                h["nonpos"] = n
            elif le != math.inf:
                idx = int(round(math.log(le) / growth)) - 1
                h["buckets"][idx] = n
            # +Inf adds nothing: cum there == count
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def merge_targets(parsed: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-rank parses into the fleet view.  Counters and gauges
    sum by key; sketches fold via Histogram.merge (exact).  dpt_up is
    excluded — aliveness is the COLLECTOR's verdict (who answered this
    cycle), not a sum of self-reports."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, telemetry.Histogram] = {}
    for p in parsed:
        for k, v in p.get("counters", {}).items():
            counters[k] = counters.get(k, 0.0) + v
        for k, v in p.get("gauges", {}).items():
            if k == "dpt_up":
                continue
            gauges[k] = gauges.get(k, 0.0) + v
        for name, st in p.get("histograms", {}).items():
            h = telemetry.Histogram.from_parts(
                name, st.get("count", 0), st.get("sum", 0.0),
                st.get("min", 0.0), st.get("max", 0.0),
                st.get("buckets", {}), nonpos=st.get("nonpos", 0))
            if name in hists:
                hists[name].merge(h)
            else:
                hists[name] = h
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def _hist_state(h: telemetry.Histogram) -> Dict[str, Any]:
    """A sketch's JSON-serializable state (the slo.py sample schema)."""
    return {"count": h.count, "sum": h.sum,
            "min": h.min if h.count else 0.0,
            "max": h.max if h.count else 0.0,
            "nonpos": h._nonpos,
            "buckets": dict(h._buckets)}


# -- sample / incident schema factories --------------------------------
#
# The fleet-metrics.jsonl sample and the incident bundle are CONTRACTS
# shared by the live collector below and the fleet simulator
# (sim/artifacts.py), which synthesizes the same shapes from a virtual
# clock — the fleet/incidents subcommands and slo.evaluate consume both
# streams identically because both go through these functions.

def build_fleet_sample(*, ts: float, mono: float, cycle: int,
                       alive: List[int], merged: Dict[str, Any],
                       targets: Dict[str, Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """One scrape-cycle sample (sans verdicts, which the caller appends
    after slo.evaluate).  Clock contract: ts is a stamp (never
    subtracted); mono is the ordering time and the SLO evaluator's
    pure ``t``."""
    return {
        "kind": "fleet_sample", "ts": ts, "mono": mono,
        "t": mono, "cycle": int(cycle),
        "alive": list(alive),
        "counters": merged["counters"],
        "gauges": merged["gauges"],
        "histograms": {n: _hist_state(h)
                       for n, h in merged["histograms"].items()},
        "targets": targets,
    }


def encode_sample(sample: Dict[str, Any]) -> str:
    """Canonical JSONL serialization of one sample (sorted keys) —
    byte-stable, which is what makes same-seed simulator runs
    byte-identical."""
    return json.dumps(sample, sort_keys=True, default=float)


def build_incident(*, name: str, spec: Dict[str, Any],
                   verdict: Dict[str, Any], cycle: int, ts: float,
                   alive: List[int], suspect_ranks: List[int],
                   offending_requests: List[str],
                   healthz: Dict[str, Any]) -> Dict[str, Any]:
    """One incident bundle document."""
    return {
        "kind": "incident", "slo": name,
        "slo_kind": spec["kind"], "spec": spec,
        "cycle": int(cycle), "ts": ts,
        "windows": verdict["windows"],
        "alive": list(alive),
        "suspect_ranks": list(suspect_ranks),
        "offending_requests": list(offending_requests),
        "healthz": healthz,
    }


def incident_filename(seq: int, name: str) -> str:
    return "incident-%03d-%s.json" % (int(seq), name)


def write_incident_bundle(rsl_path: str, seq: int, name: str,
                          bundle: Dict[str, Any]) -> Optional[str]:
    """Persist one bundle; returns the path or None on an unwritable
    disk (observability never takes the control plane down)."""
    path = os.path.join(rsl_path, incident_filename(seq, name))
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(bundle, f, sort_keys=True, default=float, indent=1)
    except OSError as e:
        logging.error(f"fleet: cannot write incident bundle "
                      f"{path!r}: {e}")
        return None
    return path


def render_fleet_metrics(merged: Dict[str, Any], alive: int) -> str:
    """The merged series as Prometheus text — same exposition shape as
    the per-rank exporter, with ``dpt_up`` = the alive-rank count."""
    growth = telemetry.Histogram._GROWTH_LOG
    lines: List[str] = []
    typed: set = set()

    def _type(base: str, kind: str) -> None:
        if base not in typed:
            typed.add(base)
            lines.append("# TYPE %s %s" % (base, kind))

    for key in sorted(merged["counters"]):
        _type(key.split("{", 1)[0], "counter")
        lines.append("%s %.17g" % (key, merged["counters"][key]))
    for key in sorted(merged["gauges"]):
        _type(key.split("{", 1)[0], "gauge")
        lines.append("%s %.17g" % (key, merged["gauges"][key]))
    for name in sorted(merged["histograms"]):
        h = merged["histograms"][name]
        _type(name, "summary")
        for q in (0.5, 0.95, 0.99):
            lines.append('%s{quantile="%g"} %.17g'
                         % (name, q, h.quantile(q)))
        lines.append("%s_count %d" % (name, h.count))
        lines.append("%s_sum %.17g" % (name, h.sum))
        if h.count:
            lines.append("%s_min %.17g" % (name, h.min))
            lines.append("%s_max %.17g" % (name, h.max))
            cum = h._nonpos
            if cum:
                lines.append('%s_bucket{le="0"} %d' % (name, cum))
            for idx in sorted(h._buckets):
                cum += h._buckets[idx]
                lines.append('%s_bucket{le="%.17g"} %d'
                             % (name, math.exp((idx + 1) * growth), cum))
            lines.append('%s_bucket{le="+Inf"} %d' % (name, h.count))
    lines.append("# TYPE dpt_up gauge")
    lines.append("dpt_up %d" % alive)
    return "\n".join(lines) + "\n"


# -- the collector -----------------------------------------------------

class _Target:
    """One candidate rank exporter and its scrape health."""

    __slots__ = ("rank", "port", "fails", "alive", "parsed", "health")

    def __init__(self, rank: int, port: int):
        self.rank = rank
        self.port = port
        self.fails = 0
        self.alive = False
        self.parsed: Optional[Dict[str, Any]] = None
        self.health: Optional[Dict[str, Any]] = None


class FleetCollector:
    """Scrape, merge, persist, re-export, alert.  One thread of its
    own (the re-export HTTP server); ``run()`` drives the scrape loop
    on the caller's thread."""

    def __init__(self, rsl_path: str, ranks: int, metrics_port: int,
                 host: str = "127.0.0.1", interval_s: float = 1.0,
                 stale_after: int = 3, port: int = 0,
                 slos: Optional[List[Dict[str, Any]]] = None,
                 max_cycles: int = 0):
        if ranks < 1:
            raise ValueError(f"fleet needs >= 1 candidate rank, "
                             f"got {ranks}")
        if interval_s <= 0:
            raise ValueError(f"scrape interval must be > 0, "
                             f"got {interval_s}")
        self.rsl_path = rsl_path
        self.host = host
        self.interval_s = float(interval_s)
        self.stale_after = max(1, int(stale_after))
        self.port = int(port)
        self.slos = list(slos or [])
        self.max_cycles = int(max_cycles)
        self.cycle = 0
        self.incidents_written = 0
        self._targets = [_Target(r, metrics_port + r)
                         for r in range(int(ranks))]
        window = max((float(w["seconds"]) for s in self.slos
                      for w in s["windows"]), default=60.0)
        keep = max(8, int(window * _WINDOW_SLACK / self.interval_s) + 2)
        self._samples: Deque[Dict[str, Any]] = collections.deque(
            maxlen=keep)
        self._firing: set = set()
        self._lock = threading.Lock()
        self._latest: Optional[Dict[str, Any]] = None  # /fleet body
        self._latest_prom = "# TYPE dpt_up gauge\ndpt_up 0\n"
        self._stop = threading.Event()
        self._server = None
        self._thread = None
        self._sink = None

    # -- scraping ------------------------------------------------------

    def _fetch(self, port: int, path: str,
               budget: Optional[dl.Deadline] = None) -> Optional[str]:
        # deadline.fetch: hard per-call timeout, bounded further by the
        # cycle budget — a wedged exporter costs at most its share of
        # one cycle, never a stall past --interval.
        return dl.fetch(f"http://{self.host}:{port}{path}",
                        _SCRAPE_TIMEOUT_S, deadline=budget)

    def scrape_once(self) -> Dict[str, Any]:
        """One full cycle: probe every candidate, age out the silent,
        merge the alive, persist the sample, evaluate SLOs.  The whole
        scrape pass shares one Deadline budget — max(interval, one
        scrape timeout) — so N wedged exporters degrade to failed
        scrapes (age-out pressure), not a cycle that overruns its
        period."""
        self.cycle += 1
        budget = dl.Deadline(max(self.interval_s, _SCRAPE_TIMEOUT_S))
        for t in self._targets:
            body = self._fetch(t.port, "/metrics", budget)
            if body is None:
                t.fails += 1
                if t.fails >= self.stale_after and t.alive:
                    logging.info(
                        f"fleet: rank {t.rank} (:{t.port}) aged out "
                        f"after {t.fails} failed scrapes")
                if t.fails >= self.stale_after:
                    t.alive = False
                    t.parsed = None
                    t.health = None
                continue
            t.fails = 0
            if not t.alive:
                logging.info(f"fleet: rank {t.rank} (:{t.port}) joined")
            t.alive = True
            t.parsed = parse_metrics(body)
            health = self._fetch(t.port, "/healthz", budget)
            try:
                t.health = json.loads(health) if health else None
            except ValueError:
                t.health = None
        alive = [t for t in self._targets if t.alive]
        merged = merge_targets([t.parsed for t in alive
                                if t.parsed is not None])
        sample = build_fleet_sample(
            ts=time.time(), mono=time.monotonic(), cycle=self.cycle,
            alive=[t.rank for t in alive], merged=merged,
            targets={str(t.rank): {
                "port": t.port,
                "counters": (t.parsed or {}).get("counters", {}),
                "health": t.health,
            } for t in alive})
        self._samples.append(sample)
        verdicts = (slo.evaluate(self.slos, list(self._samples))
                    if self.slos else [])
        sample["verdicts"] = verdicts
        self._alert(verdicts, sample)
        self._persist(sample)
        with self._lock:
            self._latest = sample
            self._latest_prom = render_fleet_metrics(merged, len(alive))
        return sample

    # -- alerting ------------------------------------------------------

    def _alert(self, verdicts: List[Dict[str, Any]],
               sample: Dict[str, Any]) -> None:
        """Edge-detect newly-firing objectives and write their incident
        bundles; a cleared objective re-arms."""
        for v in verdicts:
            name = v["name"]
            if not v["firing"]:
                if name in self._firing:
                    logging.info(f"fleet: slo {name!r} recovered at "
                                 f"cycle {self.cycle}")
                self._firing.discard(name)
                continue
            if name in self._firing:
                continue  # still burning: one bundle per episode
            self._firing.add(name)
            self._write_incident(name, v, sample)

    def _suspects(self, spec: Dict[str, Any],
                  verdict: Dict[str, Any]) -> List[int]:
        """Ranks whose own bad counter moved inside the widest window —
        the merged series says THAT something burned, the per-target
        history says WHERE."""
        if spec.get("kind") != "ratio":
            return sorted(int(r) for r in sample_targets(self._samples))
        seconds = max(float(w["seconds"]) for w in spec["windows"])
        samples = list(self._samples)
        base, latest = slo._window(samples, seconds)
        key = spec["bad"]
        out = []
        for rank, doc in latest.get("targets", {}).items():
            end = float(doc.get("counters", {}).get(key, 0.0))
            start = float(base.get("targets", {}).get(rank, {})
                          .get("counters", {}).get(key, 0.0))
            if end - start > 0:
                out.append(int(rank))
        return sorted(out)

    def _offenders(self, sample: Dict[str, Any],
                   verdict: Dict[str, Any]) -> List[str]:
        """Request ids whose trace records ended badly inside the
        triggering window (wall-clock mapped via the window samples'
        own stamps, padded one interval for flush skew)."""
        seconds = max(float(w["seconds"]) for w in verdict["windows"])
        base, latest = slo._window(list(self._samples), seconds)
        lo = float(base.get("ts", 0.0)) - self.interval_s
        hi = float(latest.get("ts", 0.0)) + self.interval_s
        ids = []
        for rec in tracing.load_records(self.rsl_path):
            if rec.get("outcome") not in tracing.BAD_OUTCOMES:
                continue
            ts = float(rec.get("ts", 0.0))
            if lo <= ts <= hi:
                ids.append(rec["id"])
        return ids

    def _write_incident(self, name: str, verdict: Dict[str, Any],
                        sample: Dict[str, Any]) -> None:
        spec = next(s for s in self.slos if s["name"] == name)
        self.incidents_written += 1
        bundle = build_incident(
            name=name, spec=spec, verdict=verdict, cycle=self.cycle,
            ts=sample["ts"], alive=sample["alive"],
            suspect_ranks=self._suspects(spec, verdict),
            offending_requests=self._offenders(sample, verdict),
            healthz={rank: doc.get("health")
                     for rank, doc in sample["targets"].items()})
        path = write_incident_bundle(self.rsl_path,
                                     self.incidents_written, name, bundle)
        if path is None:
            return
        logging.warning(
            f"fleet: INCIDENT — slo {name!r} firing at cycle "
            f"{self.cycle}: suspects {bundle['suspect_ranks']}, "
            f"{len(bundle['offending_requests'])} offending "
            f"request(s) -> {path}")

    # -- persistence ---------------------------------------------------

    def _persist(self, sample: Dict[str, Any]) -> None:
        try:
            if self._sink is None:
                os.makedirs(self.rsl_path, exist_ok=True)
                self._sink = open(
                    os.path.join(self.rsl_path, "fleet-metrics.jsonl"),
                    "a", encoding="utf-8")
            self._sink.write(encode_sample(sample) + "\n")
            self._sink.flush()
        except OSError as e:
            logging.error(f"fleet: cannot persist fleet-metrics.jsonl "
                          f"({e}); collection continues")
            self._sink = None

    # -- re-export -----------------------------------------------------

    def start(self) -> None:
        """Bind the fleet exporter (port 0 in config disables; port 0
        here binds an ephemeral port, resolved into self.port)."""
        import http.server

        coll = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.startswith("/metrics"):
                    with coll._lock:
                        body = coll._latest_prom.encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/fleet"):
                    with coll._lock:
                        doc = coll._latest
                    body = json.dumps(doc, sort_keys=True,
                                      default=float).encode("utf-8")
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
                pass  # scrapes would drown the collector log

        class _Listener(http.server.ThreadingHTTPServer):
            request_queue_size = FLEET_BACKLOG

        self._server = _Listener(("0.0.0.0", self.port), _Handler)
        self.port = self._server.server_address[1]
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="fleet-exporter", daemon=True)
        self._thread.start()
        logging.info(f"fleet: re-exporting /metrics + /fleet "
                     f"on :{self.port}")

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> int:
        """The scrape loop: cycle, sleep, repeat until max_cycles /
        stop() / ^C.  Returns cycles completed."""
        started = 0
        try:
            while not self._stop.is_set():
                self.scrape_once()
                started += 1
                if self.max_cycles and started >= self.max_cycles:
                    break
                if self._stop.wait(self.interval_s):
                    break
        except KeyboardInterrupt:
            pass
        return started

    def close(self) -> None:
        self._stop.set()
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
            self._thread.join(timeout=5.0)
        if self._sink is not None:
            self._sink.close()
            self._sink = None


def sample_targets(samples: "collections.deque") -> List[str]:
    """Ranks present in the latest sample (helper for suspect listing
    when an objective isn't a ratio and no counter names a culprit)."""
    if not samples:
        return []
    return sorted(samples[-1].get("targets", {}).keys())


# -- CLI entry (the fleet subcommand) ---------------------------------

def run_cli(cfg) -> int:
    """Run the collector per Config; returns a process exit code."""
    try:
        slos = slo.load_spec(cfg.slo_spec) if cfg.slo_spec else []
    except ValueError as e:
        print(f"fleet: {e}")
        return 2
    coll = FleetCollector(
        rsl_path=cfg.rsl_path, ranks=cfg.fleet_ranks,
        metrics_port=cfg.metrics_port, interval_s=cfg.fleet_interval,
        stale_after=cfg.fleet_stale_after, port=cfg.fleet_port,
        slos=slos, max_cycles=cfg.fleet_max_cycles)
    coll.start()
    print(f"fleet: scraping {cfg.fleet_ranks} candidate exporter(s) "
          f"at :{cfg.metrics_port}+rank every {coll.interval_s}s; "
          f"re-export on :{coll.port}"
          + (f"; {len(slos)} SLO objective(s)" if slos else ""))
    try:
        cycles = coll.run()
    finally:
        coll.close()
    alive = coll._samples[-1]["alive"] if coll._samples else []
    print(f"fleet: stopped after {cycles} cycle(s); last view had "
          f"{len(alive)} alive rank(s); {coll.incidents_written} "
          f"incident(s) written")
    return 0
