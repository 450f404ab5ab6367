"""Declarative SLOs over fleet series: pure burn-rate evaluation.

A copy of ``distributedpytorch_tpu/slo.py`` (stdlib and the port's
``telemetry``), kept in the port so that the port imports nothing of the
JAX package; the port's ``incidents`` subcommand prints
``incidents_report``.

An ``--slo-spec`` JSON file declares objectives over the fleet
collector's merged series (fleet.py) — the three shapes that cover the
serving tier's contract:

  ratio      a good/bad counter pair with an availability target and
             multi-window burn-rate alerting (the SRE playbook shape:
             error rate, shed rate).  burn = bad_fraction / (1-target);
             the objective fires only when EVERY window's burn exceeds
             its threshold — the short window proves it is happening
             NOW, the long window proves it is not a blip.
  quantile   a latency histogram objective (e.g. p95 request latency
             <= 250ms) evaluated on the WINDOWED delta sketch, not the
             lifetime sketch — a startup spike must not page forever.
  share      a goodput category's share of wall time over the window
             (e.g. compute share >= 0.5) from the merged
             dpt_goodput_seconds_total counters.

Spec example::

    {"slos": [
      {"name": "serve-errors", "kind": "ratio",
       "bad": "dpt_serve_failed_total",
       "total": "dpt_serve_requests_total",
       "target": 0.99,
       "windows": [{"seconds": 10, "burn": 2.0},
                   {"seconds": 60, "burn": 1.0}]},
      {"name": "latency-p95", "kind": "quantile",
       "series": "dpt_serve_request_latency_ms", "q": 0.95,
       "max": 250.0, "windows": [{"seconds": 30}]}
    ]}

THE design constraint: ``evaluate()`` is a pure function of
(spec, sample window).  No wall-clock reads, no sockets, no process
state — every sample carries its own ordering time ``t``, stamped by
whoever produced it (the fleet collector live, a test by hand, a fleet
simulator synthetically).  Same spec + same window => identical
verdicts, so an autoscaler controller or a simulator can consume this
module unchanged.

Samples are fleet.py cycle records::

    {"t": <ordering seconds>, "counters": {prom_key: value},
     "histograms": {name: {"count","sum","min","max","nonpos",
                           "buckets": {idx: n}}}}

Counter keys are full Prometheus keys including labels
(``dpt_goodput_seconds_total{category="compute"}``), so ``share``
objectives are just a labeled-counter family sum.  Windowed deltas are
clamped at zero: an elastic rank ageing out can shrink a merged
cumulative sum, and a shrink must read as "no new events", never as
negative traffic.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry

KINDS = ("ratio", "quantile", "share")

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]+$")

#: the goodput counter family share objectives sum over.
GOODPUT_FAMILY = "dpt_goodput_seconds_total"


# -- spec --------------------------------------------------------------

def validate_spec(spec: Any) -> List[Dict[str, Any]]:
    """Validate a parsed spec, returning its objective list.  Every
    rejection is ONE actionable line naming the offending objective —
    a spec error at fleet startup must read like a fix, not a trace."""
    if not isinstance(spec, dict) or not isinstance(spec.get("slos"),
                                                    list):
        raise ValueError(
            "slo spec must be an object with an 'slos' list")
    if not spec["slos"]:
        raise ValueError("slo spec declares no objectives ('slos' is "
                         "empty) — delete the flag or add one")
    out: List[Dict[str, Any]] = []
    seen: set = set()
    for i, slo in enumerate(spec["slos"]):
        where = f"slos[{i}]"
        if not isinstance(slo, dict):
            raise ValueError(f"{where}: objective must be an object")
        name = slo.get("name")
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(
                f"{where}: 'name' must match [A-Za-z0-9._-]+ (it names "
                f"the incident bundle file), got {name!r}")
        where = f"slos[{i}] {name!r}"
        if name in seen:
            raise ValueError(f"{where}: duplicate objective name")
        seen.add(name)
        kind = slo.get("kind")
        if kind not in KINDS:
            raise ValueError(
                f"{where}: 'kind' must be one of {list(KINDS)}, "
                f"got {kind!r}")
        windows = slo.get("windows")
        if not isinstance(windows, list) or not windows:
            raise ValueError(
                f"{where}: 'windows' must be a non-empty list of "
                f"{{'seconds': s}} objects")
        for j, w in enumerate(windows):
            if not isinstance(w, dict) \
                    or not isinstance(w.get("seconds"), (int, float)) \
                    or w["seconds"] <= 0:
                raise ValueError(
                    f"{where}: windows[{j}] needs 'seconds' > 0")
        if kind == "ratio":
            for key in ("bad", "total"):
                if not isinstance(slo.get(key), str) or not slo[key]:
                    raise ValueError(
                        f"{where}: ratio objectives need a {key!r} "
                        f"counter key (a fleet /metrics series name)")
            target = slo.get("target")
            if not isinstance(target, (int, float)) \
                    or not 0.0 < target < 1.0:
                raise ValueError(
                    f"{where}: 'target' must be in (0, 1) — it is the "
                    f"availability objective, e.g. 0.99")
            for j, w in enumerate(windows):
                if not isinstance(w.get("burn"), (int, float)) \
                        or w["burn"] <= 0:
                    raise ValueError(
                        f"{where}: windows[{j}] needs 'burn' > 0 "
                        f"(the burn-rate threshold for that window)")
        elif kind == "quantile":
            if not isinstance(slo.get("series"), str) \
                    or not slo["series"]:
                raise ValueError(
                    f"{where}: quantile objectives need a 'series' "
                    f"histogram name (e.g. dpt_serve_request_latency_ms)")
            q = slo.get("q")
            if not isinstance(q, (int, float)) or not 0.0 < q < 1.0:
                raise ValueError(
                    f"{where}: 'q' must be in (0, 1), e.g. 0.95")
            if not isinstance(slo.get("max"), (int, float)) \
                    or slo["max"] <= 0:
                raise ValueError(
                    f"{where}: 'max' must be > 0 (the latency bound in "
                    f"the series' own unit)")
        else:  # share
            if not isinstance(slo.get("category"), str) \
                    or not slo["category"]:
                raise ValueError(
                    f"{where}: share objectives need a goodput "
                    f"'category' (compute/input/checkpoint/...)")
            mn = slo.get("min")
            if not isinstance(mn, (int, float)) or not 0.0 < mn <= 1.0:
                raise ValueError(
                    f"{where}: 'min' must be in (0, 1] — the category's "
                    f"minimum share of windowed goodput seconds")
    return list(spec["slos"])


def load_spec(path: str) -> List[Dict[str, Any]]:
    """Read + validate a spec file; errors carry the path."""
    try:
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read slo spec {path!r}: {e}")
    except ValueError as e:
        raise ValueError(f"slo spec {path!r} is not valid JSON: {e}")
    try:
        return validate_spec(spec)
    except ValueError as e:
        raise ValueError(f"slo spec {path!r}: {e}")


# -- windowed deltas ---------------------------------------------------

def _window(samples: List[Dict[str, Any]], seconds: float
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(baseline, latest) samples for a trailing window: the baseline is
    the newest sample at least ``seconds`` older than the latest, or
    the oldest sample when the series is younger than the window — a
    fast-burn objective must be able to fire before a long history
    exists."""
    latest = samples[-1]
    cutoff = float(latest["t"]) - float(seconds)
    base = samples[0]
    for s in samples:
        if float(s["t"]) <= cutoff:
            base = s
        else:
            break
    return base, latest


def counter_delta(samples: List[Dict[str, Any]], key: str,
                  seconds: float) -> float:
    """Windowed increase of a merged counter, clamped at zero (an
    elastic shrink is 'no new events', not negative traffic)."""
    base, latest = _window(samples, seconds)
    return max(0.0, float(latest.get("counters", {}).get(key, 0.0))
               - float(base.get("counters", {}).get(key, 0.0)))


def _sketch_delta(base: Dict[str, Any], latest: Dict[str, Any],
                  series: str) -> Optional[telemetry.Histogram]:
    """The window's own histogram: latest state minus baseline state,
    bucket-wise.  Exact for the sketch, same as merge()."""
    end = latest.get("histograms", {}).get(series)
    if not end:
        return None
    start = base.get("histograms", {}).get(series) or {}
    sb = {int(k): int(v) for k, v in (start.get("buckets") or {}).items()}
    buckets: Dict[int, int] = {}
    for k, v in (end.get("buckets") or {}).items():
        d = int(v) - sb.get(int(k), 0)
        if d > 0:
            buckets[int(k)] = d
    nonpos = max(0, int(end.get("nonpos", 0)) - int(start.get("nonpos",
                                                              0)))
    count = nonpos + sum(buckets.values())
    if count <= 0:
        return None
    # min/max are lifetime extremes, not windowed — the delta sketch's
    # clamp range comes from its own occupied buckets instead (within
    # the sketch's 2% bound by construction).
    growth = telemetry.Histogram._GROWTH_LOG
    if buckets:
        lo = math.exp(min(buckets) * growth)
        hi = math.exp((max(buckets) + 1) * growth)
    else:
        lo = hi = 0.0
    total = float(end.get("sum", 0.0)) - float(start.get("sum", 0.0))
    return telemetry.Histogram.from_parts(
        series, count, total, lo, hi, buckets, nonpos=nonpos)


def windowed_quantile(samples: List[Dict[str, Any]], series: str,
                      q: float, seconds: float) -> Optional[float]:
    """The q-quantile of observations that landed INSIDE the trailing
    window, from the delta sketch (None = no observations)."""
    base, latest = _window(samples, seconds)
    sketch = _sketch_delta(base, latest, series)
    return sketch.quantile(q) if sketch is not None else None


# -- evaluation --------------------------------------------------------

def evaluate(slos: List[Dict[str, Any]],
             samples: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One verdict per objective over the sample window.  Pure: the
    only time that exists here is the ``t`` the samples carry.  An
    objective fires when EVERY window exceeds its threshold; fewer than
    two samples means nothing can burn yet (no deltas exist)."""
    verdicts: List[Dict[str, Any]] = []
    ready = len(samples) >= 2
    for slo in slos:
        windows: List[Dict[str, Any]] = []
        firing = ready
        for w in slo["windows"]:
            seconds = float(w["seconds"])
            detail: Dict[str, Any] = {"seconds": seconds}
            exceeded = False
            if ready:
                base, latest = _window(samples, seconds)
                detail["t_start"] = float(base["t"])
                detail["t_end"] = float(latest["t"])
                if slo["kind"] == "ratio":
                    bad = counter_delta(samples, slo["bad"], seconds)
                    total = counter_delta(samples, slo["total"], seconds)
                    burn = ((bad / total) / (1.0 - float(slo["target"]))
                            if total > 0 else 0.0)
                    detail.update(bad=bad, total=total,
                                  value=round(burn, 6),
                                  threshold=float(w["burn"]))
                    exceeded = total > 0 and burn >= float(w["burn"])
                elif slo["kind"] == "quantile":
                    val = windowed_quantile(samples, slo["series"],
                                            float(slo["q"]), seconds)
                    detail.update(
                        value=None if val is None else round(val, 6),
                        threshold=float(slo["max"]))
                    exceeded = val is not None and val > float(slo["max"])
                else:  # share
                    prefix = GOODPUT_FAMILY + "{"
                    keys = [k for k in samples[-1].get("counters", {})
                            if k.startswith(prefix)]
                    deltas = {k: counter_delta(samples, k, seconds)
                              for k in keys}
                    whole = sum(deltas.values())
                    want = '%s{category="%s"}' % (GOODPUT_FAMILY,
                                                  slo["category"])
                    share = (deltas.get(want, 0.0) / whole
                             if whole > 0 else None)
                    detail.update(
                        value=None if share is None else round(share, 6),
                        threshold=float(slo["min"]))
                    exceeded = share is not None \
                        and share < float(slo["min"])
            detail["exceeded"] = exceeded
            windows.append(detail)
            firing = firing and exceeded
        verdicts.append({"name": slo["name"], "kind": slo["kind"],
                         "firing": firing, "windows": windows})
    return verdicts


# -- incident reporting (the incidents subcommand) ---------------------

def load_incidents(rsl_path: str) -> List[Dict[str, Any]]:
    """Every incident bundle the fleet collector wrote under the run
    dir, in firing order."""
    bundles: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(rsl_path,
                                              "incident-*.json"))):
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        doc["_path"] = os.path.basename(path)
        bundles.append(doc)
    return bundles


def incidents_report(rsl_path: str) -> str:
    """Human-readable digest of the run's incident bundles."""
    bundles = load_incidents(rsl_path)
    if not bundles:
        return ("no incidents: no SLO objective fired during this run "
                f"(searched {os.path.join(rsl_path, 'incident-*.json')})")
    lines = [f"{len(bundles)} incident(s):", ""]
    for b in bundles:
        lines.append(f"== {b.get('_path')} — objective "
                     f"{b.get('slo')!r} ({b.get('kind')}) fired at "
                     f"cycle {b.get('cycle')}")
        for w in b.get("windows", []):
            lines.append(
                f"   window {w.get('seconds')}s: value "
                f"{w.get('value')} vs threshold {w.get('threshold')} "
                f"(t {w.get('t_start')} -> {w.get('t_end')})")
        suspects = b.get("suspect_ranks", [])
        lines.append(f"   suspect ranks: "
                     f"{suspects if suspects else '(none isolated)'}")
        ids = b.get("offending_requests", [])
        if ids:
            shown = ", ".join(ids[:8])
            more = f" (+{len(ids) - 8} more)" if len(ids) > 8 else ""
            lines.append(f"   offending requests: {shown}{more}")
        health = b.get("healthz", {})
        for rank in sorted(health, key=str):
            doc = health[rank]
            lines.append(f"   rank {rank} healthz: {json.dumps(doc)}"
                         if doc else f"   rank {rank} healthz: (down)")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"
