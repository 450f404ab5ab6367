"""Cross-rank timeline — telemetry + flight records as one trace.

Counterpart of ``distributedpytorch_tpu/timeline.py``, copied (the JAX
module is framework-free; it reads the port's telemetry, flight-recorder
dumps, goodput ledgers and request traces, which keep the JAX schemas).

``python -m distributedpytorch_tpu_torch timeline --rsl_path RSL`` merges
every rank's telemetry
JSONL (telemetry/rank*.jsonl) and flight-recorder dump
(flightrec-rank*.json) into a single Chrome trace-event file that
Perfetto (https://ui.perfetto.dev) or chrome://tracing loads directly:
one process row per rank, telemetry spans and flight-recorder steps on
separate threads, point events (anomaly, fault_injected, preempt_signal,
health_boundary) as instants, and — when the run wrote a goodput ledger
(goodput*.json) — a per-rank category track: one slice per reconcile
window named by its dominant category plus a stacked counter series of
the full category mix.

Clock alignment.  Each rank stamps records with its own ``mono`` clock,
whose origin is arbitrary per process — raw mono values from two ranks
are not comparable.  Wall clocks (``ts``) are comparable but can be
skewed between hosts.  The merger therefore aligns on the health
allgather: ``cli._health_boundary`` emits a ``health_boundary`` event on
every rank immediately after ``runtime.agree_health`` returns, and a
blocking allgather returns at (nearly) the same real instant everywhere —
so for each epoch boundary e, mono_r(e) on every rank r names the same
physical moment.  Rank r's offset onto rank 0's mono axis is the median
over shared boundaries of ``mono_0(e) - mono_r(e)``; the median makes one
straggly boundary (a rank that lingered in the allgather) harmless.
Runs without shared boundaries (single rank, --no-health-checks) fall
back to wall-clock alignment via each rank's median ``ts - mono`` delta —
correct up to host clock skew, which the skew report then quantifies.
The fallback is per rank ("mixed" mode): one boundary-less stream — a
rank that died mid-epoch before its first boundary, the elastic
rank-loss shape — degrades only itself, and an ``elastic/reconfigure``
boundary in the events is surfaced as a survivors/departed warning
rather than a crash or silent truncation.

Grown worlds.  A rank that JOINS mid-run (elastic grow) announces
itself with an ``elastic/join`` event — and when it is a departed rank
restarting, it appends to the departed incarnation's telemetry file.
The two incarnations have different mono origins, so alignment cuts at
the join instant: boundary offsets use only post-join boundaries (the
joined rank aligns from its first health-boundary), and the pre-join
segment is re-anchored by its own wall clock with a warning.  The
reconfigure warning names joined ranks alongside departed ones.

Skew report.  At every shared boundary the ranks' *wall* stamps should
agree too; their spread (max - min) is the measured cross-rank wall-clock
skew per epoch, reported per boundary and as a maximum.  The straggler
table attributes per-rank time: mean epoch span, mean step time and
data-wait share from the flight records — the rank that is slow because
it waits on data reads differently from the rank that is slow dispatching.

Hostile inputs degrade, never crash: a missing flight record for one rank
drops to telemetry-only for that rank (warning in the summary), torn
JSONL tails are skipped line-wise, and a run directory with no telemetry
at all is a one-line actionable error (``ValueError``).
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Any, Dict, List, Optional, Tuple

from . import flightrec, goodput, telemetry, tracing

# Thread ids within each rank's process row.
_TID_SPANS = 0      # telemetry spans
_TID_STEPS = 1      # flight-recorder per-step records
_TID_EVENTS = 2     # point events / instants
_TID_GOODPUT = 3    # goodput ledger: per-epoch category attribution
_TID_REQUESTS = 4   # serving tier: per-request trace span chains


def _attrs(ev: Dict[str, Any]) -> Dict[str, Any]:
    a = ev.get("attrs")
    return a if isinstance(a, dict) else {}


def _goodput_rows(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The plottable per-window rows of one rank's ledger: mono END
    stamp, positive wall_s window, and a category map — anything torn
    or hand-edited is dropped, never crashed on."""
    rows = []
    for row in doc.get("epochs", []):
        if not isinstance(row, dict) \
                or not isinstance(row.get("mono"), (int, float)) \
                or not isinstance(row.get("wall_s"), (int, float)) \
                or not isinstance(row.get("categories"), dict):
            continue
        if float(row["wall_s"]) <= 0:
            continue
        rows.append({"epoch": row.get("epoch"),
                     "mono": float(row["mono"]),
                     "wall_s": float(row["wall_s"]),
                     "residual_s": row.get("residual_s"),
                     "categories": {str(k): float(v)
                                    for k, v in row["categories"].items()
                                    if isinstance(v, (int, float))}})
    return rows


def _boundaries(events: List[Dict[str, Any]],
                cuts: Optional[Dict[int, float]] = None
                ) -> Dict[int, Dict[int, Dict[str, float]]]:
    """rank -> epoch -> {"ts","mono"} for every health_boundary event.
    A rank that emitted the same epoch twice keeps the last stamp (a
    resumed run re-walks earlier epochs).  ``cuts`` (rank -> wall ts of
    its last ``elastic/join``) drops boundaries stamped BEFORE a rank
    rejoined: those belong to the departed incarnation, whose mono
    origin is unrelated to the rejoined process's."""
    out: Dict[int, Dict[int, Dict[str, float]]] = {}
    for ev in events:
        if ev.get("kind") != "event" or ev.get("name") != "health_boundary":
            continue
        try:
            rank = int(ev["rank"])
            epoch = int(_attrs(ev)["epoch"])
            stamp = {"ts": float(ev["ts"]), "mono": float(ev["mono"])}
        except (KeyError, TypeError, ValueError):
            continue
        if cuts and stamp["ts"] < cuts.get(rank, float("-inf")):
            continue
        out.setdefault(rank, {})[epoch] = stamp
    return out


def _join_cuts(events: List[Dict[str, Any]]) -> Dict[int, float]:
    """rank -> wall ts of that rank's LAST ``elastic/join`` event: the
    instant a mid-run joiner's stream (re)started.  A rejoining rank
    appends to the departed incarnation's telemetry file, so records
    before the cut carry a different mono origin than records after."""
    cuts: Dict[int, float] = {}
    for ev in events:
        if ev.get("kind") != "event" or ev.get("name") != "elastic/join":
            continue
        rank, ts = ev.get("rank"), ev.get("ts")
        if isinstance(rank, int) and isinstance(ts, (int, float)):
            cuts[rank] = max(float(ts), cuts.get(rank, float("-inf")))
    return cuts


def _wall_delta(events: List[Dict[str, Any]], rank: int,
                lo: Optional[float] = None,
                hi: Optional[float] = None) -> Optional[float]:
    """Median ``ts - mono`` for one rank: maps its mono clock onto its
    own wall clock (the no-boundary fallback alignment).  ``lo``/``hi``
    bound the wall stamps considered — used to keep a rejoined rank's
    two incarnations (different mono origins) from polluting each
    other's delta."""
    deltas = [float(ev["ts"]) - float(ev["mono"]) for ev in events
              if ev.get("rank") == rank
              and isinstance(ev.get("ts"), (int, float))
              and isinstance(ev.get("mono"), (int, float))
              and (lo is None or float(ev["ts"]) >= lo)
              and (hi is None or float(ev["ts"]) < hi)]
    return statistics.median(deltas) if deltas else None


def _alignment(events: List[Dict[str, Any]], ranks: List[int],
               cuts: Optional[Dict[int, float]] = None
               ) -> Tuple[Dict[int, float], str, List[str]]:
    """Per-rank offset to add to that rank's mono stamps so all ranks
    share one time axis.  Returns (offsets, method, warnings).

    Alignment is PER RANK, not all-or-nothing: a single rank with no
    shared boundary (one that died before its first health_boundary —
    the elastic rank-loss shape — or a freshly joined stream) falls
    back to its own wall clock with a warning naming it, while every
    other rank keeps the precise boundary alignment.  Method is
    "health_boundary" when every rank aligned on boundaries,
    "wall_clock" when none could, "mixed" otherwise.  In mixed mode
    every offset targets the WALL axis (boundary offsets are shifted by
    the base rank's own ts-mono delta) so the two kinds of offset land
    on one comparable axis.

    A rank with a join cut (see :func:`_join_cuts`) aligns from its
    first POST-join health boundary; its pre-join segment gets a
    separate wall-clock offset in :func:`build_timeline`.
    """
    cuts = cuts or {}
    warnings: List[str] = []
    bounds = _boundaries(events, cuts)
    base = min(ranks)
    boundary_offsets: Dict[int, float] = {}
    fallback: List[int] = []
    if base in bounds and len(ranks) > 1:
        boundary_offsets[base] = 0.0
        for r in ranks:
            if r == base:
                continue
            shared = sorted(set(bounds.get(r, {})) & set(bounds[base]))
            if shared:
                boundary_offsets[r] = statistics.median(
                    bounds[base][e]["mono"] - bounds[r][e]["mono"]
                    for e in shared)
            else:
                fallback.append(r)
        if not fallback:
            return boundary_offsets, "health_boundary", warnings
        if len(boundary_offsets) > 1:
            # Mixed: most ranks align precisely; the boundary-less ones
            # (truncated by a mid-epoch death, typically) ride their own
            # wall clock — comparable up to host clock skew.
            for r in fallback:
                warnings.append(
                    f"clock alignment: rank {r} shares no "
                    f"health_boundary with rank {base} (stream "
                    "truncated before its first boundary?); aligning "
                    "it by wall clock only")
            base_delta = _wall_delta(events, base, lo=cuts.get(base))
            if base_delta is not None:
                offsets = {r: off + base_delta
                           for r, off in boundary_offsets.items()}
                for r in fallback:
                    d = _wall_delta(events, r, lo=cuts.get(r))
                    offsets[r] = d if d is not None else base_delta
                return offsets, "mixed", warnings
            # base has no usable ts/mono pairs at all — degenerate;
            # drop to the uniform wall-clock fallback below.
        warnings.append("clock alignment: not every rank shares a "
                        "health_boundary with rank "
                        f"{base}; falling back to wall clocks")
    # Fallback: project every rank onto its own wall clock.  Correct up
    # to host clock skew (single-rank runs trivially so).
    offsets = {}
    for r in ranks:
        d = _wall_delta(events, r, lo=cuts.get(r))
        offsets[r] = d if d is not None else 0.0
    return offsets, "wall_clock", warnings


def _skew_report(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cross-rank wall-clock spread at each shared boundary epoch."""
    bounds = _boundaries(events)
    per_epoch: Dict[int, float] = {}
    epochs = set()
    for stamps in bounds.values():
        epochs |= set(stamps)
    for e in sorted(epochs):
        walls = [stamps[e]["ts"] for stamps in bounds.values()
                 if e in stamps]
        if len(walls) >= 2:
            per_epoch[e] = max(walls) - min(walls)
    return {
        "boundary_epochs": sorted(epochs),
        "wall_skew_s_per_epoch": {str(e): round(v, 6)
                                  for e, v in per_epoch.items()},
        "max_wall_skew_s": (round(max(per_epoch.values()), 6)
                            if per_epoch else None),
    }


def _stragglers(events: List[Dict[str, Any]],
                dumps: Dict[int, Dict[str, Any]],
                ranks: List[int]) -> List[Dict[str, Any]]:
    """Per-rank attribution rows; the slowest mean epoch is flagged."""
    rows: List[Dict[str, Any]] = []
    for r in ranks:
        epoch_durs = [float(ev["dur_s"]) for ev in events
                      if ev.get("kind") == "span"
                      and ev.get("name") == "epoch"
                      and ev.get("rank") == r
                      and isinstance(ev.get("dur_s"), (int, float))]
        steps = [rec for rec in dumps.get(r, {}).get("records", [])
                 if isinstance(rec, dict) and rec.get("kind") == "step"]
        step_s = [float(s["step_s"]) for s in steps
                  if isinstance(s.get("step_s"), (int, float))]
        wait_s = [float(s["wait_s"]) for s in steps
                  if isinstance(s.get("wait_s"), (int, float))]
        row: Dict[str, Any] = {
            "rank": r,
            "epochs_seen": len(epoch_durs),
            "mean_epoch_s": (round(statistics.mean(epoch_durs), 6)
                             if epoch_durs else None),
            "steps_recorded": len(steps),
            "mean_step_s": (round(statistics.mean(step_s), 6)
                            if step_s else None),
            "data_wait_share": (round(sum(wait_s) / max(sum(step_s), 1e-12),
                                      4) if wait_s and step_s else None),
        }
        rows.append(row)
    timed = [row for row in rows if row["mean_epoch_s"] is not None]
    if timed:
        slowest = max(timed, key=lambda row: row["mean_epoch_s"])
        slowest["straggler"] = True
    return rows


def build_timeline(rsl_path: str) -> Dict[str, Any]:
    """Merge one run directory into {trace, skew, stragglers, ...}.

    Raises ``ValueError`` (one actionable line) when the run has no
    telemetry at all; every lesser defect degrades with a warning."""
    events = telemetry.load_events(os.path.join(rsl_path, "telemetry"))
    dumps = flightrec.load_dumps(rsl_path)
    ledgers = goodput.load_ledgers(rsl_path)
    requests = [r for r in tracing.load_records(rsl_path)
                if isinstance(r.get("rank"), int)
                and isinstance(r.get("mono_admit"), (int, float))]
    ranks = sorted({int(ev["rank"]) for ev in events
                    if isinstance(ev.get("rank"), int)} | set(dumps)
                   | {int(r["rank"]) for r in requests})
    if not ranks:
        raise ValueError(
            f"telemetry under {rsl_path!r} has no rank-stamped events; "
            "was it produced by an older build? re-run with --telemetry")
    cuts = _join_cuts(events)
    offsets, method, warnings = _alignment(events, ranks, cuts)
    # A rejoined rank's pre-join segment (the departed incarnation's
    # records, same file, different mono origin) gets its own offset:
    # its own wall clock, shifted onto whatever axis `offsets` targets.
    pre_offsets: Dict[int, float] = {}
    if cuts:
        base = min(ranks)
        base_delta = (_wall_delta(events, base, lo=cuts.get(base))
                      if method == "health_boundary" else None)
        for r, cut in sorted(cuts.items()):
            pre_delta = _wall_delta(events, r, hi=cut)
            if pre_delta is None:
                continue  # fresh joiner: no pre-join records at all
            if method == "health_boundary":
                if base_delta is None:
                    warnings.append(
                        f"clock alignment: rank {r} rejoined mid-run but "
                        f"base rank {base} has no usable wall stamps; its "
                        "pre-join segment may be misplaced")
                    continue
                pre_offsets[r] = (pre_delta - base_delta
                                  + offsets.get(base, 0.0))
            else:  # mixed / wall_clock: offsets already target wall time
                pre_offsets[r] = pre_delta
            warnings.append(
                f"clock alignment: rank {r} rejoined mid-run (elastic "
                "grow); its pre-join segment is aligned by wall clock "
                "only")
    for r in ranks:
        if r not in dumps:
            warnings.append(f"no flight record for rank {r} "
                            f"(flightrec-rank{r}.json missing/unreadable); "
                            "timeline shows telemetry spans only")
    if not ledgers:
        warnings.append("no goodput ledger (goodput*.json missing — run "
                        "predates the ledger or was killed before its "
                        "final write); timeline omits the category track")
    # Elastic reconfigure boundary (elastic.py): every survivor emits an
    # elastic/reconfigure event; a rank present in the run but absent
    # from that set is the departed one — its stream simply truncates at
    # the failure.  Named here so a shrunken-world trace reads as a
    # reconfigure, not as data loss.
    reconf = [ev for ev in events
              if ev.get("kind") == "event"
              and ev.get("name") == "elastic/reconfigure"
              and isinstance(ev.get("rank"), int)]
    if reconf:
        survivors = sorted({int(ev["rank"]) for ev in reconf})
        joined = sorted(set(cuts) & set(ranks))
        departed = sorted(set(ranks) - set(survivors) - set(joined))
        gens = sorted({_attrs(ev).get("generation") for ev in reconf
                       if _attrs(ev).get("generation") is not None})
        dep_note = (f"; rank(s) {departed} departed — their streams "
                    "truncate at the failure, which is expected, not "
                    "data loss" if departed else "")
        if joined:
            warnings.append(
                f"elastic reconfigure (generation(s) {gens}): survivors "
                f"{survivors} continued across the world change(s); "
                f"rank(s) {joined} joined in a grow generation — their "
                "streams begin (or restart) mid-run" + dep_note)
        else:
            warnings.append(
                f"elastic reconfigure (generation(s) {gens}): survivors "
                f"{survivors} continued in a smaller world" + dep_note)

    def aligned(rank: int, mono: float,
                ts: Optional[float] = None) -> float:
        if ts is not None and rank in pre_offsets \
                and ts < cuts.get(rank, float("-inf")):
            return mono + pre_offsets[rank]
        return mono + offsets.get(rank, 0.0)

    # First pass: the trace origin is the earliest aligned stamp so every
    # Chrome ts is non-negative.
    stamps: List[float] = []
    for ev in events:
        if isinstance(ev.get("mono"), (int, float)) \
                and isinstance(ev.get("rank"), int):
            wall = (float(ev["ts"])
                    if isinstance(ev.get("ts"), (int, float)) else None)
            t = aligned(ev["rank"], float(ev["mono"]), wall)
            if ev.get("kind") == "span" \
                    and isinstance(ev.get("dur_s"), (int, float)):
                t -= float(ev["dur_s"])  # span stamps are END stamps
            stamps.append(t)
    for r, doc in dumps.items():
        for rec in doc.get("records", []):
            if isinstance(rec, dict) \
                    and isinstance(rec.get("mono"), (int, float)):
                t = aligned(r, float(rec["mono"]))
                if isinstance(rec.get("step_s"), (int, float)):
                    t -= float(rec["step_s"])
                stamps.append(t)
    for r, doc in ledgers.items():
        for row in _goodput_rows(doc):
            # Ledger rows carry END stamps; the slice starts wall_s back.
            stamps.append(aligned(r, row["mono"] - row["wall_s"]))
    for rec in requests:
        stamps.append(aligned(int(rec["rank"]), float(rec["mono_admit"]),
                              rec.get("ts_admit")))
    if not stamps:
        raise ValueError(
            f"no timestamped records under {rsl_path!r}; nothing to plot")
    origin = min(stamps)

    def us(rank: int, mono: float, ts: Optional[float] = None) -> float:
        return round((aligned(rank, float(mono), ts) - origin) * 1e6, 3)

    trace_events: List[Dict[str, Any]] = []
    for r in ranks:
        trace_events.append({"ph": "M", "name": "process_name", "pid": r,
                             "args": {"name": f"rank{r}"}})
        trace_events.append({"ph": "M", "name": "process_sort_index",
                             "pid": r, "args": {"sort_index": r}})
        for tid, label in ((_TID_SPANS, "telemetry spans"),
                           (_TID_STEPS, "flightrec steps"),
                           (_TID_EVENTS, "events"),
                           (_TID_GOODPUT, "goodput categories"),
                           (_TID_REQUESTS, "requests")):
            if tid == _TID_GOODPUT and r not in ledgers:
                continue
            if tid == _TID_REQUESTS and not any(
                    int(rec["rank"]) == r for rec in requests):
                continue
            trace_events.append({"ph": "M", "name": "thread_name",
                                 "pid": r, "tid": tid,
                                 "args": {"name": label}})

    for ev in events:
        r = ev.get("rank")
        mono = ev.get("mono")
        if not isinstance(r, int) or not isinstance(mono, (int, float)):
            continue
        kind = ev.get("kind")
        wall = (float(ev["ts"])
                if isinstance(ev.get("ts"), (int, float)) else None)
        if kind == "span" and isinstance(ev.get("dur_s"), (int, float)):
            dur = float(ev["dur_s"])
            trace_events.append({
                "ph": "X", "cat": "telemetry",
                "name": str(ev.get("name", "span")), "pid": r,
                "tid": _TID_SPANS,
                "ts": us(r, float(mono) - dur, wall),
                "dur": round(dur * 1e6, 3),
                "args": _attrs(ev),
            })
        elif kind == "event":
            trace_events.append({
                "ph": "i", "cat": "telemetry", "s": "p",
                "name": str(ev.get("name", "event")), "pid": r,
                "tid": _TID_EVENTS, "ts": us(r, mono, wall),
                "args": _attrs(ev),
            })
    for r, doc in dumps.items():
        for rec in doc.get("records", []):
            if not isinstance(rec, dict) \
                    or not isinstance(rec.get("mono"), (int, float)):
                continue
            if rec.get("kind") == "step" \
                    and isinstance(rec.get("step_s"), (int, float)):
                dur = float(rec["step_s"])
                args = {k: rec[k] for k in ("epoch", "step", "dispatch_s",
                                            "wait_s", "queue_depth")
                        if k in rec}
                trace_events.append({
                    "ph": "X", "cat": "flightrec", "name": "step",
                    "pid": r, "tid": _TID_STEPS,
                    "ts": us(r, float(rec["mono"]) - dur),
                    "dur": round(dur * 1e6, 3), "args": args,
                })
            elif rec.get("kind") == "event":
                trace_events.append({
                    "ph": "i", "cat": "flightrec", "s": "p",
                    "name": str(rec.get("name", "event")), "pid": r,
                    "tid": _TID_EVENTS, "ts": us(r, rec["mono"]),
                    "args": {k: v for k, v in rec.items()
                             if k not in ("kind", "name", "ts", "mono")},
                })
    # Goodput ledger track: one slice per reconcile window, named by the
    # window's dominant category (full map in args), plus a Chrome
    # counter ("C") event per window so Perfetto draws the category mix
    # as a stacked area over the run.
    for r, doc in ledgers.items():
        for row in _goodput_rows(doc):
            cats = row["categories"]
            start = us(r, row["mono"] - row["wall_s"])
            top = max(cats, key=cats.get) if cats else "other"
            label = ("final" if row["epoch"] is None
                     else f"epoch {row['epoch']}")
            args = dict(cats)
            if row["residual_s"] is not None:
                args["residual_s"] = row["residual_s"]
            trace_events.append({
                "ph": "X", "cat": "goodput",
                "name": f"{label}: {top}", "pid": r,
                "tid": _TID_GOODPUT, "ts": start,
                "dur": round(row["wall_s"] * 1e6, 3), "args": args,
            })
            trace_events.append({
                "ph": "C", "cat": "goodput", "name": "goodput (s)",
                "pid": r, "tid": _TID_GOODPUT, "ts": start,
                "args": cats,
            })
    # Per-request track (serving tier, tracing.py): each request's span
    # chain laid out sequentially from its admission stamp — the chain
    # property (sum(spans) == total_s) means the slices tile exactly,
    # so queue_wait vs batch_form vs infer reads directly off the row.
    for rec in requests:
        r = int(rec["rank"])
        t = float(rec["mono_admit"])
        wall = (float(rec["ts_admit"])
                if isinstance(rec.get("ts_admit"), (int, float)) else None)
        spans = rec.get("spans", {})
        args = {k: rec[k] for k in ("id", "status", "outcome", "bucket",
                                    "latency_ms") if k in rec}
        for name in tracing.SPAN_ORDER:
            dur = spans.get(name)
            if not isinstance(dur, (int, float)) or dur < 0:
                continue
            trace_events.append({
                "ph": "X", "cat": "request", "name": name,
                "pid": r, "tid": _TID_REQUESTS,
                "ts": us(r, t, wall), "dur": round(float(dur) * 1e6, 3),
                "args": args,
            })
            t += float(dur)
    # Stable per-rank ordering: metadata first, then strictly by
    # (pid, ts) — Perfetto tolerates any order, humans and tests don't.
    trace_events.sort(key=lambda e: (e.get("pid", -1),
                                     0 if e["ph"] == "M" else 1,
                                     e.get("ts", -1.0)))

    skew = _skew_report(events)
    stragglers = _stragglers(events, dumps, ranks)
    rooflines = _roofline_summaries(events, rsl_path)
    trace = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "distributedpytorch_tpu timeline",
            "alignment": method,
            "ranks": ranks,
            "skew": skew,
            "stragglers": stragglers,
            "roofline": rooflines,
        },
    }
    return {"trace": trace, "skew": skew, "stragglers": stragglers,
            "ranks": ranks, "alignment": method, "warnings": warnings,
            "roofline": rooflines}


def _roofline_summaries(events: List[Dict[str, Any]], rsl_path: str
                        ) -> Dict[str, Any]:
    """Per-rank op-level blame for the timeline annotation: the newest
    ``roofline`` telemetry event per rank (roofline.py emits one after
    every analyzed capture), falling back to RSL_PATH/roofline.json —
    an offline `roofline` subcommand run is rank-agnostic, keyed "*"."""
    out: Dict[str, Any] = {}
    for ev in events:
        if ev.get("kind") != "event" or ev.get("name") != "roofline":
            continue
        rank = ev.get("rank")
        if not isinstance(rank, int):
            continue
        prev = out.get(str(rank))
        if prev and prev.get("_mono", -1) >= ev.get("mono", 0):
            continue
        a = _attrs(ev)
        out[str(rank)] = {"coverage": a.get("coverage"),
                          "top_ops": a.get("top_ops"),
                          "source": "telemetry",
                          "_mono": ev.get("mono", 0)}
    for v in out.values():
        v.pop("_mono", None)
    if not out:
        try:
            with open(os.path.join(rsl_path, "roofline.json")) as f:
                rep = json.load(f)
            out["*"] = {
                "coverage": rep.get("coverage"),
                "top_ops": [{"name": r.get("name"),
                             "time_share": r.get("time_share"),
                             "bound": r.get("bound")}
                            for r in (rep.get("ops") or [])[:3]],
                "source": "roofline.json",
            }
        except (OSError, ValueError):
            pass
    return out


def render_summary(result: Dict[str, Any], out_path: str) -> str:
    """Human-readable digest printed by the CLI next to the trace file."""
    lines = [f"timeline: {len(result['ranks'])} rank(s), clock alignment "
             f"via {result['alignment']}",
             f"wrote {out_path} (load in https://ui.perfetto.dev)"]
    for w in result["warnings"]:
        lines.append(f"warning: {w}")
    skew = result["skew"]
    if skew["max_wall_skew_s"] is not None:
        lines.append(f"cross-rank wall-clock skew: "
                     f"max {skew['max_wall_skew_s'] * 1e3:.3f} ms")
        for e, v in skew["wall_skew_s_per_epoch"].items():
            lines.append(f"  boundary epoch {e}: {v * 1e3:.3f} ms")
    else:
        lines.append("cross-rank wall-clock skew: n/a "
                     "(fewer than 2 ranks at any health boundary)")
    lines.append("straggler attribution:")
    lines.append(f"  {'rank':>4s} {'epochs':>6s} {'mean_epoch_s':>12s} "
                 f"{'steps':>6s} {'mean_step_s':>12s} {'wait_share':>10s}")
    for row in result["stragglers"]:

        def _f(v, spec):
            return format(v, spec) if v is not None else "-"

        flag = "  <- straggler" if row.get("straggler") else ""
        lines.append(
            f"  {row['rank']:>4d} {row['epochs_seen']:>6d} "
            f"{_f(row['mean_epoch_s'], '>12.4f')} "
            f"{row['steps_recorded']:>6d} "
            f"{_f(row['mean_step_s'], '>12.5f')} "
            f"{_f(row['data_wait_share'], '>10.3f')}{flag}")
    rl = result.get("roofline") or {}
    if rl:
        lines.append("roofline attribution (per rank):")
        for rank in sorted(rl, key=lambda k: (k == "*", k)):
            info = rl[rank]
            tops = ", ".join(
                f"{t['name']} {t['time_share'] * 100:.0f}% "
                f"({t['bound']}-bound)"
                for t in (info.get("top_ops") or [])[:3]
                if t.get("time_share") is not None) or "-"
            cov = info.get("coverage")
            cov_s = f"{cov * 100:.1f}%" if cov is not None else "-"
            who = f"rank {rank}" if rank != "*" else "run"
            lines.append(f"  {who}: {cov_s} attributed; top: {tops} "
                         f"[{info.get('source')}]")
    return "\n".join(lines)


def write_timeline(rsl_path: str, out: Optional[str] = None
                   ) -> Tuple[str, Dict[str, Any]]:
    """Build + write the trace JSON; returns (path, build result)."""
    result = build_timeline(rsl_path)
    path = out or os.path.join(rsl_path, "timeline.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(result["trace"], f, default=float)
    os.replace(tmp, path)
    return path, result


def run_cli(rsl_path: str, out: Optional[str] = None) -> str:
    """CLI entry point: write the trace, return the printable summary."""
    path, result = write_timeline(rsl_path, out=out)
    return render_summary(result, path)
