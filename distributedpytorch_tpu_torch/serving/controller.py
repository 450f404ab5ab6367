"""Autoscale policy for the serving fleet — pure and clock-free.

A copy of ``distributedpytorch_tpu/serving/controller.py`` (stdlib only),
kept in the port so that the port imports nothing of the JAX package.

``decide_scale`` is a pure function of (config, controller state, the
fleet sample window) in the ``slo.evaluate`` style: samples carry
their own ordering time ``t`` (the collector's monotonic stamp), the
module never imports ``time``, and identical inputs give identical
decisions — so the fleet simulator (``sim/``) drives it at N=100+
replicas exactly as the live front door drives it at 2.

The decision ladder, in priority order:

  repair     world below ``min_world`` (a replica died and aged out of
             the fleet series) -> scale UP immediately; capacity floors
             outrank hysteresis.
  scale up   sustained pressure: EVERY sample in the trailing
             ``up_hold_s`` window shows fleet queue depth >=
             ``queue_high``, OR any shed was counted inside the window,
             OR an SLO burn-rate verdict is firing.  The queue trigger
             is deliberately ahead of the shed trigger: a load ramp
             fills queues before it sheds, so the tier grows BEFORE the
             shed rate crosses a floor — the shed/burn triggers are the
             backstop, not the plan.
  scale dn   sustained idleness: EVERY sample in the trailing
             ``down_hold_s`` window shows queue depth <= ``queue_low``,
             zero shed movement, and no firing verdicts.

Both holds require the window to be fully COVERED by samples (there is
a sample at or before ``t - hold``): a young series never triggers.  A
``cooldown_s`` refractory period after any action plus the two
asymmetric holds are the hysteresis that keeps diurnal traffic — load
oscillating between the two thresholds — from flapping the world size.

The impure half (launching ``--elastic-join`` replicas, POSTing
``/admin/drain``) lives in the front door's control loop
(frontdoor.py), which also emits every non-``none`` decision as a
``controller/scale_*`` telemetry event for the ``timeline`` reader.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

#: queue-depth gauge in the fleet merged series (summed across ranks).
QUEUE_GAUGE = "dpt_serve_queue_depth"
#: shed counter in the fleet merged series.
SHED_COUNTER = "dpt_serve_shed_total"
#: the front door's own admission sheds, injected into the samples by
#: frontdoor.tick() — fleet-level backpressure counts as pressure too.
FD_SHED_COUNTER = "dpt_frontdoor_shed_total"

SCALE_DEFAULTS: Dict[str, Any] = {
    "min_world": 1,      # repair floor: below this, scale up now
    "max_world": 4,      # clamp: never launch past this
    "queue_high": 8.0,   # sustained fleet queue depth that means "grow"
    "queue_low": 1.0,    # sustained fleet queue depth that means "idle"
    "up_hold_s": 2.0,    # pressure must hold this long before growing
    "down_hold_s": 10.0,  # idleness must hold this long before retiring
    "cooldown_s": 5.0,   # refractory period after any action
}


def _cfg(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(SCALE_DEFAULTS)
    out.update(cfg or {})
    return out


def _queue_depth(sample: Dict[str, Any]) -> float:
    """Fleet-wide queue depth of one sample: the merged gauge (fleet.py
    sums gauges across alive ranks at merge time)."""
    g = sample.get("gauges", {}).get(QUEUE_GAUGE, 0.0)
    if isinstance(g, dict):  # per-rank form: sum it ourselves
        return float(sum(float(v) for v in g.values()))
    return float(g or 0.0)


def _counter(sample: Dict[str, Any], name: str) -> float:
    return float(sample.get("counters", {}).get(name, 0.0))


def _shed_total(sample: Dict[str, Any]) -> float:
    """Replica-level 503s plus the front door's own admission sheds."""
    return _counter(sample, SHED_COUNTER) \
        + _counter(sample, FD_SHED_COUNTER)


def _firing(sample: Dict[str, Any]) -> List[str]:
    return [v.get("name", "?") for v in sample.get("verdicts", [])
            if v.get("firing")]


def _window(samples: Sequence[Dict[str, Any]], hold_s: float
            ) -> Optional[List[Dict[str, Any]]]:
    """The trailing ``hold_s`` of the series, or None when the series
    does not yet span it (no sample at/before the window start)."""
    if not samples:
        return None
    t = float(samples[-1]["t"])
    start = t - float(hold_s)
    if not any(float(s["t"]) <= start for s in samples):
        return None
    return [s for s in samples if float(s["t"]) >= start]


def decide_scale(cfg: Optional[Dict[str, Any]],
                 state: Optional[Dict[str, Any]],
                 samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Pure scale decision over the fleet sample window.

    ``state`` carries only ``last_action_t`` (the sample-clock time of
    the previous up/down action; the caller stamps it).  Returns
    ``{"action": "none"|"up"|"down", "reason", "world", "target"}`` —
    ``target`` is the post-action world size, clamped to
    [min_world, max_world].
    """
    c = _cfg(cfg)
    if not samples:
        return {"action": "none", "reason": "no samples", "world": 0,
                "target": 0}
    latest = samples[-1]
    t = float(latest["t"])
    world = len(latest.get("alive") or [])
    minw, maxw = int(c["min_world"]), int(c["max_world"])

    def none(reason: str) -> Dict[str, Any]:
        return {"action": "none", "reason": reason, "world": world,
                "target": world}

    last = (state or {}).get("last_action_t")
    if last is not None and (t - float(last)) < float(c["cooldown_s"]):
        return none(f"cooldown ({t - float(last):.1f}s since last "
                    f"action < {c['cooldown_s']:.1f}s)")

    # Repair outranks hysteresis: a dead replica is a capacity hole NOW.
    if world < minw:
        return {"action": "up",
                "reason": f"world {world} below min_world {minw}",
                "world": world, "target": min(world + 1, maxw)}

    up_w = _window(samples, c["up_hold_s"])
    if up_w is not None and world < maxw:
        depths = [_queue_depth(s) for s in up_w]
        if all(d >= float(c["queue_high"]) for d in depths):
            return {"action": "up",
                    "reason": f"queue depth >= {c['queue_high']:g} for "
                              f"{c['up_hold_s']:g}s (min "
                              f"{min(depths):g})",
                    "world": world, "target": min(world + 1, maxw)}
        shed = _shed_total(up_w[-1]) - _shed_total(up_w[0])
        if shed > 0:
            return {"action": "up",
                    "reason": f"{shed:g} requests shed inside the "
                              f"{c['up_hold_s']:g}s window",
                    "world": world, "target": min(world + 1, maxw)}
        firing = _firing(latest)
        if firing:
            return {"action": "up",
                    "reason": f"slo burn firing: {', '.join(firing)}",
                    "world": world, "target": min(world + 1, maxw)}

    down_w = _window(samples, c["down_hold_s"])
    if down_w is not None and world > minw:
        depths = [_queue_depth(s) for s in down_w]
        shed = _shed_total(down_w[-1]) - _shed_total(down_w[0])
        if all(d <= float(c["queue_low"]) for d in depths) \
                and shed <= 0 and not _firing(latest):
            return {"action": "down",
                    "reason": f"queue depth <= {c['queue_low']:g} for "
                              f"{c['down_hold_s']:g}s, zero shed",
                    "world": world, "target": max(world - 1, minw)}

    return none("no sustained pressure or idleness")


def pick_retire(candidates: Sequence[int],
                protected: Sequence[int] = ()) -> Optional[int]:
    """Which replica a scale-down drains: the HIGHEST eligible slot —
    joiners land on high slots, so the tier retires newest-first and
    the stable low slots (and anything ``protected``, e.g. a live
    canary) keep serving.  Pure; None when nothing is eligible."""
    pool = sorted(set(int(c) for c in candidates)
                  - set(int(p) for p in protected))
    return pool[-1] if pool else None
