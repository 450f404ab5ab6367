"""Scenario definitions: what the simulated fleet is put through.

A scenario is one JSON-able dict — fleet size, virtual duration,
traffic spec (traffic.py), a fault plan in the EXISTING faults.py DSL
(site ``sim.step``), the policy configs handed verbatim to the real
deciders, the SLO objectives (slo.validate_spec shapes), and the
robustness floors a replay is held to.  Built-ins:

  control           over-provisioned fleet, flat light traffic — the
                    null hypothesis: zero scale actions, zero incidents.
  diurnal           sinusoidal load across the autoscaler's thresholds —
                    the flap test.
  burst             a rectangular surge through the front door's pending
                    budget — the bounded-shed test.
  preemption_wave   30% of the fleet vanishes at once — the rejoin-
                    thrash test.
  chaos             all of the above plus an ioerror burst, a stall
                    wave and a canary rollout, at N=100 — the
                    headline scenario.

Fault-plan reading under the virtual clock (the DSL is unchanged; only
the interpretation is simulator-specific, documented here and next to
faults.SITES): ``after_n`` = virtual seconds at which the spec fires,
``count`` = replicas affected (rank_loss / preempt / rank_join / stall)
or requests failed (ioerror), ``stall_s`` = added service seconds per
stalled replica's next dispatch.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List

from .. import faults, slo

#: Keys every scenario carries; load_scenario fills these from DEFAULTS
#: so user scenario files only state what they change.
DEFAULTS: Dict[str, Any] = {
    "replicas": 10,
    "duration_s": 120.0,
    "interval_s": 1.0,        # control tick / fleet scrape cadence
    "buckets": "1,4,8",       # the planner's compiled batch menu
    "flush_s": 0.05,          # idle-replica batch-formation wait
    "provision_delay_s": 8.0,  # scale-up launch -> join claim
    "rejoin_delay_s": 15.0,   # fault-killed replica -> rejoin claim
    "join_retry_s": 5.0,      # declined joiner -> next claim
    "max_attempts": 10,       # client retries before dropped-forever
    "trace_sample": 7,        # every Nth answered request gets a trace
    "goodput_window_s": 30.0,  # ledger epoch-row cadence
    "traffic": {"kind": "constant", "rps": 12.0},
    "fault_plan": "",
    "route": {},              # frontdoor.ROUTE_DEFAULTS overrides
    "scale": {},              # controller.SCALE_DEFAULTS overrides
    "elastic": {"target": "capacity", "min_world": 1},
    "slos": [],
    "rollout": None,          # {"at_s": T, ...ROLLOUT_DEFAULTS overrides}
    "floors": {},
}

_SLOS_STANDARD: List[Dict[str, Any]] = [
    {"name": "availability", "kind": "ratio",
     "bad": "dpt_serve_errors_total", "total": "dpt_serve_requests_total",
     "target": 0.99, "windows": [{"seconds": 30, "burn": 2.0}]},
    {"name": "shed-burn", "kind": "ratio",
     "bad": "dpt_frontdoor_shed_total",
     "total": "dpt_frontdoor_requests_total",
     "target": 0.98, "windows": [{"seconds": 20, "burn": 2.0}]},
    {"name": "p95-latency", "kind": "quantile",
     "series": "dpt_serve_request_latency_ms", "q": 0.95,
     "max": 15000.0, "windows": [{"seconds": 30}]},
]

SCENARIOS: Dict[str, Dict[str, Any]] = {
    "control": {
        "name": "control", "replicas": 10, "duration_s": 120.0,
        "traffic": {"kind": "constant", "rps": 12.0},
        "scale": {"min_world": 10, "max_world": 12, "queue_high": 60.0,
                  "queue_low": 0.5, "up_hold_s": 6.0,
                  "down_hold_s": 40.0, "cooldown_s": 15.0},
        "route": {"pending_budget": 400, "eject_after": 3,
                  "max_step_age_s": 30.0},
        "elastic": {"target": "capacity", "min_world": 10},
        "slos": _SLOS_STANDARD,
        "floors": {"scale_actions": 0, "incidents_exact": 0,
                   "dropped_forever": 0, "max_direction_changes": 0,
                   "max_shed_window_s": 0.0},
    },
    "diurnal": {
        "name": "diurnal", "replicas": 30, "duration_s": 180.0,
        "traffic": {"kind": "diurnal", "base_rps": 25.0,
                    "peak_rps": 55.0, "period_s": 60.0},
        "scale": {"min_world": 20, "max_world": 40, "queue_high": 60.0,
                  "queue_low": 2.0, "up_hold_s": 6.0,
                  "down_hold_s": 40.0, "cooldown_s": 15.0},
        "route": {"pending_budget": 500, "eject_after": 3,
                  "max_step_age_s": 45.0},
        "elastic": {"target": "capacity", "min_world": 20},
        "slos": _SLOS_STANDARD,
        "floors": {"dropped_forever": 0, "max_direction_changes": 2},
    },
    "burst": {
        "name": "burst", "replicas": 20, "duration_s": 120.0,
        "traffic": {"kind": "burst", "base_rps": 15.0,
                    "burst_rps": 120.0, "burst_start_s": 40.0,
                    "burst_len_s": 8.0},
        "scale": {"min_world": 15, "max_world": 30, "queue_high": 80.0,
                  "queue_low": 2.0, "up_hold_s": 6.0,
                  "down_hold_s": 40.0, "cooldown_s": 15.0},
        "route": {"pending_budget": 300, "retry_after_s": 2.0,
                  "eject_after": 3, "max_step_age_s": 45.0},
        "elastic": {"target": "capacity", "min_world": 15},
        "slos": _SLOS_STANDARD,
        "floors": {"dropped_forever": 0, "max_shed_window_s": 40.0},
    },
    "preemption_wave": {
        "name": "preemption_wave", "replicas": 50, "duration_s": 150.0,
        "traffic": {"kind": "constant", "rps": 60.0},
        "fault_plan": "sim.step:rank_loss:60:15",
        "scale": {"min_world": 35, "max_world": 60, "queue_high": 100.0,
                  "queue_low": 3.0, "up_hold_s": 6.0,
                  "down_hold_s": 40.0, "cooldown_s": 15.0},
        "route": {"pending_budget": 500, "eject_after": 3,
                  "max_step_age_s": 45.0},
        "elastic": {"target": "capacity", "min_world": 35},
        "slos": _SLOS_STANDARD,
        "floors": {"dropped_forever": 0,
                   "max_rejoin_admits_per_replica": 1},
    },
    "chaos": {
        "name": "chaos", "replicas": 100, "duration_s": 180.0,
        # Capacity math: one replica turns a full bucket-8 batch in
        # ~3.5s => ~2.3 rps; 100 replicas ~230 rps.  The diurnal band
        # below keeps utilization 0.45-0.75 — headroom at base, real
        # queueing at peak, and the pending budget (Little's law:
        # ~peak_rps x in-system seconds, plus a burst margin) only
        # trips when a fault eats capacity.
        "traffic": {"kind": "diurnal", "base_rps": 100.0,
                    "peak_rps": 170.0, "period_s": 120.0},
        # t=45 six replicas stall (+2.5s on their next dispatch);
        # t=100 a 30%-of-fleet preemption wave; t=130 a 300-request
        # ioerror burst on one replica.
        "fault_plan": ("sim.step:stall:45:6:2.5;"
                       "sim.step:rank_loss:100:30;"
                       "sim.step:ioerror:130:300"),
        "scale": {"min_world": 70, "max_world": 120,
                  "queue_high": 150.0, "queue_low": 5.0,
                  "up_hold_s": 6.0, "down_hold_s": 40.0,
                  "cooldown_s": 15.0},
        "route": {"pending_budget": 2000, "retry_after_s": 2.0,
                  "eject_after": 3, "max_step_age_s": 45.0},
        "elastic": {"target": "capacity", "min_world": 70},
        "slos": _SLOS_STANDARD,
        "rollout": {"at_s": 140.0, "fraction": 0.10, "hold_s": 15.0,
                    "min_requests": 40, "timeout_s": 35.0},
        "floors": {"dropped_forever": 0, "max_direction_changes": 2,
                   "max_shed_window_s": 60.0,
                   "max_rejoin_admits_per_replica": 1,
                   "recover_world_min": 70,
                   "rollout_outcome": "promote",
                   # The one SLO the fault plan is DESIGNED to trip:
                   # the spread ioerror burst at t=130.  The stall and
                   # the wave must ride through without an incident.
                   "incidents_exact": ["availability"]},
    },
}


def load_scenario(name_or_path: str, replicas: int = 0,
                  duration_s: float = 0.0) -> Dict[str, Any]:
    """Resolve a built-in name or a scenario JSON path, fill defaults,
    validate, and apply CLI overrides (0 = keep the scenario's own)."""
    if name_or_path in SCENARIOS:
        sc = copy.deepcopy(SCENARIOS[name_or_path])
    elif name_or_path.endswith(".json") or os.path.exists(name_or_path):
        try:
            with open(name_or_path, encoding="utf-8") as f:
                sc = json.load(f)
        except OSError as e:
            raise ValueError(
                f"cannot read scenario file {name_or_path!r}: {e}")
        except ValueError as e:
            raise ValueError(
                f"scenario file {name_or_path!r} is not valid JSON: {e}")
        if not isinstance(sc, dict):
            raise ValueError(
                f"scenario file {name_or_path!r} must hold a JSON "
                f"object")
        sc.setdefault("name", os.path.splitext(
            os.path.basename(name_or_path))[0])
    else:
        raise ValueError(
            f"unknown scenario {name_or_path!r}: expected one of "
            f"{sorted(SCENARIOS)} or a scenario JSON path")
    out = copy.deepcopy(DEFAULTS)
    out.update(sc)
    if replicas:
        out["replicas"] = int(replicas)
    if duration_s:
        out["duration_s"] = float(duration_s)
    if int(out["replicas"]) < 1:
        raise ValueError(f"scenario {out.get('name')!r}: replicas must "
                         f"be >= 1")
    if float(out["duration_s"]) <= 0:
        raise ValueError(f"scenario {out.get('name')!r}: duration_s "
                         f"must be > 0")
    if out["slos"]:
        slo.validate_spec({"slos": out["slos"]})
    timed_faults(out, seed=0)  # validate the plan shape up front
    return out


def timed_faults(scenario: Dict[str, Any], seed: int
                 ) -> List[Dict[str, Any]]:
    """The scenario's fault plan, parsed by the REAL faults.parse_plan
    and reinterpreted under the virtual clock (module docstring).
    Returns ``[{"t", "kind", "count", "stall_s"}, ...]`` sorted by t."""
    plan_text = scenario.get("fault_plan") or ""
    if not plan_text:
        return []
    plan = faults.parse_plan(plan_text, seed=seed)
    out: List[Dict[str, Any]] = []
    for spec in plan.specs:
        if spec.site != "sim.step":
            raise ValueError(
                f"scenario {scenario.get('name')!r}: simulator fault "
                f"plans use site 'sim.step' only (got {spec.site!r} — "
                f"other sites belong to live processes)")
        if spec.kind in ("fatal", "torn"):
            raise ValueError(
                f"scenario {scenario.get('name')!r}: fault kind "
                f"{spec.kind!r} has no fleet-level reading; use "
                f"rank_loss/preempt/stall/ioerror/rank_join")
        out.append({"t": float(spec.after_n), "kind": spec.kind,
                    "count": int(spec.count),
                    "stall_s": float(spec.stall_s)})
    return sorted(out, key=lambda f: (f["t"], f["kind"]))
