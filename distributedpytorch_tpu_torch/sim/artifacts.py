"""Persist a finished FleetSim as the repo's LIVE artifact layout.

One rule: every file written here goes through the same schema factory
the live emitters use (telemetry.stamp_record/encode_line,
tracing.build_request_record/encode_record, goodput.build_ledger_doc,
fleet.encode_sample / write_incident_bundle), so the ``goodput``,
``timeline``, ``fleet`` and ``incidents`` readers render a simulated
fleet with zero simulator-specific code — and schema drift between sim
and live is structurally impossible.

On top of the live layout, two simulator-only files:

  sim-events.jsonl   the deterministic event log — same seed, same
                     scenario, same model => byte-identical file.  The
                     report pins its sha256.
  sim-report.json    the run summary, which robustness floors are
                     asserted against.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

from .. import fleet, goodput, telemetry, tracing
from .engine import BASE_TS, FleetSim


def _encode_events(sim: FleetSim) -> bytes:
    lines = [json.dumps(ev, sort_keys=True, default=float)
             for ev in sim.events]
    return ("\n".join(lines) + "\n").encode("utf-8") if lines else b""


def event_log_sha256(sim: FleetSim) -> str:
    return hashlib.sha256(_encode_events(sim)).hexdigest()


def write_artifacts(rsl_path: str, sim: FleetSim,
                    report: Dict[str, Any]) -> Dict[str, Any]:
    """Write every stream; returns ``{"paths": [...], "report": ...}``
    with the report enriched with the event-log digest + provenance."""
    os.makedirs(rsl_path, exist_ok=True)
    paths = []

    # -- sim-events.jsonl (the byte-identity artifact) ----------------
    blob = _encode_events(sim)
    p = os.path.join(rsl_path, "sim-events.jsonl")
    with open(p, "wb") as f:
        f.write(blob)
    paths.append(p)

    # -- telemetry/rank<N>.jsonl --------------------------------------
    tdir = os.path.join(rsl_path, "telemetry")
    os.makedirs(tdir, exist_ok=True)
    for rank in sorted(sim.tel):
        p = os.path.join(tdir, f"rank{rank}.jsonl")
        with open(p, "w", encoding="utf-8") as f:
            for t, payload in sim.tel[rank]:
                rec = telemetry.stamp_record(payload, ts=BASE_TS + t,
                                             mono=t, rank=rank)
                f.write(telemetry.encode_line(rec) + "\n")
        paths.append(p)

    # -- trace-rank<N>.jsonl ------------------------------------------
    by_rank: Dict[int, list] = {}
    for rec in sim.traces:
        by_rank.setdefault(rec["rank"], []).append(rec)
    for rank in sorted(by_rank):
        p = os.path.join(rsl_path, f"trace-rank{rank}.jsonl")
        with open(p, "w", encoding="utf-8") as f:
            for rec in by_rank[rank]:
                f.write(tracing.encode_record(rec) + "\n")
        paths.append(p)

    # -- fleet-metrics.jsonl ------------------------------------------
    p = os.path.join(rsl_path, "fleet-metrics.jsonl")
    with open(p, "w", encoding="utf-8") as f:
        for sample in sim.samples:
            f.write(fleet.encode_sample(sample) + "\n")
    paths.append(p)

    # -- incident bundles ---------------------------------------------
    for seq, (name, bundle) in enumerate(sim.incidents, start=1):
        ip = fleet.write_incident_bundle(rsl_path, seq, name, bundle)
        if ip:
            paths.append(ip)

    # -- goodput ledgers ----------------------------------------------
    world = int(sim.sc["replicas"])
    for rank, r in sorted(sim.replicas.items()):
        rows = [goodput.build_epoch_row(
                    epoch=row["epoch"], wall_s=row["wall_s"],
                    mono=row["t_end"], ts=BASE_TS + row["t_end"],
                    residual_s=max(0.0, row["wall_s"] - row["compute_s"]),
                    categories={"compute": row["compute_s"]})
                for row in sim.gp_rows.get(rank, [])]
        doc = goodput.build_ledger_doc(
            rank=rank, world=world, started_ts=BASE_TS,
            wall_s=sim.duration, totals={"compute": r["busy_s"]},
            epochs=rows)
        gp = goodput.write_ledger_doc(rsl_path, doc)
        if gp:
            paths.append(gp)

    # -- sim-report.json ----------------------------------------------
    report = dict(report)
    report["event_log_sha256"] = hashlib.sha256(blob).hexdigest()
    report["latency_model_provenance"] = sim.model.get(
        "provenance", {"source": "unknown"})
    p = os.path.join(rsl_path, "sim-report.json")
    with open(p, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=float)
        f.write("\n")
    paths.append(p)
    return {"paths": paths, "report": report}
