"""Entry points: ``run_scenario`` (library) and ``run_cli`` (the ``sim``
subcommand).

``python -m distributedpytorch_tpu_torch sim --scenario chaos --rsl_path
DIR`` replays the scenario, writes the live-schema artifacts, prints the
report, and exits 0 — floors are enforced by whoever reads the report,
not here, so interactive replays of a failing fleet still produce
artifacts to read.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

from . import latency as latmod
from . import scenario as scmod
from .engine import FleetSim


def run_scenario(name_or_path: str, *, seed: int = 0, replicas: int = 0,
                 duration_s: float = 0.0,
                 model_path: Optional[str] = None,
                 rsl_path: Optional[str] = None) -> Dict[str, Any]:
    """Load, replay, and (when ``rsl_path`` is given) persist one
    scenario.  Returns the report dict — with the event-log sha256
    stamped whether or not artifacts were written, so callers can pin
    byte-identity without touching a disk."""
    sc = scmod.load_scenario(name_or_path, replicas=replicas,
                             duration_s=duration_s)
    model = latmod.load_model(model_path) if model_path else None
    sim = FleetSim(sc, seed=seed, model=model)
    report = sim.run()
    if rsl_path:
        from . import artifacts
        report = artifacts.write_artifacts(rsl_path, sim,
                                           report)["report"]
    else:
        from .artifacts import event_log_sha256
        report["event_log_sha256"] = event_log_sha256(sim)
        report["latency_model_provenance"] = sim.model.get(
            "provenance", {"source": "unknown"})
    return report


def run_cli(cfg: Any) -> int:
    """The ``sim`` subcommand.  ValueErrors (unknown scenario, bad
    model file) propagate to main()'s uniform error path."""
    report = run_scenario(
        cfg.sim_scenario, seed=int(cfg.sim_seed),
        replicas=int(cfg.sim_replicas),
        duration_s=float(cfg.sim_duration),
        model_path=cfg.sim_model, rsl_path=cfg.rsl_path)
    import json
    print(json.dumps(report, indent=1, sort_keys=True, default=float))
    r = report["requests"]
    logging.info(
        f"sim: scenario={report['scenario']} seed={report['seed']} "
        f"replicas {report['replicas_start']}->{report['replicas_end']} "
        f"arrivals={r['arrivals']} answered={r['answered']} "
        f"shed={r['fd_shed']} dropped={r['dropped_forever']} "
        f"incidents={len(report['incidents'])} "
        f"log_sha256={report['event_log_sha256'][:12]}")
    return 0
