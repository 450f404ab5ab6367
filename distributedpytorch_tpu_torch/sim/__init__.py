"""Deterministic fleet simulator.

A copy of ``distributedpytorch_tpu/sim/`` (stdlib and the port's policy
modules), kept in the port so that the port imports nothing of the JAX
package: for the same scenario, seed and latency model it writes the
same event log, byte for byte, as the JAX package's simulator.

A seeded discrete-event simulator that proves the control planes at
N=100+ replicas — the scale where the interesting policy failures live
(autoscale oscillation under diurnal traffic, shed cascades through the
front door's pending budget, rejoin thrash after a preemption wave) and
which no gloo subprocess harness on one host can afford.

The design rule, and the reason every decider in this repo is a pure
clock-free function of (config, sample window): the simulator composes
the REAL policy code, never reimplementations.  What runs in here is

  * ``serving/planner.py``      batch planning per simulated dispatch,
  * ``serving/frontdoor.py``    admission / routing / health ejection,
  * ``serving/controller.py``   the autoscale ladder over fleet samples,
  * ``serving/rollout.py``      canary promote/rollback verdicts,
  * ``elastic.py``              join admission (evaluate_join_policy),
  * ``slo.py``                  burn-rate evaluation over the samples,
  * ``faults.py``               the fault-plan DSL and RetryPolicy's
                                deterministic backoff schedule,

driven by a virtual clock: time exists only as the event heap's ``t``.
No module in sim/ reads a wall clock or an unseeded RNG, so the same
seed and scenario produce a byte-identical event log — replayable,
diffable, bisectable.  It touches no device.

Artifacts come out in the repo's live JSONL schemas (via the shared
schema factories in telemetry/tracing/goodput/fleet), so the
``goodput``, ``timeline``, ``fleet`` and ``incidents`` readers render a
simulated fleet unchanged.  Entry point: ``python -m
distributedpytorch_tpu_torch sim --scenario ...``.
"""

from .engine import BASE_TS, FleetSim  # noqa: F401
from .runner import run_cli, run_scenario  # noqa: F401
