"""The serving tier: batched inference over lineage-verified checkpoints,
and the fleet's front door.

Copies of ``distributedpytorch_tpu/serving/*.py`` (framework-free),
pointed at the port's ``deadline``/``faults``/``fleet``/``slo``/
``telemetry``/``tracing``:

  planner.py    the fixed menu of warmed batch sizes (``--serve-buckets``)
                and the pick-largest-ready / pad-to-smallest decision
  batcher.py    the bounded micro-batch queue with a flush deadline and
                explicit backpressure (503 when full)
  server.py     the replica: HTTP handler threads that only validate and
                enqueue, one dispatcher thread that calls ``infer_fn``

and the front door, a control process of its own (``python -m
distributedpytorch_tpu_torch frontdoor``) that clients talk to instead of
picking a replica:

  frontdoor.py  one client port: health-aware routing (probe, eject,
                readmit), fleet-level admission with Retry-After
                shedding, deadline-bounded proxying with one retry on
                another replica, and the control loop that feeds the
                two policy modules below
  controller.py the autoscale policy: pure decisions over the fleet
                collector's merged samples (queue depth, shed counters,
                SLO verdicts) with hysteresis, cooldown and
                min/max-world clamps
  rollout.py    the canary rollout policy and manager: watch the
                checkpoint lineage ledger, canary a newer verified
                checkpoint on a fraction of replicas via
                /admin/reload, promote or roll back on the
                canary-vs-stable error-rate/p95 comparison
"""

from .planner import parse_buckets, choose_bucket, plan_batch  # noqa: F401
from .batcher import MicroBatcher, Request, QueueFullError  # noqa: F401
from .server import ServingTier  # noqa: F401
from .controller import decide_scale, pick_retire  # noqa: F401
from .rollout import RolloutManager, newest_lineage_entry  # noqa: F401
from .frontdoor import FrontDoor  # noqa: F401
