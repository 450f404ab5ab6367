"""The serving tier: batched inference over lineage-verified checkpoints.

Copies of ``distributedpytorch_tpu/serving/{planner,batcher,server}.py``
(framework-free), pointed at the port's ``faults``/``telemetry``/
``tracing``:

  planner.py   the fixed menu of warmed batch sizes (``--serve-buckets``)
               and the pick-largest-ready / pad-to-smallest decision
  batcher.py   the bounded micro-batch queue with a flush deadline and
               explicit backpressure (503 when full)
  server.py    the replica: HTTP handler threads that only validate and
               enqueue, one dispatcher thread that calls ``infer_fn``
"""

from .planner import parse_buckets, choose_bucket, plan_batch  # noqa: F401
from .batcher import MicroBatcher, Request, QueueFullError  # noqa: F401
from .server import ServingTier  # noqa: F401
