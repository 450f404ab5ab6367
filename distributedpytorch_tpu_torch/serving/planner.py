"""Bucket planner: the fixed menu of batch sizes the server warms.

A copy of ``distributedpytorch_tpu/serving/planner.py`` (stdlib only).
The tier warms a FIXED menu of bucket sizes up front
(``--serve-buckets``, one forward each) and every micro-batch is padded
to one of them, so request-path shapes are always ones already run.  The planning rule:

  * pending >= some bucket: take the LARGEST bucket that fills
    completely — maximum rows per dispatch, zero padding;
  * pending < the smallest bucket (a deadline flush): pad up to the
    smallest bucket — the padding rows are provably inert because the
    predict program runs eval-mode (BatchNorm uses running stats, no
    dropout), so every output row depends only on its own input row
    (pinned by tests/test_serve.py).

Pure functions over ints — no framework, no threads.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def parse_buckets(spec) -> Tuple[int, ...]:
    """``"1,4,16,64"`` (or an int sequence) -> sorted unique bucket
    tuple.  Rejects empty menus and non-positive sizes loudly — a typo
    here would otherwise surface as an unwarmed shape at request time."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
        try:
            sizes = [int(p) for p in parts]
        except ValueError as e:
            raise ValueError(
                f"--serve-buckets must be comma-separated ints, "
                f"got {spec!r}") from e
    else:
        sizes = [int(b) for b in spec]
    if not sizes:
        raise ValueError("--serve-buckets must name at least one bucket")
    if any(b < 1 for b in sizes):
        raise ValueError(
            f"--serve-buckets sizes must be >= 1, got {sorted(sizes)}")
    return tuple(sorted(set(sizes)))


def choose_bucket(pending: int, buckets: Sequence[int]) -> int:
    """The bucket for ``pending`` queued requests: largest fully-filled
    bucket, else the smallest one (padded)."""
    if pending < 1:
        raise ValueError(f"choose_bucket needs pending >= 1, got {pending}")
    fits = [b for b in buckets if b <= pending]
    return max(fits) if fits else min(buckets)


def plan_batch(pending: int, buckets: Sequence[int]) -> Tuple[int, int, int]:
    """(take, bucket, padding) for one micro-batch: dequeue ``take``
    requests, pad with ``padding`` inert rows to ``bucket``."""
    bucket = choose_bucket(pending, buckets)
    take = min(pending, bucket)
    return take, bucket, bucket - take
