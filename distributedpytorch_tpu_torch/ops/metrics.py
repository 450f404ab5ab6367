"""Metrics: per-example top-1 correctness.

Counterpart of ``distributedpytorch_tpu/ops/metrics.py``
(``per_example_correct``, :15-18).  ``torch.argmax`` takes the first
maximum on ties, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch


def per_example_correct(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """top-1 argmax vs labels -> float32 (B,) of 0/1."""
    pred = torch.argmax(logits, dim=-1)
    return (pred == labels.to(pred.dtype)).to(torch.float32)
