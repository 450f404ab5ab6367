"""Reference scaled-dot-product attention.

Counterpart of ``distributedpytorch_tpu/ops/attention.py::full_attention``
(the ring variants are not ported yet).  This is the plain reference the
flash kernel is held against and the ``--attention full`` path.
"""

from __future__ import annotations

import math

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """q/k/v (B, S, H, D) -> (B, S, H, D).  Computed in float32 for a
    stable softmax, cast back to the input dtype."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(dtype)
