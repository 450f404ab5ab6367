"""Loss zoo: cross_entropy | weighted_cross_entropy | focal_loss.

Counterpart of ``distributedpytorch_tpu/ops/losses.py`` (:39-92).  Each
loss returns per-example (numerator, denominator) pairs, so the engine
forms the masked mean as two sums, sum(numer * valid) / sum(denom *
valid), which a data-parallel world all-reduces as sums:

  * cross_entropy / focal_loss: denom = 1 per example (a plain mean);
  * weighted_cross_entropy: denom = w_{y_n} (torch CrossEntropyLoss with
    weights divides by the sum of target weights).

The logits are upcast to the accumulation dtype (f32) before the
log-softmax, whatever the model's compute dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

LossFn = Callable[[torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def _log_softmax_gather(logits: torch.Tensor, labels: torch.Tensor,
                        accum_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(accum_dtype), dim=-1)
    return torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.nn.CrossEntropyLoss() per example."""
    nll = -_log_softmax_gather(logits, labels)
    return nll, torch.ones_like(nll)


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.nn.CrossEntropyLoss(weight=...) per example."""
    nll = -_log_softmax_gather(logits, labels)
    w = class_weights[labels.long()]
    return w * nll, w


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               class_weights: Optional[torch.Tensor] = None,
               gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """w_y * (1 - p_y)^gamma * (-log p_y), denominator 1."""
    logp = _log_softmax_gather(logits, labels)
    p = torch.exp(logp)
    per_ex = -((1.0 - p) ** gamma) * logp
    if class_weights is not None:
        per_ex = class_weights[labels.long()] * per_ex
    return per_ex, torch.ones_like(per_ex)


def get_loss_fn(name: str, class_weights: Optional[np.ndarray] = None,
                focal_gamma: float = 2.0,
                device: torch.device | str = "cpu") -> LossFn:
    """Loss by name (invalid -> ValueError); class weights are placed on
    ``device`` once."""
    if name == "cross_entropy":
        return cross_entropy
    cw = (None if class_weights is None
          else torch.as_tensor(np.asarray(class_weights, np.float32),
                               device=device))
    if name == "weighted_cross_entropy":
        if cw is None:
            raise ValueError("weighted_cross_entropy requires class weights")
        return lambda lg, lb: weighted_cross_entropy(lg, lb, cw)
    if name == "focal_loss":
        return lambda lg, lb: focal_loss(lg, lb, cw, focal_gamma)
    raise ValueError(f"Invalid loss {name!r}")
