"""BatchNorm with flax's semantics, its statistics global over the ranks.

Counterpart of flax ``nn.BatchNorm(use_running_average=not train,
momentum=0.9, dtype=...)`` as ``distributedpytorch_tpu/models/resnet.py``
uses it (:28-29, :58-59).  torch's ``BatchNorm2d``/``SyncBatchNorm`` differ
from it in three ways, so the port keeps its own module:

  * the running statistics move by ``momentum`` 0.9 of the old value
    (torch's ``momentum=0.1`` weighs the new one);
  * the running variance is the biased batch variance, computed as
    E[x^2] - E[x]^2 and floored at 0 (torch keeps the unbiased one);
  * statistics and normalisation are f32 for a half-precision input (at
    least f32, as flax promotes them), and only the result is cast to
    the compute dtype (eps 1e-5).

The statistics are taken over the global batch, as the JAX package's one
SPMD program takes them (``models/__init__.py``: sync-BN semantics): each
rank sums x, x^2 and its row count, and the sums are all-reduced with
``torch.distributed.nn.functional.all_reduce``, whose backward all-reduces
the gradient, so every rank's gradient sees every rank's rows.
``running_var`` holds flax's ``var`` and ``running_mean`` its ``mean``:
a JAX checkpoint's ``batch_stats`` load as they are.  Under ``--remat``
the recompute of a forward (``remat.recomputing()``) normalises with the
same batch statistics and leaves the running ones alone, so they move
once a step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from . import remat


def _global_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks of the default process group (``t``
    itself without one), differentiable."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t)
    return t


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of (B, C, H, W) or (B,
    C) inputs.  ``train()`` normalises with the global batch statistics
    and moves the running ones; ``eval()`` normalises with the running
    ones."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            count = torch.full((1,), float(x.numel() // x.shape[1]),
                               device=x.device)
            sums = _global_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                          count]))
            c = x.shape[1]
            n = sums[-1]
            mean = sums[:c] / n
            var = torch.clamp_min(sums[c:2 * c] / n - mean * mean, 0.0)
            if not remat.recomputing():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                    self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.to(xf.dtype).reshape(shape)
        return y.to(x.dtype)
