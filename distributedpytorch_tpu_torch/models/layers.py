"""flax's Dense and Conv numerics, and its initializers, on torch layers.

The CNN models store their weights in ``nn.Linear``/``nn.Conv2d`` (f32,
torch's layouts) and apply them the way flax applies ``nn.Dense`` and
``nn.Conv`` with ``dtype=compute_dtype``: the weight is cast to the compute
dtype at use, the product is rounded to it, then the bias is added in it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import conv3x3_same_nchw
from .norm import BatchNorm


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)``."""
    return F.linear(x, layer.weight.to(x.dtype)) + layer.bias.to(x.dtype)


def conv(layer: nn.Conv2d, x: torch.Tensor, k5: bool = False
         ) -> torch.Tensor:
    """flax ``Conv(dtype=x.dtype)`` on an NCHW ``x``; ``k5`` takes a 3x3
    stride-1 SAME conv's weight gradient through kernel K5."""
    w = layer.weight.to(x.dtype)
    if k5:
        y = conv3x3_same_nchw(x, w)
    else:
        y = F.conv2d(x, w, stride=layer.stride, padding=layer.padding)
    if layer.bias is not None:
        y = y + layer.bias.to(x.dtype).reshape(1, -1, 1, 1)
    return y


def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults: lecun-normal kernels (truncated at 2 sigma), zero
    biases, BatchNorm scale 1, bias 0, running mean 0 and variance 1.  The
    draws are made on the generator's device and copied to the model's,
    so one CPU generator gives the same weights on every device."""
    dev = generator.device
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape, device=dev)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
    return model
