"""flax's Dense, Conv and Dropout numerics, and its initializers, on torch
layers.

The CNN models store their weights in ``nn.Linear``/``nn.Conv2d`` (f32,
torch's layouts) and apply them the way flax applies ``nn.Dense`` and
``nn.Conv`` with ``dtype=compute_dtype``: the weight is cast to the compute
dtype at use, the product is rounded to it, then the bias is added in it.

``Dropout`` is flax's ``nn.Dropout`` with its keep mask given from
outside: the train step draws the masks of every dropout layer from its
generator (``train.engine``), and a parity test can set the JAX masks.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

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


def lecun_draw(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """flax's lecun-normal draw of one kernel of ``shape`` in torch's
    layout (fan-in: every axis but the first), truncated at 2 sigma, on
    the generator's device."""
    std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
    w = torch.empty(shape, device=generator.device)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return w


def lecun_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's defaults: lecun-normal kernels (truncated at 2 sigma), zero
    biases, BatchNorm scale 1, bias 0, running mean 0 and variance 1.  The
    draws are made on the generator's device and copied to the model's,
    so one CPU generator gives the same weights on every device.  A
    ``--scan-layers`` run (``models/scan.py``) draws its stacked kernels
    itself, step by step, where the unrolled blocks' draws fall."""
    with torch.no_grad():
        inside = set()
        for mod in model.modules():
            if id(mod) in inside:
                continue
            if hasattr(mod, "init_stacked_"):
                mod.init_stacked_(generator)
                inside.update(id(m) for m in mod.modules())
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.copy_(lecun_draw(tuple(mod.weight.shape),
                                            generator))
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
    return model


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode ``where(mask, x / keep,
    0)`` with keep = 1 - rate and ``mask`` the keep mask (bool, ``x``'s
    shape) that ``set_dropout_masks`` set before the forward; the identity
    in eval mode.  It draws nothing itself."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        if self.mask is None:
            raise ValueError("a train-mode dropout needs its keep mask "
                             "(set_dropout_masks; Engine.train_step draws "
                             "them)")
        keep = 1.0 - self.rate
        return torch.where(self.mask, x / keep, torch.zeros_like(x))


def dropout_layers(model: nn.Module) -> List[Dropout]:
    """The model's dropout layers, in the order its forward calls them
    (each model registers them in that order)."""
    return [m for m in model.modules() if isinstance(m, Dropout)]


def set_dropout_masks(model: nn.Module,
                      masks: Optional[Sequence[torch.Tensor]]) -> None:
    """Give each dropout layer its keep mask, in the JAX layout: (B, F),
    or (B, H, W, C) for a feature map, which is permuted to the port's
    (B, C, H, W) view.  ``None`` clears them."""
    layers = dropout_layers(model)
    if masks is None:
        for layer in layers:
            layer.mask = None
        return
    if len(masks) != len(layers):
        raise ValueError(f"{len(masks)} dropout masks for {len(layers)} "
                         f"dropout layers")
    for layer, mask in zip(layers, masks):
        layer.mask = mask.permute(0, 3, 1, 2) if mask.dim() == 4 else mask
