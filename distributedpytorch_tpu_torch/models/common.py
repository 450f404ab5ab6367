"""Shared model building blocks of the zoo.

Counterpart of ``distributedpytorch_tpu/models/common.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """(B, C, H, W) adaptive average pool to (out_hw, out_hw), as the JAX
    package's NHWC ``adaptive_avg_pool`` (:9-23): the identity at that
    size, the mean over equal windows where out_hw divides H and W (the
    zoo's canonical sizes), else a bilinear resize of the map.

    The resize is ``jax.image.resize(..., "bilinear")``, antialiased on
    downscale, and is not what torch's ``AdaptiveAvgPool2d`` computes:
    ``F.interpolate(..., antialias=True)`` matches it on both sides
    (half-pixel centres, weights renormalised over the pixels inside the
    map), as ``data.augment.eval_transform`` does.  Both branches reduce
    in f32 and round to the input's dtype."""
    h, w = x.shape[-2:]
    if h == out_hw and w == out_hw:
        return x
    if h % out_hw == 0 and w % out_hw == 0:
        b, c = x.shape[:2]
        kh, kw = h // out_hw, w // out_hw
        return x.float().reshape(b, c, out_hw, kh, out_hw, kw).mean(
            dim=(3, 5)).to(x.dtype)
    return F.interpolate(x.float(), size=(out_hw, out_hw), mode="bilinear",
                         align_corners=False, antialias=True).to(x.dtype)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C), ``jnp.mean(x, axis=(1, 2))`` of the NHWC
    map: summed in f32, rounded to the input's dtype."""
    return x.float().mean(dim=(2, 3)).to(x.dtype)
