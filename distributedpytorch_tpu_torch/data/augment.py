"""The eval transform: uint8 images -> normalized model input.

Counterpart of ``distributedpytorch_tpu/data/augment.py::eval_transform``
(:151-167); the train-time warp is not ported yet.  Conventions kept:
the resize is bilinear with half-pixel centres, antialiased on downscale
as ``jax.image.resize`` is (``F.interpolate(..., antialias=True)``), and
a resize to the input's own size is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def eval_transform(images: torch.Tensor, mean: float, std: float,
                   out_dim: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W) gray or (B, H, W, C) -> float (B, out, out, 3):
    /255, bilinear resize, gray -> 3 channels, normalize, cast."""
    grayscale = images.dim() == 3
    imgs = images.to(torch.float32) / 255.0
    if grayscale:
        imgs = imgs[..., None]
    if tuple(imgs.shape[1:3]) != (out_dim, out_dim):
        imgs = F.interpolate(imgs.permute(0, 3, 1, 2), size=(out_dim, out_dim),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)
    if grayscale:
        imgs = imgs.expand(-1, -1, -1, 3)
    return ((imgs - mean) / std).to(out_dtype)
