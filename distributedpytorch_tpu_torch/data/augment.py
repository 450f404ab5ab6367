"""On-device augmentation: uint8 images -> normalized model input.

Counterpart of ``distributedpytorch_tpu/data/augment.py``:

  * ``eval_transform`` (:151-167): bilinear resize with half-pixel centres,
    antialiased on downscale as ``jax.image.resize`` is
    (``F.interpolate(..., antialias=True)``); a resize to the input's own
    size is the identity.
  * ``train_transform`` (:52-148): rotation and random-resized crop fused
    into ONE inverse-affine bilinear sample per image, as one batched op on
    the device.  It is split in two: ``sample_affine_batch`` draws the
    (theta, y0, x0, crop_h, crop_w) parameters from one (b, 5) uniform
    draw with the formulas of ``_sample_affine_batch`` (:66-76), and
    ``train_transform`` warps with them using the hat-weight products of
    ``_warp_one`` (:79-119): half-pixel centres, rotation about
    ((h-1)/2, (w-1)/2) by -theta, zero fill outside the image, gray
    repeated to 3 channels, then normalize.  The draws come from a
    ``torch.Generator`` (Philox) and match the JAX ones (threefry) in
    distribution only; the parity tests inject the JAX draws.

Both transforms compute in f32, or in the output dtype where it is wider
(an f64 output, used to compare devices without f32 rounding).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

SCALE_RANGE = (0.08, 1.0)        # torchvision RandomResizedCrop defaults
LOG_RATIO_RANGE = (math.log(3.0 / 4.0), math.log(4.0 / 3.0))
MAX_ROTATION_DEG = 5.0

Affine = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor]


def sample_affine_batch(generator: torch.Generator, b: int, h: int,
                        w: int) -> Affine:
    """(theta, crop_y0, crop_x0, crop_h, crop_w), each (b,) f32 on the
    generator's device, from one (b, 5) uniform draw."""
    u = torch.rand((b, 5), generator=generator, device=generator.device)
    return affine_from_uniform(u, h, w)


def affine_from_uniform(u: torch.Tensor, h: int, w: int) -> Affine:
    """The affine parameters from a (b, 5) uniform draw in [0, 1)."""
    theta = (2.0 * u[:, 0] - 1.0) * MAX_ROTATION_DEG * (math.pi / 180.0)
    scale = SCALE_RANGE[0] + u[:, 1] * (SCALE_RANGE[1] - SCALE_RANGE[0])
    ratio = torch.exp(LOG_RATIO_RANGE[0]
                      + u[:, 2] * (LOG_RATIO_RANGE[1] - LOG_RATIO_RANGE[0]))
    area = scale * h * w
    crop_w = torch.clamp(torch.sqrt(area * ratio), 1.0, float(w))
    crop_h = torch.clamp(torch.sqrt(area / ratio), 1.0, float(h))
    y0 = u[:, 3] * (h - crop_h)
    x0 = u[:, 4] * (w - crop_w)
    return theta, y0, x0, crop_h, crop_w


def _work_dtype(out_dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(out_dtype, torch.float32)


def _hat_weights(images: torch.Tensor, affine: Affine, out_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_y (b, P, H), a_x (b, P, W)) bilinear hat weights of every output
    pixel p = i * out_dim + j over the source rows and columns, in the
    images' dtype."""
    h, w = images.shape[1], images.shape[2]
    dt = images.dtype
    theta, y0, x0, crop_h, crop_w = (t.to(dt).reshape(-1, 1, 1)
                                     for t in affine)
    dev = images.device
    ii = torch.arange(out_dim, dtype=dt, device=dev)
    ys = y0 + (ii[None, :, None] + 0.5) * crop_h / out_dim - 0.5
    xs = x0 + (ii[None, None, :] + 0.5) * crop_w / out_dim - 0.5
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos_t, sin_t = torch.cos(-theta), torch.sin(-theta)
    src_y = (cos_t * (ys - cy) - sin_t * (xs - cx) + cy).reshape(
        images.shape[0], -1)
    src_x = (sin_t * (ys - cy) + cos_t * (xs - cx) + cx).reshape(
        images.shape[0], -1)
    rows = torch.arange(h, dtype=dt, device=dev)
    cols = torch.arange(w, dtype=dt, device=dev)
    a_y = torch.clamp_min(1.0 - (src_y[..., None] - rows).abs(), 0.0)
    a_x = torch.clamp_min(1.0 - (src_x[..., None] - cols).abs(), 0.0)
    return a_y, a_x


def train_transform(images: torch.Tensor, mean: float, std: float,
                    out_dim: int, affine: Affine,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W) or (B, H, W, C) -> augmented float
    (B, out, out, 3): rotate + random-resized crop (one bilinear pass with
    the given affine draws) + gray -> 3 channels + normalize."""
    b = images.shape[0]
    imgs = images.to(_work_dtype(out_dtype)) / 255.0
    a_y, a_x = _hat_weights(imgs, affine, out_dim)
    if imgs.dim() == 3:
        t = torch.bmm(a_x, imgs.transpose(1, 2))          # (b, P, H)
        out = (a_y * t).sum(dim=-1)                       # (b, P)
        out = out.reshape(b, out_dim, out_dim, 1).expand(-1, -1, -1, 3)
    else:
        # same geometric draw for all channels of an image
        t = torch.einsum("bpw,bhwc->bphc", a_x, imgs)     # (b, P, H, C)
        out = (a_y[..., None] * t).sum(dim=2)             # (b, P, C)
        out = out.reshape(b, out_dim, out_dim, imgs.shape[-1])
    return ((out - mean) / std).to(out_dtype)


def eval_transform(images: torch.Tensor, mean: float, std: float,
                   out_dim: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W) gray or (B, H, W, C) -> float (B, out, out, 3):
    /255, bilinear resize, gray -> 3 channels, normalize, cast."""
    grayscale = images.dim() == 3
    imgs = images.to(_work_dtype(out_dtype)) / 255.0
    if grayscale:
        imgs = imgs[..., None]
    if tuple(imgs.shape[1:3]) != (out_dim, out_dim):
        imgs = F.interpolate(imgs.permute(0, 3, 1, 2), size=(out_dim, out_dim),
                             mode="bilinear", align_corners=False,
                             antialias=True).permute(0, 2, 3, 1)
    if grayscale:
        imgs = imgs.expand(-1, -1, -1, 3)
    return ((imgs - mean) / std).to(out_dtype)
