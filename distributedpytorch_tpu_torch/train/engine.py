"""The serving-side predict step.

Counterpart of ``distributedpytorch_tpu/train/engine.py::Engine._predict_step``
(:630-648); the train and eval steps are not ported yet.  uint8 images go
through the eval transform, an eval-mode forward, then ``argmax`` of the
logits (int32, first maximum on ties, as ``jnp.argmax``) and the max of
``softmax(logits)`` taken in the accumulation dtype.  Eval-mode apply makes
every output row a function of its own input row only, so padded rows are
inert.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..data import augment
from ..precision import PrecisionPolicy


class Predictor:
    """One model on one device, answering ``predict_step`` batches."""

    def __init__(self, model: nn.Module, mean: float, std: float,
                 input_size: int, precision: PrecisionPolicy,
                 device: torch.device):
        self.model = model.eval()
        self.mean = float(mean)
        self.std = float(std)
        self.input_size = int(input_size)
        self.precision = precision
        self.device = torch.device(device)

    @torch.inference_mode()
    def predict_step(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W[, C]) numpy array or tensor -> (labels int32,
        confidences in the accumulation dtype), both (B,) on the device."""
        if isinstance(images_u8, np.ndarray):
            images_u8 = torch.from_numpy(images_u8)
        x = images_u8.to(self.device, non_blocking=True)
        imgs = augment.eval_transform(x, self.mean, self.std,
                                      self.input_size,
                                      out_dtype=self.precision.compute_dtype)
        logits = self.model(imgs)
        probs = torch.softmax(logits.to(self.precision.accum_dtype), dim=-1)
        return (torch.argmax(logits, dim=-1).to(torch.int32),
                probs.amax(dim=-1))
