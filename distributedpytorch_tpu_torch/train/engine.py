"""The train, eval and predict steps.

Counterpart of ``distributedpytorch_tpu/train/engine.py``: ``make_optimizer``
(:62-83), ``Engine`` (:86-331) with ``_train_step`` (``train_step``),
``_train_step_keys`` (``train_step_affine``), ``_finish_step`` and
``_eval_step`` (:612-628), and ``_predict_step`` (:630-648) as
``Predictor``.  One process, one device: there is no gradient all-reduce
yet, but the loss is formed as two sums, sum(numer * valid) /
max(sum(denom * valid), 1e-9) (:227-230), which a data-parallel world
all-reduces as they are.

PyTorch runs eagerly, so a step is a sequence of launches rather than one
compiled program; the state is updated in place (``TrainState`` holds the
model, the optimizer and the step count).  Metrics stay on the device; the
epoch loop reads them once per epoch.  The optimizers are ``torch.optim``'s:
Adam(lr=1e-3) has optax's defaults; SGD(lr=1e-3, momentum=0.9) is optax's
``sgd`` with ``trace``, and its staircase schedule lr = 1e-3 * 0.1 **
floor(step / steps_per_epoch) is set from the step count before every
update, as optax's ``exponential_decay(staircase=True)`` does, so a resumed
run and an uninterrupted one agree at an epoch boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..data import augment
from ..models.registry import freeze_backbone
from ..ops.losses import LossFn
from ..ops.metrics import per_example_correct
from ..precision import PrecisionPolicy, cast_grads

OPTIMIZER_CHOICES = ("adam", "SGD")


def make_optimizer(optimizer: str, model: nn.Module,
                   learning_rate: float = 1e-3,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """``--optimizer`` over the model's trainable parameters."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=learning_rate)
    if optimizer == "SGD":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)
    raise ValueError(f"Invalid optimizer {optimizer!r}")


def learning_rate_at(optimizer: str, step: int, learning_rate: float,
                     lr_step_gamma: float, steps_per_epoch: int) -> float:
    """Adam: constant.  SGD: the per-epoch staircase of the update count."""
    if optimizer != "SGD":
        return learning_rate
    return learning_rate * lr_step_gamma ** (step // max(1, steps_per_epoch))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class Engine:
    """The steps of one (model, config) pair on one device."""

    def __init__(self, model: nn.Module, loss_fn: LossFn, mean: float,
                 std: float, input_size: int, precision: PrecisionPolicy,
                 device: torch.device | str, optimizer: str = "adam",
                 learning_rate: float = 1e-3, momentum: float = 0.9,
                 lr_step_gamma: float = 0.1, steps_per_epoch: int = 1,
                 feature_extract: bool = False):
        if optimizer not in OPTIMIZER_CHOICES:
            raise ValueError(f"Invalid optimizer {optimizer!r}")
        self.model = model
        self.loss_fn = loss_fn
        self.mean = float(mean)
        self.std = float(std)
        self.input_size = int(input_size)
        self.precision = precision
        self.device = torch.device(device)
        self.optimizer_name = optimizer
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.lr_step_gamma = float(lr_step_gamma)
        self.steps_per_epoch = int(steps_per_epoch)
        self.feature_extract = bool(feature_extract)

    # -- state ------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Random weights from ``generator`` (flax's initializers), the
        backbone frozen under ``feature_extract``, a fresh optimizer."""
        self.model.init_weights(generator)
        if self.feature_extract:
            freeze_backbone(self.model)
        return TrainState(self.model, make_optimizer(
            self.optimizer_name, self.model, self.learning_rate,
            self.momentum))

    def lr(self, step: int) -> float:
        return learning_rate_at(self.optimizer_name, step,
                                self.learning_rate, self.lr_step_gamma,
                                self.steps_per_epoch)

    # -- steps ------------------------------------------------------------

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor,
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Draw the step's affine augmentation from ``generator``, then
        ``train_step_affine``."""
        b, h, w = images_u8.shape[:3]
        affine = augment.sample_affine_batch(generator, b, h, w)
        return self.train_step_affine(state, images_u8, labels, valid,
                                      affine)

    def train_step_affine(self, state: TrainState, images_u8: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor,
                          affine: augment.Affine
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Augment with the given draws, forward, masked loss, backward,
        grad cast, optimizer update.  The step's gradients stay on the
        parameters' ``.grad`` until the next step."""
        model = state.model
        model.train()
        imgs = augment.train_transform(
            images_u8, self.mean, self.std, self.input_size, affine,
            out_dtype=self.precision.compute_dtype)
        vmask = valid.to(self.precision.accum_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(imgs)
        numer, denom = self.loss_fn(logits, labels)
        loss = ((numer * vmask).sum()
                / torch.clamp_min((denom * vmask).sum(), 1e-9))
        loss.backward()
        self.apply_gradients(state)
        correct = (per_example_correct(logits.detach(), labels)
                   * vmask).sum()
        return state, {"loss": loss.detach(), "correct": correct,
                       "valid": vmask.sum()}

    def apply_gradients(self, state: TrainState) -> None:
        """The update tail of a step (``_finish_step``): gradients cast to
        the param dtype, the learning rate of this update count, one
        optimizer step, the count advanced."""
        cast_grads(state.model.parameters())
        lr = self.lr(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1

    @torch.no_grad()
    def eval_step(self, state: TrainState, images_u8: torch.Tensor,
                  labels: torch.Tensor, valid: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """Sums over the batch: loss numerator and denominator, correct
        and valid rows, masked by ``valid``."""
        model = state.model
        model.eval()
        imgs = augment.eval_transform(images_u8, self.mean, self.std,
                                      self.input_size,
                                      out_dtype=self.precision.compute_dtype)
        vmask = valid.to(self.precision.accum_dtype)
        logits = model(imgs)
        numer, denom = self.loss_fn(logits, labels)
        return {"loss_numer": (numer * vmask).sum(),
                "loss_denom": (denom * vmask).sum(),
                "correct": (per_example_correct(logits, labels)
                            * vmask).sum(),
                "valid": vmask.sum()}


class Predictor:
    """The serving-side predict step: one model on one device.  uint8
    images go through the eval transform and an eval-mode forward, then
    ``argmax`` of the logits (int32, first maximum on ties) and the max of
    ``softmax(logits)`` in the accumulation dtype.  Every output row is a
    function of its own input row only, so padded rows are inert."""

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
