"""The train, eval and predict steps.

Counterpart of ``distributedpytorch_tpu/train/engine.py``: ``make_optimizer``
(:62-83), ``Engine`` (:86-331) with ``_train_step`` (``train_step``),
``_train_step_keys`` (``train_step_affine``), ``_finish_step`` and
``_eval_step`` (:612-628), and ``_predict_step`` (:630-648) as
``Predictor``.

PyTorch runs eagerly, so a step is a sequence of launches rather than one
compiled program; the state is updated in place (``TrainState`` holds the
model, the optimizer, the step count and, in a world of several ranks,
the ``DistributedDataParallel`` wrapper that averages the gradients).
BatchNorm's running statistics are the model's buffers: a train step
moves them, the eval step reads them.  Metrics stay on the device; the
epoch loop reads them once per epoch.

The loss is one masked mean over the global batch, sum(numer * valid) /
max(sum(denom * valid), 1e-9) (:227-230).  A rank's rows are its data
shard's (``runtime.Mesh``; the rank's own at ``--model-parallel`` 1), and
the M model ranks of a shard compute the same loss.  The denominator does
not depend on the parameters, so a rank all-reduces it over its data
group first (with the metric sums, one collective: every data shard
counted once) and back-propagates its shard's numerator sum times
data_parallel / global denominator.  Each rank's gradient is then its
shard's share of the global mean's gradient times data_parallel, the same
on the M ranks of a shard, and DDP's mean over all W = data_parallel * M
ranks is exactly the gradient of the global mean, whatever the number of
valid rows in each shard.  The affine augmentation of a step is drawn for
the whole rank-major global batch from the step's generator, which is
seeded alike on every rank, and data shard d keeps rows [d*b, (d+1)*b) of
its b rows, as one JAX key augments the global batch (:237-251).

The optimizers are ``torch.optim``'s: Adam(lr=1e-3) has optax's defaults;
SGD(lr=1e-3, momentum=0.9) is optax's ``sgd`` with ``trace``, and its
staircase schedule lr = 1e-3 * 0.1 ** floor(step / steps_per_epoch) is set
from the step count before every update, as optax's
``exponential_decay(staircase=True)`` does, so a resumed run and an
uninterrupted one agree at an epoch boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import runtime
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
    # the DistributedDataParallel wrapper of ``model`` in a process group
    ddp: Optional[nn.Module] = None


class Engine:
    """The steps of one (model, config) pair on one device."""

    def __init__(self, model: nn.Module, loss_fn: LossFn, mean: float,
                 std: float, input_size: int, precision: PrecisionPolicy,
                 device: torch.device | str, optimizer: str = "adam",
                 learning_rate: float = 1e-3, momentum: float = 0.9,
                 lr_step_gamma: float = 0.1, steps_per_epoch: int = 1,
                 feature_extract: bool = False,
                 mesh: Optional[runtime.Mesh] = None):
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
        # the (data, model) layout; at model_parallel 1 every rank is a
        # data shard of its own
        self.mesh = mesh or runtime.make_mesh(1)

    # -- state ------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> TrainState:
        """Random weights from ``generator`` (flax's initializers), the
        backbone frozen under ``feature_extract``, a fresh optimizer, and
        in a process group the DDP wrapper (which broadcasts rank 0's
        parameters; BatchNorm's buffers are alike on every rank, since
        their statistics are global, and are not broadcast)."""
        self.model.init_weights(generator)
        if self.feature_extract:
            freeze_backbone(self.model)
        ddp = None
        if runtime.distributed():
            from torch.nn.parallel import DistributedDataParallel

            ddp = DistributedDataParallel(
                self.model, broadcast_buffers=False,
                device_ids=([self.device] if self.device.type == "cuda"
                            else None))
        return TrainState(self.model, make_optimizer(
            self.optimizer_name, self.model, self.learning_rate,
            self.momentum), ddp=ddp)

    def lr(self, step: int) -> float:
        return learning_rate_at(self.optimizer_name, step,
                                self.learning_rate, self.lr_step_gamma,
                                self.steps_per_epoch)

    # -- steps ------------------------------------------------------------

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor,
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Draw the step's affine augmentation for the global batch from
        ``generator``, keep this data shard's rows, then
        ``train_step_affine``."""
        b, h, w = images_u8.shape[:3]
        dp, d = self.mesh.data_parallel, self.mesh.data_index
        affine = augment.sample_affine_batch(generator, dp * b, h, w)
        if dp > 1:
            affine = tuple(t[d * b:(d + 1) * b] for t in affine)
        return self.train_step_affine(state, images_u8, labels, valid,
                                      affine)

    def train_step_affine(self, state: TrainState, images_u8: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor,
                          affine: augment.Affine
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Augment this data shard's rows with the given draws, forward,
        the global masked loss, backward (DDP averages the gradients),
        grad cast, optimizer update.  The step's gradients stay on the
        parameters' ``.grad`` until the next step.  The metrics are the
        global batch's."""
        model = state.model
        model.train()
        imgs = augment.train_transform(
            images_u8, self.mean, self.std, self.input_size, affine,
            out_dtype=self.precision.compute_dtype)
        vmask = valid.to(self.precision.accum_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        logits = (model if state.ddp is None else state.ddp)(imgs)
        numer, denom = self.loss_fn(logits, labels)
        numer_sum = (numer * vmask).sum()
        correct = (per_example_correct(logits.detach(), labels)
                   * vmask).sum()
        sums = runtime.all_reduce_sum(torch.stack(
            [numer_sum.detach(), (denom * vmask).sum(), correct,
             vmask.sum()]), self.mesh.data_group)
        global_denom = torch.clamp_min(sums[1], 1e-9)
        (numer_sum * self.mesh.data_parallel / global_denom).backward()
        self.apply_gradients(state)
        return state, {"loss": sums[0] / global_denom, "correct": sums[2],
                       "valid": sums[3]}

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
