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
on the M ranks of a shard, and DDP's mean over the data group is exactly
the gradient of the global mean, whatever the number of valid rows in
each shard.  Under a model axis (M >= 2) the parameters are placed over
the model group (``parallel.place``, the JAX ``_place_state``): a rank
holds its slice of each sharded tensor, the optimizer steps on the
slices, and a rank's gradient of a slice is its share of the full
gradient, which the M ranks of a shard compute alike; so the slices and
the whole tensors alike are reduced over the data group only, never
summed over the model group (DDP over the data group, none when it has
one rank).  Under ``--pipeline-parallel`` (``models/vit_pipeline.py``)
the model group's ranks are pipeline stages and, with ``--seq-parallel``,
the M x S ranks of a data shard hold its rows: the model's own backward
makes every rank's gradients its shard's (a stage's blocks its own, the
replicated tensors equal on every rank), so the reduction is the same,
over the data group only.  The affine augmentation of a step is drawn for
the whole rank-major global batch from the step's generator, which is
seeded alike on every rank, and data shard d keeps rows [d*b, (d+1)*b) of
its b rows, as one JAX key augments the global batch (:237-251).  The
keep masks of a dropout model (alexnet, vgg, squeezenet, inception) are
drawn the same way, from the same generator after the affine draws:
uniform draws below keep = 1 - rate, for the global batch, each data
shard keeping its rows, so a world of several ranks trains as one process
does.  (The JAX package draws them from the step's dropout key; the
parity tests inject JAX's masks through ``train_step_affine``.)  A model
whose train-mode forward returns auxiliary logits (inception) adds their
loss with weight 0.4, ``loss1 + 0.4 * loss2`` as ``_grads_and_metrics``
(:274-277): the two numerators over the one global denominator, and the
correct rows counted from the primary logits.  A model that sows a loss
(the MoE vit's load balance, ``models/moe.py``; JAX ``_apply`` at
:196-224) returns each data shard's share of it from its train-mode
forward; the step adds data_parallel x the share to what it
back-propagates, so that DDP's mean is the gradient of the global mean
plus the sown loss, and the shares' sum over the data group to the
reported loss, JAX's ``loss + sown`` (:281).  The eval and predict steps
add nothing.

The optimizer state lives in ``torch.optim`` objects: Adam(lr=1e-3) has
optax's defaults and runs its own step (``capturable`` on the card, so
that its step count stays on the device); SGD(lr=1e-3, momentum=0.9)
holds the ``momentum_buffer`` of optax's ``sgd`` with ``trace``, and the
update is written here in ``torch._foreach`` ops (torch's SGD reads a
tensor learning rate back to the host): trace = 0.9 * trace + g, then p +
trace * -lr, optax's order.  Its staircase schedule lr = 1e-3 * 0.1 **
floor(updates / steps_per_epoch) is computed on the device from the count
of updates applied so far, as optax's ``exponential_decay(staircase=True)``
counts inside its state, so a resumed run and an uninterrupted one agree
at an epoch boundary.  Both optimizers' states exist from the first
update on (zeros, optax's initial state), whether that update is applied
or skipped.

A step reads nothing back from the device (``--epochs-per-dispatch``
captures it as a CUDA Graph, ``train/dispatch.py``): ``TrainState.step``
and ``.updates`` are 0-d int64 device tensors, the loss scale is two 0-d
tensors, and a skipped update is a ``torch.where`` between the state
before and after the optimizer's step.

Under ``--precision f16`` (``PrecisionPolicy.scales_loss``) the state
carries a ``LossScaleState`` (``_grads_and_metrics`` / ``_finish_step``,
:262-331): the backward runs on loss x scale, the gradients (after DDP's
reduction, so every rank decides alike) are divided by the scale and cast
to the parameter dtype, and a step whose gradients are not all finite is
skipped (under a model axis a rank checks its slices and the model group
sums the findings, so every rank reaches one verdict): the optimizer's
step runs, and ``torch.where`` puts back the parameters and the whole
optimizer state (Adam's own step count included) from a copy taken
before it, bit for bit; the applied-update count that
sets the learning rate does not move, and BatchNorm's running statistics,
which the forward moved in place, are put back the same way.
``state.step`` advances either way and the scale halves; a finite step
counts toward the scale's growth.

``grad_accum`` K > 1 is ``_train_step_accum`` (:366-467): microbatch j is
rows j, j+K, j+2K, ... of this data shard's rows (b % K == 0, so the data
shards' microbatches j together are the JAX stride over the global batch).
Each microbatch runs forward (its BatchNorm statistics over the global
microbatch, the running statistics chained from one microbatch to the
next) and backward of its numerator sum (x the loss scale), outside DDP's
reduction; its gradients are added, in the accumulation dtype (f32), to
one flat buffer, whatever the parameter dtype.  After the K microbatches
the buffer is summed over the data group once, and divided once by the
global denominator (x the scale): the exact gradient of the global masked
mean.  The dropout keep masks are
drawn per microbatch for the global microbatch's rows; inception adds 0.4
x its aux numerator; ``correct`` counts the primary logits; a sown loss
is added to each microbatch's numerator times the global microbatch's
denominator (one all-reduce of it over the data group), JAX's
per-microbatch weighting (:427-432).

``remat`` (``--remat``, :114-133): a model of REMAT_BLOCK_MODELS built
with ``remat="blocks"`` checkpoints its own blocks; under ``blocks`` the
engine checkpoints any other model's whole train-mode forward with the
matmul outputs saved, and under ``full`` every model's, saving nothing
(``models/remat.py``).  The dropout keep masks go into the checkpointed
function as arguments, so the recompute in the backward sees the masks
of its step.  The checkpoint wraps the model's own forward, inside
DDP's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import parallel, runtime
from ..data import augment
from ..models import remat as remat_mod
from ..models.layers import dropout_layers, set_dropout_masks
from ..models.registry import freeze_backbone
from ..ops.losses import LossFn
from ..ops.metrics import per_example_correct
from ..precision import LossScaleState, PrecisionPolicy, cast_grads

OPTIMIZER_CHOICES = ("adam", "SGD")
AUX_LOSS_WEIGHT = 0.4       # ref classif.py:49-53


def make_optimizer(optimizer: str, model: nn.Module,
                   learning_rate: float = 1e-3,
                   momentum: float = 0.9) -> torch.optim.Optimizer:
    """``--optimizer`` over the model's trainable parameters; Adam is
    ``capturable`` when they are on the card."""
    params = [p for p in model.parameters() if p.requires_grad]
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=learning_rate,
                                capturable=bool(params and params[0].is_cuda))
    if optimizer == "SGD":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum)
    raise ValueError(f"Invalid optimizer {optimizer!r}")


def learning_rate_at(optimizer: str, step: Union[int, torch.Tensor],
                     learning_rate: float, lr_step_gamma: float,
                     steps_per_epoch: int) -> Union[float, torch.Tensor]:
    """Adam: constant.  SGD: the per-epoch staircase of the update count;
    for a tensor count, a 0-d float64 tensor on its device, the number
    the host computes for the same count."""
    if optimizer != "SGD":
        return learning_rate
    k = step // max(1, steps_per_epoch)
    if isinstance(k, torch.Tensor):
        k = k.double()
    return learning_rate * lr_step_gamma ** k


def init_optimizer_state(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter without one the optimizer's initial state,
    optax's zeros, as torch would create it at its first step (Adam's step
    count on the device when ``capturable``)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            if isinstance(optimizer, torch.optim.Adam):
                state["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if group["capturable"] else "cpu")
                state["exp_avg"] = torch.zeros_like(p)
                state["exp_avg_sq"] = torch.zeros_like(p)
            else:
                state["momentum_buffer"] = torch.zeros_like(p)


@dataclasses.dataclass
class TrainState:
    """The trainer's state.  ``step`` and ``updates`` are 0-d int64
    tensors on the model's device (numbers given become such tensors),
    moved in place by the step: set them with ``fill_``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: Union[int, torch.Tensor] = 0
    # the DistributedDataParallel wrapper of ``model`` in a process group
    ddp: Optional[nn.Module] = None
    # optimizer updates applied (step less the skipped ones): the count
    # that the SGD schedule reads, as optax's state counts it
    updates: Union[int, torch.Tensor] = 0
    # the dynamic loss scale (f16); None for every other preset
    loss_scale: Optional[LossScaleState] = None

    def __post_init__(self):
        device = next(self.model.parameters()).device
        self.step = torch.as_tensor(self.step, dtype=torch.int64,
                                    device=device)
        self.updates = torch.as_tensor(self.updates, dtype=torch.int64,
                                       device=device)
        if self.loss_scale is not None:
            self.loss_scale.to(device)


def checkpoint_forward(model: nn.Module, save_dots: bool) -> None:
    """Make ``model``'s train-mode forward on the gradient path one
    ``remat.call`` (its eval forward stays as it is); the keep masks that
    its dropout layers hold at the call go in as arguments and are set
    again for the recompute."""
    plain = model.forward
    layers = dropout_layers(model)

    def run(x, *masks):
        before = [layer.mask for layer in layers]
        for layer, mask in zip(layers, masks):
            layer.mask = mask
        try:
            return plain(x)
        finally:
            for layer, mask in zip(layers, before):
                layer.mask = mask

    def forward(x):
        if not remat_mod.active(model):
            return plain(x)
        return remat_mod.call(run, x, *[layer.mask for layer in layers],
                              save_dots=save_dots)

    model.forward = forward


class Engine:
    """The steps of one (model, config) pair on one device."""

    def __init__(self, model: nn.Module, loss_fn: LossFn, mean: float,
                 std: float, input_size: int, precision: PrecisionPolicy,
                 device: torch.device | str, optimizer: str = "adam",
                 learning_rate: float = 1e-3, momentum: float = 0.9,
                 lr_step_gamma: float = 0.1, steps_per_epoch: int = 1,
                 feature_extract: bool = False,
                 mesh: Optional[runtime.Mesh] = None, grad_accum: int = 1,
                 remat: str = "none"):
        if optimizer not in OPTIMIZER_CHOICES:
            raise ValueError(f"Invalid optimizer {optimizer!r}")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if remat not in ("none", "blocks", "full"):
            raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
        self.grad_accum = int(grad_accum)
        self.remat = remat
        handles_blocks = hasattr(model, "remat_blocks")
        if handles_blocks and model.remat_blocks != (remat == "blocks"):
            raise ValueError(
                f"the model was built with remat_blocks="
                f"{model.remat_blocks} and the engine asked for remat "
                f"{remat!r}: give get_model the same remat")
        if remat == "full" or (remat == "blocks" and not handles_blocks):
            checkpoint_forward(model, save_dots=remat == "blocks")
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

    def init_state(self, generator: torch.Generator,
                   load_weights: Optional[Callable[[nn.Module], None]]
                   = None) -> TrainState:
        """Random weights from ``generator`` (flax's initializers), then
        ``load_weights(model)`` if given (``--use-pretrained``'s
        backbone), the backbone frozen under ``feature_extract``, under
        a model axis the parameters placed over the model group
        (``parallel.place``), a fresh optimizer over the rank's tensors,
        and the DDP wrapper over the data group when it has several
        ranks (which broadcasts its first rank's parameters; BatchNorm's
        buffers are alike on every rank, since their statistics are
        global, and are not broadcast)."""
        self.model.init_weights(generator)
        if load_weights is not None:
            load_weights(self.model)
        if self.feature_extract:
            freeze_backbone(self.model)
        parallel.place(self.model, self.mesh)
        ddp = None
        if runtime.distributed() and (self.mesh.shard_ranks == 1
                                      or self.mesh.data_parallel > 1):
            from torch.nn.parallel import DistributedDataParallel

            ddp = DistributedDataParallel(
                self.model, broadcast_buffers=False,
                process_group=self.mesh.data_group,
                device_ids=([self.device] if self.device.type == "cuda"
                            else None))
        return TrainState(self.model, make_optimizer(
            self.optimizer_name, self.model, self.learning_rate,
            self.momentum), ddp=ddp, loss_scale=self.fresh_loss_scale())

    def fresh_loss_scale(self) -> Optional[LossScaleState]:
        """The policy's initial loss scale (f16), or None."""
        if not self.precision.scales_loss:
            return None
        return LossScaleState.create(self.precision.loss_scale)

    def lr(self, step: Union[int, torch.Tensor]
           ) -> Union[float, torch.Tensor]:
        return learning_rate_at(self.optimizer_name, step,
                                self.learning_rate, self.lr_step_gamma,
                                self.steps_per_epoch)

    # -- steps ------------------------------------------------------------

    def train_step(self, state: TrainState, images_u8: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor,
                   generator: torch.Generator
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Draw the step's affine augmentation and then the dropout masks
        for the global batch from ``generator``, keep this data shard's
        rows, then ``train_step_affine``."""
        b, h, w = images_u8.shape[:3]
        dp, d = self.mesh.data_parallel, self.mesh.data_index
        affine = augment.sample_affine_batch(generator, dp * b, h, w)
        if dp > 1:
            affine = tuple(t[d * b:(d + 1) * b] for t in affine)
        k = self.grad_accum
        # K = 1: one list for the batch; K > 1: one list per microbatch,
        # drawn for the global microbatch's dp * b / K rows, of which this
        # data shard keeps its b / K
        rows = b // k
        masks = [self.draw_dropout_masks(generator, dp * rows)
                 for _ in range(k)]
        if dp > 1:
            masks = [[m[d * rows:(d + 1) * rows] for m in ms]
                     for ms in masks]
        return self.train_step_affine(state, images_u8, labels, valid,
                                      affine, masks[0] if k == 1 else masks)

    def draw_dropout_masks(self, generator: torch.Generator,
                           rows: int) -> List[torch.Tensor]:
        """The keep masks of the model's dropout layers for ``rows``
        rows, in the JAX layout, drawn from ``generator`` (none for a
        model without dropout)."""
        layers = dropout_layers(self.model)
        if not layers:
            return []
        shapes = self.model.dropout_shapes(self.input_size)
        return [torch.rand((rows,) + tuple(shape), generator=generator,
                           device=generator.device) < 1.0 - layer.rate
                for layer, shape in zip(layers, shapes)]

    def train_step_affine(self, state: TrainState, images_u8: torch.Tensor,
                          labels: torch.Tensor, valid: torch.Tensor,
                          affine: augment.Affine,
                          dropout_masks: Sequence[torch.Tensor] = ()
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Augment this data shard's rows with the given draws, forward
        with the given dropout keep masks (this shard's rows, in the JAX
        layout; with ``grad_accum`` K > 1, K lists, one per microbatch, of
        its b / K rows), the global masked loss (with the aux logits'
        share), backward (DDP averages the gradients; x the loss scale
        under f16), the update tail (``apply_gradients``).  The step's
        gradients stay on the parameters' ``.grad`` until the next step.
        The metrics are the global batch's."""
        model = state.model
        model.train()
        imgs = augment.train_transform(
            images_u8, self.mean, self.std, self.input_size, affine,
            out_dtype=self.precision.compute_dtype)
        vmask = valid.to(self.precision.accum_dtype)
        state.optimizer.zero_grad(set_to_none=True)
        scale = None if state.loss_scale is None else state.loss_scale.scale
        # a skipped step puts back what the forward moved in place
        buffers = list(model.buffers())
        saved = (torch._foreach_mul(buffers, 1)
                 if scale is not None and buffers else None)
        if self.grad_accum > 1:
            sums = self._accumulate(state, imgs, labels, vmask,
                                    dropout_masks, scale)
            global_denom = torch.clamp_min(sums[1], 1e-9)
        else:
            numer_sum, local, sown = self._forward_sums(
                model if state.ddp is None else state.ddp, imgs, labels,
                vmask, dropout_masks)
            if sown is not None:
                local = torch.cat([local, sown.detach()[None]])
            sums = runtime.all_reduce_sum(local, self.mesh.data_group)
            global_denom = torch.clamp_min(sums[1], 1e-9)
            target = numer_sum * self.mesh.data_parallel / global_denom
            if sown is not None:
                # the data shards' shares sum to the global batch's loss
                target = target + sown * self.mesh.data_parallel
            (target if scale is None else target * scale).backward()
        parallel.release(model)
        # _accumulate divides by the scale itself, in its one divide
        unscale = None if self.grad_accum > 1 else scale
        finite = self.apply_gradients(state, unscale)
        if saved is not None:
            with torch.no_grad():
                for b, s in zip(buffers, saved):
                    torch.where(finite, b, s, out=b)
        loss = sums[0] / global_denom
        if sums.shape[0] > 4:
            loss = loss + sums[4]       # JAX's loss + sown
        return state, {"loss": loss, "correct": sums[2], "valid": sums[3]}

    def _forward_sums(self, module: nn.Module, imgs: torch.Tensor,
                      labels: torch.Tensor, vmask: torch.Tensor,
                      dropout_masks: Sequence[torch.Tensor],
                      microbatch: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
        """One train-mode forward of ``imgs`` with the given keep masks:
        (the differentiable numerator sum, with 0.4 x the aux logits'; the
        detached local sums of numerator, denominator, correct and valid
        rows; this data shard's share of what the model sowed (a MoE vit's
        load-balance loss, differentiable), else None).  A ``microbatch``
        of ``_accumulate`` adds the sown share x the global microbatch's
        denominator to its numerator instead (JAX ``engine.py:427-432``)
        and returns None for it."""
        set_dropout_masks(self.model, list(dropout_masks) or None)
        try:
            out = module(imgs)
        finally:
            set_dropout_masks(self.model, None)
        sown = None
        if isinstance(out, dict):
            out, sown = out["logits"], out["sown"]
        logits, aux = out if isinstance(out, tuple) else (out, None)
        numer, denom = self.loss_fn(logits, labels)
        numer_sum = (numer * vmask).sum()
        if aux is not None:
            numer_sum = numer_sum + AUX_LOSS_WEIGHT * (
                self.loss_fn(aux, labels)[0] * vmask).sum()
        denom_sum = (denom * vmask).sum()
        if sown is not None and microbatch:
            global_denom = runtime.all_reduce_sum(denom_sum.clone(),
                                                  self.mesh.data_group)
            numer_sum = numer_sum + sown * global_denom
            sown = None
        correct = (per_example_correct(logits.detach(), labels)
                   * vmask).sum()
        return numer_sum, torch.stack([numer_sum.detach(), denom_sum,
                                       correct, vmask.sum()]), sown

    def _accumulate(self, state: TrainState, imgs: torch.Tensor,
                    labels: torch.Tensor, vmask: torch.Tensor,
                    dropout_masks, scale: Optional[torch.Tensor]
                    ) -> torch.Tensor:
        """``grad_accum`` K microbatches (see the module docstring): each
        one's gradients of numerator x scale summed into one f32 buffer
        (of the rank's slices under a model axis), the buffer summed over
        the data group and divided by the global denominator x scale,
        then set as the parameters' gradients in their dtype.  Returns
        the global sums of numerator, denominator, correct and valid
        rows."""
        k = self.grad_accum
        b = imgs.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by grad_accum={k}")
        masks = list(dropout_masks) or [()] * k
        if len(masks) != k:
            raise ValueError(f"{len(masks)} dropout mask lists for {k} "
                             f"microbatches")
        params = [p for p in state.model.parameters() if p.requires_grad]
        acc = torch.zeros(sum(p.numel() for p in params),
                          dtype=self.precision.accum_dtype,
                          device=imgs.device)
        sums = None
        for j in range(k):
            numer_sum, local, _ = self._forward_sums(
                state.model, imgs[j::k], labels[j::k], vmask[j::k],
                masks[j], microbatch=True)
            # outside DDP's reduction: the buffer is summed once below
            (numer_sum if scale is None else numer_sum * scale).backward()
            at = 0
            for p in params:
                n = p.numel()
                if p.grad is not None:
                    acc[at:at + n] += p.grad.reshape(-1)
                    p.grad = None
                at += n
            sums = local if sums is None else sums + local
        parallel.release(state.model)
        sums = runtime.all_reduce_sum(sums, self.mesh.data_group)
        runtime.all_reduce_sum(acc, self.mesh.data_group)
        acc /= (torch.clamp_min(sums[1], 1e-9)
                * (1.0 if scale is None else scale))
        at = 0
        for p in params:
            n = p.numel()
            p.grad = acc[at:at + n].view_as(p).to(p.dtype)
            at += n
        return sums

    def apply_gradients(self, state: TrainState,
                        scale: Optional[torch.Tensor] = None
                        ) -> Optional[torch.Tensor]:
        """The update tail of a step (``_finish_step``), with no read of
        the device: under a loss scale the gradients divided by it, then
        cast to the param dtype; the optimizer's step at the
        applied-update count's learning rate; under a loss scale, a step
        whose gradients are not all finite is undone (parameters and
        optimizer state put back from a copy, bit for bit) and the scale
        halves.  The step count advances either way.  Returns the 0-d bool
        tensor of whether the update was applied (None without a loss
        scale: always)."""
        params = list(state.model.parameters())
        optimizer = state.optimizer
        init_optimizer_state(optimizer)
        with torch.no_grad():
            finite = kept = None
            if state.loss_scale is not None:
                # unscaled and checked in one pass: the scale is a power of
                # two, so g * (1 / scale) is g / scale exactly.  The
                # decision is the same on every rank: DDP (or _accumulate)
                # reduced the gradients over the data group, and the model
                # group sums its ranks' findings
                found = torch.zeros(1, device=state.step.device)
                inv = (torch.ones_like(found) if scale is None
                       else torch.reciprocal(scale.float()).reshape(1))
                torch._amp_foreach_non_finite_check_and_unscale_(
                    [p.grad for p in params if p.grad is not None], found,
                    inv)
                if self.mesh.model_parallel > 1:
                    # each rank checked its own slices: one verdict
                    runtime.all_reduce_sum(found, self.mesh.model_group)
                finite = (found == 0).reshape(())
                state.loss_scale.assign(state.loss_scale.adjust(
                    finite, self.precision.loss_scale_growth))
                kept = [t for group in optimizer.param_groups
                        for p in group["params"] if p.grad is not None
                        for t in (p, *optimizer.state[p].values())]
                saved = torch._foreach_mul(kept, 1)
            cast_grads(params)
            if self.optimizer_name == "SGD":
                self._sgd_update(optimizer, self.lr(state.updates))
            else:
                optimizer.step()
            if kept is not None:
                for t, s in zip(kept, saved):
                    torch.where(finite, t, s, out=t)
                state.updates.add_(finite.long())
            else:
                state.updates.add_(1)
            state.step.add_(1)
        return finite

    def _sgd_update(self, optimizer: torch.optim.Optimizer,
                    lr: torch.Tensor) -> None:
        """optax's sgd with trace on the parameters that have gradients:
        trace = momentum * trace + g, p = p + trace * -lr (``lr`` a 0-d
        tensor)."""
        params = [p for group in optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        if not params:
            return
        trace = [optimizer.state[p]["momentum_buffer"] for p in params]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, [p.grad for p in params])
        torch._foreach_add_(params, torch._foreach_mul(
            trace, (-lr).to(torch.float32)))

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
    function of its own input row only, so padded rows are inert; but a
    MoE vit's, whose expert capacity is shared by the rows of a dispatch
    group, depends on its batch-mates too (as in the JAX package)."""

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
