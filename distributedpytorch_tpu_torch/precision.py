"""Mixed-precision policy: the ``f32``, ``bf16``, ``bf16_full`` and ``f16``
presets, and the dynamic loss scale of ``f16``.

Counterpart of ``distributedpytorch_tpu/precision.py`` (:78-184).
``param_dtype`` is the storage dtype of the weights (bfloat16 under
``bf16_full``, f32 otherwise; BatchNorm's running statistics are buffers
and stay f32 in every preset), ``compute_dtype`` the dtype the forward
runs in (weights are cast to it at use, as flax casts at apply), and
``accum_dtype`` the dtype of sums, of the gradient buffers of
``--grad-accum`` and of the serving softmax.  The logits are f32 in every
preset.  ``cast_grads`` is the grad-cast rule of the JAX engine's
``_finish_step`` (``train/engine.py:304-305``): gradients reach the
optimizer in the param dtype, whatever dtype the backward produced.

``f16`` scales the loss: ``LossScaleState`` is JAX's state machine, on
0-d device tensors (the scale is a power of two, so its arithmetic is
exact in any float type).  ``torch.amp.GradScaler`` is not used: it
starts at 2^16 and has neither the cap at 2^24 nor the floor at 1, so its
trajectory would differ from the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

MAX_LOSS_SCALE = 2.0 ** 24      # the JAX cap: a clean run cannot reach inf


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One named mixed-precision configuration.  ``loss_scale`` is the
    initial dynamic loss scale, 0.0 for none (every preset but f16);
    ``loss_scale_growth`` the number of consecutive finite steps after
    which the scale doubles."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype
    loss_scale: float = 0.0
    loss_scale_growth: int = 2000

    @property
    def scales_loss(self) -> bool:
        return self.loss_scale > 0.0

    def describe(self) -> dict:
        """JSON-able summary, recorded in telemetry as
        ``precision_policy`` (the JAX package's keys)."""
        def name(dt):
            return str(dt).replace("torch.", "")

        return {"preset": self.name, "param_dtype": name(self.param_dtype),
                "compute_dtype": name(self.compute_dtype),
                "accum_dtype": name(self.accum_dtype),
                "output_dtype": "float32",
                "loss_scale": float(self.loss_scale)}


PRESETS = {
    "f32": PrecisionPolicy(
        name="f32", param_dtype=torch.float32, compute_dtype=torch.float32,
        accum_dtype=torch.float32),
    "bf16": PrecisionPolicy(
        name="bf16", param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        accum_dtype=torch.float32),
    # bf16 weights (and so bf16 optimizer state); updates below about 2^-8
    # of a weight's magnitude are lost, as in the JAX package
    "bf16_full": PrecisionPolicy(
        name="bf16_full", param_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16, accum_dtype=torch.float32),
    # f16's 5-bit exponent underflows small gradients without the scale
    "f16": PrecisionPolicy(
        name="f16", param_dtype=torch.float32, compute_dtype=torch.float16,
        accum_dtype=torch.float32, loss_scale=float(2 ** 15)),
}

PRESET_NAMES = tuple(PRESETS)


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown precision preset {name!r}; choose from "
                         f"{PRESET_NAMES}") from None


def from_flags(precision: Optional[str],
               half_precision: bool) -> PrecisionPolicy:
    """``--precision`` wins when given; otherwise ``--no-bf16`` picks f32
    and its absence bf16, as in the JAX package."""
    if precision is not None:
        if precision != "f32" and not half_precision:
            raise ValueError(
                f"--no-bf16 conflicts with --precision {precision}: "
                "--no-bf16 is the legacy alias for --precision f32; drop one")
        return get_policy(precision)
    return PRESETS["bf16" if half_precision else "f32"]


@dataclasses.dataclass
class LossScaleState:
    """The dynamic loss scale of ``f16`` (JAX ``LossScaleState``):
    ``scale`` multiplies the loss before the backward, and the step divides
    the gradients back; ``good_steps`` counts consecutive finite steps.
    Both are 0-d tensors on the run's device (f32 and int32, JAX's
    dtypes), so a step reads and moves the scale (``adjust``, then
    ``assign`` into the trainer's tensors) without a read of the device,
    and a captured step moves it on every replay; numbers given to the
    constructor become such tensors, on the CPU."""

    scale: torch.Tensor
    good_steps: torch.Tensor = 0

    def __post_init__(self):
        self.scale = torch.as_tensor(self.scale, dtype=torch.float32)
        self.good_steps = torch.as_tensor(self.good_steps,
                                          dtype=torch.int32)

    @classmethod
    def create(cls, initial_scale: float,
               device: torch.device | str = "cpu") -> "LossScaleState":
        return cls(scale=float(initial_scale), good_steps=0).to(device)

    def to(self, device: torch.device | str) -> "LossScaleState":
        """The same state on ``device``."""
        self.scale = self.scale.to(device)
        self.good_steps = self.good_steps.to(device)
        return self

    def adjust(self, grads_finite, growth_interval: int = 2000
               ) -> "LossScaleState":
        """The next state: a finite step doubles the scale when it
        completes ``growth_interval`` good steps (and restarts the count),
        a non-finite one halves it, floored at 1; the scale is capped at
        2^24.  ``grads_finite``: a bool or a 0-d bool tensor.  Every branch
        is a ``torch.where`` of powers of two, exact in f32, so the
        trajectory is JAX's bit for bit, with no read of the device."""
        finite = torch.as_tensor(grads_finite, device=self.scale.device)
        grew = self.good_steps + 1 >= growth_interval
        grown = torch.where(grew, self.scale * 2.0, self.scale)
        shrunk = torch.clamp_min(self.scale * 0.5, 1.0)
        return LossScaleState(
            scale=torch.clamp_max(torch.where(finite, grown, shrunk),
                                  MAX_LOSS_SCALE),
            good_steps=torch.where(finite & ~grew, self.good_steps + 1, 0))

    def assign(self, other: "LossScaleState") -> None:
        """Take ``other``'s values in place (the tensors stay these)."""
        self.scale.copy_(other.scale)
        self.good_steps.copy_(other.good_steps)

    def to_dict(self) -> dict:
        """Plain numbers (a read of the device), as format 3 stores them."""
        return {"scale": float(self.scale),
                "good_steps": int(self.good_steps)}

    @classmethod
    def from_dict(cls, d: dict) -> "LossScaleState":
        return cls(scale=float(d["scale"]), good_steps=int(d["good_steps"]))


def all_finite(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """0-dim bool tensor: every element of every given tensor is finite
    (True for none).  One device reduction; ``None`` entries are
    skipped."""
    checks = [torch.isfinite(t).all() for t in tensors if t is not None]
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


def cast_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Cast every gradient to its parameter's dtype, in place."""
    for p in params:
        if p.grad is not None and p.grad.dtype != p.dtype:
            p.grad = p.grad.to(p.dtype)
