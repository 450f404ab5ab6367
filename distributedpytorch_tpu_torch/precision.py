"""Mixed-precision policy: the ``bf16`` and ``f32`` presets.

Counterpart of ``distributedpytorch_tpu/precision.py``.  ``param_dtype``
is the storage dtype of the weights, ``compute_dtype`` the dtype the
forward runs in (weights are cast to it at use, as flax casts at apply),
and ``accum_dtype`` the dtype of sums and of the serving softmax.  The
logits are f32 in both presets.  ``bf16_full`` and ``f16`` are
not ported yet.  ``cast_grads`` is the grad-cast rule of the JAX engine's
``_finish_step`` (``train/engine.py:304-305``): gradients reach the
optimizer in the param dtype, whatever dtype the backward produced.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype

    def describe(self) -> dict:
        """JSON-able summary, recorded in telemetry as
        ``precision_policy`` (the JAX package's keys)."""
        def name(dt):
            return str(dt).replace("torch.", "")

        return {"preset": self.name, "param_dtype": name(self.param_dtype),
                "compute_dtype": name(self.compute_dtype),
                "accum_dtype": name(self.accum_dtype),
                "output_dtype": "float32", "loss_scale": 1.0}


PRESETS = {
    "f32": PrecisionPolicy(
        name="f32", param_dtype=torch.float32, compute_dtype=torch.float32,
        accum_dtype=torch.float32),
    "bf16": PrecisionPolicy(
        name="bf16", param_dtype=torch.float32, compute_dtype=torch.bfloat16,
        accum_dtype=torch.float32),
}

PRESET_NAMES = tuple(PRESETS)


def get_policy(name: str) -> PrecisionPolicy:
    if name in ("bf16_full", "f16"):
        raise ValueError(f"not ported yet: --precision {name}")
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


def cast_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Cast every gradient to its parameter's dtype, in place."""
    for p in params:
        if p.grad is not None and p.grad.dtype != p.dtype:
            p.grad = p.grad.to(p.dtype)
