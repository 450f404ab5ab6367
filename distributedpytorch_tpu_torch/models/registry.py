"""Model registry: name -> module / input size, and the head/backbone
split of ``--feature-extract``.

Counterpart of ``distributedpytorch_tpu/models/registry.py`` (``get_model``,
``get_model_input_size`` and ``trainable_mask`` at :290-299), for ``vit``
with ``attention`` in {full, flash}.  Every other model or feature raises
"not ported yet".
"""

from __future__ import annotations

import torch
from torch import nn

from ..precision import PrecisionPolicy

KNOWN_MODELS = ("cnn", "mlp", "resnet", "alexnet", "vgg", "squeezenet",
                "densenet", "inception", "vit")
_INPUT_SIZES = {"vit": 28}


def _check_name(name: str) -> None:
    if name not in KNOWN_MODELS:
        raise ValueError(f"Invalid model name {name!r} "
                         f"(choices: {sorted(KNOWN_MODELS)})")
    if name not in _INPUT_SIZES:
        raise ValueError(f"not ported yet: --model {name}")


def attention_fn(attention: str):
    """``--attention`` -> the (B, S, H, D) attention function."""
    if attention == "full":
        from ..ops.attention import full_attention

        return full_attention
    if attention == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention
    if attention in ("ring", "ring_flash"):
        raise ValueError(f"not ported yet: --attention {attention}")
    raise ValueError(f"attention must be 'full', 'ring', 'flash' or "
                     f"'ring_flash', got {attention!r}")


def get_model(name: str, num_classes: int, precision: PrecisionPolicy,
              attention: str = "full",
              device: torch.device | str = "cuda") -> nn.Module:
    """The registry's full-width model, on ``device``, with f32 weights
    (zeros until restored or ``init_weights``)."""
    _check_name(name)
    from .vit import ViT

    return ViT(num_classes=num_classes, dtype=precision.compute_dtype,
               attention_fn=attention_fn(attention), device=device)


def get_model_input_size(name: str) -> int:
    _check_name(name)
    return _INPUT_SIZES[name]


def trainable_mask(model: nn.Module) -> dict:
    """{parameter name: "head" | "backbone"}: a parameter is in the head
    when a component of its name is ``head`` or ``aux_head``."""
    return {name: ("head" if {"head", "aux_head"} & set(name.split("."))
                   else "backbone")
            for name, _ in model.named_parameters()}


def freeze_backbone(model: nn.Module) -> None:
    """``--feature-extract``: only the head trains.  ``requires_grad_``
    off on every backbone parameter leaves it unchanged by the optimizer,
    as ``optax.set_to_zero`` does in the JAX package."""
    for name, label in trainable_mask(model).items():
        if label == "backbone":
            model.get_parameter(name).requires_grad_(False)
