"""Model registry: name -> module / input size, and the head/backbone
split of ``--feature-extract``.

Counterpart of ``distributedpytorch_tpu/models/registry.py`` (``get_model``
at :79-266, ``get_model_input_size`` and ``trainable_mask`` at :269-299),
for ``cnn``, ``mlp``, ``resnet`` (resnet18) and ``vit`` with ``attention``
in {full, flash, ring, ring_flash} (the rings over the model group of a
``runtime.Mesh``), and the API-only ``pallas_dw`` knob of ``cnn`` (kernel
K5; no CLI flag, as in the JAX package).  The validation errors are the
JAX registry's, word for word; every other model or feature raises "not
ported yet".
"""

from __future__ import annotations

import torch
from torch import nn

from ..precision import PrecisionPolicy

KNOWN_MODELS = ("cnn", "mlp", "resnet", "alexnet", "vgg", "squeezenet",
                "densenet", "inception", "vit")
# ref getModelInputSize (utils.py:24-36); cnn/mlp/vit run at the native 28
_INPUT_SIZES = {"cnn": 28, "mlp": 28, "resnet": 224, "vit": 28}


def _check_name(name: str) -> None:
    if name not in KNOWN_MODELS:
        raise ValueError(f"Invalid model name {name!r} "
                         f"(choices: {sorted(KNOWN_MODELS)})")
    if name not in _INPUT_SIZES:
        raise ValueError(f"not ported yet: --model {name}")


def check_attention(name: str, attention: str) -> None:
    """The JAX registry's refusal of ``--attention`` other than ``full``
    on a model without attention (``registry.py:200-206``)."""
    if attention not in ("full", "ring", "flash", "ring_flash"):
        raise ValueError(f"attention must be 'full', 'ring', 'flash' or "
                         f"'ring_flash', got {attention!r}")
    if attention != "full" and name != "vit":
        raise ValueError(
            f"--attention {attention} applies to the attention model "
            f"family only (--model vit); {name!r} has no attention")


def require_model_axis(mesh, what: str) -> None:
    """The JAX registry's ``_require_model_axis`` (``registry.py:69-76``):
    ``what`` needs a mesh whose model axis has 2 ranks or more."""
    if mesh is None or mesh.model_parallel < 2:
        raise ValueError(
            f"{what} uses the mesh's 'model' axis: pass "
            "--model-parallel >= 2 (and a mesh)")


def attention_fn(attention: str, mesh=None):
    """``--attention`` -> the (B, S, H, D) attention function; the rings
    run over ``mesh``'s model group."""
    if attention == "full":
        from ..ops.attention import full_attention

        return full_attention
    if attention == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention
    if attention in ("ring", "ring_flash"):
        from ..ops.attention import make_ring_attention

        require_model_axis(mesh, f"--attention {attention} (token axis)")
        return make_ring_attention(mesh,
                                   use_flash=attention == "ring_flash")
    raise ValueError(f"attention must be 'full', 'ring', 'flash' or "
                     f"'ring_flash', got {attention!r}")


def get_model(name: str, num_classes: int, precision: PrecisionPolicy,
              attention: str = "full",
              device: torch.device | str = "cuda",
              pallas_dw: bool = False, mesh=None) -> nn.Module:
    """The registry's full-width model, on ``device``, with f32 weights
    (zeros until restored or ``init_weights``).  ``pallas_dw=True`` gives
    the cnn whose 3x3 convs with 32+ input channels take their weight
    gradient from kernel K5.  ``mesh`` (a ``runtime.Mesh``) is the one of
    ``--attention ring|ring_flash``; the parameters stay replicated on
    every rank."""
    _check_name(name)
    dtype = precision.compute_dtype
    if pallas_dw:
        if name != "cnn":
            raise ValueError(
                "pallas_dw applies to the cnn model only (the "
                "patch-reuse conv-dW kernel covers its 3x3/SAME convs)")
        if attention != "full":
            raise ValueError(
                "pallas_dw is exclusive with the vit-family features; got "
                f"moe_experts=0, attention={attention!r}, "
                "tensor_parallel=False, pipeline_parallel=False")
    check_attention(name, attention)
    if name == "vit":
        from .vit import ViT

        return ViT(num_classes=num_classes, dtype=dtype,
                   attention_fn=attention_fn(attention, mesh),
                   device=device)
    if name == "cnn":
        from .simple import SmallCNN

        return SmallCNN(num_classes=num_classes, dtype=dtype,
                        pallas_dw=pallas_dw, device=device)
    if name == "mlp":
        from .simple import MLP

        return MLP(num_classes=num_classes, dtype=dtype, device=device)
    from .resnet import resnet18

    return resnet18(num_classes, dtype=dtype, device=device)


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
