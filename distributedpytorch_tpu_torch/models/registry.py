"""Model registry: name -> module / input size, and the head/backbone
split of ``--feature-extract``.

Counterpart of ``distributedpytorch_tpu/models/registry.py`` (``get_model``
at :79-266, ``get_model_input_size`` and ``trainable_mask`` at :269-299),
for the nine models: ``cnn``, ``mlp``, the torchvision zoo (``resnet``
(resnet18), ``alexnet``, ``vgg`` (vgg11_bn), ``squeezenet``
(squeezenet1_0), ``densenet`` (densenet121), ``inception``
(inception_v3)) and ``vit`` with ``attention`` in {full, flash, ring,
ring_flash} (the rings over the model group of a ``runtime.Mesh``), and
the API-only ``pallas_dw`` knob of ``cnn`` (kernel K5; no CLI flag, as in
the JAX package).  The validation errors are the JAX registry's, word for
word.  ``--remat`` and ``--scan-layers`` are not ported yet (the CLI
refuses them).
"""

from __future__ import annotations

import torch
from torch import nn

from ..precision import PrecisionPolicy
from .alexnet import AlexNet
from .densenet import densenet121
from .inception import InceptionV3
from .resnet import resnet18
from .simple import MLP, SmallCNN
from .squeezenet import SqueezeNet
from .vgg import VGG11BN

# name -> input resolution (ref getModelInputSize, utils.py:24-36: 224 for
# all but inception=299; cnn/mlp/vit run at the dataset-native 28)
_INPUT_SIZES = {
    "cnn": 28, "mlp": 28, "resnet": 224, "alexnet": 224, "vgg": 224,
    "squeezenet": 224, "densenet": 224, "inception": 299, "vit": 28,
}
KNOWN_MODELS = tuple(_INPUT_SIZES)

# The models without attention: name -> (num_classes, dtype, device) ->
# module.
_CNN_ZOO = {
    "cnn": lambda n, d, dev: SmallCNN(num_classes=n, dtype=d, device=dev),
    "mlp": lambda n, d, dev: MLP(num_classes=n, dtype=d, device=dev),
    "resnet": lambda n, d, dev: resnet18(n, dtype=d, device=dev),
    "alexnet": lambda n, d, dev: AlexNet(num_classes=n, dtype=d,
                                         device=dev),
    "vgg": lambda n, d, dev: VGG11BN(num_classes=n, dtype=d, device=dev),
    "squeezenet": lambda n, d, dev: SqueezeNet(num_classes=n, dtype=d,
                                               device=dev),
    "densenet": lambda n, d, dev: densenet121(n, dtype=d, device=dev),
    "inception": lambda n, d, dev: InceptionV3(num_classes=n, dtype=d,
                                               device=dev),
}

# Models whose train-mode forward also returns auxiliary logits
# (ref classif.py:49-53 special-cases 'inception').
AUX_LOGIT_MODELS = frozenset({"inception"})

# Models using dropout: their train-mode forward needs the step's keep
# masks (``models.layers.Dropout``; the engine draws them).
DROPOUT_MODELS = frozenset({"alexnet", "vgg", "squeezenet", "inception"})


def _check_name(name: str) -> None:
    if name not in KNOWN_MODELS:
        raise ValueError(f"Invalid model name {name!r} "
                         f"(choices: {sorted(KNOWN_MODELS)})")


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
    if pallas_dw:
        return SmallCNN(num_classes=num_classes, dtype=dtype,
                        pallas_dw=True, device=device)
    return _CNN_ZOO[name](num_classes, dtype, device)


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
