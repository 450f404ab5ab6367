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
the JAX package), ``moe_experts`` (``--moe-experts``: the vit's MLPs
as switch mixtures of experts, ``models/moe.py``, expert parallel over
the model group of ``mesh`` when it has 2 ranks or more; its data group
holds the global batch the dispatch groups are cut from) and
``tensor_parallel`` (``--tensor-parallel``: the vit's Megatron tensor
parallelism over the model group, ``models/vit.py``, with ``--attention
full`` only).  The validation errors are the JAX registry's, word for
word.  ``remat="blocks"`` builds vit, densenet and inception with
``remat_blocks`` (each block checkpointed, ``models/remat.py``; the
parameter names do not change); the engine checkpoints the other models'
whole forward, and every model's under ``full``, as the JAX split of the
work goes.  ``pipeline_parallel`` (``--pipeline-parallel``, with
``pipeline_microbatches``) builds the GPipe vit over the model group of
``mesh`` (``models/vit_pipeline.py``), with ``attention`` ``full`` or
``ring`` (the ring over the mesh's seq group).  ``scan_layers``
(``--scan-layers``) stacks the homogeneous block runs of vit, vgg,
densenet and inception (SCAN_LAYER_MODELS; ``models/scan.py``), with any
attention, ``tensor_parallel``, ``remat`` and placement, and is refused
with the JAX registry's messages on another model, with
``pipeline_parallel`` and with ``moe_experts``, in the JAX order.
"""

from __future__ import annotations

import torch
from torch import nn

from ..precision import PrecisionPolicy
from .alexnet import AlexNet
from .densenet import densenet121
from .inception import InceptionV3
from .remat import REMAT_BLOCK_MODELS
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
# module; those of SCAN_LAYER_MODELS take ``scan_layers`` too.
_CNN_ZOO = {
    "cnn": lambda n, d, dev: SmallCNN(num_classes=n, dtype=d, device=dev),
    "mlp": lambda n, d, dev: MLP(num_classes=n, dtype=d, device=dev),
    "resnet": lambda n, d, dev: resnet18(n, dtype=d, device=dev),
    "alexnet": lambda n, d, dev: AlexNet(num_classes=n, dtype=d,
                                         device=dev),
    "vgg": lambda n, d, dev, scan=False: VGG11BN(
        num_classes=n, dtype=d, scan_layers=scan, device=dev),
    "squeezenet": lambda n, d, dev: SqueezeNet(num_classes=n, dtype=d,
                                               device=dev),
    "densenet": lambda n, d, dev, scan=False: densenet121(
        n, dtype=d, scan_layers=scan, device=dev),
    "inception": lambda n, d, dev, scan=False: InceptionV3(
        num_classes=n, dtype=d, scan_layers=scan, device=dev),
}

# Models with a homogeneous block run that --scan-layers stacks (JAX
# registry.py:59).
SCAN_LAYER_MODELS = frozenset({"vit", "vgg", "densenet", "inception"})

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


def _check_attention_name(attention: str) -> None:
    if attention not in ("full", "ring", "flash", "ring_flash"):
        raise ValueError(f"attention must be 'full', 'ring', 'flash' or "
                         f"'ring_flash', got {attention!r}")


def check_attention(name: str, attention: str) -> None:
    """The JAX registry's refusal of ``--attention`` other than ``full``
    on a model without attention (``registry.py:200-206``)."""
    _check_attention_name(attention)
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
              pallas_dw: bool = False, mesh=None,
              remat: str = "none", moe_experts: int = 0,
              tensor_parallel: bool = False,
              pipeline_parallel: bool = False,
              pipeline_microbatches: int = 0,
              scan_layers: bool = False) -> nn.Module:
    """The registry's full-width model, on ``device``, its parameters
    stored in the policy's ``param_dtype`` (bfloat16 under ``bf16_full``,
    f32 otherwise; BatchNorm's running statistics are buffers and stay
    f32, flax's ``accum_dtype`` guard; zeros until restored or
    ``init_weights``, which rounds flax's f32 draws to it).
    ``pallas_dw=True`` gives the cnn whose 3x3 convs with 32+ input
    channels take their weight gradient from kernel K5.  ``mesh`` (a
    ``runtime.Mesh``) is the one of ``--attention ring|ring_flash``, of
    ``tensor_parallel`` and of a MoE vit's global batch and experts; the
    parameters are whole until ``parallel.place`` splits them (the
    engine's ``init_state``).  ``remat="blocks"`` on a
    model of REMAT_BLOCK_MODELS checkpoints its blocks.  ``scan_layers``
    stacks the block runs of a model of SCAN_LAYER_MODELS."""
    # the JAX get_model's order of checks (registry.py:96-133)
    _check_name(name)
    _check_attention_name(attention)
    if remat not in ("none", "blocks", "full"):
        raise ValueError(f"remat must be none|blocks|full, got {remat!r}")
    if scan_layers:
        check_scan_layers(name, pipeline_parallel, moe_experts)
    if pipeline_parallel and remat != "none":
        raise ValueError(
            "--remat composes with the plain vit, not --pipeline-parallel "
            "(the pipelined vit hand-rolls its stage loop and manages "
            "per-stage memory itself)")
    model = _build(name, num_classes, precision, attention, device,
                   pallas_dw, mesh, moe_experts, tensor_parallel,
                   pipeline_parallel, pipeline_microbatches, scan_layers)
    if name in REMAT_BLOCK_MODELS:
        model.remat_blocks = remat == "blocks"
    return store_params(model, precision.param_dtype)


def store_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every parameter of ``model`` stored in ``dtype``, in place; the
    buffers (BatchNorm's running statistics) keep theirs, so this is not
    ``model.to(dtype)``."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype != dtype:
                p.data = p.data.to(dtype)
    return model


def check_scan_layers(name: str, pipeline_parallel: bool = False,
                      moe_experts: int = 0) -> None:
    """The JAX registry's refusals of ``--scan-layers``
    (``registry.py:113-128``), in its order."""
    if name not in SCAN_LAYER_MODELS:
        raise ValueError(
            f"--scan-layers applies to the repeated-block models "
            f"only ({sorted(SCAN_LAYER_MODELS)}); {name!r} has no "
            "homogeneous block run to stack")
    if pipeline_parallel:
        raise ValueError(
            "--scan-layers is exclusive with --pipeline-parallel "
            "(the pipelined vit already stacks its blocks and "
            "hand-rolls the schedule)")
    if moe_experts:
        raise ValueError(
            "--scan-layers is exclusive with --moe-experts (expert "
            "dispatch does not stack under lax.scan, and MoE "
            "checkpoints have no scan layout conversion)")


def check_moe(name: str, moe_experts: int, tensor_parallel: bool = False,
              pipeline_parallel: bool = False) -> None:
    """The JAX registry's refusals of ``--moe-experts``
    (``registry.py:156-172``)."""
    if not moe_experts:
        return
    if name != "vit":
        raise ValueError(
            "--moe-experts applies to the attention model family "
            f"only (--model vit); {name!r} has no MLP blocks to "
            "replace")
    if moe_experts < 2:
        raise ValueError(f"--moe-experts must be >= 2, got {moe_experts}")
    if tensor_parallel or pipeline_parallel:
        raise ValueError(
            "--moe-experts is exclusive with --tensor-parallel "
            "(both shard the MLP over 'model') and "
            "--pipeline-parallel (the pipelined vit hand-rolls "
            "dense blocks); it composes with --attention "
            "full/ring/flash")


def check_tensor_parallel(name: str, attention: str, mesh) -> None:
    """The JAX registry's refusals of ``--tensor-parallel``
    (``registry.py:200-212``, ``_require_model_axis`` at :69-76)."""
    if name != "vit":
        raise ValueError(
            "--tensor-parallel applies to the attention model family "
            f"only (--model vit); {name!r} has no attention")
    if attention != "full":
        raise ValueError(
            "--tensor-parallel composes only with --attention full "
            "(ring shards the same 'model' axis; the flash Pallas "
            "kernel is not GSPMD-partitionable over heads) — pick one")
    require_model_axis(mesh, "--tensor-parallel (head/hidden axes)")


def check_moe_model_axis(moe_experts: int, mesh) -> None:
    """JAX's expert-parallel divisibility (``registry.py:247-259``): with a
    model axis of 2 ranks or more, each rank holds E/M experts."""
    if moe_experts and mesh is not None and mesh.model_parallel >= 2 \
            and moe_experts % mesh.model_parallel:
        raise ValueError(
            f"--moe-experts {moe_experts} must be divisible "
            f"by --model-parallel {mesh.model_parallel} for expert "
            "parallelism (each device holds E/mp experts)")


def check_pipeline(name: str, attention: str, tensor_parallel: bool,
                   mesh, pipeline_microbatches: int) -> None:
    """The JAX registry's refusals of ``--pipeline-parallel``
    (``registry.py:173-191``)."""
    if name != "vit":
        raise ValueError(
            "--pipeline-parallel applies to the attention model "
            f"family only (--model vit); {name!r} has no stages")
    if attention not in ("full", "ring") or tensor_parallel:
        raise ValueError(
            "--pipeline-parallel is exclusive with --attention "
            "flash/ring_flash and --tensor-parallel (the pipelined "
            "vit hand-rolls its blocks); it composes with "
            "--attention ring on a 3-D mesh (--seq-parallel >= 2)")
    require_model_axis(mesh, "--pipeline-parallel (stage axis)")
    if pipeline_microbatches < 0:
        raise ValueError("--pipeline-microbatches must be >= 0, got "
                         f"{pipeline_microbatches}")


def _build(name: str, num_classes: int, precision: PrecisionPolicy,
           attention: str, device, pallas_dw: bool, mesh,
           moe_experts: int = 0, tensor_parallel: bool = False,
           pipeline_parallel: bool = False, pipeline_microbatches: int = 0,
           scan_layers: bool = False) -> nn.Module:
    """The module of ``get_model``, its parameters in f32."""
    dtype = precision.compute_dtype
    if pallas_dw:
        if name != "cnn":
            raise ValueError(
                "pallas_dw applies to the cnn model only (the "
                "patch-reuse conv-dW kernel covers its 3x3/SAME convs)")
        if moe_experts or attention != "full" or tensor_parallel \
                or pipeline_parallel:
            raise ValueError(
                "pallas_dw is exclusive with the vit-family features; got "
                f"moe_experts={moe_experts}, attention={attention!r}, "
                f"tensor_parallel={tensor_parallel}, "
                f"pipeline_parallel={pipeline_parallel}")
    check_moe(name, moe_experts, tensor_parallel, pipeline_parallel)
    if pipeline_parallel:
        from .vit_pipeline import PipelinedViT

        check_pipeline(name, attention, tensor_parallel, mesh,
                       pipeline_microbatches)
        return PipelinedViT(num_classes=num_classes, dtype=dtype, mesh=mesh,
                            n_micro=pipeline_microbatches,
                            ring=attention == "ring", device=device)
    check_attention(name, attention)
    if tensor_parallel:
        check_tensor_parallel(name, attention, mesh)
    if name == "vit":
        from .vit import ViT

        attn = attention_fn(attention, mesh)
        check_moe_model_axis(moe_experts, mesh)
        return ViT(num_classes=num_classes, dtype=dtype, attention_fn=attn,
                   moe_experts=moe_experts, moe_mesh=mesh,
                   tp_mesh=mesh if tensor_parallel else None,
                   scan_layers=scan_layers, device=device)
    if pallas_dw:
        return SmallCNN(num_classes=num_classes, dtype=dtype,
                        pallas_dw=True, device=device)
    if scan_layers:
        return _CNN_ZOO[name](num_classes, dtype, device, True)
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
