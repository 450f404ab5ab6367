"""The port's model FLOPs (``ops/flops.py``) against the JAX package's
``train_flops_per_sample`` on the same models, and the H100 peak tables.

The JAX count is taken abstractly (``jax.eval_shape`` of the init, then
its jaxpr walk); the port's with ``FlopCounterMode`` on the meta device.
Both count 2 x the multiply-adds of every matmul and convolution, so for
the ``attention="full"`` models they must agree exactly (relative
1e-12), the MoE vit's (``--moe-experts``) too.  The JAX count of the
flash vit stops at the ``pallas_call``'s one-block body and is lower; the
port counts the model, whatever kernel computes its attention.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models.registry import (
    get_model_input_size as jax_input_size)
from distributedpytorch_tpu.ops import flops as jax_flops
from distributedpytorch_tpu_torch.ops import flops

# the JAX counts of the vit at 28 x 28 (batch 8, a sample), pinned: full
# attention, and the flash model whose pallas_call is counted for one
# block of its grid
JAX_VIT_FULL = 247_776_768
JAX_VIT_FLASH = 236_170_752


@functools.lru_cache(maxsize=None)
def jax_train_flops(name: str, attention: str = "full",
                    moe_experts: int = 0) -> float:
    model = jax_get_model(name, 10, half_precision=False,
                          attention=attention, moe_experts=moe_experts)
    size = jax_input_size(name)
    x = jax.ShapeDtypeStruct((2, size, size, 3), jnp.float32)
    v = jax.eval_shape(functools.partial(model.init, train=False),
                       {"params": jax.random.PRNGKey(0)}, x)
    return jax_flops.train_flops_per_sample(
        model, v["params"], v.get("batch_stats", {}), batch=8,
        input_size=size)


@pytest.mark.parametrize("name", ["cnn", "mlp", "resnet", "vit"])
def test_train_flops_equal_jax_full_attention(name):
    got = flops.train_flops_per_sample(name, 10)
    want = jax_train_flops(name)
    assert abs(got - want) <= 1e-12 * want, (name, got, want)


def test_the_flash_vit_counts_the_full_model():
    """The port counts the model's attention-agnostic form: the flash vit
    equals the full one, and both equal JAX's full count; JAX's flash
    count is 4.7% lower (its ``jaxpr_flops`` steps into the
    ``pallas_call`` body, one grid block)."""
    assert flops.train_flops_per_sample("vit", 10) == JAX_VIT_FULL
    assert jax_train_flops("vit", "full") == JAX_VIT_FULL
    assert jax_train_flops("vit", "flash") == JAX_VIT_FLASH
    assert JAX_VIT_FLASH < JAX_VIT_FULL


def test_the_moe_vit_counts_as_jax():
    """The MoE vit at E = 4 (batch 8: one dispatch group of 392 tokens,
    capacity 123): the router, the dispatch and combine one-hot products
    and the experts' batched FFNs count exactly as JAX's jaxpr walk
    counts them, and more than the dense vit's MLPs."""
    got = flops.train_flops_per_sample("vit", 10, moe_experts=4)
    assert got == jax_train_flops("vit", "full", 4)
    assert got > JAX_VIT_FULL


def test_train_flops_is_3x_the_forward_per_sample():
    from distributedpytorch_tpu_torch.models.registry import get_model
    from distributedpytorch_tpu_torch.precision import from_flags

    model = get_model("mlp", 10, from_flags("f32", False), device="meta")
    fwd = flops.forward_flops(model, 8, 28)
    assert fwd == 8 * (2 * 28 * 28 * 3 * 512 + 2 * 512 * 256 + 2 * 256 * 10)
    assert flops.train_flops_per_sample("mlp", 10) == 3 * fwd / 8


H100_SXM = "NVIDIA H100 80GB HBM3"
H100_PCIE = "NVIDIA H100 PCIe"


@pytest.mark.parametrize("kind,peaks,membw", [
    (H100_SXM, {"bf16": 989.4e12, "f16": 989.4e12, "tf32": 494.7e12,
                "f32": 66.9e12}, 3.35e12),
    (H100_PCIE, {"bf16": 756.5e12, "f16": 756.5e12, "tf32": 378e12,
                 "f32": 51.2e12}, 2.0e12),
])
def test_h100_peaks_are_the_datasheets(kind, peaks, membw):
    for label, peak in peaks.items():
        assert flops.peak_flops(kind, label) == peak
    assert flops.peak_flops(kind, torch.bfloat16) == peaks["bf16"]
    assert flops.peak_flops(kind, torch.float16) == peaks["f16"]
    assert flops.peak_flops(kind, torch.float32) == peaks["f32"]
    assert flops.peak_membw(kind) == membw


@pytest.mark.parametrize("kind", [None, "", "cpu", "TPU v4", "Radeon"])
def test_unknown_devices_have_no_peak(kind):
    for label in ("bf16", "f32", "f16", "tf32"):
        assert flops.peak_flops(kind, label) is None
    assert flops.peak_membw(kind) is None
    assert flops.device_kind("cpu") is None


def test_dtype_labels_and_the_tf32_denominator(monkeypatch):
    assert [flops.dtype_label(d) for d in (torch.bfloat16, torch.float16,
                                           torch.float32, "bf16", "tf32")] \
        == ["bf16", "f16", "f32", "bf16", "tf32"]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    # cuDNN's TF32 is on by PyTorch's default: an f32 run divides by the
    # TF32 peak, never inflating its MFU
    assert flops.compute_peak_label(torch.float32) == "tf32"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert flops.compute_peak_label(torch.float32) == "f32"
    assert flops.compute_peak_label(torch.bfloat16) == "bf16"
    assert flops.human_flops(247_776_768) == "247.78 MFLOP"
