"""The port's ViT held against the JAX package's: JAX-initialised params of
a narrow ViT (depth 2, dim 64, heads 2) go through
``models.convert.params_from_jax`` into the port's model, and the logits
must match the flax model's on the same numpy inputs, with full attention
and with flash attention (the JAX side in Pallas interpret mode, the port
on the kernel's plain version).  Tolerances: 1e-4 in f32 (same math,
other summation order), 5e-2 in bf16 (bf16 rounding at the same points,
different accumulation order inside each product)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.vit import ViT
from distributedpytorch_tpu_torch.ops.attention import full_attention
from distributedpytorch_tpu_torch.ops.flash_attention import flash_attention
from distributedpytorch_tpu_torch.precision import PRESETS

NARROW = dict(num_classes=10, dim=64, depth=2, heads=2)


@pytest.fixture(scope="module")
def jax_params():
    x = np.random.default_rng(0).standard_normal((3, 28, 28, 3))
    model = JaxViT(dtype=jnp.float32, **NARROW)
    params = model.init({"params": jax.random.PRNGKey(0)},
                        jnp.asarray(x, jnp.float32))["params"]
    return x.astype(np.float32), params


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("attention", ["full", "flash"])
def test_logits_match_jax(jax_params, attention, dtype, tol):
    x, params = jax_params
    jmodel = JaxViT(dtype=getattr(jnp, dtype),
                    attention_fn=jax_flash if attention == "flash" else None,
                    **NARROW)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = ViT(dtype=getattr(torch, dtype), device="cpu",
                attention_fn=(flash_attention if attention == "flash"
                              else full_attention), **NARROW)
    model.load_state_dict(convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


def test_converter_layouts(jax_params):
    _, params = jax_params
    sd = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    kernel = np.asarray(params["block0"]["qkv"]["kernel"])       # (in, out)
    np.testing.assert_array_equal(sd["blocks.0.qkv.weight"].numpy(),
                                  kernel.T)
    hwio = np.asarray(params["patch_embed"]["kernel"])
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    assert sd["pos_embed"].shape == (1, 49, 64)
    assert sd["norm.weight"].shape == (64,)


def test_converter_refuses_other_layouts(jax_params):
    _, params = jax_params
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree = {k: v for k, v in tree.items() if k != "block1"}
    tree["blocks"] = {"block": {}}
    with pytest.raises(ValueError, match="not ported yet"):
        convert.params_from_jax(tree)


def test_registry_builds_full_width_vit():
    model = registry.get_model("vit", 10, PRESETS["bf16"],
                               attention="flash", device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert len(model.blocks) == 4 and model.pos_embed.shape == (1, 49, 128)
    assert model.blocks[0].heads == 4 and n > 500_000
    assert registry.get_model_input_size("vit") == 28


@pytest.mark.parametrize("name", ["alexnet", "vgg", "densenet", "inception"])
def test_registry_refuses_models_not_ported(name):
    with pytest.raises(ValueError, match=f"not ported yet: --model {name}"):
        registry.get_model(name, 10, PRESETS["f32"], device="cpu")


@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_registry_refuses_ring_attention(attention):
    """Without a mesh whose model axis has 2 ranks or more, the ring is
    refused with the JAX registry's message."""
    from distributedpytorch_tpu.models.registry import _require_model_axis

    with pytest.raises(ValueError) as want:
        _require_model_axis(None, f"--attention {attention} (token axis)")
    with pytest.raises(ValueError) as got:
        registry.get_model("vit", 10, PRESETS["f32"], attention=attention,
                           device="cpu")
    assert str(got.value) == str(want.value)


def test_init_weights_is_seeded():
    a = ViT(device="cpu", **NARROW).init_weights(
        torch.Generator().manual_seed(5))
    b = ViT(device="cpu", **NARROW).init_weights(
        torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.blocks[0].qkv.weight.std().item() > 0.05


def test_eval_forward_rows_are_independent():
    """Padded rows are inert: a row's logits do not depend on its batch."""
    model = ViT(dtype=torch.float32, device="cpu", **NARROW).init_weights(
        torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 28, 28, 3)).astype(np.float32))
    with torch.no_grad():
        full = model(x)
        first = model(x[:1])
    np.testing.assert_allclose(full[:1].numpy(), first.numpy(), atol=1e-5)
