"""The port's inception_v3 held against the JAX package's flax module at
the registry's widths, 299 px and batch 2, on one flax init
(tests/_torch_zoo_jax.py): train-mode logits and aux logits with JAX's
dropout mask, every gradient (the aux head's included), the BatchNorm
running statistics after the step, and the eval-mode logits; the aux
head's refusal of small maps.  tests/test_torch_zoo_inception_step.py
holds one engine step with the aux loss.

As for densenet (tests/test_torch_zoo_densenet.py), f64 on both sides
(JAX's x64 mode, f32 parameters) is the exact check, 1e-6 of each
tensor's largest value.  In f32 and bf16 the step at batch 2 is
dominated by rounding in both frameworks (ROADMAP queue 3 entry 8): the
aux head's BatchNorm normalises 2 values a channel (its map is 1x1), and
JAX's own f32 gradients lie 3% from its f64 ones at the median.  There
the logits are held to JAX's at f32 1e-4 and bf16 5e-2 or, failing that,
to the f64 step no further than twice JAX's distance from it, and the
gradients and statistics no further from the f64 step than twice JAX's
distance, at the median and at the largest error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu_torch.models import registry
from distributedpytorch_tpu_torch.precision import PRESETS

from tests import _torch_zoo_jax as Z


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_aux_grads_and_bn_stats_match_flax(dtype):
    found = Z.check_against_flax("inception", dtype, conditioned=True)
    assert "aux" in found and any(k.startswith("AuxHead_0.aux_head.")
                                  for k in found)


def test_f64_step_equals_flax_in_x64():
    found = Z.check_against_flax("inception", "float64")
    assert found["aux"] <= 1e-6


def test_jax_f32_gradients_are_rounding_dominated_at_batch_2():
    """Why the f32 check above is against the f64 step: JAX's f32
    gradients are further than 1e-4 from its own f64 ones at the median,
    and the port's are no further."""
    truth = Z.reference("inception", "float64")["grads"]
    ref = Z.reference("inception", "float32")["grads"]
    model, *_ = Z.port_step("inception", "float32")
    grads = {n: p.grad for n, p in model.named_parameters()}
    jax_err = np.median(list(Z.errors(
        "inception", {n: ref[n] for n in grads}, truth).values()))
    port_err = np.median(list(Z.errors("inception", grads, truth).values()))
    assert jax_err > 1e-3 and port_err <= jax_err


def test_aux_head_refuses_a_small_map_with_the_jax_message():
    """Below 299 px the aux head's map is under 17x17: train mode fails
    with the JAX model's message, word for word (JAX raises at trace
    time)."""
    jmodel = jax_get_model("inception", 10, half_precision=False)
    x = jax.ShapeDtypeStruct((1, 139, 139, 3), jnp.float32)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda x: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, train=True), x)
    model = registry.get_model("inception", 10, PRESETS["f32"],
                               device="cpu")
    model.train()
    with pytest.raises(ValueError) as got:
        model(torch.zeros((1, 139, 139, 3)))
    assert str(got.value) == str(want.value)
    assert "needs a >=17x17 feature map" in str(got.value)
