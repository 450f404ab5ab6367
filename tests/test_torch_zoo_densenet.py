"""The port's densenet121 held against the JAX package's flax module at
the registry's widths, 64 px and batch 2, on one flax init
(tests/_torch_zoo_jax.py): train-mode logits, every gradient, the
BatchNorm running statistics after the step, and the eval-mode logits
with them.

In f64 on both sides (JAX's x64 mode, f32 parameters) the two steps are
the same to 1e-6 of each tensor's largest value: the same function.  In
f32 and bf16 the step's gradients are dominated by rounding at this
size, in the reference as much as in the port (ROADMAP queue 3 entry 8):
JAX's own f32 gradients lie up to 19% from its f64 ones, in the
stem's BatchNorm scale, so 1e-4 between the two frameworks is out of
reach.  There the logits are held to JAX's at f32 1e-4 and bf16 5e-2 or,
failing that, to the f64 step no further than twice JAX's distance from
it, and the gradients and statistics no further from the f64 step than
twice JAX's distance, at the median and at the largest error
(``_torch_zoo_jax.check_against_flax``).
"""

import numpy as np
import pytest
import torch

from tests import _torch_zoo_jax as Z


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_grads_and_bn_stats_match_flax(dtype):
    Z.check_against_flax("densenet", dtype, conditioned=True)


def test_f64_step_equals_flax_in_x64():
    Z.check_against_flax("densenet", "float64")


def test_jax_f32_gradients_are_rounding_dominated_at_batch_2():
    """Why the f32 check above is against the f64 step: JAX's f32
    gradients are further than 1e-4 from its own f64 ones, and the
    port's f32 gradients are closer to the f64 step than JAX's at the
    median."""
    truth = Z.reference("densenet", "float64")["grads"]
    ref = Z.reference("densenet", "float32")["grads"]
    model, *_ = Z.port_step("densenet", "float32")
    grads = {n: p.grad for n, p in model.named_parameters()}
    jax_err = Z.errors("densenet", {n: ref[n] for n in grads}, truth)
    port_err = Z.errors("densenet", grads, truth)
    assert max(jax_err.values()) > 1e-2
    assert np.median(list(port_err.values())) \
        < np.median(list(jax_err.values()))
