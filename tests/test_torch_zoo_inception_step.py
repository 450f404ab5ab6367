"""One train step of the port's inception_v3 with its aux loss against the
JAX ``Engine._train_step_keys``: the same init, uint8 batch, affine draws
and dropout mask, at 299 px and batch 2 (plus a masked row), in f64
compute on both sides (JAX's x64 mode, f32 parameters), since the f32
step at this size is dominated by rounding (ROADMAP queue 3 entry 8).

The loss, the correct rows, the BatchNorm running statistics after the
step and the two classifiers (``head`` and ``AuxHead_0.aux_head``, whose
gradients carry the 0.4 weight and the global denominator directly) are
held to TOL_STEP = 1e-5 of each tensor's largest value (1.9e-6 seen).
The backbone's gradients are not: both frameworks compute the loss's
gradient in f32 (the models return f32 logits), and inception's backward
at 3 rows amplifies that last-bit difference about 1e5-fold, as it
amplifies f32 rounding (ROADMAP queue 3 entry 8).  So the backbone's
parameters after the update (an SGD step of 1e-3) are held to
TOL_BACKBONE = 5e-2 of each tensor's largest value (3.4e-2 seen, in a
BatchNorm bias that starts at 0).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import (
    PrecisionPolicy as JaxPrecisionPolicy)
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

from tests import _torch_zoo_jax as Z

MEAN, STD = 0.13, 0.31
TOL_STEP = 1e-5
TOL_BACKBONE = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_one_engine_step_with_the_aux_loss_equals_jax():
    """One SGD step (momentum 0.9) of ``Engine.train_step_affine`` against
    the JAX ``Engine._train_step_keys`` on the same init, uint8 batch
    (its last row masked), affine draws and dropout mask, in f64 compute
    on both sides (JAX's x64 mode, f32 parameters): the loss is
    loss(logits) + 0.4 * loss(aux) over the one global denominator, the
    correct rows come from the primary logits, and the statistics and
    both classifiers after the update are JAX's (the tolerances are the
    module docstring's)."""
    b = 2
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (b + 1, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, b + 1).astype(np.int32)
    valid = np.ones(b + 1, bool)
    valid[-1] = False
    with jax.enable_x64(True):
        policy = JaxPrecisionPolicy(
            name="f64", param_dtype=jnp.float32, compute_dtype=jnp.float64,
            accum_dtype=jnp.float64, output_dtype=jnp.float32)
        jmodel = jax_get_model("inception", 10, precision=policy)
        tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
        jengine = JaxEngine(jmodel, "inception", jax_losses.cross_entropy,
                            tx, MEAN, STD, 299, precision=policy)
        jstate = jengine.init_state(jax.random.PRNGKey(3))
        init = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                   jstate.batch_stats))
        aug_key, dropout_key = jax.random.split(jax.random.PRNGKey(11))
        affine = [torch.from_numpy(np.array(t)) for t in
                  jax_augment._sample_affine_batch(aug_key, b + 1, 28, 28)]
        masks = []
        with fnn.intercept_methods(Z.capture_dropout(masks)):
            jmodel.apply({"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
                         jnp.zeros((b + 1, 299, 299, 3), jnp.float64),
                         train=True, rngs={"dropout": dropout_key},
                         mutable=["batch_stats"])
        jstate, jm = jax.jit(jengine._train_step_keys)(
            jstate, jnp.asarray(images), jnp.asarray(labels),
            jnp.asarray(valid), aug_key, dropout_key)
        want = convert.cnn_params_from_jax(
            *jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                 jstate.batch_stats)))
        jm = jax.tree_util.tree_map(float, jm)

    model = registry.get_model("inception", 10, Z.F64, device="cpu")
    model.load_state_dict(convert.cnn_params_from_jax(*init))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 299, Z.F64,
                    "cpu", optimizer="SGD", steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model))
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), affine,
        [torch.from_numpy(np.array(mk)) for mk in masks])
    assert [tuple(mk.shape) for mk in masks] == [(b + 1, 2048)]
    assert abs(m["loss"].item() - jm["loss"]) <= TOL_STEP * abs(jm["loss"])
    assert m["correct"].item() == jm["correct"]
    assert m["valid"].item() == jm["valid"] == b
    got = model.state_dict()
    assert set(got) == set(want)
    for key, w in want.items():
        tight = "running_" in key or key.startswith(
            ("head.", "AuxHead_0.aux_head."))
        assert Z.rel(got[key], w) <= (TOL_STEP if tight else TOL_BACKBONE), \
            key
