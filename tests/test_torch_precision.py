"""The port's precision presets and dynamic loss scale held against the
JAX package's: the preset table, ``LossScaleState``'s trajectory over a
scripted run of finite and non-finite steps (growth, the floor at 1, the
cap at 2^24), ``all_finite``, the overflow skip of a train step
(parameters, the whole Adam state and BatchNorm's running statistics
bit-unchanged; the step advances; the scale halves), and the SGD learning
rate after a skip (it follows the applied updates, as optax's schedule
counts them).  Inputs come from numpy with a seed; the JAX side runs on
the CPU.  Tolerances are stated where they are used.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models.simple import MLP as JaxMLP
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.precision import LossScaleState as JaxLossScale
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch.models import convert
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.models.simple import MLP
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import (MAX_LOSS_SCALE, PRESETS,
                                                    LossScaleState,
                                                    all_finite)
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

MEAN, STD = 0.13, 0.31
# an overflow injected into a step: the loss numerator times 1e38 is
# finite in f32, and times the loss scale it is not
BLOWUP = 1e38


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _draws(key, b, h, w):
    return [torch.from_numpy(np.array(x)) for x in
            jax_augment._sample_affine_batch(key, b, h, w)]


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, b).astype(np.int32)
    valid = np.ones(b, bool)
    valid[-2:] = False
    return images, labels, valid


def _torch_batch(images, labels, valid):
    return (torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid))


def _blowup(loss_fn):
    def loss(logits, labels):
        numer, denom = loss_fn(logits, labels)
        return numer * BLOWUP, denom
    return loss


@pytest.mark.parametrize("name", ["f32", "bf16", "bf16_full", "f16"])
def test_presets_match_jax(name):
    want, got = JAX_PRESETS[name], PRESETS[name]
    assert got.describe() == want.describe()
    assert (got.scales_loss, got.loss_scale_growth) == (
        want.scales_loss, want.loss_scale_growth)


# finite and non-finite steps: growth at the interval, a halving that
# restarts the count, a run of overflows down to the floor, and a long
# clean run up to the cap
SCRIPT = ([True] * 5 + [False] + [True] * 3 + [False] * 24 + [True] * 60)


@pytest.mark.parametrize("initial,interval",
                         [(2.0 ** 15, 3), (4.0, 2), (2.0 ** 22, 1),
                          (2.0 ** 15, 2000)])
def test_loss_scale_trajectory_matches_jax_exactly(initial, interval):
    want = JaxLossScale.create(initial)
    got = LossScaleState.create(initial)
    seen = set()
    for finite in SCRIPT:
        want = want.adjust(jnp.asarray(finite), interval)
        got = got.adjust(finite, interval)
        assert (got.scale, got.good_steps) == (float(want.scale),
                                               int(want.good_steps))
        seen.add(got.scale)
    if initial <= 2.0 ** 15:
        assert min(seen) == 1.0                  # the floor
    if interval == 1:
        assert max(seen) == MAX_LOSS_SCALE == 2.0 ** 24   # the cap


def test_loss_scale_round_trips_as_a_dict():
    state = LossScaleState(scale=512.0, good_steps=17)
    assert LossScaleState.from_dict(state.to_dict()) == state


def test_all_finite():
    good = [torch.ones(3), None, torch.zeros((2, 2), dtype=torch.float16)]
    assert bool(all_finite(good)) and bool(all_finite([]))
    for bad in (float("inf"), float("-inf"), float("nan")):
        assert not bool(all_finite(good + [torch.tensor([1.0, bad])]))


def _resnet_state(seed=3):
    model = ResNet((1, 1), width=8, dtype=torch.float16)
    model.init_weights(torch.Generator().manual_seed(seed))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 32,
                    PRESETS["f16"], "cpu", optimizer="adam")
    return engine, engine.init_state(torch.Generator().manual_seed(seed))


def test_overflow_skips_the_update_bit_for_bit():
    """A finite f16 step of a BatchNorm resnet with Adam, then one whose
    loss overflows at the scale: parameters, the whole Adam state (its
    step count included) and the running statistics are bit-identical to
    those before the overflowing step; the step count advances, the
    applied-update count does not, the scale halves and its good-step
    count restarts."""
    engine, state = _resnet_state()
    key = jax.random.PRNGKey(5)
    batch = _torch_batch(*_batch(1))
    engine.train_step_affine(state, *batch, _draws(key, 8, 28, 28))
    assert (state.step, state.updates) == (1, 1)
    assert state.loss_scale.good_steps == 1
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = copy.deepcopy(state.optimizer.state_dict())
    assert opt["state"]               # Adam's moments and step exist
    scale = float(state.loss_scale.scale)   # the tensor moves in place
    engine.loss_fn = _blowup(engine.loss_fn)
    engine.train_step_affine(state, *batch, _draws(key, 8, 28, 28))
    assert not bool(all_finite(p.grad for p in state.model.parameters()))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params[k]), k      # params and BN buffers
    after = state.optimizer.state_dict()
    for i, st in opt["state"].items():
        for name, t in st.items():
            assert torch.equal(after["state"][i][name], t), (i, name)
    assert (state.step, state.updates) == (2, 1)
    assert state.loss_scale == LossScaleState(scale / 2, 0)


def _mlp_pair(blowup: bool, policy_jax, steps_per_epoch=2):
    jmodel = JaxMLP(dtype=policy_jax.compute_dtype)
    loss = jax_losses.cross_entropy
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, steps_per_epoch, False)
    return JaxEngine(jmodel, "mlp", _blowup(loss) if blowup else loss, tx,
                     MEAN, STD, 28, precision=policy_jax)


def test_sgd_learning_rate_after_a_skip_follows_jax():
    """Four SGD steps, 2 an epoch, the second one overflowing, under an f32
    policy that scales the loss by 2^15 (f32 keeps the comparison to the
    schedule: the same f32 math in another summation order, 1e-5 relative
    to each tensor's largest value).  optax's schedule counts the applied
    updates, so the third step still runs at epoch 0's rate on both
    sides; a rate read from the step count (2) would have decayed it."""
    jpolicy = dataclasses.replace(JAX_PRESETS["f32"], name="f32_scaled",
                                  loss_scale=2.0 ** 15)
    policy = dataclasses.replace(PRESETS["f32"], name="f32_scaled",
                                 loss_scale=2.0 ** 15)
    jsteps = {b: jax.jit(_mlp_pair(b, jpolicy)._train_step_keys)
              for b in (False, True)}
    jstate = _mlp_pair(False, jpolicy).init_state(jax.random.PRNGKey(2))
    model = MLP(dtype=torch.float32)
    model.load_state_dict(convert.cnn_params_from_jax(_np(jstate.params),
                                                      None))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, policy,
                    "cpu", optimizer="SGD", steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model),
                       loss_scale=engine.fresh_loss_scale())
    plain = engine.loss_fn
    for i in range(4):
        images, labels, valid = _batch(20 + i)
        key = jax.random.PRNGKey(30 + i)
        jstate, _ = jsteps[i == 1](jstate, jnp.asarray(images),
                                   jnp.asarray(labels), jnp.asarray(valid),
                                   key, key)
        engine.loss_fn = _blowup(plain) if i == 1 else plain
        engine.train_step_affine(state, *_torch_batch(images, labels, valid),
                                 _draws(key, 8, 28, 28))
    assert (state.step, state.updates) == (int(jstate.step), 3) == (4, 3)
    assert state.loss_scale.scale == float(jstate.loss_scale.scale) \
        == 2.0 ** 14
    want = convert.cnn_params_from_jax(_np(jstate.params), None)
    for k, v in state.model.state_dict().items():
        err = (v - want[k]).abs().max().item() / max(
            want[k].abs().max().item(), 1e-12)
        assert err <= 1e-5, (k, err)
