"""``--precision bf16_full`` in the port held against the JAX package:
three SGD steps of the mlp and of a reduced BatchNorm resnet from the same
bfloat16 parameters, batches and affine draws.  The parameters (and the
SGD momentum) are stored in bfloat16 on both sides, BatchNorm's running
statistics in f32; a checkpoint keeps the dtypes.  The JAX side runs on
the CPU.

Tolerances, relative to each tensor's largest value: parameters 1.6e-2,
two units in the last place of a bfloat16 near the largest value (an
update of 1e-3 x the gradient is mostly below a bfloat16 parameter's
resolution, and where it is near half a unit the two frameworks' sums,
in another order, may round it to either neighbour); running statistics
1e-3 (f32 sums of bfloat16 activations that round alike).  A BatchNorm
bias starts at 0 and its gradient is a sum over 6 x H x W bfloat16 terms
of both signs that cancel to a few percent of their magnitude, so a
last-bit difference in the terms moves it by tens of percent (on the CPU:
6-28% between the two frameworks, and the JAX bfloat16 trajectory lies
3-15% from the JAX f32 one); those hold sign and scale only, at 5e-1,
and the weights, the mlp's and the head's biases and the statistics
carry the check.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models.resnet import ResNet as JaxResNet
from distributedpytorch_tpu.models.simple import MLP as JaxMLP
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

MEAN, STD = 0.13, 0.31
TOL_PARAMS = 1.6e-2
TOL_STATS = 1e-3
TOL_BN_BIAS = 5e-1
BN_BIAS = re.compile(r"(.*\.)?BatchNorm_\d+\.bias")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16
        else np.asarray(x), tree)


def _models(name, jax_dtype=jnp.bfloat16):
    if name == "mlp":
        return (JaxMLP(dtype=jax_dtype), 28,
                registry.get_model("mlp", 10, PRESETS["bf16_full"],
                                   device="cpu"))
    model = registry.store_params(
        ResNet((1, 1), width=8, dtype=torch.bfloat16), torch.bfloat16)
    return (JaxResNet(stage_sizes=(1, 1), width=8, dtype=jax_dtype), 32,
            model)


@pytest.fixture(scope="module", params=["mlp", "resnet_small"])
def trajectory(request):
    name = request.param
    jmodel, size, model = _models(name)
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    jengine = JaxEngine(jmodel, name, jax_losses.cross_entropy, tx, MEAN,
                        STD, size, precision=JAX_PRESETS["bf16_full"])
    jstate = jengine.init_state(jax.random.PRNGKey(1))
    model.load_state_dict(convert.cnn_params_from_jax(
        _np(jstate.params), _np(jstate.batch_stats) or None))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size,
                    PRESETS["bf16_full"], "cpu", optimizer="SGD",
                    steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model))
    step = jax.jit(jengine._train_step_keys)
    out = []
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        images = rng.integers(0, 256, (8, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, 8).astype(np.int32)
        valid = np.ones(8, bool)
        valid[-2:] = False
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = step(jstate, jnp.asarray(images), jnp.asarray(labels),
                          jnp.asarray(valid), key, key)
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid),
            [torch.from_numpy(np.array(x)) for x in
             jax_augment._sample_affine_batch(key, 8, 28, 28)])
        out.append((float(jm["loss"]), m["loss"].item()))
    return name, jstate, state, out


def test_bf16_full_stores_bf16_params_and_f32_statistics(trajectory):
    name, jstate, state, *_ = trajectory
    for p in state.model.parameters():
        assert p.dtype == torch.bfloat16
    for b in state.model.buffers():
        assert b.dtype == torch.float32
    assert all(leaf.dtype == jnp.bfloat16 for leaf in
               jax.tree_util.tree_leaves(jstate.params))
    momentum = [s["momentum_buffer"] for s in
                state.optimizer.state_dict()["state"].values()]
    assert momentum and all(m.dtype == torch.bfloat16 for m in momentum)
    assert (name == "resnet_small") == bool(list(state.model.buffers()))


def test_bf16_full_sgd_trajectory_matches_jax(trajectory):
    name, jstate, state, losses_ = trajectory
    for jloss, loss in losses_:
        assert np.isfinite(loss) and abs(loss - jloss) <= 2e-2 * abs(jloss)
    want = convert.cnn_params_from_jax(_np(jstate.params),
                                       _np(jstate.batch_stats) or None)
    got = state.model.state_dict()
    assert state.step == int(jstate.step) == 3 and set(got) == set(want)
    for k, w in want.items():
        tol = TOL_PARAMS
        if "running" in k:
            tol = TOL_STATS
        elif BN_BIAS.fullmatch(k):
            tol = TOL_BN_BIAS
        g = got[k].float()
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
        assert err <= tol, (name, k, err)


def test_bf16_full_checkpoint_keeps_the_dtypes(trajectory, tmp_path):
    name, _, state, *_ = trajectory
    path = str(tmp_path / "bf16_full.ckpt")
    ckpt.save_checkpoint(path, name, state.model, 2, 0.5, state.optimizer,
                         state.step)
    _, _, model = _models(name)
    fresh = TrainState(model, make_optimizer("SGD", model))
    ckpt.load_checkpoint(path, fresh.model, fresh.optimizer,
                         train_state=fresh)
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert fresh.updates == state.updates == 3
