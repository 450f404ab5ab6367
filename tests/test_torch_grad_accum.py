"""``--grad-accum K`` in the port: the accumulated step against the port's
own big-batch step for each of the three losses (JAX's bound, rtol 2e-5
and atol 2e-6 on the parameters after one SGD step, as
``tests/test_grad_accum.py`` holds the JAX package); against the JAX
package's ``_train_step_accum`` in f64 (JAX's x64 mode; f32 parameters)
for the mlp, a reduced BatchNorm resnet (the running statistics chained
over the microbatches) and alexnet at 64 px with JAX's own per-microbatch
dropout masks injected, within 1e-6 of each tensor's largest value (the
f32 parameters' and gradients' roundings only); and a 2-rank gloo world
against one process (``tests/_torch_ddp_child.py``), within 1e-5 in f32
(sums in another order).  Inputs come from numpy with a seed.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models.resnet import ResNet as JaxResNet
from distributedpytorch_tpu.models.simple import MLP as JaxMLP
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PrecisionPolicy as JaxPolicy
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import runtime
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS, PrecisionPolicy
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)
from tests._torch_zoo_jax import capture_dropout
from tests.test_torch_ddp import _run_world

MEAN, STD = 0.45, 0.2
F64 = PrecisionPolicy(name="f64", param_dtype=torch.float32,
                      compute_dtype=torch.float64,
                      accum_dtype=torch.float64)
JAX_F64 = JaxPolicy(name="f64", param_dtype=jnp.float32,
                    compute_dtype=jnp.float64, accum_dtype=jnp.float64,
                    output_dtype=jnp.float64)
TOL_F64 = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(b=16, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(b, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(b,)).astype(np.int32)
    valid = np.ones(b, dtype=bool)
    valid[-3:] = False      # uneven masking across microbatches
    return images, labels, valid


def _identity(b):
    zeros = torch.zeros(b)
    return (zeros, zeros, zeros, zeros + 28.0, zeros + 28.0)


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


# -- K = 4 against K = 1 in the port ------------------------------------------

@pytest.mark.parametrize("loss", ["cross_entropy", "weighted_cross_entropy",
                                  "focal_loss"])
def test_accumulated_step_equals_big_batch_step(loss):
    weights = (np.linspace(0.5, 1.5, 10).astype(np.float32)
               if loss == "weighted_cross_entropy" else None)
    images, labels, valid = _batch()
    affine = augment.sample_affine_batch(torch.Generator().manual_seed(3),
                                         16, 28, 28)
    out = {}
    for k in (1, 4):
        model = registry.get_model("cnn", 10, PRESETS["f32"], device="cpu")
        engine = Engine(model, losses.get_loss_fn(loss, weights), MEAN, STD,
                        28, PRESETS["f32"], "cpu", optimizer="SGD",
                        steps_per_epoch=4, grad_accum=k)
        state = engine.init_state(torch.Generator().manual_seed(0))
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid), affine)
        out[k] = (m, model.state_dict(), state)
    (m1, p1, s1), (m4, p4, s4) = out[1], out[4]
    np.testing.assert_allclose(m4["loss"].item(), m1["loss"].item(),
                               rtol=1e-5)
    assert m4["correct"].item() == m1["correct"].item()
    assert m4["valid"].item() == m1["valid"].item() == 13.0
    assert (s1.step, s1.updates) == (s4.step, s4.updates) == (1, 1)
    for key, v in p1.items():
        np.testing.assert_allclose(p4[key].numpy(), v.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=key)


def test_indivisible_microbatch_raises():
    model = registry.get_model("mlp", 10, PRESETS["f32"], device="cpu")
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28,
                    PRESETS["f32"], "cpu", grad_accum=5)
    state = engine.init_state(torch.Generator().manual_seed(0))
    images, labels, valid = _batch()
    with pytest.raises(ValueError, match="not divisible"):
        engine.train_step_affine(state, torch.from_numpy(images),
                                 torch.from_numpy(labels).long(),
                                 torch.from_numpy(valid), _identity(16))


@pytest.mark.parametrize("dp", [1, 2])
def test_train_step_draws_masks_per_microbatch(dp):
    """``train_step`` of a dropout model under K = 2 draws, after the
    affine draws, one mask list per microbatch for the global
    microbatch's dp * b / K rows, and data shard d keeps its b / K of
    them (shard 1 of 2 here)."""
    b, k = 4, 2
    model = registry.get_model("alexnet", 10, PRESETS["f32"], device="cpu")
    mesh = runtime.Mesh(data_parallel=dp, model_parallel=1,
                        data_index=dp - 1, model_index=0)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 64,
                    PRESETS["f32"], "cpu", grad_accum=k, mesh=mesh)
    seen = []

    def capture(state, images, labels, valid, affine, masks):
        seen.append(masks)
        return state, {}

    engine.train_step_affine = capture
    images, labels, valid = _batch(b=b)
    engine.train_step(None, torch.from_numpy(images),
                      torch.from_numpy(labels).long(),
                      torch.from_numpy(valid),
                      torch.Generator().manual_seed(1))
    (masks,) = seen
    gen = torch.Generator().manual_seed(1)
    augment.sample_affine_batch(gen, dp * b, 28, 28)
    rows = slice((dp - 1) * b // k, dp * b // k)
    want = [[m[rows] for m in engine.draw_dropout_masks(gen, dp * b // k)]
            for _ in range(k)]
    assert len(masks) == k and len(masks[0]) == 2      # alexnet: 2 dropouts
    for got_ms, want_ms in zip(masks, want):
        for got, w in zip(got_ms, want_ms):
            assert got.shape[0] == b // k and got.dtype == torch.bool
            assert torch.equal(got, w)
    assert not torch.equal(masks[0][0], masks[1][0])


# -- the accumulated step against JAX's, f64 ----------------------------------

CASES = {"mlp": (16, 4, 28), "resnet_small": (8, 2, 32),
         "alexnet": (8, 4, 64)}


def _jax_model(name):
    if name == "mlp":
        return JaxMLP(dtype=jnp.float64)
    if name == "resnet_small":
        return JaxResNet(stage_sizes=(1, 1), width=8, dtype=jnp.float64)
    return jax_get_model("alexnet", 10, half_precision=False).clone(
        dtype=jnp.float64)


def _port_model(name):
    if name == "resnet_small":
        return ResNet((1, 1), width=8, dtype=torch.float64)
    return registry.get_model(name, 10, F64, device="cpu")


@pytest.fixture(scope="module", params=list(CASES))
def f64_accum(request):
    """The port's accumulated f64 step and JAX's on the same inputs, params
    and masks: (name, JAX grads, batch_stats, loss; port grads, buffers,
    loss)."""
    name = request.param
    b, k, size = CASES[name]
    images, labels, valid = _batch(b, seed=4)
    model = _port_model(name)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size, F64, "cpu",
                    optimizer="SGD", steps_per_epoch=2, grad_accum=k)
    imgs = augment.train_transform(torch.from_numpy(images), MEAN, STD, size,
                                   _identity(b), out_dtype=torch.float64)
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    captured = {}
    dkey = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        jengine = JaxEngine(_jax_model(name), name, jax_losses.cross_entropy,
                            tx, MEAN, STD, size, precision=JAX_F64,
                            grad_accum=k)
        state = jengine.init_state(jax.random.PRNGKey(1))
        # the statistics as the scan carries them, in the accum dtype
        state = state.replace(batch_stats=jax.tree_util.tree_map(
            lambda v: v.astype(jnp.float64), state.batch_stats))
        finish = jengine._finish_step

        def capture(st, grads, new_bs, loss, correct, vmask):
            captured.update(grads=_np(grads), bs=_np(new_bs),
                            loss=float(loss), correct=float(correct))
            return finish(st, grads, new_bs, loss, correct, vmask)

        jengine._finish_step = capture
        x = jnp.asarray(imgs.numpy())
        masks = []
        if name == "alexnet":
            # JAX's own masks of microbatch i: the dropout key folded with
            # i, as _train_step_accum folds it (rows i, i+k, ...)
            for i in range(k):
                got = []
                with fnn.intercept_methods(capture_dropout(got)):
                    _jax_model(name).apply(
                        {"params": state.params}, x[i::k], train=True,
                        rngs={"dropout": jax.random.fold_in(dkey, i)})
                masks.append([torch.from_numpy(np.array(m)) for m in got])
        jengine._train_step_accum(state, x, jnp.asarray(labels),
                                  jnp.asarray(valid, jnp.float64), dkey)
    model.load_state_dict(convert.cnn_params_from_jax(
        _np(state.params), _np(state.batch_stats) or None))
    tstate = TrainState(model, make_optimizer("SGD", model))
    _, m = engine.train_step_affine(
        tstate, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), _identity(b), masks)
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (name, captured, grads, dict(model.named_buffers()),
            m["loss"].item(), m["correct"].item())


def test_accumulated_f64_step_matches_jax(f64_accum):
    name, want, grads, buffers, loss, correct = f64_accum
    jgrads = convert.cnn_params_from_jax(want["grads"], want["bs"] or None)
    assert abs(loss - want["loss"]) <= TOL_F64 * abs(want["loss"])
    assert correct == want["correct"]
    for key, g in grads.items():
        assert g.dtype == torch.float32, key
        assert _rel(g, jgrads[key]) <= TOL_F64, (name, key)
    assert bool(buffers) == (name == "resnet_small")
    for key, v in buffers.items():          # chained over the microbatches
        assert v.dtype == torch.float32
        assert _rel(v, jgrads[key]) <= TOL_F64, (name, key)


# -- two ranks against one ----------------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "resnet_small"])
def test_two_ranks_accumulate_as_one_process(name, tmp_path):
    """Three SGD steps at K = 2 (the first with the valid rows spread 4 +
    1 over the ranks): two gloo ranks end where one process ends on the
    whole global batch, parameters and statistics within 1e-5 of each
    tensor's largest value, metrics within 1e-6."""
    one = _run_world(name, tmp_path, 1, "--grad-accum", "2")[0]
    two = _run_world(name, tmp_path, 2, "--grad-accum", "2")
    assert all(r["ddp"] for r in two)
    for k, v in one["state"].items():
        assert torch.equal(two[1]["state"][k], two[0]["state"][k]), k
        err = (two[0]["state"][k] - v).abs().max().item() / max(
            v.abs().max().item(), 1e-6)
        assert err <= 1e-5, (k, err)
    np.testing.assert_allclose(np.array(two[0]["metrics"]),
                               np.array(one["metrics"]), rtol=1e-6,
                               atol=1e-6)
    assert one["metrics"][0][2] == 5.0
