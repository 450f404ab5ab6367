"""The zoo's training step held against the JAX package's, and its
data-parallel world.

* Three f32 SGD steps of alexnet at 64 px against the JAX
  ``Engine._train_step_keys``: the same init, uint8 batches (two rows
  masked), affine draws and dropout masks (JAX's, captured from an apply
  with the step's dropout key: the bits depend only on the key and the
  module path).  Parameters within 1e-5 of each tensor's largest value,
  as tests/test_torch_cnn_train.py holds the cnn.
* ``Engine.train_step`` draws the dropout masks after the affine draws,
  for the global batch, and a data shard keeps its rows.
* Two ranks (gloo, tests/_torch_ddp_child.py) of vgg11_bn at 64 px with
  dropout masks drawn for the global batch end where one process ends on
  it: parameters, BatchNorm statistics and metrics, in f64 compute (f32
  parameters) within 1e-6 of each tensor's largest value.  In f32 the two
  worlds sum BatchNorm's statistics in another order (per rank, then
  across ranks), and vgg's backward at 4 rows a rank amplifies that into
  gradients up to 2.4% apart after three steps (ROADMAP queue 3 entry 8).
  The conv biases, which a train-mode BatchNorm cancels, move by rounding
  only and are held at their conv weight's scale.
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
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import runtime
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.layers import dropout_layers
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

from tests import _torch_zoo_jax as Z
from tests.test_torch_ddp import _run_world

MEAN, STD = 0.13, 0.31


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_alexnet_sgd_trajectory_matches_jax():
    size, b = 64, 8
    jmodel = jax_get_model("alexnet", 10, half_precision=False)
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    jengine = JaxEngine(jmodel, "alexnet", jax_losses.cross_entropy, tx,
                        MEAN, STD, size, precision=JAX_PRESETS["f32"])
    jstate = jengine.init_state(jax.random.PRNGKey(1))
    model = registry.get_model("alexnet", 10, PRESETS["f32"], device="cpu")
    model.load_state_dict(convert.cnn_params_from_jax(_np(jstate.params)))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size,
                    PRESETS["f32"], "cpu", optimizer="SGD",
                    steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model))
    step = jax.jit(jengine._train_step_keys)
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        images = rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, b).astype(np.int32)
        valid = np.ones(b, bool)
        valid[-2:] = False
        aug_key, dropout_key = jax.random.split(jax.random.PRNGKey(100 + i))
        masks = []
        with fnn.intercept_methods(Z.capture_dropout(masks)):
            jmodel.apply({"params": jstate.params},
                         jnp.zeros((b, size, size, 3)), train=True,
                         rngs={"dropout": dropout_key})
        jstate, jm = step(jstate, jnp.asarray(images), jnp.asarray(labels),
                          jnp.asarray(valid), aug_key, dropout_key)
        draws = [torch.from_numpy(np.array(t)) for t in
                 jax_augment._sample_affine_batch(aug_key, b, 28, 28)]
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid), draws,
            [torch.from_numpy(np.array(mk)) for mk in masks])
        assert abs(m["loss"].item() - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    want = convert.cnn_params_from_jax(_np(jstate.params))
    got = state.model.state_dict()
    assert state.step == int(jstate.step) == 3 and set(got) == set(want)
    for k, w in want.items():
        assert Z.rel(got[k], w) <= 1e-5, k


def test_train_step_draws_masks_for_the_global_batch(monkeypatch):
    """Data shard 1 of 2 gets rows [b, 2b) of the masks drawn for 2b rows
    after the affine draws, and the affine draws' rows likewise."""
    b = 3
    model = registry.get_model("alexnet", 10, PRESETS["f32"], device="cpu")
    mesh = runtime.Mesh(data_parallel=2, model_parallel=1, data_index=1,
                        model_index=0)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 64,
                    PRESETS["f32"], "cpu", mesh=mesh)
    seen = {}

    def capture(state, images, labels, valid, affine, masks=()):
        seen.update(affine=affine, masks=masks)

    monkeypatch.setattr(engine, "train_step_affine", capture)
    engine.train_step(None, torch.zeros((b, 28, 28), dtype=torch.uint8),
                      None, None, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    affine = augment.sample_affine_batch(gen, 2 * b, 28, 28)
    masks = [torch.rand((2 * b,) + s, generator=gen) < 0.5
             for s in ((256 * 6 * 6,), (4096,))]
    for got, want in zip(seen["affine"], affine):
        assert torch.equal(got, want[b:])
    assert len(seen["masks"]) == 2
    for got, want in zip(seen["masks"], masks):
        assert got.dtype == torch.bool and torch.equal(got, want[b:])
    assert 0.4 < seen["masks"][1].float().mean().item() < 0.6


def test_a_dropout_model_needs_its_masks():
    model = registry.get_model("squeezenet", 10, PRESETS["f32"],
                               device="cpu")
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 64,
                    PRESETS["f32"], "cpu")
    state = TrainState(model, make_optimizer("adam", model))
    zeros = torch.zeros(2)
    with pytest.raises(ValueError, match="needs its keep mask"):
        engine.train_step_affine(
            state, torch.zeros((2, 28, 28), dtype=torch.uint8),
            torch.zeros(2, dtype=torch.long), torch.ones(2, dtype=torch.bool),
            (zeros, zeros, zeros, zeros + 28, zeros + 28))
    assert all(layer.mask is None for layer in dropout_layers(model))


def _world(tmp_path, n):
    """The ``n``-rank vgg64 world's outputs, their files (0.5 GB a rank)
    deleted once read."""
    out = _run_world("vgg64", tmp_path, n, "--precision", "f64")
    for f in tmp_path.glob("vgg64-*.pt"):
        f.unlink()
    return out


def test_two_ranks_of_vgg_equal_one_process(tmp_path):
    one = _world(tmp_path, 1)[0]
    two = _world(tmp_path, 2)
    assert not one["ddp"] and all(r["ddp"] for r in two)
    for r in two:
        for k, v in r["state"].items():
            assert torch.equal(v, two[0]["state"][k]), (r["rank"], k)
        assert r["metrics"] == two[0]["metrics"]
    # a conv bias before a train-mode BatchNorm moves by rounding only:
    # held at its conv weight's scale (_torch_zoo_jax.ZERO_GRAD)
    for k, err in Z.errors("vgg", two[0]["state"], one["state"]).items():
        assert err <= 1e-6, (k, err)
    np.testing.assert_allclose(np.array(two[0]["metrics"]),
                               np.array(one["metrics"]), rtol=1e-6,
                               atol=1e-6)
    assert one["metrics"][0][2] == 5.0
