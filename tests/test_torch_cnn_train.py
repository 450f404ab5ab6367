"""The port's cnn and resnet training held against the JAX package's: a
3-step f32 SGD trajectory of cnn (K5's plain version) and of a small
BatchNorm resnet from identical init, batches and affine draws; ``test
-f`` on a cnn and a resnet checkpoint written by the JAX package at the
JAX accuracy.  Inputs come from numpy with a seed; the JAX side runs on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models.resnet import ResNet as JaxResNet
from distributedpytorch_tpu.models.simple import SmallCNN as JaxCNN
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.models import convert
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.models.simple import SmallCNN
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (Engine, TrainState,
                                                       make_optimizer)

MEAN, STD = 0.13, 0.31


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


@pytest.mark.parametrize("name", ["cnn", "resnet_small"])
def test_sgd_trajectory_matches_jax(name):
    """Three SGD steps (momentum 0.9, staircase at 2 steps an epoch) in
    f32, the batch's last two rows masked: parameters and BatchNorm
    statistics within 1e-5 of the JAX ones, relative to each tensor's
    largest value (f32 sums in other orders)."""
    if name == "cnn":
        jmodel, size = JaxCNN(dtype=jnp.float32, pallas_dw=True), 28
        model = SmallCNN(dtype=torch.float32, pallas_dw=True)
    else:
        jmodel = JaxResNet(stage_sizes=(1, 1), width=8, dtype=jnp.float32)
        model, size = ResNet((1, 1), width=8, dtype=torch.float32), 32
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    jengine = JaxEngine(jmodel, "cnn", jax_losses.cross_entropy, tx, MEAN,
                        STD, size, precision=JAX_PRESETS["f32"])
    jstate = jengine.init_state(jax.random.PRNGKey(1))
    model.load_state_dict(convert.cnn_params_from_jax(
        _np(jstate.params), _np(jstate.batch_stats) or None))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size,
                    PRESETS["f32"], "cpu", optimizer="SGD",
                    steps_per_epoch=2)
    state = TrainState(model, make_optimizer("SGD", model))
    step = jax.jit(jengine._train_step_keys)
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        images = rng.integers(0, 256, (8, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, 8).astype(np.int32)
        valid = np.ones(8, bool)
        valid[-2:] = False
        key = jax.random.PRNGKey(100 + i)
        jstate, _ = step(jstate, jnp.asarray(images), jnp.asarray(labels),
                         jnp.asarray(valid), key, key)
        engine.train_step_affine(
            state, torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid), _draws(key, 8, 28, 28))
    want = convert.cnn_params_from_jax(_np(jstate.params),
                                       _np(jstate.batch_stats) or None)
    got = state.model.state_dict()
    assert state.step == int(jstate.step) == 3 and set(got) == set(want)
    for k, w in want.items():
        err = (got[k] - w).abs().max().item() / max(w.abs().max().item(),
                                                    1e-6)
        assert err <= 1e-5, (k, err)


@pytest.mark.parametrize("name", ["cnn", "resnet"])
def test_test_on_a_jax_written_checkpoint_gives_the_jax_accuracy(name,
                                                                 tmp_path):
    """A model initialised by the JAX package, its BatchNorm statistics
    moved off their initial (0, 1), and saved by it: the port's ``test``
    in f32 counts the same correct rows as the JAX ``run_test``, with the
    batch_stats carried across."""
    from distributedpytorch_tpu import checkpoint as jax_ckpt
    from distributedpytorch_tpu import utils as jax_utils
    from distributedpytorch_tpu.cli import _build_engine, run_test
    from distributedpytorch_tpu.config import Config
    from distributedpytorch_tpu.data.datasets import load_dataset

    path = str(tmp_path / f"bestmodel-synthetic-{name}.ckpt")
    cfg = Config(action="test", data_path=str(tmp_path / "data"),
                 rsl_path=str(tmp_path / "jax"), dataset="synthetic",
                 model_name=name, debug=True, half_precision=False,
                 checkpoint_file=path, flightrec=False, batch_size=32,
                 no_compile_cache=True)
    dataset = load_dataset("synthetic", cfg.data_path, cfg.seed, debug=True)
    engine = _build_engine(cfg, name, dataset, steps_per_epoch=1)
    state = engine.init_state(jax_utils.root_key(3))
    rng = np.random.default_rng(4)
    state = state.replace(batch_stats=jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        * (v + 0.1), state.batch_stats))
    jax_ckpt.save_checkpoint(path, name, state, epoch=0,
                             best_valid_loss=1.0)
    want = run_test(cfg)["test_acc"]

    payload = ckpt.read_checkpoint(path)
    assert payload["model_name"] == name
    params = payload["state"]["params"]
    if name == "resnet":
        stats = _np(state.batch_stats)["BatchNorm_0"]
        np.testing.assert_array_equal(
            params["BatchNorm_0.running_var"].numpy(), stats["var"])
        assert not np.allclose(stats["var"], 1.0)
    argv = ["test", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "port"), "--dataset", "synthetic", "--debug",
            "--no-bf16", "--device", "cpu", "-b", "32", "-f", path]
    got = tcli.run_test(tconfig.config_from_argv(argv))
    assert got["model_name"] == name
    assert 0.0 < want < 1.0
    assert abs(got["test_acc"] - want) < 1e-6      # the same count of rows
