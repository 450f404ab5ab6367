"""``train -f`` on a JAX-written checkpoint: the optax state becomes the
torch optimizer's (``convert.optimizer_state_from_jax``) and the run goes
on as the JAX run would.

  * The JAX engine trains one epoch of two steps and writes its msgpack
    file; the port restores it (``checkpoint.load_checkpoint``) and trains
    the second epoch's two steps on the same batches (the port's identity
    augmentation, the images fed to both; alexnet's dropout masks drawn by
    JAX and injected); both in f64 compute with f32 parameters.  The
    parameters, BatchNorm statistics and optimizer state (Adam's moments
    and count, SGD's trace) end within 1e-6 of each tensor's largest
    value of JAX's own four-step run (the f32 parameters' roundings
    only), for the mlp with Adam and with SGD (the staircase's count
    crosses the epoch: the second epoch runs at a tenth of the rate), a
    BatchNorm resnet under ``--feature-extract`` (optax's
    ``multi_transform``, the masked backbone carrying no state) and
    alexnet (dropout).  In f16 the file's loss scale carries over: the
    scale and good-step count equal JAX's after the resumed steps, and
    the parameters' updates are within 1e-2 of each one's largest but the
    dense layers' biases (XLA on the CPU sums a half-precision bias
    gradient in half precision, ROADMAP queue 3 entry 2).
  * ``train -f`` through the CLI on the JAX ``run_train``'s rolling file:
    the port goes on at the next epoch and step.
  * A JAX file with no optimizer state is still refused for a resume,
    and a ``--feature-extract`` mismatch says so.
"""

import re

import flax.linen as fnn
from flax import serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models.resnet import ResNet as JaxResNet
from distributedpytorch_tpu.models.simple import MLP as JaxMLP
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as ckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import convert, registry
from distributedpytorch_tpu_torch.models.resnet import ResNet
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine
from tests._torch_zoo_jax import capture_dropout
from tests.test_torch_grad_accum import F64, JAX_F64

TOL_F64 = 1e-6
TOL_UPDATE = 1e-2
MEAN, STD = 0.45, 0.2
STEPS_PER_EPOCH = 2
# the model name each case's file records (the reduced resnet as resnet)
FILE_MODEL = {"mlp": "mlp", "resnet_small": "resnet", "alexnet": "alexnet"}

# name: (optimizer, feature_extract, image size, precision)
CASES = {"mlp-adam": ("adam", False, 28, "f64"),
         "mlp-SGD": ("SGD", False, 28, "f64"),
         "resnet_small-SGD-feature_extract": ("SGD", True, 32, "f64"),
         "alexnet-SGD": ("SGD", False, 64, "f64"),
         "mlp-SGD-f16": ("SGD", False, 28, "f16")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(state) -> dict:
    """A JAX TrainState as the nested dict of numpy arrays its file
    holds."""
    return serialization.to_state_dict(jax.device_get(state))


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _identity(b):
    zeros = torch.zeros(b)
    return (zeros, zeros, zeros, zeros + 28.0, zeros + 28.0)


def _batches(size, dtype):
    """Four batches of 8: (uint8 images, labels, valid, the images the
    port's identity augmentation gives, in ``dtype``)."""
    out = []
    for i in range(4):
        rng = np.random.default_rng(80 + i)
        images = rng.integers(0, 256, (8, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, 8).astype(np.int32)
        valid = np.ones(8, bool)
        valid[-1 - i % 2:] = False
        x = augment.train_transform(torch.from_numpy(images), MEAN, STD,
                                    size, _identity(8), out_dtype=dtype)
        out.append((images, labels, valid, x))
    return out


def _jax_model(name, dtype):
    arch = name.split("-")[0]
    if arch == "mlp":
        return JaxMLP(dtype=dtype)
    if arch == "resnet_small":
        return JaxResNet(stage_sizes=(1, 1), width=8, dtype=dtype)
    return jax_get_model("alexnet", 10, half_precision=False).clone(
        dtype=dtype)


def _port_model(name, policy):
    arch = name.split("-")[0]
    if arch == "resnet_small":
        return ResNet((1, 1), width=8, dtype=policy.compute_dtype)
    return registry.get_model(arch, 10, policy, device="cpu")


def _jax_masks(model, params, x, key):
    got = []
    with fnn.intercept_methods(capture_dropout(got)):
        model.apply({"params": params}, x, train=True,
                    rngs={"dropout": key})
    return [torch.from_numpy(np.array(m)) for m in got]


@pytest.fixture(scope="module", params=list(CASES))
def resumed(request, tmp_path_factory):
    """JAX's four steps, with its file after two; the port's two steps
    from that file.  Returns (name, JAX's final state, its state at the
    file, the port's engine state)."""
    name = request.param
    optimizer, feature_extract, size, precision = CASES[name]
    f64 = precision == "f64"
    jpolicy = JAX_F64 if f64 else JAX_PRESETS["f16"]
    policy = F64 if f64 else PRESETS["f16"]
    batches = _batches(size, torch.float64 if f64 else torch.float32)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, STEPS_PER_EPOCH,
                            feature_extract)
    path = str(tmp_path_factory.mktemp("jax") / f"{name}.ckpt")
    masks = []
    with jax.enable_x64(f64):
        model = _jax_model(name, jpolicy.compute_dtype)
        jengine = JaxEngine(model, name.split("-")[0],
                            jax_losses.cross_entropy, tx, MEAN, STD, size,
                            precision=jpolicy)
        state = jengine.init_state(jax.random.PRNGKey(1))
        for i, (_, labels, valid, x) in enumerate(batches):
            key = jax.random.PRNGKey(90 + i)
            xj = jnp.asarray(x.numpy(), jpolicy.compute_dtype)
            if jengine.uses_dropout:
                masks.append(_jax_masks(model, state.params, xj, key))
            vmask = jnp.asarray(valid, jpolicy.accum_dtype)
            grads, bs, loss, correct = jengine._grads_and_metrics(
                state, xj, jnp.asarray(labels), vmask, key)
            state, _ = jengine._finish_step(state, grads, bs, loss,
                                            correct, vmask)
            if i == STEPS_PER_EPOCH - 1:
                jax_ckpt.save_checkpoint(path, FILE_MODEL[name.split("-")[0]],
                                         state, epoch=0, best_valid_loss=2.5)
                at_file = _np(state)
    model = _port_model(name, policy)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size, policy,
                    "cpu", optimizer=optimizer,
                    steps_per_epoch=STEPS_PER_EPOCH,
                    feature_extract=feature_extract)
    tstate = engine.init_state(torch.Generator().manual_seed(0))
    loaded = ckpt.load_checkpoint(path, tstate.model, tstate.optimizer,
                                  train_state=tstate)
    assert loaded == (1, 2.5, STEPS_PER_EPOCH)
    for i in range(STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH):
        images, labels, valid, _ = batches[i]
        engine.train_step_affine(
            tstate, torch.from_numpy(images),
            torch.from_numpy(labels).long(), torch.from_numpy(valid),
            _identity(8), masks[i] if masks else ())
    return name, _np(state), at_file, tstate


def _port_tree(state_dict: dict) -> dict:
    return {k: v.detach().float() for k, v in state_dict.items()}


def _dense_bias(name: str) -> bool:
    return name.endswith(".bias") and "Dense" in name or name == "head.bias"


def test_resumed_params_and_statistics_match_jax(resumed):
    name, want, at_file, tstate = resumed
    jax_sd = convert.cnn_params_from_jax(want["params"],
                                         want["batch_stats"] or None)
    start = convert.cnn_params_from_jax(at_file["params"],
                                        at_file["batch_stats"] or None)
    got = _port_tree(tstate.model.state_dict())
    assert set(got) == set(jax_sd)
    for key, w in jax_sd.items():
        if name.endswith("f16"):
            if _dense_bias(key):
                continue
            assert _rel(got[key] - start[key], w - start[key]) <= \
                TOL_UPDATE, key
        else:
            assert _rel(got[key], w) <= TOL_F64, key


def test_resumed_optimizer_state_and_counters_match_jax(resumed):
    name, want, _, tstate = resumed
    optimizer, feature_extract, _, precision = CASES[name]
    by_name, count = convert.optimizer_state_from_jax(
        want["opt_state"], want["params"], want["batch_stats"] or {},
        optimizer, False)
    assert count == 2 * STEPS_PER_EPOCH
    assert (int(tstate.step), int(tstate.updates)) == (count, count)
    names = {p: n for n, p in tstate.model.named_parameters()}
    trained = [p for g in tstate.optimizer.param_groups for p in g["params"]]
    assert sorted(names[p] for p in trained) == sorted(by_name)
    if feature_extract:
        assert set(by_name) == {"head.weight", "head.bias"}
    for p in trained:
        st = tstate.optimizer.state[p]
        assert set(st) == set(by_name[names[p]])
        for key, w in by_name[names[p]].items():
            if key == "step":
                assert float(st[key]) == float(w) == count
            elif precision == "f64":
                assert _rel(st[key], w) <= TOL_F64, (names[p], key)
    if precision == "f16":
        assert tstate.loss_scale.to_dict() == {
            "scale": float(want["loss_scale"]["scale"]),
            "good_steps": int(want["loss_scale"]["good_steps"])} == {
            "scale": 2.0 ** 15, "good_steps": 2 * STEPS_PER_EPOCH}


def test_train_resumes_a_jax_run_through_the_cli(tmp_path):
    """The JAX ``run_train`` writes its epoch-0 rolling file; the port's
    ``train -f`` on it trains epoch 2 and counts on from JAX's steps."""
    from distributedpytorch_tpu.cli import run_train
    from distributedpytorch_tpu.config import Config

    data = str(tmp_path / "data")
    jax_result = run_train(Config(
        action="train", data_path=data, rsl_path=str(tmp_path / "jax"),
        dataset="synthetic", model_name="mlp", batch_size=8, nb_epochs=1,
        debug=True, optimizer="SGD"))
    jax_steps = int(jax_result["state"].step)
    path = str(tmp_path / "jax" / "checkpoint-synthetic-mlp-000.ckpt")
    result = tcli.run_train(tconfig.config_from_argv(
        ["train", "-d", data, "--rsl_path", str(tmp_path / "port"),
         "--dataset", "synthetic", "--debug", "-b", "8", "-e", "2",
         "--optimizer", "SGD", "--device", "cpu", "-f", path]))
    log = (tmp_path / "port" / "test.log").read_text()
    assert "model loaded from" in log
    assert re.findall(r"[* ] Epoch: (\d{3})", log) == ["002"]
    assert [h["epoch"] for h in result["history"]] == [1]
    steps = int(result["state"].step)
    assert steps > jax_steps and steps == int(result["state"].updates)
    payload = ckpt.read_checkpoint(
        str(tmp_path / "port" / "checkpoint-synthetic-mlp-001.ckpt"))
    assert payload["state"]["step"] == steps


def _jax_file(tmp_path, name, feature_extract=False, opt_state=True):
    tx = jax_make_optimizer("adam", 1e-3, 0.9, 0.1, 2, feature_extract)
    jengine = JaxEngine(JaxMLP(dtype=jnp.float32), "mlp",
                        jax_losses.cross_entropy, tx, MEAN, STD, 28,
                        precision=JAX_PRESETS["f32"])
    state = jengine.init_state(jax.random.PRNGKey(2))
    if not opt_state:
        state = state.replace(opt_state=())
    path = str(tmp_path / name)
    jax_ckpt.save_checkpoint(path, "mlp", state, epoch=0,
                             best_valid_loss=1.0)
    return path


def test_a_jax_file_without_optimizer_state_is_refused(tmp_path):
    path = _jax_file(tmp_path, "params-only.ckpt", opt_state=False)
    engine = Engine(registry.get_model("mlp", 10, PRESETS["f32"],
                                       device="cpu"),
                    losses.cross_entropy, MEAN, STD, 28, PRESETS["f32"],
                    "cpu")
    state = engine.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="holds no optimizer state"):
        ckpt.load_checkpoint(path, state.model, state.optimizer,
                             train_state=state)
    ckpt.load_checkpoint(path, state.model, restore_optimizer=False)


@pytest.mark.parametrize("saved,resumed_with", [(True, False),
                                                (False, True)])
def test_a_feature_extract_mismatch_is_refused(tmp_path, saved,
                                               resumed_with):
    path = _jax_file(tmp_path, "fe.ckpt", feature_extract=saved)
    engine = Engine(registry.get_model("mlp", 10, PRESETS["f32"],
                                       device="cpu"),
                    losses.cross_entropy, MEAN, STD, 28, PRESETS["f32"],
                    "cpu", feature_extract=resumed_with)
    state = engine.init_state(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="--feature-extract must match"):
        ckpt.load_checkpoint(path, state.model, state.optimizer,
                             train_state=state)


# -- the torch-only writer of a JAX-format file (chip_smoke resumes from it)

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    return (a.shape, a.dtype.name)


@pytest.mark.parametrize("optimizer,feature_extract",
                         [("adam", False), ("SGD", True)])
def test_the_torch_written_jax_file_is_jax_s_and_round_trips(
        tmp_path, optimizer, feature_extract):
    """``tests/_torch_jax_ckpt.py`` writes, from a port state after two
    f16 steps of a BatchNorm resnet, the tree of a JAX ``TrainState`` of
    the same model and optimizer (every key, shape and dtype, flax's
    decoder reading it), and the port's ``load_checkpoint`` restores from
    it the same parameters, statistics, optimizer state, counters and
    loss scale, bit for bit."""
    from tests._torch_jax_ckpt import jax_state_tree, write_jax_checkpoint

    def engine():
        model = ResNet((1, 1), width=8, dtype=torch.float16)
        return Engine(model, losses.cross_entropy, MEAN, STD, 32,
                      PRESETS["f16"], "cpu", optimizer=optimizer,
                      feature_extract=feature_extract)

    eng = engine()
    state = eng.init_state(torch.Generator().manual_seed(3))
    batches = _batches(32, torch.float32)[:2]
    for i, (images, labels, valid, _) in enumerate(batches):
        eng.train_step(state, torch.from_numpy(images),
                       torch.from_numpy(labels).long(),
                       torch.from_numpy(valid),
                       torch.Generator().manual_seed(i))
    tree = jax_state_tree(state.model, state.optimizer, int(state.step),
                          int(state.updates), state.loss_scale.to_dict(),
                          feature_extract)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, 2, feature_extract)
    jengine = JaxEngine(JaxResNet(stage_sizes=(1, 1), width=8,
                                  dtype=jnp.float16), "resnet",
                        jax_losses.cross_entropy, tx, MEAN, STD, 32,
                        precision=JAX_PRESETS["f16"])
    want = _np(jengine.init_state(jax.random.PRNGKey(0)))
    assert _shapes(tree) == _shapes(want)
    path = str(tmp_path / "port-as-jax.ckpt")
    write_jax_checkpoint(path, "resnet", tree, epoch=3,
                         best_valid_loss=0.75)
    with open(path, "rb") as f:
        decoded = serialization.msgpack_restore(f.read())
    assert _shapes(decoded["state"]) == _shapes(want)

    fresh_engine = engine()
    fresh = fresh_engine.init_state(torch.Generator().manual_seed(9))
    assert ckpt.load_checkpoint(path, fresh.model, fresh.optimizer,
                                train_state=fresh) == (4, 0.75, 2)
    for (k, v), w in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(v, w), k
    got, want_opt = (s.optimizer.state_dict()["state"]
                     for s in (fresh, state))
    assert got.keys() == want_opt.keys()
    for i, st in want_opt.items():
        for name, t in st.items():
            assert torch.equal(got[i][name], t), (i, name)
    assert (int(fresh.step), int(fresh.updates)) == (2, int(state.updates))
    assert fresh.loss_scale.to_dict() == state.loss_scale.to_dict()


# -- the zoo's optax trees against the port's parameters ---------------------

@pytest.mark.parametrize("name", ["alexnet", "vgg", "squeezenet", "densenet",
                                  "inception"])
@pytest.mark.parametrize("optimizer,feature_extract",
                         [("adam", False), ("SGD", True)])
def test_zoo_optax_state_maps_onto_the_trained_parameters(
        name, optimizer, feature_extract):
    """The optax state of each full-width zoo model (its shapes from
    ``jax.eval_shape`` of the JAX engine's init, no compute) converts to
    one torch state per parameter the port trains, by name, each of that
    parameter's shape: the leaf order of the JAX tree (inception's
    ``AuxHead_0``, the dropout models) plays no part."""
    from distributedpytorch_tpu.models import get_model_input_size

    size = get_model_input_size(name)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, 2, feature_extract)
    jengine = JaxEngine(jax_get_model(name, 10, half_precision=False), name,
                        jax_losses.cross_entropy, tx, MEAN, STD, size,
                        precision=JAX_PRESETS["f32"])
    shapes = jax.eval_shape(jengine.init_state, jax.random.PRNGKey(0))
    state = serialization.to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    by_name, count = convert.optimizer_state_from_jax(
        state["opt_state"], state["params"], state["batch_stats"] or {},
        optimizer, False)
    model = registry.get_model(name, 10, PRESETS["f32"], device="cpu")
    if feature_extract:
        registry.freeze_backbone(model)
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert count == 0 and set(by_name) == set(trained)
    for n, st in by_name.items():
        assert set(st) == ({"exp_avg", "exp_avg_sq", "step"}
                           if optimizer == "adam" else {"momentum_buffer"})
        for key, t in st.items():
            if key != "step":
                assert t.shape == trained[n].shape, (n, key)
