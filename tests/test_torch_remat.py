"""``--remat none|blocks|full`` in the port, held against its own
``none`` step and against the JAX package's ``remat=blocks`` gradients.

  * vit (full and flash attention), densenet, inception, resnet and the
    cnn with K5 (its plain version here): one train step under ``blocks``
    and under ``full`` gives the ``none`` step's gradients, parameters
    and BatchNorm statistics (f64 to 1e-12 and f32 to 1e-6 of each
    tensor's largest value; the recompute runs the same ops on the same
    values, so they come out equal).
  * Against JAX in f64 (JAX's x64 mode, f32 parameters) on the same
    weights through ``models/convert.py``: the vit's and a reduced
    densenet's ``remat=blocks`` gradients within 1e-6, by the pattern of
    JAX's ``tests/test_precision.py:127-170``.
  * densenet121's running statistics after one ``blocks`` step equal the
    ``none`` step's bit for bit (they would not if the recompute moved
    them again); ``--grad-accum 2`` with ``--remat full`` equals
    ``--grad-accum 2`` alone on alexnet (dropout masks per microbatch);
    the 2-rank ``ring_flash`` world at M = 2 takes 3 steps under
    ``blocks`` as under ``none``.
  * The refusal of a bad value is JAX's, the parameter names do not
    change, and ``train``, ``test`` and ``serve`` take the flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import cli as jax_cli
from distributedpytorch_tpu.config import Config as JaxConfig
from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models.densenet import DenseNet as JaxDenseNet
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import convert, registry, remat
from distributedpytorch_tpu_torch.models.densenet import DenseNet
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS, PrecisionPolicy
from distributedpytorch_tpu_torch.train.engine import Engine
from tests.test_torch_ring import NARROW, _run_world, _steps

F64 = PrecisionPolicy(name="f64", param_dtype=torch.float32,
                      compute_dtype=torch.float64,
                      accum_dtype=torch.float64)
TOL = {"f64": 1e-12, "f32": 1e-6}
TOL_JAX = 1e-6
MEAN, STD = 0.13, 0.31
CLASS_W = np.linspace(-1.0, 1.0, 10).astype(np.float32)
# name -> (registry name, attention, K5, input size, batch, precision)
MODELS = {
    "vit": ("vit", "full", False, 28, 4, "f64"),
    "vit_flash": ("vit", "flash", False, 28, 4, "f64"),
    "densenet": ("densenet", "full", False, 64, 2, "f64"),
    "inception": ("inception", "full", False, 299, 2, "f32"),
    "resnet": ("resnet", "full", False, 64, 2, "f64"),
    "cnn_k5": ("cnn", "full", True, 28, 4, "f32"),      # K5: no f64
}
SMALL_DENSENET = dict(block_config=(2, 2), growth=8, bn_size=2,
                      num_init_features=16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got), dtype=torch.float64)
    want = torch.as_tensor(np.asarray(want), dtype=torch.float64)
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (b, 28, 28),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 10, b)),
            torch.ones(b, dtype=torch.bool))


def _step(case: str, mode: str, grad_accum: int = 1) -> dict:
    """One Adam step of ``case`` under ``mode`` from seed 0's weights and
    the step generator's draws (affine and dropout masks): the gradients,
    the state (parameters and BatchNorm statistics) and the loss."""
    name, attention, k5, size, b, prec = MODELS.get(
        case, (case, "full", False, 64, 4, "f32"))
    policy = F64 if prec == "f64" else PRESETS["f32"]
    model = registry.get_model(name, 10, policy, attention=attention,
                               device="cpu", pallas_dw=k5, remat=mode)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, size, policy,
                    "cpu", grad_accum=grad_accum, remat=mode)
    state = engine.init_state(torch.Generator().manual_seed(0))
    _, m = engine.train_step(state, *_batch(b),
                             torch.Generator().manual_seed(5))
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "loss": m["loss"].item(), "prec": prec}


@pytest.fixture(scope="module")
def none_steps():
    return {}


@pytest.mark.parametrize("mode", ["blocks", "full"])
@pytest.mark.parametrize("case", list(MODELS))
def test_remat_step_equals_none(case, mode, none_steps):
    if case not in none_steps:
        none_steps[case] = _step(case, "none")
    want = none_steps[case]
    got = _step(case, mode)
    tol = TOL[want["prec"]]
    assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for key, g in got["grads"].items():
        assert _rel(g, want["grads"][key]) <= tol, (case, mode, key)
    for key, v in got["state"].items():
        assert _rel(v, want["state"][key]) <= tol, (case, mode, key)


# -- against JAX's remat=blocks, f64 ------------------------------------------

def _jax_vit():
    return jax_get_model("vit", 10, half_precision=False,
                         remat="blocks").clone(dtype=jnp.float64)


def _jax_densenet():
    return JaxDenseNet(num_classes=10, dtype=jnp.float64, remat=True,
                       **SMALL_DENSENET)


@pytest.mark.parametrize("name", ["vit", "densenet"])
def test_blocks_gradients_match_jax_in_f64(name):
    size = 28 if name == "vit" else 32
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    jmodel = _jax_vit() if name == "vit" else _jax_densenet()
    with jax.enable_x64(True):
        xj = jnp.asarray(x, jnp.float64)
        variables = jax.jit(lambda x: jmodel.init(
            {"params": jax.random.PRNGKey(0)}, x, train=False))(xj)
        stats = variables.get("batch_stats", {})

        def loss(params):
            out, upd = jmodel.apply(
                {"params": params, "batch_stats": stats}, xj, train=True,
                mutable=["batch_stats"])
            return jnp.sum(out * CLASS_W), upd.get("batch_stats", {})

        (_, new_stats), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
        params, grads, new_stats = jax.tree_util.tree_map(
            np.asarray, (variables["params"], grads, new_stats))
    if name == "vit":
        model = registry.get_model("vit", 10, F64, device="cpu",
                                   remat="blocks")
        model.load_state_dict(convert.params_from_jax(params))
        want = convert.params_from_jax(grads)
    else:
        model = DenseNet(num_classes=10, dtype=torch.float64,
                         **SMALL_DENSENET)
        model.remat_blocks = True
        model.load_state_dict(convert.cnn_params_from_jax(
            params, jax.tree_util.tree_map(
                lambda v: v.astype(np.float32), stats)))
        want = convert.cnn_params_from_jax(grads, new_stats)
    model.train()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(CLASS_W)).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) | set(dict(model.named_buffers())) == set(want)
    for key, g in grads.items():
        assert _rel(g, want[key]) <= TOL_JAX, key
    for key, v in model.named_buffers():     # moved once, as flax's
        assert _rel(v, want[key]) <= TOL_JAX, key


# -- BatchNorm, grad-accum, the ring -------------------------------------------

def test_densenet_statistics_move_once_a_step():
    """densenet121 at 64 px, f32: every running statistic after one
    ``blocks`` step is the ``none`` step's, and it moved from its initial
    value (mean 0, variance 1)."""
    none, blocks = _step("densenet", "none"), _step("densenet", "blocks")
    stats = [k for k in none["state"] if "running" in k]
    assert len(stats) == 2 * 121        # 120 BatchNorms and the stem's
    for key in stats:
        assert torch.equal(blocks["state"][key], none["state"][key]), key
        start = 0.0 if key.endswith("running_mean") else 1.0
        assert not torch.all(none["state"][key] == start), key


def test_grad_accum_with_full_remat_equals_grad_accum():
    """alexnet at 64 px with its two dropouts: the masks of each
    microbatch reach its recompute."""
    plain = _step("alexnet", "none", grad_accum=2)
    full = _step("alexnet", "full", grad_accum=2)
    assert full["loss"] == plain["loss"]
    for key, v in full["state"].items():
        assert torch.equal(v, plain["state"][key]), key


def test_ring_flash_steps_under_blocks_equal_none(tmp_path):
    """Two gloo ranks, one ring at M = 2 (K4/K2p/K3p's plain versions):
    three SGD steps of the narrow vit, the recompute running the ring's
    forward again in the backward."""
    steps = []
    for i, (images, labels, valid, _key) in enumerate(_steps()):
        draws = [t.numpy() for t in augment.sample_affine_batch(
            torch.Generator().manual_seed(i), 8, 28, 28)]
        steps.append((images, labels, valid, draws))
    out = {}
    for mode in ("none", "blocks"):
        spec = dict(arch=NARROW, attention="ring_flash", seed=0,
                    params=None, steps=steps, remat=mode)
        out[mode] = _run_world(tmp_path, f"ring-{mode}", 2, "vit", spec,
                               "--model-parallel", "2")
    for r_none, r_blocks in zip(out["none"], out["blocks"]):
        assert r_blocks["metrics"] == r_none["metrics"]
        for key, v in r_blocks["state"].items():
            assert _rel(v, r_none["state"][key]) <= TOL["f32"], key


# -- refusals, names, the CLI ---------------------------------------------------

def test_bad_value_fails_as_jax():
    with pytest.raises(ValueError) as jax_err:
        jax_cli._validate_precision(JaxConfig(remat="some"))
    with pytest.raises(ValueError) as err:
        tconfig.check_ported(tconfig.Config(remat="some"))
    assert str(err.value) == str(jax_err.value) == (
        "--remat must be none|blocks|full, got 'some'")
    with pytest.raises(ValueError) as jax_err:
        jax_get_model("vit", 10, remat="some")
    with pytest.raises(ValueError) as err:
        registry.get_model("vit", 10, PRESETS["f32"], device="cpu",
                           remat="some")
    assert str(err.value) == str(jax_err.value)
    model = registry.get_model("cnn", 10, PRESETS["f32"], device="cpu")
    with pytest.raises(ValueError, match=r"^remat must be none\|blocks\|"
                                         r"full, got 'some'$"):
        Engine(model, losses.cross_entropy, MEAN, STD, 28, PRESETS["f32"],
               "cpu", remat="some")
    with pytest.raises(SystemExit):
        tconfig.config_from_argv(["train", "-d", "/d", "--remat", "some"])


def test_engine_refuses_a_model_built_for_other_blocks():
    """remat is never quietly dropped: a block model built without
    ``remat="blocks"`` cannot train under it, nor one built with it
    under another setting."""
    for built, asked in (("none", "blocks"), ("blocks", "full")):
        model = registry.get_model("vit", 10, PRESETS["f32"], device="cpu",
                                   remat=built)
        with pytest.raises(ValueError, match="give get_model the same"):
            Engine(model, losses.cross_entropy, MEAN, STD, 28,
                   PRESETS["f32"], "cpu", remat=asked)


@pytest.mark.parametrize("name", sorted(remat.REMAT_BLOCK_MODELS))
def test_parameter_names_do_not_change(name):
    keys = {mode: list(registry.get_model(
        name, 10, PRESETS["f32"], device="cpu", remat=mode).state_dict())
        for mode in ("none", "blocks", "full")}
    assert keys["blocks"] == keys["none"] == keys["full"]


@pytest.mark.parametrize("mode", ["blocks", "full"])
def test_train_under_remat_equals_none_through_the_cli(mode, tmp_path):
    def train(name, *extra):
        return tcli.run_train(tconfig.config_from_argv(
            ["train", "-d", str(tmp_path / "data"), "--rsl_path",
             str(tmp_path / name), "--dataset", "synthetic", "--debug",
             "--model", "cnn", "--device", "cpu", "-e", "1", *extra]))

    plain, got = train("none"), train(mode, "--remat", mode)
    assert got["history"][0]["train_loss"] == plain["history"][0][
        "train_loss"]
    want = plain["state"].model.state_dict()
    for key, v in got["state"].model.state_dict().items():
        assert torch.equal(v, want[key]), key


@pytest.mark.parametrize("action", ["test", "serve"])
def test_test_and_serve_take_the_flag(action):
    cfg = tconfig.config_from_argv([action, "-d", "/d", "-f", "/c.ckpt",
                                    "--device", "cpu", "--remat", "full",
                                    "--data-mode", "stream",
                                    "--prefetch", "3"])
    assert (cfg.remat, cfg.data_mode, cfg.prefetch) == ("full", "stream", 3)


def test_batchnorm_sees_the_recompute_flag_in_the_recompute_only():
    """Under ``full`` each BatchNorm of a resnet runs twice a step: in the
    forward with the flag off, in the backward's recompute with it on."""
    model = registry.get_model("resnet", 10, PRESETS["f32"], device="cpu",
                               remat="full")
    Engine(model, losses.cross_entropy, MEAN, STD, 32, PRESETS["f32"],
           "cpu", remat="full")
    seen = []
    norms = [m for m in model.modules() if type(m).__name__ == "BatchNorm"]
    for norm in norms:
        norm.register_forward_pre_hook(
            lambda module, args: seen.append(remat.recomputing()))
    model.train()
    model(torch.randn(2, 32, 32, 3)).sum().backward()
    assert seen == [False] * len(norms) + [True] * len(norms)
    assert not remat.recomputing()
