"""The switch mixture-of-experts vit (``--moe-experts``) of the port held
against the JAX package's (``models/moe.py``, the ``moe_experts`` branch
of ``models/vit.py``, the engine's sown loss), on the CPU.  Inputs are
numpy arrays from a seed; the JAX parameters come across through
``models/convert.py``.

  * ``SwitchMLP`` at E = 4 on two dispatch groups, forward and backward
    of sum(y * w) + the load-balance loss: f32 (1e-5 of the largest
    output, each gradient within 1e-4 of its largest value, the loss
    within 1e-6: the same f32 math in other summation orders), bf16 (by
    the conditioned rule of ``tests/_torch_zoo_jax.py``: no further from
    the f32 result than twice JAX's bf16 distance, or within one bf16
    rounding), and a capacity factor low enough that tokens are dropped:
    the same rows exactly 0 on both sides.
  * The MoE vit at depth 2 (width 32, 2 heads), ``full`` and ``flash``
    (the flash kernels' plain versions here) against JAX's ``full``:
    logits, one Adam step and one ``--grad-accum 2`` step (parameters
    within 1e-6) with the reported loss, which carries the sown loss,
    within 1e-5.
  * Two data ranks (``tests/_torch_ring_child.py``, one gloo world for
    every case) against the JAX step on a (data=2) mesh: 8 rows a rank,
    where JAX's one dispatch group straddles the ranks (an SGD step and
    the eval logits), the same with ``--grad-accum 2``, 16 rows a rank
    (one group a rank), and ``--attention ring --model-parallel 2`` (an
    SGD step): parameters within 1e-5, the loss within 1e-5, the eval
    logits within 1e-5.
  * The registry's and the CLI's refusals against JAX's messages; a
    checkpoint whose experts differ from ``--moe-experts`` fails with one
    line naming the flag.
  * A JAX-written MoE checkpoint: ``test -f`` equal to JAX's eval of the
    same batches, ``train -f`` resuming with the Adam moments converted,
    and a served batch equal to JAX's predict step.
"""

import functools
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.data.sampler import ShardedSampler as JaxSampler
from distributedpytorch_tpu.models import registry as jax_registry
from distributedpytorch_tpu.models.moe import SwitchMLP as JaxSwitchMLP
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import attention as jax_attention
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.parallel import make_tp_constrain
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import runtime
from distributedpytorch_tpu_torch.data.datasets import load_dataset
from distributedpytorch_tpu_torch.models import convert, registry, vit
from distributedpytorch_tpu_torch.models.moe import SwitchMLP, rows_per_group
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.ops.attention import full_attention
from distributedpytorch_tpu_torch.ops.flash_attention import flash_attention
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import (
    Engine, TrainState, make_optimizer)
from tests._subproc import REPO, await_all, free_port

sys.path.insert(0, os.path.join(REPO, "tests"))
from _torch_elastic_child import TINY_VIT  # noqa: E402

E = 4
DIM, HIDDEN = 32, 64
# 24 rows of 49 tokens: rows_per_group(24, 49) = 12, two groups of 588
MOD_SHAPE = (24, 49, DIM)
# name -> (capacity factor, dtype); 0.25 leaves 37 slots of 588 tokens
MODULE_CASES = {"f32": (1.25, "float32"), "bf16": (1.25, "bfloat16"),
                "drop": (0.25, "float32")}
MEAN, STD = 0.13, 0.31
CHILD = os.path.join(REPO, "tests", "_torch_ring_child.py")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return (got - want).abs().max().item() / max(
        want.abs().max().item(), 1e-12)


def _sown(updated) -> jax.Array:
    return sum((jnp.sum(leaf) for leaf in
                jax.tree_util.tree_leaves(updated.get("losses", {}))),
               jnp.zeros((), jnp.float32))


# -- the module ------------------------------------------------------------

@pytest.fixture(scope="module")
def module_ref():
    """The JAX ``SwitchMLP``'s output, loss and gradients for every case
    of MODULE_CASES, from one set of parameters and inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(MOD_SHAPE).astype(np.float32)
    w = rng.standard_normal(MOD_SHAPE).astype(np.float32)
    params = JaxSwitchMLP(dim=DIM, hidden=HIDDEN, num_experts=E).init(
        jax.random.PRNGKey(3), jnp.asarray(x), train=True)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(4),
                                               a.shape), params)
    out = {}
    for case, (cf, dt) in MODULE_CASES.items():
        jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
        mod = JaxSwitchMLP(dim=DIM, hidden=HIDDEN, num_experts=E,
                           capacity_factor=cf, dtype=jdt)

        def f(p, xx, mod=mod):
            y, upd = mod.apply({"params": p}, xx, train=True,
                               mutable=["losses"])
            aux = _sown(upd)
            return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x, jdt))
        out[case] = {"y": np.asarray(y, np.float32), "aux": float(aux),
                     "grads": {**convert.moe_params_from_jax(_np_tree(gp)),
                               "x": torch.from_numpy(
                                   np.array(gx, np.float32))}}
    return x, w, _np_tree(params), out


def _port_module(case, params, x, w) -> dict:
    cf, dt = MODULE_CASES[case]
    mod = SwitchMLP(DIM, HIDDEN, E, capacity_factor=cf)
    mod.load_state_dict(convert.moe_params_from_jax(params))
    xt = torch.from_numpy(x).to(getattr(torch, dt)).requires_grad_()
    y, aux = mod(xt)
    ((y.float() * torch.from_numpy(w)).sum() + aux).backward()
    grads = {n: p.grad for n, p in mod.named_parameters()}
    grads["x"] = xt.grad.float()
    return {"y": y.detach().float(), "aux": aux.item(), "grads": grads}


def test_groups_are_the_jax_groups():
    from distributedpytorch_tpu.models import moe as jax_moe

    for b, s in ((24, 49), (8, 49), (16, 49), (64, 49), (30, 49), (7, 1),
                 (20, 256)):
        assert rows_per_group(b, s) == jax_moe._rows_per_group(b, s)


@pytest.mark.parametrize("case", ["f32", "drop"])
def test_switch_mlp_f32_equals_jax(module_ref, case):
    x, w, params, ref = module_ref
    got, want = _port_module(case, params, x, w), ref[case]
    assert _rel(got["y"], want["y"]) <= 1e-5
    assert abs(got["aux"] - want["aux"]) <= 1e-6
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        assert _rel(got["grads"][name], g) <= 1e-4, name
    dropped = (got["y"] == 0).all(dim=-1)
    np.testing.assert_array_equal(dropped.numpy(),
                                  (want["y"] == 0).all(axis=-1))
    if case == "drop":          # 4 x 37 slots of 588 tokens a group
        assert int(dropped.sum()) >= 2 * (588 - 4 * 37)


def test_switch_mlp_bf16_equals_jax_by_the_conditioned_rule(module_ref):
    """bf16 against JAX's bf16: each output and gradient within one bf16
    rounding (1e-2 of its largest value) of JAX's, or no further from the
    f32 result than twice JAX's own distance."""
    x, w, params, ref = module_ref
    got, want, truth = (_port_module("bf16", params, x, w), ref["bf16"],
                        ref["f32"])
    assert abs(got["aux"] - want["aux"]) <= 1e-6     # the f32 router
    pairs = [("y", got["y"], want["y"], truth["y"])] + [
        (n, got["grads"][n], g, truth["grads"][n])
        for n, g in want["grads"].items()]
    for name, g, j, t in pairs:
        assert _rel(g, j) <= 1e-2 or _rel(g, t) <= 2 * _rel(j, t), name


# -- the model: logits, an Adam step, a --grad-accum 2 step -----------------

def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, b).astype(np.int32)
    valid = np.ones(b, bool)
    valid[-2:] = False
    return images, labels, valid


def _jax_engine(optimizer="adam", grad_accum=1, attention_fn=None,
                moe_constrain=None):
    prec = JAX_PRESETS["f32"]
    model = JaxViT(dtype=prec.compute_dtype, num_classes=10, moe_experts=E,
                   attention_fn=attention_fn, moe_constrain=moe_constrain,
                   **TINY_VIT)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, 2, False)
    return JaxEngine(model, "vit", jax_losses.cross_entropy, tx, MEAN, STD,
                     28, precision=prec, grad_accum=grad_accum)


@pytest.fixture(scope="module")
def model_ref():
    """The JAX MoE vit's eval logits, its K = 1 step's gradients, and
    after one Adam step at K = 1 and at K = 2 its parameters and loss,
    from one initial state; the K = 1 state is kept (it has Adam moments)
    for the checkpoints."""
    images, labels, valid = _batch(1)
    key = jax.random.PRNGKey(11)
    engine = _jax_engine()
    state = engine.init_state(jax.random.PRNGKey(0))
    out = {"init": state}
    imgs = jax_augment.eval_transform(jnp.asarray(images), MEAN, STD, 28)
    out["logits"] = np.asarray(jax.jit(functools.partial(
        engine.model.apply, train=False))({"params": state.params}, imgs))
    timgs = jax.jit(jax_augment.train_transform, static_argnums=(4,))(
        key, jnp.asarray(images), MEAN, STD, 28)
    vmask = jnp.asarray(valid, jnp.float32)
    grads, new_bs, loss, correct = jax.jit(engine._grads_and_metrics)(
        state, timgs, jnp.asarray(labels), vmask, None)
    out["grads"] = convert.params_from_jax(_np_tree(grads))
    new, m = jax.jit(engine._finish_step)(state, grads, new_bs, loss,
                                          correct, vmask)
    out[1] = (convert.params_from_jax(_np_tree(new.params)),
              float(m["loss"]))
    out["stepped"] = (engine, new)
    accum = _jax_engine(grad_accum=2)
    new, m = jax.jit(accum._train_step_keys)(
        state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(valid),
        key, key)
    out[2] = (convert.params_from_jax(_np_tree(new.params)),
              float(m["loss"]))
    draws = [torch.from_numpy(np.array(a)) for a in
             jax_augment._sample_affine_batch(key, 8, 28, 28)]
    return out, (images, labels, valid), draws


def _port_engine(jax_params, attention, grad_accum=1):
    policy = PRESETS["f32"]
    model = vit.ViT(dtype=policy.compute_dtype, device="cpu",
                    attention_fn=(flash_attention if attention == "flash"
                                  else full_attention),
                    moe_experts=E, **TINY_VIT)
    model.load_state_dict(convert.params_from_jax(_np_tree(jax_params)))
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, policy,
                    "cpu", optimizer="adam", steps_per_epoch=2,
                    grad_accum=grad_accum)
    return engine, TrainState(model, make_optimizer("adam", model))


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_moe_vit_logits_equal_jax(model_ref, attention):
    ref, (images, _, _), _ = model_ref
    engine, state = _port_engine(ref["init"].params, attention)
    from distributedpytorch_tpu_torch.data import augment

    state.model.eval()
    with torch.no_grad():
        logits = state.model(augment.eval_transform(
            torch.from_numpy(images), MEAN, STD, 28))
    assert isinstance(logits, torch.Tensor)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("k", [1, 2], ids=["step", "grad_accum2"])
@pytest.mark.parametrize("attention", ["full", "flash"])
def test_moe_vit_adam_step_equals_jax(model_ref, attention, k):
    """One Adam step (and one of --grad-accum 2, the sown loss weighted by
    each microbatch's denominator) from JAX's initial state: the reported
    loss within 1e-5; at K = 1 every gradient (the sown loss's included)
    within 1e-4 of its largest value; every parameter within 1e-6, but
    where the step's gradient is below that 1e-4 of its largest (the key
    bias, whose exact gradient is 0, is rounding noise), which Adam's
    first step scales to up to its learning rate: there within 1e-3."""
    ref, (images, labels, valid), draws = model_ref
    engine, state = _port_engine(ref["init"].params, attention, k)
    init = {n: p.detach().clone()
            for n, p in state.model.named_parameters()}
    _, m = engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.from_numpy(valid), tuple(draws))
    want, loss = ref[k]
    assert abs(m["loss"].item() - loss) <= 1e-5
    got = state.model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g = state.model.get_parameter(name).grad
        if k == 1:
            assert _rel(g, ref["grads"][name]) <= 1e-4, name
        noise = g.abs() <= 1e-4 * g.abs().max()
        delta = (got[name] - w).abs()
        assert delta[~noise].max().item() <= 1e-6, name
        assert delta[noise].max().item() <= 1e-3 if noise.any() else True
        assert (got[name] - init[name]).abs().max().item() <= 1.01e-3


def test_reported_loss_carries_the_sown_loss(model_ref):
    """JAX's K = 1 loss is the masked mean plus the blocks' sown loss
    (about 0.01 x E x 1 a block): the port's train-mode forward returns
    its logits and the sown loss, whose sum is JAX's loss within 1e-5."""
    ref, (images, labels, valid), draws = model_ref
    engine, state = _port_engine(ref["init"].params, "full")
    from distributedpytorch_tpu_torch.data import augment

    state.model.train()
    out = state.model(augment.train_transform(
        torch.from_numpy(images), MEAN, STD, 28, tuple(draws)))
    assert set(out) == {"logits", "sown"}
    assert 0.02 <= out["sown"].item() <= 0.2
    numer, denom = losses.cross_entropy(out["logits"],
                                        torch.from_numpy(labels).long())
    vm = torch.from_numpy(valid).float()
    ce = ((numer * vm).sum() / (denom * vm).sum()).item()
    assert abs(ce + out["sown"].item() - ref[1][1]) <= 1e-5


def test_remat_blocks_saves_the_router_and_recomputes_the_experts(
        model_ref):
    """``--remat blocks`` keeps the outputs of ``mm``/``addmm`` (the
    router's, the dense layers') and recomputes batched products, as JAX's
    ``dots_with_no_batch_dims_saveable``: a MoE layer's router is one
    ``mm`` and its dispatch, two expert and combine products are four
    ``bmm``; the step under it equals the plain step bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func)
            return func(*args, **(kwargs or {}))

    mod = SwitchMLP(DIM, HIDDEN, E)
    with Ops() as ops:
        mod(torch.zeros(2, 49, DIM))
    count = {f: ops.seen.count(f) for f in (torch.ops.aten.mm.default,
                                            torch.ops.aten.bmm.default)}
    assert count == {torch.ops.aten.mm.default: 1,
                     torch.ops.aten.bmm.default: 4}
    ref, (images, labels, valid), draws = model_ref
    grads = {}
    for remat in ("none", "blocks"):
        engine, state = _port_engine(ref["init"].params, "full")
        state.model.remat_blocks = remat == "blocks"
        engine.remat = remat
        _, m = engine.train_step_affine(
            state, torch.from_numpy(images),
            torch.from_numpy(labels).long(), torch.from_numpy(valid),
            tuple(draws))
        grads[remat] = {n: p.grad.clone()
                        for n, p in state.model.named_parameters()}
    for name, g in grads["none"].items():
        assert torch.equal(grads["blocks"][name], g), name


# -- refusals ----------------------------------------------------------------

def _jax_error(**kwargs) -> str:
    with pytest.raises(ValueError) as e:
        jax_registry.get_model(num_classes=10, **kwargs)
    return str(e.value)


def test_registry_refuses_as_jax():
    f32 = PRESETS["f32"]
    jmesh = jax_runtime.make_mesh(data_parallel=1, model_parallel=2,
                                  devices=jax.devices()[:2])
    mesh = runtime.Mesh(1, 2, 0, 0, (0, 1))
    cases = [(dict(name="cnn", moe_experts=4), {}),
             (dict(name="vit", moe_experts=1), {}),
             (dict(name="vit", moe_experts=-2), {}),
             (dict(name="cnn", moe_experts=4, pallas_dw=True), {}),
             (dict(name="vit", moe_experts=3, mesh=jmesh), dict(mesh=mesh)),
             (dict(name="vit", moe_experts=3, mesh=jmesh, attention="ring"),
              dict(mesh=mesh, attention="ring")),
             # exclusive with the pipeline, as with tensor parallelism
             (dict(name="vit", moe_experts=4, mesh=jmesh,
                   pipeline_parallel=True),
              dict(mesh=mesh, pipeline_parallel=True))]
    for jax_kw, port_kw in cases:
        message = _jax_error(**jax_kw)
        kw = {**{k: v for k, v in jax_kw.items() if k != "mesh"}, **port_kw}
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            registry.get_model(num_classes=10, precision=f32, device="meta",
                               **kw)
    model = registry.get_model("vit", 10, f32, device="meta", moe_experts=4,
                               mesh=mesh, attention="ring")
    assert model.blocks[0].moe.num_experts == 4


def _train_argv(tmp_path, *extra):
    return ["train", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "rsl"), "--device", "cpu", "--debug",
            "--synthetic-fallback", "--dataset", "synthetic", *extra]


@pytest.mark.parametrize("model,e", [("cnn", 4), ("vit", 1)])
def test_cli_refuses_as_jax_before_the_dataset(tmp_path, model, e):
    argv = _train_argv(tmp_path, "--model", model, "--moe-experts", str(e))
    assert tcli.main(argv) == 1
    assert not os.path.exists(tmp_path / "data")
    cfg = tconfig.config_from_argv(argv)
    with pytest.raises(ValueError, match="^" + re.escape(
            "--moe-experts needs --model vit, E >= 2, and is exclusive "
            "with --tensor-parallel/--pipeline-parallel; got "
            f"model={model!r}, moe_experts={e}, tensor_parallel=False, "
            "pipeline_parallel=False") + "$"):
        tconfig.check_moe(cfg, model)
    cfg = tconfig.config_from_argv(_train_argv(
        tmp_path, "--model", "vit", "--moe-experts", "3", "--attention",
        "ring", "--model-parallel", "2"))
    with pytest.raises(ValueError, match="^" + re.escape(
            "--moe-experts 3 must be divisible by --model-parallel 2 for "
            "expert parallelism (each device holds E/mp experts)") + "$"):
        tconfig.check_moe(cfg, "vit")


def test_a_checkpoint_of_other_experts_fails_naming_the_flag(tmp_path):
    f32 = PRESETS["f32"]
    models = {e: registry.get_model("vit", 10, f32, device="cpu",
                                    moe_experts=e) for e in (0, 4, 8)}
    path = str(tmp_path / "moe.ckpt")
    tckpt.save_checkpoint(path, "vit", models[4], 0, 1.0)
    dense = str(tmp_path / "dense.ckpt")
    tckpt.save_checkpoint(dense, "vit", models[0], 0, 1.0)
    for file, e, want in ((path, 0, "holds 4-expert mixture-of-experts "
                           "blocks, the requested model dense MLPs"),
                          (path, 8, "holds 4-expert mixture-of-experts "
                           "blocks, the requested model 8-expert"),
                          (dense, 4, "holds dense MLPs, the requested "
                           "model 4-expert")):
        with pytest.raises(ValueError) as err:
            tckpt.restore_for_serving(file, models[e])
        text = str(err.value)
        assert want in text and "--moe-experts" in text \
            and "\n" not in text
    tckpt.restore_for_serving(path, models[4])


# -- JAX-written MoE checkpoints ---------------------------------------------

@pytest.fixture(scope="module")
def jax_file(model_ref, tmp_path_factory):
    """model_ref's stepped JAX state (Adam moments non-zero) as a JAX
    msgpack checkpoint, and the corpus the CLI runs read."""
    ref, _, _ = model_ref
    engine, state = ref["stepped"]
    work = tmp_path_factory.mktemp("jaxmoe")
    path = str(work / "checkpoint-synthetic-vit-000.ckpt")
    jax_ckpt.save_checkpoint(path, "vit", state, 0, 2.5)
    data = str(work / "data")
    ds = load_dataset("synthetic", data, 1234, debug=True,
                      synthetic_fallback=True)
    return engine, state, path, data, ds


def _on_corpus(engine, ds):
    """``engine`` normalising with the corpus's mean and std, as the CLI
    runs do."""
    return JaxEngine(engine.model, "vit", jax_losses.cross_entropy,
                     engine.tx, ds.mean, ds.std, 28,
                     precision=JAX_PRESETS["f32"])


@pytest.fixture
def tiny_vit(monkeypatch):
    monkeypatch.setattr(vit.ViT, "__init__", functools.partialmethod(
        vit.ViT.__init__, **TINY_VIT))


def _cli_args(data, rsl, *extra):
    return ["-d", data, "--rsl_path", rsl, "--dataset", "synthetic",
            "--synthetic-fallback", "--debug", "--device", "cpu",
            "--precision", "f32", "--moe-experts", str(E), "-b", "16",
            *extra]


def test_test_on_a_jax_moe_file_equals_jax_eval(jax_file, tiny_vit,
                                                tmp_path):
    engine, state, path, data, ds = jax_file
    split = ds.splits["test"]
    idx, valid = (a.reshape(-1) for a in JaxSampler(
        len(split.labels), 1, 0, 16, shuffle=False).epoch_indices(0))
    step = jax.jit(_on_corpus(engine, ds)._eval_step)
    numer = denom = 0.0
    for i in range(0, len(idx), 16):
        rows = idx[i:i + 16]
        s = step(state, jnp.asarray(split.images[rows]),
                 jnp.asarray(split.labels[rows]),
                 jnp.asarray(valid[i:i + 16]))
        numer += float(s["loss_numer"])
        denom += float(s["loss_denom"])
    cfg = tconfig.config_from_argv(["test", *_cli_args(
        data, str(tmp_path / "rsl"), "-f", path)])
    got = tcli.run_test(cfg)
    assert got["model_name"] == "vit"
    assert abs(got["test_loss"] - numer / denom) <= 1e-5


def test_train_resumes_a_jax_moe_file_with_its_adam_moments(jax_file,
                                                            tiny_vit,
                                                            tmp_path):
    engine, state, path, data, _ = jax_file
    model = registry.get_model("vit", 10, PRESETS["f32"], device="cpu",
                               moe_experts=E)
    opt = make_optimizer("adam", model)
    epoch, _, step = tckpt.load_checkpoint(path, model, opt)
    assert (epoch, step) == (1, 1)
    adam = state.opt_state[0]
    mu = convert.params_from_jax(_np_tree(adam.mu))
    nu = convert.params_from_jax(_np_tree(adam.nu))
    names = {p: n for n, p in model.named_parameters()}
    moe = [n for n in names.values() if ".moe." in n]
    assert len(moe) == 2 * 6
    for p, name in names.items():
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert st["step"].item() == 1.0
    assert any(mu[n].abs().max() > 0 for n in moe)
    rsl = str(tmp_path / "rsl")
    assert tcli.main(["train", *_cli_args(data, rsl, "-f", path, "-e",
                                          "2")]) == 0
    log = open(os.path.join(rsl, "test.log")).read()
    assert "Epoch: 002" in log and "Epoch: 001" not in log


def test_serve_on_a_jax_moe_file_equals_jax_predict(jax_file, tiny_vit):
    engine, state, path, data, ds = jax_file
    images = ds.splits["test"].images[:4]
    cfg = tconfig.config_from_argv(["serve", "-f", path, *_cli_args(
        data, data)[:-2]])
    infer = tcli._serve_build_replica(cfg, path, "vit", ds, (4,),
                                      images.shape[1:], images.dtype,
                                      torch.device("cpu"))
    labels, confs = infer(images)
    want_labels, want_confs = jax.jit(_on_corpus(engine, ds)._predict_step)(
        state, jnp.asarray(images))
    np.testing.assert_array_equal(labels, np.asarray(want_labels))
    np.testing.assert_allclose(confs, np.asarray(want_confs), atol=1e-5,
                               rtol=0)


# -- two data ranks against the JAX mesh step --------------------------------

# name -> (rows a data rank, --grad-accum, model_parallel, attention, steps)
WORLD_CASES = {"straddle": (8, 1, 1, "full", 1),
               "straddle_accum": (8, 2, 1, "full", 1),
               "rank_local": (16, 1, 1, "full", 1),
               "ring_model2": (8, 1, 2, "ring", 1)}
_draws = jax.jit(jax_augment._sample_affine_batch, static_argnums=(1, 2, 3))


def _world_inputs(rows, mp, n, seed):
    """The case's global batches (two rows masked) with their JAX keys
    and affine draws, and a further global batch for the eval logits."""
    rows_global = rows * 2 // mp
    steps = []
    for i in range(n):
        images, labels, valid = _batch(seed + i, rows_global)
        valid[:] = True
        valid[[1, rows_global - 3]] = False
        key = jax.random.PRNGKey(300 + i)
        steps.append((images, labels, valid, key,
                      [np.asarray(a) for a in _draws(key, rows_global, 28,
                                                     28)]))
    return steps, _batch(seed + 50, rows_global)[0]


def _jax_world_case(state, rows, k, mp, attention, steps, evals):
    """The JAX step on the case's (data, model) mesh from ``state``: SGD
    steps on the global batches, then the eval logits of ``evals`` (None:
    none)."""
    mesh = jax_runtime.make_mesh(data_parallel=2 // mp, model_parallel=mp,
                                 devices=jax.devices()[:2])
    fn = constrain = None
    if attention == "ring":
        fn = jax_attention.make_ring_attention(mesh)
        constrain = make_tp_constrain(mesh)
    engine = _jax_engine("SGD", k, fn, constrain)
    put = functools.partial(jax.device_put, device=NamedSharding(
        mesh, P(jax_runtime.DATA_AXIS)))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    step = jax.jit(engine._train_step_keys)
    metrics = []
    for images, labels, valid, key, _ in steps:
        state, m = step(state, put(jnp.asarray(images)),
                        put(jnp.asarray(labels)), put(jnp.asarray(valid)),
                        key, key)
        metrics.append([float(m["loss"]), float(m["correct"]),
                        float(m["valid"])])
    logits = None if evals is None else np.asarray(jax.jit(
        functools.partial(engine.model.apply, train=False))(
            {"params": state.params},
            jax_augment.eval_transform(put(jnp.asarray(evals)), MEAN, STD,
                                       28)))
    return (convert.params_from_jax(_np_tree(state.params)), metrics,
            logits)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 2-rank gloo world of ``tests/_torch_ring_child.py`` running
    every case of WORLD_CASES from one initial state, and, while it runs,
    the JAX references."""
    import subprocess

    state = _jax_engine("SGD").init_state(jax.random.PRNGKey(5))
    init = {k: v.numpy() for k, v in convert.params_from_jax(
        _np_tree(state.params)).items()}
    specs, inputs = [], {}
    for i, (name, (rows, k, mp, attention, n)) in enumerate(
            WORLD_CASES.items()):
        steps, evals = _world_inputs(rows, mp, n, 40 + 10 * i)
        if mp > 1:
            evals = None        # the data cases hold the eval step
        inputs[name] = steps, evals
        specs.append(dict(
            arch=dict(TINY_VIT, moe_experts=E), attention=attention, seed=0,
            params=init, steps=[(im, lb, vd, dr) for im, lb, vd, _, dr
                                in steps],
            grad_accum=k, model_parallel=mp, eval=evals, mean=MEAN,
            std=STD))
    work = tmp_path_factory.mktemp("moeworld")
    inp = str(work / "in.pt")
    torch.save(specs, inp)
    master = str(free_port())
    procs, logs, outs = [], [], []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE",
                            "XLA_FLAGS")}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=master)
        outs.append(str(work / f"r{rank}.pt"))
        logs.append(str(work / f"r{rank}.log"))
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, "vit", inp, outs[-1],
                 "--model-parallel", "1"], cwd=REPO, env=env, stdout=out,
                stderr=out))
    try:
        refs = {name: _jax_world_case(state, *case[:4], *inputs[name])
                for name, case in WORLD_CASES.items()}
    finally:
        await_all(procs, logs, timeout=240.0)
    got = [torch.load(o, weights_only=False) for o in outs]
    return {name: ([r[i] for r in got], refs[name])
            for i, name in enumerate(WORLD_CASES)}


@pytest.mark.parametrize("name", list(WORLD_CASES))
def test_two_ranks_equal_the_jax_mesh_step(world, name):
    """Parameters after the step within 1e-5 of JAX's (and equal on both
    ranks), its loss within 1e-5 with its counts equal, and on the data
    ranks the eval logits of the global batch within 1e-5."""
    ranks, (want, metrics, logits) = world[name]
    rows, _, mp, _, _ = WORLD_CASES[name]
    assert [(r["data_index"], r["model_index"]) for r in ranks] == (
        [(0, 0), (1, 0)] if mp == 1 else [(0, 0), (0, 1)])
    groups = rows_per_group(rows * 2 // mp, 49)
    assert (groups > rows) == name.startswith("straddle")
    for r in ranks:
        for key, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][key]), key
        for (loss, correct, valid), (jl, jc, jv) in zip(r["metrics"],
                                                        metrics):
            assert abs(loss - jl) <= 1e-5
            assert (correct, valid) == (jc, jv)
    for key, w in want.items():
        np.testing.assert_allclose(ranks[0]["state"][key].numpy(),
                                   w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=key)
    if logits is not None:
        shards = [r["eval_logits"] for r in ranks if r["model_index"] == 0]
        np.testing.assert_allclose(np.concatenate(shards), logits,
                                   atol=1e-5, rtol=0)
