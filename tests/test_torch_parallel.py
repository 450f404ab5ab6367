"""Placement over the 'model' axis (``--model-parallel``), tensor
parallelism (``--tensor-parallel``) and expert parallelism of the port
(``distributedpytorch_tpu_torch/parallel.py``), held against the JAX
package's (``parallel.py``, the vit's ``tp_constrain``, the MoE vit's
``moe_constrain``) on the CPU.  Inputs are numpy arrays from a seed; the
JAX parameters come across through ``models/convert.py``.

  * The placement rule: ``leaf_spec`` against JAX's on seeded shapes, and
    for vit, the MoE vit (E = 4), mlp, cnn and resnet18 at their full
    widths, every parameter's per-rank element count (so the set of
    sharded tensors) equal to the shard shape of JAX's
    ``state_sharding`` on a model axis of 2; no buffer is sharded.
  * One 4-rank gloo world (data 2 x model 2) of
    ``tests/_torch_ring_child.py`` holding the world's stages, beside
    the JAX steps on the (2, 2) mesh with the state placed by
    ``state_sharding``: a vit of width 64 (its MLP's tensors sharded,
    attention's not) with ``--attention flash`` (the kernels' plain
    versions here) against JAX's ``full``, 3 SGD steps within 1e-5 of
    JAX and within 1e-6 of the port's replicated world (data 4), Adam
    within 1e-4 of JAX, ``--grad-accum 2`` under ``--remat blocks``, the
    MoE vit (E = 4, expert parallel) with its sown loss, an f16 step
    overflowing on one model rank skipped on all four; a rank's
    parameter and optimizer elements; the placed run's checkpoint read
    in one process equal to the replicated run's; a 1-rank file and a
    JAX file written from a (2, 2)-placed state resumed at M = 2 equal
    to their 1-process resume.
  * One 2-rank world (data 1 x model 2): the Megatron vit's logits
    within 2e-5 of JAX's tensor-parallel logits, 3 SGD steps within 1e-5
    of JAX's, and the bytes a rank's forward saves for the backward at
    least 25% below one process's (JAX's test_tensor_parallel bound).
  * JAX's errors, word for word: --tensor-parallel on resnet, without a
    model axis, with a ring, with --moe-experts (registry and CLI).
"""

import functools
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu import parallel as jax_parallel
from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models import registry as jax_registry
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.parallel import make_tp_constrain
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import parallel, runtime
from distributedpytorch_tpu_torch.models import convert, registry, vit
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine
from tests._subproc import REPO, await_all, free_port

sys.path.insert(0, os.path.join(REPO, "tests"))
from _torch_ring_child import saved_bytes  # noqa: E402

CHILD = os.path.join(REPO, "tests", "_torch_ring_child.py")
MEAN, STD = 0.13, 0.31
# width 64: mlp_up and mlp_down (16384 elements) are sharded, qkv
# (12288) and proj stay whole
ARCH = dict(dim=64, depth=2, heads=2)
E = 4
FULL = PRESETS["f32"]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _fake_mesh(m: int = 0) -> runtime.Mesh:
    """A model axis of 2 with no process groups: enough to split."""
    return runtime.Mesh(1, 2, 0, m, (0, 1))


# -- the placement rule --------------------------------------------------

_rng = np.random.default_rng(0)
SHAPES = [tuple(int(d) for d in _rng.choice([1, 2, 3, 5, 6, 8, 64, 96, 128,
                                             512], size=n))
          for n in (1, 2, 2, 3, 4, 4, 2, 3)] + [(128, 128), (3, 7, 1024)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_leaf_spec_is_jaxs(shape):
    for mp in (1, 2, 3, 4):
        for axis0 in (False, True):     # True: the pipeline's placement
            spec = jax_parallel.leaf_spec(shape, mp, prefer_axis0=axis0)
            want = next((i for i, a in enumerate(spec) if a is not None),
                        None)
            assert parallel.leaf_spec(shape, mp, prefer_axis0=axis0) == \
                want, (shape, mp, axis0)


def _jax_params(name: str, moe: int = 0):
    """The JAX model's params and batch_stats at its input size, as
    zero numpy arrays of their shapes (only shapes matter here)."""
    model = jax_registry.get_model(name, 10, moe_experts=moe)
    size = jax_registry.get_model_input_size(name)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("name,moe", [("vit", 0), ("vit", E), ("mlp", 0),
                                      ("cnn", 0), ("resnet", 0)],
                         ids=["vit", "moe_vit", "mlp", "cnn", "resnet18"])
def test_per_rank_elements_are_jaxs_state_sharding(name, moe):
    """Each parameter's elements on a rank of a model axis of 2 equal
    JAX's shard shape under ``state_sharding``: each JAX leaf filled with
    its shard's element count goes through ``models/convert.py`` to the
    port's names.  JAX shards no batch statistic, and the port places no
    buffer."""
    tree = _jax_params(name, moe)
    mesh = jax_runtime.make_mesh(model_parallel=2, devices=jax.devices()[:2])
    sharding = jax_parallel.state_sharding(tree, mesh)
    counts = jax.tree_util.tree_map(
        lambda leaf, sh: np.full(leaf.shape, math.prod(
            sh.shard_shape(leaf.shape)), np.float32), tree, sharding)
    stats = counts.get("batch_stats", {})
    assert all(v.size == 0 or v.flat[0] == v.size
               for v in jax.tree_util.tree_leaves(stats))
    if name == "vit":
        want = convert.params_from_jax(counts["params"])
    else:
        want = convert.cnn_params_from_jax(counts["params"], stats or None)
    model = registry.get_model(name, 10, FULL, device="meta",
                               mesh=_fake_mesh(), moe_experts=moe)
    parallel.place(model, _fake_mesh())
    got = {k: p.numel() for k, p in model.named_parameters()}
    assert got == {k: int(want[k].flatten()[0]) for k in got}
    sharded = [k for k in got if got[k] < want[k].numel()]
    assert sharded == sorted(parallel.placement_of(model).shards,
                             key=list(got).index)
    assert sharded, "nothing sharded at the model's full width"
    if moe:
        assert got["blocks.0.moe.w_up"] == \
            want["blocks.0.moe.w_up"].numel() // 2
        assert parallel.placement_of(model).shards[
            "blocks.0.moe.w_up"] == parallel.Shard(0, False)
    assert {k for k, _ in model.named_buffers()}.isdisjoint(sharded)


def test_take_and_join_cross_the_qkv_layout():
    """The Megatron qkv slices: rank m takes heads m of each of q, k and
    v; joining the two ranks' slices gives the whole back."""
    full = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(24, 2)
    shard = {"w": parallel.Shard(0, False, groups=3)}
    parts = [parallel.Placement(_fake_mesh(m), shard).take("w", full)
             for m in (0, 1)]
    assert parts[0][:, 0].tolist() == [0, 2, 4, 6, 16, 18, 20, 22, 32, 34,
                                       36, 38]
    joined = torch.stack([p.unflatten(0, (3, -1)) for p in parts], 1)
    assert torch.equal(joined.flatten(0, 2), full)


# -- the worlds --------------------------------------------------------

_draws = jax.jit(jax_augment._sample_affine_batch, static_argnums=(1, 2, 3))


def _steps(n: int, rows: int, seed: int):
    """``n`` global batches of ``rows`` (two rows masked in each) with
    their JAX keys and affine draws."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        valid = np.ones(rows, bool)
        valid[[1, rows - 3]] = False
        key = jax.random.PRNGKey(seed + i)
        out.append((rng.integers(0, 256, (rows, 28, 28), dtype=np.uint8),
                    rng.integers(0, 10, rows).astype(np.int32), valid, key,
                    [np.asarray(a) for a in _draws(key, rows, 28, 28)]))
    return out


def _jax_engine(optimizer="SGD", k=1, tp=None, moe=0, ep=None,
                precision="f32"):
    prec = JAX_PRESETS[precision]
    model = JaxViT(dtype=prec.compute_dtype, num_classes=10,
                   tp_constrain=tp, moe_experts=moe, moe_constrain=ep,
                   **ARCH)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, 2, False)
    return JaxEngine(model, "vit", jax_losses.cross_entropy, tx, MEAN, STD,
                     28, precision=prec, grad_accum=k)


def _jax_mesh(dp: int, mp: int):
    return jax_runtime.make_mesh(data_parallel=dp, model_parallel=mp,
                                 devices=jax.devices()[:dp * mp])


def _jax_run(engine, state, mesh, steps, evals=None):
    """SGD/Adam steps on ``mesh`` from ``state`` placed by JAX's
    ``state_sharding`` (``_place_state``), then eval logits."""
    put = functools.partial(jax.device_put, device=NamedSharding(
        mesh, P(jax_runtime.DATA_AXIS)))
    state = jax.device_put(state, jax_parallel.state_sharding(state, mesh))
    logits = None
    if evals is not None:
        logits = np.asarray(jax.jit(functools.partial(
            engine.model.apply, train=False))(
                {"params": state.params},
                jax_augment.eval_transform(put(jnp.asarray(evals)), MEAN,
                                           STD, 28)))
    step = jax.jit(engine._train_step_keys)
    losses_ = []
    for images, labels, valid, key, _ in steps:
        state, m = step(state, put(jnp.asarray(images)),
                        put(jnp.asarray(labels)), put(jnp.asarray(valid)),
                        key, key)
        losses_.append(float(m["loss"]))
    return convert.params_from_jax(_np_tree(state.params)), losses_, logits


def _spec(init, steps, **kw):
    return dict(arch=dict(ARCH), attention="flash", seed=0, params=init,
                steps=[(im, lb, vd, dr) for im, lb, vd, _, dr in steps],
                mean=MEAN, std=STD, **kw)


def _launch(work, tag, specs, world, mp):
    inp = os.path.join(work, f"{tag}-in.pt")
    torch.save(specs, inp)
    master = str(free_port())
    procs, logs, outs = [], [], []
    for rank in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE",
                            "XLA_FLAGS")}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=master)
        outs.append(os.path.join(work, f"{tag}-r{rank}.pt"))
        logs.append(os.path.join(work, f"{tag}-r{rank}.log"))
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, "vit", inp, outs[-1],
                 "--model-parallel", str(mp)], cwd=REPO, env=env,
                stdout=out, stderr=out))
    return procs, logs, outs


def _one_process_file(path: str, init: dict) -> None:
    """A 1-rank port checkpoint of the vit after one local Adam step
    (moments not zero)."""
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, FULL, "cpu",
                    optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(3))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in init.items()})
    images, labels, valid, _, draws = _steps(1, 8, 900)[0]
    engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.tensor(valid), tuple(map(torch.tensor, draws)))
    tckpt.save_checkpoint(path, "vit", model, 0, 1.0, state.optimizer,
                          state.step, state.updates)


def _jax_file(path: str, engine, state, mesh) -> None:
    """A JAX checkpoint of ``state`` with random Adam moments, placed by
    ``state_sharding`` on ``mesh`` first (JAX writes whole arrays)."""
    leaves, tree = jax.tree_util.tree_flatten(state.opt_state)
    rng = np.random.default_rng(7)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)), x.dtype)
              if np.ndim(x) else x for x in leaves]
    state = state.replace(opt_state=jax.tree_util.tree_unflatten(
        tree, leaves))
    state = jax.device_put(state, jax_parallel.state_sharding(state, mesh))
    jax_ckpt.save_checkpoint(path, "vit", state, 0, 2.5)


# name -> (model_parallel, spec extras); the steps and the JAX reference
# of each are set in ``worlds``
WORLD4 = {
    "zero_sgd": (2, {}), "repl_sgd": (1, {}),
    "zero_adam": (2, {"optimizer": "adam"}),
    "repl_adam": (1, {"optimizer": "adam"}),
    "zero_accum": (2, {"grad_accum": 2, "remat": "blocks"}),
    "moe_zero": (2, {"moe": True}), "moe_repl": (1, {"moe": True}),
    "f16_zero": (2, {"precision": "f16", "overflow": (0, 1)}),
    "f16_repl": (1, {"precision": "f16", "overflow": (0, 1)}),
    "resume_port": (2, {"optimizer": "adam"}),
    "resume_jax": (2, {"optimizer": "adam"}),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 4-rank world's and the 2-rank world's results beside the JAX
    references, computed while the worlds run."""
    work = str(tmp_path_factory.mktemp("parallel"))
    base = _jax_engine()
    state = base.init_state(jax.random.PRNGKey(5))
    init = {k: v.numpy() for k, v in convert.params_from_jax(
        _np_tree(state.params)).items()}
    moe_state = _jax_engine(moe=E).init_state(jax.random.PRNGKey(6))
    moe_init = {k: v.numpy() for k, v in convert.params_from_jax(
        _np_tree(moe_state.params)).items()}
    files = {"resume_port": os.path.join(work, "one.ckpt"),
             "resume_jax": os.path.join(work, "jax.ckpt"),
             "zero_adam": os.path.join(work, "zero.ckpt"),
             "repl_adam": os.path.join(work, "repl.ckpt")}
    _one_process_file(files["resume_port"], init)
    adam = _jax_engine("adam")
    _jax_file(files["resume_jax"], adam, adam.init_state(
        jax.random.PRNGKey(8)), _jax_mesh(2, 2))
    steps = _steps(3, 8, 100)
    specs = []
    for name, (mp, extra) in WORLD4.items():
        extra = dict(extra)
        spec = _spec(moe_init if extra.pop("moe", False) else init,
                     [] if name.startswith("resume") else
                     steps[:2] if name.startswith("f16") else steps,
                     model_parallel=mp, **extra)
        if spec["params"] is moe_init:
            spec["arch"]["moe_experts"] = E
        if name in files:
            spec["resume" if name.startswith("resume") else "ckpt"] = \
                files[name]
        specs.append(spec)
    running = [_launch(work, "w4", specs, 4, 2)]
    tp_steps = _steps(3, 8, 200)
    evals = tp_steps[0][0]
    tp_arch = dict(ARCH, tensor_parallel=True)
    specs2 = [dict(_spec(init, [], eval=evals), arch=tp_arch,
                   attention="full"),
              dict(_spec(init, tp_steps, saved_bytes=True), arch=tp_arch,
                   attention="full")]
    running.append(_launch(work, "w2", specs2, 2, 2))
    try:
        mesh4, mesh2 = _jax_mesh(2, 2), _jax_mesh(1, 2)
        refs = {
            "sgd": _jax_run(base, state, mesh4, steps),
            "adam": _jax_run(adam, adam.init_state(jax.random.PRNGKey(5)),
                             mesh4, steps),
            "moe": _jax_run(_jax_engine(moe=E, ep=make_tp_constrain(mesh4)),
                            moe_state, mesh4, steps),
            "tp": _jax_run(_jax_engine(tp=make_tp_constrain(mesh2)), state,
                           mesh2, tp_steps, evals)}
    finally:
        for procs, logs, _ in running:
            await_all(procs, logs, timeout=300.0)
    w4 = [torch.load(o, weights_only=False) for o in running[0][2]]
    w2 = [torch.load(o, weights_only=False) for o in running[1][2]]
    return {"w4": {name: [r[i] for r in w4]
                   for i, name in enumerate(WORLD4)},
            "w2": [[r[i] for r in w2] for i in range(2)],
            "refs": refs, "files": files, "init": init, "steps": tp_steps}


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k


def _close(got: dict, want: dict, atol: float):
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=k)


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k].double() - b[k].double()).abs().max().item()
               for k in a)


def _adam_view(state: dict) -> dict:
    """``state`` without the key part of each qkv bias.  Its gradient is
    zero in exact arithmetic (a per-query constant in the scores, which
    the softmax drops), and Adam turns the rounding left there (1e-10)
    into steps of +-lr, so any two summation orders differ there by up to
    steps x lr."""
    dim = ARCH["dim"]
    return {k: (torch.cat([v[:dim], v[2 * dim:]])
                if k.endswith("qkv.bias") else v) for k, v in state.items()}


@pytest.mark.parametrize("name,ref,tol", [
    ("zero_sgd", "sgd", 1e-5), ("zero_adam", "adam", 1e-4),
    ("zero_accum", "sgd", 1e-5), ("moe_zero", "moe", 1e-5)])
def test_placed_steps_equal_the_jax_mesh_step(worlds, name, ref, tol):
    """Parameters after the steps within ``tol`` of JAX's on the placed
    (2, 2) mesh (equal on the four ranks), the reported loss (the sown
    loss included for the MoE vit) within 1e-5.  ``--grad-accum 2`` is
    held to JAX's K = 1 step: the vit has no BatchNorm and no dropout,
    so two microbatches' numerators over the global denominator are the
    whole batch's gradient."""
    ranks = worlds["w4"][name]
    want, jax_losses_, _ = worlds["refs"][ref]
    assert [(r["data_index"], r["model_index"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    _same_on_every_rank(ranks)
    got = ranks[0]["state"]
    if ref == "adam":
        got, want = _adam_view(got), _adam_view(want)
    _close(got, want, tol)
    for (loss, _, _), jl in zip(ranks[0]["metrics"], jax_losses_):
        assert abs(loss - jl) <= 1e-5


@pytest.mark.parametrize("zero,repl", [("zero_sgd", "repl_sgd"),
                                       ("zero_adam", "repl_adam"),
                                       ("moe_zero", "moe_repl")])
def test_placed_world_equals_the_replicated_world(worlds, zero, repl):
    """The placed world's parameters within 1e-6 of the port's data-4
    world's (Adam's: but for the key biases, ``_adam_view``), and its
    losses and counts alike: the layout changes where the state lives,
    not the math."""
    a, b = worlds["w4"][zero][0], worlds["w4"][repl][0]
    view = _adam_view if zero == "zero_adam" else dict
    assert _max_diff(view(a["state"]), view(b["state"])) <= 1e-6
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert abs(ma[0] - mb[0]) <= 1e-6 and ma[1:] == mb[1:]


def test_a_rank_holds_its_share_of_the_state(worlds):
    """Per rank: the vit's two MLP tensors a block (and their Adam
    moments) halved, everything else whole; the MoE vit's experts
    halved."""
    w4 = worlds["w4"]
    full = sum(v.numel() for k, v in w4["repl_adam"][0]["state"].items())
    mlp = sum(v.numel() for k, v in w4["repl_adam"][0]["state"].items()
              if re.search(r"mlp_(up|down)\.weight$", k))
    for r in w4["zero_adam"]:
        assert r["elements"] == (full - mlp // 2, 2 * (full - mlp // 2))
    assert w4["repl_adam"][0]["elements"] == (full, 2 * full)
    moe_full = sum(v.numel() for v in w4["moe_repl"][0]["state"].values())
    experts = sum(v.numel() for k, v in w4["moe_repl"][0]["state"].items()
                  if re.search(r"\.w_(up|down)$", k))
    for r in w4["moe_zero"]:
        assert r["elements"][0] == moe_full - experts // 2


def test_an_overflow_on_one_model_rank_skips_on_every_rank(worlds):
    """f16: the first step's gradients blow up on rank 1 only; the model
    group agrees, so every rank skips it and applies the second, as the
    replicated world does."""
    zero, repl = worlds["w4"]["f16_zero"], worlds["w4"]["f16_repl"]
    assert {r["counters"] for r in zero + repl} == {(2, 1)}
    _same_on_every_rank(zero)
    # f16 products over other row splits: 1e-5, not the f32 1e-6
    assert _max_diff(zero[0]["state"], repl[0]["state"]) <= 1e-5


def test_the_placed_checkpoint_reads_as_the_replicated_one(worlds):
    """The file the placed world wrote, read in one process, holds the
    parameters and the Adam state the replicated world's holds (within
    1e-6), in the same layout, and the gathered state it was written
    from."""
    files = worlds["files"]
    zero, repl = (tckpt.read_checkpoint(files[n])["state"]
                  for n in ("zero_adam", "repl_adam"))
    assert _max_diff(_adam_view(zero["params"]),
                     _adam_view(repl["params"])) <= 1e-6
    assert _max_diff(zero["params"],
                     worlds["w4"]["zero_adam"][0]["state"]) == 0
    for idx, st in zero["opt_state"]["state"].items():
        for key, v in st.items():
            other = repl["opt_state"]["state"][idx][key]
            assert v.shape == other.shape
            assert (v.double() - other.double()).abs().max() <= 1e-6, key
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tckpt.load_checkpoint(files["zero_adam"], model, opt)


@pytest.mark.parametrize("name", ["resume_port", "resume_jax"])
def test_a_file_resumes_under_model_parallel_2(worlds, name):
    """A 1-rank port file and a JAX file of a (2, 2)-placed state,
    restored by the placed world, gather back to what one process
    restores from them: parameters and Adam moments, bit for bit."""
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, FULL, "cpu",
                    optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    tckpt.load_checkpoint(worlds["files"][name], model, state.optimizer,
                          train_state=state)
    want_params, want_opt = parallel.full_state(model, state.optimizer)
    for r in worlds["w4"][name]:
        params, opt = r["resumed"]
        assert _max_diff(params, want_params) == 0
        for idx, st in want_opt["state"].items():
            for key, v in st.items():
                assert torch.equal(opt["state"][idx][key], v), (idx, key)


def test_tensor_parallel_logits_equal_jaxs(worlds):
    """The Megatron vit's eval logits on each rank of the (1, 2) world
    within 2e-5 of JAX's tensor-parallel logits (test_tensor_parallel's
    bound)."""
    _, _, logits = worlds["refs"]["tp"]
    for r in worlds["w2"][0]:
        np.testing.assert_allclose(r["eval_logits"], logits, atol=2e-5,
                                   rtol=0)


def test_tensor_parallel_steps_equal_jaxs(worlds):
    """3 SGD steps of the Megatron vit within 1e-5 of JAX's TP steps,
    the two ranks' gathered parameters equal."""
    ranks = worlds["w2"][1]
    want, jax_losses_, _ = worlds["refs"]["tp"]
    _same_on_every_rank(ranks)
    _close(ranks[0]["state"], want, 1e-5)
    for (loss, _, _), jl in zip(ranks[0]["metrics"], jax_losses_):
        assert abs(loss - jl) <= 1e-5


def test_tensor_parallel_saves_a_quarter_less_for_the_backward(worlds):
    """A rank's train-mode forward saves at least 25% fewer bytes than
    one process's forward of the same rows (JAX's test_tensor_parallel
    bound at M = 4, held here at M = 2)."""
    from distributedpytorch_tpu_torch.data import augment

    images, _, _, _, draws = worlds["steps"][0]
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in worlds["init"].items()})
    one = saved_bytes(model, augment.train_transform(
        torch.from_numpy(images), MEAN, STD, 28,
        tuple(map(torch.from_numpy, draws))))
    for r in worlds["w2"][1]:
        assert r["saved_bytes"] <= 0.75 * one, (r["saved_bytes"], one)


# -- a model without attention ---------------------------------------------

DDP_CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")


def test_a_placed_mlp_world_of_two_equals_one_process(tmp_path):
    """``tests/_torch_ddp_child.py``'s three SGD steps of the mlp at
    --model-parallel 2 (data 1) against one process: its dense kernels
    placed, gathered and stepped on slices (f32, 1e-5 of each tensor's
    largest value)."""
    procs, logs, outs = [], [], []
    master = str(free_port())
    for world, rank in ((1, 0), (2, 0), (2, 1)):
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE",
                            "XLA_FLAGS")}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        if world > 1:
            env.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=master)
        outs.append(str(tmp_path / f"w{world}-r{rank}.pt"))
        logs.append(str(tmp_path / f"w{world}-r{rank}.log"))
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, DDP_CHILD, "mlp", outs[-1],
                 "--model-parallel", str(world)], cwd=REPO, env=env,
                stdout=out, stderr=out))
    await_all(procs, logs, timeout=120.0)
    one, *two = [torch.load(o, weights_only=True) for o in outs]
    for k, v in one["state"].items():
        assert torch.equal(two[1]["state"][k], two[0]["state"][k]), k
        scale = max(v.abs().max().item(), 1e-6)
        assert (two[0]["state"][k] - v).abs().max().item() / scale <= 1e-5, k
    np.testing.assert_allclose(np.array(two[0]["metrics"]),
                               np.array(one["metrics"]), rtol=1e-6,
                               atol=1e-6)


# -- JAX's errors --------------------------------------------------------

def _jax_error(**kwargs) -> str:
    with pytest.raises(ValueError) as e:
        jax_registry.get_model(**kwargs)
    return str(e.value)


@pytest.mark.parametrize("kwargs", [
    dict(name="resnet", tensor_parallel=True),
    dict(name="vit", tensor_parallel=True),
    dict(name="vit", tensor_parallel=True, attention="ring"),
    dict(name="vit", tensor_parallel=True, moe_experts=4)],
    ids=["resnet", "no_model_axis", "ring", "moe"])
def test_the_registry_refuses_as_jax(kwargs):
    want = _jax_error(num_classes=10, **kwargs)
    with pytest.raises(ValueError) as e:
        registry.get_model(num_classes=10, precision=FULL, device="meta",
                           **kwargs)
    assert str(e.value) == want


def _run_train_message(model, mp, attention, tp) -> str:
    return ("--attention ring/flash/ring_flash, --tensor-parallel and "
            "--pipeline-parallel require --model vit, are mutually "
            "exclusive (except --pipeline-parallel + --attention ring with "
            "--seq-parallel >= 2), and (except single-chip flash) need "
            f"--model-parallel >= 2; got model={model!r}, "
            f"model_parallel={mp}, attention={attention!r}, "
            f"tensor_parallel={tp}, pipeline_parallel=False")


@pytest.mark.parametrize("extra,message", [
    (["--model", "resnet", "--model-parallel", "2"],
     _run_train_message("resnet", 2, "full", True)),
    (["--model", "vit"], _run_train_message("vit", 1, "full", True)),
    (["--model", "vit", "--model-parallel", "2", "--attention", "ring"],
     _run_train_message("vit", 2, "ring", True)),
    (["--model", "vit", "--model-parallel", "2", "--attention", "flash"],
     _run_train_message("vit", 2, "flash", True)),
    (["--model", "vit", "--model-parallel", "2", "--moe-experts", "4"],
     "--moe-experts needs --model vit, E >= 2, and is exclusive with "
     "--tensor-parallel/--pipeline-parallel; got model='vit', "
     "moe_experts=4, tensor_parallel=True, pipeline_parallel=False")],
    ids=["resnet", "no_model_axis", "ring", "flash", "moe"])
def test_train_refuses_as_jax_run_train(tmp_path, extra, message):
    """``train --tensor-parallel`` fails before any work with the JAX
    run_train's messages (cli.py:735-776); the MoE one after the
    checkpoint's model is known, as there."""
    from distributedpytorch_tpu_torch import cli as tcli

    argv = ["train", "-d", str(tmp_path / "d"), "--rsl_path",
            str(tmp_path / "rsl"), "--device", "cpu", "--tensor-parallel",
            *extra]
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tcli.run_train(tconfig.config_from_argv(argv))
    assert not (tmp_path / "d").exists()


@pytest.mark.parametrize("extra,message", [
    ([], "--tensor-parallel (head/hidden axes) uses the mesh's 'model' "
         "axis: pass --model-parallel >= 2 (and a mesh)"),
    (["--model-parallel", "2", "--attention", "ring"],
     "--tensor-parallel composes only with --attention full (ring shards "
     "the same 'model' axis; the flash Pallas kernel is not "
     "GSPMD-partitionable over heads) — pick one")],
    ids=["no_model_axis", "ring"])
def test_test_refuses_as_the_jax_registry(extra, message):
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tconfig.config_from_argv(["test", "-d", "/d", "-f", "/x.ckpt",
                                  "--tensor-parallel", *extra])


def test_tensor_parallel_parses_with_a_model_axis():
    for action, extra in (("train", ["--model", "vit"]),
                          ("test", ["-f", "/x.ckpt"])):
        cfg = tconfig.config_from_argv([action, "-d", "/d",
                                        "--tensor-parallel",
                                        "--model-parallel", "2", *extra])
        assert (cfg.tensor_parallel, cfg.model_parallel) == (True, 2)
