"""The port's GPipe vit (``--pipeline-parallel``, ``--pipeline-
microbatches``) and its ring over 'seq' (``--seq-parallel``), held against
the JAX package's ``models/vit_pipeline.py`` on the CPU.  Inputs are
numpy arrays from a seed; the JAX parameters come across through
``models/convert.py``.  JAX's own tolerances (``tests/test_pipeline.py``):
2e-5 forward, 5e-5 gradients.

  * ``_block_apply`` and ``sequential_blocks`` against JAX's at dim 64,
    depth 4, 4 heads, forward and gradients.
  * One 4-rank gloo world of ``tests/_torch_pipeline_child.py`` (every
    stage bounded by the world's timeout), first on the (2 x 2) mesh,
    then on the (1 x 2 x 2) one, beside the JAX computations:
    - the schedule's forward and gradients against JAX's
      ``make_pipeline_fn`` at M = 2 (the stacked tensors whole) and M = 4
      (placed), and its tick count, P + M - 1;
    - the ring pipeline at 18 tokens (padded to 20) against JAX's;
    - 3 SGD and 3 Adam steps of ``PipelinedViT`` through the engine
      against JAX's steps on the placed mesh (``state_sharding(
      prefer_axis0=True)``), and 3 SGD steps of the ring pipeline at 49
      tokens; equal on every rank; each rank's elements against JAX's
      shard shapes;
    - a JAX-written stacked file and a port file of the plain vit resumed
      under the pipeline, equal to the files' state.
  * ``params_layout`` and ``convert_layout`` round trips equal to JAX's,
    the parameters and Adam's moments.
  * A port pipeline file read by a plain ``test -f`` and ``serve``'s
    restore, and a JAX-written stacked file resumed into the plain vit,
    each equal to the reference.
  * JAX's registry and CLI errors, word for word.
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
from flax import serialization
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu import cli as jax_cli
from distributedpytorch_tpu import parallel as jax_parallel
from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.config import Config as JaxConfig
from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.models import registry as jax_registry
from distributedpytorch_tpu.models import vit_pipeline as jvp
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import runtime, telemetry
from distributedpytorch_tpu_torch.models import convert, registry, vit
from distributedpytorch_tpu_torch.models import vit_pipeline as tvp
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.train.engine import Engine
from tests._subproc import REPO, await_all, free_port

CHILD = os.path.join(REPO, "tests", "_torch_pipeline_child.py")
DIM, DEPTH, HEADS = 64, 4, 4
ARCH = dict(dim=DIM, depth=DEPTH, heads=HEADS)
MEAN, STD = 0.13, 0.31
FWD_TOL, GRAD_TOL = 2e-5, 5e-5      # JAX tests/test_pipeline.py
FULL = PRESETS["f32"]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _stacked_params(seed: int) -> dict:
    """JAX test_pipeline's stacked tensors, with the LayerNorms and
    biases drawn too (so their gradients are not trivially equal)."""
    rng = np.random.default_rng(seed)
    d, dep = DIM, DEPTH
    init = jax.nn.initializers.lecun_normal(batch_axis=0)
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    out = {}
    for i, name in enumerate(("qkv_kernel", "proj_kernel", "up_kernel",
                              "down_kernel")):
        shape = {"qkv_kernel": (dep, d, 3 * d), "proj_kernel": (dep, d, d),
                 "up_kernel": (dep, d, 4 * d),
                 "down_kernel": (dep, 4 * d, d)}[name]
        out[name] = np.asarray(init(ks[i], shape, jnp.float32))
    for name, width in (("ln1", d), ("ln2", d)):
        out[f"{name}_scale"] = (1 + 0.1 * rng.standard_normal(
            (dep, width))).astype(np.float32)
        out[f"{name}_bias"] = (0.1 * rng.standard_normal(
            (dep, width))).astype(np.float32)
    for name, width in (("qkv_bias", 3 * d), ("proj_bias", d),
                        ("up_bias", 4 * d), ("down_bias", d)):
        out[name] = (0.05 * rng.standard_normal((dep, width))).astype(
            np.float32)
    return out


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# -- the block and the sequential schedule ---------------------------------

def test_block_and_sequential_blocks_are_jaxs():
    params = _stacked_params(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 16, DIM)).astype(np.float32)
    w = rng.standard_normal((8, 16, DIM)).astype(np.float32)
    block0 = {k: v[0] for k, v in params.items()}

    def jax_loss(p, xx):
        return jnp.sum(jvp.sequential_blocks(p, xx, HEADS, DEPTH) * w)

    j_block = jvp._block_apply(block0, jnp.asarray(x), HEADS)
    j_out = jvp.sequential_blocks(params, jnp.asarray(x), HEADS, DEPTH)
    j_gp, j_gx = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    t_block = tvp._block_apply({k: torch.from_numpy(v)
                                for k, v in block0.items()},
                               torch.from_numpy(x), HEADS)
    _close(t_block, j_block, FWD_TOL, "block")
    out = tvp.sequential_blocks(tp, tx, HEADS, DEPTH)
    _close(out.detach(), j_out, FWD_TOL, "sequential")
    (out * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, j_gx, GRAD_TOL, "dx")
    for k in params:
        _close(tp[k].grad, j_gp[k], GRAD_TOL, k)


def test_the_layernorm_and_gelu_are_flaxs():
    """The block's LayerNorm is JAX's two-pass one (not flax's nn
    LayerNorm's E[x^2] - E[x]^2), and its GELU flax's tanh form."""
    rng = np.random.default_rng(2)
    x = (3 + 2 * rng.standard_normal((4, 9, DIM))).astype(np.float32)
    s = rng.standard_normal(DIM).astype(np.float32)
    b = rng.standard_normal(DIM).astype(np.float32)
    _close(tvp._layernorm(*map(torch.from_numpy, (x, s, b))),
           jvp._layernorm(x, s, b), 1e-6)
    bf = torch.from_numpy(x).to(torch.bfloat16)
    got = tvp._layernorm(bf, torch.from_numpy(s), torch.from_numpy(b))
    want = jvp._layernorm(jnp.asarray(x, jnp.bfloat16), s, b)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)
    import flax.linen as nn

    _close(torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh"),
           nn.gelu(jnp.asarray(x)), 1e-6)


# -- the world ---------------------------------------------------------------

_draws = jax.jit(jax_augment._sample_affine_batch, static_argnums=(1, 2, 3))


def _steps(n: int, rows: int, seed: int):
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


def _jax_mesh(dp: int, mp: int, sp: int = 1):
    return jax_runtime.make_mesh(data_parallel=dp, model_parallel=mp,
                                 seq_parallel=sp,
                                 devices=jax.devices()[:dp * mp * sp])


def _jax_engine(optimizer: str, mesh=None, n_micro=None, ring=False):
    prec = JAX_PRESETS["f32"]
    fn = (None if mesh is None else jvp.make_pipeline_fn(
        mesh, mesh.shape["model"], DEPTH, HEADS, n_micro=n_micro, ring=ring))
    model = jvp.PipelinedViT(num_classes=10, dtype=prec.compute_dtype,
                             pipeline_fn=fn, **ARCH)
    tx = jax_make_optimizer(optimizer, 1e-3, 0.9, 0.1, 2, False)
    return JaxEngine(model, "vit", jax_losses.cross_entropy, tx, MEAN, STD,
                     28, precision=prec)


def _jax_run(engine, state, mesh, steps):
    """The steps on ``mesh`` from ``state`` placed by JAX's
    ``state_sharding(prefer_axis0=True)`` (``_place_state`` under
    ``--pipeline-parallel``); (params, optax moments by port name, the
    losses)."""
    put = functools.partial(jax.device_put, device=NamedSharding(
        mesh, P(jax_runtime.DATA_AXIS)))
    state = jax.device_put(state, jax_parallel.state_sharding(
        state, mesh, prefer_axis0=True))
    step = jax.jit(engine._train_step_keys)
    losses_ = []
    for images, labels, valid, key, _ in steps:
        state, m = step(state, put(jnp.asarray(images)),
                        put(jnp.asarray(labels)), put(jnp.asarray(valid)),
                        key, key)
        losses_.append(float(m["loss"]))
    return convert.params_from_jax(_np_tree(state.params)), losses_


def _spec(kind, mesh, **kw):
    return dict(kind=kind, mesh=mesh, **kw)


def _launch(work: str, specs: list, world: int):
    inp = os.path.join(work, "in.pt")
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
        outs.append(os.path.join(work, f"r{rank}.pt"))
        logs.append(os.path.join(work, f"r{rank}.log"))
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, inp, outs[-1]], cwd=REPO, env=env,
                stdout=out, stderr=out))
    return procs, logs, outs


def _jax_file(path: str, engine, state, mesh) -> dict:
    """A JAX checkpoint of ``state`` with random Adam moments, placed on
    ``mesh`` first; returns the state written, as numpy trees."""
    leaves, tree = jax.tree_util.tree_flatten(state.opt_state)
    rng = np.random.default_rng(7)
    leaves = [jnp.asarray(rng.standard_normal(np.shape(x)), x.dtype)
              if np.ndim(x) else x for x in leaves]
    state = state.replace(opt_state=jax.tree_util.tree_unflatten(
        tree, leaves))
    state = jax.device_put(state, jax_parallel.state_sharding(
        state, mesh, prefer_axis0=True))
    jax_ckpt.save_checkpoint(path, "vit", state, 0, 2.5)
    return serialization.to_state_dict(jax.device_get(state))


def _plain_file(path: str, init: dict) -> None:
    """A 1-process port checkpoint of the plain vit (per-block layout)
    after one Adam step (moments not zero)."""
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    engine = Engine(model, losses.cross_entropy, MEAN, STD, 28, FULL, "cpu",
                    optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(3))
    model.load_state_dict(tvp.convert_layout(
        {k: torch.as_tensor(v) for k, v in init.items()}, "blocks"))
    images, labels, valid, _, draws = _steps(1, 8, 900)[0]
    engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.tensor(valid), tuple(map(torch.tensor, draws)))
    tckpt.save_checkpoint(path, "vit", model, 0, 1.0, state.optimizer,
                          state.step, state.updates)


WORLD = ("fn_m2", "fn_m4", "sgd", "adam", "resume_jax", "resume_plain",
         "ring_fn", "ring_sgd")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results (the (2 x 2) mesh's specs, then the
    (1 x 2 x 2) mesh's) beside the JAX references, computed while the
    world runs."""
    work = str(tmp_path_factory.mktemp("pipeline"))
    params = _stacked_params(5)
    rng = np.random.default_rng(6)
    x, w = (rng.standard_normal((8, 16, DIM)).astype(np.float32)
            for _ in range(2))
    x18, w18 = (rng.standard_normal((4, 18, DIM)).astype(np.float32)
                for _ in range(2))
    mesh4, mesh3d = _jax_mesh(2, 2), _jax_mesh(1, 2, 2)
    sgd = _jax_engine("SGD", mesh4)
    state = sgd.init_state(jax.random.PRNGKey(5))
    init = {k: v.numpy() for k, v in convert.params_from_jax(
        _np_tree(state.params)).items()}
    adam = _jax_engine("adam", mesh4)
    files = {"jax": os.path.join(work, "jax.ckpt"),
             "plain": os.path.join(work, "plain.ckpt")}
    jax_state = _jax_file(files["jax"], adam, adam.init_state(
        jax.random.PRNGKey(8)), mesh4)
    _plain_file(files["plain"], init)
    steps = _steps(3, 8, 100)
    port_steps = [(im, lb, vd, dr) for im, lb, vd, _, dr in steps]
    specs = [
        _spec("fn", (2, 1), params=params, x=x, w=w, heads=HEADS,
              n_micro=2, ring=False),
        _spec("fn", (2, 1), params=params, x=x, w=w, heads=HEADS,
              n_micro=4, ring=False, placed=True),
        _spec("engine", (2, 1), arch=ARCH, params=init, steps=port_steps),
        _spec("engine", (2, 1), arch=ARCH, params=init, steps=port_steps,
              optimizer="adam"),
        _spec("engine", (2, 1), arch=ARCH, optimizer="adam",
              resume=files["jax"]),
        _spec("engine", (2, 1), arch=ARCH, optimizer="adam",
              resume=files["plain"]),
        _spec("fn", (2, 2), params=params, x=x18, w=w18, heads=HEADS,
              n_micro=2, ring=True, placed=True),
        _spec("engine", (2, 2), arch=ARCH, params=init, ring=True,
              steps=port_steps),
    ]
    procs, logs, outs = _launch(work, specs, 4)
    try:
        refs = {}

        def jax_fn(mesh, n_micro, ring, xx, ww):
            pipe = jvp.make_pipeline_fn(mesh, 2, DEPTH, HEADS,
                                        n_micro=n_micro, ring=ring)
            out = jax.jit(pipe)(params, jnp.asarray(xx))
            gp, gx = jax.jit(jax.grad(lambda p, a: jnp.sum(pipe(p, a) * ww),
                                      argnums=(0, 1)))(params,
                                                       jnp.asarray(xx))
            return np.asarray(out), np.asarray(gx), _np_tree(gp)

        refs["fn_m2"] = jax_fn(mesh4, 2, False, x, w)
        refs["fn_m4"] = jax_fn(mesh4, 4, False, x, w)
        refs["ring_fn"] = jax_fn(mesh3d, 2, True, x18, w18)
        refs["sgd"] = _jax_run(sgd, state, mesh4, steps)
        refs["adam"] = _jax_run(adam, adam.init_state(
            jax.random.PRNGKey(5)), mesh4, steps)
        ring = _jax_engine("SGD", mesh3d, ring=True)
        refs["ring_sgd"] = _jax_run(ring, state, mesh3d, steps)
        counts = jax.tree_util.tree_map(
            lambda leaf, sh: np.full(leaf.shape, math.prod(
                sh.shard_shape(leaf.shape)), np.float32),
            _np_tree(state.params), jax_parallel.state_sharding(
                state.params, mesh4, prefer_axis0=True))
        refs["counts"] = {k: int(v.flatten()[0]) for k, v in
                          convert.params_from_jax(counts).items()}
    finally:
        await_all(procs, logs, timeout=300.0)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    return {"res": {name: [r[i] for r in ranks]
                    for i, name in enumerate(WORLD)},
            "refs": refs, "init": init, "jax_state": jax_state,
            "files": files}


@pytest.mark.parametrize("name,micro", [("fn_m2", 2), ("fn_m4", 4),
                                        ("ring_fn", 2)])
def test_the_schedule_is_jaxs(world, name, micro):
    """Each rank's output rows and its rows' token gradients within
    2e-5 and 5e-5 of JAX's ``make_pipeline_fn`` (the ring's at 18 tokens,
    padded to 20 on the seq axis of 2), the stacked tensors' gradients
    (summed over the data shards) within 5e-5, and P + M - 1 ticks."""
    out, gx, gp = world["refs"][name]
    ranks = world["res"][name]
    dp = 1 if name == "ring_fn" else 2
    b = len(out) // dp
    assert sorted((r["data_index"], r["model_index"], r["seq_index"])
                  for r in ranks) == ([(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                       (0, 1, 1)] if dp == 1 else
                                      [(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                       (1, 1, 0)])
    for r in ranks:
        rows = slice(r["data_index"] * b, (r["data_index"] + 1) * b)
        _close(r["out"], out[rows], FWD_TOL, "out")
        _close(r["dx"], gx[rows], GRAD_TOL, "dx")
        for k, g in gp.items():
            _close(r["grads"][k], g, GRAD_TOL, k)
        assert r["ticks"] == 2 + micro - 1


def _adam_view(state: dict) -> dict:
    """``state`` without the key part of each qkv bias, whose gradient
    is zero in exact arithmetic and which Adam turns into +-lr steps of
    rounding (as tests/test_torch_parallel.py)."""
    return {k: (torch.cat([v[..., :DIM], v[..., 2 * DIM:]], -1)
                if k == "qkv_bias" else v) for k, v in state.items()}


@pytest.mark.parametrize("name,tol", [("sgd", 1e-5), ("adam", 1e-4),
                                      ("ring_sgd", 1e-5)])
def test_engine_steps_equal_the_jax_mesh_steps(world, name, tol):
    """3 steps of ``PipelinedViT`` through ``Engine`` within ``tol`` of
    JAX's on the placed mesh (the ring's on the (1, 2, 2) mesh at 49
    tokens, padded to 50), the losses within 1e-5, every rank's gathered
    state and its whole tensors (the replicated ends and the small
    stacked ones) bit-equal across the four ranks, and no kernel
    launched."""
    ranks = world["res"][name]
    want, jax_losses_ = world["refs"][name]
    for r in ranks[1:]:
        for part in ("state", "whole"):
            for k, v in r[part].items():
                assert torch.equal(v, ranks[0][part][k]), (part, k)
    got = ranks[0]["state"]
    if name == "adam":
        got, want = _adam_view(got), _adam_view(want)
    for k, v in want.items():
        _close(got[k], v, tol, k)
    for (loss, _, _), jl in zip(ranks[0]["metrics"], jax_losses_):
        assert abs(loss - jl) <= 1e-5
    assert sorted(ranks[0]["whole"]) == sorted(
        k for k in got if k not in ("qkv_kernel", "proj_kernel",
                                    "up_kernel", "down_kernel"))
    assert all(not any(r["launches"].values()) for r in ranks)


def test_a_rank_holds_jaxs_share_of_the_state(world):
    """A rank's parameter elements equal the shard shapes of JAX's
    ``state_sharding(prefer_axis0=True)`` (the four stacked kernels a
    stage's half, everything else whole), and Adam's moments the
    same."""
    counts = world["refs"]["counts"]
    want = sum(counts.values())
    full = sum(v.numel() for v in world["res"]["adam"][0]["state"].values())
    assert want < full
    for r in world["res"]["adam"]:
        assert r["elements"] == (want, 2 * want)


@pytest.mark.parametrize("name", ["resume_jax", "resume_plain"])
def test_files_of_either_layout_resume_under_the_pipeline(world, name):
    """A JAX-written stacked file (params and optax moments) and a port
    file of the plain vit (per-block, converted at load) restored into
    the placed ``PipelinedViT``: the gathered state equals the file's."""
    params, opt = world["res"][name][0]["resumed"]
    if name == "resume_jax":
        src = world["jax_state"]
        want = convert.params_from_jax(src["params"])
        adam = src["opt_state"]["0"]
        moments = {"exp_avg": convert.params_from_jax(adam["mu"]),
                   "exp_avg_sq": convert.params_from_jax(adam["nu"])}
    else:
        sd = torch.load(world["files"]["plain"], weights_only=False)
        want = tvp.convert_layout(sd["state"]["params"], "stacked")
        names = list(sd["state"]["params"])
        st = sd["state"]["opt_state"]["state"]
        moments = {m: tvp.convert_layout({names[i]: s[m] for i, s in
                                          st.items()}, "stacked")
                   for m in ("exp_avg", "exp_avg_sq")}
    for k, v in want.items():
        assert torch.equal(params[k], torch.as_tensor(v)), k
    names = list(params)
    for i, st in opt["state"].items():
        for m, tree in moments.items():
            assert torch.equal(st[m], torch.as_tensor(tree[names[i]])), \
                (names[i], m)
    for r in world["res"][name][1:]:
        assert all(torch.equal(v, r["resumed"][0][k])
                   for k, v in params.items())


# -- the layouts -------------------------------------------------------------

def test_layouts_convert_as_jaxs():
    """The JAX vit's per-block params and Adam moments converted to the
    stacked layout by JAX's ``convert_layout`` equal the port's
    conversion of the same trees, and back, bitwise."""
    from distributedpytorch_tpu.models.vit import ViT as JaxViT

    model = JaxViT(num_classes=10, dtype=jnp.float32, **ARCH)
    params = _np_tree(model.init(jax.random.PRNGKey(0), jnp.zeros(
        (1, 28, 28, 3)))["params"])
    rng = np.random.default_rng(3)
    mu = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    for tree in (params, mu):
        assert jvp.params_layout(tree) == "blocks"
        blocks = convert.params_from_jax(tree)
        assert tvp.params_layout(blocks) == "blocks"
        stacked = convert.params_from_jax(jvp.convert_layout(tree,
                                                             "stacked"))
        got = tvp.convert_layout(blocks, "stacked")
        assert tvp.params_layout(got) == "stacked"
        assert list(got) == list(stacked) or sorted(got) == sorted(stacked)
        for k, v in stacked.items():
            assert torch.equal(got[k], v), k
        back = tvp.convert_layout(got, "blocks")
        assert sorted(back) == sorted(blocks)
        for k, v in blocks.items():
            assert torch.equal(back[k], v), k
    steps = {f"blocks.{i}.qkv.weight": torch.tensor(3.0)
             for i in range(DEPTH)}
    steps.update({k: torch.tensor(3.0) for k in (
        f"blocks.{i}.{m}" for i in range(DEPTH) for m in (
            "ln1.weight", "ln1.bias", "qkv.bias", "proj.weight",
            "proj.bias", "ln2.weight", "ln2.bias", "mlp_up.weight",
            "mlp_up.bias", "mlp_down.weight", "mlp_down.bias"))})
    stacked = tvp.convert_layout(steps, "stacked")
    assert all(v.dim() == 0 for v in stacked.values())
    assert tvp.convert_layout(stacked, "blocks", DEPTH).keys() == \
        steps.keys()


def _full_width_pipeline_file(path: str):
    """A full-width ``PipelinedViT`` (no mesh: the blocks in order) after
    one Adam step, written by the port: (the model, its state dict)."""
    model = registry.store_params(tvp.PipelinedViT(
        dtype=torch.float32, device="cpu"), torch.float32)
    engine = Engine(model, losses.cross_entropy, 0.1307, 0.3081, 28, FULL,
                    "cpu", optimizer="adam")
    state = engine.init_state(torch.Generator().manual_seed(11))
    images, labels, valid, _, draws = _steps(1, 8, 901)[0]
    engine.train_step_affine(
        state, torch.from_numpy(images), torch.from_numpy(labels).long(),
        torch.tensor(valid), tuple(map(torch.tensor, draws)))
    tckpt.save_checkpoint(path, "vit", model, 0, 1.0, state.optimizer,
                          state.step, state.updates)
    return model


def test_a_pipeline_file_tests_and_serves_on_a_plain_config(tmp_path):
    """``test -f`` of a port pipeline file on a plain config (stacked ->
    blocks at load) equals the pipelined model's own eval of the test
    split; ``serve``'s restore gives the plain vit the same logits and
    records the layout it serves; a plain ``train -f`` resumes it."""
    path = str(tmp_path / "pp.ckpt")
    piped = _full_width_pipeline_file(path)
    argv = ["test", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "rsl"), "--dataset", "synthetic", "--debug",
            "--synthetic-fallback", "--device", "cpu", "--precision", "f32",
            "-f", path]
    got = tcli.run_test(tconfig.config_from_argv(argv))
    log = (tmp_path / "rsl" / "test.log").read_text()
    assert "checkpoint params converted: stacked -> blocks block layout" \
        in log
    from distributedpytorch_tpu_torch.data.datasets import load_dataset
    from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader

    ds = load_dataset("synthetic", str(tmp_path / "data"), 1234, debug=True,
                      synthetic_fallback=True)
    engine = Engine(piped, losses.cross_entropy, ds.mean, ds.std, 28, FULL,
                    "cpu")
    state = type("S", (), {"model": piped})()
    totals = None
    for batch in ResidentLoader(ds.splits["test"], 64, False, 1234,
                                "cpu").epoch(0):
        m = engine.eval_step(state, *batch)
        totals = m if totals is None else {k: totals[k] + m[k]
                                           for k in totals}
    assert got["test_loss"] == pytest.approx(
        float(totals["loss_numer"] / totals["loss_denom"]), abs=1e-6)
    assert got["test_acc"] == float(totals["correct"]) / float(
        totals["valid"])
    plain = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10)
    rsl = str(tmp_path / "serve")
    telemetry.configure(rsl, True, rank=0)
    try:
        tckpt.restore_for_serving(path, plain)
    finally:
        telemetry.get().close()
        telemetry.configure(rsl, False, 0)
    events = open(os.path.join(rsl, "telemetry", "rank0.jsonl")).read()
    assert '"layout": "blocks"' in events and "serve_restore" in events
    x = torch.rand(5, 28, 28, 3)
    with torch.no_grad():
        _close(plain.eval()(x), piped.eval()(x), 1e-5)
    optimizer = torch.optim.Adam(plain.parameters())
    tckpt.load_checkpoint(path, plain, optimizer)
    saved = tckpt.read_checkpoint(path)["state"]["opt_state"]["state"]
    qkv = list(piped.state_dict()).index("qkv_kernel")
    got = optimizer.state[plain.get_parameter("blocks.1.qkv.weight")]
    assert len(optimizer.state) == len(list(plain.parameters()))
    assert torch.equal(got["exp_avg"], saved[qkv]["exp_avg"][1].T)


def test_a_jax_stacked_file_resumes_into_the_plain_vit(world):
    """A JAX-written stacked file (params and Adam's moments) restored
    into the plain vit with ``train -f``'s optimizer: everything equals
    JAX's own stacked -> blocks conversion of the file's state."""
    src = world["jax_state"]
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    **ARCH)
    optimizer = torch.optim.Adam(model.parameters())
    tckpt.load_checkpoint(world["files"]["jax"], model, optimizer)
    want = convert.params_from_jax(jvp.convert_layout(src["params"],
                                                      "blocks"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    adam = src["opt_state"]["0"]
    mu = convert.params_from_jax(jvp.convert_layout(adam["mu"], "blocks"))
    names = [n for n, _ in model.named_parameters()]
    for i, st in optimizer.state_dict()["state"].items():
        assert torch.equal(st["exp_avg"], mu[names[i]]), names[i]
        assert float(st["step"]) == float(adam["count"])


# -- refusals ----------------------------------------------------------------

def _jax_error(fn, *args, **kwargs) -> str:
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_registry_and_schedule_refuse_as_jax():
    """The JAX registry's pipeline errors (``registry.py:119-199``) and
    ``make_pipeline_fn``'s (:190-226), word for word."""
    f32 = PRESETS["f32"]
    jmesh2, jmesh1 = _jax_mesh(1, 2), _jax_mesh(2, 1)
    mesh2 = runtime.Mesh(1, 2, 0, 0, (0, 1))
    mesh1 = runtime.Mesh(2, 1, 0, 0, (0,))
    cases = [
        (dict(name="vit", remat="blocks"), {}),
        (dict(name="vit", moe_experts=4), {}),
        (dict(name="cnn", pallas_dw=True), {}),
        (dict(name="cnn"), {}),
        (dict(name="vit", attention="flash"), {}),
        (dict(name="vit", attention="ring_flash"), {}),
        (dict(name="vit", tensor_parallel=True), {}),
        (dict(name="vit", mesh=jmesh1), dict(mesh=mesh1)),
        (dict(name="vit", mesh=None), dict(mesh=None)),
        (dict(name="vit", pipeline_microbatches=-1), {}),
        (dict(name="vit", mesh=_jax_mesh(1, 3), attention="full"),
         dict(mesh=runtime.Mesh(1, 3, 0, 0, (0, 1, 2)))),
        (dict(name="vit", attention="ring"), {}),
    ]
    for jax_kw, port_kw in cases:
        jax_kw = {"mesh": jmesh2, **jax_kw}
        message = _jax_error(jax_registry.get_model, num_classes=10,
                             pipeline_parallel=True, **jax_kw)
        kw = {**{k: v for k, v in jax_kw.items() if k != "mesh"},
              "mesh": mesh2, **port_kw}
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            registry.get_model(num_classes=10, precision=f32, device="meta",
                               pipeline_parallel=True, **kw)
    model = registry.get_model("vit", 10, f32, device="meta", mesh=mesh2,
                               pipeline_parallel=True,
                               pipeline_microbatches=4)
    assert isinstance(model, tvp.PipelinedViT)
    assert model.pipeline_fn.schedule.n_micro == 4
    fn = tvp.make_pipeline_fn(mesh2, 2, DEPTH, HEADS, n_micro=3)
    jfn = jvp.make_pipeline_fn(jmesh2, 2, DEPTH, HEADS, n_micro=3)
    message = _jax_error(jfn, _stacked_params(0), jnp.zeros((4, 16, DIM)))
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        fn({k: torch.from_numpy(v) for k, v in _stacked_params(0).items()},
           torch.zeros(4, 16, DIM))


def _cli_cases():
    return [
        # (JAX Config fields, the port's extra argv)
        (dict(model_name="cnn", model_parallel=2, pipeline_parallel=True),
         ["--model", "cnn", "--model-parallel", "2", "--pipeline-parallel"]),
        (dict(model_name="vit", pipeline_parallel=True),
         ["--model", "vit", "--pipeline-parallel"]),
        (dict(model_name="vit", model_parallel=2, pipeline_parallel=True,
              attention="ring"),
         ["--model", "vit", "--model-parallel", "2", "--pipeline-parallel",
          "--attention", "ring"]),
        (dict(model_name="vit", model_parallel=2, pipeline_parallel=True,
              tensor_parallel=True),
         ["--model", "vit", "--model-parallel", "2", "--pipeline-parallel",
          "--tensor-parallel"]),
        (dict(model_name="vit", seq_parallel=2),
         ["--model", "vit", "--seq-parallel", "2"]),
        (dict(model_name="vit", model_parallel=2, seq_parallel=2,
              pipeline_parallel=True),
         ["--model", "vit", "--model-parallel", "2", "--seq-parallel", "2",
          "--pipeline-parallel"]),
        (dict(model_name="vit", pipeline_microbatches=4),
         ["--model", "vit", "--pipeline-microbatches", "4"]),
        (dict(model_name="vit", model_parallel=2, pipeline_parallel=True,
              moe_experts=4),
         ["--model", "vit", "--model-parallel", "2", "--pipeline-parallel",
          "--moe-experts", "4"]),
        (dict(model_name="vit", model_parallel=2, pipeline_parallel=True,
              batch_size=1, pipeline_microbatches=4),
         ["--model", "vit", "--model-parallel", "2", "--pipeline-parallel",
          "-b", "1", "--pipeline-microbatches", "4"]),
        (dict(model_name="vit", model_parallel=2, pipeline_parallel=True,
              batch_size=4, grad_accum=4, pipeline_microbatches=4),
         ["--model", "vit", "--model-parallel", "2", "--pipeline-parallel",
          "-b", "4", "--grad-accum", "4", "--pipeline-microbatches", "4"]),
    ]


@pytest.mark.parametrize("case", range(10))
def test_train_refuses_as_jax_run_train(tmp_path, case):
    """``train`` fails before any work with the JAX run_train's
    messages (cli.py:731-807), word for word."""
    jax_kw, extra = _cli_cases()[case]
    message = _jax_error(jax_cli.run_train, JaxConfig(
        action="train", data_path=str(tmp_path / "nodata"),
        rsl_path=str(tmp_path / "jax"), dataset="synthetic", debug=True,
        **jax_kw))
    argv = ["train", "-d", str(tmp_path / "d"), "--rsl_path",
            str(tmp_path / "rsl"), "--device", "cpu", "--dataset",
            "synthetic", *extra]
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tcli.run_train(tconfig.config_from_argv(argv))
    assert not os.path.exists(tmp_path / "d")


def test_test_and_serve_refuse_as_jax(tmp_path):
    """``test``'s seq-parallel guard (cli.py:1347-1358) and ``serve``'s
    refusal of the four flags (:1500-1509), word for word; --scan-layers
    and orbax stay not ported."""
    message = _jax_error(jax_cli.run_test, JaxConfig(
        action="test", data_path=str(tmp_path / "nodata"),
        rsl_path=str(tmp_path / "jax"), dataset="synthetic",
        seq_parallel=2, checkpoint_file="/nonexistent.ckpt"))
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tconfig.config_from_argv(["test", "-d", "/d", "-f", "/x.ckpt",
                                  "--seq-parallel", "2", "--device", "cpu"])
    for flag in (["--pipeline-parallel"], ["--seq-parallel", "2"]):
        message = _jax_error(jax_cli.run_serve, JaxConfig(
            action="serve", data_path="/d", checkpoint_file="/x.ckpt",
            **({"pipeline_parallel": True} if len(flag) == 1
               else {"seq_parallel": 2})))
        with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
            tconfig.config_from_argv(["serve", "-d", "/d", "-f", "/x.ckpt",
                                      "--device", "cpu", *flag])
    for flag, shown in ((["--scan-layers"], "--scan-layers"),
                        (["--ckpt-format", "orbax"], "--ckpt-format orbax")):
        with pytest.raises(ValueError, match=f"^not ported yet: {shown}$"):
            tconfig.config_from_argv(["train", "-d", "/d", "--model", "vit",
                                      "--model-parallel", "2",
                                      "--pipeline-parallel", "--device",
                                      "cpu", *flag])
