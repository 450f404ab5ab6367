"""The port's ring attention (``--attention ring`` and ``ring_flash``) on
CPU ranks under gloo, held against the JAX package on the 8-device
virtual CPU mesh.

  * The ring op: 2 and 4 ranks (``tests/_torch_ring_child.py``, one ring
    of the whole world) against the JAX ``ring_attention`` and
    ``make_ring_attention`` on a mesh of the first 2 and 4 devices, the
    einsum ring and the flash ring (kernel K4 and K2p/K3p, their plain
    versions here; the JAX flash ring in Pallas interpret mode), at S = 49
    (padded to the ring, the padded keys masked) and causal, and at a
    causal S = 64: outputs at 2e-5 and q/k/v gradients at 5e-5, the
    tolerances of the JAX package's own ring tests (the same f32 math in
    other orders).  Every rank returns the whole output.
  * A narrow vit at data = 2, model = 2 (4 ranks): three f32 SGD steps on a
    global batch of 8 with the JAX draws, against the JAX step on a (2, 2)
    mesh with the same attention: parameters at 1e-5 (as the one-process
    trajectory in ``test_torch_train.py``), the steps' loss at 1e-5 and
    their correct and valid counts equal.  This pins the data shard's
    rows, its draws and the gradient scale (DDP's mean over 4 ranks of 2
    shards).  The first step masks 3 of the 8 rows, unevenly over the
    shards.
  * The loader's rows under ``--model-parallel``: the JAX plan's data
    shards.
  * The refusals, with the JAX messages.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import runtime as jax_runtime
from distributedpytorch_tpu.data import augment as jax_augment
from distributedpytorch_tpu.data.datasets import Split as JaxSplit
from distributedpytorch_tpu.data.pipeline import (
    ResidentLoader as JaxResidentLoader)
from distributedpytorch_tpu.models.vit import ViT as JaxViT
from distributedpytorch_tpu.ops import attention as jax_attention
from distributedpytorch_tpu.ops import losses as jax_losses
from distributedpytorch_tpu.precision import PRESETS as JAX_PRESETS
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import runtime
from distributedpytorch_tpu_torch.data.datasets import Split
from distributedpytorch_tpu_torch.data.pipeline import ResidentLoader
from distributedpytorch_tpu_torch.models import convert
from distributedpytorch_tpu_torch.ops import attention as tattention
from tests._subproc import REPO, await_all, free_port

CHILD = os.path.join(REPO, "tests", "_torch_ring_child.py")
TIMEOUT = 240.0
B, H, D = 2, 2, 16
# (S, causal, flash, ragged): ragged goes through make_ring_attention
CASES = [(49, False, False, True), (49, True, False, True),
         (49, False, True, True), (49, True, True, True),
         (64, True, False, False), (64, True, True, False)]
CASE_IDS = [f"S{s}-{'causal' if c else 'full'}-{'ring_flash' if f else 'ring'}"
            for s, c, f, _ in CASES]
NARROW = dict(dim=64, depth=2, heads=2)
MEAN, STD = 0.13, 0.31


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
    return env


def _run_world(tmp_path, name, world, mode, spec, *args):
    """Every rank of a world of ``world`` children on ``spec``; returns the
    ranks' results in rank order."""
    inp = str(tmp_path / f"{name}-in.pt")
    torch.save(spec, inp)
    port = str(free_port())
    procs, logs, outs = [], [], []
    for rank in range(world):
        env = _env() if world == 1 else _env(
            WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=port)
        outs.append(str(tmp_path / f"{name}-r{rank}.pt"))
        logs.append(str(tmp_path / f"{name}-r{rank}.log"))
        with open(logs[-1], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, mode, inp, outs[-1], *args],
                cwd=REPO, env=env, stdout=out, stderr=out))
    await_all(procs, logs, timeout=TIMEOUT)
    return [torch.load(o, weights_only=False) for o in outs]


def _case_inputs(i, s):
    rng = np.random.default_rng(100 + i)
    return [rng.standard_normal((B, s, H, D)).astype(np.float32)
            for _ in range(4)]                          # q, k, v, w


def _jax_case(mesh, i, case):
    s, causal, flash, ragged = case
    q, k, v, w = (jnp.asarray(x) for x in _case_inputs(i, s))
    if ragged:
        attn = jax_attention.make_ring_attention(mesh, causal=causal,
                                                 use_flash=flash)
    else:
        def attn(a, b, c):
            return jax_attention.ring_attention(a, b, c, mesh,
                                                causal=causal,
                                                use_flash=flash)
    o, vjp = jax.vjp(attn, q, k, v)
    return {"o": np.asarray(o),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"),
                                                vjp(w))}}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def rings(request, tmp_path_factory):
    """(JAX results, the port's per-rank results) of every case on a ring
    of ``world`` ranks."""
    world = request.param
    mesh = jax_runtime.make_mesh(data_parallel=1, model_parallel=world,
                                 devices=jax.devices()[:world])
    want = [_jax_case(mesh, i, c) for i, c in enumerate(CASES)]
    spec = []
    for i, (s, causal, flash, ragged) in enumerate(CASES):
        q, k, v, w = _case_inputs(i, s)
        spec.append(dict(q=q, k=k, v=v, w=w, causal=causal, use_flash=flash,
                         ragged=ragged, dtype="float32"))
    got = _run_world(tmp_path_factory.mktemp("ring"), f"attn{world}", world,
                     "attn", spec)
    return want, got


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_ring_output_matches_jax(rings, i):
    want, got = rings
    assert [r["model_index"] for r in got] == list(range(len(got)))
    for r in got:        # every rank returns the whole output
        np.testing.assert_allclose(r["cases"][i]["o"], want[i]["o"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_ring_gradients_match_jax(rings, i):
    want, got = rings
    for r in got:
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(r["cases"][i][name], want[i][name],
                                       rtol=5e-5, atol=5e-5, err_msg=name)


# -- a narrow vit at data = 2, model = 2 ------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _steps():
    """Three global batches of 8 with their JAX keys; the first masks rows
    1, 2 and 6 (shard 0 keeps 2 of 4 valid rows, shard 1 keeps 3)."""
    out = []
    for i in range(3):
        rng = np.random.default_rng(20 + i)
        images = rng.integers(0, 256, (8, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, 8).astype(np.int32)
        valid = np.ones(8, bool)
        if i == 0:
            valid[[1, 2, 6]] = False
        out.append((images, labels, valid, jax.random.PRNGKey(200 + i)))
    return out


@pytest.fixture(scope="module", params=["ring", "ring_flash"])
def vit_worlds(request, tmp_path_factory):
    """(JAX params and metrics after 3 steps on a (2, 2) mesh, the 4 port
    ranks' results) for one ring attention."""
    attention = request.param
    mesh = jax_runtime.make_mesh(data_parallel=2, model_parallel=2,
                                 devices=jax.devices()[:4])
    prec = JAX_PRESETS["f32"]
    model = JaxViT(dtype=prec.compute_dtype, num_classes=10,
                   attention_fn=jax_attention.make_ring_attention(
                       mesh, use_flash=attention == "ring_flash"),
                   **NARROW)
    tx = jax_make_optimizer("SGD", 1e-3, 0.9, 0.1, 2, False)
    engine = JaxEngine(model, "vit", jax_losses.cross_entropy, tx, MEAN, STD,
                       28, precision=prec)
    state = engine.init_state(jax.random.PRNGKey(1))
    params = convert.params_from_jax(_np_tree(state.params))
    step = jax.jit(engine._train_step_keys)
    steps, metrics = [], []
    for images, labels, valid, key in _steps():
        draws = [np.asarray(x) for x in
                 jax_augment._sample_affine_batch(key, 8, 28, 28)]
        steps.append((images, labels, valid, draws))
        state, m = step(state, jnp.asarray(images), jnp.asarray(labels),
                        jnp.asarray(valid), key, key)
        metrics.append([float(m["loss"]), float(m["correct"]),
                        float(m["valid"])])
    want = convert.params_from_jax(_np_tree(state.params))
    spec = dict(arch=NARROW, attention=attention, seed=0,
                params={k: v.numpy() for k, v in params.items()},
                steps=steps)
    got = _run_world(tmp_path_factory.mktemp("vit"), f"vit-{attention}", 4,
                     "vit", spec, "--model-parallel", "2")
    return want, metrics, got


def test_ranks_are_laid_out_as_the_jax_mesh(vit_worlds):
    _, _, got = vit_worlds
    assert [(r["data_index"], r["model_index"]) for r in got] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["backend"] == "gloo" and r["world"] == 4 for r in got)


def test_three_steps_at_data2_model2_equal_the_jax_mesh_step(vit_worlds):
    want, _, got = vit_worlds
    for r in got:           # DDP keeps every rank's parameters equal
        for k, v in r["state"].items():
            assert torch.equal(v, got[0]["state"][k]), (r["rank"], k)
    for name, w in want.items():
        np.testing.assert_allclose(got[0]["state"][name].numpy(), w.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_step_metrics_count_each_data_shard_once(vit_worlds):
    _, metrics, got = vit_worlds
    for r in got:
        assert r["metrics"] == got[0]["metrics"]
    for (loss, correct, valid), (jl, jc, jv) in zip(got[0]["metrics"],
                                                    metrics):
        assert abs(loss - jl) <= 1e-5
        assert (correct, valid) == (jc, jv)
    assert [m[2] for m in metrics] == [5.0, 8.0, 8.0]


def test_loader_rows_are_the_data_shards_of_the_jax_plan():
    """Rank r of W = 4 at model_parallel 2 gathers the rows of JAX data
    shard r // 2: columns [d*B*2, (d+1)*B*2) of the JAX global plan (the
    sampler slices of ranks 2d and 2d + 1), with their valid mask."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (37, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 37).astype(np.int32)
    mesh = jax_runtime.make_mesh(data_parallel=2, model_parallel=2,
                                 devices=jax.devices()[:4])
    jplan = JaxResidentLoader(JaxSplit(images, labels), mesh, 3,
                              shuffle=True, seed=4)._host_plan(1)
    for rank in range(4):
        loader = ResidentLoader(Split(images, labels), 3, True, 4, "cpu",
                                world=4, rank=rank, model_parallel=2)
        idx, valid = loader.epoch_plan(1)
        cols = slice((rank // 2) * 6, (rank // 2 + 1) * 6)
        np.testing.assert_array_equal(idx.numpy(), jplan[0][:, cols])
        np.testing.assert_array_equal(valid.numpy(), jplan[1][:, cols])
        assert loader.global_batch == 12 and len(loader) == len(jplan[0])


# -- refusals ---------------------------------------------------------------

def test_mesh_refuses_a_model_axis_that_does_not_divide_the_world():
    with pytest.raises(ValueError) as want:
        jax_runtime.make_mesh(model_parallel=2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        runtime.make_mesh(2)            # a world of one
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("s,kv_valid", [(30, None), (64, 0), (64, 65)],
                         ids=["indivisible", "kv_valid0", "kv_valid_past"])
def test_ring_attention_refusals_are_the_jax_ones(s, kv_valid):
    jmesh = jax_runtime.make_mesh(data_parallel=1, model_parallel=8)
    x = np.zeros((1, s, 2, 8), np.float32)
    with pytest.raises(ValueError) as want:
        jax_attention.ring_attention(jnp.asarray(x), jnp.asarray(x),
                                     jnp.asarray(x), jmesh,
                                     kv_valid=kv_valid)
    t = torch.from_numpy(x)
    with pytest.raises(ValueError) as got:
        tattention.ring_attention(t, t, t, runtime.Mesh(model_parallel=8),
                                  kv_valid=kv_valid)
    assert str(got.value) == str(want.value)


def test_ring_flash_without_a_model_axis_fails_as_in_jax():
    argv = ["train", "-d", "/d", "--model", "vit", "--attention",
            "ring_flash", "--device", "cpu"]
    with pytest.raises(ValueError, match=r"need --model-parallel >= 2; got "
                       r"model='vit', model_parallel=1, "
                       r"attention='ring_flash'"):
        tconfig.config_from_argv(argv)
    with pytest.raises(ValueError, match=r"^--attention ring_flash \(token "
                       r"axis\) uses the mesh's 'model' axis"):
        tconfig.config_from_argv(["test", "-d", "/d", "-f", "/x.ckpt",
                                  "--attention", "ring_flash"])


@pytest.mark.parametrize("attention", ["ring", "ring_flash"])
def test_ring_with_a_model_axis_parses(attention):
    for action, extra in (("train", ["--model", "vit"]),
                          ("test", ["-f", "/x.ckpt"])):
        cfg = tconfig.config_from_argv([action, "-d", "/d", "--attention",
                                        attention, "--model-parallel", "2",
                                        *extra])
        assert (cfg.model_parallel, cfg.attention) == (2, attention)


@pytest.mark.parametrize("extra", [["--model", "cnn"],
                                   ["--model", "vit", "--attention",
                                    "flash"]], ids=["cnn", "vit-flash"])
def test_model_parallel_without_the_ring_is_not_ported(extra):
    """Ported now (the name is kept from when it was refused): without a
    ring, --model-parallel places the state over 'model' and parses; with
    --tensor-parallel the cnn and the flash vit fail with the JAX
    run_train's message (tests/test_torch_parallel.py runs both)."""
    argv = ["train", "-d", "/d", "--model-parallel", "2", *extra]
    cfg = tconfig.config_from_argv(argv)
    assert (cfg.model_parallel, cfg.tensor_parallel) == (2, False)
    model, attention = ("cnn", "full") if extra[1] == "cnn" else \
        ("vit", "flash")
    with pytest.raises(ValueError, match=re.escape(
            f"got model={model!r}, model_parallel=2, "
            f"attention={attention!r}, tensor_parallel=True, "
            f"pipeline_parallel=False")):
        tconfig.config_from_argv(argv + ["--tensor-parallel"])

