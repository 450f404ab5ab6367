"""``--ckpt-format orbax``: checkpoint directories on
``torch.distributed.checkpoint``, against the JAX package's orbax path.

One 2-rank gloo world of ``tests/_torch_ring_child.py`` (data 1 x model
2) runs, one after another: the ZeRO vit, the Megatron
(``--tensor-parallel``, qkv placed as ``Shard(groups=3)``) vit and the
expert-parallel MoE vit, 2 SGD steps each, each saving a directory with
``Placement.join`` and
``parallel.full_state`` made to raise; then the restores of both
directories into the ZeRO and the tensor-parallel vit, read with neither.
Beside it, a 2-rank CLI world trains the vit under ``--model-parallel 2
--ckpt-format orbax``.  In this process: meta.json's fields against JAX
``_orbax_meta`` for five layouts, the structural checksum and the
meta.json errors against JAX's, restores at M = 1, the resume at M = 1
against the continuous run (JAX topology test C == A), msgpack <->
directory both ways, the stacked and scan layouts through ``test -f`` on
a plain model, the MoE refusal, a restore under another optimizer, the
torn head's fallback, async against sync (and through the CLI), a
JAX-written orbax directory refused, the rotation, the rollout's lineage
watch, and the peer loss inside DCP's ``CheckpointException``.
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributedpytorch_tpu import checkpoint as jax_ckpt
from distributedpytorch_tpu.models import get_model as jax_get_model
from distributedpytorch_tpu.models import scan as jax_scan
from distributedpytorch_tpu.ops.losses import get_loss_fn as jax_loss_fn
from distributedpytorch_tpu.train.engine import Engine as JaxEngine
from distributedpytorch_tpu.train.engine import (
    make_optimizer as jax_make_optimizer)
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import dcp_io, elastic, faults, parallel
from distributedpytorch_tpu_torch.data import augment
from distributedpytorch_tpu_torch.models import registry, vit
from distributedpytorch_tpu_torch.models.vit_pipeline import PipelinedViT
from distributedpytorch_tpu_torch.ops import losses
from distributedpytorch_tpu_torch.precision import PRESETS
from distributedpytorch_tpu_torch.serving import rollout
from distributedpytorch_tpu_torch.train.engine import Engine
from tests._subproc import REPO, await_all, free_port

CHILD = os.path.join(REPO, "tests", "_torch_ring_child.py")
MEAN, STD = 0.13, 0.31
# width 80: qkv (240 x 80) and the MLP's two kernels are ZeRO-sharded;
# under --tensor-parallel qkv is Shard(0, groups=3)
ARCH = dict(dim=80, depth=2, heads=2)
FULL = PRESETS["f32"]


def _vit(arch=ARCH, seed=0, attention="full"):
    model = vit.ViT(dtype=torch.float32, device="cpu", num_classes=10,
                    attention_fn=registry.attention_fn(attention, None),
                    **arch)
    return model.init_weights(torch.Generator().manual_seed(seed))


def _steps(n: int, rows: int, seed: int):
    """``n`` global batches of ``rows`` uint8 images (one row masked in
    each) with their affine draws, as numpy arrays."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        valid = np.ones(rows, bool)
        valid[1] = False
        out.append((rng.integers(0, 256, (rows, 28, 28), dtype=np.uint8),
                    rng.integers(0, 10, rows).astype(np.int32), valid,
                    [a.numpy() for a in augment.sample_affine_batch(
                        gen, rows, 28, 28)]))
    return out


def _engine(model, optimizer="SGD"):
    return Engine(model, losses.cross_entropy, MEAN, STD, 28, FULL, "cpu",
                  optimizer=optimizer, steps_per_epoch=2)


def _run_steps(engine, state, steps):
    for images, labels, valid, draws in steps:
        engine.train_step_affine(
            state, torch.from_numpy(images), torch.from_numpy(labels).long(),
            torch.from_numpy(valid), tuple(map(torch.from_numpy, draws)))


def _equal_states(a, b):
    """Two ``parallel.full_state`` results, bit for bit."""
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    if a[1] is None:
        return
    assert a[1]["state"].keys() == b[1]["state"].keys()
    for i, st in a[1]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, b[1]["state"][i][key]), (i, key)


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


def _cli_world(work):
    """``train --model vit --attention flash --model-parallel 2
    --ckpt-format orbax -e 1`` under torchrun on 2 CPU ranks."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                        "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    log = os.path.join(work, "cli.log")
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "distributedpytorch_tpu_torch",
             "train", "-d", os.path.join(work, "data"), "--rsl_path",
             os.path.join(work, "cli"), "--model", "vit", "--attention",
             "flash", "--model-parallel", "2", "--ckpt-format", "orbax",
             "--device", "cpu", "--debug", "--synthetic-fallback", "-e",
             "1", "-b", "16"], cwd=REPO, env=env, stdout=out, stderr=out)
    return proc, log


# name -> (arch extras, attention, steps, writes a directory, restores)
WORLD = {
    "zero": ({}, "flash", 2, "zero", None),
    "tp": ({"tensor_parallel": True}, "full", 2, "tp", None),
    "ep": ({"moe_experts": 4}, "flash", 2, "ep", None),
    "zero_from_zero": ({}, "flash", 0, None, "zero"),
    "tp_from_zero": ({"tensor_parallel": True}, "full", 0, None, "zero"),
    "zero_from_tp": ({}, "flash", 0, None, "tp"),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("orbax"))
    init = {k: v.numpy() for k, v in _vit().state_dict().items()}
    steps = _steps(3, 8, 100)
    dirs = {name: os.path.join(work, f"{name}.ckpt")
            for name in ("zero", "tp", "ep")}
    specs = []
    for name, (extra, attention, n, save, load) in WORLD.items():
        spec = dict(arch=dict(ARCH, **extra), attention=attention, seed=0,
                    params=None if "moe_experts" in extra else init,
                    mean=MEAN, std=STD,
                    steps=[(im, lb, vd, dr) for im, lb, vd, dr in steps[:n]])
        if save:
            spec["ckpt_dir"] = dirs[save]
        if load:
            spec["resume"] = dirs[load]
        specs.append(spec)
    running = _launch(work, "w2", specs, 2, 2)
    cli, cli_log = _cli_world(work)
    # the continuous run (JAX topology test's A) at M = 1, one thread as
    # the ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = _vit(attention="flash")
        engine = _engine(model)
        state = engine.init_state(torch.Generator().manual_seed(0))
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in init.items()})
        _run_steps(engine, state, steps)
        continuous = parallel.full_state(model, state.optimizer)
    finally:
        torch.set_num_threads(threads)
        procs, logs, outs = running
        await_all(procs + [cli], logs + [cli_log], timeout=300.0)
    results = [torch.load(o, weights_only=False) for o in outs]
    return {"ranks": {name: [r[i] for r in results]
                      for i, name in enumerate(WORLD)},
            "dirs": dirs, "steps": steps, "continuous": continuous,
            "init": init, "cli": os.path.join(work, "cli"), "work": work}


# -- (a) meta.json and the checksum ------------------------------------------

def _jax_params(name, **kw):
    model = jax_get_model(name, 10, **kw)
    size = 224 if name == "densenet" else 28
    return jax.eval_shape(lambda k: model.init(
        k, jax.numpy.zeros((1, size, size, 3)), train=False),
        jax.random.PRNGKey(0))["params"]


LAYOUTS = {
    "vit_blocks": ("vit", lambda: _jax_params("vit"),
                   lambda: registry.get_model("vit", 10, FULL,
                                              device="meta")),
    "vit_scan": ("vit", lambda: _jax_params("vit", scan_layers=True),
                 lambda: registry.get_model("vit", 10, FULL, device="meta",
                                            scan_layers=True)),
    "vit_stacked": ("vit", lambda: jax_scan.convert_layout(
        _jax_params("vit"), "stacked"),
        lambda: PipelinedViT(10, dtype=torch.float32, device="meta")),
    "moe_vit": ("vit", lambda: _jax_params("vit", moe_experts=4),
                lambda: registry.get_model("vit", 10, FULL, device="meta",
                                           moe_experts=4)),
    "densenet_scan": ("densenet", lambda: _jax_params("densenet",
                                                      scan_layers=True),
                      lambda: registry.get_model("densenet", 10, FULL,
                                                 device="meta",
                                                 scan_layers=True)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_meta_fields_are_jaxs(layout):
    """model_name, epoch, loss, params_layout and moe as JAX
    ``_orbax_meta`` writes them for the same model; the port's format
    version is its own (3)."""
    name, jax_tree, port_model = LAYOUTS[layout]
    want = jax_ckpt._orbax_meta(name, 4, 0.75, {"params": jax_tree()})
    got = tckpt._dir_meta(name, port_model(), 4, 0.75, {})
    assert got.pop("format_version") == tckpt.FORMAT_VERSION == 3
    assert want.pop("format_version") == 1
    assert got.pop("views") == {}
    assert got == want
    assert got["params_layout"] is not None


def test_written_meta_and_checksum_are_jaxs(tmp_path):
    """A written directory's meta.json is ``_dir_meta``'s plus the
    structural checksum, which JAX's ``_orbax_checksum`` computes alike;
    JAX's ``verify_checkpoint`` passes it, and after a torn payload file
    both give the same one-line reason."""
    model = _vit()
    path = str(tmp_path / "bestmodel-mnist-vit.ckpt")
    tckpt.save_directory(path, "vit", model, 2, 0.5)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == dict(tckpt._dir_meta("vit", model, 2, 0.5, {}),
                        checksum=jax_ckpt._orbax_checksum(path))
    assert sorted(os.listdir(os.path.join(path, "state"))) == [
        ".metadata", "__0_0.distcp"]
    assert jax_ckpt.verify_checkpoint(path) is None
    assert tckpt.verify_checkpoint(path) is None
    assert tckpt.lineage_info(path) == jax_ckpt.lineage_info(path)
    faults._tear(path)
    reason = tckpt.verify_checkpoint(path)
    assert reason == jax_ckpt.verify_checkpoint(path)
    assert reason.startswith("content checksum mismatch (recorded ")
    with pytest.raises(ValueError, match="corrupt checkpoint — content "
                                         "checksum mismatch"):
        tckpt.load_checkpoint(path, _vit(), restore_optimizer=False)


# -- (b) the 2-rank world: written as laid out, restored anywhere --------

def test_each_rank_writes_its_own_slices(world):
    """The ZeRO directory: each chunk of a sharded tensor (qkv, mlp_up,
    mlp_down and their momentum, each block) lies in its own rank's file,
    and the chunks of every entry cover its elements once: the payload
    holds the parameters and the momentum, every element once, and each
    rank's file its slices and a share of the replicated tensors."""
    state_dir = os.path.join(world["dirs"]["zero"], "state")
    meta = dcp_io.dcp.FileSystemReader(state_dir).read_metadata()
    held, own = {}, {0: 0, 1: 0}
    for fqn, entry in meta.state_dict_metadata.items():
        if not dcp_io.is_tensor(entry):
            continue
        assert sum(int(np.prod(c.sizes)) for c in entry.chunks) == \
            int(np.prod(entry.size)), fqn
        for c in entry.chunks:
            where = meta.storage_data[dcp_io.MetadataIndex(fqn, c.offsets)]
            held[where.relative_path] = held.get(where.relative_path, 0) \
                + int(np.prod(c.sizes))
            if len(entry.chunks) > 1:
                rank = int(any(c.offsets))
                assert where.relative_path == f"__{rank}_0.distcp", fqn
                own[rank] += int(np.prod(c.sizes))
    sharded = [k for k, e in meta.state_dict_metadata.items()
               if dcp_io.is_tensor(e) and len(e.chunks) > 1]
    assert len(sharded) == 2 * 3 * ARCH["depth"], sharded
    full = sum(v.numel() for v in world["ranks"]["zero"][0]["state"].values())
    assert sum(held.values()) == 2 * full      # parameters and momentum
    for rank in (0, 1):
        elements = sum(world["ranks"]["zero"][rank]["elements"])
        assert own[rank] == elements - (2 * full - sum(own.values()))
        assert held[f"__{rank}_0.distcp"] > own[rank]


@pytest.mark.parametrize("name,source", [
    ("zero_from_zero", "zero"), ("tp_from_zero", "zero"),
    ("zero_from_tp", "tp")])
def test_a_directory_restores_at_m2_bit_identically(world, name, source):
    """A directory written under ZeRO or tensor parallelism at M = 2,
    restored by a ZeRO or a tensor-parallel world at M = 2 with no
    gather, gathers back to the state it was written from, parameters
    and momentum, and the counters with it."""
    for restored, saved in zip(world["ranks"][name],
                               world["ranks"][source]):
        params, opt = restored["resumed"]
        _equal_states((params, opt), (saved["state"], saved["opt_state"]))
        assert opt["state"].keys() and all(
            torch.isfinite(st["momentum_buffer"]).all()
            for st in opt["state"].values())
    assert world["ranks"][name][0]["counters"] == (2, 2)


@pytest.mark.parametrize("source", ["zero", "tp", "ep"])
def test_a_directory_restores_at_m1_bit_identically(world, source):
    """The ZeRO, tensor-parallel and expert-parallel (the MoE vit's
    experts split on their axis) directories restore into one unplaced
    process: its parameters, momentum and counters are the world's,
    gathered."""
    arch = dict(ARCH, moe_experts=4) if source == "ep" else ARCH
    model = _vit(arch)
    engine = _engine(model)
    state = engine.init_state(torch.Generator().manual_seed(1))
    tckpt.load_checkpoint(world["dirs"][source], model, state.optimizer,
                          train_state=state)
    saved = world["ranks"][source][0]
    _equal_states(parallel.full_state(model, state.optimizer),
                  (saved["state"], saved["opt_state"]))
    assert (int(state.step), int(state.updates)) == (2, 2)


# -- (c) resume at M = 1 equals the continuous run ---------------------

def test_resume_at_m1_equals_the_continuous_run(world):
    """The M = 2 directory of step 2, resumed in one process for step 3,
    equals the continuous 3-step run bit for bit (JAX C == A)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = _vit(attention="flash")
        engine = _engine(model)
        state = engine.init_state(torch.Generator().manual_seed(2))
        tckpt.load_checkpoint(world["dirs"]["zero"], model,
                              state.optimizer, train_state=state)
        _run_steps(engine, state, world["steps"][2:])
    finally:
        torch.set_num_threads(threads)
    _equal_states(parallel.full_state(model, state.optimizer),
                  world["continuous"])


def test_the_cli_world_writes_directories(world):
    """``train --model-parallel 2 --ckpt-format orbax``: the rolling and
    best directories, each rank's payload file, no leftover .tmp, the
    lineage records; ``test -f`` of the best one in one process."""
    rsl = world["cli"]
    rolling = tckpt.checkpoint_path(rsl, "mnist", "vit", 0)
    best = tckpt.best_model_path(rsl, "mnist", "vit")
    for path in (rolling, best):
        assert os.path.isdir(path) and tckpt.verify_checkpoint(path) is None
        assert sorted(os.listdir(os.path.join(path, "state"))) == [
            ".metadata", "__0_0.distcp", "__1_0.distcp"]
    assert not [n for n in os.listdir(rsl) if n.endswith(".tmp")]
    assert "parameters placed" in open(os.path.join(rsl, "test.log")).read()
    assert tckpt.lineage_info(best)["sha256"] == \
        tckpt._lineage_entry(best)["sha256"]
    out = tcli.run_test(tconfig.config_from_argv(
        ["test", "-d", os.path.join(world["work"], "data"), "--rsl_path",
         os.path.join(world["work"], "cli_test"), "-f", best,
         "--attention", "flash", "--device", "cpu", "--debug",
         "--synthetic-fallback"]))
    assert out["model_name"] == "vit" and 0.0 <= out["test_acc"] <= 1.0


# -- (d) msgpack <-> directory -----------------------------------------

def test_formats_convert_both_ways(tmp_path):
    """A port file resumed and saved as a directory, and that directory
    resumed and saved as a file, read back as the first file (JAX
    topology tests D/E/G): parameters, Adam's state and counters."""
    model = _vit()
    engine = _engine(model, "adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    _run_steps(engine, state, _steps(1, 8, 7))
    first = str(tmp_path / "a.ckpt")
    tckpt.save_checkpoint(first, "vit", model, 1, 0.5, state.optimizer,
                          state.step, state.updates)
    paths = [first, str(tmp_path / "b.ckpt"), str(tmp_path / "c.ckpt")]
    for src, dst in zip(paths, paths[1:]):
        m = _vit(seed=9)
        e = _engine(m, "adam")
        s = e.init_state(torch.Generator().manual_seed(9))
        tckpt.load_checkpoint(src, m, s.optimizer, train_state=s)
        save = (tckpt.save_directory if dst.endswith("b.ckpt")
                else tckpt.save_checkpoint)
        save(dst, "vit", m, 1, 0.5, s.optimizer, s.step, s.updates)
    assert os.path.isdir(paths[1]) and os.path.isfile(paths[2])
    want = tckpt.read_checkpoint(first)
    for other in paths[1:]:
        got = tckpt.read_checkpoint(other)
        assert (got["epoch"], got["loss"], got["model_name"]) == (1, 0.5,
                                                                  "vit")
        for key in ("step", "updates", "loss_scale"):
            assert got["state"][key] == want["state"][key], key
        for k, v in want["state"]["params"].items():
            assert torch.equal(got["state"]["params"][k], v), k
        for i, st in want["state"]["opt_state"]["state"].items():
            for key, v in st.items():
                assert torch.equal(
                    got["state"]["opt_state"]["state"][i][key], v), (i, key)


# -- (e) the layouts through test -f on a plain model ------------------

@pytest.mark.parametrize("layout", ["stacked", "scan"])
def test_a_layout_directory_tests_on_a_plain_model(tmp_path, layout):
    """A pipeline (stacked) or --scan-layers directory, ``test -f`` on a
    plain config (converted at load), gives the msgpack file's result
    for the same model (the intent of JAX's
    ``test_pipeline_orbax_checkpoint_tests_without_pipeline_mesh``)."""
    gen = torch.Generator().manual_seed(4)
    if layout == "stacked":
        model = PipelinedViT(10, dtype=torch.float32).init_weights(gen)
    else:
        model = registry.get_model("vit", 10, FULL, device="cpu",
                                   scan_layers=True).init_weights(gen)
    assert tckpt._model_layout(model) == layout
    results = []
    for fmt in ("orbax", "msgpack"):
        path = str(tmp_path / f"{fmt}.ckpt")
        save = (tckpt.save_directory if fmt == "orbax"
                else tckpt.save_checkpoint)
        save(path, "vit", model, 0, 1.0)
        results.append(tcli.run_test(tconfig.config_from_argv(
            ["test", "-d", str(tmp_path / "data"), "--rsl_path",
             str(tmp_path / f"rsl-{fmt}"), "-f", path, "--device", "cpu",
             "--debug", "--synthetic-fallback", "--dataset", "synthetic"])))
    assert results[0] == results[1]
    log = open(tmp_path / "rsl-orbax" / "test.log").read()
    assert f"checkpoint params converted: {layout} -> blocks" in log


# -- (f) the rest ------------------------------------------------------

def test_a_moe_directory_of_other_experts_is_refused(tmp_path, monkeypatch):
    """One line naming --moe-experts, from the DCP metadata's shapes
    before any tensor is read."""
    model = registry.get_model("vit", 10, FULL, device="cpu",
                               moe_experts=4)
    path = str(tmp_path / "moe.ckpt")
    tckpt.save_directory(path, "vit", model, 0, 1.0)
    monkeypatch.setattr(dcp_io, "read", lambda *a: pytest.fail("read"))
    for experts, side in ((2, "2-expert mixture-of-experts blocks"),
                          (0, "dense MLPs")):
        other = registry.get_model("vit", 10, FULL, device="cpu",
                                   moe_experts=experts)
        with pytest.raises(ValueError) as e:
            tckpt.load_checkpoint(path, other, restore_optimizer=False)
        assert str(e.value) == (
            f"checkpoint at {os.path.abspath(path)} holds 4-expert "
            f"mixture-of-experts blocks, the requested model {side} — "
            f"load with a matching --moe-experts (--moe-experts 4)")


def test_restore_without_optimizer_into_another_optimizer(tmp_path):
    """An Adam directory restores into an SGD run with
    ``restore_optimizer=False``: the parameters, and the SGD state left
    as it was; asked for the optimizer state, it is refused in one
    line."""
    model = _vit()
    engine = _engine(model, "adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    _run_steps(engine, state, _steps(1, 8, 3))
    path = str(tmp_path / "adam.ckpt")
    tckpt.save_directory(path, "vit", model, 0, 1.0, state.optimizer,
                         state.step, state.updates)
    other = _vit(seed=5)
    sgd = torch.optim.SGD(other.parameters(), lr=0.1, momentum=0.9)
    tckpt.load_checkpoint(path, other, sgd, restore_optimizer=False)
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert sgd.state_dict()["state"] == {}
    frozen = _vit(seed=5)
    head = torch.optim.Adam(frozen.head.parameters())
    with pytest.raises(ValueError, match="optimizer state does not fit the "
                                         "optimizer: the checkpoint trains"):
        tckpt.load_checkpoint(path, frozen, head)


def _cli(tmp_path, *extra):
    return tcli.main(["train", "-d", str(tmp_path / "data"), "--rsl_path",
                      str(tmp_path / "rsl"), "--model", "mlp", "--device",
                      "cpu", "--debug", "--synthetic-fallback", "--dataset",
                      "synthetic", "--ckpt-format", "orbax", *extra])


def test_a_torn_head_falls_back_to_the_previous_directory(tmp_path):
    """Two rolling directories kept; the newest torn after its swap:
    ``train -f`` on it rejects it loudly (log line and ``ckpt_fallback``
    event) and resumes from the one before."""
    assert _cli(tmp_path, "-e", "2", "--keep-ckpts", "2") == 0
    rsl = str(tmp_path / "rsl")
    head = tckpt.checkpoint_path(rsl, "synthetic", "mlp", 1)
    assert tckpt.list_checkpoints(rsl, "synthetic", "mlp") == [
        head, tckpt.checkpoint_path(rsl, "synthetic", "mlp", 0)]
    faults._tear(head)
    assert _cli(tmp_path, "-e", "3", "-f", head, "--telemetry") == 0
    log = open(os.path.join(rsl, "test.log")).read()
    assert f"CHECKPOINT REJECTED {head!r}" in log
    assert "epoch:0001: model loaded from" in log
    events = [json.loads(line) for line in open(os.path.join(
        rsl, "telemetry", "rank0.jsonl"))]
    fallback = [e for e in events if e.get("name") == "ckpt_fallback"]
    assert fallback and fallback[0]["attrs"]["skipped"] == \
        os.path.basename(head)


def test_async_restores_bit_identically_to_sync(tmp_path):
    """``save_directory_async`` (1 process: the snapshot here, DCP and
    the finalize on the writer's thread) restores to what the synchronous
    save restores, and to the state saved; no .tmp is left (JAX
    ``test_orbax_async_restore_bit_identical_to_sync``)."""
    model = _vit()
    engine = _engine(model, "adam")
    state = engine.init_state(torch.Generator().manual_seed(0))
    _run_steps(engine, state, _steps(1, 8, 5))
    want = parallel.full_state(model, state.optimizer)
    sync_path, async_path = (str(tmp_path / n) for n in ("sync", "async"))
    args = ("vit", model, 3, 0.25, state.optimizer, state.step,
            state.updates)
    tckpt.save_directory(sync_path, *args)
    saver = tckpt.AsyncSaver()
    tckpt.save_directory_async(saver, async_path, *args)
    _run_steps(engine, state, _steps(1, 8, 6))  # moves the live state
    saver.close()
    assert os.path.isdir(async_path)
    assert not os.path.exists(async_path + ".tmp")
    for path in (sync_path, async_path):
        m = _vit(seed=8)
        e = _engine(m, "adam")
        s = e.init_state(torch.Generator().manual_seed(8))
        assert tckpt.load_checkpoint(path, m, s.optimizer,
                                     train_state=s) == (4, 0.25, 1)
        _equal_states(parallel.full_state(m, s.optimizer), want)


def test_cli_async_directories_equal_the_sync_ones(tmp_path):
    """``train --ckpt-async --ckpt-format orbax`` in one process writes
    the directories the synchronous train writes, read back tensor for
    tensor, with no .tmp left."""
    rsl = {}
    for name, extra in (("sync", []), ("async", ["--ckpt-async"])):
        rsl[name] = tmp_path / name
        assert tcli.main(["train", "-d", str(tmp_path / "data"),
                          "--rsl_path", str(rsl[name]), "--model", "mlp",
                          "--device", "cpu", "--debug", "--synthetic-fallback",
                          "--dataset", "synthetic", "--ckpt-format", "orbax",
                          "-e", "1", *extra]) == 0
    for name in ("checkpoint-synthetic-mlp-000.ckpt",
                 "bestmodel-synthetic-mlp.ckpt"):
        a, b = (tckpt.read_checkpoint(str(rsl[n] / name))["state"]
                for n in ("sync", "async"))
        for k, v in a["params"].items():
            assert torch.equal(b["params"][k], v), k
        for i, st in a["opt_state"]["state"].items():
            for key, v in st.items():
                assert torch.equal(b["opt_state"]["state"][i][key], v)
        assert (a["step"], a["updates"]) == (b["step"], b["updates"])
    assert not [p for p in rsl["async"].iterdir()
                if p.name.endswith(".tmp")]


@pytest.mark.parametrize("content", [None, "not json {"])
def test_meta_errors_are_jaxs_word_for_word(tmp_path, content):
    """A directory without meta.json, or with garbage in it: JAX's one
    line, word for word (JAX ``tests/test_ckpt_lineage.py:160-175``)."""
    d = tmp_path / "notackpt"
    d.mkdir()
    if content is not None:
        (d / "meta.json").write_text(content)
    with pytest.raises(ValueError) as jax_err:
        jax_ckpt.load_checkpoint(str(d), None)
    with pytest.raises(ValueError) as port_err:
        tckpt.load_checkpoint(str(d), _vit(), restore_optimizer=False)
    assert str(port_err.value) == str(jax_err.value)
    assert "\n" not in str(port_err.value)


def test_a_jax_written_orbax_directory_is_refused(tmp_path):
    """A directory the JAX package's orbax wrote (its tensorstore
    payload) is refused in one line, by ``test -f`` too."""
    model = jax_get_model("mlp", 10, half_precision=False)
    tx = jax_make_optimizer("adam", 1e-3, 0.9, 0.1, 4, False)
    engine = JaxEngine(model, "mlp", jax_loss_fn("cross_entropy"), tx,
                       mean=0.45, std=0.2, input_size=28,
                       half_precision=False)
    path = str(tmp_path / "bestmodel-mnist-mlp.ckpt")
    jax_ckpt.save_checkpoint(path, "mlp", engine.init_state(
        jax.random.PRNGKey(7)), 3, 0.25, fmt="orbax")
    message = (f"{path}: written by the JAX package's orbax (tensorstore "
               f"payload); the port reads directories it wrote and the JAX "
               f"package's msgpack files; re-save it with --ckpt-format "
               f"msgpack")
    assert tckpt.get_checkpoint_model_name(path) == "mlp"
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tckpt.load_checkpoint(path, registry.get_model(
            "mlp", 10, FULL, device="cpu"), restore_optimizer=False)
    assert tcli.main(["test", "-d", str(tmp_path / "data"), "--rsl_path",
                      str(tmp_path / "rsl"), "-f", path, "--device", "cpu",
                      "--debug", "--synthetic-fallback"]) == 1


def test_rotation_removes_a_directory_and_its_record(tmp_path):
    rsl = str(tmp_path)
    paths = [tckpt.checkpoint_path(rsl, "mnist", "vit", e) for e in (0, 1)]
    model = _vit()
    for e, path in enumerate(paths):
        tckpt.save_directory(path, "vit", model, e, 1.0)
    os.makedirs(paths[1] + ".tmp")      # a save cut before its swap
    assert tckpt.list_checkpoints(rsl, "mnist", "vit") == paths[::-1]
    assert tckpt.newest_checkpoint(rsl, "mnist", "vit") == paths[1]
    tckpt.rotate_checkpoint(rsl, "mnist", "vit", 1)
    assert not os.path.exists(paths[0])
    assert [r["file"] for r in tckpt._lineage_load(rsl)["records"]] == [
        os.path.basename(paths[1])]


def test_the_rollout_watch_takes_a_directory(tmp_path):
    """The ledger's newest entry is a directory; its sha is the
    meta.json checksum, which ``verify_sha`` and ``lineage_info`` agree
    on until a payload file is torn."""
    rsl = str(tmp_path)
    path = tckpt.checkpoint_path(rsl, "mnist", "vit", 0)
    tckpt.save_directory(path, "vit", _vit(), 0, 1.0)
    entry = rollout.newest_lineage_entry(rsl)
    assert entry["path"] == path
    assert entry["sha256"] == tckpt.lineage_info(path)["sha256"]
    assert rollout.verify_sha(path, entry["sha256"])
    faults._tear(path)
    assert not rollout.verify_sha(path, entry["sha256"])


def test_a_peer_lost_inside_a_directory_save_is_a_peer_loss():
    """DCP's ``CheckpointException`` (a BaseException holding each
    rank's failure, with no cause) around a gloo peer loss, raised
    through the save's RuntimeError, is a peer loss; around another
    failure it is not."""
    gloo = RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:"
                        "534] Connection closed by peer [127.0.0.1]:4321")
    backend = torch.distributed.DistBackendError("NCCL communicator was "
                                                 "aborted on rank 1")
    for failure in (gloo, backend):
        exc = dcp_io.CheckpointException("save", {1: (failure, None)})
        assert elastic.is_peer_loss(exc)
        wrapped = RuntimeError("checkpoint directory not written")
        wrapped.__cause__ = exc
        assert elastic.is_peer_loss(wrapped)
    assert not elastic.is_peer_loss(dcp_io.CheckpointException(
        "save", {0: (ValueError("bad shape"), None)}))
