"""The port's data-parallel world on the CPU: two processes on gloo.

``tests/test_distributed.py`` holds the JAX package's sharded step equal
to the single-device step on the same global batch.  Here the same
statement for the port: two ranks (``tests/_torch_ddp_child.py`` under
the env:// variables torchrun sets), each with its rank-major half of a
global batch of 8, take three SGD steps of cnn (with K5's plain
version), mlp and a small BatchNorm resnet, and must end where one
process ends on the whole global batch with the same draws: parameters,
BatchNorm running statistics and the steps' metrics.  The first step
spreads the valid rows 4 + 1 over the ranks, so a mean of per-rank means
would differ from the global masked mean.  Tolerance: 1e-5 of each
tensor's largest value in f32, and 1e-6 for the metrics: the sums run in
another order (per rank, then across ranks), and in the resnet through
BatchNorm's statistics and their gradients (1.9e-6 seen on a bias).

Then ``train --model cnn --debug --device cpu`` under ``torchrun
--nproc_per_node 2``: one ``test.log`` and one set of checkpoints, all
from rank 0.  Every child process has its own time limit.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._subproc import REPO, await_all, free_port

CHILD = os.path.join(REPO, "tests", "_torch_ddp_child.py")
TIMEOUT = 240.0


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE", "XLA_FLAGS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)
    return env


def _run_world(name, tmp_path, world, *args):
    port = str(free_port())
    procs, logs = [], []
    for rank in range(world):
        env = _env() if world == 1 else _env(
            WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=port)
        log = str(tmp_path / f"{name}-w{world}-r{rank}.log")
        out = open(log, "wb")
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, name,
             str(tmp_path / f"{name}-w{world}-r{rank}.pt"), *args],
            cwd=REPO, env=env, stdout=out, stderr=out))
        out.close()
        logs.append(log)
    await_all(procs, logs, timeout=TIMEOUT)
    return [torch.load(tmp_path / f"{name}-w{world}-r{r}.pt",
                       weights_only=True) for r in range(world)]


@pytest.mark.parametrize("name", ["cnn", "mlp", "resnet_small"])
def test_two_ranks_equal_one_process_on_the_global_batch(name, tmp_path):
    one = _run_world(name, tmp_path, 1)[0]
    two = _run_world(name, tmp_path, 2)
    assert not one["ddp"] and all(r["ddp"] for r in two)
    assert [r["rank"] for r in two] == [0, 1] and two[0]["world"] == 2
    for r in two:
        # every rank holds the same parameters and statistics...
        for k, v in r["state"].items():
            assert torch.equal(v, two[0]["state"][k]), (r["rank"], k)
        # ...and the same global metrics
        assert r["metrics"] == two[0]["metrics"]
    for k, v in one["state"].items():
        scale = max(v.abs().max().item(), 1e-6)
        err = (two[0]["state"][k] - v).abs().max().item() / scale
        assert err <= 1e-5, (k, err)
    assert any("running_var" in k for k in one["state"]) == \
        (name == "resnet_small")
    np.testing.assert_allclose(np.array(two[0]["metrics"]),
                               np.array(one["metrics"]), rtol=1e-6,
                               atol=1e-6)
    # the uneven first step: 5 valid rows of 8 in the global batch
    assert one["metrics"][0][2] == 5.0


def test_two_ranks_equal_one_process_in_f64(tmp_path):
    """The child's f64 mode (f64 compute, f32 parameters, identity affine),
    which chip_smoke runs on the card: the f32 parameter casts per rank
    leave 1e-6 of each tensor's largest value."""
    one = _run_world("resnet_small", tmp_path, 1, "--precision", "f64")[0]
    two = _run_world("resnet_small", tmp_path, 2, "--precision", "f64")
    assert two[0]["backend"] == "gloo" and one["backend"] is None
    for k, v in one["state"].items():
        assert torch.equal(two[1]["state"][k], two[0]["state"][k]), k
        scale = max(v.abs().max().item(), 1e-6)
        err = (two[0]["state"][k] - v).abs().max().item() / scale
        assert err <= 1e-6, (k, err)
    np.testing.assert_allclose(np.array(two[0]["metrics"]),
                               np.array(one["metrics"]), rtol=1e-6,
                               atol=1e-6)
    assert one["metrics"][0][2] == 5.0 and one["k5"] == 0


def test_torchrun_cnn_train_writes_once_from_rank_zero(tmp_path):
    rsl = tmp_path / "rsl"
    log = str(tmp_path / "torchrun.log")
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m", "distributedpytorch_tpu_torch",
             "train", "-d", str(tmp_path / "data"), "--rsl_path", str(rsl),
             "--model", "cnn", "--device", "cpu", "--debug",
             "--synthetic-fallback", "-e", "2"],
            cwd=REPO, env=_env(), stdout=out, stderr=out)
    await_all([proc], [log], timeout=TIMEOUT)
    # the flight recorder is on by default: each rank dumps its ring
    assert sorted(os.listdir(rsl)) == [
        "bestmodel-mnist-cnn.ckpt", "checkpoint-mnist-cnn-001.ckpt",
        "ckpt-lineage.json", "flightrec-rank0.json", "flightrec-rank1.json",
        "test.log"]
    text = (rsl / "test.log").read_text()
    for pattern in (
            r"process: 0/2, world size: 2, backend: gloo",
            r"batch size: 64/replica \(128 global\), prefetch: 2",
            r"  Throughput  \| [\d,]+ samples/s/chip \(2 chips\)",
            r"train: kernel launches flash_fwd 0, flash_dq 0, flash_dkv 0, "
            r"conv_dw 0 over 4 train steps and 4 eval batches"):
        assert re.search(pattern, text), pattern
    # rank 0 logged every epoch once; rank 1 wrote nothing
    assert text.count("epoch   2 =") == 1
    assert "process: 1/2" not in text
