"""The JAX chaos gate's stages A-F (``scripts/chaos_gate.py``) re-posed on
the port, through its CLI, at a tiny vit (2 blocks of width 32,
``--attention full``) on the CPU:

  A. a fault-free 3-epoch run: the recovery target;
  B. the same run under the gate's plan: two retried dataset reads, a
     SIGTERM at epoch 1's rolling save (a clean preemption after epoch 1)
     and a torn write of that rolling file;
  C. the resume from the torn head falls back to the epoch-0 snapshot and
     ends equal, at 1e-6 in f32, to A;
  D. two ranks, a fatal fault on rank 0: both exit 1 with ``peer_failure``
     in their telemetry, no hang;
  E. three ``--elastic`` ranks, ``rank_loss`` on rank 2 in epoch 1: ranks
     0 and 1 reconfigure to a world of 2, whose last snapshot is allclose
     (1e-6) to an uninterrupted 2-rank run resumed from a copy of the
     same epoch-0 snapshot;
  F. in the same run, a fourth process with ``--elastic-join``, started
     with the world and holding its claim until the shrink, then grows
     the world back to 3, whose final state is checked the same way
     against a 3-rank run from the grow's snapshot.

Every rank is one process (``tests/_torch_elastic_child.py``) with the
env:// variables set by hand, as ``--elastic`` must be launched."""

import functools
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import faults, flightrec, telemetry
from distributedpytorch_tpu_torch.faults import RANK_LOSS_EXIT
from distributedpytorch_tpu_torch.models import vit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_elastic_child.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_elastic_child import TINY_VIT  # noqa: E402

EPOCHS = 4
DEADLINE_S = 150.0
TOL = 1e-6
# the gate's plan: ckpt.save and ckpt.finalize hit 3 is epoch 1's rolling
# save (epoch 0 writes the rolling file, then the best one)
CHAOS_PLAN = {"seed": 0, "faults": [
    {"site": "data.read", "kind": "ioerror", "after_n": 0, "count": 2},
    {"site": "ckpt.save", "kind": "preempt", "after_n": 2, "count": 1},
    {"site": "ckpt.finalize", "kind": "torn", "after_n": 2, "count": 1,
     "path_match": "checkpoint-"}]}
# World 3, -b 16, --debug: ceil(200 / 3 / 16) = 5 steps a split, so epoch
# 0 is host-batch hits 1-10 (train and valid) and hit 13 is train step 3
# of epoch 1, after the epoch-0 snapshot.
RANK_LOSS = {"site": "data.host_batch", "kind": "rank_loss",
             "after_n": 12, "count": 1, "rank": 2}
# a pure sleep on rank 0 from epoch 1 on: the shrunken world stays open
# long enough for the joiner's claim to land
STALL = {"site": "data.host_batch", "kind": "stall", "after_n": 10,
         "count": 1000, "stall_s": 0.15, "rank": 0}


@pytest.fixture(autouse=True)
def _clean():
    yield
    faults.configure(None)
    telemetry._active = telemetry.Telemetry(enabled=False)
    flightrec._active = flightrec.FlightRecorder(enabled=False)


def _args(data: str, rsl: str, epochs: int = EPOCHS) -> list:
    return ["train", "-d", data, "--rsl_path", rsl, "--model", "vit",
            "--attention", "full", "--device", "cpu", "--debug",
            "--synthetic-fallback", "--dataset", "synthetic",
            "-e", str(epochs), "-b", "16", "--keep-ckpts", str(epochs),
            "--telemetry", "--data-mode", "stream"]


def _events(rsl: str, rank: int, name: str) -> list:
    path = os.path.join(rsl, "telemetry", f"rank{rank}.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                e = json.loads(line)
            except ValueError:
                continue        # a line being written
            if e.get("name") == name:
                out.append(e)
    return out


def _params(path: str) -> dict:
    return torch.load(path, weights_only=False)["state"]["params"]


def _assert_close(a: str, b: str) -> None:
    pa, pb = _params(a), _params(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.allclose(pa[k].double(), pb[k].double(), rtol=0,
                              atol=TOL), k


def _launch(args: list, logs: str, tag: str, world: int = 0,
            port: int = 0, child: tuple = ()) -> list:
    """``world`` rank processes of the CLI (a joiner with world 0), each
    its own log, ``child`` the child's own options; returns
    [(rank, Popen, log)]."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(max(world, 1)):
        extra = {} if world == 0 else {
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        log = os.path.join(logs, f"{tag}-{rank if world else 'join'}.log")
        with open(log, "w") as f:
            procs.append((rank if world else "join", subprocess.Popen(
                [sys.executable, CHILD, "--tiny-vit", "--settle", "3",
                 *child, "--", *args], cwd=ROOT, env={**env, **extra},
                stdout=f, stderr=subprocess.STDOUT), log))
    return procs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs: list) -> dict:
    """{rank: exit code} once all exit; a rank past the deadline is
    killed and fails the test with its log."""
    deadline = time.monotonic() + DEADLINE_S
    rcs = {}
    try:
        for rank, p, log in procs:
            try:
                rcs[rank] = p.wait(timeout=max(1.0, deadline
                                               - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} hung:\n{open(log).read()[-3000:]}")
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def _check_rcs(rcs: dict, procs: list, want: dict) -> None:
    for rank, p, log in procs:
        assert rcs[rank] == want.get(rank, 0), \
            f"rank {rank} exited {rcs[rank]}:\n{open(log).read()[-3000:]}"


def test_stages_a_b_c_retries_preempt_torn_head_resume(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(vit.ViT, "__init__", functools.partialmethod(
        vit.ViT.__init__, **TINY_VIT))
    monkeypatch.chdir(tmp_path)
    data = str(tmp_path / "data")
    ref = str(tmp_path / "ref")
    assert tcli.main(_args(data, ref, 3)) == 0                    # A
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(CHAOS_PLAN))
    rsl = str(tmp_path / "chaos")
    assert tcli.main(_args(data, rsl, 3) + ["--fault-plan", str(plan)]) \
        == 0
    fired = sorted(e["attrs"]["kind"]
                   for e in _events(rsl, 0, "fault_injected"))   # B
    assert fired == ["ioerror", "ioerror", "preempt", "torn"]
    assert len(_events(rsl, 0, "retry")) == 2
    assert not _events(rsl, 0, "retry_giveup")
    assert [e["attrs"]["after_epoch"]
            for e in _events(rsl, 0, "preempt")] == [1]
    head = tckpt.checkpoint_path(rsl, "synthetic", "vit", 1)
    assert "checksum" in tckpt.verify_checkpoint(head)
    assert not os.path.exists(tckpt.checkpoint_path(rsl, "synthetic", "vit",
                                                    2))
    assert tcli.main(_args(data, rsl, 3) + ["-f", head]) == 0   # C
    assert [e["attrs"]["skipped"] for e in _events(
        rsl, 0, "ckpt_fallback")] == [os.path.basename(head)]
    log = open(os.path.join(rsl, "test.log")).read()
    assert "Epoch: 002" in log and "Epoch: 003" in log \
        and "Epoch: 001" not in log
    _assert_close(tckpt.checkpoint_path(rsl, "synthetic", "vit", 2),
                  tckpt.checkpoint_path(ref, "synthetic", "vit", 2))


def test_stage_d_fatal_fault_ends_both_ranks(tmp_path):
    plan = tmp_path / "fatal.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "ckpt.save", "kind": "fatal", "after_n": 0, "count": 1,
         "rank": 0}]}))
    rsl = str(tmp_path / "rsl")
    procs = _launch(_args(str(tmp_path / "data"), rsl)
                    + ["--fault-plan", str(plan)], str(tmp_path), "fatal",
                    world=2, port=_free_port())
    rcs = _wait(procs)
    _check_rcs(rcs, procs, {0: 1, 1: 1})
    for rank in (0, 1):
        events = _events(rsl, rank, "peer_failure")
        assert [e["attrs"]["local"] for e in events] == [rank == 0]
    assert "fatal failure: injected fatal fault at ckpt.save" in \
        open(procs[0][2]).read()


@pytest.fixture(scope="module")
def elastic_world(tmp_path_factory):
    """Stages E and F's one run: three --elastic ranks lose rank 2 in
    epoch 1 and shrink to 2; a joiner, started with the world, drops its
    claim once rank 0's telemetry shows the shrink and grows the world
    back to 3.  Then, at once, the references: 2 ranks from the epoch-0
    snapshot to the grow's snapshot, and 3 ranks from the grow's snapshot
    to the end."""
    work = tmp_path_factory.mktemp("elastic")
    data, rsl = str(work / "data"), str(work / "rsl")
    plan = work / "plan.json"
    plan.write_text(json.dumps({"faults": [RANK_LOSS, STALL]}))
    shrunk = work / "shrunk"
    args = _args(data, rsl, EPOCHS) + ["--elastic", "--health-timeout", "20"]
    procs = _launch(args + ["--fault-plan", str(plan)], str(work), "world",
                    world=3, port=_free_port())
    # the joiner's Python and torch start-up runs beside the world's
    # epoch 0; only its claim waits for the shrink
    joiner = _launch(args + ["--elastic-join", "--elastic-join-wait", "60"],
                     str(work), "world", child=("--claim-after",
                                                str(shrunk)))
    deadline = time.monotonic() + DEADLINE_S
    while not _events(rsl, 0, "elastic/reconfigure"):
        if time.monotonic() > deadline or procs[0][1].poll() is not None:
            joiner[0][1].kill()
            _wait(procs + joiner)
            pytest.fail("no shrink:\n" + open(procs[0][2]).read()[-3000:])
        time.sleep(0.05)
    shrunk.write_text("")
    procs += joiner
    rcs = _wait(procs)
    _check_rcs(rcs, procs, {2: RANK_LOSS_EXIT})
    resumes = [e["attrs"]["epoch"] for e in _events(rsl, 0, "elastic/resume")]
    assert len(resumes) == 2 and resumes[0] == 1 and 2 <= resumes[1] < EPOCHS
    grow_at = resumes[1]
    refs, started = {}, []
    for world, first, epochs in ((2, 0, grow_at), (3, grow_at - 1, EPOCHS)):
        ref = str(work / f"ref{world}")
        os.makedirs(ref)
        snap = tckpt.checkpoint_path(rsl, "synthetic", "vit", first)
        shutil.copy2(snap, ref)
        refs[world] = (ref, epochs)
        started += _launch(_args(data, ref, epochs) + ["-f", os.path.join(
            ref, os.path.basename(snap))], str(work), f"ref{world}",
            world=world, port=_free_port())
    _check_rcs(_wait(started), started, {})
    return rsl, grow_at, refs


def test_stage_e_rank_loss_shrinks_and_matches_two_ranks(elastic_world):
    rsl, grow_at, refs = elastic_world
    for rank in (0, 1):
        first = _events(rsl, rank, "elastic/reconfigure")[0]["attrs"]
        assert (first["new_world"], first["old_rank"], first["new_rank"],
                first["grow"]) == (2, rank, rank, False)
        assert _events(rsl, rank, "peer_loss")
        assert [e["attrs"]["epoch"] for e in _events(
            rsl, rank, "elastic/resume")][0] == 1
    dumps = flightrec.load_dumps(rsl)
    assert all("reconfigure" in dumps[r]["reasons"] for r in (0, 1))
    ref, epochs = refs[2]
    _assert_close(tckpt.checkpoint_path(rsl, "synthetic", "vit", epochs - 1),
                  tckpt.checkpoint_path(ref, "synthetic", "vit", epochs - 1))


def test_stage_f_joiner_grows_back_and_matches_three_ranks(elastic_world):
    rsl, grow_at, refs = elastic_world
    for rank in (0, 1):
        recs = _events(rsl, rank, "elastic/reconfigure")
        assert [e["attrs"]["new_world"] for e in recs] == [2, 3]
        assert recs[1]["attrs"]["grow"] and len(recs[1]["attrs"]["joined"]) \
            == 1
    [join] = _events(rsl, 2, "elastic/join")
    assert (join["attrs"]["new_rank"], join["attrs"]["new_world"]) == (2, 3)
    assert [e["attrs"]["epoch"] for e in _events(
        rsl, 2, "elastic/resume")] == [grow_at]
    ref, epochs = refs[3]
    _assert_close(tckpt.checkpoint_path(rsl, "synthetic", "vit", epochs - 1),
                  tckpt.checkpoint_path(ref, "synthetic", "vit", epochs - 1))
