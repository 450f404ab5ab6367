"""The port's elastic machinery against the JAX package's (``elastic.py``,
``runtime.agree_health``, ``ShardedLoader.reshard``): the admission
policy on a table, the loader resharded to N-1 and N+1 ranks against
JAX's ``reshard`` and against a loader born at that world, the
filesystem rendezvous and the join claims, ``is_peer_loss`` on the texts
a killed gloo peer really produces, and ``agree_health``'s flags and its
bound over 2-rank gloo worlds (``tests/_torch_elastic_child.py``).  Then
the CLI's elastic flags with the JAX defaults and launch-time checks."""

import json
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from distributedpytorch_tpu import elastic as jelastic
from distributedpytorch_tpu import faults as jfaults
from distributedpytorch_tpu.config import config_from_argv as jax_argv
from distributedpytorch_tpu.data.datasets import Split as JSplit
from distributedpytorch_tpu.data.pipeline import ShardedLoader as JLoader
from distributedpytorch_tpu.runtime import DATA_AXIS
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import elastic, faults, runtime
from distributedpytorch_tpu_torch.data.datasets import Split
from distributedpytorch_tpu_torch.data.pipeline import ShardedLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_elastic_child.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_elastic_child import CASES, LATE_S, TIMEOUT_S  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_generation():
    elastic._reset_for_tests()
    faults.install(None)
    yield
    elastic._reset_for_tests()
    faults.install(None)


@pytest.fixture
def fast_settle(monkeypatch):
    for mod in (elastic, jelastic):
        monkeypatch.setattr(mod, "SETTLE_S", 0.2)
        monkeypatch.setattr(mod, "WORLD_WAIT_S", 2.0)
        monkeypatch.setattr(mod, "RENDEZVOUS_DEADLINE_S", 5.0)


POLICY = [
    (2, ["b", "a"], "capacity", 1),
    (2, [], "capacity", 1),
    (2, ["c", "a", "b"], "fixed:3", 1),
    (3, ["a"], "fixed:3", 1),
    (1, ["a", "b"], "fixed:2", 1),
    (1, ["a"], "capacity", 4),
    (1, ["a", "b", "c"], "capacity", 4),
    (2, ["x"], "fixed:5", 9),
    (4, ["a", "b"], "fixed:1", 1),
]


@pytest.mark.parametrize("live,ids,target,floor", POLICY)
def test_join_policy_equals_jax(live, ids, target, floor):
    assert elastic.evaluate_join_policy(live, ids, target, floor) == \
        jelastic.evaluate_join_policy(live, ids, target, floor)


@pytest.mark.parametrize("target", ["fixed:x", "fixed:0", "auto", ""])
def test_bad_join_policy_fails_as_in_jax(target):
    with pytest.raises(ValueError) as want:
        jelastic.evaluate_join_policy(1, [], target, 1)
    with pytest.raises(ValueError) as got:
        elastic.evaluate_join_policy(1, [], target, 1)
    assert str(got.value) == str(want.value)


def _split(n: int):
    images = (np.arange(n * 4) % 251).astype(np.uint8).reshape(n, 2, 2)
    images[:, 0, 0] = np.arange(n) % 256
    labels = (np.arange(n) % 10).astype(np.int32)
    return Split(images, labels), JSplit(images, labels)


def _port_world_batches(loader_of, world: int, epoch: int) -> list:
    """The global batches of a port world: each rank's loader, rows
    concatenated rank-major (the JAX loader's global batch)."""
    per_rank = [list(loader_of(r).epoch(epoch)) for r in range(world)]
    return [[np.concatenate([per_rank[r][i][k].numpy()
                             for r in range(world)])
             for k in range(3)] for i in range(len(per_rank[0]))]


@pytest.mark.parametrize("old,new", [(3, 2), (2, 3), (4, 3), (1, 2)])
@pytest.mark.parametrize("n", [37, 50])
def test_reshard_enumerates_as_jax_and_as_born(old, new, n):
    """Resharded from ``old`` ranks to ``new``: the port's loaders give
    the JAX reshard's global batches, step for step, and those of port
    loaders born at ``new`` ranks; every sample once an epoch."""
    split, jsplit = _split(n)
    mesh = Mesh(np.array(jax.devices()[:new]), (DATA_AXIS,))
    jloader = JLoader(jsplit, Mesh(np.array(jax.devices()[:old]),
                                   (DATA_AXIS,)), batch_per_replica=4,
                      shuffle=True, seed=5).reshard(mesh)
    olds = [ShardedLoader(split, 4, True, 5, "cpu", world=old, rank=r)
            for r in range(old)]

    def resharded(r):
        return olds[min(r, old - 1)].reshard(runtime.Mesh(
            data_parallel=new, data_index=r))

    def born(r):
        return ShardedLoader(split, 4, True, 5, "cpu", world=new, rank=r)

    for epoch in (0, 1):
        want = [[np.asarray(x) for x in b] for b in jloader.epoch(epoch)]
        for loader_of in (resharded, born):
            got = _port_world_batches(loader_of, new, epoch)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
        seen = np.concatenate([b[0][b[2]][:, 0, 0] for b in want])
        assert sorted(seen.tolist()) == list(range(n))


def _claim(gen_dir: str, rank: int) -> None:
    os.makedirs(gen_dir, exist_ok=True)
    with open(os.path.join(gen_dir, f"rank-{rank}.json"), "w") as f:
        json.dump({"old_rank": rank, "pid": 0}, f)


def _join_claim(elastic_dir, jid: str) -> None:
    joins = os.path.join(str(elastic_dir), "joins")
    os.makedirs(joins, exist_ok=True)
    with open(os.path.join(joins, f"join-{jid}.json"), "w") as f:
        json.dump({"id": jid, "host": "h", "pid": 1}, f)


def test_lowest_claimant_opens_the_store_and_publishes(tmp_path,
                                                       fast_settle):
    gen_dir = str(tmp_path / "gen-1")
    _claim(gen_dir, 1)
    _claim(gen_dir, 2)
    doc, store = elastic._rendezvous(str(tmp_path), 1, 0, 4, "gloo")
    assert doc["members"] == [0, 1, 2] and doc["joiners"] == []
    host, port = doc["coordinator"].rsplit(":", 1)
    assert int(port) == store.port and doc["backend"] == "gloo"
    with open(os.path.join(gen_dir, "world.json")) as f:
        assert json.load(f) == doc
    # a follower reads the same world
    assert elastic._rendezvous(str(tmp_path), 1, 2, 4, "gloo") == (doc,
                                                                   None)


@pytest.mark.parametrize("case", ["straggler", "nothing_died", "no_world"])
def test_rendezvous_failures_as_in_jax(case, tmp_path, fast_settle):
    """The same RuntimeError texts as the JAX rendezvous."""
    def setup(d):
        gen_dir = os.path.join(d, "gen-1")
        if case == "straggler":
            os.makedirs(gen_dir)
            with open(os.path.join(gen_dir, "world.json"), "w") as f:
                json.dump({"generation": 1, "members": [0, 1],
                           "coordinator": "localhost:1"}, f)
            return 2, 3
        if case == "nothing_died":
            _claim(gen_dir, 1)
            _claim(gen_dir, 2)
            return 0, 3
        _claim(gen_dir, 0)
        return 2, 4

    texts = []
    for name, run in (("jax", lambda d, r, w: jelastic._rendezvous(
            d, gen=1, old_rank=r, old_world=w)),
                      ("port", lambda d, r, w: elastic._rendezvous(
                          d, 1, r, w, "gloo"))):
        d = str(tmp_path / name)
        rank, world = setup(d)
        with pytest.raises(RuntimeError) as e:
            run(d, rank, world)
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def test_grow_rendezvous_admits_and_declines(tmp_path, fast_settle):
    _claim(str(tmp_path / "gen-1"), 1)
    _join_claim(tmp_path, "hostx-77")
    _join_claim(tmp_path, "hostx-88")
    doc, store = elastic._rendezvous(str(tmp_path), 1, 0, 2, "gloo",
                                     grow=True, target="fixed:3")
    assert doc["members"] == [0, 1] and doc["joiners"] == ["hostx-77"]
    joins = tmp_path / "joins"
    admit = json.loads((joins / "admit-hostx-77.json").read_text())
    assert (admit["new_rank"], admit["new_world"], admit["backend"]) == \
        (2, 3, "gloo")
    assert admit["coordinator"] == doc["coordinator"]
    assert "fixed target 3" in json.loads(
        (joins / "decline-hostx-88.json").read_text())["reason"]
    assert elastic.pending_joins(str(tmp_path)) == []
    with pytest.raises(elastic.JoinDeclinedError, match="fixed target 3"):
        elastic.wait_for_admission(str(tmp_path), "hostx-88", 1.0)
    assert elastic.wait_for_admission(str(tmp_path), "hostx-77",
                                      1.0) == admit


def test_join_claims_dedupe_and_time_out(tmp_path):
    """A rank_join fault duplicates the claim, which dedupes by the id
    inside it, as in the JAX package; a torn claim is skipped; a joiner
    with no verdict times out."""
    faults.configure("elastic.join:rank_join:0")
    jid = elastic.request_join(str(tmp_path))
    names = sorted(os.listdir(tmp_path / "joins"))
    assert names == [f"join-{jid}-dup.json", f"join-{jid}.json"]
    assert elastic.pending_joins(str(tmp_path)) == [jid] == \
        jelastic.pending_joins(str(tmp_path))
    (tmp_path / "joins" / "join-torn.json").write_text("{")
    assert elastic.pending_joins(str(tmp_path)) == [jid]
    with pytest.raises(TimeoutError, match="no admit/decline marker"):
        elastic.wait_for_admission(str(tmp_path), jid, 0.3)


def test_generation_state_and_dirs(tmp_path):
    assert elastic.generation() == 0 and not elastic.reconfigured()
    assert elastic.default_elastic_dir("/r") == \
        jelastic.default_elastic_dir("/r")
    for name in ("SETTLE_S", "WORLD_WAIT_S", "RENDEZVOUS_DEADLINE_S",
                 "JOIN_WAIT_S"):
        assert getattr(elastic, name) == getattr(jelastic, name)


def _world(mode: str, tmp_path) -> list:
    """Runs the 2-rank probe world ``mode``; returns each rank's report
    (None for a rank that vanished)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS")}
    procs, outs = [], []
    for rank in range(2):
        out = str(tmp_path / f"{mode}-{rank}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, "--probe", mode, out], cwd=ROOT,
            env={**env, "WORLD_SIZE": "2", "RANK": str(rank),
                 "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": "2",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        p.communicate(timeout=120)
    return [json.load(open(o)) if os.path.exists(o) else None for o in outs]


@pytest.fixture(scope="module")
def flags_world(tmp_path_factory):
    return _world("flags", tmp_path_factory.mktemp("flags"))


def test_agree_health_flags_equal_jax_over_two_ranks(flags_world):
    """Each agreement of the 2-rank world returns the flags the JAX
    agree_health gives, OR-ed over the ranks' own answers."""
    got = flags_world[0]["agree"]
    want = []
    for case in CASES:
        per_rank = [jax_agree(*flags) for flags in case]
        want.append([any(r[i] for r in per_rank) for i in range(3)])
    assert got == want
    assert flags_world[1] is None       # rank 1 vanished afterwards


def jax_agree(failed, shutdown, grow):
    from distributedpytorch_tpu import runtime as jruntime

    return jruntime.agree_health(bool(failed), bool(shutdown),
                                 grow=bool(grow))


def test_killed_gloo_peer_texts_are_peer_loss(flags_world):
    """The texts a vanished gloo peer gives its survivor, in DDP's
    backward and in the next agreement (captured from the probe world,
    pinned here), are peer losses, as the JAX markers are; ordinary
    errors are not."""
    for key in ("backward", "agree_after"):
        seen = flags_world[0][key]
        assert "RuntimeError" in seen["types"]
        assert re.search(r"gloo/transport/tcp/pair\.cc:\d+\] (Read error "
                         r"\[[\d.]+\]:\d+: Connection reset by peer|"
                         r"Connection closed by peer \[[\d.]+\]:\d+)",
                         seen["text"]), seen["text"]
        assert elastic.is_peer_loss(RuntimeError(seen["text"]))
    for text in ("UNKNOWN: Gloo AllGather failed: [..] Connection closed "
                 "by peer", "Connection reset by peer", "Broken pipe"):
        assert elastic.is_peer_loss(ValueError(text)) == \
            jelastic.is_peer_loss(ValueError(text)) is True
    assert elastic.is_peer_loss(faults.HealthTimeoutError("t"))
    assert elastic.is_peer_loss(faults.PeerFailureError("p"))
    wrapped = RuntimeError("step failed")
    wrapped.__cause__ = RuntimeError("Connection closed by peer [x]:1")
    assert elastic.is_peer_loss(wrapped)
    for err in (None, ValueError("bad shape"), KeyError("x"),
                jfaults.FatalFaultError("injected")):
        assert not elastic.is_peer_loss(err)


def test_health_timeout_within_the_bound(tmp_path):
    """The late rank's peer gets HealthTimeoutError within timeout + 2 s;
    the late rank then finds its peer gone (a peer loss)."""
    early, late = _world("timeout", tmp_path)
    assert early["timeout"] and "HealthTimeoutError" in early["error"][
        "types"]
    assert TIMEOUT_S <= early["seconds"] <= TIMEOUT_S + 2.0
    assert "within 2.0s" in early["error"]["text"]
    assert not late["timeout"] and elastic.is_peer_loss(
        RuntimeError(late["error"]["text"]))
    assert late["seconds"] < LATE_S


def test_agree_health_alone_does_no_communication():
    assert runtime.agree_health(True, False, timeout_s=1.0, grow=True) == \
        (True, False, True)


ELASTIC_FLAGS = {
    "elastic": (["--elastic"], True),
    "elastic_dir": (["--elastic", "--elastic-dir", "/e"], "/e"),
    "health_timeout": (["--health-timeout", "5"], 5.0),
    "max_reconfigures": (["--max-reconfigures", "1"], 1),
    "elastic_target": (["--elastic", "--elastic-target", "fixed:4"],
                       "fixed:4"),
    "elastic_min_world": (["--elastic-min-world", "2"], 2),
    "elastic_join": (["--elastic", "--elastic-join"], True),
    "elastic_join_wait": (["--elastic-join-wait", "30"], 30.0),
}


@pytest.mark.parametrize("action", ["train", "test"])
def test_elastic_flags_parse_with_jax_defaults(action):
    base = [action, "-d", "/d"] + (["-f", "/x.ckpt"] if action == "test"
                                   else [])
    want = jax_argv(base)
    cfg = tconfig.config_from_argv(base + ["--device", "cpu"])
    for field in ELASTIC_FLAGS:
        assert getattr(cfg, field) == getattr(want, field), field
    for field, (extra, value) in ELASTIC_FLAGS.items():
        assert getattr(tconfig.config_from_argv(
            base + ["--device", "cpu"] + extra), field) == value


@pytest.mark.parametrize("extra", [["--elastic-join"],
                                   ["--elastic", "--elastic-target", "x"],
                                   ["--elastic", "--elastic-target",
                                    "fixed:0"]])
def test_elastic_launch_checks_fail_with_jax_messages(extra, capsys):
    """train fails before any work, with the JAX run_train's message;
    test takes the flags and ignores them, as the JAX test does."""
    argv = ["train", "-d", "/nonexistent", "--device", "cpu"] + extra
    if extra == ["--elastic-join"]:
        message = ("--elastic-join requires --elastic: a joiner becomes a "
                   "normal elastic member and must keep reconfiguring "
                   "with its world")
    else:
        with pytest.raises(ValueError) as e:
            jelastic.evaluate_join_policy(1, [], extra[-1], 1)
        message = str(e.value)
    with pytest.raises(ValueError, match=f"^{re.escape(message)}$"):
        tconfig.config_from_argv(argv)
    assert tcli.main(argv) == 1
    assert tconfig.config_from_argv(
        ["test", "-d", "/d", "-f", "/x", "--device", "cpu"] + extra)


def test_max_reconfigures_ends_in_peer_failure(tmp_path, monkeypatch):
    """Past --max-reconfigures the world change ends the run with the
    JAX message (a PeerFailureError: exit 1)."""
    def changed(*args, **kwargs):
        raise elastic.WorldChangedError("peer lost during epoch 1: x")

    monkeypatch.setattr(tcli, "_train_world", changed)
    cfg = tconfig.config_from_argv(
        ["train", "-d", str(tmp_path / "data"), "--rsl_path",
         str(tmp_path / "rsl"), "--model", "mlp", "--device", "cpu",
         "--debug", "--synthetic-fallback", "--dataset", "synthetic",
         "--elastic", "--max-reconfigures", "0"])
    with pytest.raises(faults.PeerFailureError, match=re.escape(
            "world changed 1 times, over the --max-reconfigures 0 cap; "
            "exiting with the last failure")):
        tcli.run_train(cfg)


def test_coordinator_loss_is_a_clean_error(tmp_path, fast_settle):
    """A shrink whose claims lack rank 0 (the coordinator, whose process
    holds the world's store) fails on every survivor, as the JAX package
    does."""
    gen_dir = str(tmp_path / "gen-1")
    _claim(gen_dir, 2)
    for rank in (1, 2):
        with pytest.raises(RuntimeError, match=re.escape(
                "elastic rendezvous: rank 0 of generation 0, the coordinator "
                "whose process holds its world's store, was lost (claims "
                "[1, 2]) — not survivable; exiting")):
            elastic._rendezvous(str(tmp_path), 1, rank, 3, "gloo")
