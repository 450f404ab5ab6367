"""The port's fault plans and retry policy against the JAX package's
(``faults.py``): the same DSL and JSON text give the same specs and the
same errors, the same hit sequences fire on the same hits (rank and path
filters included), the retry schedule is equal for each seed and site,
and every kind acts as the JAX kind does.  Then the sites the port wires:
``ckpt.save``/``ckpt.finalize`` (a torn head falls back to the previous
snapshot), ``data.host_batch`` (retried batches unchanged),
``data.read``, ``newest_checkpoint``, the handler's re-entrant locks and
the CLI's flags with the JAX defaults and messages."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distributedpytorch_tpu import faults as jfaults
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch import cli as tcli
from distributedpytorch_tpu_torch import config as tconfig
from distributedpytorch_tpu_torch import faults, flightrec, telemetry, utils
from distributedpytorch_tpu_torch.data.datasets import Split
from distributedpytorch_tpu_torch.data.pipeline import ShardedLoader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_plan():
    faults.install(None)
    jfaults.install(None)
    yield
    faults.configure(None)
    jfaults.install(None)
    telemetry._active = telemetry.Telemetry(enabled=False)
    flightrec._active = flightrec.FlightRecorder(enabled=False)


def _fields(spec) -> tuple:
    return (spec.site, spec.kind, spec.after_n, spec.count, spec.rank,
            spec.path_match, spec.stall_s)


DSL = [
    "data.read:ioerror:0:2",
    "data.read:ioerror:0:2;ckpt.save:preempt:1;ckpt.finalize:torn:1",
    " ckpt.save:fatal:3 ; data.host_batch:stall:5:2:0.5 ;",
    "elastic.join:rank_join:0",
    "data.host_batch:rank_loss:40",
    "runtime.init:ioerror:0:2",
    "elastic.reinit:ioerror:0;elastic.grow_reinit:ioerror:1:3",
    "telemetry.write:ioerror:2;serve.infer:ioerror:0",
    "sim.step:rank_loss:30:2",
]


@pytest.mark.parametrize("text", DSL)
def test_parse_plan_dsl_equals_jax(text):
    got = faults.parse_plan(text, seed=7)
    want = jfaults.parse_plan(text, seed=7)
    assert [_fields(s) for s in got.specs] == \
        [_fields(s) for s in want.specs]
    assert got.seed == want.seed == 7
    for site in faults.SITES:
        assert got.targets(site) == want.targets(site)


JSON_PLANS = [
    {"seed": 3, "faults": [
        {"site": "ckpt.finalize", "kind": "torn", "after_n": 2, "count": 1,
         "path_match": "checkpoint-"}]},
    {"faults": [
        {"site": "data.host_batch", "kind": "rank_loss", "after_n": 40,
         "count": 1, "rank": 2},
        {"site": "data.host_batch", "kind": "stall", "after_n": 34,
         "count": 250, "stall_s": 0.25, "rank": 0}]},
    {"seed": 0, "faults": [
        {"site": "data.read", "kind": "ioerror", "after_n": 0, "count": 2},
        {"site": "ckpt.save", "kind": "preempt", "after_n": 2, "count": 1},
        {"site": "ckpt.finalize", "kind": "torn", "after_n": 2, "count": 1,
         "path_match": "checkpoint-"}]},
]


@pytest.mark.parametrize("doc", JSON_PLANS, ids=["torn", "elastic", "chaos"])
def test_parse_plan_json_equals_jax(doc, tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(doc))
    got = faults.parse_plan(str(path), seed=11)
    want = jfaults.parse_plan(str(path), seed=11)
    assert [_fields(s) for s in got.specs] == \
        [_fields(s) for s in want.specs]
    assert got.seed == want.seed


BAD = [
    "nosuch.site:ioerror:0",
    "data.read:explode:0",
    "data.read:ioerror",
    "data.read:ioerror:x",
    "data.read:ioerror:-1",
    "data.read:ioerror:0:0",
    "data.read:stall:0:1:0",
    "",
    "missing.json",
]


@pytest.mark.parametrize("bad", BAD)
def test_bad_plan_fails_as_in_jax(bad, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError) as want:
        jfaults.parse_plan(bad)
    with pytest.raises(ValueError) as got:
        faults.parse_plan(bad)
    assert str(got.value) == str(want.value)


def _fired(mod, text: str, hits: int, path=None) -> list:
    """The hits of each site on which ``text``'s plan raised."""
    plan = mod.parse_plan(text)
    out = []
    for site in sorted({s.site for s in plan.specs}):
        for i in range(1, hits + 1):
            try:
                plan.fire(site, path=path)
            except (mod.InjectedIOError, mod.FatalFaultError):
                out.append((site, i))
    return out


WINDOWS = [
    ("data.read:ioerror:0:2", None),
    ("data.read:ioerror:3;data.read:fatal:5:2", None),
    ("ckpt.save:ioerror:1:3;ckpt.restore:fatal:0", "/r/checkpoint-x.ckpt"),
    ("serve.infer:ioerror:7:4", None),
]


@pytest.mark.parametrize("text,path", WINDOWS)
def test_same_hits_fire_as_in_jax(text, path):
    assert _fired(faults, text, 12, path) == _fired(jfaults, text, 12, path)


def test_rank_and_path_filters_fire_as_in_jax(tmp_path):
    doc = {"faults": [
        {"site": "ckpt.save", "kind": "ioerror", "after_n": 0, "count": 3,
         "rank": 0, "path_match": "best"},
        {"site": "ckpt.save", "kind": "fatal", "after_n": 3, "count": 2,
         "rank": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(doc))
    seq = []
    for mod in (faults, jfaults):
        plan = mod.parse_plan(str(path))
        fired = []
        for i, p in enumerate(["a/best.ckpt", "a/checkpoint-0.ckpt",
                               "a/best.ckpt", "a/best.ckpt",
                               "a/best.ckpt"]):
            try:
                plan.fire("ckpt.save", path=p)
            except OSError:
                fired.append(i)
        seq.append(fired)
    assert seq[0] == seq[1] == [0, 2]


@pytest.mark.parametrize("seed", [0, 1, 1234])
@pytest.mark.parametrize("site", ["data.read", "ckpt.save", "runtime.init",
                                  "elastic.reinit"])
def test_retry_delays_equal_jax(seed, site):
    got = faults.RetryPolicy(max_attempts=8, seed=seed)
    want = jfaults.RetryPolicy(max_attempts=8, seed=seed)
    assert [got._delay(site, a) for a in range(1, 9)] == \
        [want._delay(site, a) for a in range(1, 9)]


def test_retry_attempts_and_giveups_as_in_jax(monkeypatch):
    """Two transients then success: three calls, two retry events; a
    fatal fault is never retried; an exhausted policy re-raises."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    for mod in (faults, jfaults):
        calls = []

        def flaky(mod=mod):
            calls.append(1)
            if len(calls) < 3:
                raise mod.InjectedIOError("x")
            return "ok"

        assert mod.RetryPolicy(seed=2).call(flaky, "data.read") == "ok"
        assert len(calls) == 3

        def fatal(mod=mod):
            calls.append(1)
            raise mod.FatalFaultError("f")

        calls.clear()
        with pytest.raises(mod.FatalFaultError):
            mod.RetryPolicy().call(fatal, "ckpt.save")
        assert len(calls) == 1
        with pytest.raises(OSError):
            mod.RetryPolicy(max_attempts=2).call(
                lambda mod=mod: (_ for _ in ()).throw(OSError("d")), "s")


def test_retry_events_in_telemetry(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    tel = telemetry.configure(str(tmp_path), True, rank=0)
    faults.configure("data.read:ioerror:0:2", retry_max_attempts=3)

    def attempt():
        faults.fire("data.read")
        return 5

    assert faults.retry(attempt, "data.read") == 5
    tel.close()
    events = telemetry.load_events(str(tmp_path / "telemetry"))
    names = [e.get("name") for e in events]
    assert names.count("fault_injected") == 2 and names.count("retry") == 2
    agg = telemetry.aggregate(events)
    assert agg["counters"]["retry/attempts"] == 2


@pytest.mark.parametrize("kind", ["torn", "rank_join"])
def test_file_kinds_act_as_in_jax(kind, tmp_path):
    site = "ckpt.finalize" if kind == "torn" else "elastic.join"
    out = []
    for mod, name in ((faults, "port"), (jfaults, "jax")):
        path = tmp_path / f"{name}-claim.json"
        path.write_bytes(bytes(range(256)) * 5)
        mod.parse_plan(f"{site}:{kind}:0").fire(site, path=str(path))
        dup = tmp_path / f"{name}-claim-dup.json"
        out.append((path.read_bytes(),
                    dup.read_bytes() if dup.exists() else None))
    assert out[0] == out[1]
    assert len(out[0][0]) == (640 if kind == "torn" else 1280)


def test_stall_kind_sleeps_and_carries_on():
    plan = faults.parse_plan("data.host_batch:stall:0:1:0.2")
    t0 = time.monotonic()
    plan.fire("data.host_batch")
    assert time.monotonic() - t0 >= 0.2


def test_preempt_kind_sets_the_shutdown_flag(tmp_path):
    """kind=preempt signals this process: GracefulShutdown sets
    ``requested`` and the handler's audit write lands in the telemetry
    and the flight recorder, whose locks the handler re-enters."""
    telemetry.configure(str(tmp_path), True, rank=0)
    rec = flightrec.configure(str(tmp_path), True, rank=0)
    with utils.GracefulShutdown() as gs:
        with telemetry.get()._lock, rec._lock:  # held, as mid-write
            faults.parse_plan("ckpt.save:preempt:0").fire("ckpt.save")
        assert gs.requested
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    names = [r.get("name") for r in rec._ring]
    assert "fault_injected" in names and "preempt_signal" in names


def test_rank_loss_exits_with_its_status(tmp_path):
    code = ("import sys; sys.path.insert(0, %r);"
            "from distributedpytorch_tpu_torch import faults;"
            "faults.parse_plan('data.host_batch:rank_loss:1')"
            ".fire('data.host_batch');"
            "faults.parse_plan('data.host_batch:rank_loss:0')"
            ".fire('data.host_batch'); print('survived')" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == faults.RANK_LOSS_EXIT == \
        jfaults.RANK_LOSS_EXIT == 113
    assert "survived" not in proc.stdout


def test_no_plan_is_a_noop_and_targets_nothing():
    assert faults.installed() is None
    for site in faults.SITES:
        assert faults.fire(site) is None and not faults.targets(site)
    assert faults.KINDS == jfaults.KINDS and faults.SITES == jfaults.SITES


def test_plan_lock_is_reentrant_for_the_signal_handler():
    faults.install(faults.parse_plan("data.read:ioerror:99"))
    plan = faults.installed()
    with plan._lock:
        assert plan._lock.acquire(blocking=False)
        plan._lock.release()
        assert faults.fire("data.read") is None


def test_configure_installs_plan_and_policy_as_jax(tmp_path):
    for mod in (faults, jfaults):
        mod.configure("data.read:ioerror:0", fault_seed=9,
                      retry_max_attempts=5, retry_base_delay_s=0.01,
                      retry_timeout_s=1.5)
        p = mod.policy()
        assert (p.max_attempts, p.base_delay_s, p.timeout_s, p.seed) == \
            (5, 0.01, 1.5, 9)
        assert mod.installed().targets("data.read")
        mod.configure(None)
        assert mod.installed() is None


# -- the sites ------------------------------------------------------------


def _tiny_model():
    return torch.nn.Linear(4, 3)


def test_ckpt_save_retries_and_torn_finalize_falls_back(tmp_path,
                                                        monkeypatch):
    """An ioerror at ckpt.save is retried (the file lands whole); a torn
    ckpt.finalize leaves a head whose checksum fails, and the resume
    falls back to the previous snapshot; newest_checkpoint names the
    head, as the JAX newest_checkpoint does."""
    from distributedpytorch_tpu import checkpoint as jckpt

    monkeypatch.setattr(time, "sleep", lambda s: None)
    rsl = str(tmp_path)
    model = _tiny_model()
    faults.configure("ckpt.save:ioerror:0;ckpt.finalize:torn:1")
    paths = [tckpt.checkpoint_path(rsl, "mnist", "mlp", e) for e in (0, 1)]
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for epoch, path in enumerate(paths):
        tckpt.save_checkpoint(path, "mlp", model, epoch, 1.0, opt)
    assert tckpt.verify_checkpoint(paths[0]) is None
    assert "checksum" in tckpt.verify_checkpoint(paths[1])
    assert tckpt.newest_checkpoint(rsl, "mnist", "mlp") == paths[1] == \
        jckpt.newest_checkpoint(rsl, "mnist", "mlp")
    assert tckpt.newest_checkpoint(str(tmp_path / "none"), "mnist",
                                   "mlp") is None
    fresh = _tiny_model()
    epoch, _, _ = tckpt.load_checkpoint_with_fallback(
        paths[1], fresh, torch.optim.SGD(fresh.parameters(), lr=0.1), rsl,
        "mnist", "mlp")
    assert epoch == 1       # resumes after the epoch-0 snapshot


@pytest.mark.parametrize("threads", [0, 1])
def test_host_batch_site_retries_with_the_same_batches(threads,
                                                       monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    rng = np.random.default_rng(0)
    split = Split(images=rng.integers(0, 255, (37, 4, 4), dtype=np.uint8),
                  labels=rng.integers(0, 10, 37).astype(np.int32))

    def batches():
        loader = ShardedLoader(split, 4, True, 5, "cpu", world=2, rank=1,
                               producer_threads=threads)
        return [tuple(t.clone() for t in b) for b in loader.epoch(1)]

    clean = batches()
    faults.configure("data.host_batch:ioerror:1:2")
    faulty = batches()
    assert faults.installed()._hits["data.host_batch"] == len(clean) + 2
    assert all(all(torch.equal(x, y) for x, y in zip(a, b))
               for a, b in zip(clean, faulty)) and len(clean) == len(faulty)


FAULT_FLAGS = {
    "fault_plan": (["--fault-plan", "data.read:ioerror:0"],
                   "data.read:ioerror:0"),
    "fault_seed": (["--fault-seed", "4"], 4),
    "retry_max_attempts": (["--retry-max-attempts", "5"], 5),
    "retry_base_delay": (["--retry-base-delay", "0.5"], 0.5),
    "retry_timeout": (["--retry-timeout", "9"], 9.0),
}


@pytest.mark.parametrize("action", ["train", "test", "serve"])
def test_fault_flags_parse_with_jax_defaults(action):
    from distributedpytorch_tpu.config import config_from_argv as jax_argv

    base = [action, "-d", "/d", "--device", "cpu"]
    base += ["-f", "/x.ckpt"] if action != "train" else []
    want = jax_argv([a for a in base if a not in ("--device", "cpu")])
    jax_names = dict(fault_plan="fault_plan", fault_seed="fault_seed",
                     retry_max_attempts="retry_max_attempts",
                     retry_base_delay="retry_base_delay",
                     retry_timeout="retry_timeout")
    cfg = tconfig.config_from_argv(base)
    for field, jfield in jax_names.items():
        assert getattr(cfg, field) == getattr(want, jfield)
    for field, (extra, value) in FAULT_FLAGS.items():
        assert getattr(tconfig.config_from_argv(base + extra),
                       field) == value


def test_cli_fault_run_retries_preempts_and_tears(tmp_path, monkeypatch):
    """train under the chaos plan's DSL twin: two retried reads, the
    preempt and the torn write at epoch 0's best file, a preempted exit
    after epoch 1 (exit 0); the resume from the torn best file falls back
    to the epoch-0 snapshot."""
    monkeypatch.chdir(tmp_path)
    argv = ["train", "-d", str(tmp_path / "data"), "--rsl_path",
            str(tmp_path / "rsl"), "--model", "mlp", "--device", "cpu",
            "--debug", "--synthetic-fallback", "--dataset", "synthetic",
            "-e", "2", "--telemetry"]
    assert tcli.main(argv + ["--fault-plan", "data.read:ioerror:0:2;"
                             "ckpt.save:preempt:1;ckpt.finalize:torn:1"]) == 0
    log = (tmp_path / "rsl" / "test.log").read_text()
    assert log.count("transient failure") == 2
    assert "preempted after epoch 1" in log
    best = tckpt.best_model_path(str(tmp_path / "rsl"), "synthetic", "mlp")
    assert "checksum" in tckpt.verify_checkpoint(best)
    assert tcli.main(argv + ["-f", best]) == 0
    log = (tmp_path / "rsl" / "test.log").read_text()
    assert "CHECKPOINT REJECTED" in log and "Epoch: 002" in log \
        and "Epoch: 001" not in log


def test_runtime_init_site_retries_the_process_group(monkeypatch):
    """An ioerror at runtime.init is retried under the policy and the
    world of one still forms (JAX runtime.py:122-136)."""
    from distributedpytorch_tpu_torch import runtime

    monkeypatch.setattr(time, "sleep", lambda s: None)
    with __import__("socket").socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for name, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(port))):
        monkeypatch.setenv(name, value)
    faults.configure("runtime.init:ioerror:0")
    try:
        assert runtime.initialize_distributed(torch.device("cpu")) == "gloo"
        assert faults.installed()._hits["runtime.init"] == 2
        assert runtime.agree_health(True, False) == (True, False, False)
    finally:
        runtime.shutdown_distributed()
