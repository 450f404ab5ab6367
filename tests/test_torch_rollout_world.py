"""JAX ``scripts/rollout_gate.py`` stages A-C re-posed on the port: the
``frontdoor`` CLI over one 2-rank ``serve --elastic --device cpu`` world
of ``tests/_torch_elastic_child.py --tiny-vit`` replicas, serving
checkpoints A (epoch 0) and B (epoch 1) that the port's
``save_checkpoint`` wrote into one lineage ledger, under closed-loop
clients that talk only to the front door:

  A. the fleet serves A; replica 0's first CANARY_FAILS batches fail
     (``serve.infer`` ioerror).  A front door with ``--rollout``
     canaries the ledger head B onto replica 0, sees the canary's error
     ratio dwarf stable's, rolls back to A and never canaries B again,
     while every client request is answered 200 (retry-once);
  C. the test hot-swaps both replicas to B; a second front door, with
     ``--rollout`` and ``--autoscale --min-world 2 --max-world 2``,
     watches a fleet already on the head: no rollback, no promotion, no
     scale event, every answer 200 and the same, and every trace record
     of the window stamped with B's sha;
  B. under the same front door, SIGKILL of replica 1 mid-load: the front
     door ejects slot 1, the controller repairs the world below
     ``--min-world`` with the ``--launch-cmd`` join command (one scale
     event), the joiner comes back at rank 1 on its old port and takes
     traffic again, and no client sees anything but a 200.

The three stages share the one replica world; C runs before B so that B's
repair is the world's last change."""

import functools
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch.models import get_model, vit
from distributedpytorch_tpu_torch.precision import PRESETS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_elastic_child.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _torch_elastic_child import TINY_VIT  # noqa: E402

SAMPLE = [[(r * 28 + c) % 256 for c in range(28)] for r in range(28)]
CANARY_FAILS = 12       # replica 0's failed batches; the canary needs 6
DEADLINE_S = 90.0
FD_RANK = 90            # the front door's telemetry rank
# The survivor's next health agreement after the grow waits this long for
# the joiner, whose own set-up (the dataset, the replica's build and
# warm-up) comes before its first agreement.  A loaded test host needs
# more than the JAX gate's 5 s: there the survivor counts the late joiner
# as a peer loss and shrinks back to 1 (as the JAX package does; ROADMAP
# queue 3 entry 29), and stage B wants the world of 2.  A SIGKILLed peer
# is found by its closed sockets.
HEALTH_TIMEOUT_S = 20


def _free_ports(n):
    """``n`` consecutive free ports (per-rank ports are base + rank)."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            for p in range(base, base + n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
    raise RuntimeError("no run of free ports")


def _env(world=0, rank=0, master=0):
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "MASTER_ADDR", "MASTER_PORT", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    if world:
        env.update(WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master))
    return env


def _checkpoints(dirname):
    """A and B of the tiny vit (seeds 7 and 8) in one ledger."""
    saved = vit.ViT.__init__
    vit.ViT.__init__ = functools.partialmethod(saved, **TINY_VIT)
    try:
        paths = []
        for epoch, seed in ((0, 7), (1, 8)):
            model = get_model("vit", 10, PRESETS["f32"], attention="flash",
                              device="cpu")
            model.init_weights(torch.Generator().manual_seed(seed))
            path = tckpt.checkpoint_path(dirname, "synthetic", "vit", epoch)
            tckpt.save_checkpoint(path, "vit", model, epoch, 0.5)
            paths.append(path)
    finally:
        vit.ViT.__init__ = saved
    return paths


def _get(port, path="/healthz", timeout=5.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _post(port, path="/predict", doc=None, timeout=120.0):
    """(status, body, upstream) of one call; a transport failure is
    (-1, {"error": ...}, None)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(doc or {"image": SAMPLE}).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return (r.status, json.loads(r.read()),
                    r.headers.get("X-DPT-Upstream"))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), None
    except OSError as e:
        return -1, {"error": repr(e)}, None


class _Load:
    """Closed-loop clients against the front door; every answer kept."""

    def __init__(self, port, clients=2):
        self.port, self.results = port, []
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(clients)]
        for t in self._threads:
            t.start()

    def _run(self):
        while not self._stop.is_set():
            self.results.append(_post(self.port))
            self._stop.wait(0.02)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=150)
        return list(self.results)


def _until(what, fn, logs, timeout_s=DEADLINE_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            got = fn()
        except (OSError, ValueError, KeyError, TypeError):
            got = None
        if got:
            return got
        time.sleep(0.1)
    tails = "\n".join(f"--- {p}\n" + open(p, errors="replace").read()[-2500:]
                      for p in logs if os.path.exists(p))
    pytest.fail(f"{what} within {timeout_s}s\n{tails}")


def _events(rsl, rank):
    path = os.path.join(rsl, "telemetry", f"rank{rank}.jsonl")
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


def _joiners(rsl):
    """Pids of live ``--elastic-join`` processes of the world at ``rsl``
    (the front door launches them; they are not this test's children)."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace").split("\0")
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if "--elastic-join" in cmd and rsl in cmd and state != "Z":
            pids.append(int(d))
    return pids


def _frontdoor(work, tag, rsl, port, mport, ckd, extra, logs):
    log = str(work / f"frontdoor_{tag}.log")
    logs.append(log)
    fdp = _free_ports(1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedpytorch_tpu_torch", "frontdoor",
         "--rsl_path", str(work / f"fd_{tag}"), "--port", str(fdp),
         "--ranks", "2", "--serve-port", str(port), "--metrics-port",
         str(mport), "--interval", "0.3", "--upstream-timeout", "60",
         "--rollout", "--watch-dir", ckd, *extra], cwd=ROOT, env=_env(),
        stdout=open(log, "w"), stderr=subprocess.STDOUT)
    _until(f"front door {tag} probing both replicas alive", lambda: all(
        _get(fdp)["upstreams"][str(i)]["alive"] for i in (0, 1)), logs)
    return proc, fdp


def _sha(path):
    return tckpt.lineage_info(path)["sha256"]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The one run of stages A, C and B (module docstring)."""
    work = tmp_path_factory.mktemp("rolloutworld")
    data, rsl, ckd = str(work / "data"), str(work / "rsl"), str(work / "ck")
    os.makedirs(ckd)
    path_a, path_b = _checkpoints(ckd)
    plan = work / "plan.json"
    plan.write_text(json.dumps({"faults": [
        {"site": "serve.infer", "kind": "ioerror", "after_n": 0,
         "count": CANARY_FAILS, "rank": 0}]}))
    port, mport, master = _free_ports(2), _free_ports(2), _free_ports(1)

    def serve(ckpt):
        return [sys.executable, CHILD, "--tiny-vit", "--settle", "3", "--",
                "serve", "-d", data, "--rsl_path", rsl, "-f", ckpt,
                "--dataset", "synthetic", "--synthetic-fallback", "--debug",
                "--attention", "flash", "--precision", "f32", "--device",
                "cpu", "--serve-port", str(port), "--serve-buckets", "1,4",
                "--serve-max-latency-ms", "5", "--serve-queue", "16",
                "--metrics-port", str(mport), "--elastic", "--health-timeout",
                str(HEALTH_TIMEOUT_S), "--max-reconfigures", "6",
                "--serve-request-timeout", "120"]

    join_cmd = serve(path_b) + ["--elastic-join", "--elastic-join-wait",
                                "60"]
    got = {"rsl": rsl, "fd_rsl": {t: str(work / f"fd_{t}")
                                  for t in ("a", "cb")},
           "sha": {"A": _sha(path_a), "B": _sha(path_b)}}
    procs, logs, fds, load = [], [], [], None
    try:
        for rank in (0, 1):
            logs.append(str(work / f"replica{rank}.log"))
            procs.append(subprocess.Popen(
                serve(path_a) + ["--fault-plan", str(plan)], cwd=ROOT,
                env=_env(2, rank, master), stdout=open(logs[-1], "w"),
                stderr=subprocess.STDOUT))
        for rank in (0, 1):
            _until(f"replica {rank} live", lambda: _get(
                port + rank, "/livez")["ok"], logs, 120.0)

        # -- stage A: the canary of B on replica 0 rolls back ------------
        fd, fdp = _frontdoor(work, "a", rsl, port, mport, ckd, [
            "--canary-fraction", "0.34", "--canary-hold", "60",
            "--canary-min-requests", "6", "--canary-max-error", "0.2"],
            logs)
        fds.append(fd)
        got["a_canary"] = _until("a canary", lambda: (
            lambda r: r if r["phase"] == "canary" else None)(
                _get(fdp)["rollout"]), logs)
        load = _Load(fdp)
        _until("the rollback", lambda: _get(fdp)["rollout"]["rollbacks"],
               logs)
        time.sleep(1.5)     # B is never canaried again
        got["a_doc"] = _until("replica 0 back on A", lambda: (
            lambda d: d if (d["upstreams"]["0"]["lineage"] or {}).get(
                "sha256") == got["sha"]["A"] else None)(_get(fdp)), logs)
        got["a_results"], load = load.stop(), None
        fd.send_signal(signal.SIGTERM)
        got["a_rc"] = fd.wait(timeout=30)
        # replica 0's fault window ends: its remaining failed batches
        got["drain"] = [_post(port)[0] for _ in range(CANARY_FAILS + 1)]

        # -- stage C: a fleet already on the head ------------------------
        got["reloads"] = [_post(port + r, "/admin/reload",
                                {"checkpoint": path_b})[:2] for r in (0, 1)]
        fd, fdp = _frontdoor(work, "cb", rsl, port, mport, ckd, [
            "--stale-after", "3", "--autoscale", "--min-world", "2",
            "--max-world", "2", "--queue-high", "999999", "--queue-low", "0",
            "--up-hold", "2", "--down-hold", "3600", "--cooldown", "120",
            "--launch-cmd", shlex.join(join_cmd)], logs)
        fds.append(fd)
        got["c_start"] = time.monotonic()
        load = _Load(fdp)
        time.sleep(4.0)
        got["c_results"] = load.stop()
        got["c_end"] = time.monotonic()
        got["c_doc"] = _get(fdp)

        # -- stage B: SIGKILL of replica 1 and the join repair -----------
        load = _Load(fdp)
        served = _until("load on both replicas", lambda: (
            lambda d: d["upstreams"]["1"]["requests"] if all(
                d["upstreams"][str(i)]["requests"] > 0 for i in (0, 1))
            else None)(_get(fdp)), logs)
        procs[1].kill()
        t_kill = time.monotonic()
        got["b_rc1"] = procs[1].wait(timeout=30)
        _until("the front door's ejection", lambda: _get(fdp)[
            "upstreams"]["1"]["ejected"], logs)
        got["b_eject_s"] = time.monotonic() - t_kill
        logs.append(os.path.join(got["fd_rsl"]["cb"], "join-1.log"))
        got["b_doc"] = _until("slot 1 serving again", lambda: (
            lambda d: d if (d["scale_events"] >= 1
                            and d["upstreams"]["1"]["alive"]
                            and not d["upstreams"]["1"]["ejected"]
                            and d["upstreams"]["1"]["requests"] > served)
            else None)(_get(fdp)), logs, 120.0)
        got["b_rejoin_s"] = time.monotonic() - t_kill
        got["b_results"], load = load.stop(), None
        got["b_doc"] = _get(fdp)
        fd.send_signal(signal.SIGTERM)
        got["cb_rc"] = fd.wait(timeout=30)
        # SIGTERM to rank 0: the shutdown rides the health agreement, so
        # the joiner the front door launched stops with it
        procs[0].send_signal(signal.SIGTERM)
        got["rc0"] = procs[0].wait(timeout=90)
        got["joiner_exited"] = _until("the joiner's exit", lambda: not
                                      _joiners(rsl), logs, 60.0)
    finally:
        if load is not None:
            load.stop()
        for p in procs + fds:
            if p.poll() is None:
                p.kill()
                p.wait()
        for pid in _joiners(rsl):
            os.kill(pid, signal.SIGKILL)
    return got


def _fails(results):
    return [(s, b) for s, b, _ in results if s != 200]


def test_stage_a_canary_rolls_back_with_no_client_failure(fleet):
    assert fleet["a_canary"]["canary_ids"] == [0]
    ro = fleet["a_doc"]["rollout"]
    assert (ro["phase"], ro["rollbacks"], ro["promotions"],
            ro["canary_ids"]) == ("stable", 1, 0, [])
    assert fleet["a_rc"] == 0
    results = fleet["a_results"]
    assert results and not _fails(results), _fails(results)[:3]
    assert fleet["a_doc"]["retries"] >= 1
    names = [e["name"] for e in _events(fleet["fd_rsl"]["a"], FD_RANK)]
    for want in ("frontdoor_start", "rollout/canary_start",
                 "rollout/rollback"):
        assert want in names, names
    assert names.count("rollout/canary_start") == 1
    # replica 0's whole fault window was spent, on the canary and the
    # drain after it, and replica 0 answers again
    fired = [e for e in _events(fleet["rsl"], 0)
             if e["name"] == "fault_injected"]
    assert len(fired) == CANARY_FAILS and fleet["drain"][-1] == 200


def test_stage_c_fleet_on_the_head_draws_no_action(fleet):
    assert [c for c, _ in fleet["reloads"]] == [200, 200]
    doc, sha_b = fleet["c_doc"], fleet["sha"]["B"]
    ro = doc["rollout"]
    assert (ro["phase"], ro["rollbacks"], ro["promotions"]) == (
        "stable", 0, 0)
    assert doc["scale_events"] == 0
    for i in ("0", "1"):
        assert doc["upstreams"][i]["lineage"]["sha256"] == sha_b
    results = fleet["c_results"]
    assert results and not _fails(results), _fails(results)[:3]
    assert {u for _, _, u in results} == {"0", "1"}
    assert len({b["label"] for _, b, _ in results}) == 1
    recs = []
    for rank in (0, 1):
        with open(os.path.join(fleet["rsl"],
                               f"trace-rank{rank}.jsonl")) as f:
            recs += [r for r in map(json.loads, f)
                     if fleet["c_start"] <= r["mono_admit"] <= fleet["c_end"]]
    assert recs and {r["lineage"] for r in recs} == {sha_b[:12]}


def test_stage_b_kill_ejects_and_the_join_repairs(fleet):
    doc = fleet["b_doc"]
    assert fleet["b_rc1"] == -signal.SIGKILL
    assert doc["scale_events"] == 1
    up1 = doc["upstreams"]["1"]
    assert up1["alive"] and not up1["ejected"]
    assert up1["lineage"]["sha256"] == fleet["sha"]["B"]
    results = fleet["b_results"]
    assert results and not _fails(results), _fails(results)[:3]
    events = _events(fleet["fd_rsl"]["cb"], FD_RANK)
    [up] = [e for e in events if e["name"] == "controller/scale_up"]
    assert "min_world" in up["attrs"]["reason"]
    names = [e["name"] for e in events]
    assert "frontdoor/eject" in names and "frontdoor/readmit" in names
    # the joiner is rank 1 of a world of 2 again, on slot 1's port
    joins = [e["attrs"] for e in _events(fleet["rsl"], 1)
             if e["name"] == "elastic/join"]
    assert [(j["new_rank"], j["new_world"]) for j in joins] == [(1, 2)]
    grows = [e["attrs"] for e in _events(fleet["rsl"], 0)
             if e["name"] == "elastic/reconfigure"]
    assert [g["new_world"] for g in grows] == [1, 2]
    assert 0 < fleet["b_eject_s"] < fleet["b_rejoin_s"]


def test_the_world_and_the_front_door_stop_cleanly(fleet):
    assert fleet["cb_rc"] == 0 and fleet["rc0"] == 0
    assert fleet["joiner_exited"]
