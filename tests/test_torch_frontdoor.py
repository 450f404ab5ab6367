"""The port's fleet front door, autoscale controller and canary rollout
(``serving/{frontdoor,controller,rollout}.py``), held against the JAX
package's:

  * the pure deciders (``decide_health``, ``routable_ids``,
    ``pick_upstream``, ``admission``, ``decide_scale``, ``pick_retire``,
    ``choose_canaries``, ``decide_rollout``) on the same seeded numpy
    draws through both packages: equal outputs;
  * the JAX ``tests/test_frontdoor.py`` live cases re-posed on the port's
    ``FrontDoor`` over in-process fake replicas: the request id kept end
    to end, a shed at the pending budget with ``Retry-After``, a hung
    upstream cut at its deadline and retried on the other replica, a 5xx
    retried once, 503 when nothing is routable, a dead replica ejected;
  * the listener's backlog (ROADMAP queue 3 entry 27): 64 connections
    made while the ``frontdoor`` CLI process is stopped all complete and
    are all answered once it runs again;
  * ``RolloutManager`` over a ledger the port's ``checkpoint.py`` wrote:
    canary then promote, a bad canary rolled back and never retried, a
    sha mismatch rejected, with the same events as the JAX manager."""

import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributedpytorch_tpu.serving import controller as jax_ctrl
from distributedpytorch_tpu.serving import frontdoor as jax_fd
from distributedpytorch_tpu.serving import rollout as jax_ro
from distributedpytorch_tpu_torch import checkpoint as tckpt
from distributedpytorch_tpu_torch.serving import controller as ctrl
from distributedpytorch_tpu_torch.serving import frontdoor as fd_mod
from distributedpytorch_tpu_torch.serving import rollout as ro
from distributedpytorch_tpu_torch.serving.frontdoor import (FrontDoor,
                                                            routable_ids)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAWS = 300


# -- the pure deciders against JAX's ------------------------------------

def _replicas(rng, n_max=6):
    return [{"id": int(i), "alive": bool(rng.random() < 0.8),
             "ejected": bool(rng.random() < 0.3),
             "draining": bool(rng.random() < 0.2),
             "consecutive_failures": int(rng.integers(0, 6)),
             "last_step_age_s": (None if rng.random() < 0.3
                                 else float(rng.uniform(0, 10)))}
            for i in rng.permutation(int(rng.integers(0, n_max + 1)))]


def _draw_health(rng):
    cfg = {"eject_after": int(rng.integers(1, 5)),
           "max_step_age_s": float(rng.choice([0.0, 2.5, 6.0]))}
    return (cfg, _replicas(rng))


def _draw_routable(rng):
    return (_replicas(rng),)


def _draw_pick(rng):
    ids = [int(i) for i in rng.permutation(8)[:int(rng.integers(0, 7))]]
    pending = {i: int(rng.integers(0, 4)) for i in ids}
    exclude = [i for i in ids if rng.random() < 0.3]
    return (ids, pending, int(rng.integers(0, 100)), exclude)


def _draw_admission(rng):
    return ({"pending_budget": int(rng.integers(0, 10)),
             "retry_after_s": float(rng.choice([0.5, 1.0, 2.5]))},
            int(rng.integers(0, 12)))


def _draw_scale(rng):
    cfg = {"min_world": int(rng.integers(1, 4)),
           "max_world": int(rng.integers(2, 6)),
           "queue_high": float(rng.choice([4.0, 8.0])),
           "queue_low": float(rng.choice([0.0, 1.0])),
           "up_hold_s": float(rng.choice([0.0, 1.0, 2.0])),
           "down_hold_s": float(rng.choice([1.0, 3.0, 10.0])),
           "cooldown_s": float(rng.choice([0.0, 2.0, 5.0]))}
    state = ({} if rng.random() < 0.5
             else {"last_action_t": float(rng.uniform(0, 12))})
    samples, t, shed, fd_shed = [], 0.0, 0.0, 0.0
    for _ in range(int(rng.integers(0, 14))):
        t += float(rng.choice([0.5, 1.0]))
        shed += float(rng.random() < 0.1)
        fd_shed += float(rng.random() < 0.05)
        world = int(rng.integers(0, 6))
        depth = float(rng.choice([0.0, 0.5, 2.0, 9.0, 12.0]))
        gauge = (depth if rng.random() < 0.7 else
                 {str(r): depth / max(world, 1) for r in range(world)})
        samples.append({
            "t": t, "alive": list(range(world)),
            "gauges": {ctrl.QUEUE_GAUGE: gauge},
            "counters": {ctrl.SHED_COUNTER: shed,
                         ctrl.FD_SHED_COUNTER: fd_shed},
            "verdicts": [{"name": "errors",
                          "firing": bool(rng.random() < 0.1)}]})
    return (cfg, state, samples)


def _draw_retire(rng):
    return ([int(i) for i in rng.permutation(6)[:int(rng.integers(0, 6))]],
            [int(i) for i in rng.permutation(6)[:int(rng.integers(0, 3))]])


def _draw_canaries(rng):
    return ([int(i) for i in rng.permutation(8)[:int(rng.integers(0, 8))]],
            float(rng.choice([0.0, 0.1, 0.34, 0.5, 1.0])))


def _draw_rollout(rng):
    cfg = {"hold_s": float(rng.choice([0.0, 5.0])),
           "min_requests": int(rng.integers(1, 30)),
           "max_error_ratio": float(rng.choice([0.05, 0.2])),
           "p95_floor_ms": float(rng.choice([0.0, 50.0])),
           "timeout_s": float(rng.choice([10.0, 120.0]))}

    def side():
        req = int(rng.integers(0, 60))
        return {"requests": req, "errors": int(rng.integers(0, req + 1)),
                "p95_ms": (None if rng.random() < 0.3
                           else float(rng.uniform(1, 400)))}

    obs = {"t": float(rng.uniform(0, 150)),
           "canary_alive": bool(rng.random() < 0.9),
           "canary": side(), "stable": side()}
    return (cfg, {"since_t": float(rng.uniform(0, 20))}, obs)


DECIDERS = {
    "decide_health": (jax_fd.decide_health, fd_mod.decide_health,
                      _draw_health),
    "routable_ids": (jax_fd.routable_ids, fd_mod.routable_ids,
                     _draw_routable),
    "pick_upstream": (jax_fd.pick_upstream, fd_mod.pick_upstream,
                      _draw_pick),
    "admission": (jax_fd.admission, fd_mod.admission, _draw_admission),
    "decide_scale": (jax_ctrl.decide_scale, ctrl.decide_scale, _draw_scale),
    "pick_retire": (jax_ctrl.pick_retire, ctrl.pick_retire, _draw_retire),
    "choose_canaries": (jax_ro.choose_canaries, ro.choose_canaries,
                        _draw_canaries),
    "decide_rollout": (jax_ro.decide_rollout, ro.decide_rollout,
                       _draw_rollout),
}


@pytest.mark.parametrize("name", sorted(DECIDERS))
def test_decider_equals_jax(name):
    """DRAWS seeded inputs through the JAX decider and the port's: every
    output equal, and the draws reach more than one outcome."""
    want_fn, got_fn, draw = DECIDERS[name]
    rng = np.random.default_rng(sorted(DECIDERS).index(name))
    outs = set()
    for _ in range(DRAWS):
        args = draw(rng)
        want, got = want_fn(*args), got_fn(*args)
        assert got == want, args
        outs.add(json.dumps(got, sort_keys=True))
    assert len(outs) > 1


def test_policy_defaults_and_names_equal_jax():
    assert fd_mod.ROUTE_DEFAULTS == jax_fd.ROUTE_DEFAULTS
    assert fd_mod.FRONTDOOR_RANK == jax_fd.FRONTDOOR_RANK
    assert ctrl.SCALE_DEFAULTS == jax_ctrl.SCALE_DEFAULTS
    assert (ctrl.QUEUE_GAUGE, ctrl.SHED_COUNTER, ctrl.FD_SHED_COUNTER) == (
        jax_ctrl.QUEUE_GAUGE, jax_ctrl.SHED_COUNTER,
        jax_ctrl.FD_SHED_COUNTER)
    assert ro.ROLLOUT_DEFAULTS == jax_ro.ROLLOUT_DEFAULTS
    assert ro.LINEAGE_FILE == jax_ro.LINEAGE_FILE \
        == os.path.basename(tckpt.lineage_path("x"))


# -- the live front door over fake replicas -----------------------------

class FakeReplica:
    """A scriptable serve replica (JAX tests/test_frontdoor.py:86-133):
    ``behavior(hit_n) -> (status, payload)`` answers /predict after
    ``delay_s``; GET answers a stats-shaped health body."""

    def __init__(self, behavior=None, delay_s=0.0, port=0):
        self.behavior = behavior or (lambda n: (200, {"label": 1}))
        self.delay_s = delay_s
        self.hits = 0
        rep = self

        class _H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                self.rfile.read(n)
                rep.hits += 1
                if rep.delay_s:
                    time.sleep(rep.delay_s)
                status, payload = rep.behavior(rep.hits)
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("X-DPT-Request-Id", f"r7-{rep.hits:06d}")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                body = json.dumps({"ok": True, "queue_depth": 0,
                                   "draining": False,
                                   "checkpoint": None}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass

        class _Listener(http.server.ThreadingHTTPServer):
            request_queue_size = 128

        self.server = _Listener(("127.0.0.1", port), _H)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _mk_fd(ports, **kw):
    replicas = {i: {"predict_port": p, "health_port": p,
                    "health_path": "/livez"}
                for i, p in enumerate(ports)}
    kw.setdefault("upstream_timeout_s", 2.0)
    kw.setdefault("probe_timeout_s", 1.0)
    kw.setdefault("interval_s", 0.05)
    fd = FrontDoor(0, replicas, **kw)
    fd.start()
    return fd


def _post(port, timeout=10.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps({"image": [[0]]}).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _case_round_trip():
    rep = FakeReplica()
    fd = _mk_fd([rep.port])
    try:
        fd.tick()   # the probe marks the replica alive
        status, body, headers = _post(fd.port)
        assert status == 200 and body["label"] == 1
        assert headers["X-DPT-Request-Id"] == "r7-000001"
        assert headers["X-DPT-Upstream"] == "0"
        doc = fd.status_doc()
        assert doc["answered"] == 1
        assert doc["upstreams"]["0"]["requests"] == 1
    finally:
        fd.close()
        rep.close()


def _case_shed():
    rep = FakeReplica()
    fd = _mk_fd([rep.port], policy={"pending_budget": 0,
                                    "retry_after_s": 2.5})
    try:
        fd.tick()
        status, body, headers = _post(fd.port)
        assert status == 503 and "capacity" in body["error"]
        assert headers["Retry-After"] == "2.5"
        assert fd.status_doc()["shed"] == 1
        assert rep.hits == 0    # shed before any upstream is touched
    finally:
        fd.close()
        rep.close()


def _case_hung_upstream():
    hung, good = FakeReplica(delay_s=10.0), FakeReplica()
    fd = _mk_fd([hung.port, good.port], upstream_timeout_s=0.4)
    try:
        fd.tick()
        # a fresh tie's round robin starts at slot 0: the hung replica
        t0 = time.monotonic()
        status, _, headers = _post(fd.port)
        elapsed = time.monotonic() - t0
        assert status == 200
        assert headers["X-DPT-Upstream"] == "1"
        assert headers["X-DPT-Request-Id"].startswith("r7-")
        assert elapsed < 5.0    # the deadline cut the hang, not the client
        doc = fd.status_doc()
        assert doc["retries"] == 1
        assert doc["upstreams"]["0"]["errors"] == 1   # unreachable
    finally:
        fd.close()
        hung.close()
        good.close()


def _case_5xx_retry():
    bad = FakeReplica(behavior=lambda n: (500, {"error": "boom"}))
    good = FakeReplica()
    fd = _mk_fd([bad.port, good.port])
    try:
        fd.tick()
        assert {_post(fd.port)[0] for _ in range(4)} == {200}
        doc = fd.status_doc()
        assert doc["retries"] >= 1
        assert doc["upstreams"]["0"]["errors"] >= 1
    finally:
        fd.close()
        bad.close()
        good.close()


def _case_no_routable():
    fd = _mk_fd([1])    # port 1: nothing listens, never probed alive
    try:
        status, body, headers = _post(fd.port)
        assert status == 503 and "no routable" in body["error"]
        assert "Retry-After" in headers
        assert fd.status_doc()["no_upstream"] == 1
    finally:
        fd.close()


def _case_eject_dead():
    dying, good = FakeReplica(), FakeReplica()
    fd = _mk_fd([dying.port, good.port], policy={"eject_after": 2})
    try:
        fd.tick()
        assert routable_ids([u.snapshot() for u in fd._ups.values()]) \
            == [0, 1]
        dying.close()
        for _ in range(3):
            fd.tick()
        assert routable_ids([u.snapshot() for u in fd._ups.values()]) \
            == [1]
        assert fd.status_doc()["upstreams"]["0"]["ejected"]
        assert _post(fd.port)[0] == 200   # every request to the survivor
    finally:
        fd.close()
        good.close()


LIVE_CASES = {"request_id": _case_round_trip, "shed": _case_shed,
              "hung_upstream": _case_hung_upstream,
              "5xx_retry": _case_5xx_retry, "no_routable": _case_no_routable,
              "eject_dead": _case_eject_dead}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_frontdoor_live_case(case):
    LIVE_CASES[case]()


# -- the listener's backlog (ROADMAP queue 3 entry 27) -------------------

BURST = 64


def _free_ports(n):
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


def test_a_burst_of_64_connections_is_answered_in_full(tmp_path):
    """The ``frontdoor`` CLI over two fake replicas is stopped (SIGSTOP)
    and 64 clients connect: with socketserver's backlog of 5 the kernel
    would complete about 6 of those handshakes and drop the rest's SYNs,
    so each connect below, bounded by 3 s, holds the backlog to at least
    the burst.  Once the process runs again every request is answered
    200 through a replica, and the front door exits 0 on SIGTERM."""
    base = _free_ports(2)
    reps = [FakeReplica(port=base + i) for i in range(2)]
    fdp = _free_ports(1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedpytorch_tpu_torch", "frontdoor",
         "--rsl_path", str(tmp_path), "--port", str(fdp), "--ranks", "2",
         "--serve-port", str(base), "--interval", "0.1"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    socks = []
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None and time.monotonic() < deadline
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{fdp}/healthz", timeout=2) as r:
                    doc = json.loads(r.read())
                if all(doc["upstreams"][str(i)]["alive"] for i in (0, 1)):
                    break
            except OSError:
                pass
            time.sleep(0.1)
        body = json.dumps({"image": [[0]]}).encode()
        raw = (f"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: "
               f"{len(body)}\r\nConnection: close\r\n\r\n").encode() + body
        os.kill(proc.pid, signal.SIGSTOP)
        try:
            for _ in range(BURST):
                s = socket.create_connection(("127.0.0.1", fdp), timeout=3)
                s.sendall(raw)
                socks.append(s)
        finally:
            os.kill(proc.pid, signal.SIGCONT)
        answers = []
        for s in socks:
            s.settimeout(30)
            got = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                got += chunk
            answers.append(got)
        assert all(a.startswith(b"HTTP/1.0 200") for a in answers), \
            [a[:40] for a in answers if not a.startswith(b"HTTP/1.0 200")]
        assert sum(r.hits for r in reps) == BURST
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        for s in socks:
            s.close()
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGCONT)
            proc.kill()
            proc.wait()
        for r in reps:
            r.close()


# -- RolloutManager over the port's own ledger ---------------------------

def _ledger(tmp_path):
    """Checkpoints A (epoch 0) and B (epoch 1) of a small model written by
    the port's ``save_checkpoint``, which records both in the ledger."""
    paths = []
    for epoch in (0, 1):
        torch.manual_seed(epoch)
        path = str(tmp_path / f"checkpoint-synthetic-mlp-{epoch:03d}.ckpt")
        tckpt.save_checkpoint(path, "mlp", torch.nn.Linear(4, 3), epoch,
                              0.5)
        paths.append(path)
    return paths


def _snaps(lineage, served):
    """Two live replicas; ``served`` = (requests, errors) of each."""
    return [{"id": i, "alive": True, "ejected": False, "draining": False,
             "lineage": lineage[i], "requests": served[i][0],
             "errors": served[i][1], "p95_ms": 10.0} for i in (0, 1)]


def _drive(mgr_cls, paths, script):
    """Ticks a manager of ``mgr_cls`` through ``script`` (per tick: the
    (requests, errors) each replica has answered so far) over a fleet
    serving A, whose lineage follows the reloads; returns the reloads and
    events, and the end state."""
    calls = []
    lineage = [tckpt.lineage_info(paths[0])] * 2

    def reload(i, path):
        calls.append(("reload", i, os.path.basename(path)))
        lineage[i] = tckpt.lineage_info(path)
        return True

    mgr = mgr_cls({"min_requests": 4, "hold_s": 2.0}, reload_fn=reload,
                  event_fn=lambda name, **a: calls.append(
                      (name, {k: v for k, v in a.items() if k != "path"})))
    head = ro.newest_lineage_entry(os.path.dirname(paths[0]))
    for t, served in enumerate(script):
        mgr.tick(float(t), _snaps(lineage, served), head)
    return calls, (mgr.phase, mgr.promotions, mgr.rollbacks,
                   len(mgr.rejected))


HEALTHY = [((0, 0), (0, 0)), ((2, 0), (2, 0)), ((5, 0), (5, 0)),
           ((8, 0), (8, 0)), ((9, 0), (9, 0))]
BAD = [((0, 0), (0, 0)), ((3, 3), (3, 0)), ((6, 6), (6, 0)),
       ((7, 7), (7, 0)), ((8, 8), (8, 0)), ((9, 9), (9, 0))]


@pytest.mark.parametrize("case", ("promote", "rollback", "sha_mismatch"))
def test_rollout_manager_over_the_port_ledger(tmp_path, case):
    """The head is B (newest epoch); the fleet serves A.  A healthy canary
    on replica 0 is promoted to the whole fleet; a failing one is rolled
    back and B is never canaried again; a B whose bytes no longer hash to
    the ledger's sha is rejected before any reload.  The JAX manager on
    the same ledger and script makes the same calls."""
    paths = _ledger(tmp_path)
    a, b = (os.path.basename(p) for p in paths)
    assert ro.newest_lineage_entry(str(tmp_path))["file"] == b
    if case == "sha_mismatch":
        with open(paths[1], "ab") as f:
            f.write(b"torn")
    script = HEALTHY if case == "promote" else BAD
    calls, end = _drive(ro.RolloutManager, paths, script)
    names = [c[0] for c in calls]
    reloads = [c[1:] for c in calls if c[0] == "reload"]
    if case == "promote":
        assert names == ["reload", "rollout/canary_start", "reload",
                         "rollout/promote"]
        assert reloads == [(0, b), (1, b)] and end == ("stable", 1, 0, 0)
    elif case == "rollback":
        assert names == ["reload", "rollout/canary_start", "reload",
                         "rollout/rollback"]
        assert reloads == [(0, b), (0, a)] and end == ("stable", 0, 1, 1)
    else:
        assert names == ["rollout/candidate_rejected"]
        assert calls[0][1]["reason"] == "lineage checksum mismatch"
        assert end == ("stable", 0, 0, 1)
    assert _drive(jax_ro.RolloutManager, paths, script) == (calls, end)
