"""The fleet front door: one port, health-aware routing, admission
control, and the autoscale + rollout control loop.

A copy of ``distributedpytorch_tpu/serving/frontdoor.py`` (stdlib and the
port's ``deadline``, ``telemetry``, ``fleet`` and ``slo``), kept in the
port so that the port imports nothing of the JAX package.  One change:
the listener sizes its accept backlog (``FRONTDOOR_BACKLOG``, at least
the pending budget) instead of socketserver's 5, as the port's replica,
exporter and collector listeners do, so a burst of clients is answered
or shed with a 503, never reset.  ``--launch-cmd`` names the port's
``serve --elastic --elastic-join``.

``python -m distributedpytorch_tpu_torch frontdoor`` turns N independent
serve replicas (each
answering ``/predict`` on ``serve_port + slot``) into ONE resilient
service:

  routing      every client request is proxied to the least-pending
               routable replica (deterministic round-robin tie-break);
               a replica is ejected from rotation after ``eject_after``
               consecutive probe/transport failures or a stale
               ``last_step_age_s``, and readmitted on its first healthy
               probe.  Requests are idempotent (stateless predict), so
               a transport failure or 5xx retries ONCE on a different
               replica — the upstream's ``X-DPT-Request-Id`` is
               preserved end-to-end either way.
  admission    a fleet-level pending budget layered over the
               per-replica 503 backpressure: past ``pending_budget``
               in-flight proxied requests the front door sheds
               immediately with 503 + ``Retry-After`` instead of
               queueing unboundedly.  Every upstream call carries a
               hard deadline (deadline.py), so one hung replica costs
               at most ``upstream_timeout_s`` of one handler thread —
               never the accept loop.
  control      a once-per-``interval_s`` tick probes every replica's
               ``/healthz``, folds the results through the PURE
               deciders (``decide_health`` here, ``decide_scale`` in
               controller.py, ``decide_rollout`` in rollout.py), and
               executes: launch an ``--elastic-join`` replica, drain
               one for retirement, start/promote/rollback a canary.
               Every decision is emitted as a telemetry event
               (``frontdoor/*``, ``controller/*``, ``rollout/*``) so
               the ``timeline`` reader shows the control plane next to
               the data plane.

Thread model mirrors server.py: handler threads (ThreadingHTTPServer)
only proxy — pick upstream, forward with a deadline, relay; the single
control-loop thread owns probing and all policy execution.  Shared
state (the upstream table) is guarded by one lock, held only for
bookkeeping, never across a socket call.

The pure deciders at the top of this module are clock-free functions
of (config, snapshot) in the ``slo.evaluate`` style — the snapshots
carry the counters, the functions never read a clock — so the fleet
simulator (``sim/``) drives the exact routing policy at N=100
replicas.
"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import deadline as dl
from .. import telemetry
from . import controller as ctrl
from . import rollout as ro

#: telemetry rank for the front-door process: far above any plausible
#: world size, so its JSONL never collides with a replica's.
FRONTDOOR_RANK = 90

#: front-door shed counter name injected into fleet samples, so the
#: autoscale decider sees fleet-level sheds next to replica-level ones
#: (controller._shed_total folds both).
FD_SHED_COUNTER = ctrl.FD_SHED_COUNTER

#: the listener's accept backlog, raised to the pending budget when that
#: is larger (the JAX front door keeps socketserver's 5): a burst of
#: clients must queue for an answer or a shed, not be reset.
FRONTDOOR_BACKLOG = 128

ROUTE_DEFAULTS: Dict[str, Any] = {
    "eject_after": 3,       # consecutive failures before ejection
    "max_step_age_s": 0.0,  # stale-health ejection threshold (0 = off)
    "pending_budget": 64,   # fleet-level in-flight cap
    "retry_after_s": 1.0,   # Retry-After hint on shed
}


def _policy(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(ROUTE_DEFAULTS)
    out.update(cfg or {})
    return out


# -- pure routing/admission policy -------------------------------------

def decide_health(cfg: Optional[Dict[str, Any]],
                  replicas: Sequence[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Pure ejection/readmission decisions over replica snapshots
    (``{"id", "ejected", "consecutive_failures", "last_step_age_s"}``).
    Eject on ``eject_after`` consecutive failures or a stale health
    age; readmit an ejected replica whose failure streak reset (a
    healthy probe zeroes it) and whose age is fresh again."""
    c = _policy(cfg)
    eject_after = int(c["eject_after"])
    max_age = float(c["max_step_age_s"] or 0.0)
    out: List[Dict[str, Any]] = []
    for rep in replicas:
        fails = int(rep.get("consecutive_failures", 0))
        age = rep.get("last_step_age_s")
        stale = bool(max_age > 0.0 and age is not None
                     and float(age) > max_age)
        if not rep.get("ejected"):
            if fails >= eject_after:
                out.append({"id": rep["id"], "action": "eject",
                            "reason": f"{fails} consecutive failures"})
            elif stale:
                out.append({"id": rep["id"], "action": "eject",
                            "reason": f"stale health: last_step_age_s "
                                      f"{float(age):.1f} > "
                                      f"{max_age:.1f}"})
        elif fails == 0 and not stale:
            out.append({"id": rep["id"], "action": "readmit",
                        "reason": "healthy probe"})
    return out


def routable_ids(replicas: Sequence[Dict[str, Any]]) -> List[int]:
    """Replicas eligible for NEW requests: seen alive at least once,
    not ejected, not draining."""
    return sorted(r["id"] for r in replicas
                  if r.get("alive") and not r.get("ejected")
                  and not r.get("draining"))


def pick_upstream(ids: Sequence[int], pending: Dict[int, int],
                  rr: int, exclude: Sequence[int] = ()
                  ) -> Optional[int]:
    """Least-pending routable replica, deterministic round-robin among
    ties (``rr`` is the caller's monotonically increasing pick
    counter).  Pure; None when nothing is routable."""
    pool = [i for i in sorted(ids) if i not in set(exclude)]
    if not pool:
        return None
    low = min(int(pending.get(i, 0)) for i in pool)
    tied = [i for i in pool if int(pending.get(i, 0)) == low]
    return tied[rr % len(tied)]


def admission(cfg: Optional[Dict[str, Any]], pending_total: int
              ) -> Dict[str, Any]:
    """Fleet-level admission: admit while the in-flight count is under
    the pending budget, else shed with a Retry-After hint.  Pure."""
    c = _policy(cfg)
    if int(pending_total) >= int(c["pending_budget"]):
        return {"admit": False,
                "retry_after_s": float(c["retry_after_s"])}
    return {"admit": True, "retry_after_s": 0.0}


# -- upstream bookkeeping ----------------------------------------------

class Upstream:
    """One replica slot as the front door sees it.  Mutated only under
    the front door's lock; ``snapshot()`` is what the pure deciders and
    the rollout manager consume."""

    def __init__(self, uid: int, predict_port: int, health_port: int,
                 health_path: str = "/healthz"):
        self.id = int(uid)
        self.predict_port = int(predict_port)
        self.health_port = int(health_port)
        self.health_path = health_path
        self.alive = False            # answered a probe at least once
        self.ejected = False
        self.draining = False
        self.consecutive_failures = 0
        self.pending = 0
        self.last_step_age_s: Optional[float] = None
        self.lineage: Optional[Dict[str, Any]] = None
        self.requests = 0             # proxied attempts that answered
        self.errors = 0               # 5xx answers (shed 503 excluded)
        self.unreachable = 0          # transport failures / deadlines
        self.shed = 0                 # upstream's own 503 backpressure
        self.latencies: collections.deque = collections.deque(
            maxlen=1024)

    def p95_ms(self) -> Optional[float]:
        if not self.latencies:
            return None
        vals = sorted(self.latencies)
        return vals[int(0.95 * (len(vals) - 1))]

    def snapshot(self) -> Dict[str, Any]:
        return {"id": self.id, "alive": self.alive,
                "ejected": self.ejected, "draining": self.draining,
                "consecutive_failures": self.consecutive_failures,
                "pending": self.pending,
                "last_step_age_s": self.last_step_age_s,
                "lineage": self.lineage,
                "requests": self.requests,
                # rollout's error signal: application 5xx AND
                # unreachability both count against a canary
                "errors": self.errors + self.unreachable,
                "shed": self.shed, "p95_ms": self.p95_ms()}


class SubprocessLauncher:
    """Scale-up executor: spawn one ``--elastic-join`` replica per
    ``launch()`` from a shell command template.  The command is
    operator-supplied (config ``--launch-cmd``); stdout/stderr land in
    numbered logs under ``log_dir`` so a failed join is debuggable."""

    def __init__(self, cmd: str, cwd: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self.cmd = cmd
        self.cwd = cwd
        self.log_dir = log_dir
        self.launched = 0
        self.procs: List[Any] = []

    def launch(self) -> bool:
        import shlex
        import subprocess

        self.launched += 1
        out = None
        if self.log_dir:
            import os

            os.makedirs(self.log_dir, exist_ok=True)
            out = open(f"{self.log_dir}/join-{self.launched}.log", "ab")
        try:
            self.procs.append(subprocess.Popen(
                shlex.split(self.cmd), cwd=self.cwd, stdout=out,
                stderr=out))
            return True
        except OSError as e:
            logging.error(f"frontdoor: launch command failed: {e}")
            return False


# -- the front door -----------------------------------------------------

class FrontDoor:
    """The impure shell: listener + proxy + control loop."""

    def __init__(self, port: int,
                 replicas: Dict[int, Dict[str, Any]],
                 *, host: str = "127.0.0.1",
                 policy: Optional[Dict[str, Any]] = None,
                 upstream_timeout_s: float = 10.0,
                 probe_timeout_s: float = 2.0,
                 interval_s: float = 0.5,
                 collector: Optional[Any] = None,
                 scale_cfg: Optional[Dict[str, Any]] = None,
                 launcher: Optional[Callable[[], bool]] = None,
                 rollout_cfg: Optional[Dict[str, Any]] = None,
                 watch_dir: Optional[str] = None,
                 reload_timeout_s: float = 180.0,
                 drain_timeout_s: float = 10.0):
        self.port = int(port)
        self.host = host
        self.policy = _policy(policy)
        self.upstream_timeout_s = float(upstream_timeout_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.interval_s = float(interval_s)
        self.reload_timeout_s = float(reload_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._ups: Dict[int, Upstream] = {
            int(uid): Upstream(
                uid, spec["predict_port"],
                spec.get("health_port") or spec["predict_port"],
                spec.get("health_path", "/healthz"))
            for uid, spec in replicas.items()}
        self._lock = threading.Lock()
        self._rr = 0
        self._pending_total = 0
        self._shed = 0            # fleet-level admission sheds
        self._no_upstream = 0     # 503s for "nothing routable"
        self._retries = 0
        self._answered = 0
        self._client_codes: Dict[int, int] = {}
        self._coll = collector
        self._scale_cfg = dict(scale_cfg) if scale_cfg else None
        self._scale_state: Dict[str, Any] = {}
        self._launcher = launcher
        self.scale_events: List[Dict[str, Any]] = []
        self.rollout: Optional[ro.RolloutManager] = None
        if watch_dir is not None:
            self.rollout = ro.RolloutManager(
                rollout_cfg, reload_fn=self._reload_replica,
                event_fn=self._event)
        self._watch_dir = watch_dir
        self.cycle = 0
        self._server: Optional[Any] = None
        self._http_thread: Optional[threading.Thread] = None

    # -- telemetry -----------------------------------------------------

    def _event(self, name: str, **attrs: Any) -> None:
        tel = telemetry.get()
        tel.event(name, **attrs)
        tel.flush()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        import http.server

        fd = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - http.server API
                if self.path.rstrip("/") != "/predict":
                    self.send_error(404)
                    return
                try:
                    fd._proxy(self)
                except BrokenPipeError:
                    pass  # client gave up mid-relay
                # broad on purpose: the front door must answer every
                # request — a proxy bug becomes the client's 500, not
                # a dropped connection
                except Exception as e:
                    logging.error(f"frontdoor: handler failed: {e}")
                    try:
                        fd._respond(self, 500, {"error": repr(e)})
                    except Exception:
                        pass  # client already gone — nothing to answer

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.rstrip("/") in ("/healthz", "/livez"):
                    fd._respond(self, 200, fd.status_doc())
                else:
                    self.send_error(404)

            def log_message(self, fmt, *args):
                pass

        class _Listener(http.server.ThreadingHTTPServer):
            request_queue_size = max(FRONTDOOR_BACKLOG,
                                     int(fd.policy["pending_budget"]))

        self._server = _Listener(("0.0.0.0", self.port), _Handler)
        self.port = self._server.server_address[1]
        self._server.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="frontdoor-listener", daemon=True)
        self._http_thread.start()
        logging.info(f"frontdoor: listening on :{self.port} over "
                     f"{len(self._ups)} replica slots "
                     f"(pending budget {self.policy['pending_budget']})")

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
            if self._http_thread is not None:
                self._http_thread.join(timeout=5.0)

    # -- proxy path (handler threads) ----------------------------------

    def _respond(self, handler, code: int, payload: dict,
                 headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
        with self._lock:
            self._client_codes[code] = \
                self._client_codes.get(code, 0) + 1

    def _relay(self, handler, status: int, raw: bytes,
               rid: Optional[str], uid: int) -> None:
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        if rid:
            handler.send_header("X-DPT-Request-Id", rid)
        handler.send_header("X-DPT-Upstream", str(uid))
        handler.send_header("Content-Length", str(len(raw)))
        handler.end_headers()
        handler.wfile.write(raw)
        with self._lock:
            self._client_codes[status] = \
                self._client_codes.get(status, 0) + 1

    def _forward(self, up: Upstream, body: bytes):
        """One deadline-bounded upstream attempt.  Raises OSError on
        any transport failure (timeout included); returns
        ``(status, raw_body, request_id)``."""
        conn = http.client.HTTPConnection(
            self.host, up.predict_port, timeout=self.upstream_timeout_s)
        try:
            conn.request("POST", "/predict", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            return (int(resp.status), raw,
                    resp.getheader("X-DPT-Request-Id"))
        except http.client.HTTPException as e:
            raise OSError(f"upstream protocol error: {e}") from e
        finally:
            conn.close()

    def _proxy(self, handler) -> None:
        tel = telemetry.get()
        tel.counter("frontdoor/requests").add()
        n = int(handler.headers.get("Content-Length", 0))
        body = handler.rfile.read(n)
        with self._lock:
            verdict = admission(self.policy, self._pending_total)
            if not verdict["admit"]:
                self._shed += 1
            else:
                self._pending_total += 1
        if not verdict["admit"]:
            tel.counter("frontdoor/shed").add()
            self._respond(
                handler, 503,
                {"error": "front door at capacity",
                 "pending": self._pending_total},
                headers={"Retry-After":
                         f"{verdict['retry_after_s']:g}"})
            return
        tried: List[int] = []
        last = None  # (status, raw, rid, uid) from an answering 5xx
        try:
            for attempt in range(2):
                with self._lock:
                    snaps = [u.snapshot() for u in self._ups.values()]
                    pending = {u.id: u.pending
                               for u in self._ups.values()}
                    uid = pick_upstream(routable_ids(snaps), pending,
                                        self._rr, exclude=tried)
                    self._rr += 1
                    if uid is None:
                        break
                    up = self._ups[uid]
                    up.pending += 1
                tried.append(uid)
                if attempt:
                    self._retries += 1
                    tel.counter("frontdoor/retries").add()
                t0 = time.monotonic()
                try:
                    status, raw, rid = self._forward(up, body)
                except OSError as e:
                    with self._lock:
                        up.pending -= 1
                        up.unreachable += 1
                        up.consecutive_failures += 1
                    logging.info(f"frontdoor: replica {uid} "
                                 f"unreachable ({e}); "
                                 f"{'retrying' if not attempt else 'giving up'}")
                    continue
                ms = (time.monotonic() - t0) * 1000.0
                with self._lock:
                    up.pending -= 1
                    up.requests += 1
                    up.consecutive_failures = 0
                    up.latencies.append(ms)
                    if status == 503:
                        up.shed += 1
                    elif status >= 500:
                        up.errors += 1
                if status < 500:
                    self._answered += 1
                    self._relay(handler, status, raw, rid, uid)
                    return
                last = (status, raw, rid, uid)
            if last is not None:
                # both attempts answered 5xx: relay the upstream's own
                # error — the id still names the real failing request
                self._relay(handler, *last)
            else:
                self._no_upstream += 1
                tel.counter("frontdoor/no_upstream").add()
                self._respond(
                    handler, 503, {"error": "no routable replica"},
                    headers={"Retry-After":
                             f"{self.policy['retry_after_s']:g}"})
        finally:
            with self._lock:
                self._pending_total -= 1

    # -- control loop (single thread) ----------------------------------

    def _probe(self, budget: dl.Deadline) -> None:
        for up in list(self._ups.values()):
            doc = dl.fetch_json(
                f"http://{self.host}:{up.health_port}"
                f"{up.health_path}",
                self.probe_timeout_s, deadline=budget)
            with self._lock:
                if doc is None:
                    if up.alive:
                        up.consecutive_failures += 1
                    continue
                serve = doc.get("serve")
                if not isinstance(serve, dict):
                    # probe hit a /livez (tier.stats() body) directly
                    serve = doc if "queue_depth" in doc else {}
                up.alive = True
                up.consecutive_failures = 0
                age = doc.get("last_step_age_s")
                up.last_step_age_s = (float(age) if age is not None
                                      else None)
                up.draining = bool(serve.get("draining"))
                lin = serve.get("checkpoint")
                if isinstance(lin, dict) and lin.get("sha256"):
                    up.lineage = lin

    def _apply_health(self) -> None:
        with self._lock:
            snaps = [u.snapshot() for u in self._ups.values()
                     if u.alive]
        for d in decide_health(self.policy, snaps):
            with self._lock:
                up = self._ups[d["id"]]
                up.ejected = d["action"] == "eject"
            logging.info(f"frontdoor: {d['action']} replica "
                         f"{d['id']} — {d['reason']}")
            self._event(f"frontdoor/{d['action']}", id=d["id"],
                        reason=d["reason"])

    def _reload_replica(self, uid: int, path: str) -> bool:
        up = self._ups.get(int(uid))
        if up is None:
            return False
        status, body = dl.post_json(
            f"http://{self.host}:{up.predict_port}/admin/reload",
            {"checkpoint": path}, timeout_s=self.reload_timeout_s)
        if status != 200:
            logging.warning(f"frontdoor: reload of replica {uid} -> "
                            f"{path} answered {status} {body}")
        return status == 200

    def _drain_replica(self, uid: int) -> bool:
        up = self._ups.get(int(uid))
        if up is None:
            return False
        status, _ = dl.post_json(
            f"http://{self.host}:{up.predict_port}/admin/drain", {},
            timeout_s=self.drain_timeout_s)
        if status == 200:
            with self._lock:
                up.draining = True
        return status == 200

    def _autoscale(self, samples: List[Dict[str, Any]]) -> None:
        if self._scale_cfg is None or not samples:
            return
        decision = ctrl.decide_scale(self._scale_cfg,
                                     self._scale_state, samples)
        if decision["action"] == "none":
            return
        t = float(samples[-1]["t"])
        if decision["action"] == "up":
            if self._launcher is None or not self._launcher():
                logging.warning(
                    f"frontdoor: scale-up wanted ({decision['reason']})"
                    f" but no launcher is configured")
                return
            logging.info(f"frontdoor: scale UP {decision['world']} -> "
                         f"{decision['target']} ({decision['reason']})")
            self._event("controller/scale_up",
                        world=decision["world"],
                        target=decision["target"],
                        reason=decision["reason"])
        else:
            protected = list(self.rollout.canary_ids) \
                if self.rollout else []
            with self._lock:
                snaps = [u.snapshot() for u in self._ups.values()]
            victim = ctrl.pick_retire(routable_ids(snaps), protected)
            if victim is None or not self._drain_replica(victim):
                return
            logging.info(f"frontdoor: scale DOWN {decision['world']} "
                         f"-> {decision['target']}: draining replica "
                         f"{victim} ({decision['reason']})")
            self._event("controller/scale_down",
                        world=decision["world"],
                        target=decision["target"], id=victim,
                        reason=decision["reason"])
        self._scale_state["last_action_t"] = t
        self.scale_events.append(decision)

    def tick(self) -> None:
        """One control cycle: probe -> eject/readmit -> collect ->
        autoscale -> rollout.  The probe pass shares one deadline
        budget, so N wedged replicas cannot stretch a cycle past
        ~max(interval, one probe timeout)."""
        self.cycle += 1
        budget = dl.Deadline(max(self.interval_s, self.probe_timeout_s))
        self._probe(budget)
        self._apply_health()
        samples: List[Dict[str, Any]] = []
        if self._coll is not None:
            sample = self._coll.scrape_once()
            # surface the fleet-level sheds to the scale decider
            with self._lock:
                sample["counters"][FD_SHED_COUNTER] = float(self._shed)
            samples = list(self._coll._samples)
        self._autoscale(samples)
        if self.rollout is not None and self._watch_dir:
            with self._lock:
                snaps = [u.snapshot() for u in self._ups.values()]
            head = ro.newest_lineage_entry(self._watch_dir)
            self.rollout.tick(
                samples[-1]["t"] if samples else float(self.cycle)
                * self.interval_s, snaps, head)

    def run(self, max_cycles: int = 0,
            shutdown: Optional[threading.Event] = None) -> int:
        """The control loop: tick every ``interval_s`` until shutdown
        (or ``max_cycles`` for bounded runs).  Returns cycles run."""
        while not (shutdown is not None and shutdown.is_set()):
            t0 = time.monotonic()
            self.tick()
            if max_cycles and self.cycle >= max_cycles:
                break
            rest = self.interval_s - (time.monotonic() - t0)
            if rest > 0:
                if shutdown is not None:
                    shutdown.wait(rest)
                else:
                    time.sleep(rest)
        return self.cycle

    # -- introspection -------------------------------------------------

    def status_doc(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ok": True, "port": self.port, "cycle": self.cycle,
                "pending": self._pending_total,
                "answered": self._answered, "shed": self._shed,
                "no_upstream": self._no_upstream,
                "retries": self._retries,
                "client_codes": {str(k): v for k, v
                                 in sorted(self._client_codes.items())},
                "rollout": ({"phase": self.rollout.phase,
                             "stable": (self.rollout.stable_sha
                                        or "")[:12],
                             "canary_ids": self.rollout.canary_ids,
                             "rollbacks": self.rollout.rollbacks,
                             "promotions": self.rollout.promotions}
                            if self.rollout else None),
                "scale_events": len(self.scale_events),
                "upstreams": {str(u.id): u.snapshot()
                              for u in self._ups.values()},
            }


# -- CLI entry (the frontdoor subcommand) -------------------------------

def run_cli(cfg) -> int:
    """``frontdoor``: stand up the front door over
    ``--ranks`` replica slots (predict on ``serve_port + slot``,
    health on ``metrics_port + slot``), with optional autoscale
    (``--autoscale`` + ``--launch-cmd``) and rollout (``--rollout``).
    A monitoring/control process, never a member of the world — no
    device is touched."""
    import signal

    from .. import fleet, slo

    telemetry.configure(cfg.rsl_path, True, rank=FRONTDOOR_RANK)
    tel = telemetry.get()
    slos = slo.load_spec(cfg.slo_spec) if cfg.slo_spec else None
    max_world = cfg.fd_max_world or cfg.fd_ranks
    nslots = max(cfg.fd_ranks, max_world)
    replicas = {
        i: {"predict_port": cfg.serve_port + i,
            "health_port": ((cfg.metrics_port + i)
                            if cfg.metrics_port
                            else (cfg.serve_port + i)),
            "health_path": ("/healthz" if cfg.metrics_port
                            else "/livez")}
        for i in range(nslots)}
    collector = None
    if cfg.metrics_port:
        collector = fleet.FleetCollector(
            cfg.rsl_path, ranks=nslots,
            metrics_port=cfg.metrics_port,
            interval_s=cfg.fd_interval,
            stale_after=cfg.fleet_stale_after, port=0, slos=slos)
    scale_cfg = None
    launcher = None
    if cfg.fd_autoscale:
        scale_cfg = {"min_world": cfg.fd_min_world,
                     "max_world": max_world,
                     "queue_high": cfg.fd_queue_high,
                     "queue_low": cfg.fd_queue_low,
                     "up_hold_s": cfg.fd_up_hold,
                     "down_hold_s": cfg.fd_down_hold,
                     "cooldown_s": cfg.fd_cooldown}
        if cfg.fd_launch_cmd:
            launcher = SubprocessLauncher(
                cfg.fd_launch_cmd, log_dir=cfg.rsl_path).launch
    rollout_cfg = None
    watch_dir = None
    if cfg.fd_rollout:
        watch_dir = cfg.fd_watch_dir or cfg.rsl_path
        rollout_cfg = {"fraction": cfg.fd_canary_fraction,
                       "hold_s": cfg.fd_canary_hold,
                       "min_requests": cfg.fd_canary_min_requests,
                       "max_error_ratio": cfg.fd_canary_max_error,
                       "p95_factor": cfg.fd_canary_p95_factor}
    fd = FrontDoor(
        cfg.fd_port, replicas,
        policy={"eject_after": cfg.fd_eject_after,
                "max_step_age_s": cfg.fd_max_step_age,
                "pending_budget": cfg.fd_pending_budget,
                "retry_after_s": cfg.fd_retry_after},
        upstream_timeout_s=cfg.fd_upstream_timeout,
        interval_s=cfg.fd_interval, collector=collector,
        scale_cfg=scale_cfg, launcher=launcher,
        rollout_cfg=rollout_cfg, watch_dir=watch_dir)
    shutdown = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: shutdown.set())
    fd.start()
    tel.event("frontdoor_start", port=fd.port, slots=nslots,
              autoscale=bool(scale_cfg), rollout=bool(watch_dir))
    tel.flush()
    try:
        cycles = fd.run(max_cycles=cfg.fd_max_cycles,
                        shutdown=shutdown)
        doc = fd.status_doc()
        logging.info(
            f"frontdoor: stopped after {cycles} cycles — "
            f"{doc['answered']} answered, {doc['shed']} shed, "
            f"{len(fd.scale_events)} scale events, "
            f"{doc['rollout']['rollbacks'] if doc['rollout'] else 0} "
            f"rollbacks")
    finally:
        fd.close()
        tel.close()
    return 0
