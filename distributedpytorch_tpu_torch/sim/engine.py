"""The discrete-event core: a virtual-clock fleet driving real policies.

One ``FleetSim`` owns a seeded event heap keyed ``(t, seq)`` — virtual
seconds and a monotone push counter, so simultaneous events replay in
push order and the whole run is a pure function of (scenario, seed,
latency model).  The clock contract for every artifact this emits:
``mono = t`` and ``ts = BASE_TS + t`` — a fixed epoch, never the wall
clock, so ``ts - mono`` is one constant for every simulated rank and
the ``timeline`` reader's per-rank wall alignment holds trivially.

What is real and what is simulated, precisely:

  real    plan_batch / parse_buckets, admission / routable_ids /
          pick_upstream / decide_health, decide_scale / pick_retire,
          evaluate_join_policy, decide_rollout / choose_canaries,
          slo.evaluate, faults.parse_plan + RetryPolicy._delay (the
          deterministic backoff schedule), the sample/incident/trace/
          telemetry/goodput schema factories.
  fake    only the physics: request arrival times (traffic.py), batch
          service times (latency.py), and the fault schedule's effect
          on replica state (scenario.timed_faults).

Replica state is the dict shape the pure deciders already consume
(``{"id", "alive", "ejected", "draining", "consecutive_failures",
"last_step_age_s"}``) plus simulator bookkeeping keys the policies
never read.
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .. import elastic, faults, slo, telemetry
from ..serving import controller, frontdoor, planner
from ..serving import rollout as ro
from . import latency as latmod
from . import scenario as scmod
from . import traffic

#: Fixed virtual epoch: every emitted ``ts`` is BASE_TS + t.  Chosen
#: inside the plausible-unix-time range so renderers treat it like a
#: real run; NEVER derived from the wall clock (rule 21).
BASE_TS = 1_700_000_000.0

#: Ports are cosmetic in a simulated fleet sample, but the schema has
#: the field; replica rank r "listens" here.
_PORT_BASE = 9100

#: The live front door exports telemetry as FRONTDOOR_RANK (90).
#: Simulated replica ranks are dense from 0 and routinely pass 90 at
#: N=100+, so the simulated front door parks at a rank no fleet will
#: reach — same role, collision-free.
FD_RANK = 9000 + frontdoor.FRONTDOOR_RANK


class FleetSim:
    """One scenario replay.  ``run()`` returns the report dict; the
    artifact streams (event log, telemetry, traces, samples, incidents,
    goodput rows) accumulate on the instance for artifacts.py."""

    def __init__(self, sc: Dict[str, Any], seed: int,
                 model: Optional[Dict[str, Any]] = None):
        self.sc = sc
        self.seed = int(seed)
        self.model = model or latmod.DEFAULT_MODEL
        self.t = 0.0
        self._heap: List[Tuple[float, int, str, Any]] = []
        self._push_seq = 0
        self.duration = float(sc["duration_s"])
        self.interval = float(sc["interval_s"])
        self.buckets = planner.parse_buckets(sc["buckets"])
        self.route_cfg = dict(sc["route"])
        self.scale_cfg = dict(sc["scale"])
        self.rollout_cfg = dict(sc["rollout"] or {})
        self.rng_traffic = random.Random(f"{self.seed}:traffic")
        self.rng_lat = random.Random(f"{self.seed}:latency")
        self.retry = faults.RetryPolicy(
            max_attempts=int(sc["max_attempts"]), base_delay_s=0.5,
            max_delay_s=8.0, timeout_s=1e9, seed=self.seed)

        # -- fleet state ----------------------------------------------
        self.replicas: Dict[int, Dict[str, Any]] = {}
        self._next_rank = 0
        self._routable: Optional[List[int]] = None  # cache
        self.pending: Dict[int, int] = {}   # rank -> queued + in-flight
        self.pending_total = 0
        self.rr = 0                         # pick_upstream tie-breaker
        self.generation = 0
        self.pending_joins: List[str] = []  # jids awaiting a tick
        self.joiners: Dict[str, Dict[str, Any]] = {}
        self._join_seq = 0
        self.scale_state: Dict[str, Any] = {"last_action_t": None}
        self.canary_ids: List[int] = []
        self.ro_state: Optional[Dict[str, Any]] = None
        self.ro_group: Dict[str, Any] = {}
        self.rollout_outcome: Optional[str] = None

        # -- counters / series ----------------------------------------
        self.c: Dict[str, int] = {
            "arrivals": 0, "admitted": 0, "fd_shed": 0, "answered": 0,
            "failed": 0, "retries": 0, "dropped_forever": 0,
            "requeued": 0, "lost_inflight": 0}
        self.lat_hist = telemetry.Histogram("dpt_serve_request_latency_ms")
        self.first_shed_t: Optional[float] = None
        self.last_shed_t: Optional[float] = None

        # -- artifact streams -----------------------------------------
        self.events: List[Dict[str, Any]] = []   # sim-events.jsonl
        self.tel: Dict[int, List[Tuple[float, Dict[str, Any]]]] = {}
        self.traces: List[Dict[str, Any]] = []
        self._trace_seq: Dict[int, int] = {}     # per-rank trace seq
        self.bad_trace: List[Tuple[float, str]] = []  # (ts, id)
        window = max(float(w["seconds"]) for s in sc["slos"]
                     for w in s["windows"]) if sc["slos"] else 30.0
        self.samples: deque = deque(
            maxlen=max(8, int(window * 3.0 / self.interval) + 2))
        self.cycle = 0
        self._slo_firing: set = set()
        self.incidents: List[Tuple[str, Dict[str, Any]]] = []
        self.scale_actions: List[Tuple[float, str]] = []
        self.health_actions: Dict[str, int] = {"eject": 0, "readmit": 0}
        self.join_admits: Dict[str, int] = {}
        self.join_claims: Dict[str, int] = {}
        self.gp_rows: Dict[int, List[Dict[str, Any]]] = {}
        self._gp_last: Dict[int, float] = {}
        self._gp_epoch = 0

    # -- plumbing ------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any = None) -> None:
        self._push_seq += 1
        heapq.heappush(self._heap, (t, self._push_seq, kind, payload))

    def _log(self, ev: str, **fields: Any) -> None:
        self.events.append({"t": round(self.t, 6), "ev": ev, **fields})

    def _tel_event(self, rank: int, name: str, **attrs: Any) -> None:
        payload: Dict[str, Any] = {"kind": "event", "name": name}
        if attrs:
            payload["attrs"] = attrs
        self.tel.setdefault(rank, []).append((self.t, payload))

    def ts(self, t: Optional[float] = None) -> float:
        return BASE_TS + (self.t if t is None else t)

    # -- replica lifecycle ---------------------------------------------

    def _new_replica(self, origin: str) -> Dict[str, Any]:
        rank = self._next_rank
        self._next_rank += 1
        r = {"id": rank, "alive": True, "ejected": False,
             "draining": False, "consecutive_failures": 0,
             "last_step_age_s": 0.0,
             # simulator bookkeeping (never read by the deciders):
             "last_step_t": self.t, "queue": deque(), "busy": False,
             "inflight": 0, "requests_total": 0, "errors_total": 0,
             "busy_s": 0.0, "ioerror_pending": 0, "stall_pending_s": 0.0,
             "version": "stable", "origin": origin, "_batch": None}
        self.replicas[rank] = r
        self.pending[rank] = 0
        self._routable = None
        self._gp_last[rank] = 0.0
        self._tel_event(rank, "sim/replica_start", origin=origin)
        return r

    def _snapshot_ids(self) -> List[int]:
        if self._routable is None:
            self._routable = frontdoor.routable_ids(
                list(self.replicas.values()))
        return self._routable

    def _alive_ranks(self) -> List[int]:
        return sorted(r["id"] for r in self.replicas.values()
                      if r["alive"])

    # -- request flow --------------------------------------------------

    def _arrive(self, req: Dict[str, Any]) -> None:
        self.c["arrivals"] += 1
        req["attempts"] += 1
        verdict = frontdoor.admission(self.route_cfg, self.pending_total)
        if not verdict["admit"]:
            self._shed(req, verdict["retry_after_s"])
            return
        self.c["admitted"] += 1
        ids = self._snapshot_ids()
        self.rr += 1
        rank = frontdoor.pick_upstream(ids, self.pending, self.rr)
        if rank is None:
            # Nothing routable (whole fleet dead/ejected): same client
            # experience as a shed.
            self._shed(req, float(self.route_cfg.get(
                "retry_after_s",
                frontdoor.ROUTE_DEFAULTS["retry_after_s"])))
            return
        self._enqueue(rank, req)

    def _shed(self, req: Dict[str, Any], retry_after_s: float) -> None:
        self.c["fd_shed"] += 1
        if self.first_shed_t is None:
            self.first_shed_t = self.t
        self.last_shed_t = self.t
        self._trace(FD_RANK, req, status=503,
                    outcome="shed", spans={"shed": 0.0005})
        self._log("shed", rid=req["rid"], attempts=req["attempts"])
        self._retry_later(req, extra_s=float(retry_after_s))

    def _retry_later(self, req: Dict[str, Any], extra_s: float = 0.0
                     ) -> None:
        if req["attempts"] >= int(self.sc["max_attempts"]):
            self.c["dropped_forever"] += 1
            self._trace(FD_RANK, req, status=504,
                        outcome="timeout", spans={"timeout": 0.0005})
            self._log("drop", rid=req["rid"], attempts=req["attempts"])
            return
        self.c["retries"] += 1
        delay = extra_s + self.retry._delay(f"sim.retry:{req['rid']}",
                                            req["attempts"])
        self._push(self.t + delay, "arrival", req)

    def _enqueue(self, rank: int, req: Dict[str, Any]) -> None:
        r = self.replicas[rank]
        r["queue"].append((req, self.t))
        self.pending[rank] += 1
        self.pending_total += 1
        if not r["busy"]:
            self._push(self.t + float(self.sc["flush_s"]), "dispatch",
                       rank)

    def _dispatch(self, rank: int) -> None:
        r = self.replicas.get(rank)
        if r is None or not r["alive"] or r["busy"] or not r["queue"]:
            return
        take, bucket, padding = planner.plan_batch(len(r["queue"]),
                                                   self.buckets)
        reqs = [r["queue"].popleft() for _ in range(take)]
        service = (latmod.sample(self.rng_lat, self.model, "infer_base_s")
                   + bucket * latmod.sample(self.rng_lat, self.model,
                                            "infer_per_row_s"))
        if r["stall_pending_s"] > 0.0:
            service += r["stall_pending_s"]
            self._log("stall_applied", rank=rank,
                      stall_s=round(r["stall_pending_s"], 6))
            r["stall_pending_s"] = 0.0
        r["busy"] = True
        r["inflight"] = take
        batch = {"rank": rank, "t_start": self.t, "service": service,
                 "reqs": reqs, "bucket": bucket, "padding": padding}
        r["_batch"] = batch  # so _kill can re-route a dying replica's work
        self._push(self.t + service, "done", batch)

    def _done(self, batch: Dict[str, Any]) -> None:
        rank = batch["rank"]
        r = self.replicas.get(rank)
        if r is None or not r["alive"] or r.get("_batch") is not batch:
            return  # the replica died mid-service; _kill re-routed
        r["_batch"] = None
        r["busy"] = False
        r["inflight"] = 0
        r["last_step_t"] = self.t
        r["busy_s"] += batch["service"]
        respond = latmod.sample(self.rng_lat, self.model, "respond_s")
        for req, t_enq in batch["reqs"]:
            self.pending[rank] -= 1
            self.pending_total -= 1
            r["requests_total"] += 1
            if r["ioerror_pending"] > 0:
                r["ioerror_pending"] -= 1
                r["errors_total"] += 1
                self.c["failed"] += 1
                self._trace(rank, req, status=500, outcome="failed",
                            spans={"queue_wait": batch["t_start"] - t_enq,
                                   "infer": batch["service"]})
                self._log("fail", rid=req["rid"], rank=rank)
                self._retry_later(req)
                continue
            queue_wait = batch["t_start"] - t_enq
            spans = {"queue_wait": queue_wait, "batch_form": 0.0005,
                     "infer": batch["service"], "respond": respond}
            latency_ms = (queue_wait + 0.0005 + batch["service"]) * 1000.0
            self.c["answered"] += 1
            self.lat_hist.observe(latency_ms)
            if self.ro_state is not None:
                g = self.ro_group[r["version"]]
                g["requests"] += 1
                g["hist"].observe(latency_ms)
            if req["rid"] % int(self.sc["trace_sample"]) == 0:
                self._trace(rank, req, status=200, outcome="answered",
                            spans=spans, latency_ms=latency_ms,
                            bucket=batch["bucket"])
                self._log("answered", rid=req["rid"], rank=rank,
                          latency_ms=round(latency_ms, 3))
        if r["draining"] and not r["queue"]:
            self._retire(r)
        elif r["queue"]:
            self._dispatch(rank)

    def _trace(self, rank: int, req: Dict[str, Any], *, status: int,
               outcome: str, spans: Dict[str, float],
               latency_ms: Optional[float] = None,
               bucket: Optional[int] = None) -> None:
        from .. import tracing
        seq = self._trace_seq.get(rank, 0)
        self._trace_seq[rank] = seq + 1
        rec = tracing.build_request_record(
            rank=rank, seq=seq, ts_admit=self.ts(req["t0"]),
            mono_admit=req["t0"], status=status, outcome=outcome,
            spans=spans, ts=self.ts(), mono=self.t,
            bucket=bucket, latency_ms=latency_ms,
            attrs={"sim": True, "attempts": req["attempts"]})
        self.traces.append(rec)
        if outcome in ("failed", "shed", "timeout"):
            self.bad_trace.append((rec["ts"], rec["id"]))

    # -- faults --------------------------------------------------------

    def _fault(self, f: Dict[str, Any]) -> None:
        kind, count = f["kind"], int(f["count"])
        self._tel_event(FD_RANK, "fault_injected",
                        site="sim.step", kind=kind, count=count)
        if kind in ("rank_loss", "preempt"):
            victims = [self.replicas[i] for i in
                       sorted(self._alive_ranks(), reverse=True)[:count]]
            for r in victims:
                if kind == "rank_loss":
                    self._kill(r, reason="rank_loss")
                else:
                    r["draining"] = True
                    r["_preempted"] = True
                    self._routable = None
                    if not r["busy"]:
                        self._retire(r, rejoin=True)
            self._log("fault", kind=kind, count=count,
                      victims=[r["id"] for r in victims])
        elif kind == "stall":
            targets = [self.replicas[i] for i in
                       sorted(self._alive_ranks(), reverse=True)[:count]]
            for r in targets:
                r["stall_pending_s"] += float(f["stall_s"])
            self._log("fault", kind=kind, count=count,
                      stall_s=f["stall_s"],
                      victims=[r["id"] for r in targets])
        elif kind == "ioerror":
            # Spread the failing requests across the fleet so the burst
            # is an error-RATE spike (the availability SLO's input),
            # not a single slow replica's backlog.
            alive = self._alive_ranks()
            if alive:
                per, extra = divmod(count, len(alive))
                for i, rank in enumerate(alive):
                    self.replicas[rank]["ioerror_pending"] += (
                        per + (1 if i < extra else 0))
                self._log("fault", kind=kind, count=count,
                          victims=alive)
        elif kind == "rank_join":
            for _ in range(count):
                self._claim_join(origin="plan")
            self._log("fault", kind=kind, count=count)

    def _kill(self, r: Dict[str, Any], reason: str) -> None:
        """Abrupt loss: in-flight work is gone, queued work re-routes,
        the slot rejoins through the real admission policy later."""
        rank = r["id"]
        r["alive"] = False
        r["busy"] = False
        self._routable = None
        lost = r["inflight"]
        r["inflight"] = 0
        self.pending_total -= self.pending[rank]
        self.pending[rank] = 0
        self.c["lost_inflight"] += lost
        queued = list(r["queue"])
        r["queue"].clear()
        self._log("rank_loss", rank=rank, reason=reason,
                  lost_inflight=lost, requeued=len(queued))
        # Queued requests re-route immediately (the front door re-sends
        # on connection failure); in-flight ones are client retries
        # with backoff — either way NOTHING is silently forgotten,
        # which is what lets a floor assert dropped_forever exactly.
        for req, _ in queued:
            self.c["requeued"] += 1
            self._push(self.t, "arrival", req)
        batch = r.get("_batch")
        r["_batch"] = None
        if batch is not None:
            for req, _ in batch["reqs"]:
                self._retry_later(req)
        self._push(self.t + float(self.sc["rejoin_delay_s"]),
                   "claim_join", {"origin": f"rejoin:{rank}"})

    def _retire(self, r: Dict[str, Any], rejoin: bool = False) -> None:
        rank = r["id"]
        r["alive"] = False
        r["draining"] = False
        self._routable = None
        self._log("retired", rank=rank, rejoin=rejoin)
        if rejoin or r.pop("_preempted", False):
            self._push(self.t + float(self.sc["rejoin_delay_s"]),
                       "claim_join", {"origin": f"rejoin:{rank}"})

    # -- elastic joins -------------------------------------------------

    def _claim_join(self, origin: str) -> str:
        self._join_seq += 1
        jid = f"j{self._join_seq:04d}"
        self.joiners[jid] = {"origin": origin}
        self.pending_joins.append(jid)
        self.join_claims[jid] = self.join_claims.get(jid, 0) + 1
        self._log("join_claim", jid=jid, origin=origin)
        return jid

    def _process_joins(self) -> None:
        if not self.pending_joins:
            return
        el = self.sc["elastic"]
        live = len(self._alive_ranks())
        admit, declined = elastic.evaluate_join_policy(
            live, list(self.pending_joins), str(el["target"]),
            int(el["min_world"]))
        self.pending_joins = []
        if admit:
            self.generation += 1
        for jid in admit:
            origin = self.joiners[jid]["origin"]
            key = origin if origin.startswith("rejoin:") else jid
            self.join_admits[key] = self.join_admits.get(key, 0) + 1
            r = self._new_replica(origin=origin)
            self._tel_event(r["id"], "elastic/join",
                            generation=self.generation,
                            new_world=len(self._alive_ranks()),
                            new_rank=r["id"], jid=jid)
            self._log("join_admit", jid=jid, rank=r["id"],
                      generation=self.generation, origin=origin)
        for jid, reason in declined:
            self._log("join_decline", jid=jid, reason=reason)
            self._tel_event(FD_RANK,
                            "elastic/join_declined", jid=jid)
            # A declined joiner claims again — the thrash the floors
            # watch for would show up here as an admit/decline loop.
            info = self.joiners[jid]
            self._push(self.t + float(self.sc["join_retry_s"]),
                       "claim_join", {"origin": info["origin"]})

    # -- control tick --------------------------------------------------

    def _tick(self) -> None:
        self.cycle += 1
        # 1. health bookkeeping: ages + probe failure streaks.
        for r in self.replicas.values():
            r["last_step_age_s"] = self.t - r["last_step_t"]
            if r["alive"]:
                r["consecutive_failures"] = 0
            else:
                r["consecutive_failures"] += 1
        # 2. join admissions (the coordinator's health-boundary scan).
        self._process_joins()
        # 3. ejection / readmission via the real decider.
        for action in frontdoor.decide_health(
                self.route_cfg, list(self.replicas.values())):
            r = self.replicas[action["id"]]
            if action["action"] == "eject":
                r["ejected"] = True
                self.health_actions["eject"] += 1
                self._requeue_queued(r)
                self._tel_event(FD_RANK,
                                "frontdoor/eject", id=r["id"],
                                reason=action["reason"])
            else:
                r["ejected"] = False
                self.health_actions["readmit"] += 1
                self._tel_event(FD_RANK,
                                "frontdoor/readmit", id=r["id"])
            self._routable = None
            self._log(action["action"], rank=r["id"],
                      reason=action["reason"])
        # 4. fleet sample + SLO verdicts + incident edge detection.
        sample = self._sample()
        self.samples.append(sample)
        verdicts = (slo.evaluate(self.sc["slos"], list(self.samples))
                    if self.sc["slos"] else [])
        sample["verdicts"] = verdicts
        self._alert(verdicts, sample)
        # 5. autoscale ladder.
        self._autoscale(sample)
        # 6. canary rollout verdict.
        self._rollout_tick()
        # 7. goodput epoch boundary.
        gp_every = max(1, int(float(self.sc["goodput_window_s"])
                              / self.interval))
        if self.cycle % gp_every == 0:
            self._gp_boundary()
        self._log("tick", cycle=self.cycle,
                  world=len(self._alive_ranks()),
                  queued=sum(len(r["queue"])
                             for r in self.replicas.values()),
                  pending=self.pending_total,
                  shed=self.c["fd_shed"], answered=self.c["answered"])

    def _requeue_queued(self, r: Dict[str, Any]) -> None:
        queued = list(r["queue"])
        r["queue"].clear()
        n = len(queued)
        self.pending[r["id"]] -= n
        self.pending_total -= n
        for req, _ in queued:
            self.c["requeued"] += 1
            self._push(self.t, "arrival", req)

    def _sample(self) -> Dict[str, Any]:
        from .. import fleet
        alive = self._alive_ranks()
        merged = {
            "counters": {
                "dpt_serve_requests_total": float(sum(
                    r["requests_total"]
                    for r in self.replicas.values())),
                "dpt_serve_errors_total": float(sum(
                    r["errors_total"] for r in self.replicas.values())),
                "dpt_serve_shed_total": 0.0,
                "dpt_frontdoor_requests_total": float(
                    self.c["arrivals"]),
                controller.FD_SHED_COUNTER: float(self.c["fd_shed"]),
            },
            "gauges": {controller.QUEUE_GAUGE: float(sum(
                len(r["queue"]) for r in self.replicas.values()
                if r["alive"]))},
            "histograms": {self.lat_hist.name: self.lat_hist},
        }
        targets = {str(rank): {
            "port": _PORT_BASE + rank,
            "counters": {
                "dpt_serve_requests_total": float(
                    self.replicas[rank]["requests_total"]),
                "dpt_serve_errors_total": float(
                    self.replicas[rank]["errors_total"]),
            },
            "health": {"status": "ok",
                       "last_step_age_s": round(
                           self.replicas[rank]["last_step_age_s"], 3)},
        } for rank in alive}
        return fleet.build_fleet_sample(
            ts=self.ts(), mono=self.t, cycle=self.cycle, alive=alive,
            merged=merged, targets=targets)

    def _alert(self, verdicts: List[Dict[str, Any]],
               sample: Dict[str, Any]) -> None:
        from .. import fleet
        for v in verdicts:
            name = v["name"]
            if not v["firing"]:
                self._slo_firing.discard(name)
                continue
            if name in self._slo_firing:
                continue  # one bundle per episode, same as fleet.py
            self._slo_firing.add(name)
            spec = next(s for s in self.sc["slos"] if s["name"] == name)
            bundle = fleet.build_incident(
                name=name, spec=spec, verdict=v, cycle=self.cycle,
                ts=sample["ts"], alive=sample["alive"],
                suspect_ranks=self._suspects(spec),
                offending_requests=self._offenders(v),
                healthz={rank: doc.get("health")
                         for rank, doc in sample["targets"].items()})
            self.incidents.append((name, bundle))
            self._tel_event(FD_RANK, "fleet/incident",
                            slo=name, cycle=self.cycle)
            self._log("incident", slo=name, cycle=self.cycle,
                      suspects=bundle["suspect_ranks"])

    def _suspects(self, spec: Dict[str, Any]) -> List[int]:
        """fleet._suspects, over the simulator's sample window: per-
        target bad-counter movement inside the widest window."""
        samples = list(self.samples)
        if spec.get("kind") != "ratio" or len(samples) < 2:
            return sorted(int(r) for s in samples
                          for r in s.get("targets", {}))
        seconds = max(float(w["seconds"]) for w in spec["windows"])
        base, latest = slo._window(samples, seconds)
        key = spec["bad"]
        out = []
        for rank, doc in latest.get("targets", {}).items():
            end = float(doc.get("counters", {}).get(key, 0.0))
            start = float(base.get("targets", {}).get(rank, {})
                          .get("counters", {}).get(key, 0.0))
            if end - start > 0:
                out.append(int(rank))
        return sorted(out)

    def _offenders(self, verdict: Dict[str, Any]) -> List[str]:
        samples = list(self.samples)
        if len(samples) < 2:
            return []
        seconds = max(float(w["seconds"]) for w in verdict["windows"])
        base, latest = slo._window(samples, seconds)
        lo = float(base["ts"]) - self.interval
        hi = float(latest["ts"]) + self.interval
        return [rid for ts, rid in self.bad_trace if lo <= ts <= hi]

    def _autoscale(self, sample: Dict[str, Any]) -> None:
        decision = controller.decide_scale(self.scale_cfg,
                                           self.scale_state,
                                           list(self.samples))
        if decision["action"] == "none":
            return
        self.scale_state["last_action_t"] = float(sample["t"])
        self.scale_actions.append((self.t, decision["action"]))
        self._tel_event(FD_RANK,
                        f"controller/scale_{decision['action']}",
                        reason=decision["reason"],
                        world=decision["world"],
                        target=decision["target"])
        self._log("scale", action=decision["action"],
                  world=decision["world"], target=decision["target"],
                  reason=decision["reason"])
        if decision["action"] == "up":
            self._push(self.t + float(self.sc["provision_delay_s"]),
                       "claim_join", {"origin": "scale"})
        else:
            victim = controller.pick_retire(self._snapshot_ids(),
                                            protected=self.canary_ids)
            if victim is not None:
                r = self.replicas[victim]
                r["draining"] = True
                self._routable = None
                self._log("drain", rank=victim)
                if not r["busy"] and not r["queue"]:
                    self._retire(r)

    # -- rollout -------------------------------------------------------

    def _start_rollout(self) -> None:
        ids = self._snapshot_ids()
        self.canary_ids = ro.choose_canaries(
            ids, float(self.rollout_cfg.get(
                "fraction", ro.ROLLOUT_DEFAULTS["fraction"])))
        if not self.canary_ids:
            self._log("rollout_skip", reason="fewer than 2 routable")
            return
        for rank in self.canary_ids:
            self.replicas[rank]["version"] = "canary"
        self.ro_state = {"since_t": self.t}
        self.ro_group = {
            "canary": {"requests": 0, "errors": 0,
                       "hist": telemetry.Histogram("sim/canary_ms")},
            "stable": {"requests": 0, "errors": 0,
                       "hist": telemetry.Histogram("sim/stable_ms")}}
        self._tel_event(FD_RANK, "rollout/start",
                        canaries=list(self.canary_ids))
        self._log("rollout_start", canaries=list(self.canary_ids))

    def _rollout_tick(self) -> None:
        if self.ro_state is None:
            return

        def group(name: str) -> Dict[str, Any]:
            g = self.ro_group[name]
            s = g["hist"].summary() if g["hist"].count else {}
            return {"requests": g["requests"], "errors": g["errors"],
                    "p95_ms": s.get("p95")}

        obs = {"t": self.t,
               "canary_alive": any(
                   r["alive"] and not r["ejected"]
                   for r in self.replicas.values()
                   if r["id"] in self.canary_ids),
               "canary": group("canary"), "stable": group("stable")}
        verdict = ro.decide_rollout(self.rollout_cfg, self.ro_state, obs)
        if verdict["action"] == "continue":
            return
        self.rollout_outcome = verdict["action"]
        for r in self.replicas.values():
            r["version"] = "stable"
        self._tel_event(FD_RANK,
                        f"rollout/{verdict['action']}",
                        reason=verdict["reason"])
        self._log(f"rollout_{verdict['action']}",
                  reason=verdict["reason"])
        self.canary_ids = []
        self.ro_state = None

    # -- goodput -------------------------------------------------------

    def _gp_boundary(self) -> None:
        self._gp_epoch += 1
        window = float(self.sc["goodput_window_s"])
        for rank, r in sorted(self.replicas.items()):
            delta = r["busy_s"] - self._gp_last.get(rank, 0.0)
            self._gp_last[rank] = r["busy_s"]
            self.gp_rows.setdefault(rank, []).append(
                {"epoch": self._gp_epoch, "t_end": self.t,
                 "wall_s": window, "compute_s": delta})

    # -- main loop -----------------------------------------------------

    def run(self) -> Dict[str, Any]:
        sc = self.sc
        for _ in range(int(sc["replicas"])):
            self._new_replica(origin="seed")
        self._tel_event(FD_RANK, "sim/frontdoor_start",
                        scenario=sc["name"], seed=self.seed,
                        replicas=int(sc["replicas"]))
        rid = 0
        for at in traffic.generate(self.rng_traffic, sc["traffic"],
                                   self.duration):
            rid += 1
            self._push(at, "arrival",
                       {"rid": rid, "t0": at, "attempts": 0})
        for f in scmod.timed_faults(sc, self.seed):
            self._push(f["t"], "fault", f)
        n_ticks = int(self.duration / self.interval)
        for k in range(1, n_ticks + 1):
            self._push(k * self.interval, "tick", None)
        if self.rollout_cfg:
            self._push(float(self.rollout_cfg["at_s"]), "ckpt", None)

        handlers = {"arrival": self._arrive, "dispatch": self._dispatch,
                    "done": self._done, "fault": self._fault,
                    "claim_join":
                        lambda p: self._claim_join(p["origin"]),
                    "tick": lambda p: self._tick(),
                    "ckpt": lambda p: self._start_rollout()}
        while self._heap and self._heap[0][0] <= self.duration:
            self.t, _, kind, payload = heapq.heappop(self._heap)
            handlers[kind](payload)
        self.t = self.duration
        return self.report()

    # -- report --------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        directions = [a for _, a in self.scale_actions]
        changes = sum(1 for a, b in zip(directions, directions[1:])
                      if a != b)
        rejoin_admits = {k: v for k, v in self.join_admits.items()
                        if k.startswith("rejoin:")}
        shed_window = (0.0 if self.first_shed_t is None
                       else self.last_shed_t - self.first_shed_t)
        return {
            "kind": "sim_report", "scenario": self.sc["name"],
            "seed": self.seed, "replicas_start": int(self.sc["replicas"]),
            "replicas_end": len(self._alive_ranks()),
            "duration_s": self.duration,
            "requests": dict(self.c),
            "in_flight_at_end": self.pending_total,
            "scale": {"actions": len(self.scale_actions),
                      "ups": directions.count("up"),
                      "downs": directions.count("down"),
                      "direction_changes": changes},
            "health": dict(self.health_actions),
            "elastic": {
                "claims": len(self.join_claims),
                "admits": sum(self.join_admits.values()),
                "rejoin_admits": sum(rejoin_admits.values()),
                "max_rejoin_admits_per_replica": max(
                    rejoin_admits.values(), default=0),
                "generation": self.generation},
            "rollout_outcome": self.rollout_outcome,
            "incidents": [name for name, _ in self.incidents],
            "shed_window_s": round(shed_window, 6),
            "trace_records": len(self.traces),
            "event_log_lines": len(self.events),
        }
