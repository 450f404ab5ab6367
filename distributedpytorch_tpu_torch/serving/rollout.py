"""Zero-downtime checkpoint rollout: canary, verdict, automatic
rollback.

A copy of ``distributedpytorch_tpu/serving/rollout.py`` (stdlib only),
kept in the port so that the port imports nothing of the JAX package; it
reads the ledger the port's ``checkpoint.py`` writes.

The train->checkpoint->serve loop closes here: when the checkpoint
lineage ledger (checkpoint.py's ``ckpt-lineage.json``) grows a newer
head than the sha the replicas report serving (their ``/healthz``
lineage block), the rollout manager hot-swaps a CANARY FRACTION of the
fleet onto it via each replica's ``/admin/reload`` (server.py's swap
seam: the replica lineage-verifies and rebuilds), then compares canary
vs stable error-rate and p95 over the same window and either promotes
the rest of the fleet or rolls the canaries back — no process ever
restarts, no listener ever closes.

Split of responsibilities:

  pure core   ``decide_rollout`` (the verdict state machine) and
              ``choose_canaries`` are clock-free functions of (config,
              state, observation) in the ``slo.evaluate`` style — the
              observation carries its own ``t``, the module never
              imports ``time``, and a rejected sha is remembered so a
              bad checkpoint cannot canary-loop forever.
  ledger      ``newest_lineage_entry`` / ``verify_sha`` read the
              lineage ledger directly (JSON + sha256), so the module
              stays framework-free — checkpoint.py, which WRITES the
              ledger, imports torch.
  manager     ``RolloutManager`` is the impure shell the front door
              ticks: it learns the stable sha from the replicas'
              healthz lineage, snapshots per-upstream counters at
              canary start (so the verdict sees deltas, not lifetime
              totals), executes reloads through an injected
              ``reload_fn``, and emits every transition as a
              ``rollout/*`` telemetry event for the ``timeline`` reader.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

#: ledger filename, mirrored from checkpoint.py (which owns writes).
LINEAGE_FILE = "ckpt-lineage.json"
DIR_META = "meta.json"  # a checkpoint directory's metadata

ROLLOUT_DEFAULTS: Dict[str, Any] = {
    "fraction": 0.34,          # canary share of the routable fleet
    "hold_s": 5.0,             # healthy canary soak before promotion
    "min_requests": 20,        # verdict needs at least this much signal
    "max_error_ratio": 0.05,   # absolute canary error budget
    "error_ratio_factor": 3.0,  # ...or this multiple of stable's ratio
    "p95_factor": 3.0,         # canary p95 regression multiple
    "p95_floor_ms": 50.0,      # ignore p95 noise below this
    "timeout_s": 120.0,        # canary that never gathers signal dies
}


def _cfg(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    out = dict(ROLLOUT_DEFAULTS)
    out.update(cfg or {})
    return out


# -- pure core ---------------------------------------------------------

def choose_canaries(ids: Sequence[int], fraction: float) -> List[int]:
    """Deterministic canary pick: the first ``floor(fraction * N)`` of
    the sorted routable ids, at least one, never the whole fleet (a
    1-replica fleet cannot canary — there would be no stable side to
    compare against)."""
    pool = sorted(set(int(i) for i in ids))
    if len(pool) < 2:
        return []
    n = max(1, int(math.floor(float(fraction) * len(pool))))
    n = min(n, len(pool) - 1)
    return pool[:n]


def decide_rollout(cfg: Optional[Dict[str, Any]],
                   state: Dict[str, Any],
                   obs: Dict[str, Any]) -> Dict[str, Any]:
    """Pure canary verdict.  ``state`` holds ``since_t`` (sample-clock
    time the canary started); ``obs`` is the window since then:

      {"t": <sample clock>, "canary_alive": bool,
       "canary": {"requests": n, "errors": n, "p95_ms": x|None},
       "stable": {"requests": n, "errors": n, "p95_ms": x|None}}

    Returns ``{"action": "continue"|"promote"|"rollback", "reason"}``.
    Rollback triggers: a dead canary, an error ratio over both the
    absolute budget and ``error_ratio_factor`` x stable's ratio, a p95
    regression past ``p95_factor`` x stable (above the noise floor), or
    a canary that cannot gather ``min_requests`` inside ``timeout_s``.
    Promotion requires the full ``hold_s`` soak WITH enough signal and
    no regression."""
    c = _cfg(cfg)
    t = float(obs["t"])
    since = float(state["since_t"])
    can = obs.get("canary", {})
    stab = obs.get("stable", {})
    creq = int(can.get("requests", 0))
    cerr = int(can.get("errors", 0))
    sreq = int(stab.get("requests", 0))
    serr = int(stab.get("errors", 0))

    if not obs.get("canary_alive", True):
        return {"action": "rollback",
                "reason": "canary replica died or was ejected"}

    if creq >= int(c["min_requests"]):
        cratio = cerr / creq
        sratio = (serr / sreq) if sreq else 0.0
        if cratio > float(c["max_error_ratio"]) \
                and cratio > sratio * float(c["error_ratio_factor"]):
            return {"action": "rollback",
                    "reason": f"canary error ratio {cratio:.3f} vs "
                              f"stable {sratio:.3f} (budget "
                              f"{c['max_error_ratio']:g})"}
        cp95, sp95 = can.get("p95_ms"), stab.get("p95_ms")
        if cp95 is not None and sp95 is not None \
                and float(cp95) > float(c["p95_floor_ms"]) \
                and float(cp95) > float(sp95) * float(c["p95_factor"]):
            return {"action": "rollback",
                    "reason": f"canary p95 {float(cp95):.1f}ms vs "
                              f"stable {float(sp95):.1f}ms (factor "
                              f"{c['p95_factor']:g})"}
        if t - since >= float(c["hold_s"]):
            return {"action": "promote",
                    "reason": f"healthy for {t - since:.1f}s over "
                              f"{creq} canary requests (error ratio "
                              f"{cratio:.3f})"}
    elif t - since >= float(c["timeout_s"]):
        return {"action": "rollback",
                "reason": f"only {creq} canary requests in "
                          f"{t - since:.0f}s (< min_requests "
                          f"{c['min_requests']})"}

    return {"action": "continue",
            "reason": f"soaking ({creq} canary requests, "
                      f"{t - since:.1f}s of {c['hold_s']:g}s)"}


# -- lineage ledger readers (framework-free by construction) -----------

def newest_lineage_entry(watch_dir: str) -> Optional[Dict[str, Any]]:
    """The newest verifiable checkpoint the ledger names: highest
    epoch, ties broken by ledger order (later write wins).  A checkpoint
    file or a checkpoint directory (``--ckpt-format orbax``, its ledger
    sha the structural checksum of its meta.json) qualifies — the
    rollout reload path hands a replica's ``/admin/reload`` a path.
    None when there is no ledger or no live entry."""
    path = os.path.join(watch_dir, LINEAGE_FILE)
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    records = doc.get("records") if isinstance(doc, dict) else None
    best: Optional[Dict[str, Any]] = None
    for rec in records or []:
        if not isinstance(rec, dict) or not rec.get("sha256"):
            continue
        fpath = os.path.join(watch_dir, str(rec.get("file", "")))
        if not (os.path.isfile(fpath) or os.path.isfile(
                os.path.join(fpath, DIR_META))):
            continue
        if best is None or int(rec.get("epoch", -1)) \
                >= int(best.get("epoch", -1)):
            best = dict(rec, path=fpath)
    return best


def verify_sha(path: str, sha256: str) -> bool:
    """Content check before a canary reload: the file still hashes to
    what the ledger recorded, a directory's payload still sums to its
    structural checksum (a torn or half-rotated checkpoint must never
    reach a serving replica)."""
    if os.path.isdir(path):
        return dir_checksum(path) == str(sha256)
    try:
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return False
    return got == str(sha256)


def dir_checksum(root: str) -> str:
    """A checkpoint directory's structural checksum, as the port's
    checkpoint.py records it: sha256 over the sorted relpath:size
    listing of every payload file, meta.json excluded."""
    entries = []
    for dirpath, _, fnames in os.walk(root):
        for fn in fnames:
            if dirpath == root and fn == DIR_META:
                continue
            full = os.path.join(dirpath, fn)
            entries.append(f"{os.path.relpath(full, root)}:"
                           f"{os.path.getsize(full)}")
    h = hashlib.sha256()
    for line in sorted(entries):
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


# -- the impure shell --------------------------------------------------

class RolloutManager:
    """Drives stable -> canary -> promote/rollback over live replicas.

    Ticked by the front door's control loop with the sample-clock time,
    the replica snapshots, and the ledger head; everything external is
    injected (``reload_fn(replica_id, path) -> bool`` and
    ``event_fn(name, **attrs)``), so tests drive the whole state
    machine with stubs and no sockets."""

    def __init__(self, cfg: Optional[Dict[str, Any]],
                 reload_fn: Callable[[int, str], bool],
                 event_fn: Callable[..., None]):
        self.cfg = _cfg(cfg)
        self._reload = reload_fn
        self._event = event_fn
        self.phase = "stable"
        self.stable_sha: Optional[str] = None
        self.stable_path: Optional[str] = None
        self.candidate: Optional[Dict[str, Any]] = None
        self.canary_ids: List[int] = []
        self.since_t = 0.0
        self._baseline: Dict[int, Dict[str, float]] = {}
        self.rejected: set = set()      # shas that already rolled back
        self._verified: set = set()     # shas content-checked this run
        self.rollbacks = 0
        self.promotions = 0

    # -- helpers -------------------------------------------------------

    def _learn_stable(self, replicas: List[Dict[str, Any]]) -> None:
        """The stable lineage is whatever the (majority of the) fleet
        reports serving — learned, not configured, so the manager can
        attach to a running tier."""
        counts: Dict[str, int] = {}
        paths: Dict[str, str] = {}
        for rep in replicas:
            lin = rep.get("lineage") or {}
            sha = lin.get("sha256")
            if not sha:
                continue
            counts[sha] = counts.get(sha, 0) + 1
            if lin.get("path"):
                paths[sha] = lin["path"]
        if counts:
            sha = max(counts, key=lambda s: counts[s])
            self.stable_sha = sha
            self.stable_path = paths.get(sha, self.stable_path)

    def _stats(self, replicas: List[Dict[str, Any]], ids: List[int]
               ) -> Dict[str, Any]:
        """Windowed (since canary start) request/error totals + worst
        p95 across the given replica ids."""
        req = err = 0
        p95: Optional[float] = None
        for rep in replicas:
            if rep["id"] not in ids:
                continue
            base = self._baseline.get(rep["id"], {})
            req += max(0, int(rep.get("requests", 0))
                       - int(base.get("requests", 0)))
            err += max(0, int(rep.get("errors", 0))
                       - int(base.get("errors", 0)))
            if rep.get("p95_ms") is not None:
                p95 = max(p95 or 0.0, float(rep["p95_ms"]))
        return {"requests": req, "errors": err, "p95_ms": p95}

    def _reload_set(self, ids: List[int], path: str) -> List[int]:
        return [i for i in ids if self._reload(i, path)]

    # -- the tick ------------------------------------------------------

    def tick(self, t: float, replicas: List[Dict[str, Any]],
             head: Optional[Dict[str, Any]]) -> None:
        """One control cycle.  ``replicas``: the front door's snapshots
        (id, alive/ejected/draining flags, lineage block, cumulative
        requests/errors, windowed p95_ms).  ``head``: the newest ledger
        entry (``newest_lineage_entry``), or None."""
        if self.phase == "stable":
            self._learn_stable([r for r in replicas
                                if r.get("alive")
                                and not r.get("ejected")])
            self._maybe_start(t, replicas, head)
            return
        self._judge(t, replicas)

    def _maybe_start(self, t: float, replicas: List[Dict[str, Any]],
                     head: Optional[Dict[str, Any]]) -> None:
        if head is None or self.stable_sha is None:
            return
        sha = str(head["sha256"])
        if sha == self.stable_sha or sha in self.rejected:
            return
        if sha not in self._verified:
            if not verify_sha(head["path"], sha):
                self.rejected.add(sha)
                self._event("rollout/candidate_rejected", sha=sha[:12],
                            path=head["path"],
                            reason="lineage checksum mismatch")
                return
            self._verified.add(sha)
        routable = [r["id"] for r in replicas
                    if r.get("alive") and not r.get("ejected")
                    and not r.get("draining")]
        ids = choose_canaries(routable, self.cfg["fraction"])
        if not ids:
            return  # < 2 routable replicas: no stable side to compare
        loaded = self._reload_set(ids, head["path"])
        if not loaded:
            self.rejected.add(sha)
            self._event("rollout/candidate_rejected", sha=sha[:12],
                        path=head["path"],
                        reason="canary reload failed on every replica")
            return
        self.phase = "canary"
        self.candidate = dict(head)
        self.canary_ids = loaded
        self.since_t = t
        self._baseline = {r["id"]: {"requests": int(r.get("requests", 0)),
                                    "errors": int(r.get("errors", 0))}
                          for r in replicas}
        logging.info(f"rollout: canary {sha[:12]} started on replicas "
                     f"{loaded} (stable {self.stable_sha[:12]})")
        self._event("rollout/canary_start", sha=sha[:12],
                    stable=self.stable_sha[:12], replicas=loaded,
                    epoch=head.get("epoch"))

    def _judge(self, t: float, replicas: List[Dict[str, Any]]) -> None:
        live = {r["id"] for r in replicas
                if r.get("alive") and not r.get("ejected")}
        stable_ids = [r["id"] for r in replicas
                      if r["id"] not in self.canary_ids
                      and r["id"] in live]
        obs = {
            "t": t,
            "canary_alive": any(i in live for i in self.canary_ids),
            "canary": self._stats(replicas, self.canary_ids),
            "stable": self._stats(replicas, stable_ids),
        }
        verdict = decide_rollout(self.cfg, {"since_t": self.since_t},
                                 obs)
        if verdict["action"] == "continue":
            return
        sha = str(self.candidate["sha256"]) if self.candidate else "?"
        if verdict["action"] == "promote":
            promoted = self._reload_set(stable_ids,
                                        self.candidate["path"])
            self.stable_sha = sha
            self.stable_path = self.candidate["path"]
            self.promotions += 1
            logging.info(f"rollout: promoted {sha[:12]} "
                         f"({verdict['reason']})")
            self._event("rollout/promote", sha=sha[:12],
                        replicas=promoted, reason=verdict["reason"])
        else:
            rolled = (self._reload_set(self.canary_ids,
                                       self.stable_path)
                      if self.stable_path else [])
            self.rejected.add(sha)
            self.rollbacks += 1
            logging.warning(f"rollout: ROLLED BACK {sha[:12]} "
                            f"({verdict['reason']})")
            self._event("rollout/rollback", sha=sha[:12],
                        replicas=rolled, reason=verdict["reason"])
        self.phase = "stable"
        self.candidate = None
        self.canary_ids = []
        self._baseline = {}
