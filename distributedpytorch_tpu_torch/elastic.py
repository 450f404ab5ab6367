"""Elastic worlds: survive the loss of a rank, and grow when one joins.

Counterpart of ``distributedpytorch_tpu/elastic.py`` (:117-937).  The
failure machinery (``runtime.agree_health``) agrees on a failure at an
epoch boundary; under ``--elastic`` the same verdict becomes a
reconfiguration: the surviving ranks tear their process group down,
re-elect a coordinator among themselves, join a smaller world and resume
from the newest lineage-verified checkpoint.  Rank loss costs the work
since the last checkpoint, not the job.

What the JAX module needs for its runtime does not carry over, and
PyTorch's idiom takes its place:

* No parked runtime client or service, and no socket sweep: the teardown
  is ``runtime.teardown_distributed`` (an NCCL communicator aborted
  first, then ``dist.destroy_process_group()``).  It runs BEFORE the
  rendezvous, for the JAX module's reason: destroying the group closes
  this process's gloo sockets, and that close is the only wake-up a peer
  still blocked in a collective on a live neighbour ever gets (in a
  3-rank ring the dead rank's neighbour errors at once, while the next
  rank's receive is posted on the neighbour and blocks until that
  neighbour leaves).  Destruction is by reference count, so the caller
  first drops everything that pins the old group: the DDP wrapper and
  its reducer, ``runtime.Mesh``'s groups, the loaders and the exception
  tracebacks (``cli.run_train``), and ``runtime`` imports
  ``torch.distributed.nn.functional`` before the first world, whose
  ``group=group.WORLD`` defaults would otherwise pin the group that was
  live when ``DistributedDataParallel`` first imported it.
* A generation's world is joined through a ``TCPStore``: the elected
  coordinator opens the store's server on a port the system picks and
  only then publishes its address in ``world.json``
  (``runtime.open_store``/``init_world``).  The store lives in the
  coordinator's process, and coordinator loss stays a clean error, as in
  the JAX package: a shrink whose settled claims lack rank 0 fails on
  every survivor.
* ``is_peer_loss`` knows torch's texts and types for a dead peer as well
  as the JAX markers: ``DistBackendError``, gloo's "Connection closed by
  peer", "Connection reset by peer" and "Read error" (the first two JAX
  markers already), and the store's "wait timeout" of a group's creation
  that a member never reached.
* No ``quiesce_exit``: the JAX exit barrier exists for a parked XLA
  service whose socket close is fatal to its peers; a departed
  ``TCPStore`` server fails no call of a peer that has finished its
  collectives, and a reconfigured process exits through the normal
  interpreter teardown.

Rendezvous between survivors cannot use the old collectives, so it runs
over the shared filesystem: each survivor writes a claim file under
``<elastic-dir>/gen-<g>/``, waits a settle window for its peers' claims,
and the lowest claimed old rank elects itself coordinator and publishes
``world.json`` (members, joiners, coordinator address, backend).
Followers take ``process_id = index of their old rank in the sorted
member list``.  A joining process (``--elastic-join``) drops a claim
under ``<elastic-dir>/joins/``; the running world scans it at each
health boundary, agrees to grow through the same all-gather, and the
coordinator answers it with ``admit-<id>.json`` (its new rank and the
world's address) or ``decline-<id>.json``.
"""

from __future__ import annotations

import gc
import json
import logging
import os
import socket
import time
from typing import List, Optional

import torch

from . import faults, runtime, telemetry

_generation = 0          # 0 = the original world (no reconfigure yet)
_reconfigured = False

# How long a claimant waits after the LAST new claim before treating the
# claim set as settled: it must dominate the skew between survivors'
# discoveries of a loss (a rank blocked on a live neighbour learns only
# when that neighbour tears down).  The exactly-one-loss fast path keeps
# the common case prompt.
SETTLE_S = 20.0
# How long a follower polls for world.json before giving up (coordinator
# candidate crashed during rendezvous / coordinator loss).
WORLD_WAIT_S = 60.0
# Overall cap on one rendezvous round (claims + settle + publish).
RENDEZVOUS_DEADLINE_S = 120.0
# How long a joiner waits for an admit/decline marker after dropping its
# claim; `--elastic-join-wait` overrides it per run.
JOIN_WAIT_S = 600.0

# Texts of a dead peer: the JAX package's markers, torch's gloo ones and
# the store's "wait timeout" of a group whose member never arrived.
PEER_LOSS_MARKERS = (
    "Gloo ", "Connection closed by peer", "Connection reset",
    "Socket closed", "connection refused", "Broken pipe",
    "peer is unavailable", "Read error", "wait timeout")


class WorldChangedError(RuntimeError):
    """Control flow, not a failure: a member was lost, or a joiner was
    admitted, and this healthy ``--elastic`` rank reconfigures instead of
    exiting.  ``grow`` tells the two apart."""

    def __init__(self, msg: str, grow: bool = False):
        super().__init__(msg)
        self.grow = grow


class JoinDeclinedError(RuntimeError):
    """The coordinator answered this join claim with a decline marker."""


def generation() -> int:
    """0 before any reconfigure, then 1, 2, ... per shrink or grow."""
    return _generation


def reconfigured() -> bool:
    """True once this process has joined a reconfigured world (shrunken,
    grown, or joined mid-run)."""
    return _reconfigured


def is_peer_loss(err: Optional[BaseException]) -> bool:
    """Classify an exception (or one in its cause chain) as "a peer
    vanished mid-collective": a timed-out or failed health agreement, a
    ``DistBackendError``, or a text of the JAX markers or torch's gloo
    errors for a closed or reset connection; inside a
    ``torch.distributed.checkpoint`` ``CheckpointException`` (a
    checkpoint directory's save), any rank's failure that is one."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, (faults.HealthTimeoutError,
                            faults.PeerFailureError)):
            return True
        failures = getattr(err, "failures", None)
        if isinstance(failures, dict) and any(
                is_peer_loss(f[0] if isinstance(f, tuple) else f)
                for f in failures.values()):
            return True
        backend_error = getattr(torch.distributed, "DistBackendError", None)
        if backend_error is not None and isinstance(err, backend_error):
            return True
        text = str(err).lower()
        if any(m.lower() in text for m in PEER_LOSS_MARKERS):
            return True
        err = err.__cause__ or err.__context__
    return False


# -- filesystem rendezvous --------------------------------------------


def default_elastic_dir(rsl_path: str) -> str:
    """``--elastic-dir`` default: inside the run directory, which the
    checkpoints already require to be shared."""
    return os.path.join(rsl_path, "elastic")


def _gen_dir(elastic_dir: str, gen: int) -> str:
    return os.path.join(elastic_dir, f"gen-{gen}")


def _joins_dir(elastic_dir: str) -> str:
    return os.path.join(elastic_dir, "joins")


def _write_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _claimed_ranks(gen_dir: str) -> List[int]:
    try:
        names = os.listdir(gen_dir)
    except OSError:
        return []
    ranks = []
    for name in names:
        if name.startswith("rank-") and name.endswith(".json"):
            try:
                ranks.append(int(name[len("rank-"):-len(".json")]))
            except ValueError:
                continue
    return sorted(ranks)


# -- join claims + admission policy (the grow half) -------------------


def request_join(elastic_dir: str) -> str:
    """Drop this process's join claim ``joins/join-<host>-<pid>.json``
    and return its id; the write runs under the retry policy at fault
    site ``elastic.join`` (fired after the write, so torn and rank_join
    faults act on the claim file itself)."""
    joins = _joins_dir(elastic_dir)
    os.makedirs(joins, exist_ok=True)
    host = socket.gethostname() or "host"
    jid = f"{host}-{os.getpid()}"
    path = os.path.join(joins, f"join-{jid}.json")

    def _claim():
        _write_json(path, {"id": jid, "host": host, "pid": os.getpid()})
        faults.fire("elastic.join", path=path)

    faults.retry(_claim, "elastic.join", transient=(OSError,))
    logging.warning(f"ELASTIC: join claim {jid} dropped in {joins}")
    return jid


def pending_joins(elastic_dir: str) -> List[str]:
    """Join-claim ids not yet answered by an admit/decline marker,
    deduplicated by the id inside the claim (a retried write may leave
    two files); an unreadable claim is skipped loudly."""
    joins = _joins_dir(elastic_dir)
    try:
        names = os.listdir(joins)
    except OSError:
        return []
    ids = set()
    for name in sorted(names):
        if not (name.startswith("join-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(joins, name)) as f:
                ids.add(str(json.load(f)["id"]))
        except (OSError, ValueError, KeyError):
            logging.warning(
                f"ELASTIC: skipping unreadable join claim {name} "
                "(torn write? the claimant's retry rewrites it)")
    return [jid for jid in sorted(ids)
            if not os.path.exists(os.path.join(joins,
                                               f"admit-{jid}.json"))
            and not os.path.exists(os.path.join(joins,
                                                f"decline-{jid}.json"))]


def evaluate_join_policy(live_world: int, join_ids: List[str],
                         target: str, min_world: int):
    """The autoscaling decision, as a pure function so every rank and
    every test computes the same verdict from the same inputs.

    ``target`` is ``capacity`` (admit every claim — scale to whatever
    shows up) or ``fixed:N`` (admit only up to a world of N).  A batch
    whose admission would still leave the world below ``min_world`` is
    declined whole: a reconfigure window is not worth paying for a
    world that stays under the floor.  Returns ``(admit, declined)``
    where ``declined`` is ``[(id, reason), ...]``; both orderings are
    deterministic (sorted ids), so coordinator-assigned new ranks are
    reproducible."""
    ids = sorted(join_ids)
    declined = []
    if target == "capacity":
        admit = ids
    elif target.startswith("fixed:"):
        try:
            cap = int(target[len("fixed:"):])
        except ValueError:
            raise ValueError(
                f"--elastic-target {target!r}: expected 'capacity' or "
                "'fixed:<N>'")
        if cap < 1:
            raise ValueError(f"--elastic-target {target!r}: N must be "
                             ">= 1")
        room = max(0, cap - live_world)
        admit = ids[:room]
        declined = [(jid, f"world already at fixed target {cap} "
                          f"(live {live_world})") for jid in ids[room:]]
    else:
        raise ValueError(
            f"--elastic-target {target!r}: expected 'capacity' or "
            "'fixed:<N>'")
    if admit and live_world + len(admit) < min_world:
        declined += [(jid, f"grown world {live_world + len(admit)} "
                           f"would stay below --elastic-min-world "
                           f"{min_world}") for jid in admit]
        admit = []
    return admit, declined


def scan_joins(elastic_dir: str, live_world: int, target: str,
               min_world: int):
    """Health-boundary poll: pending claims put through the admission
    policy.  Returns ``(admit, declined)`` like evaluate_join_policy."""
    return evaluate_join_policy(live_world, pending_joins(elastic_dir),
                                target, min_world)


def decline_joins(elastic_dir: str, declined, gen: int) -> None:
    """Answer declined claims with marker files (idempotent), written by
    the main rank or the coordinator only."""
    joins = _joins_dir(elastic_dir)
    os.makedirs(joins, exist_ok=True)
    for jid, reason in declined:
        path = os.path.join(joins, f"decline-{jid}.json")
        if os.path.exists(path):
            continue
        _write_json(path, {"id": jid, "reason": reason,
                           "generation": gen})
        logging.warning(f"ELASTIC: declined join {jid}: {reason}")


def wait_for_admission(elastic_dir: str, jid: str,
                       timeout_s: Optional[float] = None) -> dict:
    """Joiner side: poll for the coordinator's verdict on my claim.
    Returns the admit doc; raises JoinDeclinedError on a decline marker,
    TimeoutError (after an ``elastic/join_wait_timeout`` event) when no
    verdict lands in time."""
    joins = _joins_dir(elastic_dir)
    wait_s = JOIN_WAIT_S if timeout_s is None else timeout_s
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        for name, is_decline in ((f"admit-{jid}.json", False),
                                 (f"decline-{jid}.json", True)):
            path = os.path.join(joins, name)
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace read; retry
            if is_decline:
                raise JoinDeclinedError(
                    f"elastic join {jid} declined: "
                    f"{doc.get('reason', 'unspecified')}")
            return doc
        time.sleep(0.2)
    telemetry.get().event("elastic/join_wait_timeout", jid=jid,
                          wait_s=wait_s, elastic_dir=elastic_dir)
    raise TimeoutError(
        f"elastic join {jid}: no admit/decline marker within "
        f"{wait_s:.0f}s — is an --elastic run reaching health "
        f"boundaries on {elastic_dir}?")


def join_world(elastic_dir: str, device: torch.device,
               timeout_s: Optional[float] = None) -> dict:
    """A joining process's whole entry: claim, wait for the verdict,
    join the published world at the rank the admit marker names (under
    the retry policy at fault site ``elastic.grow_reinit``).  Returns
    ``{"generation", "members", "joiners", "coordinator", "new_rank",
    "new_world"}``."""
    global _generation, _reconfigured
    jid = request_join(elastic_dir)
    doc = wait_for_admission(elastic_dir, jid, timeout_s)
    gen = int(doc["generation"])
    new_rank = int(doc["new_rank"])
    new_world = int(doc["new_world"])
    logging.warning(
        f"ELASTIC: join {jid} admitted into generation {gen} as rank "
        f"{new_rank} of {new_world} (coordinator {doc['coordinator']})")

    def _reinit():
        faults.fire("elastic.grow_reinit")
        runtime.init_world(doc["coordinator"], new_world, new_rank,
                           doc["backend"], device)

    faults.retry(_reinit, "elastic.grow_reinit",
                 transient=(OSError, TimeoutError, RuntimeError))
    _generation = gen
    _reconfigured = True
    return {"generation": gen, "members": sorted(doc.get("members", [])),
            "joiners": list(doc.get("joiners", [])),
            "coordinator": doc["coordinator"], "new_rank": new_rank,
            "new_world": new_world}


def _rendezvous(elastic_dir: str, gen: int, old_rank: int,
                old_world: int, backend: str, grow: bool = False,
                target: str = "capacity", min_world: int = 1):
    """One claim/elect/publish round (JAX ``_rendezvous``).  Returns
    ``(world doc, store)``: the doc is ``{"generation", "members",
    "joiners", "coordinator", "backend"}``, and ``store`` is the
    coordinator's ``TCPStore`` server (None on a follower).

    Every survivor writes its claim and waits for the claim set to settle
    (no new claim for SETTLE_S, or every expected claim in).  The lowest
    claimed old rank opens the store, publishes world.json and, on a
    grow, answers each admitted joiner; the others poll for world.json
    and check that they are members.  A grow differs: the full old world
    claims, completion also needs a pending join claim, and the
    coordinator re-runs the admission policy, authoritatively."""
    gen_dir = _gen_dir(elastic_dir, gen)
    os.makedirs(gen_dir, exist_ok=True)
    _write_json(os.path.join(gen_dir, f"rank-{old_rank}.json"),
                {"old_rank": old_rank, "pid": os.getpid()})
    world_path = os.path.join(gen_dir, "world.json")

    deadline = time.monotonic() + RENDEZVOUS_DEADLINE_S
    members = [old_rank]
    last_change = time.monotonic()
    while time.monotonic() < deadline:
        if os.path.exists(world_path):
            break  # someone already elected and published
        now_claimed = _claimed_ranks(gen_dir)
        if now_claimed != members:
            members = now_claimed
            last_change = time.monotonic()
        complete = len(members) == (old_world if grow
                                    else old_world - 1)
        if grow:
            complete = complete and bool(pending_joins(elastic_dir))
        settled = complete \
            or (time.monotonic() - last_change) >= SETTLE_S
        if settled and not grow and 0 not in members:
            raise RuntimeError(
                f"elastic rendezvous: rank 0 of generation {gen - 1}, the "
                "coordinator whose process holds its world's store, was "
                f"lost (claims {members}) — not survivable; exiting")
        if settled and members and members[0] == old_rank:
            if len(members) >= old_world and not grow:
                raise RuntimeError(
                    "elastic rendezvous: every rank of the old world "
                    f"claimed generation {gen} ({members}) — nothing "
                    "actually died; refusing to reconfigure")
            joiners: List[str] = []
            if grow:
                joiners, declined = evaluate_join_policy(
                    len(members), pending_joins(elastic_dir), target,
                    min_world)
                decline_joins(elastic_dir, declined, gen)
            new_world = len(members) + len(joiners)
            store, host = runtime.open_store(new_world)
            address = f"{host}:{store.port}"
            doc = {"generation": gen, "members": members,
                   "joiners": joiners, "coordinator": address,
                   "backend": backend}
            _write_json(world_path, doc)
            for i, jid in enumerate(joiners):
                _write_json(
                    os.path.join(_joins_dir(elastic_dir),
                                 f"admit-{jid}.json"),
                    {"id": jid, "generation": gen,
                     "new_rank": len(members) + i, "new_world": new_world,
                     "coordinator": address, "backend": backend,
                     "members": members, "joiners": joiners})
            return doc, store
        time.sleep(0.2)

    waited = time.monotonic()
    while time.monotonic() - waited < WORLD_WAIT_S:
        if os.path.exists(world_path):
            try:
                with open(world_path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                doc = None  # mid-replace read; retry
            if doc is not None and doc.get("generation") == gen:
                if old_rank not in doc.get("members", []):
                    raise RuntimeError(
                        f"elastic rendezvous: rank {old_rank} missed "
                        f"generation {gen} (members {doc.get('members')})"
                        " — claimed after the settle window; exiting "
                        "rather than wedging the new world")
                return doc, None
        time.sleep(0.2)
    raise RuntimeError(
        f"elastic rendezvous: no world.json for generation {gen} within "
        f"{WORLD_WAIT_S}s — coordinator candidate lost?")


def reconfigure(elastic_dir: str, old_rank: int, old_world: int,
                device: torch.device, grow: bool = False,
                target: str = "capacity", min_world: int = 1,
                purpose: str = "train") -> dict:
    """Tear down the current world and join the reconfigured one —
    shrunken after a peer loss, or grown (``grow=True``) after the health
    boundary agreed to admit join claims.

    Returns ``{"generation", "members", "joiners", "coordinator",
    "new_rank", "new_world", "purpose"}``.  The join of the new world
    runs under the retry policy at fault site ``elastic.reinit``
    (``elastic.grow_reinit`` when growing).  A failed round raises
    ``faults.PeerFailureError`` (after logging the cause): this process
    leaves the job, loudly."""
    global _generation, _reconfigured
    gen = _generation + 1
    backend = (torch.distributed.get_backend() if runtime.distributed()
               else runtime.backend_for(device))
    logging.warning(
        f"ELASTIC: rank {old_rank} reconfiguring "
        f"({'grow' if grow else 'shrink'}, {purpose}) from world size "
        f"{old_world} (generation {gen})")
    try:
        gc.collect()    # what still pins the old group's sockets
        runtime.teardown_distributed()
        doc, store = _rendezvous(elastic_dir, gen, old_rank, old_world,
                                 backend, grow=grow, target=target,
                                 min_world=min_world)
        members = sorted(doc["members"])
        joiners = list(doc.get("joiners", []))
        new_rank = members.index(old_rank)
        new_world = len(members) + len(joiners)
        site = "elastic.grow_reinit" if grow else "elastic.reinit"

        def _reinit():
            faults.fire(site)
            runtime.init_world(doc["coordinator"], new_world, new_rank,
                               doc["backend"], device, store=store)

        faults.retry(_reinit, site,
                     transient=(OSError, TimeoutError, RuntimeError))
    except Exception as e:
        logging.error(f"ELASTIC: rank {old_rank} failed to join "
                      f"generation {gen}; exiting", exc_info=True)
        raise faults.PeerFailureError(
            f"elastic reconfigure to generation {gen} failed: {e}") from e
    _generation = gen
    _reconfigured = True
    logging.warning(
        f"ELASTIC: generation {gen} up — old rank {old_rank} is now "
        f"rank {new_rank} of {new_world} "
        f"({len(joiners)} joined; coordinator {doc['coordinator']})")
    return {"generation": gen, "members": members, "joiners": joiners,
            "coordinator": doc["coordinator"], "new_rank": new_rank,
            "new_world": new_world, "purpose": purpose}


def _reset_for_tests() -> None:
    """Test hook: forget generations."""
    global _generation, _reconfigured
    _generation = 0
    _reconfigured = False
