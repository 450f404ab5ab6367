"""Deterministic fault injection and the retry/backoff policy.

Counterpart of ``distributedpytorch_tpu/faults.py``, whole: the same
plans, kinds, sites, error classes and retry schedule, so a plan written
for the JAX package fires on the same hits here.  Two halves:

**Fault plans.**  A seeded, deterministic plan of faults to inject at
named sites threaded through the port.  Sites wired:

  data.read        data/io.py load_raw dispatch (dataset fetch)
  data.host_batch  data/pipeline.py ShardedLoader's per-step host gather
  ckpt.save        checkpoint.py serialize+write
  ckpt.finalize    checkpoint.py post-rename hook (receives the final
                   path — the only site where kind=torn applies)
  ckpt.restore     checkpoint.py read
  runtime.init     runtime.py torch.distributed.init_process_group
  elastic.reinit   elastic.py shrunken-world re-initialization
  elastic.join     elastic.py join-claim write (grow rendezvous entry;
                   receives the claim path — torn/rank_join apply)
  elastic.grow_reinit  elastic.py grown-world re-initialization (both
                   the joiner's connect and the survivors' grow reinit)
  telemetry.write  telemetry.py JSONL writer
  serve.request    serving/server.py per-request handler entry (an
                   injected ioerror answers that request with a 500)
  serve.admit      serving/server.py queue admission (shed-path tests)
  serve.infer      serving/server.py per-micro-batch dispatch — ioerror
                   fails one batch and the tier keeps serving

Plan forms (``--fault-plan``):

  DSL string   "site:kind:after_n[:count[:stall_s]]" — ';'-separated for
               multiple specs; fires on the (after_n+1)-th ..
               (after_n+count)-th hit of the site (count defaults to 1;
               stall_s only applies to kind=stall).
  JSON file    path to {"seed": S, "faults": [{"site": ..., "kind": ...,
               "after_n": N, "count": C, "rank": R, "path_match": "sub",
               "stall_s": T}, ...]} — rank restricts a spec to one
               process, path_match to fire() calls whose path contains
               the substring.

Kinds: ``ioerror`` (raise InjectedIOError — an OSError, i.e. transient
under the default retry classification), ``fatal`` (raise
FatalFaultError — never retried; drives the multi-rank failure
agreement), ``preempt`` (SIGTERM to self — deterministic mid-run
preemption), ``torn`` (truncate the file at the ``path`` the site
passed — a torn write discovered at the next load; only meaningful at
ckpt.finalize), ``stall`` (sleep ``stall_s`` seconds at the site and
carry on — a deterministic straggler), ``rank_loss`` (``os._exit(113)``
— the process vanishes mid-collective with no cleanup: the shape of a
preempted or OOM-killed host its peers must detect and survive), and
``rank_join`` (drop a DUPLICATE of the join claim at ``path``; only
meaningful at elastic.join, where the rendezvous dedupes claims by
claimant identity, not filename).

Every firing emits a ``fault_injected`` telemetry event and a flight-
recorder event, so chaos runs are auditable from the JSONL alone.
Zero-cost when disabled: with no plan installed ``fire()`` is one global
load and a None check, and the streaming loader wraps its per-step host
work only when ``targets("data.host_batch")`` is true at epoch setup.

**RetryPolicy.**  Bounded retries with exponential backoff and
deterministic jitter (seeded per site, so a fixed plan seed reproduces
the exact schedule), transient-vs-fatal classification, and a per-site
wall-clock deadline that bounds RETRYING, not the call itself.  Wrapped
around dataset reads, checkpoint write/restore, the process group's
init and the elastic re-inits.  ``retry/attempts`` counts extra
attempts, ``retry/giveups`` exhausted policies.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import random
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

from . import flightrec, goodput, telemetry

T = TypeVar("T")

KINDS = ("ioerror", "fatal", "preempt", "torn", "stall", "rank_loss",
         "rank_join")

SITES = ("data.read", "data.host_batch", "ckpt.save", "ckpt.finalize",
         "ckpt.restore", "runtime.init", "elastic.reinit",
         "elastic.join", "elastic.grow_reinit", "telemetry.write",
         "serve.request", "serve.infer", "serve.admit", "sim.step")
# "sim.step" belongs to the fleet simulator (sim/), which reads it under
# its virtual clock; fire() never targets it in a live process.

# Exit code of a rank killed by kind=rank_loss: distinguishable in the
# harness from a crash (1), a fatal-agreement exit (CHILD_EXIT) and a
# SIGTERM death, so the chaos gate can assert the RIGHT rank vanished.
RANK_LOSS_EXIT = 113


class InjectedIOError(OSError):
    """A transient injected failure (kind=ioerror): an OSError, so the
    default retry classification treats it exactly like a real flaky
    read/write."""


class FatalFaultError(RuntimeError):
    """A non-transient injected failure (kind=fatal): never retried;
    the rank that hits it must fail loudly and notify its peers."""


class PeerFailureError(RuntimeError):
    """Raised on HEALTHY ranks after the failure-agreement all-reduce
    reports that some other rank hit a fatal error: every rank leaves
    the training loop at the same boundary instead of hanging in the
    dead rank's next collective."""


class HealthTimeoutError(RuntimeError):
    """The bounded health agreement (--health-timeout) did not complete
    in time: a peer is gone (or wedged) and never reached the boundary
    collective.  The local rank converts the hang it WOULD have suffered
    into this verdict — under --elastic the trigger for reconfiguring
    into the surviving world, otherwise a loud exit instead of a
    deadlock.  Lives here (not elastic.py) so runtime.py can raise it
    without an import cycle."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fires on hits (after_n, after_n+count] of
    ``site``, optionally restricted to one rank / a path substring."""

    site: str
    kind: str
    after_n: int = 0
    count: int = 1
    rank: Optional[int] = None
    path_match: Optional[str] = None
    stall_s: float = 0.25  # kind=stall only: injected sleep seconds

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {', '.join(SITES)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {', '.join(KINDS)})")
        if self.after_n < 0 or self.count < 1:
            raise ValueError(
                f"fault {self.site}:{self.kind}: after_n must be >= 0 "
                f"and count >= 1 (got {self.after_n}, {self.count})")
        if self.stall_s <= 0:
            raise ValueError(
                f"fault {self.site}:{self.kind}: stall_s must be > 0 "
                f"(got {self.stall_s})")


class FaultPlan:
    """An installed set of FaultSpecs plus per-site hit counters.

    Hit counting is per (site, path_match-bucket)-free: one counter per
    site, shared by all specs targeting it, incremented on every
    ``fire(site)`` call that any spec targets — deterministic for a
    fixed plan because the framework's call sequence is deterministic.
    Thread-safe: producer threads and the training loop share the
    counters.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._sites = frozenset(s.site for s in self.specs)
        self._hits: Dict[str, int] = {}
        # REENTRANT on purpose: fire() is called from telemetry's write
        # path, which the GracefulShutdown signal handler re-enters on
        # the very thread that may already be inside fire() — a plain
        # Lock self-deadlocks there.
        self._lock = threading.RLock()

    def targets(self, site: str) -> bool:
        return site in self._sites

    def _current_rank(self) -> int:
        """This process's rank in the live process group (0 without
        one), read at each match: the rank changes across an elastic
        reconfigure."""
        from . import runtime

        return runtime.process_index()

    def fire(self, site: str, path: Optional[str] = None) -> None:
        """Count a hit of ``site`` and act on any spec that matches.

        Raises for ioerror/fatal kinds; preempt signals self; torn
        truncates the file at ``path`` and returns (the site carries on
        — the damage is discovered at the next load, like a real torn
        write).
        """
        if site not in self._sites:
            return
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
        for spec in self.specs:
            if spec.site != site:
                continue
            if not (spec.after_n < hit <= spec.after_n + spec.count):
                continue
            if spec.rank is not None \
                    and spec.rank != self._current_rank():
                continue
            if spec.path_match is not None \
                    and (path is None or spec.path_match not in path):
                continue
            self._act(spec, hit, path)

    def _act(self, spec: FaultSpec, hit: int,
             path: Optional[str]) -> None:
        tel = telemetry.get()
        tel.event("fault_injected", site=spec.site, kind=spec.kind,
                  hit=hit, **({"path": path} if path else {}))
        # "fault_kind", not "kind": flightrec reserves "kind" for its
        # record schema ("event"/"step")
        flightrec.get().record_event("fault_injected", site=spec.site,
                                     fault_kind=spec.kind, hit=hit)
        logging.warning(f"FAULT INJECTED at {spec.site} "
                        f"(kind={spec.kind}, hit #{hit}"
                        + (f", path={path}" if path else "") + ")")
        if spec.kind == "stall":
            # A deterministic straggler: the site just goes slow.  The
            # anomaly detector must notice on its own — nothing else
            # about the step changes.
            time.sleep(spec.stall_s)
            return
        if spec.kind == "ioerror":
            raise InjectedIOError(
                f"injected transient I/O error at {spec.site} "
                f"(hit #{hit})")
        if spec.kind == "fatal":
            raise FatalFaultError(
                f"injected fatal fault at {spec.site} (hit #{hit})")
        if spec.kind == "preempt":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if spec.kind == "rank_loss":
            # Vanish NOW: no atexit, no SIGTERM handler, no cleanup —
            # peers find out when their next collective to us fails.
            # Only the fault_injected line above is flushed first so
            # the injection itself stays auditable from the JSONL.
            try:
                tel.flush()
            except Exception:  # broad: the point is to die regardless
                pass
            os._exit(RANK_LOSS_EXIT)
        if spec.kind == "torn":
            _tear(path)
            return
        if spec.kind == "rank_join":
            _duplicate_claim(path)


def _duplicate_claim(path: Optional[str]) -> None:
    """Simulate a joiner whose claim write was retried across a
    partition and left TWO files behind: copy the claim at ``path`` to
    a sibling ``*-dup.json`` and let the site carry on.  The grow
    rendezvous must dedupe by the claimant id inside the claim, so the
    duplicate admits exactly one rank, not two."""
    if path is None or not os.path.exists(path):
        logging.warning(f"rank_join fault: no claim to duplicate at "
                        f"{path!r}")
        return
    dup = (path[:-len(".json")] if path.endswith(".json") else path) \
        + "-dup.json"
    with open(path, "rb") as src, open(dup, "wb") as dst:
        dst.write(src.read())


def _tear(path: Optional[str]) -> None:
    """Simulate a torn write: truncate the file at ``path`` to half its
    size (a directory gets ONE of its payload files torn), then
    let the site carry on — the corruption is only discovered when the
    checkpoint is next read and its checksum verified."""
    if path is None or not os.path.exists(path):
        logging.warning(f"torn fault: nothing to tear at {path!r}")
        return
    target = path
    if os.path.isdir(path):
        candidates = sorted(
            os.path.join(dirpath, fn)
            for dirpath, _, fns in os.walk(path) for fn in fns
            if fn != "meta.json" and os.path.getsize(
                os.path.join(dirpath, fn)) > 1)
        if not candidates:
            logging.warning(f"torn fault: no payload files under {path!r}")
            return
        target = candidates[0]
    size = os.path.getsize(target)
    with open(target, "r+b") as f:
        f.truncate(max(1, size // 2))
    logging.warning(f"torn fault: truncated {target!r} "
                    f"{size} -> {max(1, size // 2)} bytes")


# -- plan parsing ------------------------------------------------------


def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """``--fault-plan`` argument -> FaultPlan.

    A path to an existing ``.json`` file (or any existing file) is the
    JSON form; anything else is the inline DSL.
    """
    if text.endswith(".json") or os.path.exists(text):
        try:
            with open(text) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"cannot read fault plan file {text!r}: {e}") from e
        if not isinstance(doc, dict) or not isinstance(
                doc.get("faults"), list):
            raise ValueError(
                f"fault plan file {text!r} must be a JSON object with a "
                "'faults' list (and an optional 'seed')")
        specs = []
        for i, entry in enumerate(doc["faults"]):
            if not isinstance(entry, dict):
                raise ValueError(
                    f"fault plan file {text!r}: faults[{i}] is not an "
                    "object")
            unknown = set(entry) - {"site", "kind", "after_n", "count",
                                    "rank", "path_match", "stall_s"}
            if unknown:
                raise ValueError(
                    f"fault plan file {text!r}: faults[{i}] has unknown "
                    f"key(s) {sorted(unknown)}")
            specs.append(FaultSpec(**entry))
        return FaultPlan(specs, seed=int(doc.get("seed", seed)))
    specs = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (3, 4, 5):
            raise ValueError(
                f"bad fault spec {part!r}: expected "
                "'site:kind:after_n[:count[:stall_s]]'")
        try:
            after_n = int(fields[2])
            count = int(fields[3]) if len(fields) >= 4 else 1
            stall_s = float(fields[4]) if len(fields) == 5 else 0.25
        except ValueError as e:
            raise ValueError(
                f"bad fault spec {part!r}: after_n/count must be "
                "integers (and stall_s a float)") from e
        specs.append(FaultSpec(site=fields[0], kind=fields[1],
                               after_n=after_n, count=count,
                               stall_s=stall_s))
    if not specs:
        raise ValueError(f"empty fault plan {text!r}")
    return FaultPlan(specs, seed=seed)


# -- module-level installation (zero-cost when absent) -----------------

_plan: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process's fault plan."""
    global _plan
    _plan = plan


def installed() -> Optional[FaultPlan]:
    return _plan


def targets(site: str) -> bool:
    """True when the installed plan has a spec for ``site`` — hot paths
    check this ONCE at setup and skip all fault plumbing otherwise."""
    return _plan is not None and _plan.targets(site)


def fire(site: str, path: Optional[str] = None) -> None:
    """Injection point: no-op (one None check) without a plan."""
    plan = _plan
    if plan is not None:
        plan.fire(site, path)


# -- retry policy ------------------------------------------------------

# Transient by default: OS-level I/O errors and timeouts (includes
# InjectedIOError and ConnectionError, both OSError subclasses).
TRANSIENT = (OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with deterministic jittered exponential backoff.

    ``timeout_s`` is a per-call-site retry deadline: once the first
    attempt started more than ``timeout_s`` ago, no further attempt is
    made (the in-flight attempt itself is never interrupted).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    timeout_s: float = 60.0
    seed: int = 0

    def _delay(self, site: str, attempt: int) -> float:
        backoff = min(self.max_delay_s,
                      self.base_delay_s * (2.0 ** (attempt - 1)))
        # Deterministic per (seed, site, attempt): a fixed plan seed
        # reproduces the exact retry schedule on every run.
        h = hashlib.sha256(
            f"{self.seed}:{site}:{attempt}".encode()).digest()
        rng = random.Random(int.from_bytes(h[:8], "big"))
        return backoff * (0.5 + 0.5 * rng.random())

    def call(self, fn: Callable[[], T], site: str,
             transient: Tuple[type, ...] = TRANSIENT) -> T:
        """Run ``fn`` under this policy.  Exceptions outside
        ``transient`` (FatalFaultError in particular) propagate
        immediately, attempt 1 included."""
        tel = telemetry.get()
        deadline = time.monotonic() + self.timeout_s
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except FatalFaultError:
                raise
            except transient as e:
                out_of_time = time.monotonic() >= deadline
                if attempt >= self.max_attempts or out_of_time:
                    tel.counter("retry/giveups").add(1)
                    tel.event("retry_giveup", site=site, attempts=attempt,
                              error=str(e), timed_out=out_of_time)
                    flightrec.get().record_event("retry_giveup",
                                                 site=site,
                                                 attempts=attempt)
                    logging.error(
                        f"{site}: giving up after {attempt} attempt(s)"
                        + (" (retry deadline exceeded)" if out_of_time
                           else "") + f": {e}")
                    raise
                delay = self._delay(site, attempt)
                tel.counter("retry/attempts").add(1)
                tel.event("retry", site=site, attempt=attempt,
                          delay_s=delay, error=str(e))
                flightrec.get().record_event("retry", site=site,
                                             attempt=attempt)
                logging.warning(
                    f"{site}: transient failure (attempt {attempt}/"
                    f"{self.max_attempts}), retrying in {delay:.3f}s: {e}")
                # The backoff sleep is goodput retry_backoff — attributed
                # here, at the one place every retry sleeps, so ledger
                # windows that enclose a retried call (ckpt_blocking,
                # data_wait) shrink by it instead of double-counting.
                with goodput.get().timed("retry_backoff"):
                    time.sleep(delay)


_default_policy = RetryPolicy()


def configure(fault_plan: Optional[str] = None, fault_seed: int = 0,
              retry_max_attempts: int = 3,
              retry_base_delay_s: float = 0.05,
              retry_timeout_s: float = 60.0) -> None:
    """Install the process's fault plan + default retry policy from the
    run Config (the entry points call this once, before the process
    group's init, so the runtime.init site is live).  ``fault_plan=None``
    clears any plan — re-invocation safe, same convention as
    telemetry.configure."""
    global _default_policy
    install(parse_plan(fault_plan, seed=fault_seed)
            if fault_plan else None)
    _default_policy = RetryPolicy(max_attempts=retry_max_attempts,
                                  base_delay_s=retry_base_delay_s,
                                  timeout_s=retry_timeout_s,
                                  seed=fault_seed)


def policy() -> RetryPolicy:
    """The process's default retry policy (library call sites use this
    so they never see the Config)."""
    return _default_policy


def retry(fn: Callable[[], T], site: str,
          transient: Tuple[type, ...] = TRANSIENT) -> T:
    """``policy().call`` shorthand for library call sites."""
    return _default_policy.call(fn, site, transient)
