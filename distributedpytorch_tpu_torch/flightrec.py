"""Flight recorder + anomaly-triggered profiling.

Counterpart of ``distributedpytorch_tpu/flightrec.py``: the same
``FlightRecorder`` (a fixed-memory per-rank ring of per-step records and
point events, dumped to ``RSL_PATH/flightrec-rank<N>.json`` at a crash, a
peer failure, on demand and at the end of the run, in the JAX dump
schema, so the JAX package's ``load_dumps`` and timeline read it) and
``AnomalyDetector`` (a rolling median/MAD step-time window plus the
starvation and retry-burst triggers, with a bounded number of profiler
captures a run).  The recorder is on by default (``--no-flightrec``
turns it off): a dict append into a bounded deque per step.

A capture is a ``torch.profiler`` session (the JAX module starts and
stops ``jax.profiler`` traces, :152-215): started at the anomalous step,
stopped ``capture_steps`` steps later or at ``close()`` (in a
``finally``), its Chrome trace written as
``RSL_PATH/anomaly_traces/capture-<n>/rank<N>.trace.json`` beside a
``manifest.json`` that says why it fired; the ``roofline`` subcommand's
``--from-anomaly`` reads it.  The session records the CPU and, when a
card is present, the card's kernels.

Trigger semantics (the Config knobs of ``--anomaly-*``):

  step-time   window of the last W step times is full AND
              step_s > rel_factor * median AND
              step_s - median > max(mad_k * MAD, min_excess_s).
  starvation  the step's data-wait alone exceeds the same excess bound.
  retry-burst >= ``retry_burst`` retry/fault events landed since the
              last observed step.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import statistics
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from . import goodput, telemetry


def start_profiler():
    """A started ``torch.profiler`` session over the CPU and, when a card
    is present, its kernels (shapes recorded, for the roofline's FLOPs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True)
    prof.start()
    return prof


def stop_profiler(prof, trace_dir: str, rank: int = 0) -> str:
    """Stop ``prof`` (synchronizing the card first) and write its Chrome
    trace as ``trace_dir/rank<N>.trace.json``; returns the path."""
    import torch

    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"rank{rank}.trace.json")
    prof.export_chrome_trace(path)
    return path


class AnomalyDetector:
    """Rolling median/MAD step-time monitor that owns the bounded
    programmatic profiler captures.  One instance per run, driven from
    the streaming train loop via ``observe_step``; NOT thread-safe by
    design (only the main thread observes steps)."""

    def __init__(self, *, trace_dir: str, window: int = 32,
                 mad_k: float = 8.0, rel_factor: float = 3.0,
                 min_excess_s: float = 0.05, retry_burst: int = 3,
                 capture_steps: int = 4, max_captures: int = 2,
                 rank: int = 0):
        self.trace_dir = trace_dir
        self.rank = int(rank)
        self.window = max(int(window), 4)
        self.mad_k = float(mad_k)
        self.rel_factor = float(rel_factor)
        self.min_excess_s = float(min_excess_s)
        self.retry_burst = max(int(retry_burst), 1)
        self.capture_steps = max(int(capture_steps), 1)
        self.max_captures = int(max_captures)
        self._times: Deque[float] = collections.deque(maxlen=self.window)
        self._retries_since_step = 0
        self.anomalies = 0
        self.captures_started = 0
        self._capture_left = 0  # >0 while a trace capture is running
        self._prof = None       # the running capture's profiler session
        self._capture_dir: Optional[str] = None

    # -- trigger evaluation -------------------------------------------

    def note_retry(self) -> None:
        """Called (via the recorder) for every retry/fault event; feeds
        the retry-burst trigger."""
        self._retries_since_step += 1

    def _trigger(self, step_s: float, wait_s: Optional[float]
                 ) -> Optional[Dict[str, Any]]:
        retries = self._retries_since_step
        self._retries_since_step = 0
        if retries >= self.retry_burst:
            return {"trigger": "retry_burst", "retries": retries}
        if len(self._times) < self.window:
            # Window not yet full: the baseline isn't trustworthy (it
            # would include compile steps) — observe, don't judge.
            self._times.append(step_s)
            return None
        med = statistics.median(self._times)
        mad = statistics.median(abs(t - med) for t in self._times)
        excess = step_s - med
        bound = max(self.mad_k * mad, self.min_excess_s)
        evidence = {"median_s": med, "mad_s": mad, "step_s": step_s}
        self._times.append(step_s)
        if step_s > self.rel_factor * med and excess > bound:
            return {"trigger": "step_time", **evidence}
        if wait_s is not None and wait_s > bound \
                and wait_s > self.rel_factor * med:
            return {"trigger": "starvation", "wait_s": wait_s, **evidence}
        return None

    # -- capture state machine ----------------------------------------

    def observe_step(self, *, epoch: int, step: int, step_s: float,
                     wait_s: Optional[float] = None) -> Optional[str]:
        """Feed one completed step; returns the trigger name when this
        step was judged anomalous (the caller records/emits the event).
        Manages the start/stop of the bounded profiler captures."""
        if self._capture_left > 0:
            self._capture_left -= 1
            if self._capture_left == 0:
                self._stop_capture()
            # While capturing, keep feeding the window but don't re-judge:
            # the anomalous region itself must not retrain the baseline
            # into silence nor trigger overlapping captures.
            self._times.append(step_s)
            self._retries_since_step = 0
            return None
        verdict = self._trigger(step_s, wait_s)
        if verdict is None:
            return None
        self.anomalies += 1
        if self.captures_started < self.max_captures:
            self._start_capture(verdict, epoch=epoch, step=step)
        return str(verdict["trigger"])

    def _start_capture(self, verdict: Dict[str, Any], *, epoch: int,
                       step: int) -> None:
        path = os.path.join(self.trace_dir,
                            f"capture-{self.captures_started}")
        try:
            # The profiler's own start cost is goodput anomaly_capture
            # overhead — the capture is diagnosis, not training.
            with goodput.get().timed("anomaly_capture"):
                os.makedirs(path, exist_ok=True)
                self._prof = start_profiler()
        except Exception as e:  # profiling is advisory, never fatal
            self._prof = None
            logging.warning(f"flightrec: profiler start failed ({e}); "
                            f"anomaly recorded without a capture")
            return
        self._capture_dir = path
        self.captures_started += 1
        self._capture_left = self.capture_steps
        # A manifest beside the raw trace makes the capture
        # self-describing: `roofline --from-anomaly` reports WHY the
        # profiler fired next to the op-level blame.
        try:
            manifest = {"trigger": verdict, "epoch": epoch, "step": step,
                        "capture": self.captures_started - 1,
                        "capture_steps": self.capture_steps}
            tmp = os.path.join(path, "manifest.json.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f, indent=2, default=float)
            os.replace(tmp, os.path.join(path, "manifest.json"))
        except (OSError, TypeError, ValueError) as e:
            logging.warning(f"flightrec: capture manifest not written "
                            f"({e})")
        logging.info(f"flightrec: anomaly ({verdict['trigger']}) at "
                     f"epoch {epoch} step {step} — capturing next "
                     f"{self.capture_steps} step(s) to {path}")

    def _stop_capture(self) -> None:
        """End-of-budget stop for the normal K-step path: the session
        stops and its trace is written."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            # writing the trace is goodput anomaly_capture overhead, as
            # the start is
            with goodput.get().timed("anomaly_capture"):
                stop_profiler(prof, self._capture_dir, self.rank)
        except Exception as e:
            # advisory: a failed stop must not take the training loop
            # down with it
            logging.warning(f"flightrec: profiler stop failed ({e})")

    def close(self) -> None:
        """End-of-run cleanup: an in-flight capture is stopped in a
        ``finally``, so the profiler never runs past the detector."""
        if self._capture_left <= 0:
            return
        try:
            self._capture_left = 0
        finally:
            try:
                self._stop_capture()
            except Exception as e:
                # close() runs inside the entry point's finally — swallow
                # everything so cleanup cannot mask the real exception
                logging.warning(f"flightrec: close of the capture "
                                f"failed ({e})")


class FlightRecorder:
    """Fixed-memory ring buffer of step records + point events.

    Disabled instances (the default singleton) are no-ops on every
    method; enabled ones append bounded dicts — no file I/O until
    ``dump``.  Append/dump are locked: producer threads and the signal
    handler may record events concurrently with the main thread."""

    def __init__(self, enabled: bool = False, rsl_path: str = ".",
                 rank: int = 0, ring_size: int = 4096):
        self.enabled = enabled
        self.rank = rank
        self.ring_size = int(ring_size)
        self._path = os.path.join(rsl_path,
                                  f"flightrec-rank{rank}.json")
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max(self.ring_size, 16))
        # REENTRANT on purpose: the preempt signal handler
        # (utils.GracefulShutdown) fires record_event() + dump() on the
        # main thread and may interrupt a frame already inside this
        # lock (record_step, an anomaly capture) — a plain Lock
        # self-deadlocks the whole process there.
        self._lock = threading.RLock()
        self._dump_reasons: List[str] = []
        self.detector: Optional[AnomalyDetector] = None

    # -- recording ----------------------------------------------------

    def record_step(self, *, epoch: int, step: int, step_s: float,
                    dispatch_s: Optional[float] = None,
                    wait_s: Optional[float] = None,
                    queue_depth: Optional[int] = None,
                    category: Optional[str] = None) -> None:
        """One completed train step: total step wall time, the dispatch
        slice of it, the data-wait slice, the prefetch queue depth
        sampled after the fetch, and the step's dominant goodput
        category — so a crash/preempt dump shows where the rank was
        spending its time when it died, not just how long steps took."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"kind": "step", "epoch": epoch,
                               "step": step, "ts": time.time(),
                               "mono": time.monotonic(),
                               "step_s": step_s}
        if dispatch_s is not None:
            rec["dispatch_s"] = dispatch_s
        if wait_s is not None:
            rec["wait_s"] = wait_s
        if queue_depth is not None:
            rec["queue_depth"] = queue_depth
        if category is not None:
            rec["category"] = category
        with self._lock:
            self._ring.append(rec)

    def record_event(self, name: str, **attrs: Any) -> None:
        """Point event (retry, fault_injected, anomaly, preempt...).
        Retry-ish events additionally feed the detector's burst
        trigger."""
        if not self.enabled:
            return
        # attrs first, reserved fields last: a caller attr named "kind"
        # (e.g. a fault kind) must never clobber the record schema
        rec = {**attrs, "kind": "event", "name": name, "ts": time.time(),
               "mono": time.monotonic()}
        with self._lock:
            self._ring.append(rec)
        if name in ("retry", "fault_injected") and self.detector:
            self.detector.note_retry()

    # -- dumping ------------------------------------------------------

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring to ``flightrec-rank{N}.json`` (latest dump
        wins; ``reasons`` accumulates so a preempt dump followed by the
        end-of-run dump is visible).  Never raises: the recorder is
        called from signal handlers and ``finally`` blocks."""
        if not self.enabled:
            return None
        with self._lock:
            self._dump_reasons.append(reason)
            doc = {
                "rank": self.rank,
                "ring_size": self.ring_size,
                "reason": reason,
                "reasons": list(self._dump_reasons),
                # The dump's own paired stamp anchors the records' mono
                # values to this host's wall clock at dump time.
                "dumped_at": {"ts": time.time(), "mono": time.monotonic()},
                "records": list(self._ring),
            }
        try:
            tmp = self._path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, default=float)
            os.replace(tmp, self._path)  # never leave a torn dump
            return self._path
        except Exception as e:
            # dump() is called from signal handlers and finally blocks:
            # a full disk must degrade to a logged error, never raise
            logging.error(f"flightrec: cannot write {self._path!r} ({e})")
            return None

    def close(self, reason: str = "run_end") -> None:
        """Final dump + detector cleanup; idempotent (disables self)."""
        if not self.enabled:
            return
        if self.detector is not None:
            self.detector.close()
        self.dump(reason)
        self.enabled = False


_active = FlightRecorder(enabled=False)


def get() -> FlightRecorder:
    """The process's active flight recorder (disabled no-op by
    default)."""
    return _active


def configure(rsl_path: str, enabled: bool, rank: int = 0,
              ring_size: int = 4096) -> FlightRecorder:
    """Install the process's recorder (the entry points call this once, after
    runtime init so the rank is the global process index).  A previous
    enabled instance is closed first — re-invocation safe."""
    global _active
    if _active.enabled:
        _active.close("reconfigure")
    _active = FlightRecorder(enabled=enabled, rsl_path=rsl_path,
                             rank=rank, ring_size=ring_size)
    return _active


def attach_detector(rec: FlightRecorder, *, trace_dir: str,
                    **knobs: Any) -> Optional[AnomalyDetector]:
    """Create + attach the anomaly detector to an enabled recorder and
    return it (None on a disabled recorder — anomaly capture requires
    the flight recorder, since the captures are explained by its
    records)."""
    if not rec.enabled:
        return None
    rec.detector = AnomalyDetector(trace_dir=trace_dir, **knobs)
    return rec.detector


def observe_step(rec: FlightRecorder, *, epoch: int, step: int,
                 step_s: float, dispatch_s: Optional[float] = None,
                 wait_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 category: Optional[str] = None) -> None:
    """Hot-loop helper: record the step and, if a detector is attached,
    judge it — emitting the ``anomaly`` event on both sinks when it
    fires."""
    rec.record_step(epoch=epoch, step=step, step_s=step_s,
                    dispatch_s=dispatch_s, wait_s=wait_s,
                    queue_depth=queue_depth, category=category)
    det = rec.detector
    if det is None:
        return
    trigger = det.observe_step(epoch=epoch, step=step, step_s=step_s,
                               wait_s=wait_s)
    if trigger is not None:
        rec.record_event("anomaly", trigger=trigger, epoch=epoch,
                         step=step, step_s=step_s)
        telemetry.get().event("anomaly", trigger=trigger, epoch=epoch,
                              step=step, step_s=step_s,
                              captures=det.captures_started)


def load_dumps(rsl_path: str) -> Dict[int, Dict[str, Any]]:
    """All ``flightrec-rank*.json`` dumps under a run dir, keyed by rank.
    Unreadable/torn dumps are skipped (the timeline merger degrades to
    telemetry-only for that rank)."""
    out: Dict[int, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(rsl_path))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith("flightrec-rank")
                and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(rsl_path, fn), encoding="utf-8") as f:
                doc = json.load(f)
            out[int(doc["rank"])] = doc
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out
