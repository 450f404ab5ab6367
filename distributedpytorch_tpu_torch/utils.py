"""Logging, signal handling, durations and seeded generators for the
port's entry points.

Counterpart of ``distributedpytorch_tpu/utils.py`` (``initialize_logging``,
``GracefulShutdown``, ``get_duration`` at :121-126, ``epoch_numpy_rng`` at
:152-160).  The JAX package's per-step PRNG keys (``fold_key``) become
``step_generator``: a ``torch.Generator`` on the run's device seeded from
(seed, epoch, step), so a resumed run draws exactly what an uninterrupted
one draws.  The draws themselves differ from JAX's (Philox, not threefry).
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from typing import Tuple

import numpy as np
import torch


def initialize_logging(rsl_path: str, log_file: str,
                       truncate: bool = True) -> None:
    """File + stdout logging; re-invocation replaces earlier handlers."""
    os.makedirs(rsl_path, exist_ok=True)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    logging.basicConfig(
        level=logging.INFO,
        format="%(message)s",
        handlers=[
            logging.FileHandler(os.path.join(rsl_path, log_file),
                                mode="w" if truncate else "a"),
            logging.StreamHandler(sys.stdout),
        ],
    )


def quiet_logging() -> None:
    """A rank other than 0: warnings and errors to stdout, no log file."""
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    logging.basicConfig(level=logging.WARNING, format="%(message)s",
                        handlers=[logging.StreamHandler(sys.stdout)])


class GracefulShutdown:
    """SIGTERM/SIGINT set ``requested``; the training loop agrees on it at
    the next epoch (or chunk) boundary, after the rolling checkpoint, and
    stops every rank there; the serving loop checks it between batches.
    A second signal restores the previous handler and re-raises, so a
    hung step stays abortable.  No-op outside the main thread.  The JAX
    ``GracefulShutdown`` (utils.py:49-119), driven by the ``preempt``
    fault kind as by a real signal: the handler's audit writes go through
    the telemetry and flight-recorder sinks, whose locks are re-entrant
    (the handler may interrupt a frame holding them), and a failed write
    is logged, never raised into the interrupted frame."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def _handle(self, signum, frame):
        del frame
        if self.requested:
            logging.warning(f"second signal {signum}: aborting now")
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self.requested = True
        from . import flightrec, telemetry

        try:
            telemetry.get().event("preempt_signal", signum=int(signum))
            # the black box survives a grace window cut short
            rec = flightrec.get()
            rec.record_event("preempt_signal", signum=int(signum))
            rec.dump("preempt_signal")
        # broad on purpose: an exception escaping a signal handler is
        # raised into the interrupted frame
        except Exception:
            logging.exception("preempt handler: audit write failed")
        logging.warning(
            f"received signal {signum}: finishing the current epoch, "
            "then checkpointing and exiting (repeat to abort immediately)")

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def get_duration(start_time: float, end_time: float) -> Tuple[int, int]:
    """(minutes, seconds) split (ref: getDuration, utils.py:182-186)."""
    elapsed = end_time - start_time
    mins = int(elapsed / 60)
    secs = int(elapsed - mins * 60)
    return mins, secs


def epoch_numpy_rng(seed: int, epoch: int) -> np.random.Generator:
    """Host-side generator for the sampler permutation, seeded with
    seed + epoch as DistributedSampler's ``manual_seed(seed + epoch)``."""
    return np.random.default_rng(np.uint64(seed) + np.uint64(epoch))


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one train step's generator, a function of (seed,
    epoch, step) only."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)


def step_generator(seed: int, epoch: int, step: int,
                   device: torch.device | str) -> torch.Generator:
    """The augmentation generator of one train step: a ``torch.Generator``
    on ``device`` seeded with ``step_seed``.  (A captured step re-seeds
    one generator with ``step_seed`` before each replay: the same
    numbers.)"""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(step_seed(seed, epoch, step))
    return gen
