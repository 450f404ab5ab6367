"""Logging and signal handling for the port's entry points.

Counterpart of ``distributedpytorch_tpu/utils.py`` (``initialize_logging``
and ``GracefulShutdown``); the JAX PRNG helpers have no counterpart here.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading


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


class GracefulShutdown:
    """SIGTERM/SIGINT set ``requested``; the serving loop checks it between
    batches and stops cleanly.  A second signal restores the previous
    handler and re-raises.  No-op outside the main thread."""

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
        from . import telemetry

        telemetry.get().event("preempt_signal", signum=int(signum))
        logging.warning(f"received signal {signum}: stopping after the "
                        "current batch (repeat to abort immediately)")

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False
