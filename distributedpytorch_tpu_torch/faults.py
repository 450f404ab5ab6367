"""Fault-injection site hooks and the retry policy.

Counterpart of ``distributedpytorch_tpu/faults.py``, cut to what the
serving path, the checkpoint and dataset readers and the telemetry
writer call: ``fire`` at the JAX package's site names (data.read,
ckpt.restore, telemetry.write, serve.request, serve.admit, serve.infer)
and ``retry`` around transient I/O.  Fault plans are not ported yet
(``--fault-plan`` is refused in config.py), so every site is a no-op
hook that keeps the sites in place for a later slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import random
import time
from typing import Callable, Optional, Tuple, TypeVar

from . import telemetry

T = TypeVar("T")


def fire(site: str, path: Optional[str] = None) -> None:
    """Injection site hook; a no-op while no fault plan can be installed."""
    del site, path


TRANSIENT = (OSError, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with deterministic jittered exponential backoff; no
    new attempt starts ``timeout_s`` after the first one."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    timeout_s: float = 60.0
    seed: int = 0

    def _delay(self, site: str, attempt: int) -> float:
        backoff = min(self.max_delay_s,
                      self.base_delay_s * (2.0 ** (attempt - 1)))
        h = hashlib.sha256(f"{self.seed}:{site}:{attempt}".encode()).digest()
        rng = random.Random(int.from_bytes(h[:8], "big"))
        return backoff * (0.5 + 0.5 * rng.random())

    def call(self, fn: Callable[[], T], site: str,
             transient: Tuple[type, ...] = TRANSIENT) -> T:
        tel = telemetry.get()
        deadline = time.monotonic() + self.timeout_s
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except transient as e:
                out_of_time = time.monotonic() >= deadline
                if attempt >= self.max_attempts or out_of_time:
                    tel.counter("retry/giveups").add(1)
                    tel.event("retry_giveup", site=site, attempts=attempt,
                              error=str(e), timed_out=out_of_time)
                    logging.error(f"{site}: giving up after {attempt} "
                                  f"attempt(s): {e}")
                    raise
                delay = self._delay(site, attempt)
                tel.counter("retry/attempts").add(1)
                tel.event("retry", site=site, attempt=attempt,
                          delay_s=delay, error=str(e))
                logging.warning(f"{site}: transient failure (attempt "
                                f"{attempt}/{self.max_attempts}), retrying "
                                f"in {delay:.3f}s: {e}")
                time.sleep(delay)


def retry(fn: Callable[[], T], site: str,
          transient: Tuple[type, ...] = TRANSIENT) -> T:
    """Run ``fn`` under the default retry policy."""
    return RetryPolicy().call(fn, site, transient)
