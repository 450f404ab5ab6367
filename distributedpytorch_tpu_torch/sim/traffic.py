"""Traffic generators: seeded arrival-time sequences in virtual seconds.

Each generator is a pure function of (rng, spec, duration) returning a
sorted list of arrival times — non-homogeneous Poisson processes
realized by thinning against the spec's peak rate, so the diurnal ramp
and the burst are statistically honest, not staircases.  The shapes
mirror what a serving tier actually sees:

  constant     flat base-rate background (control scenarios),
  diurnal      sinusoidal ramp between base_rps and peak_rps — the load
               pattern that makes naive autoscalers flap,
  burst        base rate plus a rectangular surge window — the shape
               that cascades through the front door's pending budget,
  heavy_tail   Pareto interarrivals (bursty at every timescale) with
               the requested mean rate — the tail-risk generator.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List

KINDS = ("constant", "diurnal", "burst", "heavy_tail")


def _poisson(rng: random.Random, duration_s: float, peak_rps: float,
             rate_at) -> List[float]:
    """Thinning: candidate arrivals at ``peak_rps``, each kept with
    probability rate(t)/peak — an exact non-homogeneous Poisson
    realization as long as rate(t) <= peak everywhere."""
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak_rps)
        if t >= duration_s:
            return out
        if rng.random() <= rate_at(t) / peak_rps:
            out.append(t)


def constant(rng: random.Random, duration_s: float, rps: float
             ) -> List[float]:
    return _poisson(rng, duration_s, rps, lambda t: rps)


def diurnal(rng: random.Random, duration_s: float, base_rps: float,
            peak_rps: float, period_s: float) -> List[float]:
    mid = (base_rps + peak_rps) / 2.0
    amp = (peak_rps - base_rps) / 2.0

    def rate(t: float) -> float:
        return mid + amp * math.sin(2.0 * math.pi * t / period_s)

    return _poisson(rng, duration_s, peak_rps, rate)


def burst(rng: random.Random, duration_s: float, base_rps: float,
          burst_rps: float, burst_start_s: float, burst_len_s: float
          ) -> List[float]:
    def rate(t: float) -> float:
        if burst_start_s <= t < burst_start_s + burst_len_s:
            return burst_rps
        return base_rps

    return _poisson(rng, duration_s, max(base_rps, burst_rps), rate)


def heavy_tail(rng: random.Random, duration_s: float, rps: float,
               alpha: float = 1.5) -> List[float]:
    """Pareto(alpha) interarrivals scaled to mean 1/rps.  alpha must be
    > 1 (an infinite-mean process has no rate to scale to)."""
    if alpha <= 1.0:
        raise ValueError(f"heavy_tail: alpha must be > 1 (got {alpha})")
    # Pareto(alpha) with x_m=1 has mean alpha/(alpha-1); scale so the
    # interarrival mean is 1/rps.
    scale = (alpha - 1.0) / (alpha * rps)
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.paretovariate(alpha) * scale
        if t >= duration_s:
            return out
        out.append(t)


def generate(rng: random.Random, spec: Dict[str, Any],
             duration_s: float) -> List[float]:
    """Dispatch on ``spec["kind"]``; unknown kinds and missing params
    fail loudly at scenario load, not mid-replay."""
    kind = spec.get("kind")
    try:
        if kind == "constant":
            return constant(rng, duration_s, float(spec["rps"]))
        if kind == "diurnal":
            return diurnal(rng, duration_s, float(spec["base_rps"]),
                           float(spec["peak_rps"]),
                           float(spec["period_s"]))
        if kind == "burst":
            return burst(rng, duration_s, float(spec["base_rps"]),
                         float(spec["burst_rps"]),
                         float(spec["burst_start_s"]),
                         float(spec["burst_len_s"]))
        if kind == "heavy_tail":
            return heavy_tail(rng, duration_s, float(spec["rps"]),
                              float(spec.get("alpha", 1.5)))
    except KeyError as e:
        raise ValueError(
            f"traffic spec kind {kind!r} is missing parameter {e}")
    raise ValueError(
        f"traffic spec kind must be one of {list(KINDS)}, got {kind!r}")
