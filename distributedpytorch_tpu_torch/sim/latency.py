"""Latency / service-time model the simulator samples from.

A model is quantile sketches per named quantity — ``{"min", "p50",
"p90", "p95", "p99", "max"}`` in seconds — sampled by inverse-CDF
piecewise-linear interpolation against a SEEDED rng, so the draw
sequence is part of the deterministic replay.

Where the numbers come from: a model file (``sim --model``) in the JAX
package's format, whose ``scripts/extract_latency_model.py`` fits these
sketches from flightrec/goodput dumps and stamps the file with
provenance, so simulated results name their calibration source.  A
model file may define any subset of quantities; the sampler falls back
per-quantity to the built-in defaults below.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict

#: CDF points the sketch pins, in order.
QUANTILES = (("min", 0.0), ("p50", 0.5), ("p90", 0.9), ("p95", 0.95),
             ("p99", 0.99), ("max", 1.0))

#: Built-in calibration: a large-model serving tier where one batch
#: dispatch is seconds, not milliseconds — the regime where queueing,
#: shed and autoscale dynamics actually bite.  The JAX package's numbers,
#: unchanged: a modelling input, not a measurement of any device.
DEFAULT_MODEL: Dict[str, Any] = {
    "version": 1,
    "provenance": {"source": "built-in defaults (sim/latency.py)"},
    "quantities": {
        # Fixed cost of one inference dispatch, whatever the bucket.
        "infer_base_s": {"min": 1.5, "p50": 2.4, "p90": 3.2,
                         "p95": 3.6, "p99": 4.4, "max": 6.0},
        # Marginal cost per padded row in the bucket.
        "infer_per_row_s": {"min": 0.08, "p50": 0.14, "p90": 0.20,
                            "p95": 0.22, "p99": 0.30, "max": 0.40},
        # Response write-back after the infer span.
        "respond_s": {"min": 0.004, "p50": 0.010, "p90": 0.025,
                      "p95": 0.035, "p99": 0.060, "max": 0.120},
        # One training step (timeline realism for simulated trainers).
        "step_s": {"min": 1.8, "p50": 2.6, "p90": 3.4, "p95": 3.8,
                   "p99": 4.6, "max": 6.5},
    },
}


def validate_model(doc: Any, where: str = "latency model") -> Dict[str, Any]:
    """Check a model document's shape; returns it.  Every rejection is
    one actionable line — a malformed calibration file must read like a
    fix, not a trace."""
    if not isinstance(doc, dict) or not isinstance(doc.get("quantities"),
                                                   dict):
        raise ValueError(f"{where}: must be an object with a "
                         f"'quantities' map")
    for name, q in doc["quantities"].items():
        if not isinstance(q, dict):
            raise ValueError(f"{where}: quantity {name!r} must be an "
                             f"object of quantile values")
        last = None
        for key, _ in QUANTILES:
            v = q.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(
                    f"{where}: quantity {name!r} needs numeric "
                    f"{key!r} >= 0 (got {v!r})")
            if last is not None and v < last:
                raise ValueError(
                    f"{where}: quantity {name!r} quantiles must be "
                    f"non-decreasing ({key} {v} < previous {last})")
            last = v
    return doc


def load_model(path: str) -> Dict[str, Any]:
    """Read + validate a model file (extract_latency_model.py output);
    errors carry the path."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read latency model {path!r}: {e}")
    except ValueError as e:
        raise ValueError(f"latency model {path!r} is not valid JSON: "
                         f"{e}")
    return validate_model(doc, where=f"latency model {path!r}")


def sample(rng: random.Random, model: Dict[str, Any], name: str) -> float:
    """One draw of quantity ``name``: u ~ rng, inverse-CDF interpolated
    between the sketch's pinned quantiles.  Falls back to the built-in
    default when the model omits the quantity."""
    q = model.get("quantities", {}).get(name)
    if q is None:
        q = DEFAULT_MODEL["quantities"][name]
    u = rng.random()
    prev_key, prev_u = QUANTILES[0]
    for key, qu in QUANTILES[1:]:
        if u <= qu:
            lo, hi = float(q[prev_key]), float(q[key])
            frac = (u - prev_u) / (qu - prev_u)
            return lo + (hi - lo) * frac
        prev_key, prev_u = key, qu
    return float(q["max"])
