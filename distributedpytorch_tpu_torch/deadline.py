"""Deadline-bounded outbound HTTP — the one way the port talks to a
socket it does not own.

A copy of ``distributedpytorch_tpu/deadline.py`` (stdlib only), kept in
the port so that the port imports nothing of the JAX package.

Two failure shapes motivate the module:

  * a WEDGED peer (accepts the connection, never answers) must cost at
    most the per-call timeout, never an unbounded handler stall — so
    every helper here takes a mandatory ``timeout_s``;
  * a CYCLE of many calls (the fleet collector scraping N exporters,
    the front door probing N replicas) must finish inside its caller's
    period even when several peers wedge at once — ``Deadline`` is the
    spend-down budget threaded through such a cycle: each call gets
    ``min(its own timeout, what's left of the budget)``, and a spent
    budget turns the remaining calls into immediate failures instead
    of queued stalls.

Clock contract (telemetry.py): budgets are ``time.monotonic``
differences — wall clock is never subtracted.
All helpers swallow transport errors into ``None`` / status-0 returns:
the callers (collector age-out, front-door ejection) treat "no answer"
as data, not as an exception path.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple


class Deadline:
    """A spend-down time budget for a multi-call cycle.  Created at the
    top of the cycle; every outbound call bounds its own timeout by
    ``remaining()`` so the cycle as a whole cannot overrun the budget
    by more than one in-flight call."""

    def __init__(self, budget_s: float):
        self.budget_s = float(budget_s)
        self._t0 = time.monotonic()

    def remaining(self) -> float:
        return max(0.0, self.budget_s - (time.monotonic() - self._t0))

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def bound(self, timeout_s: float) -> float:
        """The effective timeout for the next call: the caller's own
        cap or what is left of the budget, whichever is smaller."""
        return min(float(timeout_s), self.remaining())


def fetch(url: str, timeout_s: float,
          deadline: Optional[Deadline] = None) -> Optional[str]:
    """GET ``url`` with a hard timeout; the body as text, or None on
    any transport/HTTP/parse failure — including a deadline already
    spent, which costs zero wall clock."""
    t = float(timeout_s) if deadline is None else deadline.bound(timeout_s)
    if t <= 0.0:
        return None
    try:
        with urllib.request.urlopen(url, timeout=t) as resp:
            return resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError, ValueError):
        return None


def fetch_json(url: str, timeout_s: float,
               deadline: Optional[Deadline] = None
               ) -> Optional[Dict[str, Any]]:
    """GET ``url`` and parse the body as a JSON object; None on any
    failure (transport, budget, or a body that is not a dict)."""
    body = fetch(url, timeout_s, deadline=deadline)
    if body is None:
        return None
    try:
        doc = json.loads(body)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def post_json(url: str, doc: Dict[str, Any], timeout_s: float
              ) -> Tuple[int, Dict[str, Any]]:
    """POST ``doc`` as JSON with a hard timeout.  Returns
    ``(status, body_dict)``; HTTP error statuses are returned (not
    raised) with their parsed body, transport failures return
    ``(0, {})`` — callers branch on status, never on exceptions."""
    data = json.dumps(doc).encode("utf-8")
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=float(timeout_s)) as r:
            return int(r.status), _body_dict(r.read())
    except urllib.error.HTTPError as e:
        try:
            raw = e.read()
        except OSError:
            raw = b""
        return int(e.code), _body_dict(raw)
    except (urllib.error.URLError, OSError, ValueError):
        return 0, {}


def _body_dict(raw: bytes) -> Dict[str, Any]:
    try:
        doc = json.loads(raw.decode("utf-8", "replace") or "{}")
    except ValueError:
        return {}
    return doc if isinstance(doc, dict) else {}
