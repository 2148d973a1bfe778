"""Per-tier circuit breaker: failure isolation ahead of the admission queue.

The port's own copy of ``distributed_llm_tpu/serving/breaker.py``: the
three-state machine, the HealthMonitor's hooks (``note_probe``,
``reset``) and the replica sub-gate's membership verbs (``ensure``,
``forget``):

- **closed**: traffic flows; consecutive error-shaped results are counted
  (any success resets the count);
- **open**: after ``failure_threshold`` consecutive failures the tier
  sheds ALL traffic for ``cooldown_s``; the Router re-routes to the other
  tier before dispatch;
- **half-open**: past the cooldown exactly ONE request is let through as
  a canary; success closes the breaker, failure re-opens it.

Thresholds live in ``ClusterConfig`` (``breaker_failures`` /
``breaker_cooldown_s``); ``breaker_failures=0`` disables it.  All
transitions are thread-safe.  The Router hooks ``on_transition`` to the
``dllm_breaker_transitions_total`` counter and the ``dllm_breaker_state``
gauge (obs/metrics.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, Optional

logger = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One state machine per tier, keyed by tier name."""

    def __init__(self, tiers: Iterable[str], failure_threshold: int = 5,
                 cooldown_s: float = 30.0, clock=time.monotonic,
                 on_transition=None):
        """``on_transition(tier, old_state, new_state)`` fires on every
        state change, WHILE HOLDING the breaker lock, so implementations
        must be cheap and must never call back into the breaker;
        exceptions are swallowed."""
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        names = list(tiers)
        self._state: Dict[str, str] = {t: CLOSED for t in names}
        self._consecutive: Dict[str, int] = {t: 0 for t in names}
        self._opened_at: Dict[str, float] = {}
        # Half-open admits ONE canary at a time: without the in-flight
        # flag, every request racing past the cooldown edge would be
        # "the" probe and a still-down tier would eat a thundering herd.
        # The permit carries a timestamp: a canary whose outcome never
        # comes back (stream handle abandoned unconsumed) expires after
        # another cooldown_s, so a lost canary can't starve the tier of
        # probe windows forever.
        self._probe_inflight: Dict[str, bool] = {t: False for t in names}
        self._probe_started: Dict[str, float] = {}
        self.opened_total: Dict[str, int] = {t: 0 for t in names}

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    def _set_state(self, tier: str, new: str) -> None:
        """State write + transition notification (caller holds the lock).
        No-op (and no notification) when the state doesn't change."""
        old = self._state[tier]
        if old == new:
            return
        self._state[tier] = new
        if self._on_transition is not None:
            try:
                self._on_transition(tier, old, new)
            except Exception:
                pass

    # -- routing-time consultation ----------------------------------------

    def allow(self, tier: str) -> bool:
        """May traffic be sent to ``tier``?  A True from an open breaker
        means THIS caller holds the half-open canary permit — it must
        dispatch and then ``record`` the outcome (the Router always
        records after dispatch, so the permit is repaid)."""
        if not self.enabled or tier not in self._state:
            return True
        with self._lock:
            st = self._state[tier]
            if st == CLOSED:
                return True
            if st == OPEN:
                opened = self._opened_at.get(tier, 0.0)
                if self._clock() - opened < self.cooldown_s:
                    return False
                self._set_state(tier, HALF_OPEN)
                self._probe_inflight[tier] = True
                self._probe_started[tier] = self._clock()
                logger.info("breaker %s: cooldown expired -> half-open "
                            "(this request is the canary)", tier)
                return True
            # HALF_OPEN: one canary at a time — unless the outstanding
            # permit is stale (its outcome never came back), in which
            # case a fresh canary takes over.
            if (self._probe_inflight[tier]
                    and self._clock() - self._probe_started.get(tier, 0.0)
                    < self.cooldown_s):
                return False
            self._probe_inflight[tier] = True
            self._probe_started[tier] = self._clock()
            return True

    def retry_after_s(self, tier: Optional[str] = None) -> float:
        """Seconds until the next half-open probe window — the
        retry-after hint for the degraded both-tiers-open response.
        Without a tier: the SOONEST window across open tiers."""
        with self._lock:
            now = self._clock()
            remaining = [
                max(0.0, self.cooldown_s - (now - self._opened_at.get(t, now)))
                for t, st in self._state.items()
                if st == OPEN and (tier is None or t == tier)]
        return min(remaining) if remaining else 0.0

    # -- outcome recording --------------------------------------------------

    def record(self, tier: str, ok: bool) -> None:
        """Feed one request's outcome (ok = not error-shaped)."""
        if not self.enabled or tier not in self._state:
            return
        with self._lock:
            self._probe_inflight[tier] = False
            if ok:
                if self._state[tier] != CLOSED:
                    logger.info("breaker %s: probe succeeded -> closed", tier)
                self._set_state(tier, CLOSED)
                self._consecutive[tier] = 0
                return
            self._consecutive[tier] += 1
            st = self._state[tier]
            if st == HALF_OPEN or (st == CLOSED and self._consecutive[tier]
                                   >= self.failure_threshold):
                if st != OPEN:
                    self.opened_total[tier] += 1
                    logger.warning(
                        "breaker %s: OPEN after %d consecutive failures "
                        "(cooldown %.1fs)", tier, self._consecutive[tier],
                        self.cooldown_s)
                self._set_state(tier, OPEN)
                self._opened_at[tier] = self._clock()

    def note_probe(self, tier: str, healthy: bool) -> None:
        """A HealthMonitor liveness probe's verdict: a healthy probe of an
        OPEN tier past its cooldown advances it to half-open (the next
        real request is the canary), so recovery needs no client request
        to find the cooldown over.  An unhealthy probe leaves the state
        alone (the probe cadence must not re-arm the cooldown)."""
        if not self.enabled or tier not in self._state:
            return
        with self._lock:
            if (healthy and self._state[tier] == OPEN
                    and self._clock() - self._opened_at.get(tier, 0.0)
                    >= self.cooldown_s):
                self._set_state(tier, HALF_OPEN)
                self._probe_inflight[tier] = False
                logger.info("breaker %s: healthy liveness probe past "
                            "cooldown -> half-open", tier)

    def release_probe(self, tier: str) -> None:
        """Repay a half-open canary permit WITHOUT a verdict (the
        dispatch never produced failure evidence — e.g. an admission
        rejection): the next request becomes the canary immediately
        instead of waiting out the stale-permit expiry."""
        if tier not in self._state:
            return
        with self._lock:
            self._probe_inflight[tier] = False

    def reset(self, tier: str) -> None:
        """Force-close (a successful engine restart by the HealthMonitor
        makes the old failure streak meaningless)."""
        if tier not in self._state:
            return
        with self._lock:
            self._set_state(tier, CLOSED)
            self._consecutive[tier] = 0
            self._probe_inflight[tier] = False

    # -- dynamic membership ---------------------------------------------------

    def ensure(self, tier: str) -> None:
        """Mint state for a key added after construction (a replica that
        goes live mid-run needs its own sub-gate).  New keys start CLOSED;
        idempotent, never resets an existing key."""
        with self._lock:
            if tier in self._state:
                return
            self._state[tier] = CLOSED
            self._consecutive[tier] = 0
            self._probe_inflight[tier] = False
            self.opened_total.setdefault(tier, 0)

    def forget(self, tier: str) -> None:
        """Drop a retired key's live state; ``opened_total`` keeps its
        count (history, not live state)."""
        with self._lock:
            self._state.pop(tier, None)
            self._consecutive.pop(tier, None)
            self._probe_inflight.pop(tier, None)
            self._opened_at.pop(tier, None)
            self._probe_started.pop(tier, None)

    # -- observability ------------------------------------------------------

    def state(self, tier: str) -> str:
        with self._lock:
            return self._state.get(tier, CLOSED)

    def all_open(self) -> bool:
        """True iff every tier is open AND none is ready for a canary: a
        read-only mirror of the Router's degraded gate (the gate itself is
        the ``allow`` pair in ``route_query``, which consumes the canary
        permit)."""
        if not self.enabled:
            return False
        with self._lock:
            now = self._clock()
            for t, st in self._state.items():
                if st == CLOSED:
                    return False
                if st == OPEN and (now - self._opened_at.get(t, now)
                                   >= self.cooldown_s):
                    return False
                if st == HALF_OPEN and not self._probe_inflight[t]:
                    return False
            return True

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            now = self._clock()
            return {
                t: {
                    "state": st,
                    "consecutive_failures": self._consecutive[t],
                    "opened_total": self.opened_total[t],
                    "cooldown_remaining_s": (
                        round(max(0.0, self.cooldown_s
                                  - (now - self._opened_at.get(t, now))), 2)
                        if st == OPEN else 0.0),
                }
                for t, st in self._state.items()
            }
