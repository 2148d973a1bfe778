"""SLO-driven replica autoscaler: the elastic-capacity control loop.

Counterpart of ``distributed_llm_tpu/serving/autoscaler.py``.  A per-tier
``ReplicaAutoscaler`` reads signals the system already emits and moves
replica membership through ``ReplicatedTierClient.scale_to``
(serving/replicas.py):

- **SLO goodput** (obs/slo.py ``SLOMonitor.goodput(tier=...)``), the
  windowed fraction of requests meeting their TTFT/TBT targets: below
  ``autoscale_goodput_floor`` the tier is failing users.
- **Queue growth** (the tier's ``load_snapshot``): queue depth above
  ``autoscale_queue_high`` x live replicas, the leading indicator.
- **Admission sheds** (each replica's admission-controller ``rejected``
  deltas): the bounded queue overflowed, capacity is short now.

Scale UP when a breach has held for ``autoscale_breach_window_s``, the
last membership event is at least ``autoscale_up_cooldown_s`` old and
membership is below ``autoscale_max_replicas``.  Scale DOWN when the tier
has been idle (no queue, no active slot, no shed, goodput at least the
floor plus ``IDLE_GOODPUT_MARGIN``) for ``autoscale_idle_window_s``, the
last event is at least ``autoscale_down_cooldown_s`` old and membership
is above ``autoscale_min_replicas``.  Every actuation appends its signals
to a bounded ledger (``GET /stats``) and bumps
``dllm_autoscale_events_total{tier,direction,reason}``; membership is the
``dllm_replica_count{tier}`` gauge.

``tick()`` is one decision on the injected ``clock``, so tests drive the
controller without a thread or a sleep.  The thread is a named daemon
whose ``stop()`` sets an event and joins with a bound; the Router starts
one per armed tier and stops them in ``drain()`` before the tiers.  A
tier without ``autoscale`` (or a Router built with ``autoscale=False``,
JAX's ``DLLM_AUTOSCALE=0``) has no controller: its membership is static.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# Scale-down hysteresis margin over the goodput floor: idle requires
# goodput at/above floor + margin (when a window exists), mirroring the
# SLO monitor's own recover-margin asymmetry — the bar to shed capacity
# is higher than the bar that added it.
IDLE_GOODPUT_MARGIN = 0.1

# Bounded decision ledger (GET /stats): enough history to read a whole
# diurnal cycle's transitions without growing with uptime.
LEDGER_CAP = 32


class ReplicaAutoscaler:
    """One tier's control loop: signals in, ``scale_to`` out."""

    def __init__(self, name: str, tier_cfg, client, slo,
                 metrics=None, clock=time.monotonic):
        """``client`` is the tier's ReplicatedTierClient (must expose
        ``scale_to``/``replica_count``/``load_snapshot``/``clients``);
        ``slo`` the router's SLOMonitor; ``clock`` injectable for
        deterministic tests (drive ``tick()`` directly — no thread
        needed)."""
        self.name = name
        self.tier = tier_cfg
        self.client = client
        self.slo = slo
        self._metrics = metrics
        self._clock = clock
        g = lambda f, d: getattr(tier_cfg, f, d)
        self.interval_s = max(0.05, float(g("autoscale_interval_s", 1.0)))
        self.min_replicas = max(1, int(g("autoscale_min_replicas", 1)))
        self.max_replicas = max(self.min_replicas,
                                int(g("autoscale_max_replicas", 4)))
        self.goodput_floor = float(g("autoscale_goodput_floor", 0.5))
        self.queue_high = float(g("autoscale_queue_high", 2.0))
        self.breach_window_s = float(g("autoscale_breach_window_s", 3.0))
        self.idle_window_s = float(g("autoscale_idle_window_s", 10.0))
        self.up_cooldown_s = float(g("autoscale_up_cooldown_s", 5.0))
        self.down_cooldown_s = float(g("autoscale_down_cooldown_s", 15.0))
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.ledger: "deque[Dict[str, Any]]" = deque(maxlen=LEDGER_CAP)
        self.events_total = {"up": 0, "down": 0}
        # Streak state: when did the current breach/idle stretch start
        # (None = not currently breaching/idle).
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_event: Optional[float] = None
        self._last_shed_total: Optional[int] = None
        self._last_signals: Dict[str, Any] = {}

    # -- signals ------------------------------------------------------------

    def _shed_total(self) -> int:
        """Summed admission rejections over the live replicas (lifetime
        counters; the controller differences consecutive reads)."""
        total = 0
        for c in list(getattr(self.client, "clients", ())):
            try:
                snap = c.admission.snapshot()
                total += int(snap.get("rejected", 0) or 0)
            except Exception:
                continue
        return total

    def read_signals(self) -> Dict[str, Any]:
        """One snapshot of every decision input (also the ledger's
        per-transition record)."""
        try:
            n = int(self.client.replica_count())
        except Exception:
            n = len(list(getattr(self.client, "clients", ()))) or 1
        try:
            load = self.client.load_snapshot()
        except Exception:
            load = {}
        goodput = None
        try:
            goodput = self.slo.goodput(tier=self.name)
        except Exception:
            pass
        shed_total = self._shed_total()
        last = self._last_shed_total
        self._last_shed_total = shed_total
        return {
            "replicas": n,
            "goodput": (round(goodput, 4)
                        if goodput is not None else None),
            "queue_depth": int(load.get("queue_depth", 0) or 0),
            "active_slots": int(load.get("active_slots", 0) or 0),
            "shed_delta": (max(0, shed_total - last)
                           if last is not None else 0),
        }

    # -- decision -----------------------------------------------------------

    def _breach_reason(self, sig: Dict[str, Any]) -> Optional[str]:
        if sig["shed_delta"] > 0:
            return "shed"
        if (sig["goodput"] is not None
                and sig["goodput"] < self.goodput_floor):
            return "goodput_floor"
        if sig["queue_depth"] > self.queue_high * max(1, sig["replicas"]):
            return "queue_growth"
        return None

    def _is_idle(self, sig: Dict[str, Any]) -> bool:
        if sig["queue_depth"] or sig["active_slots"] or sig["shed_delta"]:
            return False
        return (sig["goodput"] is None
                or sig["goodput"] >= self.goodput_floor
                + IDLE_GOODPUT_MARGIN)

    def tick(self) -> Optional[str]:
        """One control decision: read signals, advance the streaks,
        maybe actuate.  Public so tests drive the controller
        deterministically with an injected clock — the thread just
        calls this at cadence.  Returns 'up'/'down' when membership
        changed, else None."""
        now = self._clock()
        sig = self.read_signals()
        self._last_signals = sig
        n = sig["replicas"]
        reason = self._breach_reason(sig)
        if reason is not None:
            if self._breach_since is None:
                self._breach_since = now
        else:
            self._breach_since = None
        if self._is_idle(sig):
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None

        cooldown_ok_up = (self._last_event is None
                          or now - self._last_event >= self.up_cooldown_s)
        cooldown_ok_down = (self._last_event is None
                            or now - self._last_event
                            >= self.down_cooldown_s)
        if (reason is not None and n < self.max_replicas
                and self._breach_since is not None
                and now - self._breach_since >= self.breach_window_s
                and cooldown_ok_up):
            return self._actuate(n + 1, "up", reason, sig, now)
        if (n > self.min_replicas
                and self._idle_since is not None
                and now - self._idle_since >= self.idle_window_s
                and cooldown_ok_down):
            return self._actuate(n - 1, "down", "idle", sig, now)
        return None

    def _actuate(self, target: int, direction: str, reason: str,
                 sig: Dict[str, Any], now: float) -> Optional[str]:
        try:
            result = self.client.scale_to(target, reason=reason)
        except Exception:
            logger.exception("autoscaler %s: scale_to(%d) failed",
                             self.name, target)
            result = {"errors": ["scale_to raised"]}
        changed = (result.get("added") or result.get("removed")
                   if isinstance(result, dict) else False)
        entry = {
            "ts": time.time(),
            "direction": direction,
            "reason": reason,
            "from_replicas": sig["replicas"],
            "to_replicas": (result.get("replicas", target)
                            if isinstance(result, dict) else target),
            "ok": bool(changed),
            "signals": dict(sig),
        }
        with self._lock:
            self.ledger.append(entry)
        if not changed:
            # A refused actuation (scale errors, already at bound)
            # doesn't re-arm the cooldown: the condition persists and
            # the next tick retries.
            return None
        self._last_event = now
        self._breach_since = None
        self._idle_since = None
        self.events_total[direction] += 1
        logger.info("autoscaler %s: %s -> %d replicas (%s; goodput=%s "
                    "queue=%d shed=%d)", self.name, direction,
                    entry["to_replicas"], reason, sig["goodput"],
                    sig["queue_depth"], sig["shed_delta"])
        try:
            m = self._metrics
            if m is not None:
                m.autoscale_events.labels(self.name, direction,
                                          reason).inc()
                m.replica_count_g.labels(self.name).set(
                    entry["to_replicas"])
        except Exception:
            pass
        return direction

    # -- lifecycle (the sampler's thread discipline) ------------------------

    def start(self) -> None:
        """Idempotent: one controller thread per autoscaler."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"autoscaler-{self.name}")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # The controller must outlive a bad read — a dead
                # autoscaler is a silent return to static capacity.
                logger.exception("autoscaler %s: tick failed", self.name)

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop the controller (bounded join; the current tick may be
        inside scale_to, which can take a drain — the join bound keeps
        Router.drain from hanging on it; the daemon flag keeps an
        overrunning tick from blocking interpreter exit)."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The GET /stats block: bounds/windows, live membership, streak
        state, event counters, and the bounded decision ledger."""
        with self._lock:
            ledger = list(self.ledger)
        try:
            n = int(self.client.replica_count())
        except Exception:
            n = None
        return {
            "enabled": True,
            "replicas": n,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "goodput_floor": self.goodput_floor,
            "queue_high_per_replica": self.queue_high,
            "breach_window_s": self.breach_window_s,
            "idle_window_s": self.idle_window_s,
            "up_cooldown_s": self.up_cooldown_s,
            "down_cooldown_s": self.down_cooldown_s,
            "interval_s": self.interval_s,
            "breaching": self._breach_since is not None,
            "idle": self._idle_since is not None,
            "events_total": dict(self.events_total),
            "last_signals": dict(self._last_signals),
            "ledger": ledger,
        }
