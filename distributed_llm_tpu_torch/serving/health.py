"""Health monitor: liveness probing, automatic restart, perf-row merge.

Counterpart of ``distributed_llm_tpu/serving/health.py``.  The reference
detects failure per call (a bootstrap probe, a lazy restart in every
``.process()``, failover on error-shaped responses); all of that lives in
the tier clients and the Router.  This module adds:

- **background liveness probing** of every tier at a fixed cadence, with
  an automatic engine restart after ``max_consecutive_failures`` failed
  probes of a tier that was seen running (a merely stopped tier, lazy or
  shut down between bench configurations, reads ``stopped`` and is never
  restarted; a draining one reads ``draining``).  A remote tier
  (serving/remote.py, ``remote_lifecycle``) that was seen running and then
  stops answering, or answers not ok, reads ``failed`` and is respawned
  through its manager's ``start_server``.  A decode-watchdog wedge
  (``health()["wedged"]``) restarts at once.  A replicated tier is probed
  replica by replica and only the wedged replica restarts, through
  ``ReplicatedTierClient.restart_replica`` (its crash rescue).  A restart
  runs on a worker joined for at most ``restart_timeout_s``; one that
  outlives it is abandoned and counted, and probing goes on;
- **the perf-row merge** of the cross-host health exchange
  (``_merge_gathered``: rows of other hosts folded into the perf
  strategy).  The exchange itself needs a device mesh and its allgather,
  which come with tensor parallelism (ROADMAP A10): ``exchange_health``
  returns None without a mesh, as JAX's does, and a mesh is refused;
- a **snapshot** for GET /stats.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class HealthMonitor:
    """Periodically probes tiers and restarts engines that went
    unhealthy."""

    def __init__(
        self,
        router,                              # serving.router.Router
        interval_s: float = 5.0,
        max_consecutive_failures: int = 3,
        mesh=None,
        auto_restart: bool = True,
        restart_timeout_s: float = 900.0,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "the cross-host health exchange (a device mesh and its "
                "allgather) is not ported to the PyTorch/CUDA package yet "
                "(see ROADMAP.md A10)")
        self.router = router
        self.interval_s = interval_s
        self.max_failures = max_consecutive_failures
        self.mesh = mesh
        self.auto_restart = auto_restart
        # Bounded wait for a restart: a rebuild against a wedged card may
        # never return, and an unbounded join would end all probing.
        self.restart_timeout_s = restart_timeout_s
        self._fail_counts: Dict[str, int] = {}
        self._seen_running: Dict[str, bool] = {}
        self._last: Dict[str, Dict[str, Any]] = {}
        self._restarts: Dict[str, int] = {}
        # Restart workers abandoned past restart_timeout_s: each still
        # holds its manager's lifecycle lock, so until it returns no later
        # restart of that tier can proceed; counted in the health entries.
        self._restarts_abandoned: Dict[str, int] = {}
        self._restarting: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- probing -----------------------------------------------------------

    def _probe_tier(self, name: str, mgr) -> Tuple[str, Dict[str, Any]]:
        """-> (state, health): state is running, stopped, draining or
        failed."""
        try:
            running = mgr.is_server_running()
            health = mgr.health()
        except Exception as exc:
            return "failed", {"ok": False, "error": str(exc)}
        if health.get("draining"):
            # Intentional shedding: never a failure, never restarted.
            return "draining", health
        if not running:
            # A dead remote raised above.  A remote that answers /health
            # but reports not ok has no deliberate local stop: once seen
            # running, that is a failure too (the restart respawns it
            # through its spawn_cmd).  A local tier stopped on purpose
            # stays "stopped".
            if (getattr(mgr, "remote_lifecycle", False)
                    and self._seen_running.get(name)):
                return "failed", {**health, "ok": False}
            return "stopped", health
        # Running but unhealthy (a batched engine whose scheduler thread
        # died reads as failed even before the watchdog's deadline).
        engine = getattr(mgr, "_engine", None)
        loop_dead = (engine is not None
                     and getattr(engine, "_thread", True) is None
                     and hasattr(engine, "submit"))
        if not health.get("ok") or loop_dead:
            return "failed", {**health, "ok": False}
        return "running", health

    def _account_probe(self, key: str, state: str, health: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], bool]:
        """Fold one probe into the failure and restart accounting under
        the monitor lock; returns (snapshot entry, restart?).  ``key`` is
        a tier name or a replica key ("nano/r0"): replicas carry their own
        streaks and restart counts."""
        wedged = bool(health.get("wedged"))
        restart = False
        with self._lock:
            if state == "running":
                self._fail_counts[key] = 0
                self._seen_running[key] = True
            elif state == "failed" and (self._seen_running.get(key)
                                        or wedged):
                if wedged:
                    # Stalled step progress is direct wedge evidence:
                    # restart now instead of waiting out the probe count.
                    self._fail_counts[key] = max(
                        self._fail_counts.get(key, 0) + 1,
                        self.max_failures)
                else:
                    self._fail_counts[key] = \
                        self._fail_counts.get(key, 0) + 1
                restart = (self.auto_restart
                           and self._fail_counts[key] >= self.max_failures)
            entry = {**health, "state": state,
                     "consecutive_failures": self._fail_counts.get(key, 0),
                     "restarts": self._restarts.get(key, 0),
                     "restarts_abandoned":
                         self._restarts_abandoned.get(key, 0)}
            self._last[key] = entry
        return entry, restart

    def _probe_replicated(self, name: str, tier, items, breaker,
                          to_restart) -> Dict[str, Any]:
        """Probe a replicated tier's replicas one by one: each keeps its
        own streak and restart target, so one wedged replica restarts
        alone while the others serve.  The tier entry aggregates (ok while
        any replica runs).  ``items`` is a (rid, manager) snapshot."""
        reps: Dict[str, Dict[str, Any]] = {}
        states: List[str] = []
        for rid, sub in items:
            rkey = f"{name}/r{rid}"
            state, health = self._probe_tier(rkey, sub)
            entry, restart = self._account_probe(rkey, state, health)
            if restart:
                def _on_restarted(tc=tier, rid=rid):
                    fn = getattr(tc, "reset_replica", None)
                    if callable(fn):
                        fn(rid)
                # The crash-rescue restart, when the probed manager IS
                # the member the client would restart (a duck-typed
                # manager set swapped under the tier takes the plain
                # stop/start).  A refusal raises, which keeps the streak:
                # the next probe retries.
                restart_fn = None
                rescue = getattr(tier, "restart_replica", None)
                member_of = getattr(tier, "member_manager", None)
                if (callable(rescue) and callable(member_of)
                        and member_of(rid) is sub):
                    def restart_fn(tc=tier, rid=rid):
                        summary = tc.restart_replica(rid,
                                                     reason="health probe")
                        if not summary.get("restarted"):
                            errs = (summary.get("errors")
                                    or ["restart failed"])
                            raise RuntimeError(str(errs[0]))
                to_restart.append((rkey, sub, _on_restarted, restart_fn))
            reps[rkey] = entry
            states.append(state)
        # Replicas that left membership leave the bookkeeping.
        with self._lock:
            prefix = f"{name}/r"
            for key in [k for k in self._last
                        if k.startswith(prefix) and k not in reps]:
                self._last.pop(key, None)
                self._fail_counts.pop(key, None)
                self._seen_running.pop(key, None)
        running = sum(1 for s in states if s == "running")
        if running:
            tier_state = "running"
        elif states and all(s == "draining" for s in states):
            tier_state = "draining"
        elif states and all(s == "stopped" for s in states):
            tier_state = "stopped"
        else:
            tier_state = "failed"
        tier_entry = {
            "ok": running > 0,
            "state": tier_state,
            "healthy_replicas": running,
            "replica_count": len(items),
            "degraded": 0 < running < len(items),
            "replicas": reps,
        }
        with self._lock:
            self._last[name] = tier_entry
        if breaker is not None and tier_state != "draining":
            breaker.note_probe(name, running > 0)
        return tier_entry

    def probe_once(self) -> Dict[str, Dict[str, Any]]:
        """One liveness pass.  Restarts (outside the lock: a rebuild takes
        seconds on the card) only tiers seen running that then failed
        ``max_consecutive_failures`` probes in a row, or wedged;
        replicated tiers probe and restart per replica."""
        snapshot: Dict[str, Dict[str, Any]] = {}
        # (key, manager, on-restarted callback, rescue restart fn or None)
        to_restart: List[Tuple[str, Any, Any, Any]] = []

        breaker = getattr(self.router, "breaker", None)
        for name, tier in self.router.tiers.items():
            mgr = tier.server_manager
            items_fn = getattr(mgr, "replica_items", None)
            subs = getattr(mgr, "replica_managers", None)
            if callable(items_fn):
                snapshot[name] = self._probe_replicated(
                    name, tier, items_fn(), breaker, to_restart)
                continue
            if callable(subs):
                # Replica sets without stable ids: positional keys.
                snapshot[name] = self._probe_replicated(
                    name, tier, list(enumerate(subs())), breaker,
                    to_restart)
                continue
            state, health = self._probe_tier(name, mgr)
            entry, restart = self._account_probe(name, state, health)
            if restart:
                def _on_restarted(n=name, b=breaker):
                    # A restart voids the streak that opened the circuit.
                    if b is not None:
                        b.reset(n)
                to_restart.append((name, mgr, _on_restarted, None))
            snapshot[name] = entry
            # Half-open probing rides the liveness cadence; draining is
            # deliberate and feeds the breaker neither verdict.
            if breaker is not None and state != "draining":
                breaker.note_probe(name, state == "running")

        for name, mgr, on_restarted, restart_fn in to_restart:
            prev = self._restarting.get(name)
            if prev is not None and prev.is_alive():
                logger.warning("tier %s restart still in flight: not "
                               "stacking another", name)
                continue
            logger.warning("tier %s unhealthy after %d probes: restarting",
                           name, self.max_failures)

            def _restart(name=name, mgr=mgr, on_restarted=on_restarted,
                         restart_fn=restart_fn):
                try:
                    if restart_fn is not None:
                        restart_fn()
                    else:
                        mgr.stop_server()
                        mgr.start_server()
                except Exception as exc:
                    # The streak stays: the next probe retries.
                    logger.error("tier %s restart failed: %s", name, exc)
                    return
                with self._lock:
                    self._restarts[name] = self._restarts.get(name, 0) + 1
                    self._fail_counts[name] = 0
                    if name in self._last:
                        self._last[name]["restarts"] = self._restarts[name]
                if on_restarted is not None:
                    on_restarted()

            worker = threading.Thread(target=_restart, daemon=True,
                                      name=f"restart-{name}")
            self._restarting[name] = worker
            worker.start()
            # Synchronous in the healthy case (probe_once returns with the
            # restart done); bounded so a wedged rebuild cannot end all
            # probing.
            worker.join(self.restart_timeout_s)
            if worker.is_alive():
                logger.error("tier %s restart exceeded %.0fs: abandoning "
                             "the worker and probing on", name,
                             self.restart_timeout_s)
                with self._lock:
                    self._restarts_abandoned[name] = \
                        self._restarts_abandoned.get(name, 0) + 1
                    if name in self._last:
                        self._last[name]["restarts_abandoned"] = \
                            self._restarts_abandoned[name]
        return snapshot

    # -- cross-host perf exchange ------------------------------------------

    def _perf_strategy(self):
        strategy = getattr(self.router.query_router, "router", None)
        if strategy is not None and hasattr(strategy, "merge_remote"):
            return strategy           # PerfStrategy only
        return None

    def exchange_health(self) -> Optional[Dict[str, np.ndarray]]:
        """The cross-host exchange of perf rows over a device mesh: None
        without a mesh or a perf strategy (the only case the port has; a
        mesh is refused at construction)."""
        if self.mesh is None or self._perf_strategy() is None:
            return None
        raise NotImplementedError("the cross-host health exchange is not "
                                  "ported (see ROADMAP.md A10)")

    @staticmethod
    def _merge_gathered(perf, tier_name: str, rows: np.ndarray,
                        remote_mask: Sequence[bool]) -> None:
        """Fold REMOTE rows only (mask True) into the perf strategy as
        representative samples: each row is (latency sum, token sum, ok
        count, samples), at most 5 synthetic samples a host."""
        for i, row in enumerate(rows):
            if not remote_mask[i]:
                continue
            lat, tok, ok_count, n_samples = row
            n_samples = int(n_samples)
            if n_samples <= 0:
                continue
            k = min(n_samples, 5)
            mean_lat = float(lat) / n_samples
            mean_tok = max(1, int(tok) // n_samples)
            ok_true = round(float(ok_count) / n_samples * k)
            samples: List[Tuple[float, int, bool]] = [
                (mean_lat, mean_tok, j < ok_true) for j in range(k)]
            perf.merge_remote(tier_name, samples)

    # -- lifecycle ---------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
                self.exchange_health()
            except Exception:
                logger.exception("health monitor tick failed")
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="health-monitor")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2 * self.interval_s)
        self._thread = None

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._last.items()}
