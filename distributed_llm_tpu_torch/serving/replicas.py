"""Replicated tiers: N data-parallel engine replicas behind one tier.

Counterpart of ``distributed_llm_tpu/serving/replicas.py``.
``TierConfig.replicas > 1`` makes the tier own N full ``EngineManager``
replicas, each behind its own ``TierClient`` (bounded admission and its
wait predictor, watchdog, drain, chunked prefill, shared-prefix KV, tick
profiler: the whole single-engine machinery), and one
``ReplicatedTierClient`` with the tier client's surface in front of them.
The tier's device group (``parallel/mesh.carve_tier_meshes``: a
('batch', 'tp') group of ``replicas x tp`` slots where the devices
suffice) gives each replica one ``tp``-wide row (``_split_devices``); a
row of more than one slot runs its replica tensor-parallel; a tier's
``ep`` and ``sp`` are ignored here, with JAX's warning.  On one card
every replica shares the device: the replicas' ticks interleave on it,
so a second replica buys the overlap of one replica's host work with the
other's device work, not a second card's throughput.

Dispatch picks a replica by a two-level policy:

1. **Prefix affinity** (``TierConfig.replica_affinity``): the request is
   tokenized once and every live replica's parked prefixes (the device
   prefix cache and the host spill tier) are peeked with the same ids.  A
   match of at least ``replica_affinity_min_tokens`` binds the request to
   that replica, so a session lands where its blocks are parked.
2. **Least-loaded** otherwise: smallest predicted queue wait (queue depth
   / slots x EWMA service time, the admission predictor), ties broken by
   in-flight count, then round-robin.  An affine replica whose predicted
   wait exceeds the least-loaded one's by more than
   ``replica_affinity_override_s`` is overridden.

``policy`` (a constructor argument; JAX reads it from the
``DLLM_REPLICA_POLICY`` environment variable) forces ``affinity``,
``load`` or ``random``.

Each replica has its own breaker sub-gate (serving/breaker.py, keyed
``r<rid>``, with the cluster's thresholds): dispatch skips open replicas,
sync and stream verdicts feed back per replica, and admission rejections
stay breaker-neutral.  Tier-level ``health()``, ``kv_stats()`` and
``slot_stats()`` aggregate over the replicas with a per-replica
breakdown, and the HealthMonitor probes and restarts replicas one by one
(``restart_replica``): a restart captures the victim's queued and
in-flight requests and resumes them on a live sibling (or re-queues them
on the rebuilt engine when the tier has one replica), and carries the
host spill store across the restart.

Membership is a list of member records, each with a replica id (``rid``)
that is never reused: engine-side tier names (``nano/r1``), metric labels
and breaker keys stay stable.  Every reader iterates a snapshot
(``list(members)``), so membership may change mid-flight.  ``scale_to(n)``
is the autoscaler's (serving/autoscaler.py) and the operator's verb:
scale-up publishes a warm standby, or builds and warms a new replica off
membership and only then publishes it (dispatch never sees a cold
replica); scale-down picks the least-affine replica, removes it from
membership first, waits out its in-flight work, demotes its sole-owner
parked prefixes through the host spill tier and hands the resident
entries to a survivor's store, then parks it in the warm standby pool or
drains and stops it.  An autoscale-armed tier starts at
``autoscale_min_replicas`` and, with ``autoscale_warm_pool``, builds the
replicas up to ``autoscale_max_replicas`` as standbys that
``start_server`` warms.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import ClusterConfig, TierConfig
from ..device import DeviceLike, resolve_device
from ..engine.manager import EngineManager
from ..obs import get_observability
from ..obs import spans as obs_spans
from ..obs.spans import current_trace
from ..parallel.mesh import DeviceGroup, requested_tp, tp_mesh
from ..utils.faults import FaultInjector
from .breaker import OPEN, CircuitBreaker
from .errors import error_dict, is_error_shape
from .tiers import TierClient

logger = logging.getLogger(__name__)

_POLICIES = ("affinity", "load", "random")


def replica_name(i: int) -> str:
    return f"r{i}"


def _split_devices(devices: List, n: int, tp: int = 1) -> List[List]:
    """Per-replica device groups: with at least ``n x tp`` devices each
    replica gets its own ``tp``-device slice; with fewer (one card) an
    unsharded replica is pinned to one device round-robin, so every
    replica of a one-card tier shares the card."""
    per = max(1, tp)
    if len(devices) >= n * per:
        return [devices[i * per:(i + 1) * per] for i in range(n)]
    if per == 1 and devices:
        return [[devices[i % len(devices)]] for i in range(n)]
    return [list(devices) for _ in range(n)]


class _Replica:
    """One live member: its replica id (metric and breaker identity,
    never reused), its request client and its engine manager."""

    __slots__ = ("rid", "client", "mgr")

    def __init__(self, rid: int, client: TierClient, mgr: EngineManager):
        self.rid = rid
        self.client = client
        self.mgr = mgr

    @property
    def name(self) -> str:
        return replica_name(self.rid)


class ReplicaSetManager:
    """The EngineManager-shaped facade over a tier's replica managers:
    lifecycle verbs fan out to every replica, liveness reads aggregate,
    and ``health()``/``kv_stats()``/``slot_stats()`` return tier-level
    aggregates with a per-replica breakdown.  The probe surface is
    lock-free like EngineManager's, and every method iterates a snapshot
    of the member list."""

    def __init__(self, tier: TierConfig,
                 managers: Optional[Sequence[EngineManager]] = None,
                 members: Optional[List[_Replica]] = None,
                 standby: Optional[List[_Replica]] = None):
        self.tier = tier
        if members is not None:
            # The SAME list the ReplicatedTierClient mutates: membership
            # has one source of truth.
            self._members = members
        else:
            self._members = [_Replica(i, None, m)
                             for i, m in enumerate(managers or [])]
        # The warm standby pool, shared by reference with the client's
        # scale_to: start_server warms it, stop_server stops it; the
        # serving aggregates and drain cover members only.
        self._standby = standby if standby is not None else []

    # -- replica access -----------------------------------------------------

    @property
    def managers(self) -> List[EngineManager]:
        return [r.mgr for r in list(self._members)]

    def replica_managers(self) -> List[EngineManager]:
        """The per-replica EngineManagers: the HealthMonitor's probe and
        restart targets."""
        return self.managers

    def replica_items(self) -> List[Tuple[int, EngineManager]]:
        """(rid, manager) snapshot: the stable keys of probes and metric
        labels."""
        return [(r.rid, r.mgr) for r in list(self._members)]

    def live_engines(self) -> List[Tuple[str, Any]]:
        """(replica key, engine) for every running replica: the obs
        surfaces' iteration point.  Never starts an engine."""
        out = []
        for r in list(self._members):
            engine = getattr(r.mgr, "_engine", None)
            if engine is not None:
                out.append((r.name, engine))
        return out

    # -- lifecycle ----------------------------------------------------------

    def start_server(self, beat=None) -> None:
        """Start every replica (idempotent per replica): replica 0 first
        and alone, then the others and the warm standbys concurrently, as
        JAX's does (there, replica 0 fills the compile cache the others
        then hit).  ``beat`` fires from the joining loop while the others
        start."""
        members = list(self._members)
        if not members:
            return
        members[0].mgr.start_server()
        rest = members[1:] + list(self._standby)
        if not rest:
            return
        errors: Dict[int, Optional[BaseException]] = {r.rid: None
                                                      for r in rest}
        threads = []
        for r in rest:
            def _start(r=r):
                try:
                    r.mgr.start_server()
                except BaseException as exc:
                    errors[r.rid] = exc
            t = threading.Thread(target=_start, daemon=True,
                                 name=f"warm-{self.tier.name}-{r.name}")
            threads.append(t)
            t.start()
        for t in threads:
            while t.is_alive():
                t.join(timeout=0.5)
                if beat is not None:
                    beat()
        for r in rest:
            if errors[r.rid] is not None:
                raise errors[r.rid]

    def stop_server(self) -> None:
        for mgr in self.managers:
            mgr.stop_server()
        for rec in list(self._standby):
            rec.mgr.stop_server()

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Drain every replica concurrently and wait them all out; the
        aggregate summary carries the per-replica breakdown."""
        timeout = (timeout_s if timeout_s is not None
                   else self.tier.drain_timeout_s)
        t0 = time.monotonic()
        members = list(self._members)
        # Every key exists before the workers start: a worker abandoned
        # past the join bound only overwrites a value later.
        results: Dict[str, Any] = {
            r.name: {"error": "Request failed: replica drain did not "
                              "return within the join bound"}
            for r in members}
        threads = []
        for r in members:
            def _drain(key=r.name, mgr=r.mgr):
                try:
                    results[key] = mgr.drain(timeout_s=timeout)
                except Exception as exc:
                    results[key] = {"error": f"Request failed: {exc}"}
            t = threading.Thread(target=_drain, daemon=True,
                                 name=f"drain-{self.tier.name}-{r.name}")
            threads.append(t)
            t.start()
        deadline = time.monotonic() + max(0.0, float(timeout)) + 30.0
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        dicts = [r for r in results.values() if isinstance(r, dict)]
        return {
            "draining_started": True,
            "in_flight_at_start": sum(int(r.get("in_flight_at_start", 0))
                                      for r in dicts),
            "drained": sum(int(r.get("drained", 0)) for r in dicts),
            "aborted": sum(int(r.get("aborted", 0)) for r in dicts),
            "waited_s": round(time.monotonic() - t0, 3),
            "replicas": dict(results),
        }

    @property
    def draining(self) -> bool:
        """The tier drains only when every replica does."""
        members = list(self._members)
        return bool(members) and all(r.mgr.draining for r in members)

    def is_server_running(self) -> bool:
        return any(m.is_server_running() for m in self.managers)

    def engine(self):
        """The first member's engine, lazily started like
        ``EngineManager.engine()`` (for callers that introspect one)."""
        return list(self._members)[0].mgr.engine()

    # -- aggregate observability --------------------------------------------

    def health(self) -> Dict[str, Any]:
        """Tier-level health over the replicas' ``health()``: ``ok`` while
        ANY replica serves (one wedged replica is lost capacity, not a
        dead tier), ``wedged`` only when every replica is, the capacity
        counters and the per-replica breakdown."""
        members = list(self._members)
        reps: Dict[str, Dict[str, Any]] = {}
        for r in members:
            try:
                reps[r.name] = r.mgr.health()
            except Exception as exc:
                # dllm-lint: disable=error-shape -- health-probe snapshot (GET /health surface), not the tier error path
                reps[r.name] = {"ok": False, "error": str(exc)[:200]}
        healthy = sum(1 for h in reps.values() if h.get("ok"))
        running = sum(1 for h in reps.values() if h.get("uptime_s"))
        entry: Dict[str, Any] = {
            "ok": healthy > 0,
            "draining": self.draining,
            "tier": self.tier.name,
            "model": self.tier.model_preset,
            "uptime_s": max((h.get("uptime_s") or 0.0)
                            for h in reps.values()) if reps else 0.0,
            "device": sorted({str(h["device"]) for h in reps.values()
                              if h.get("device")}),
            "replica_count": len(members),
            "healthy_replicas": healthy,
            "degraded": 0 < healthy < len(members),
            "queue_depth": sum(int(h.get("queue_depth") or 0)
                               for h in reps.values()),
            "active_slots": sum(int(h.get("active_slots") or 0)
                                for h in reps.values()),
            "max_slots": sum(int(h.get("max_slots") or 0)
                             for h in reps.values()),
            "replicas": reps,
        }
        if entry["max_slots"]:
            entry["slot_occupancy"] = round(
                entry["active_slots"] / entry["max_slots"], 3)
        if reps and all(h.get("wedged") for h in reps.values()):
            entry["ok"] = False
            entry["wedged"] = True
        if running and not healthy:
            entry["error"] = "no healthy replica (all wedged or failed)"
        return entry

    def kv_stats(self) -> Optional[Dict[str, Any]]:
        """Summed block-pool picture over the live replicas with the
        per-replica breakdown; None when no live replica has a pool.
        ``dedup_ratio`` is the max over replicas (the pools are
        disjoint)."""
        reps: Dict[str, Dict[str, Any]] = {}
        for key, engine in self.live_engines():
            fn = getattr(engine, "kv_stats", None)
            if callable(fn):
                reps[key] = fn()
        if not reps:
            return None
        summed = ("free_blocks", "reclaimable_blocks", "total_blocks",
                  "preempted_total", "prefill_pending_blocks",
                  "prefill_backlog_tokens", "shared_blocks",
                  "pinned_entries")
        out: Dict[str, Any] = {k: sum(int(r.get(k, 0))
                                      for r in reps.values())
                               for k in summed}
        first = next(iter(reps.values()))
        out["block_size"] = first.get("block_size")
        out["dedup_ratio"] = max(float(r.get("dedup_ratio", 1.0))
                                 for r in reps.values())
        # The host spill tier's occupancy and counters sum too, where a
        # replica runs one.
        spill_keys = ("host_entries", "host_blocks", "host_bytes",
                      "host_budget_bytes", "demotions_total",
                      "promotions_total", "promotion_races_total",
                      "demote_inflight", "promote_backlog_blocks")
        for k in spill_keys:
            if any(k in r for r in reps.values()):
                out[k] = sum(int(r.get(k, 0)) for r in reps.values())
        out["replicas"] = reps
        return out

    def slot_stats(self) -> Dict[str, Any]:
        """Summed occupancy over the live replicas with per-replica
        rows."""
        reps: Dict[str, Dict[str, Any]] = {}
        for key, engine in self.live_engines():
            fn = getattr(engine, "slot_stats", None)
            if callable(fn):
                reps[key] = fn()
        summed = ("queue_depth", "active_slots", "max_slots",
                  "preempted_total", "prefill_inflight",
                  "prefill_backlog_tokens")
        out: Dict[str, Any] = {k: sum(int(r.get(k, 0))
                                      for r in reps.values())
                               for k in summed}
        out["slot_occupancy"] = round(
            out["active_slots"] / max(1, out["max_slots"]), 3)
        out["replicas"] = reps
        return out

    def prefix_affinity(self, history) -> int:
        """Best parked-prefix match across the live replicas: the
        tier-level probe of the Router's cross-tier affinity (the tier
        holds a prefix if any replica does).  Tokenizes once."""
        best = 0
        ids = None
        for _key, engine in self.live_engines():
            peek = getattr(engine, "prefix_affinity_tokens", None)
            if not callable(peek):
                continue
            if ids is None:
                ids = engine.affinity_token_ids(history)
            best = max(best, int(peek(ids)))
        return best


class _ReplicaStream:
    """Stream wrapper feeding the replica breaker its completion verdict
    (a death mid-decode is a failure; a consumer disconnect is not the
    replica's fault).  Iteration and ``.result`` forward to the tier
    handle."""

    def __init__(self, handle, on_done):
        self._handle = handle
        self._on_done = on_done
        self._fired = False

    def _fire(self, ok: bool) -> None:
        if not self._fired:
            self._fired = True
            self._on_done(ok)

    def __iter__(self):
        try:
            for delta in self._handle:
                yield delta
        except GeneratorExit:
            self._fire(True)              # client disconnect: replica fine
            raise
        except BaseException:
            self._fire(False)
            raise
        self._fire(True)

    @property
    def result(self):
        return self._handle.result


def fail_captured(reqs: Sequence[Any], tier_name: str) -> int:
    """Last-resort release of a rescue capture: no sibling adopted the
    requests and the restarted engine cannot take them, so each fails with
    the engine-stopped error shape (the outcome without a rescue).
    Blocked callers unblock; streams see the end-of-stream sentinel.
    Returns the number failed."""
    from ..engine.batching import EngineStoppedError
    n = 0
    for req in reqs:
        req.error = EngineStoppedError(error_dict(
            f"Request failed: tier {tier_name} engine stopped mid-flight"))
        tq = getattr(req, "token_queue", None)
        if tq is not None:
            tq.put(None)
        req.done.set()
        n += 1
    return n


class ReplicatedTierClient:
    """The tier client over N replica TierClients: the TierClient surface
    (``process``, ``process_stream``, ``load_snapshot``,
    ``server_manager``, ``tier``, ``name``), with dispatch choosing a
    replica per request (affinity, then least-loaded, behind the
    per-replica breaker), ``scale_to`` for the autoscaler and
    ``restart_replica`` for the HealthMonitor.  ``policy``: ``affinity``,
    ``load`` or ``random`` forces a dispatch policy; None takes
    ``affinity`` when ``tier.replica_affinity`` is set, else ``load``."""

    def __init__(self, tier: TierConfig, cluster: ClusterConfig,
                 device: DeviceLike = None,
                 fault_injector: Optional[FaultInjector] = None,
                 warmup_on_start: bool = True, seed: int = 0,
                 policy: Optional[str] = None,
                 mesh: Optional[DeviceGroup] = None):
        if tier.replicas < 1:
            raise ValueError(f"tier {tier.name}: replicas must be >= 1, "
                             f"got {tier.replicas}")
        tier.check_ported()
        if tier.ep > 1 or tier.sp > 1:
            # Replica groups are tp-only: say so rather than look as if
            # expert or sequence parallelism were in effect (JAX's rule).
            logger.warning(
                "tier %s: ep=%d sp=%d IGNORED — replicated tiers build "
                "tp-only submeshes per replica (replicas=%d wins); set "
                "replicas=1 to keep expert/sequence parallelism",
                tier.name, tier.ep, tier.sp, tier.replicas)
        if policy is not None and policy not in _POLICIES:
            raise ValueError(f"replica policy {policy!r} is not one of "
                             f"{_POLICIES}")
        self.tier = tier
        self.name = tier.name
        self.faults = fault_injector
        self.policy = policy
        n = tier.replicas
        if tier.autoscale:
            # An elastic tier starts at the autoscaler's capacity floor.
            n = max(n, tier.autoscale_min_replicas)
        self._devices = (list(mesh.devices) if mesh is not None
                         else [resolve_device(device)])
        self._tp_req = requested_tp(tier)
        self._seed = seed
        self._warmup_on_start = warmup_on_start
        groups = _split_devices(self._devices, n, self._tp_req)
        # Membership: ONE list of member records, shared by reference with
        # the ReplicaSetManager; readers take list() snapshots.
        self._members: List[_Replica] = []
        self._next_rid = 0
        # Scale operations and restarts are serialized by a busy flag
        # claimed under the lock; the work itself (warmup, quiesce,
        # capture, rebuild) runs with no lock held, so dispatch and an
        # overlapping caller never block on it.
        self._scale_lock = threading.Lock()
        self._scaling = False
        for i in range(n):
            self._members.append(self._build_replica(self._mint_rid(),
                                                     groups[i]))
        # The warm standby pool (autoscale tiers): the replicas between
        # min and max are built here, warmed by start_server and parked
        # off membership, so a scale-up publishes a warm engine in
        # milliseconds and a scale-down parks the drained one.
        self._standby: List[_Replica] = []
        if tier.autoscale and tier.autoscale_warm_pool:
            n_max = max(n, tier.autoscale_max_replicas)
            for k in range(n, n_max):
                self._standby.append(self._build_replica(
                    self._mint_rid(), self._device_group(k, n_max)))
        self.server_manager = ReplicaSetManager(tier, members=self._members,
                                                standby=self._standby)
        # The per-replica breaker sub-gate, with the cluster's thresholds;
        # the Router's tier-level breaker still owns whole-tier shedding.
        self.breaker = CircuitBreaker(
            [r.name for r in self._members],
            failure_threshold=cluster.breaker_failures,
            cooldown_s=cluster.breaker_cooldown_s)
        self._rr_lock = threading.Lock()
        self._rr = 0
        self._rng = random.Random(seed ^ 0x5EED)
        self._last_client: Optional[TierClient] = None
        # The observability bundle, resolved at use so a caller can inject
        # one after construction (default: the process-global one).
        self.obs = None

    # -- membership ----------------------------------------------------------

    @property
    def clients(self) -> List[TierClient]:
        return [r.client for r in list(self._members)]

    def replica_count(self) -> int:
        return len(self._members)

    def _mint_rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def _build_replica(self, rid: int, group: List) -> _Replica:
        """One replica's EngineManager and TierClient (not started).  The
        ENGINE side carries the replica-suffixed tier name (logs, metric
        labels such as ``dllm_compiled_programs{tier="nano/r0"}``,
        profiler timelines); the CLIENT keeps the base name, so error
        shapes, fault targeting and spans read as the tier's."""
        rtier = dataclasses.replace(
            self.tier, name=f"{self.tier.name}/{replica_name(rid)}")
        # A row of several slots is the replica's own tp group, at the
        # tier's degree at most.
        mgr = EngineManager(rtier, seed=self._seed,
                            warmup_on_start=self._warmup_on_start,
                            device=group[0],
                            group=(tp_mesh(group, min(self._tp_req,
                                                      len(group)))
                                   if len(group) > 1 else None))
        client = TierClient(rtier, mgr, self.faults)
        client.name = self.tier.name
        return _Replica(rid, client, mgr)

    def _metrics(self):
        return (self.obs or get_observability()).m

    # -- elastic membership ---------------------------------------------------

    def scale_to(self, n: int, reason: str = "manual",
                 timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Actuate membership to ``n`` replicas (at least 1).  One scale
        operation at a time: an overlapping call returns a ``busy`` error
        at once (the autoscaler retries a refused actuation).  Scale-up
        publishes warm standbys first, then builds and warms the rest
        concurrently and publishes them (deferred go-live).  Scale-down
        retires the least-affine replica: membership removal first, a
        bounded quiesce, the demote sweep and the spill handoff to a
        survivor, then park or drain-and-stop."""
        n = max(1, int(n))
        summary: Dict[str, Any] = {"target": n, "reason": reason,
                                   "added": [], "removed": [],
                                   "errors": []}
        with self._scale_lock:
            if self._scaling:
                summary["errors"].append("busy: scale in progress")
                summary["replicas"] = len(self._members)
                return summary
            self._scaling = True
        try:
            cur = len(self._members)
            if cur < n:
                self._scale_up(n, summary)
            elif cur > n:
                while len(self._members) > n:
                    info = self._scale_down_one(timeout_s)
                    if info is None:
                        break
                    summary["removed"].append(info)
        finally:
            with self._scale_lock:
                self._scaling = False
        summary["replicas"] = len(self._members)
        return summary

    def _scale_up(self, n: int, summary: Dict[str, Any]) -> None:
        """Add members up to ``n`` (busy flag claimed, no lock held)."""
        while len(self._members) < n and self._standby:
            r = self._standby.pop(0)
            try:
                if self.faults is not None:
                    # An injected publish failure: the parked engine is
                    # lost, and the loop falls through to fresh capacity.
                    fail = self.faults.standby_publish_fail(self.name)
                    if fail is not None:
                        raise RuntimeError(fail)
                r.mgr.start_server()     # idempotent: a no-op when warm
                self.breaker.ensure(r.name)
            except BaseException as exc:
                # Neither standby nor member now: stop it or it leaks.
                try:
                    r.mgr.stop_server()
                except Exception:
                    pass
                summary["errors"].append(f"{r.name}: {exc}")
                continue
            self._members.append(r)
            summary["added"].append(r.name)
            logger.info("tier %s: replica %s live (scale-up from warm "
                        "standby, %s)", self.name, r.name,
                        summary.get("reason"))
        count = len(self._members)
        fresh = [self._build_replica(self._mint_rid(),
                                     self._device_group(count + k, n))
                 for k in range(n - count)]
        errors: Dict[int, Optional[BaseException]] = {r.rid: None
                                                      for r in fresh}
        threads = []
        for r in fresh:
            def _warm(r=r):
                try:
                    r.mgr.start_server()
                except BaseException as exc:
                    errors[r.rid] = exc
            t = threading.Thread(target=_warm, daemon=True,
                                 name=f"warm-{self.name}-{r.name}")
            threads.append(t)
            t.start()
        for t in threads:
            t.join()
        for r in fresh:
            if errors[r.rid] is not None:
                summary["errors"].append(f"{r.name}: {errors[r.rid]}")
                try:
                    r.mgr.stop_server()
                except Exception:
                    pass
                continue
            # Breaker key first (a keyless replica would pass ungated),
            # then the atomic membership append.
            self.breaker.ensure(r.name)
            self._members.append(r)
            summary["added"].append(r.name)
            logger.info("tier %s: replica %s live (scale-up, %s)",
                        self.name, r.name, summary.get("reason"))

    def _device_group(self, slot: int, count: int) -> List:
        """The device slice of a new replica at position ``slot`` of
        ``count`` (on one card, the card)."""
        groups = _split_devices(self._devices, count, self._tp_req)
        return groups[slot] if slot < len(groups) else self._devices

    def _pick_victim(self) -> Optional[_Replica]:
        """The least-affine live replica: fewest parked prefix tokens,
        then least in-flight work, then the youngest rid."""
        members = list(self._members)
        if len(members) <= 1:
            return None

        def score(rec: _Replica):
            parked = 0
            engine = getattr(rec.mgr, "_engine", None)
            cache = getattr(engine, "prefix_cache", None)
            if cache is not None:
                parked = sum(len(e.ids) for e in cache.entries_snapshot())
            snap = rec.client.load_snapshot()
            busy = (int(snap.get("queue_depth", 0))
                    + int(snap.get("active_slots", 0)))
            return (parked, busy, -rec.rid)

        return min(members, key=score)

    def _scale_down_one(
            self, timeout_s: Optional[float]) -> Optional[Dict[str, Any]]:
        """Retire one replica (busy flag claimed).  The order is the
        correctness argument: (1) membership removal, no new dispatch;
        (2) a bounded quiesce, finishing requests park their prefixes;
        (3) the demote sweep and spill handoff, before a drain stops the
        engine's demotions; (4) park or drain-and-stop; (5) the breaker
        key retired."""
        victim = self._pick_victim()
        if victim is None:
            return None
        self._members.remove(victim)      # atomic: dispatch stops here
        try:
            return self._retire(victim, timeout_s)
        except BaseException:
            # Out of membership and never re-homed: this is the last
            # reference to a live server.
            if victim not in self._standby:
                try:
                    victim.mgr.stop_server()
                except Exception:
                    pass
                self.breaker.forget(victim.name)
            raise

    def _retire(self, victim: _Replica,
                timeout_s: Optional[float]) -> Dict[str, Any]:
        """Quiesce, demote and hand off, then park or drain one removed
        member (the caller owns the unwind)."""
        timeout = (timeout_s if timeout_s is not None
                   else self.tier.drain_timeout_s)
        deadline = time.monotonic() + max(0.5, float(timeout))

        def quiet() -> bool:
            snap = victim.client.load_snapshot()
            return not snap.get("queue_depth") and not snap.get(
                "active_slots")

        while time.monotonic() < deadline and not quiet():
            time.sleep(0.05)
        demoted = handed = 0
        engine = getattr(victim.mgr, "_engine", None)
        if engine is not None:
            sweep = getattr(engine, "demote_parked", None)
            if callable(sweep):
                demoted = int(sweep() or 0)
            spill = getattr(engine, "kv_spill", None)
            if spill is not None:
                spill.flush(timeout_s=5.0)
                target = self._spill_target(exclude=victim)
                if target is not None:
                    for ids, tiles, nbytes, nb in spill.export_resident():
                        if target.admit_resident(ids, tiles, nbytes, nb):
                            handed += 1
        # A quiesced victim of a warm-pool tier parks (engine kept warm,
        # off membership) for the next scale-up; one still busy at the
        # deadline drains and stops, since a parked engine with live
        # work would hide those requests from every aggregate.
        parked = (self.tier.autoscale and self.tier.autoscale_warm_pool
                  and quiet())
        drain = None
        if parked:
            self._standby.append(victim)
        else:
            try:
                drain = victim.mgr.drain(
                    timeout_s=max(0.5, deadline - time.monotonic()))
            except Exception as exc:
                # A failed drain still retires the replica.
                try:
                    victim.mgr.stop_server()
                except Exception:
                    pass
                drain = {"error": f"Request failed: {exc}"}
        self.breaker.forget(victim.name)
        logger.info("tier %s: replica %s %s (scale-down; %d entries "
                    "demoted, %d handed off)", self.name, victim.name,
                    "parked to warm standby" if parked else "retired",
                    demoted, handed)
        return {"replica": victim.name, "demoted_entries": demoted,
                "handed_off": handed, "parked": parked,
                "drained": (drain or {}).get("drained", 0)
                if isinstance(drain, dict) else 0}

    def _spill_target(self, exclude: _Replica):
        """A survivor's spill store for a restarted replica's resident
        entries: the first other live member with one (host tiles are in
        pool layout, the same across replicas of one configuration)."""
        for rec in list(self._members):
            if rec is exclude:
                continue
            engine = getattr(rec.mgr, "_engine", None)
            spill = getattr(engine, "kv_spill", None)
            if spill is not None:
                return spill
        return None

    # -- crash rescue ---------------------------------------------------------

    def restart_replica(self, rid: int,
                        reason: str = "wedged") -> Dict[str, Any]:
        """Restart ONE replica's engine with crash rescue: its queued and
        in-flight requests are captured (prompt and emitted tokens) and
        resumed on a live sibling, or re-queued on the restarted engine
        when the tier has no other, continuing on the same greedy tokens;
        the host spill store survives the restart (detached before the
        stop, re-attached after, or handed to a sibling).  One restart at
        a time: an overlapping call returns a ``busy`` error, and the
        HealthMonitor keeps the failure streak and retries at its next
        probe."""
        summary: Dict[str, Any] = {
            "replica": replica_name(rid), "reason": reason,
            "restarted": False, "rescued": 0, "outcome": None,
            "spill_reattached": False, "errors": []}
        with self._scale_lock:
            if self._scaling:
                summary["errors"].append("busy: scale in progress")
                return summary
            self._scaling = True
        try:
            victim = next((r for r in list(self._members) if r.rid == rid),
                          None)
            if victim is None:
                summary["errors"].append(f"{replica_name(rid)}: not a "
                                         "member")
                return summary
            engine = getattr(victim.mgr, "_engine", None)
            spill = None
            if self.tier.spill_survive_restart and hasattr(engine,
                                                           "detach_spill"):
                spill = engine.detach_spill()
            captured: List[Any] = []
            if self.tier.replica_rescue and hasattr(engine,
                                                    "capture_requests"):
                captured = engine.capture_requests()
            self._rescue_and_restart(victim, captured, spill, summary)
            return summary
        finally:
            with self._scale_lock:
                self._scaling = False

    def _rescue_and_restart(self, victim: _Replica, captured: List[Any],
                            spill: Any, summary: Dict[str, Any]) -> None:
        """Restart ``victim``'s engine and re-home its captured work.  The
        rescue runs FIRST when a sibling lives, so the rebuild's seconds
        never sit between a stalled stream and its resumption.  A failed
        rebuild raises into nothing: it is recorded in ``errors`` and
        ``restarted`` stays False (the HealthMonitor counts it)."""
        sibling = None
        if captured:
            for rec in list(self._members):
                if rec is victim or not rec.mgr.is_server_running():
                    continue
                eng = getattr(rec.mgr, "_engine", None)
                if callable(getattr(eng, "adopt_requests", None)):
                    sibling = rec
                    break
            if sibling is not None:
                summary["rescued"] = sibling.mgr._engine.adopt_requests(
                    captured)
                summary["outcome"] = "sibling"
                self._note_rescue(captured, "sibling", sibling.name)
        try:
            victim.mgr.stop_server()
            victim.mgr.start_server()
            summary["restarted"] = True
        except Exception as exc:
            logger.exception("tier %s: replica %s restart failed",
                             self.name, victim.name)
            summary["errors"].append(f"{victim.name}: restart: {exc}")
        new_engine = (getattr(victim.mgr, "_engine", None)
                      if summary["restarted"] else None)
        if spill is not None:
            adopt = getattr(new_engine, "adopt_spill", None)
            if callable(adopt) and adopt(spill):
                summary["spill_reattached"] = True
                self._metrics().spill_reattach.labels(self.name).inc()
            else:
                # The rebuilt engine refused (restart failed, or another
                # geometry): hand the warm entries to a survivor, then
                # stop the orphan store.
                target = self._spill_target(exclude=victim)
                handed = 0
                if target is not None:
                    for ids, tiles, nbytes, nb in spill.export_resident():
                        if target.admit_resident(ids, tiles, nbytes, nb):
                            handed += 1
                summary["spill_handed_off"] = handed
                spill.stop()
        if captured and sibling is None:
            adopt_reqs = getattr(new_engine, "adopt_requests", None)
            if callable(adopt_reqs):
                summary["rescued"] = adopt_reqs(captured)
                summary["outcome"] = "requeue"
                self._note_rescue(captured, "requeue", victim.name)
            else:
                fail_captured(captured, self.name)
                summary["outcome"] = "failed"
                self._note_rescue(captured, "failed", victim.name)
        if summary["restarted"]:
            self.breaker.reset(victim.name)
        logger.info("tier %s: replica %s restarted=%s rescued=%d (%s) "
                    "spill_reattached=%s (%s)", self.name, victim.name,
                    summary["restarted"], summary["rescued"],
                    summary["outcome"], summary["spill_reattached"],
                    summary["reason"])

    def _note_rescue(self, captured: List[Any], outcome: str,
                     by: str) -> None:
        """One counter bump per request, and a ``rescue`` span event so a
        flight-recorder entry shows who saved the request."""
        self._metrics().replica_rescues.labels(self.name, outcome).inc(
            len(captured))
        for req in captured:
            obs_spans.event(getattr(req, "trace", None), "rescue",
                            tier=self.name, outcome=outcome, by=by)

    # -- dispatch policy ----------------------------------------------------

    def _policy(self) -> str:
        if self.policy in _POLICIES:
            return self.policy
        return "affinity" if self.tier.replica_affinity else "load"

    def _predicted_waits(self) -> List[Tuple[float, int]]:
        """(predicted queue wait s, inflight) per replica, from each
        replica's own admission controller."""
        out = []
        for c in self.clients:
            snap = c.admission.snapshot()
            ewma_s = (snap.get("ewma_service_ms") or 0.0) / 1000.0
            wait = (snap["queue_depth"] / max(1, snap["slots"])) * ewma_s
            out.append((wait, int(snap["inflight"])))
        return out

    def _affinity_scores(self, history) -> List[int]:
        """Parked-prefix match tokens per replica: tokenize once with the
        first live engine, peek every live replica with the same ids
        (stopped replicas score 0; the probe never starts an engine)."""
        members = list(self._members)
        scores = [0] * len(members)
        ids = None
        for i, r in enumerate(members):
            engine = getattr(r.mgr, "_engine", None)
            peek = getattr(engine, "prefix_affinity_tokens", None)
            if not callable(peek) \
                    or getattr(engine, "prefix_cache", None) is None:
                continue            # no cache: never pay tokenization
            if ids is None:
                ids = engine.affinity_token_ids(history)
            scores[i] = int(peek(ids))
        return scores

    def _pick_replica(self, history,
                      members: Optional[List[_Replica]] = None
                      ) -> Tuple[int, str]:
        """(index into the membership snapshot, how): how is one of
        single, affinity, affinity_overridden, least_loaded, random,
        breaker_fallback."""
        if members is None:
            members = list(self._members)
        n = len(members)
        if n == 1:
            return 0, "single"
        waits = self._predicted_waits()
        if len(waits) < n:
            waits = waits + [(0.0, 0)] * (n - len(waits))
        with self._rr_lock:
            rr = self._rr
            self._rr += 1
            # Drawn under the lock even when unused: Random is not thread
            # safe, and an unconditional draw keeps the sequence
            # deterministic per request index.
            shuffled = self._rng.sample(range(n), n)
        order = sorted(range(n),
                       key=lambda i: (waits[i][0], waits[i][1],
                                      (i - rr) % n))
        how = "least_loaded"
        policy = self._policy()
        if policy == "random":
            order = shuffled
            how = "random"
        elif policy == "affinity":
            scores = self._affinity_scores(history)
            if len(scores) < n:
                scores = scores + [0] * (n - len(scores))
            best = max(range(n), key=lambda i: (scores[i], -waits[i][0]))
            if scores[best] >= self.tier.replica_affinity_min_tokens:
                least = order[0]
                if (waits[best][0] - waits[least][0]
                        <= self.tier.replica_affinity_override_s):
                    order.remove(best)
                    order.insert(0, best)
                    how = "affinity"
                else:
                    # The affine replica is too hot: locality yields.
                    how = "affinity_overridden"
        for idx in order:
            if self.breaker.allow(members[idx].name):
                return idx, (how if idx == order[0] else "breaker_fallback")
        # Every replica's circuit is open: dispatch the best candidate
        # anyway (whole-tier shedding is the Router's breaker's job).
        return order[0], "breaker_fallback"

    def _note_route(self, member: _Replica, how: str) -> None:
        obs_spans.annotate(current_trace(), replica=member.name,
                           replica_policy=how)
        self._metrics().replica_routed.labels(self.name, how).inc()

    def _feed_breaker(self, member, raw: Any) -> None:
        """A sync or setup outcome into the replica breaker.  Admission
        rejections are breaker-neutral (healthy backpressure) but repay a
        half-open canary permit.  ``member`` is the dispatched record or a
        positional index into the membership."""
        if isinstance(member, _Replica):
            key = member.name
        else:
            members = list(self._members)
            i = int(member)
            key = (members[i].name if 0 <= i < len(members)
                   else replica_name(i))
        if is_error_shape(raw):
            if "admission rejected" in str(raw.get("error", "")):
                self.breaker.release_probe(key)
            else:
                self.breaker.record(key, False)
        else:
            self.breaker.record(key, True)

    def reset_replica(self, rid: int) -> None:
        """Force-close one replica's circuit (after the HealthMonitor
        restarted its engine)."""
        self.breaker.reset(replica_name(rid))

    def member_manager(self, rid: int) -> Optional[EngineManager]:
        """The EngineManager behind member ``rid``, or None.  The
        HealthMonitor compares it with its probe snapshot by identity
        before it routes a restart through ``restart_replica``."""
        for r in list(self._members):
            if r.rid == rid:
                return r.mgr
        return None

    def healthy_replicas(self) -> int:
        """Replicas able to serve now: running, not draining, not stalled
        past the watchdog, circuit not open (lock-free reads: the sampler
        calls this at its cadence)."""
        n = 0
        for r in list(self._members):
            if not r.mgr.is_server_running() or r.mgr.draining:
                continue
            if self.breaker.state(r.name) == OPEN:
                continue
            engine = getattr(r.mgr, "_engine", None)
            stall = getattr(engine, "progress_stall_s", None)
            deadline = self.tier.watchdog_stall_s
            if (callable(stall) and deadline is not None
                    and float(stall()) > deadline):
                continue
            n += 1
        return n

    # -- request surface (TierClient parity) --------------------------------

    def _dispatch(self, history) -> _Replica:
        members = list(self._members)
        idx, how = self._pick_replica(history, members=members)
        member = members[min(idx, len(members) - 1)]
        self._note_route(member, how)
        self._last_client = member.client
        return member

    def process(self, history) -> Dict[str, Any]:
        member = self._dispatch(history)
        raw = member.client.process(history)
        self._feed_breaker(member, raw)
        return raw

    def process_stream(self, history):
        member = self._dispatch(history)
        handle = member.client.process_stream(history)
        if is_error_shape(handle):
            self._feed_breaker(member, handle)
            return handle
        key = member.name
        return _ReplicaStream(handle,
                              lambda ok: self.breaker.record(key, ok))

    def load_snapshot(self) -> Dict[str, Any]:
        """Tier-level load: the sum over replicas (perf routing reads one
        row per tier)."""
        out = {"queue_depth": 0, "active_slots": 0, "max_slots": 0}
        for c in self.clients:
            snap = c.load_snapshot()
            for k in out:
                out[k] += int(snap.get(k, 0))
        return out

    @property
    def last_result(self):
        c = self._last_client
        return c.last_result if c is not None else None

    @property
    def admission(self):
        """The last-dispatched replica's admission controller (each
        replica's lives on its client in ``clients``)."""
        c = self._last_client or self.clients[0]
        return c.admission
