"""Router: the two-tier serving pipeline behind ``/chat``.

Counterpart of ``distributed_llm_tpu/serving/router.py`` with the same
``route_query(history) -> (response_dict, tokens, device)`` contract and
response-dict keys, over in-process tier clients (serving/tiers.py) on
one device.  The stages:

0. response cache (production mode; key = strategy + query text,
   deliberately context-independent);
1. the routing decision (``QueryRouter``), with the context-size
   threshold fallback if it raises; prefix affinity may steer a
   low-confidence decision UP to the tier holding the conversation's
   parked KV; the circuit breaker vetoes an open tier (both open: the
   degraded response); the dispatching tier's context-overflow policy;
2. inference with a bounded retry of transient error shapes and a
   one-shot failover to the other tier on an error-shaped response;
3. text normalization and token count; 4. perf feedback; 5. the
   response-cache store.

``route_query_stream`` is the streaming twin: the same decision stage,
veto and overflow policy, failover at stream setup and mid-stream (the
already-delivered prefix replayed silently on the survivor), perf and
breaker feedback when the stream completes.

Observability (obs/): each request gets a span tree bound to its thread
(``use_trace``) that the tiers and engines extend, and leaves through the
single exit ``_finish_request``, which feeds the metrics, the SLO monitor
(goodput windows and overload incidents), the flight recorder and the
bounded per-(tier, strategy, session) cost ledger of the device time the
batched engines attributed to it.  A state sampler thread (started at the
first request, stopped by ``drain``) keeps a timeline of each tier's load
and mirrors it to gauges; ``profiler_trace`` renders the engines'
tick-phase rings as Chrome-trace JSON.  The JAX package's env knobs are
arguments: ``sample_ms`` (0 turns the sampler off) and
``timeline_samples``; the SLO targets are the tiers' ``slo_ttft_ms`` and
``slo_tbt_ms``.

The fleet: a ``FaultInjector`` (utils/faults.py) reaches every tier
client; ``enable_health_monitor`` in the config starts a
``HealthMonitor`` (serving/health.py) that probes every
``health_interval_s`` and restarts wedged engines, replica by replica on
a replicated tier (``replicas > 1``: serving/replicas.py), whose replicas
get their own sampler entries (``tier/rN``), trace threads and
``dllm_replica_*`` series.  A tier with ``autoscale`` gets a
``ReplicaAutoscaler`` (serving/autoscaler.py; ``autoscale=False`` here,
JAX's ``DLLM_AUTOSCALE=0``, disarms every tier), stopped by ``drain``
before the tiers; a tier with an ``endpoint`` is a remote ``/query``
server (serving/remote.py).

Tenants: ``route_query(..., tenant_id=...)`` stamps the tenant on the
trace, where the tier clients' quota layer (serving/tenants.py) and the
engines read it; a request without one bills to the ``default`` tenant.
``_finish_request`` feeds the tenant's SLO window, its
``dllm_tenant_device_time_ms_total`` and ``_kv_block_ticks_total``, the
cost ledger's tenant key, and debits the measured device time from the
serving tier's token bucket; a tenant-quota refusal counts on
``dllm_tenant_rejected_total`` and opens a ``tenant_overquota``
flight-recorder incident that the tenant's next completed request
closes.

Not ported (ROADMAP.md): the cross-host health exchange
(``health_mesh``).
"""

from __future__ import annotations

import hashlib
import logging
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..config import ClusterConfig, resolve_config
from ..device import DeviceLike, resolve_device
from ..obs import Observability, get_observability
from ..obs import profiler as obs_profiler
from ..obs import spans as obs_spans
from ..obs.metrics import BoundedLabels, breaker_state_value
from ..obs.sampler import SystemStateSampler
from ..obs.slo import SLOMonitor
from ..obs.spans import current_trace, use_trace
from ..routing.engine import QueryRouter
from ..routing.token_counter import TokenCounter
from ..utils.faults import FaultInjector
from .errors import is_error_shape
from .tenants import DEFAULT_TENANT
from .tiers import TierClient, build_tiers

logger = logging.getLogger(__name__)

# Error-shape substrings the bounded retry treats as TRANSIENT (a fresh
# attempt on the same tier plausibly succeeds at once): connection-level
# races and an engine that shut down mid-flight.  Not timeouts (the call
# already spent its whole budget) and not admission rejections (failover
# is the productive move).
_TRANSIENT_MARKERS = (
    "connection refused",
    "connection reset",
    "reset by peer",
    "temporarily unavailable",
    "engine returned no result",
    "(transient)",
)


def default_cluster(device: DeviceLike = None) -> ClusterConfig:
    """The cluster a ``Router`` built without one serves, and the bench's:
    ``bench_cluster()`` (nano_1b and orin_8b) on the card, the tiny
    batched tiers (``tiny_batched_cluster()``) on the CPU, each tier on
    its preset's trained checkpoint where the repo has one
    (``with_default_checkpoints``), as the JAX package's
    ``default_cluster`` serves them.  Only the tiny presets have one, so
    the card's pair stays on seeded random weights."""
    from ..config import (bench_cluster, tiny_batched_cluster,
                          with_default_checkpoints)
    if resolve_device(device).type == "cuda":
        return with_default_checkpoints(bench_cluster())
    return with_default_checkpoints(tiny_batched_cluster())


class Router:
    def __init__(
        self,
        strategy: str = "hybrid",
        config: Optional[Dict[str, Any]] = None,
        threshold_fallback: int = 100,
        benchmark_mode: bool = False,
        cluster: Optional[ClusterConfig] = None,
        device: DeviceLike = None,
        observability: Optional[Observability] = None,
        sample_ms: float = 250.0,
        timeline_samples: int = 240,
        fault_injector: Optional[FaultInjector] = None,
        autoscale: bool = True,
    ):
        """strategy: "token" | "semantic" | "heuristic" | "hybrid" | "perf";
        benchmark_mode: True -> BENCHMARK_CFG (caches off), False ->
        PRODUCTION_CFG, unless ``config`` overrides.  ``cluster``: the
        tiers (default ``default_cluster(device)``).  ``device`` runs both
        tiers and the router's embedder (default: the card).
        ``observability``: the metric/trace/recorder bundle (default: the
        process-global one).  ``sample_ms``: the state sampler's period (0
        = no sampler); ``timeline_samples``: its ring.
        ``fault_injector``: scripted faults for every tier client.
        ``autoscale``: False disarms every tier's autoscaler (JAX's
        ``DLLM_AUTOSCALE=0``); True arms each tier that sets
        ``TierConfig.autoscale``."""
        self.token_counter = TokenCounter()
        self.device = resolve_device(device)
        self.obs = (observability if observability is not None
                    else get_observability())
        self.threshold_fallback = threshold_fallback
        self.benchmark_mode = benchmark_mode
        self.config = resolve_config(config, benchmark_mode)

        self.cluster = cluster or default_cluster(self.device)
        self.faults = fault_injector
        self.tiers: Dict[str, TierClient] = build_tiers(
            self.cluster, device=self.device, fault_injector=fault_injector)
        for tier in self.tiers.values():
            if hasattr(tier, "restart_replica"):
                # The replica dispatch and rescue series land in the
                # router's registry, beside the sampler's replica gauges.
                tier.obs = self.obs
        self.nano = self.tiers["nano"]
        self.orin = self.tiers["orin"]

        self.query_router = QueryRouter(strategy=strategy, config=self.config,
                                        device=device)

        # Per-tier circuit breaker, consulted before dispatch so an OPEN
        # tier sheds traffic at once instead of each request finding the
        # outage by a timeout; breaker_failures=0 disables it.
        self.breaker = None
        if self.cluster.breaker_failures:
            from .breaker import CircuitBreaker
            self.breaker = CircuitBreaker(
                [t.name for t in self.cluster.tiers()],
                failure_threshold=self.cluster.breaker_failures,
                cooldown_s=self.cluster.breaker_cooldown_s,
                on_transition=self._obs_breaker_transition)
            # A healthy breaker reads 0 from the start, not "no series".
            for t in self.cluster.tiers():
                self.obs.m.breaker_state.labels(t.name).set(0)
        # Bounded retry of transient error shapes, budgeted against the
        # dispatching tier's request_timeout_s.
        self.retry_attempts = max(0, int(self.cluster.retry_attempts))
        self.retry_backoff_s = float(self.cluster.retry_backoff_s)
        self.degraded_served = 0       # both-tiers-open responses served
        # Graceful drain: once True the serving edge answers 503 and no
        # new request enters the pipeline.
        self.draining = False

        # SLO goodput monitor, fed only from _finish_request.
        self.slo = SLOMonitor(self._slo_targets(), metrics=self.obs.m,
                              recorder=self.obs.recorder,
                              timeline=self._timeline_tail)
        # The state timeline: a daemon thread started at the first
        # request and stopped by drain().
        self.sampler: Optional[SystemStateSampler] = None
        if sample_ms > 0:
            self.sampler = SystemStateSampler(
                self._sampler_collect, metrics=self.obs.m,
                period_s=sample_ms / 1000.0, capacity=timeline_samples)
        # Bounded cost ledger per (tier, strategy, session): insertion-
        # ordered, the oldest key evicted past the cap.  Session ids are
        # client-controlled, so their metric labels are bounded too (past
        # the cap they aggregate under "~overflow").
        self._cost_lock = threading.Lock()
        self._cost_ledger: Dict[Tuple[str, str, str, str],
                                Dict[str, float]] = {}
        self._cost_ledger_cap = 256
        self._session_labels = BoundedLabels(cap=256)
        # Tenant over-quota incidents: a tenant's first quota refusal
        # opens a flight-recorder incident naming it, its next completed
        # request closes it with the refusals counted meanwhile.  At most
        # ``_tenant_incident_cap`` tenants are tracked at once.
        self._tenant_incidents: Dict[str, Dict[str, Any]] = {}
        self._tenant_incident_cap = 256

        self.enable_response_cache = (
            not benchmark_mode
            and bool(self.config.get("enable_response_cache", False)))
        self.cache_last_k = int(self.config.get("cache_last_k", 6))
        self.enable_failover = bool(self.config.get("enable_failover", True))
        # Prefix-affinity routing (production only): a low-confidence
        # decision is steered to the tier already holding this
        # conversation's parked KV prefix.
        self.enable_prefix_affinity = (
            not benchmark_mode
            and bool(self.config.get("enable_prefix_affinity", False)))
        self.prefix_affinity_min_confidence = float(
            self.config.get("prefix_affinity_min_confidence", 0.75))
        self.prefix_affinity_min_tokens = int(
            self.config.get("prefix_affinity_min_tokens", 32))
        self.prefix_affinity_overrides = 0
        self._response_store: Dict[str, Dict[str, Any]] = {}

        # Continuous liveness probing with automatic restart (off by
        # default, which keeps bench runs deterministic).
        self.health_monitor = None
        if self.config.get("enable_health_monitor", False):
            if self.config.get("health_mesh") is not None:
                raise NotImplementedError(
                    "health_mesh: the cross-host health exchange is not "
                    "ported to the PyTorch/CUDA package yet (see "
                    "ROADMAP.md A10)")
            from .health import HealthMonitor
            self.health_monitor = HealthMonitor(
                self, interval_s=float(self.config.get("health_interval_s",
                                                       5.0)))
            self.health_monitor.start()

        # Elastic capacity: one control loop per armed tier, actuating
        # replica membership from the SLO, queue and shed signals.
        self.autoscalers: Dict[str, Any] = {}
        if autoscale:
            from .autoscaler import ReplicaAutoscaler
            for t in self.cluster.tiers():
                client = self.tiers.get(t.name)
                if t.autoscale and callable(getattr(client, "scale_to",
                                                    None)):
                    scaler = ReplicaAutoscaler(t.name, t, client, self.slo,
                                               metrics=self.obs.m)
                    scaler.start()
                    self.autoscalers[t.name] = scaler

    # -- graceful drain ----------------------------------------------------

    def drain_retry_after_s(self) -> float:
        """Client retry hint while draining: the longest tier drain
        deadline."""
        vals = [float(t.tier.drain_timeout_s) for t in self.tiers.values()
                if t.tier is not None and t.tier.drain_timeout_s]
        return round(max(vals), 2) if vals else 30.0

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful shutdown: flip the serving edge to 503, then drain
        every tier concurrently (each stops admitting, lets its in-flight
        requests finish under ``drain_timeout_s`` and stops).  Idempotent;
        returns the per-tier drain summaries.  The health monitor stops
        first: a drain must not race an automatic restart."""
        self.draining = True
        if self.health_monitor is not None:
            self.health_monitor.stop()
        # The autoscalers stop before the tiers drain: a controller
        # mid-tick must not move membership on a draining tier.
        for scaler in self.autoscalers.values():
            scaler.stop()
        # The state sampler dies with the router.
        if self.sampler is not None:
            self.sampler.stop()
        results: Dict[str, Any] = {}
        cap = (timeout_s if timeout_s is not None
               else self.drain_retry_after_s()) + 30.0
        threads = []
        for name, tier in self.tiers.items():
            mgr = tier.server_manager

            def _drain(name=name, mgr=mgr):
                try:
                    if callable(getattr(mgr, "drain", None)):
                        results[name] = mgr.drain(timeout_s)
                    else:
                        # A remote tier has no drain: stop it, so a
                        # process it spawned does not outlive the router.
                        mgr.stop_server()
                        results[name] = {"draining_started": False,
                                         "stopped": True}
                except Exception as exc:
                    results[name] = {"error": f"Request failed: {exc}"}

            t = threading.Thread(target=_drain, daemon=True,
                                 name=f"drain-{name}")
            threads.append(t)
            t.start()
        deadline = time.monotonic() + cap
        for t in threads:
            # Bounded even against a wedged stop: the process is exiting.
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        logger.info("router drain complete: %s", results)
        return results

    # -- observability plumbing (obs/) -------------------------------------

    def _obs_breaker_transition(self, tier: str, old: str, new: str) -> None:
        """Breaker state changes -> transition counter + state gauge."""
        m = self.obs.m
        m.breaker_transitions.labels(tier, new).inc()
        m.breaker_state.labels(tier).set(breaker_state_value(new))

    def _slo_targets(self) -> Dict[str, Tuple[Optional[float],
                                              Optional[float]]]:
        """Per-tier (slo_ttft_ms, slo_tbt_ms) goodput targets."""
        return {t.name: (t.slo_ttft_ms, t.slo_tbt_ms)
                for t in self.cluster.tiers()}

    def _ensure_sampler(self) -> None:
        """Start the sampler at the first request: routers that never
        serve spawn no thread."""
        s = self.sampler
        if s is not None and not s.running and not self.draining:
            s.start()

    def _timeline_tail(self, n: int = 40) -> list:
        s = self.sampler
        return s.tail(n) if s is not None else []

    def timeline_snapshot(self) -> list:
        """The GET /stats?timeline=1 body: the whole timeline ring,
        sampled once on demand when it is empty (an idle router still
        answers with its current state)."""
        s = self.sampler
        if s is None:
            return []
        if not len(s):
            s.sample_once()
        return s.snapshot()

    def _sampler_collect(self) -> Dict[str, Dict[str, Any]]:
        """One timeline sample's per-tier state: lock-free or own-locked
        in-memory reads only (load_snapshot, kv_stats, the tick ring, the
        draining flag), never the lifecycle lock a starting engine holds:
        the sampler must keep sampling through the states it explains.  A
        replicated tier's entry reads the aggregate pool picture (one
        ``kv_stats`` pass, whose per-replica breakdown the replica entries
        reuse), its healthy and live replica counts, and each replica gets
        an entry of its own keyed ``tier/rN``."""
        out: Dict[str, Dict[str, Any]] = {}
        breaker_snap = (self.breaker.snapshot()
                        if self.breaker is not None else {})
        for name, tier in self.tiers.items():
            st: Dict[str, Any] = self._load_of(tier)
            mgr = tier.server_manager
            items_fn = getattr(mgr, "replica_items", None)
            if callable(items_fn):
                agg_kv = mgr.kv_stats()
                st.update(self._collect_engine_state(mgr, kv=agg_kv))
                st["replica_healthy"] = int(tier.healthy_replicas())
                mgr_by_key = {f"r{rid}": sub for rid, sub in items_fn()}
                st["replica_count"] = len(mgr_by_key)
                rep_kv = (agg_kv or {}).get("replicas") or {}
                for key, engine in mgr.live_engines():
                    rst = self._collect_engine_state(engine,
                                                     kv=rep_kv.get(key))
                    ss = engine.slot_stats()
                    for k in ("queue_depth", "active_slots", "max_slots"):
                        rst[k] = ss.get(k)
                    sub = mgr_by_key.get(key)
                    if sub is not None:
                        rst["draining"] = bool(sub.draining)
                    rst["breaker"] = tier.breaker.state(key)
                    out[f"{name}/{key}"] = rst
            else:
                st.update(self._collect_engine_state(
                    getattr(mgr, "_engine", None)))
            st["draining"] = bool(getattr(mgr, "draining", False))
            b = breaker_snap.get(name)
            if b is not None:
                st["breaker"] = b.get("state")
            out[name] = st
        return out

    @staticmethod
    def _load_of(tier) -> Dict[str, Any]:
        """A tier client's load snapshot; a remote tier has none (its
        load lives in the other process), as in the JAX router."""
        fn = getattr(tier, "load_snapshot", None)
        return dict(fn()) if callable(fn) else {}

    _KV_FETCH = object()      # sentinel: "read kv_stats off the engine"

    @staticmethod
    def _collect_engine_state(engine, kv=_KV_FETCH) -> Dict[str, Any]:
        """One engine's (or a replica set's aggregate's) sampler fields:
        pool pressure and sharing, the prefill backlog, the tick p50, the
        speculation accept ratio (once a draft ran) and the profiler's
        per-phase p50 self-times and coverage over its last 128 records.
        Engines without a surface (the sequential ones) contribute what
        they have.  ``kv``: a kv_stats dict read already (None: no
        pool)."""
        st: Dict[str, Any] = {}
        if kv is Router._KV_FETCH:
            kv_fn = getattr(engine, "kv_stats", None)
            ks = kv_fn() if callable(kv_fn) else None
        else:
            ks = kv
        if ks:
            st["kv_free_blocks"] = ks.get("free_blocks")
            st["kv_reclaimable_blocks"] = ks.get("reclaimable_blocks")
            st["kv_shared_blocks"] = ks.get("shared_blocks", 0)
            st["kv_dedup_ratio"] = ks.get("dedup_ratio", 1.0)
            st["preempted_total"] = ks.get("preempted_total", 0)
            if "host_blocks" in ks:
                # The host spill tier's occupancy and promotion backlog.
                st["kv_host_blocks"] = ks.get("host_blocks")
                st["kv_host_bytes"] = ks.get("host_bytes")
                st["kv_promote_backlog"] = ks.get("promote_backlog_blocks",
                                                  0)
            st["prefill_backlog_tokens"] = ks.get("prefill_backlog_tokens",
                                                  0)
        tick_fn = getattr(engine, "tick_stats", None)
        if callable(tick_fn):
            st["decode_tick_p50_ms"] = tick_fn().get("p50_ms")
        spec_fn = getattr(engine, "spec_stats", None)
        if callable(spec_fn):
            ss = spec_fn()
            if ss.get("enabled") and ss.get("accept_ratio") is not None:
                st["spec_accept_ratio"] = ss["accept_ratio"]
        prof = getattr(engine, "profiler", None)
        if prof is not None and prof.enabled:
            ps = prof.phase_stats(last=128)
            st["tick_phases"] = {name: s.get("p50_ms")
                                 for name, s in ps["phases"].items()}
            st["profile_coverage"] = ps.get("coverage")
        return st

    def _note_cost(self, tier: str, strategy: str, session: str,
                   tenant: str, device_ms: float, kv_ticks: float) -> None:
        """Fold one finished request's attributed cost into the bounded
        ledger (dict insertion order is the age order; a re-charged key
        keeps its slot)."""
        key = (tier, strategy, session, tenant)
        with self._cost_lock:
            entry = self._cost_ledger.get(key)
            if entry is None:
                while len(self._cost_ledger) >= self._cost_ledger_cap:
                    self._cost_ledger.pop(next(iter(self._cost_ledger)))
                entry = self._cost_ledger[key] = {
                    "device_time_ms": 0.0, "kv_block_ticks": 0.0,
                    "requests": 0}
            entry["device_time_ms"] += device_ms
            entry["kv_block_ticks"] += kv_ticks
            entry["requests"] += 1

    def cost_snapshot(self) -> List[Dict[str, Any]]:
        """The GET /stats ``cost`` block: attributed device time and KV
        block-ticks per (tier, strategy, session, tenant), most expensive
        first."""
        with self._cost_lock:
            rows = [{"tier": k[0], "strategy": k[1], "session": k[2],
                     "tenant": k[3],
                     "device_time_ms": round(v["device_time_ms"], 3),
                     "kv_block_ticks": round(v["kv_block_ticks"], 3),
                     "requests": int(v["requests"])}
                    for k, v in self._cost_ledger.items()]
        rows.sort(key=lambda r: r["device_time_ms"], reverse=True)
        return rows

    def autoscaler_snapshot(self) -> Optional[Dict[str, Any]]:
        """The GET /stats ``autoscaler`` block: per armed tier, its
        bounds and windows, membership, streaks, event counts and bounded
        ledger.  None when no tier is armed."""
        if not self.autoscalers:
            return None
        return {name: scaler.snapshot()
                for name, scaler in self.autoscalers.items()}

    def profiler_trace(self) -> Dict[str, Any]:
        """The GET /debug/trace body: every live engine's tick-phase ring
        and compile/host-sync events as one Chrome-trace JSON document.
        Tiers without a live profiler (sequential engines, profile=False)
        contribute nothing; a replicated tier has one thread per live
        replica (``tier/rN``)."""
        by_tier: Dict[str, Dict[str, Any]] = {}
        for name, tier in self.tiers.items():
            mgr = tier.server_manager
            subs = getattr(mgr, "live_engines", None)
            engines = ([(f"{name}/{key}", eng) for key, eng in subs()]
                       if callable(subs)
                       else [(name, getattr(mgr, "_engine", None))])
            for label, engine in engines:
                prof = getattr(engine, "profiler", None)
                if prof is not None and prof.enabled:
                    by_tier[label] = prof.snapshot()
        return obs_profiler.chrome_trace(by_tier)

    def _obs_state_snapshot(self) -> Dict[str, Any]:
        """The serving state attached to a flight-recorder entry: per-tier
        load, breaker states and the timeline's last samples (never
        manager.health(): it may wait on a starting engine)."""
        snap: Dict[str, Any] = {
            "tiers": {name: self._load_of(tier)
                      for name, tier in self.tiers.items()},
            "degraded_served": self.degraded_served,
        }
        if self.breaker is not None:
            snap["breaker"] = self.breaker.snapshot()
        timeline = self._timeline_tail(16)
        if timeline:
            snap["timeline"] = timeline
        return snap

    def _finish_request(self, trace, which: Optional[str], ok: bool,
                        degraded: bool = False, raw: Any = None) -> None:
        """Close a request trace and derive its metrics, its SLO verdict,
        its attributed cost and, for a failed, degraded or slow request,
        its flight-recorder entry.  Called exactly once per request, on
        every exit path of both pipelines."""
        trace.finish(ok=ok)
        m = self.obs.m
        strategy = trace.attrs.get("strategy") or "unknown"
        outcome = "degraded" if degraded else ("ok" if ok else "error")
        m.requests.labels(strategy, which or "none", outcome).inc()
        dur = trace.duration_ms
        if dur is not None:
            m.request_ms.labels(strategy).observe(dur)
        # Engine-true timings ride in the raw dict.  Cache hits skip the
        # latency histograms: their raw carries the original generation's
        # timings.
        cache_hit = bool(trace.attrs.get("cache_hit"))
        ttft = tbt_p95 = None
        if not cache_hit:
            if isinstance(raw, dict):
                for key in ("ttft_ms", "total_ms", "gen_tokens"):
                    val = raw.get(key)
                    if val is not None:
                        trace.annotate(**{key: val})
            ttft = trace.ttft_ms()
            if ttft is not None:
                m.ttft_ms.labels(strategy).observe(ttft)
            tbt = trace.tbt_ms()
            if tbt is not None:
                m.tbt_ms.labels(strategy).observe(tbt)
            tbt_p95 = trace.tbt_p95_ms()
        qw = trace.attrs.get("queue_wait_ms")
        if qw is not None and which:
            m.queue_wait_ms.labels(which).observe(float(qw))
        # Degraded service is not goodput even when a stale cache hit
        # carried ok=True.
        tenant_raw = trace.attrs.get("tenant") or DEFAULT_TENANT
        tenant = self.obs.tenant_labels.label(tenant_raw)
        self.slo.record_request(strategy, which, ok=ok and not degraded,
                                ttft_ms=ttft, tbt_p95_ms=tbt_p95,
                                cache_hit=cache_hit, tenant=tenant)
        # A completed request closes the tenant's over-quota incident; a
        # tenant-quota refusal is no completion.
        if not (isinstance(raw, dict)
                and "tenant '" in str(raw.get("error", ""))):
            self._tenant_incident_edge(tenant_raw, rejected=False)
        dev_ms = trace.device_time_ms
        kv_ticks = trace.kv_block_ticks
        if dev_ms or kv_ticks:
            session = self._session_labels.label(trace.attrs.get("session"))
            m.device_time.labels(which or "none", strategy,
                                 session).inc(dev_ms)
            m.kv_block_ticks.labels(which or "none", strategy,
                                    session).inc(kv_ticks)
            m.tenant_device_time.labels(which or "none", tenant).inc(dev_ms)
            m.tenant_kv_block_ticks.labels(which or "none",
                                           tenant).inc(kv_ticks)
            self._note_cost(which or "none", strategy, session, tenant,
                            dev_ms, kv_ticks)
            # Post-paid quota billing: the serving tier's token bucket is
            # debited with the measured device time (quotas off: no
            # registry, nothing to debit).
            tq = getattr(self.tiers.get(which) if which else None,
                         "tenants", None)
            if tq is not None:
                tq.debit(tenant_raw, dev_ms)
        reason = self.obs.recorder.classify(ok, degraded, dur)
        if reason is not None:
            m.flight_records.labels(reason).inc()
            self.obs.recorder.record(reason, trace,
                                     self._obs_state_snapshot())

    # -- helpers -----------------------------------------------------------

    def _apply_prefix_affinity(self, device: str, confidence: float,
                               method: str, reasoning: str, history
                               ) -> Tuple[str, str, str]:
        """Steer a LOW-confidence decision to a STRONGER tier (later in
        the cluster's order) that already holds this conversation's parked
        KV prefix, when its match beats the chosen tier's by at least
        ``prefix_affinity_min_tokens``.  The probes are non-destructive
        (``PrefixCache.peek``) and touch only running engines."""
        if (not self.enable_prefix_affinity
                or confidence >= self.prefix_affinity_min_confidence):
            return device, method, reasoning
        order = [t.name for t in self.cluster.tiers()]
        scores: Dict[str, int] = {}
        for name, tier in self.tiers.items():
            if (name not in order or device not in order
                    or order.index(name) <= order.index(device)):
                continue                 # upgrade-only: skip weaker tiers
            probe = self._tier_affinity_probe(tier)
            if callable(probe):
                try:
                    scores[name] = int(probe(history))
                except Exception:
                    scores[name] = 0
        if not scores:
            return device, method, reasoning
        own_probe = self._tier_affinity_probe(self.tiers[device])
        own = 0
        if callable(own_probe):
            try:
                own = int(own_probe(history))
            except Exception:
                own = 0
        best = max(scores, key=scores.get)
        if (best != device
                and scores[best] >= own + self.prefix_affinity_min_tokens):
            reasoning = (f"prefix affinity: {best} holds a "
                         f"{scores[best]}-token parked prefix of this "
                         f"conversation (decision was {device} at "
                         f"confidence {confidence:.2f}); {reasoning}")
            self.prefix_affinity_overrides += 1
            self.obs.m.cache_hits.labels("prefix_affinity").inc()
            obs_spans.event(current_trace(), "prefix_affinity_override",
                            to=best, match_tokens=scores[best])
            return best, f"{method}+prefix_affinity", reasoning
        return device, method, reasoning

    @staticmethod
    def _tier_affinity_probe(tier):
        """The tier's prefix-affinity probe: the replica set's best match
        over its replicas for a replicated tier (the tier holds a prefix
        if any replica does), else the running engine's (never starts
        one)."""
        mgr = tier.server_manager
        probe = getattr(mgr, "prefix_affinity", None)
        if callable(probe):
            return probe
        engine = getattr(mgr, "_engine", None)
        return getattr(engine, "prefix_affinity", None)

    @staticmethod
    def _extract_text(response: Any) -> Optional[str]:
        """Normalize any tier response shape to a plain string."""
        if response is None:
            return None
        if isinstance(response, str):
            return response.strip() or None
        if isinstance(response, dict):
            for key in ("response", "content", "message"):
                val = response.get(key)
                if isinstance(val, str) and val.strip():
                    return val.strip()
                if isinstance(val, dict):
                    inner = val.get("content")
                    if isinstance(inner, str) and inner.strip():
                        return inner.strip()
            if "error" in response:
                parts = [str(response.get(k, "")).strip()
                         for k in ("error", "detail", "body")]
                combined = " ".join(p for p in parts if p)
                return combined[:300] if combined else None
        return None

    def _history_to_query_and_context(
        self, history: List[Dict[str, Any]]
    ) -> Tuple[str, Optional[str], str]:
        """Split history into (last user query, prior-turn context string,
        sha256[:16] hash of the last-k turns)."""
        if not history:
            return "", None, "nohist"

        last_user = None
        for i in range(len(history) - 1, -1, -1):
            m = history[i]
            if isinstance(m, dict) and m.get("role") == "user":
                last_user = i
                break

        if last_user is None:
            query, ctx_msgs = "", history
        else:
            query = (history[last_user].get("content") or "").strip()
            ctx_msgs = history[:last_user]

        lines = [
            f"{(m.get('role') or '').strip()}: {(m.get('content') or '').strip()}"
            for m in ctx_msgs
            if isinstance(m, dict) and (m.get("content") or "").strip()
        ]
        context = "\n".join(lines) if lines else None

        compact = "\n".join(
            f"{m.get('role', '')}:{(m.get('content') or '').strip()}"
            for m in ctx_msgs[-self.cache_last_k:]
            if isinstance(m, dict))
        ctx_hash = hashlib.sha256(compact.encode("utf-8")).hexdigest()[:16]
        return query, context, ctx_hash

    @staticmethod
    def _is_error(raw: Any) -> bool:
        return is_error_shape(raw)

    @staticmethod
    def _is_transient_error(raw: Any) -> bool:
        """Error shapes worth one quick same-tier retry (_TRANSIENT_MARKERS)."""
        if not (isinstance(raw, dict) and "error" in raw):
            return False
        msg = str(raw.get("error", "")).lower()
        return any(m in msg for m in _TRANSIENT_MARKERS)

    @staticmethod
    def _other(device: str) -> str:
        return "orin" if device == "nano" else "nano"

    def _tier_timeout_s(self, device: str) -> Optional[float]:
        """The tier's per-request wall budget; None = unbounded."""
        tier = self.tiers.get(device)
        cfg = getattr(tier, "tier", None)
        if cfg is not None and cfg.request_timeout_s:
            return float(cfg.request_timeout_s)
        return None

    @staticmethod
    def _is_admission_rejection(raw: Any) -> bool:
        return (isinstance(raw, dict)
                and "admission rejected" in str(raw.get("error", "")))

    def _note_admission_rejection(self, raw: Any, which: str) -> None:
        """Every admission rejection counts; the KV-pressure subset also
        on its own counter, and a tenant-quota refusal (its reason names
        the tenant) on the tenant's counter and its incident edge."""
        if not self._is_admission_rejection(raw):
            return
        self.obs.m.admission_rejected.labels(which).inc()
        err = str(raw.get("error", ""))
        if "KV demand" in err:
            self.obs.m.kv_admission_rejected.labels(which).inc()
        if "tenant '" in err:
            trace = current_trace()
            tenant = (trace.attrs.get("tenant")
                      if trace is not None else None) or DEFAULT_TENANT
            self.obs.m.tenant_rejected.labels(
                which, self.obs.tenant_labels.label(tenant)).inc()
            self._tenant_incident_edge(tenant, rejected=True, which=which,
                                       reason=err)

    def _tenant_incident_edge(self, tenant: str, rejected: bool,
                              which: Optional[str] = None,
                              reason: str = "") -> None:
        """The over-quota incident's edges: a tenant's first refusal opens
        a ``tenant_overquota`` flight-recorder incident (later refusals
        count into it), its next completed request closes it.  Past
        ``_tenant_incident_cap`` open tenants, refusals still count in
        metrics but open no incident."""
        if rejected:
            with self._cost_lock:
                st = self._tenant_incidents.get(tenant)
                if st is not None:
                    st["rejections"] += 1
                    return
                if len(self._tenant_incidents) >= self._tenant_incident_cap:
                    return
                st = {"entry": None, "rejections": 1}
                self._tenant_incidents[tenant] = st
            info = {"tenant": tenant, "tier": which or "none",
                    "first_reason": (reason or "")[:200],
                    "start_unix": round(time.time(), 3), "open": True}
            st["entry"] = self.obs.recorder.record_incident(
                "tenant_overquota", info)
            self.obs.m.flight_records.labels("tenant_overquota").inc()
            return
        with self._cost_lock:
            st = self._tenant_incidents.pop(tenant, None)
        if st is None or st.get("entry") is None:
            return
        self.obs.recorder.update_incident(
            st["entry"], open=False, end_unix=round(time.time(), 3),
            rejections_while_open=int(st["rejections"]))

    # -- context-overflow policy -------------------------------------------

    def _apply_overflow_policy(self, device: str,
                               history: List[Dict[str, Any]]
                               ) -> Tuple[List[Dict[str, Any]],
                                          Optional[Dict[str, Any]], int]:
        """The dispatching tier's policy for prompts over ``max_seq_len -
        max_new_tokens`` (estimated with the router's token counter):
        ``reject`` fails fast with the reference error shape naming the
        policy; ``truncate_left`` drops the oldest turns until the
        estimate fits (the newest message always survives).  Returns
        (history, error_raw | None, dropped_messages)."""
        tier = self.tiers.get(device)
        cfg = getattr(tier, "tier", None)
        if cfg is None or not isinstance(history, list):
            return history, None, 0
        limit = max(1, cfg.model().max_seq_len - cfg.max_new_tokens)
        est = self.token_counter.get_context_size(history)
        if est <= limit:
            return history, None, 0
        if cfg.overflow_policy == "reject":
            self.obs.m.overflow.labels(device, "rejected").inc()
            obs_spans.event(current_trace(), "overflow_rejected",
                            tier=device, est_tokens=est, limit=limit)
            logger.warning("%s: prompt ~%d tokens over the %d-token "
                           "context budget: overflow_policy=reject",
                           device, est, limit)
            return history, {"error": (
                f"Request failed: prompt of ~{est} tokens exceeds "
                f"{device}'s context budget of {limit} tokens "
                f"(max_seq_len - decode budget; "
                f"overflow_policy=reject)")}, 0
        trimmed = list(history)
        dropped = 0
        while len(trimmed) > 1 and est > limit:
            dropped += 1
            est -= self.token_counter.count_tokens(trimmed.pop(0))
        self.obs.m.overflow.labels(device, "truncated").inc()
        obs_spans.event(current_trace(), "overflow_truncated",
                        tier=device, dropped_messages=dropped,
                        est_tokens=est, limit=limit)
        logger.info("%s: dropped %d oldest turn(s) to fit the %d-token "
                    "context budget (overflow_policy=truncate_left)",
                    device, dropped, limit)
        return trimmed, None, dropped

    def _breaker_record(self, device: str, ok: bool,
                        raw: Any = None) -> None:
        """Feed a dispatch outcome to the breaker.  Admission rejections
        are neither success nor failure (healthy backpressure); they only
        repay a half-open canary permit."""
        if self.breaker is None:
            return
        if not ok and self._is_admission_rejection(raw):
            self.breaker.release_probe(device)
            return
        self.breaker.record(device, ok)

    def _breaker_record_stream_setup(self, device: str, handle: Any) -> None:
        """Stream SETUP feedback: only failures count here; every success
        verdict comes from stream completion (a tier that wedges
        mid-decode passes setup every time)."""
        if self.breaker is not None and self._is_error(handle):
            self._breaker_record(device, False, handle)

    def _run_device(self, device: str,
                    history: List[Dict[str, Any]]) -> Tuple[Any, str, float]:
        tier = self.tiers.get(device, self.nano)
        logger.info("Processing query on %s", tier.name)
        t0 = time.perf_counter()
        with obs_spans.span(current_trace(), "dispatch", tier=tier.name):
            raw = tier.process(history)
        self._note_admission_rejection(raw, tier.name)
        return raw, tier.name, (time.perf_counter() - t0) * 1000.0

    def _run_device_retrying(self, device: str, history: List[Dict[str, Any]],
                             deadline: Optional[float] = None
                             ) -> Tuple[Any, str, float]:
        """``_run_device`` plus a bounded retry with jittered exponential
        backoff for TRANSIENT error shapes; no retry starts past
        ``deadline`` (monotonic)."""
        raw, which, lat_ms = self._run_device(device, history)
        for attempt in range(self.retry_attempts):
            if not self._is_transient_error(raw):
                break
            backoff = (self.retry_backoff_s * (2 ** attempt)
                       * (0.5 + random.random()))
            if (deadline is not None
                    and time.monotonic() + backoff >= deadline):
                logger.warning("%s transient error but no retry budget "
                               "left: giving up the retry", which)
                break
            logger.warning("%s transient error (%.80s): retry %d/%d after "
                           "%.0fms", which, raw.get("error", ""),
                           attempt + 1, self.retry_attempts, backoff * 1000)
            self.obs.m.retries.labels(which).inc()
            obs_spans.event(current_trace(), "retry", tier=which,
                            attempt=attempt + 1)
            time.sleep(backoff)
            raw, _, lat2 = self._run_device(device, history)
            lat_ms += lat2
        return raw, which, lat_ms

    # -- response cache ------------------------------------------------------

    def _response_cache_key(self, ctx_hash: str, query: str) -> str:
        # Deliberately context-independent (the reference's intent).
        return f"{self.query_router.strategy}|{query.lower().strip()}"

    def _degraded_response(self, query: str, ctx_hash: str, method: str,
                           confidence: float, overhead_ms: float,
                           device: str) -> Tuple[Dict[str, Any], int, str]:
        """Both circuits open: a response-cache hit if one exists (stale
        beats dead; cached errors skipped), else fail FAST with the
        reference error shape plus a retry-after hint."""
        cached = self._response_store.get(
            self._response_cache_key(ctx_hash, query))
        if cached is not None and self._is_error(cached.get("raw")):
            cached = None
        if cached is not None:
            text = cached.get("text", "")
            which = cached.get("device", device)
            tokens = self.token_counter.count_tokens(
                {"role": "assistant", "content": text})
            self.degraded_served += 1
            self.obs.m.degraded.inc()
            self.obs.m.cache_hits.labels("response_degraded").inc()
            obs_spans.annotate(current_trace(), degraded=True,
                               cache_hit="response_degraded")
            return {
                "response": text,
                "raw": cached.get("raw"),
                "cache_hit": True,
                "degraded": True,
                "routing_method": "response_cache_degraded",
                "routing_confidence": 1.0,
                "routing_reasoning": ("all tiers' circuits open -> stale "
                                      f"response-cache hit ({which})"),
                "routing_overhead_ms": round(overhead_ms, 2),
                "ok": True,
            }, tokens, which
        retry_after = (self.breaker.retry_after_s()
                       if self.breaker is not None else 0.0)
        raw = {"error": ("Request failed: all tiers unavailable (circuit "
                         f"open); retry in {retry_after:.1f}s")}
        text = self._extract_text(raw) or "No response available"
        tokens = self.token_counter.count_tokens(
            {"role": "assistant", "content": text})
        self.degraded_served += 1
        self.obs.m.degraded.inc()
        obs_spans.event(current_trace(), "degraded_fail_fast",
                        retry_after_s=round(retry_after, 2))
        obs_spans.annotate(current_trace(), degraded=True)
        logger.warning("degraded fail-fast: all circuits open "
                       "(retry_after=%.1fs)", retry_after)
        return {
            "response": text,
            "raw": raw,
            "cache_hit": False,
            "degraded": True,
            "retry_after_s": round(retry_after, 2),
            "benchmark_mode": self.benchmark_mode,
            "routing_method": f"{method}+breaker_degraded",
            "routing_confidence": round(confidence, 4),
            "routing_reasoning": ("all tiers' circuits open; shedding "
                                  "without dispatch"),
            "routing_overhead_ms": round(overhead_ms, 2),
            "ok": False,
        }, tokens, device

    # -- main pipeline -----------------------------------------------------

    def _feed_perf_load(self) -> None:
        """Breaker states and each tier's live load (admission queue depth
        and slot occupancy) into the active strategy before it decides,
        only where the strategy consumes them (perf)."""
        if (self.breaker is not None
                and hasattr(getattr(self.query_router, "router", None),
                            "update_breaker")):
            for name, st in self.breaker.snapshot().items():
                self.query_router.update_breaker(name,
                                                 st["state"] == "open")
        if not self.query_router.wants_load:
            return
        for name, tier in self.tiers.items():
            if callable(getattr(tier, "load_snapshot", None)):
                self.query_router.update_load(name, **tier.load_snapshot())

    def _decide(self, query: str, context: str, ctx_hash: str,
                history: List[Dict[str, Any]]):
        """The decision stage shared by both pipelines: the QueryRouter
        decision with the context-size fallback when it raises.  Returns
        (device, method, confidence, reasoning, cache_hit, overhead_ms)."""
        t0 = time.perf_counter()
        with obs_spans.span(current_trace(), "route") as route_sp:
            self._feed_perf_load()
            cache_hit = False
            try:
                decision = self.query_router.route_query(
                    query=query, context=context, context_key=ctx_hash)
                device = decision.device
                method = decision.method
                confidence = float(decision.confidence)
                reasoning = decision.reasoning
                cache_hit = bool(decision.cache_hit)
                logger.info("[%s] routing: %s | method=%s conf=%.3f",
                            "BENCH" if self.benchmark_mode else "PROD",
                            device.upper(), method, confidence)
            except Exception as exc:
                ctx_size = self.token_counter.get_context_size(history)
                device = ("orin" if ctx_size > self.threshold_fallback
                          else "nano")
                method = "fallback_ctx_size"
                confidence = 0.2
                reasoning = (f"router failed: {exc}; ctx_size={ctx_size}, "
                             f"threshold_fallback={self.threshold_fallback}")
                logger.warning("routing failed (%s); ctx fallback -> %s",
                               exc, device)
            route_sp.annotate(device=device, method=method,
                              confidence=round(confidence, 4))
            if cache_hit:
                self.obs.m.cache_hits.labels("routing").inc()
        overhead_ms = (time.perf_counter() - t0) * 1000.0
        return device, method, confidence, reasoning, cache_hit, overhead_ms

    def route_query(self, history: List[Dict[str, Any]],
                    session_id: Optional[str] = None,
                    tenant_id: Optional[str] = None
                    ) -> Tuple[Dict[str, Any], int, str]:
        """The request's span tree, bound to this thread for the tiers and
        engines, around the pipeline (``_route_query_inner``), then its
        single exit ``_finish_request``.  ``session_id`` keys the
        per-session cost attribution (None: '-'); ``tenant_id`` (already
        validated at the edge) reaches the tier quota layer and keys the
        tenant's billing (None: the ``default`` tenant)."""
        self._ensure_sampler()
        trace = self.obs.trace(strategy=self.query_router.strategy)
        if session_id:
            trace.annotate(session=str(session_id))
        if tenant_id:
            trace.annotate(tenant=str(tenant_id))
        with use_trace(trace):
            try:
                response, tokens, which = self._route_query_inner(
                    trace, history)
            except BaseException as exc:
                trace.annotate(error=f"{type(exc).__name__}: {exc}"[:200])
                self._finish_request(trace, None, ok=False)
                raise
        self._finish_request(trace, which,
                             ok=bool(response.get("ok", True)),
                             degraded=bool(response.get("degraded")),
                             raw=response.get("raw"))
        return response, tokens, which

    def _route_query_inner(self, trace, history: List[Dict[str, Any]]
                           ) -> Tuple[Dict[str, Any], int, str]:
        query, context, ctx_hash = self._history_to_query_and_context(history)

        # 0) response cache
        if self.enable_response_cache:
            with trace.span("cache_lookup"):
                cached = self._response_store.get(
                    self._response_cache_key(ctx_hash, query))
            if cached is not None:
                text = cached.get("text", "")
                which = cached.get("device", "nano")
                tokens = self.token_counter.count_tokens(
                    {"role": "assistant", "content": text})
                self.obs.m.cache_hits.labels("response").inc()
                trace.annotate(cache_hit="response")
                return {
                    "response": text,
                    "raw": cached.get("raw"),
                    "cache_hit": True,
                    "routing_method": "response_cache",
                    "routing_confidence": 1.0,
                    "routing_reasoning": f"response cache hit -> {which}",
                    "routing_overhead_ms": 0.0,
                    "ok": True,
                }, tokens, which

        # 1) routing decision, prefix affinity, breaker veto
        (device, method, confidence, reasoning,
         cache_hit, overhead_ms) = self._decide(query, context, ctx_hash,
                                                history)
        device, method, reasoning = self._apply_prefix_affinity(
            device, confidence, method, reasoning, history)
        if self.breaker is not None and not self.breaker.allow(device):
            other = self._other(device)
            if device in self.tiers and self.breaker.allow(other):
                reasoning = (f"circuit open on {device} -> rerouted to "
                             f"{other}; {reasoning}")
                method = f"{method}+breaker"
                trace.event("breaker_veto", vetoed=device, to=other)
                device = other
            else:
                return self._degraded_response(query, ctx_hash, method,
                                               confidence, overhead_ms,
                                               device)

        # 1.8) the dispatching tier's context-overflow policy
        history, overflow_err, overflow_dropped = \
            self._apply_overflow_policy(device, history)
        if overflow_err is not None:
            text = self._extract_text(overflow_err) or "No response available"
            tokens = self.token_counter.count_tokens(
                {"role": "assistant", "content": text})
            return {
                "response": text,
                "raw": overflow_err,
                "cache_hit": False,
                "benchmark_mode": self.benchmark_mode,
                "routing_overhead_ms": round(overhead_ms, 2),
                "routing_method": f"{method}+overflow_reject",
                "routing_confidence": round(confidence, 4),
                "routing_reasoning": (f"prompt exceeds {device}'s context "
                                      f"budget (overflow_policy=reject); "
                                      f"{reasoning}"),
                "ok": False,
            }, tokens, device

        # 2) inference + bounded transient retry + one-shot failover; the
        # retry layer is budgeted against the primary's request_timeout_s.
        timeout_s = self._tier_timeout_s(device)
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        raw, which, lat_ms = self._run_device_retrying(device, history,
                                                       deadline)
        self._breaker_record(which, not self._is_error(raw), raw)
        if self.enable_failover and self._is_error(raw):
            other = self._other(which)
            # The primary's failure reaches the perf strategy before the
            # switch (its fail penalty exists to steer off flaky tiers).
            self.query_router.update_perf(which, lat_ms, 0, ok=False)
            # One-shot failover, even after a full timeout; only an open
            # circuit on the survivor suppresses it.
            if self.breaker is None or self.breaker.allow(other):
                logger.warning("%s failed: failing over to %s", which, other)
                self.obs.m.failovers.labels(which, "sync").inc()
                trace.event("failover", failed=which, to=other)
                raw2, which2, lat2 = self._run_device_retrying(
                    other, history, deadline)
                self._breaker_record(which2, not self._is_error(raw2), raw2)
                if not self._is_error(raw2):
                    raw, which, lat_ms = raw2, which2, lat2
            else:
                logger.warning("%s failed and %s's circuit is open: "
                               "no failover target", which, other)

        # 3) normalize + count
        text = self._extract_text(raw) or "No response available"
        tokens = self.token_counter.count_tokens(
            {"role": "assistant", "content": text})
        ok = not self._is_error(raw)

        # 4) perf feedback
        self.query_router.update_perf(which, lat_ms, tokens, ok=ok)

        # 5) response-cache store
        if self.enable_response_cache:
            self._response_store[self._response_cache_key(ctx_hash, query)] = {
                "text": text,
                "raw": raw,
                "device": which,
                "routing_confidence": round(confidence, 4),
            }

        out = {
            "response": text,
            "raw": raw,
            "cache_hit": False,
            "benchmark_mode": self.benchmark_mode,
            "routing_overhead_ms": round(overhead_ms, 2),
            "routing_method": method,
            "routing_confidence": round(confidence, 4),
            "routing_reasoning": reasoning,
            "ok": ok,
        }
        if overflow_dropped:
            out["overflow_truncated"] = True
            out["overflow_dropped_messages"] = overflow_dropped
        return out, tokens, which

    def route_query_stream(self, history: List[Dict[str, Any]],
                           session_id: Optional[str] = None,
                           tenant_id: Optional[str] = None
                           ) -> "RoutedStream":
        """Streaming twin of ``route_query`` (see the module note).  The
        response cache does not take part.  Raises RuntimeError if no
        tier can start a stream (with a retry-after hint when every
        circuit is open); the stream's completion is the request's
        single exit."""
        self._ensure_sampler()
        trace = self.obs.trace(strategy=self.query_router.strategy,
                               stream=True)
        if session_id:
            trace.annotate(session=str(session_id))
        if tenant_id:
            trace.annotate(tenant=str(tenant_id))
        with use_trace(trace):
            try:
                return self._route_stream_inner(trace, history)
            except BaseException as exc:
                trace.annotate(error=f"{type(exc).__name__}: {exc}"[:200])
                self._finish_request(trace, None, ok=False,
                                     degraded=bool(
                                         trace.attrs.get("degraded")))
                raise

    def _route_stream_inner(self, trace, history: List[Dict[str, Any]]
                            ) -> "RoutedStream":
        query, context, ctx_hash = self._history_to_query_and_context(history)
        (device, method, confidence, reasoning,
         cache_hit, overhead_ms) = self._decide(query, context, ctx_hash,
                                                history)
        device, method, reasoning = self._apply_prefix_affinity(
            device, confidence, method, reasoning, history)
        if self.breaker is not None and not self.breaker.allow(device):
            other = self._other(device)
            if self.breaker.allow(other):
                reasoning = (f"circuit open on {device} -> rerouted to "
                             f"{other}; {reasoning}")
                method = f"{method}+breaker"
                trace.event("breaker_veto", vetoed=device, to=other)
                device = other
            else:
                self.degraded_served += 1
                self.obs.m.degraded.inc()
                trace.annotate(degraded=True)
                raise RuntimeError(
                    "Request failed: all tiers unavailable (circuit "
                    f"open); retry in {self.breaker.retry_after_s():.1f}s")

        history, overflow_err, overflow_dropped = \
            self._apply_overflow_policy(device, history)
        if overflow_err is not None:
            raise RuntimeError(overflow_err["error"])

        t0 = time.perf_counter()
        tier = self.tiers.get(device, self.nano)
        # Setup primes the first token (prefill runs inside): this span is
        # the stream's TTFT-critical section.
        with trace.span("stream_setup", tier=tier.name):
            handle = tier.process_stream(history)
        which = tier.name
        self._note_admission_rejection(handle, which)
        self._breaker_record_stream_setup(which, handle)
        if self._is_error(handle) and self.enable_failover:
            other = self._other(which)
            logger.warning("%s stream setup failed: failing over to %s",
                           which, other)
            self.query_router.update_perf(
                which, (time.perf_counter() - t0) * 1000.0, 0, ok=False)
            if self.breaker is None or self.breaker.allow(other):
                self.obs.m.failovers.labels(which, "stream_setup").inc()
                trace.event("failover", failed=which, to=other,
                            kind="stream_setup")
                with trace.span("stream_setup", tier=other):
                    alt = self.tiers[other].process_stream(history)
                self._note_admission_rejection(alt, other)
                self._breaker_record_stream_setup(other, alt)
                if not self._is_error(alt):
                    handle, which = alt, other
        if self._is_error(handle):
            raise RuntimeError(handle.get("error", "stream setup failed"))

        # The live (handle, device): mid-stream failover swaps both, and
        # completion is credited to the tier that finished the stream.
        state: Dict[str, Any] = {"handle": handle, "device": which}

        def on_done(ok: bool) -> None:
            # Completion is the breaker's verdict for the serving tier.
            self._breaker_record(state["device"], ok)
            result = getattr(state["handle"], "result", None)
            # Engine-true generation time, not wall time to exhaustion (a
            # slow consumer must not poison the perf window).
            if result is not None and result.total_ms > 0:
                lat_ms = result.total_ms
            else:
                lat_ms = (time.perf_counter() - t0) * 1000.0
            tokens = result.gen_tokens if result else 0
            self.query_router.update_perf(state["device"], lat_ms, tokens,
                                          ok=ok)
            # Engine-true timings preferred over the token timeline.
            if result is not None:
                trace.annotate(ttft_ms=result.ttft_ms,
                               total_ms=result.total_ms,
                               gen_tokens=result.gen_tokens)
            self._finish_request(trace, state["device"], ok=ok)

        def resume_mid_stream(emitted_chars: int, exc: BaseException):
            """The live stream died after ``emitted_chars`` chars: re-issue
            the request on the other tier and return an iterator that
            skips the delivered prefix, or None when no tier can take
            over (the caller surfaces the original failure and on_done
            records it against the dying tier)."""
            if not self.enable_failover:
                return None
            dying = state["device"]
            other = self._other(dying)
            logger.warning("%s stream died mid-decode after %d chars (%s): "
                           "re-issuing on %s", dying, emitted_chars, exc,
                           other)
            if self.breaker is not None and not self.breaker.allow(other):
                return None
            # Counted at the attempt, like the other failover kinds.
            self.obs.m.failovers.labels(dying, "mid_stream").inc()
            trace.event("mid_stream_failover", failed=dying, to=other,
                        replayed_chars=emitted_chars)
            # This hook runs on the consumer's thread: re-bind the trace
            # so the new setup's spans join the same tree.
            with use_trace(trace), \
                    trace.span("stream_setup", tier=other, resume=True):
                alt = self.tiers[other].process_stream(history)
            self._breaker_record_stream_setup(other, alt)
            if self._is_error(alt):
                logger.warning("mid-stream failover target %s also failed "
                               "(%s)", other, alt.get("error"))
                return None
            self._breaker_record(dying, False)
            self.query_router.update_perf(
                dying, (time.perf_counter() - t0) * 1000.0, 0, ok=False)
            state["handle"], state["device"] = alt, other

            def replayed():
                skip = emitted_chars
                for delta in alt:
                    if skip > 0:
                        if len(delta) <= skip:
                            skip -= len(delta)
                            continue
                        delta = delta[skip:]
                        skip = 0
                    yield delta

            return replayed()

        meta = {
            "device": which,
            "method": method,
            "confidence": round(confidence, 4),
            "reasoning": reasoning,
            # Streams never serve from the response cache; the routing
            # cache hit is its own field.
            "cache_hit": False,
            "routing_cache_hit": cache_hit,
            "routing_overhead_ms": round(overhead_ms, 2),
        }
        if overflow_dropped:
            meta["overflow_truncated"] = True
            meta["overflow_dropped_messages"] = overflow_dropped
        return RoutedStream(state, meta, on_done, resume=resume_mid_stream)


class RoutedStream:
    """A routed token stream: iterate for text deltas; ``.result`` holds
    the GenerationResult once exhausted.  Fires the router's completion
    callback exactly once, whether the stream completes, errors or is
    abandoned mid-iteration (client disconnect).  ``resume`` is the
    mid-stream failover hook, called once when the live stream raises
    between deltas."""

    def __init__(self, state: Dict[str, Any], meta: Dict[str, Any],
                 on_done, resume=None):
        self._state = state
        self.meta = meta
        self._on_done = on_done
        self._resume = resume
        self._resumed = False
        self._fired = False

    @property
    def device(self) -> str:
        """The tier currently (or finally) serving this stream."""
        return self._state["device"]

    def _fire(self, ok: bool) -> None:
        if not self._fired:
            self._fired = True
            self._on_done(ok)

    def __iter__(self):
        emitted_chars = 0
        it = iter(self._state["handle"])
        while True:
            try:
                delta = next(it)
            except StopIteration:
                break
            except BaseException as exc:   # producer (engine/stream) death
                if self._resume is not None and not self._resumed:
                    self._resumed = True   # one-shot, like setup failover
                    alt = None
                    try:
                        alt = self._resume(emitted_chars, exc)
                    except Exception:
                        logger.exception("mid-stream failover hook failed")
                    if alt is not None:
                        it = alt
                        continue
                self._fire(False)
                raise
            try:
                yield delta
            except GeneratorExit:
                # The consumer left (client disconnect): the tier was
                # healthy as far as it was consumed.
                self._fire(True)
                raise
            emitted_chars += len(delta)
        self._fire(True)

    @property
    def result(self):
        return self._state["handle"].result
