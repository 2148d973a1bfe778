"""Continuous system-state timeline: a background sampler over the
serving stack's cheap load counters.

Counterpart of ``distributed_llm_tpu/obs/sampler.py`` (the port's own
copy).  Request-level truth (spans, metrics, flight recorder) answers
"what happened to THAT request"; this module answers "what was the
SYSTEM doing around it".  A ``SystemStateSampler`` snapshots, every
``period_s`` (default 250 ms), each tier's queue depth, slot occupancy,
KV pool pressure, preemption count, breaker state, draining flag, and
decode-tick p50 into a bounded ring of timestamped samples — the
trajectory an overload post-mortem needs (was the queue GROWING when the
request failed, or already draining?).

Three consumers:

- ``GET /metrics``: the latest sample is exported as gauges
  (``dllm_queue_depth{tier}`` etc.) so dashboards plot the same series
  the timeline stores.
- ``GET /stats?timeline=1``: the whole ring, for ad-hoc forensics.
- Flight-recorder entries and SLO overload incidents attach a tail
  slice, so a failed request carries the system TRAJECTORY around it,
  not just a point snapshot (serving/router.py
  ``_obs_state_snapshot`` / obs/slo.py).

Design constraints: the collect callback reads only lock-free /
own-locked in-memory counters (load_snapshot, kv_stats, tick ring — it
must NEVER touch the engine lifecycle lock, which a mid-compile engine
holds for minutes), one sample costs tens of microseconds (inside the
< 1 ms per-request observability budget), and the
thread is a daemon that stops cleanly on ``Router.drain`` — a drained
process must not keep a sampler alive.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# Defaults; the router takes its own (``Router(sample_ms=...,
# timeline_samples=...)``).
DEFAULT_PERIOD_S = 0.25
DEFAULT_CAPACITY = 240          # 60 s of history at the default period

# Per-tier numeric fields mirrored to gauges each sample (field name ->
# ServingMetrics attribute).  Booleans export as 0/1; missing fields
# leave the gauge untouched (a stopped tier keeps its last value rather
# than faking a zero).
_GAUGE_FIELDS = (
    ("queue_depth", "queue_depth_g"),
    ("active_slots", "active_slots_g"),
    ("max_slots", "max_slots_g"),
    ("kv_free_blocks", "kv_free_blocks_g"),
    ("kv_reclaimable_blocks", "kv_reclaimable_blocks_g"),
    ("kv_shared_blocks", "kv_shared_blocks_g"),
    ("kv_dedup_ratio", "kv_dedup_ratio_g"),
    ("spec_accept_ratio", "spec_accept_ratio_g"),
    ("kv_host_blocks", "kv_host_blocks_g"),
    ("kv_host_bytes", "kv_host_bytes_g"),
    ("kv_promote_backlog", "kv_promote_backlog_g"),
    ("prefill_backlog_tokens", "prefill_backlog_g"),
    ("draining", "tier_draining_g"),
    ("decode_tick_p50_ms", "decode_tick_p50_g"),
    ("profile_coverage", "profile_coverage_g"),
    ("replica_healthy", "replica_healthy_g"),
    ("replica_count", "replica_count_g"),
)


class SystemStateSampler:
    """Bounded timeline of periodic system-state samples.

    ``collect`` is a zero-arg callable returning ``{tier_name: {field:
    value}}`` (serving/router.py ``_sampler_collect``); the sampler owns
    the cadence, the ring, and the gauge export.  ``metrics`` is an
    optional ``ServingMetrics`` for the gauge mirror.
    """

    def __init__(self, collect: Callable[[], Dict[str, Dict[str, Any]]],
                 metrics: Any = None,
                 period_s: float = DEFAULT_PERIOD_S,
                 capacity: int = DEFAULT_CAPACITY):
        self._collect = collect
        self._metrics = metrics
        self.period_s = max(0.02, float(period_s))
        self.capacity = max(8, int(capacity))
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_total = 0
        # EWMA of one sample's wall cost (ms) — the overhead-budget
        # evidence the /stats surface and tests read.
        self.sample_cost_ms: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Idempotent daemon-thread start (lazy: the serving layer calls
        this at first request, so constructed-and-dropped routers never
        spawn a thread)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="obs-sampler")
            self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        """Stop and join the sampler thread (Router.drain path).  Bounded
        join: the thread is a daemon, so a wedged collect callback cannot
        block process exit either way."""
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.period_s):
            try:
                self.sample_once()
            except Exception:            # a bad sample must not kill the loop
                logger.exception("state sampler: sample failed")

    # -- sampling ----------------------------------------------------------

    def sample_once(self) -> Dict[str, Any]:    # dllm-lint: hot-path
        """Take one sample NOW (also the on-demand path for
        ``GET /stats?timeline=1`` on an idle router).  A sample must
        stay tens-of-microseconds cheap
        and must NEVER touch the device (a host sync here would stall
        the timeline behind a busy chip)."""
        t0 = time.perf_counter()
        try:
            tiers = self._collect() or {}
        except Exception:                # collect must never raise upward
            tiers = {}
        sample = {"ts": round(time.time(), 3), "tiers": tiers}
        self._export_gauges(tiers)
        cost_ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self._ring.append(sample)
            self.samples_total += 1
            self.sample_cost_ms = (cost_ms if self.sample_cost_ms is None
                                   else 0.8 * self.sample_cost_ms
                                   + 0.2 * cost_ms)
        return sample

    def _export_gauges(self, tiers: Dict[str, Dict[str, Any]]) -> None:
        m = self._metrics
        if m is None:
            return
        for name, st in tiers.items():
            for field, attr in _GAUGE_FIELDS:
                val = st.get(field)
                if val is None:
                    continue
                try:
                    getattr(m, attr).labels(name).set(float(val))
                except Exception:
                    pass
            # Tick-phase breakdown: the collect callback
            # hands a {phase: p50_self_ms} dict; each phase is its own
            # gauge child so dashboards plot the tick's composition as
            # stacked series.
            phases = st.get("tick_phases")
            if isinstance(phases, dict):
                for phase, val in phases.items():
                    if val is None:
                        continue
                    try:
                        m.tick_phase_p50_g.labels(name, phase).set(
                            float(val))
                    except Exception:
                        pass

    # -- read --------------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Oldest-first copy of the ring (the /stats?timeline=1 body)."""
        with self._lock:
            return list(self._ring)

    def tail(self, n: int) -> List[Dict[str, Any]]:
        """The most recent ``n`` samples, oldest-first — the slice
        attached to flight-recorder entries and overload incidents."""
        with self._lock:
            if n <= 0 or not self._ring:
                return []
            return list(self._ring)[-n:]

    def slice_since(self, ts: float) -> List[Dict[str, Any]]:
        """Samples with ``sample["ts"] >= ts`` (incident windows)."""
        with self._lock:
            return [s for s in self._ring if s["ts"] >= ts]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
