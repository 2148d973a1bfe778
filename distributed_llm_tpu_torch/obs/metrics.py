"""Metrics registry: counters, gauges, log-bucketed histograms, and a
Prometheus text exposition — stdlib only.

Counterpart of ``distributed_llm_tpu/obs/metrics.py``, the port's own
copy: the same 60 ``dllm_*`` families (names, kinds, labels and help),
the same bucket ladder and the same text exposition, so a scraper reads
either package alike.  The serving stack's signals (queue depth, breaker
state, admission rejects, latencies) get a typed, scrapeable shape,
served as Prometheus text at ``GET /metrics`` (serving/app.py) and read
by the bench (bench/headline.py) for its trace-derived columns.  The
tenant families get samples from the tier quota layer (serving/
tenants.py) and the router's ``_finish_request``, the autoscaler's from
serving/autoscaler.py.

Shape notes:

- A metric is a FAMILY (name + help + label names) of children keyed by
  label values: ``reg.counter("x_total", "…", ("tier",)).labels("nano")``.
  A label-less family is its own single child (``.inc()`` directly).
- Histograms use a fixed LOG-SPACED millisecond bucket ladder
  (sub-ms to minutes): latencies span 4+ orders of magnitude between the
  tiny CPU tiers and a wedged chip's timeout, and log buckets hold the
  relative quantile error roughly constant across that range where
  linear buckets would collapse one end or the other.
- ``Histogram.quantile`` interpolates within the winning bucket
  (the same estimate PromQL's histogram_quantile makes) — good to the
  bucket's width, which is the honest precision of any bucketed store.
- Thread-safety: one lock per registry guards family/child creation;
  each child then updates under its own lock.  Hot-path cost is one
  dict lookup + one lock + a float add.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# Log-spaced ms ladder: 1-2-5 per decade from 0.5 ms to 120 s.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500,
    1000, 2000, 5000, 10000, 20000, 60000, 120000)


def nearest_rank(values: Iterable[float], q: float,
                 presorted: bool = False) -> Optional[float]:
    """Nearest-rank percentile over raw samples — rank
    ``round(q * (n - 1))`` of the sorted values, None when empty.  The
    ONE rank rule shared by the decode tick ring
    (``ContinuousBatchingEngine.tick_stats``), the per-request TBT
    cadence criterion (``RequestTrace.tbt_p95_ms``), the tick-phase
    profiler (obs/profiler.py) and the open-loop bench leg, so "p95"
    means the same thing in the sampler gauges, the SLO verdicts, and
    the bench artifact.  (Histogram.quantile is the OTHER estimator —
    bucket interpolation over the log ladder — used where raw samples
    are not retained.)

    ``presorted=True`` skips the sort for callers that already hold a
    sorted list and read several quantiles from it (tick_stats runs on
    the 4 Hz sampler path per tier: one sort of the 512-entry ring, not
    one per quantile).  ``values`` must then be an indexable sorted
    sequence."""
    vs = values if presorted else sorted(values)
    if not vs:
        return None
    ix = min(len(vs) - 1, int(q * (len(vs) - 1) + 0.5))
    return vs[ix]


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers without a trailing .0."""
    if v == int(v):
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + inner + "}"


def _escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


class Counter:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self._lock = threading.Lock()
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        ix = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[ix] += 1
            self.sum += v
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (None when empty).
        Matches PromQL histogram_quantile: linear within the winning
        bucket; the +Inf bucket clamps to the highest finite bound."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return None
        rank = q * total
        cum = 0.0
        for ix, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                if ix >= len(self.buckets):          # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[ix - 1] if ix > 0 else 0.0
                hi = self.buckets[ix]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.buckets[-1]


class _Family:
    """One metric family: kind + help + label names + children."""

    def __init__(self, name: str, help_: str, kind: str,
                 label_names: Sequence[str],
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        self.name = name
        self.help = help_
        self.kind = kind                     # "counter" | "gauge" | "histogram"
        self.label_names = tuple(label_names)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.label_names:
            self._default = self._make()
            self._children[()] = self._default

    def _make(self):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self._buckets)

    def labels(self, *values: Any):
        """The child for these label values (created on first use)."""
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make())
        return child

    # Label-less convenience: the family IS its single child.
    def inc(self, n: float = 1.0) -> None:
        self._children[()].inc(n)

    def set(self, v: float) -> None:
        self._children[()].set(v)

    def observe(self, v: float) -> None:
        self._children[()].observe(v)

    @property
    def value(self) -> float:
        return self._children[()].value

    def children(self) -> Dict[Tuple[str, ...], Any]:
        with self._lock:
            return dict(self._children)


class MetricsRegistry:
    """Named families; renders the whole set as Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, help_: str, kind: str,
                labels: Sequence[str],
                buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}{tuple(labels)} "
                    f"(was {fam.kind}{fam.label_names})")
            return fam
        with self._lock:
            return self._families.setdefault(
                name, _Family(name, help_, kind, labels, buckets))

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._family(name, help_, "gauge", labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS) -> _Family:
        return self._family(name, help_, "histogram", labels, buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # -- exposition --------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        lines: List[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                if fam.kind == "histogram":
                    cum = 0
                    for ix, bound in enumerate(child.buckets):
                        cum += child.counts[ix]
                        labels = _label_str(
                            fam.label_names + ("le",),
                            key + (_fmt(bound),))
                        lines.append(f"{fam.name}_bucket{labels} {cum}")
                    labels = _label_str(fam.label_names + ("le",),
                                        key + ("+Inf",))
                    lines.append(f"{fam.name}_bucket{labels} {child.count}")
                    base = _label_str(fam.label_names, key)
                    lines.append(f"{fam.name}_sum{base} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{base} {child.count}")
                else:
                    labels = _label_str(fam.label_names, key)
                    lines.append(f"{fam.name}{labels} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


# -- the metric registry ------------------------------------------------------
#
# Every dllm_* family the serving stack emits, declared ONCE as data:
# (attribute, kind, name, label names, help), row for row the JAX
# package's table.  ServingMetrics materializes the rows and
# ``render_markdown`` documents them; every label name carries a
# cardinality bound in BOUNDED_LABELS below.

METRIC_REGISTRY: Tuple[Tuple[str, str, str, Tuple[str, ...], str], ...] = (
    ("requests", "counter", "dllm_requests_total",
     ("strategy", "tier", "outcome"),
     "Requests completed, by strategy/tier/outcome (outcome: "
     "ok|error|degraded)"),
    ("ttft_ms", "histogram", "dllm_ttft_ms", ("strategy",),
     "Time to first token per request (engine-true when reported, else "
     "first observed token)"),
    ("tbt_ms", "histogram", "dllm_tbt_ms", ("strategy",),
     "Mean time between tokens per request"),
    ("queue_wait_ms", "histogram", "dllm_queue_wait_ms", ("tier",),
     "Submit-to-batch-slot-admission wait in the tier's engine"),
    ("request_ms", "histogram", "dllm_request_ms", ("strategy",),
     "End-to-end routed request wall time"),
    ("admission_rejected", "counter", "dllm_admission_rejected_total",
     ("tier",),
     "Requests shed by tier admission control"),
    ("retries", "counter", "dllm_retries_total", ("tier",),
     "Same-tier transient-error retries"),
    ("failovers", "counter", "dllm_failovers_total", ("tier", "kind"),
     "Tier failovers, by failed tier and kind (sync|stream_setup|"
     "mid_stream)"),
    ("breaker_transitions", "counter", "dllm_breaker_transitions_total",
     ("tier", "to"),
     "Circuit-breaker state transitions, by tier and target state"),
    ("breaker_state", "gauge", "dllm_breaker_state", ("tier",),
     "Circuit state per tier (0=closed, 1=half_open, 2=open)"),
    ("watchdog_wedged", "counter", "dllm_watchdog_wedged_total", ("tier",),
     "Decode-watchdog wedge declarations (health flips ok=False)"),
    ("cache_hits", "counter", "dllm_cache_hits_total", ("cache",),
     "Cache hits by tier of cache (response|response_degraded|"
     "routing|prefix_affinity)"),
    ("degraded", "counter", "dllm_degraded_total", (),
     "Requests served by the degraded path (all circuits open)"),
    ("flight_records", "counter", "dllm_flight_records_total", ("reason",),
     "Flight-recorder captures by reason (error|degraded|slow)"),
    # Resource-pressure family: KV-aware admission, mid-decode
    # preemption with replay, context-overflow policy, graceful drain.
    ("preemptions", "counter", "dllm_preemptions_total", ("tier",),
     "Mid-decode slot preemptions under KV block starvation "
     "(victim replays byte-identically on re-admission)"),
    ("kv_admission_rejected", "counter", "dllm_kv_admission_rejected_total",
     ("tier",),
     "Requests shed because projected KV block demand exceeded "
     "free + reclaimable pool blocks"),
    ("overflow", "counter", "dllm_overflow_total", ("tier", "action"),
     "Context-overflow policy applications at the router, by tier "
     "and action (rejected|truncated)"),
    ("drained_requests", "counter", "dllm_drained_requests_total", ("tier",),
     "In-flight requests completed during a graceful drain"),
    # Ragged-decode family: the serving path must SHOW which
    # attention kernel is actually running a tier's decode ticks and
    # what each tick costs — cross-round perf deltas get attributed
    # to a kernel, not guessed.
    ("decode_tick_ms", "histogram", "dllm_decode_tick_ms", ("tier",),
     "Batched decode tick device time (decode_steps_per_tick "
     "fused steps per observation)"),
    ("decode_ticks", "counter", "dllm_decode_ticks_total",
     ("tier", "kind", "impl"),
     "Batched decode ticks, by attention dispatch kind "
     "(ragged_decode|paged_decode[+_q8]) and the impl the "
     "measured table chose (xla|pallas)"),
    ("compiled_programs", "gauge", "dllm_compiled_programs",
     ("tier", "stage"),
     "Distinct compiled XLA programs the batched engine has "
     "minted, by stage (prefill|chunk_prefill|writer|decode) — "
     "decode pins at 1 under ragged attention; growth is logged"),
    # Chunked-prefill family: long prompts are absorbed one
    # chunk per tick between decode ticks — the chunk histogram IS
    # the TBT bound the design promises (an active stream stalls at
    # most one chunk grant), and the backlog gauge shows a long
    # prompt mid-absorption behind a TTFT spike.
    ("prefill_chunk_ms", "histogram", "dllm_prefill_chunk_ms", ("tier",),
     "Device time of one interleaved prefill chunk — the upper "
     "bound a chunked admission adds to active streams' "
     "time-between-tokens per tick"),
    # Batched-speculation family: drafted vs accepted
    # draft tokens per tier (the counter pair whose ratio IS the
    # realized acceptance rate) and the engine's running acceptance
    # ratio mirrored by the system-state sampler — an operator reads
    # whether speculation is paying for its draft FLOPs without
    # diffing counters.
    ("spec_drafted", "counter", "dllm_spec_drafted_total", ("tier",),
     "Draft tokens proposed by batched speculative decoding "
     "(per-slot γ summed over rounds)"),
    ("spec_accepted", "counter", "dllm_spec_accepted_total", ("tier",),
     "Draft tokens accepted by the fused verify's greedy "
     "acceptance rule"),
    ("spec_accept_ratio_g", "gauge", "dllm_spec_accept_ratio", ("tier",),
     "Engine-lifetime accepted/drafted ratio for batched "
     "speculation (sampled; absent until the first draft)"),
    ("prefill_backlog_g", "gauge", "dllm_prefill_backlog", ("tier",),
     "Prompt tokens of the in-flight chunked prefill not yet "
     "absorbed (sampled by the system-state sampler; 0 = no "
     "prefill in flight)"),
    # System-state timeline family (obs/sampler.py): the
    # background sampler mirrors its latest per-tier sample to these
    # gauges so dashboards plot the same series the timeline ring
    # stores.  The *_g attribute suffix keeps them apart from the
    # identically-themed request-path counters above.
    ("queue_depth_g", "gauge", "dllm_queue_depth", ("tier",),
     "Requests waiting beyond the tier's batch slots (sampled)"),
    ("active_slots_g", "gauge", "dllm_active_slots", ("tier",),
     "Busy batch slots per tier (sampled)"),
    ("max_slots_g", "gauge", "dllm_max_slots", ("tier",),
     "Configured batch slots per tier (sampled)"),
    ("kv_free_blocks_g", "gauge", "dllm_kv_free_blocks", ("tier",),
     "Free paged-KV pool blocks per tier (sampled)"),
    ("kv_reclaimable_blocks_g", "gauge", "dllm_kv_reclaimable_blocks",
     ("tier",),
     "Pool blocks reclaimable by evicting parked prefixes "
     "(sampled; under shared-prefix KV only refcount-1 blocks of "
     "unpinned entries count — what an eviction sweep could "
     "actually free)"),
    # Shared-prefix KV family: how much physical pool the
    # refcounted copy-on-write sharing is saving, and what kind of
    # prefix-cache hits admissions are taking.
    ("kv_shared_blocks_g", "gauge", "dllm_kv_shared_blocks", ("tier",),
     "Physical pool blocks with >= 2 holders (live slots mapping "
     "a shared prefix read-only and/or parked entries; sampled)"),
    ("kv_dedup_ratio_g", "gauge", "dllm_kv_dedup_ratio", ("tier",),
     "Logical block references / physical allocated blocks — the "
     "factor shared-prefix KV multiplies the effective pool by "
     "(1.0 = nothing shared; sampled)"),
    ("prefix_hits", "counter", "dllm_prefix_hits_total", ("tier", "kind"),
     "Prefix-cache lookup outcomes on the batched admit path, "
     "per admission attempt (shared = pinned read-only mapping, "
     "exclusive = take-ownership reuse, host = spill-tier "
     "promotion claim, miss = cold prefill)"),
    # Hierarchical-KV spill family: the host tier's occupancy and the demote/promote lifecycle —
    # warm TTFT as a function of host-RAM size must be observable,
    # and a promotion losing its race must be countable.
    ("kv_host_blocks_g", "gauge", "dllm_kv_host_blocks", ("tier",),
     "Pool-block equivalents of demoted prefix KV resident in "
     "the host spill tier (sampled)"),
    ("kv_host_bytes_g", "gauge", "dllm_kv_host_bytes", ("tier",),
     "Host bytes held by the KV spill tier against "
     "TierConfig.host_kv_bytes (sampled)"),
    ("kv_promote_backlog_g", "gauge", "dllm_kv_promote_backlog", ("tier",),
     "Blocks the in-flight promotion still has to land "
     "host→device (sampled; 0 = no promotion in flight)"),
    ("kv_demotions", "counter", "dllm_kv_demotions_total", ("tier",),
     "Prefix-cache evictions demoted to the host spill tier "
     "(copy landed; the async device→host copy drains on the "
     "spill copier, never the tick)"),
    ("kv_promotions", "counter", "dllm_kv_promotions_total", ("tier",),
     "Demoted prefixes promoted back to the device pool "
     "(budgeted host→device grants riding the chunked-prefill "
     "lane)"),
    ("kv_promotion_races", "counter", "dllm_kv_promotion_races_total",
     ("tier",),
     "Promotions that lost the race (entry invalidated / copier "
     "stalled) and fell back to a byte-identical cold prefill"),
    ("tier_draining_g", "gauge", "dllm_tier_draining", ("tier",),
     "1 while the tier is gracefully draining, else 0 (sampled)"),
    ("decode_tick_p50_g", "gauge", "dllm_decode_tick_p50_ms", ("tier",),
     "p50 decode-tick device time over the engine's recent-tick "
     "ring (sampled)"),
    # SLO / goodput family (obs/slo.py): fed from the router's
    # exactly-once _finish_request exit (the single feed site).
    ("slo_goodput", "gauge", "dllm_slo_goodput", ("strategy", "tier"),
     "Sliding-window fraction of requests meeting the tier's SLO "
     "(TTFT and p95 TBT targets)"),
    ("slo_violations", "counter", "dllm_slo_violations_total", ("kind",),
     "Requests missing their SLO, by kind (error|ttft|tbt)"),
    ("overload_incidents", "counter", "dllm_overload_incidents_total",
     ("tier",),
     "Rising-edge overload incidents (tier goodput under the "
     "floor); each lands in the flight recorder with a timeline "
     "slice"),
    # Tick-forensics family (obs/profiler.py): per-request
    # device-time / KV-residency attribution aggregated at the
    # router's exactly-once completion exit, plus sampled per-phase
    # tick breakdown gauges — the accounting substrate per-tenant
    # quotas and goodput-per-replica-second economics bill against.
    ("device_time", "counter", "dllm_device_time_ms_total",
     ("tier", "strategy", "session"),
     "Attributed decode device time (each tick's device ms "
     "divided across the slots it served), per serving tier, "
     "strategy and session ('-' = sessionless)"),
    ("kv_block_ticks", "counter", "dllm_kv_block_ticks_total",
     ("tier", "strategy", "session"),
     "Attributed KV residency: pool blocks held x decode ticks, "
     "shared prefix blocks charged 1/refcount to each holder"),
    ("tick_phase_p50_g", "gauge", "dllm_tick_phase_p50_ms",
     ("tier", "phase"),
     "p50 per-tick SELF time of one scheduler phase (admit|"
     "prefill|cow_copy|table_upload|decode|emit|chunk_prefill) "
     "over the profiler ring's recent tail (sampled)"),
    ("profile_coverage_g", "gauge", "dllm_profile_coverage", ("tier",),
     "Fraction of tick wall time covered by stamped phase self-"
     "times (sampled; the bench profile leg pins >= 0.95)"),
    # Replicated-tier family (serving/replicas.py): how
    # dispatch chose among a tier's engine replicas, and how much of
    # the tier's replica capacity is currently healthy.
    ("replica_routed", "counter", "dllm_replica_routed_total",
     ("tier", "policy"),
     "Requests dispatched to a tier replica, by how the replica "
     "was chosen (affinity|affinity_overridden|least_loaded|"
     "random|single|breaker_fallback)"),
    ("replica_healthy_g", "gauge", "dllm_replica_healthy", ("tier",),
     "Replicas of the tier currently serving (running, not "
     "wedged, breaker not open) out of TierConfig.replicas "
     "(sampled)"),
    # Crash-rescue family (ReplicatedTierClient.restart_replica): what
    # happened to a restarted replica's
    # in-flight work and its host spill store.
    ("replica_rescues", "counter", "dllm_replica_rescues_total",
     ("tier", "outcome"),
     "Requests captured off a crashed/wedged replica at restart, "
     "by where they resumed (sibling = adopted by a live sibling "
     "replica, requeue = re-queued on the restarted engine, "
     "failed = no home — failed with the engine-stopped shape)"),
    ("spill_reattach", "counter", "dllm_spill_reattach_total",
     ("tier",),
     "Host KV spill stores that survived an engine restart and "
     "re-attached to the rebuilt engine (spill-state survival — "
     "restart cost is warm-TTFT promotion, not cold prefill)"),
    # Elastic-capacity family: live membership (sampled from the
    # replicated tiers) and the autoscaler's actuation decisions.
    ("replica_count_g", "gauge", "dllm_replica_count", ("tier",),
     "Live replica membership of the tier — static it equals "
     "TierConfig.replicas; under the autoscaler it moves between "
     "autoscale_min_replicas and autoscale_max_replicas "
     "(sampled)"),
    ("autoscale_events", "counter", "dllm_autoscale_events_total",
     ("tier", "direction", "reason"),
     "Autoscaler membership transitions, by direction (up|down) "
     "and the signal that fired them (goodput_floor|queue_growth"
     "|shed|idle|manual)"),
    # Per-tenant isolation family (serving/tenants.py): the measured
    # bill and enforcement decisions per tenant.  Every
    # ``tenant`` label value MUST pass through a BoundedLabels set
    # (64-char truncation, 256 distinct then '~overflow') — metric
    # children are permanent, so an unbounded tenant flood would
    # otherwise grow /metrics without bound.
    ("tenant_device_time", "counter", "dllm_tenant_device_time_ms_total",
     ("tier", "tenant"),
     "Attributed decode device time billed to the tenant "
     "(per-request attribution, '-' = tenantless direct "
     "engine use)"),
    ("tenant_kv_block_ticks", "counter",
     "dllm_tenant_kv_block_ticks_total", ("tier", "tenant"),
     "Attributed KV residency billed to the tenant (blocks held "
     "x decode ticks at 1/refcount)"),
    ("tenant_rejected", "counter", "dllm_tenant_rejected_total",
     ("tier", "tenant"),
     "Requests shed by per-tenant quota enforcement (in-flight/"
     "queue caps, device-time token bucket, or KV budget)"),
    ("tenant_inflight_g", "gauge", "dllm_tenant_inflight",
     ("tier", "tenant"),
     "Requests a tenant currently has admitted against its "
     "quota (in flight or waiting)"),
    ("tenant_goodput_g", "gauge", "dllm_tenant_goodput", ("tenant",),
     "Sliding-window fraction of the tenant's requests meeting "
     "their SLO (obs/slo.py per-tenant windows)"),
)

# Every label name in METRIC_REGISTRY carries its cardinality bound
# here — metric children are permanent, so a label without a bound is
# a /metrics memory leak waiting for a hostile client.  The
# ``metrics_discipline`` checker fails tier-1 on a registry label
# missing from this table.  Closed sets are enforced by the emitting
# call sites; open (caller-supplied) sets MUST ride a BoundedLabels.

BOUNDED_LABELS: Dict[str, str] = {
    "strategy": "closed set: the router's routing strategies "
                "(serving/router.py STRATEGIES)",
    "tier": "closed set: config-enumerated tier names (TierConfig)",
    "outcome": "closed per-family enums (request outcomes ok|error|"
               "degraded; rescue outcomes sibling|requeue|failed)",
    "kind": "closed per-family enums (failover / dispatch / SLO-violation"
            " / prefix-hit kinds; see each family's help)",
    "to": "closed set: breaker states closed|half_open|open",
    "cache": "closed set: response|response_degraded|routing|"
             "prefix_affinity",
    "reason": "closed per-family enums (flight-record triggers, "
              "autoscale signals)",
    "action": "closed set: rejected|truncated",
    "impl": "closed set: xla|pallas",
    "stage": "closed set: prefill|chunk_prefill|writer|decode",
    "phase": "closed set: admit|prefill|cow_copy|table_upload|decode|"
             "emit|chunk_prefill",
    "session": "open set: BoundedLabels(cap=256) — 64-char truncation, "
               "257th distinct value collapses to '~overflow'",
    "tenant": "open set: BoundedLabels(cap=256) — 64-char truncation, "
              "257th distinct value collapses to '~overflow'",
    "policy": "closed set: affinity|affinity_overridden|least_loaded|"
              "random|single|breaker_fallback",
    "direction": "closed set: up|down",
}


class ServingMetrics:
    """The serving stack's standard metric set, materialized from
    METRIC_REGISTRY so the router, breaker hooks, engine managers,
    /metrics, and the bench all read/write the same families (one
    assembler, no name drift — the table above is the only place a
    family is declared)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        for attr, kind, name, labels, help_ in METRIC_REGISTRY:
            setattr(self, attr, getattr(registry, kind)(
                name, help_, labels))


# -- METRICS.md generation ----------------------------------------------------

def render_markdown() -> str:
    """The registry as a Markdown document, the JAX package's
    METRICS.md layout: the families' table, then the label bounds."""
    lines = [
        "# Metrics registry",
        "",
        "Generated from `distributed_llm_tpu_torch/obs/metrics.py` "
        "(`python -m distributed_llm_tpu_torch.obs.metrics`).",
        "",
        "## Metric families (`dllm_*`)",
        "",
        "| Name | Kind | Labels | Semantics |",
        "|---|---|---|---|",
    ]

    def cell(text: str) -> str:
        return text.replace("|", "\\|")     # keep table cells intact

    for _attr, kind, name, labels, help_ in sorted(
            METRIC_REGISTRY, key=lambda r: r[2]):
        lab = ", ".join(f"`{x}`" for x in labels) if labels else "(none)"
        lines.append(f"| `{name}` | {kind} | {lab} | {cell(help_)} |")
    lines += [
        "",
        "## Label cardinality bounds",
        "",
        "Metric children are permanent; every label name above rides "
        "one of these bounds.",
        "",
        "| Label | Bound |",
        "|---|---|",
    ]
    for label in sorted(BOUNDED_LABELS):
        lines.append(f"| `{label}` | {cell(BOUNDED_LABELS[label])} |")
    return "\n".join(lines) + "\n"


class BoundedLabels:
    """Cardinality bound for caller-supplied metric label values — the
    router's session-label policy, reusable: '-' when absent, values
    truncated to 64 chars, and past ``cap`` DISTINCT values every new
    one collapses to '~overflow'.  Metric children are permanent, so
    without this a client minting fresh tenant/session ids would grow
    /metrics (and every labeled family) without bound."""

    def __init__(self, cap: int = 256):
        self._cap = cap
        self._seen: set = set()
        self._lock = threading.Lock()

    def label(self, raw: Any) -> str:
        if not raw:
            return "-"
        s = str(raw)[:64]
        with self._lock:
            if s in self._seen:
                return s
            if len(self._seen) < self._cap:
                self._seen.add(s)
                return s
        return "~overflow"


_BREAKER_STATE_VALUE = {"closed": 0, "half_open": 1, "open": 2}


def breaker_state_value(state: str) -> int:
    return _BREAKER_STATE_VALUE.get(state, 0)


if __name__ == "__main__":
    import sys
    sys.stdout.write(render_markdown())
