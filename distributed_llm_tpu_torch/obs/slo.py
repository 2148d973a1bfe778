"""Online SLO monitor: sliding-window goodput and overload incidents.

Counterpart of ``distributed_llm_tpu/obs/slo.py`` (the port's own copy,
the same windows, verdicts and incident lifecycle).

Production serving is judged by GOODPUT UNDER SLO — the rate of requests
that were actually useful to a client (answered, TTFT within target,
steady token cadence) — not by raw req/s, which counts a 90-second
answer the user abandoned as a success (APEX frames online inference
exactly this way; PAPERS.md).  This module turns the per-request truth
the router already derives at its exactly-once ``_finish_request`` exit
(obs/spans.py timings) into:

- per-(strategy, tier) sliding-window goodput gauges
  (``dllm_slo_goodput{strategy,tier}``),
- violation counters by kind (``dllm_slo_violations_total{kind}``,
  kind ∈ error | ttft | tbt),
- rising-edge OVERLOAD INCIDENTS: when a tier's windowed goodput drops
  under ``goodput_floor``, one incident record opens — carrying the
  start time, the violating tier, the goodput at open, the peak queue
  depth so far, and a sampler timeline slice (obs/sampler.py) — and is
  pushed into the flight recorder immediately (an incident that is
  STILL OPEN when the process dies must already be on the post-mortem
  surface); recovery past ``goodput_floor + recover_margin`` closes it
  in place (duration, end goodput, final peak).

A request MEETS its SLO iff it completed ok (not error-shaped, not
degraded) AND its TTFT ≤ ``slo_ttft_ms`` AND its per-request p95
time-between-tokens ≤ ``slo_tbt_ms`` (targets per tier —
``TierConfig.slo_ttft_ms`` / ``slo_tbt_ms``; a None target skips that
check).  Cache hits count as good: a reply served from cache in
microseconds is the best SLO outcome there is, it just has no engine
latency to judge.

The ONLY feed point is ``Router._finish_request`` (a second feed site
would double-count requests and halve every goodput reading).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

DEFAULT_WINDOW = 64            # requests per (strategy, tier) goodput window
DEFAULT_GOODPUT_FLOOR = 0.5    # tier goodput below this opens an incident
DEFAULT_MIN_SAMPLES = 12       # window fill before incidents can fire
DEFAULT_RECOVER_MARGIN = 0.1   # hysteresis: close at floor + margin
INCIDENT_TIMELINE_SAMPLES = 40  # sampler slice attached to an incident
INCIDENT_HISTORY = 16          # closed incidents kept for /stats

# Placeholder parked in ``_active`` between reserving a tier's incident
# slot and the recorder entry existing.  It is NOT a live incident: a
# concurrent recovered request must not take the closing branch against
# it (it would finalize a throwaway dict and push a malformed history
# record), so the close edge requires a real entry and fires on the
# next feed after ``_open_incident`` lands.
_OPENING: Any = object()


class SLOMonitor:
    """Sliding-window goodput per (strategy, tier) + overload incidents.

    ``targets``: ``{tier: (slo_ttft_ms | None, slo_tbt_ms | None)}``.
    ``metrics``: optional ServingMetrics (gauges/counters mirror).
    ``recorder``: optional FlightRecorder (incident records).
    ``timeline``: optional zero-arg callable returning a sampler slice
    (list of samples) to attach to incidents.
    """

    def __init__(self, targets: Dict[str, Tuple[Optional[float],
                                                Optional[float]]],
                 metrics: Any = None, recorder: Any = None,
                 timeline: Optional[Callable[[], List[dict]]] = None,
                 window: int = DEFAULT_WINDOW,
                 goodput_floor: float = DEFAULT_GOODPUT_FLOOR,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 recover_margin: float = DEFAULT_RECOVER_MARGIN):
        self.targets = dict(targets)
        self._metrics = metrics
        self._recorder = recorder
        self._timeline = timeline
        self.window = max(4, int(window))
        self.goodput_floor = float(goodput_floor)
        self.min_samples = max(1, int(min_samples))
        self.recover_margin = float(recover_margin)
        self._lock = threading.Lock()
        self._windows: Dict[Tuple[str, str], deque] = {}
        self._tier_windows: Dict[str, deque] = {}
        # Per-tenant goodput windows (tenants are not served by the
        # port yet: its router passes no tenant).  A feed passes
        # ALREADY-BOUNDED tenant labels (Observability.tenant_labels:
        # 64-char truncation, 256 distinct then '~overflow'), so this
        # dict — and the dllm_tenant_goodput gauge children it mirrors
        # to — inherits the same cardinality bound; the belt-and-braces
        # local cap below covers recorder-less monitors fed raw ids.
        self._tenant_windows: Dict[str, deque] = {}
        self._tenant_window_cap = 256
        self.observed_total = 0
        self.good_total = 0
        self.violations: Dict[str, int] = {"error": 0, "ttft": 0, "tbt": 0}
        # tier -> the OPEN incident's ring entry (mutated in place on
        # close via FlightRecorder.update_incident).
        self._active: Dict[str, Dict[str, Any]] = {}
        self.incidents: "deque[Dict[str, Any]]" = deque(
            maxlen=INCIDENT_HISTORY)
        self.incidents_total = 0

    # -- target resolution -------------------------------------------------

    def targets_for(self, tier: str) -> Tuple[Optional[float],
                                              Optional[float]]:
        return self.targets.get(tier, (None, None))

    # -- the feed (Router._finish_request ONLY) ----------------------------

    def record_request(self, strategy: str, tier: Optional[str], ok: bool,
                       ttft_ms: Optional[float] = None,
                       tbt_p95_ms: Optional[float] = None,
                       cache_hit: bool = False,
                       tenant: Optional[str] = None) -> bool:
        """Score one finished request against its tier's SLO; returns
        whether it met it.  ``ok`` must already fold in degraded service
        (a degraded reply is not goodput).  ``tenant`` (already
        label-bounded by the caller) additionally feeds that
        tenant's goodput window and gauge — the per-tenant view the
        noisy-neighbor bench reads: whose SLO actually degraded."""
        tier = tier or "none"
        ttft_target, tbt_target = self.targets_for(tier)
        kind: Optional[str] = None
        if not ok:
            kind = "error"
        elif not cache_hit:
            if (ttft_target is not None and ttft_ms is not None
                    and ttft_ms > ttft_target):
                kind = "ttft"
            elif (tbt_target is not None and tbt_p95_ms is not None
                    and tbt_p95_ms > tbt_target):
                kind = "tbt"
        good = kind is None

        m = self._metrics
        with self._lock:
            self.observed_total += 1
            if good:
                self.good_total += 1
            else:
                self.violations[kind] = self.violations.get(kind, 0) + 1
            key = (strategy or "unknown", tier)
            win = self._windows.get(key)
            if win is None:
                win = self._windows[key] = deque(maxlen=self.window)
            win.append(good)
            goodput = sum(win) / len(win)
            twin = self._tier_windows.get(tier)
            if twin is None:
                twin = self._tier_windows[tier] = deque(maxlen=self.window)
            twin.append(good)
            tier_goodput = sum(twin) / len(twin)
            tier_samples = len(twin)
            tenant_goodput = None
            if tenant is not None:
                tw = self._tenant_windows.get(tenant)
                if tw is None and (len(self._tenant_windows)
                                   < self._tenant_window_cap):
                    tw = self._tenant_windows[tenant] = deque(
                        maxlen=self.window)
                if tw is not None:
                    tw.append(good)
                    tenant_goodput = sum(tw) / len(tw)
        if m is not None:
            try:
                if not good:
                    m.slo_violations.labels(kind).inc()
                m.slo_goodput.labels(key[0], tier).set(round(goodput, 4))
                if tenant_goodput is not None:
                    m.tenant_goodput_g.labels(tenant).set(
                        round(tenant_goodput, 4))
            except Exception:
                pass
        self._incident_edge(tier, tier_goodput, tier_samples)
        return good

    # -- incident lifecycle ------------------------------------------------

    def _timeline_slice(self) -> List[dict]:
        if self._timeline is None:
            return []
        try:
            return list(self._timeline())[-INCIDENT_TIMELINE_SAMPLES:]
        except Exception:
            return []

    @staticmethod
    def _peak_queue_depth(tier: str, samples: List[dict]) -> int:
        peak = 0
        for s in samples:
            st = (s.get("tiers") or {}).get(tier) or {}
            try:
                peak = max(peak, int(st.get("queue_depth") or 0))
            except (TypeError, ValueError):
                pass
        return peak

    def _incident_edge(self, tier: str, goodput: float,
                       samples: int) -> None:
        with self._lock:
            active = self._active.get(tier)
            opening = (active is None and samples >= self.min_samples
                       and goodput < self.goodput_floor)
            closing = (active is not None and active is not _OPENING
                       and goodput >= self.goodput_floor
                       + self.recover_margin)
            if opening:
                # Reserve the slot under the lock; build outside it (the
                # timeline callback takes the sampler's lock).
                self._active[tier] = _OPENING
            elif closing:
                del self._active[tier]
            else:
                return
        if opening:
            self._open_incident(tier, goodput)
        else:
            self._close_incident(tier, active, goodput)

    def _open_incident(self, tier: str, goodput: float) -> None:
        timeline = self._timeline_slice()
        info = {
            "tier": tier,
            "start_unix": round(time.time(), 3),
            "goodput_at_open": round(goodput, 4),
            "peak_queue_depth": self._peak_queue_depth(tier, timeline),
            "open": True,
            "timeline": timeline,
        }
        entry = None
        if self._recorder is not None:
            try:
                entry = self._recorder.record_incident("overload", info)
            except Exception:
                entry = None
        if entry is None:                       # recorder-less monitors
            entry = {"reason": "overload", "incident": info}
        m = self._metrics
        if m is not None:
            try:
                m.overload_incidents.labels(tier).inc()
                m.flight_records.labels("overload").inc()
            except Exception:
                pass
        with self._lock:
            self.incidents_total += 1
            self._active[tier] = entry

    def _close_incident(self, tier: str, entry: Dict[str, Any],
                        goodput: float) -> None:
        timeline = self._timeline_slice()
        start = entry.get("incident", {}).get("start_unix") or time.time()
        end = round(time.time(), 3)
        updates = {
            "open": False,
            "end_unix": end,
            "duration_s": round(max(0.0, end - start), 3),
            "goodput_at_close": round(goodput, 4),
            "peak_queue_depth": max(
                entry.get("incident", {}).get("peak_queue_depth", 0),
                self._peak_queue_depth(tier, timeline)),
        }
        if self._recorder is not None:
            try:
                self._recorder.update_incident(entry, **updates)
            except Exception:
                entry["incident"] = {**entry.get("incident", {}), **updates}
        else:
            entry["incident"] = {**entry.get("incident", {}), **updates}
        with self._lock:
            closed = dict(entry.get("incident", {}))
            closed.pop("timeline", None)        # history stays compact
            self.incidents.append(closed)

    # -- read --------------------------------------------------------------

    def goodput(self, strategy: Optional[str] = None,
                tier: Optional[str] = None) -> Optional[float]:
        """Windowed goodput for one (strategy, tier), one tier (any
        strategy), or overall (lifetime ratio) — None before any
        sample."""
        with self._lock:
            if strategy is not None and tier is not None:
                win = self._windows.get((strategy, tier))
                return (sum(win) / len(win)) if win else None
            if tier is not None:
                win = self._tier_windows.get(tier)
                return (sum(win) / len(win)) if win else None
            if not self.observed_total:
                return None
            return self.good_total / self.observed_total

    def snapshot(self) -> Dict[str, Any]:
        """The /stats surface: targets, per-(strategy, tier) windowed
        goodput, violation counts, and incident state."""
        with self._lock:
            goodput = {}
            for (strategy, tier), win in sorted(self._windows.items()):
                if win:
                    goodput.setdefault(strategy, {})[tier] = round(
                        sum(win) / len(win), 4)
            active = {t: {k: v for k, v in e.get("incident", {}).items()
                          if k != "timeline"}
                      for t, e in self._active.items()
                      if e is not _OPENING}
            tenants = {t: round(sum(w) / len(w), 4)
                       for t, w in sorted(self._tenant_windows.items())
                       if w}
            return {
                "targets": {t: {"slo_ttft_ms": tt, "slo_tbt_ms": tb}
                            for t, (tt, tb) in sorted(self.targets.items())},
                "observed_total": self.observed_total,
                "good_total": self.good_total,
                "goodput_lifetime": (round(self.good_total
                                           / self.observed_total, 4)
                                     if self.observed_total else None),
                "goodput": goodput,
                "tenants": tenants,
                "violations": dict(self.violations),
                "incidents_total": self.incidents_total,
                "active_incidents": active,
                "recent_incidents": list(self.incidents),
            }
