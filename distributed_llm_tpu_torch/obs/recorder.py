"""Flight recorder: the last N interesting requests, in full.

Counterpart of ``distributed_llm_tpu/obs/recorder.py`` (the port's own
copy, the same classification and rings).  Aggregates (obs/metrics.py)
answer "how often / how slow"; the flight recorder answers "what exactly
happened to THAT request": a bounded ring buffer retaining the complete
span tree plus the serving stack's state snapshot (tier load, breaker
states) for the last ``capacity`` failed / degraded / slow requests.
Retrieval: ``GET /stats?debug=1`` (serving/app.py) — the post-mortem
surface for a request that timed out or got degraded service hours ago
on a box nobody was watching.

Healthy-fast requests are deliberately NOT retained: at serving rates
the interesting requests are a trickle and the boring ones are a flood;
recording everything would evict the post-mortem material the recorder
exists to keep.  The ``slow_ms`` threshold marks "slow" (None disables
the slow trigger; failed/degraded always record).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .spans import RequestTrace

DEFAULT_CAPACITY = 32
# Incidents (obs/slo.py overload windows) keep a ring of their OWN: an
# overload storm floods the request ring with hundreds of per-request
# error entries in seconds, and the one record that EXPLAINS them — the
# incident with its timeline slice — must not be evicted by its own
# symptoms.
INCIDENT_CAPACITY = 8


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 slow_ms: Optional[float] = 30000.0):
        self.capacity = max(1, int(capacity))
        self.slow_ms = slow_ms
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self._incidents: "deque[Dict[str, Any]]" = deque(
            maxlen=INCIDENT_CAPACITY)
        self.recorded_total = 0

    def classify(self, ok: bool, degraded: bool,
                 duration_ms: Optional[float]) -> Optional[str]:
        """The capture reason for a finished request, or None (don't
        record).  Degraded outranks error (it carries more state worth
        keeping); slow only applies to otherwise-healthy requests."""
        if degraded:
            return "degraded"
        if not ok:
            return "error"
        if (self.slow_ms is not None and duration_ms is not None
                and duration_ms >= self.slow_ms):
            return "slow"
        return None

    def record(self, reason: str, trace: RequestTrace,
               snapshot: Optional[Dict[str, Any]] = None) -> None:
        """Retain one request (trace serialized NOW — span objects must
        not outlive this call's view of them)."""
        entry = {
            "ts": round(time.time(), 3),
            "reason": reason,
            "trace": trace.to_dict(),
        }
        if snapshot:
            entry["state"] = snapshot
        with self._lock:
            self.recorded_total += 1
            entry["seq"] = self.recorded_total   # capture order, ts ties
            self._ring.append(entry)

    # -- incident records (obs/slo.py overload lifecycle) ------------------

    def record_incident(self, kind: str,
                        info: Dict[str, Any]) -> Dict[str, Any]:
        """Retain one traceless incident (e.g. an SLO overload window).
        Returns the ring entry so the caller can finalize it in place
        via ``update_incident`` when the incident closes — an incident
        is recorded at its RISING edge (a process that dies mid-overload
        must already have it on the post-mortem surface)."""
        entry = {
            "ts": round(time.time(), 3),
            "reason": kind,
            "incident": dict(info),
        }
        with self._lock:
            self.recorded_total += 1
            entry["seq"] = self.recorded_total
            self._incidents.append(entry)
        return entry

    def update_incident(self, entry: Dict[str, Any], **info: Any) -> None:
        """Finalize a live incident entry.  The ``incident`` value is
        REPLACED (not mutated): a concurrent ``snapshot`` serializer
        holding the old dict sees a complete earlier view, never a
        half-updated one."""
        with self._lock:
            entry["incident"] = {**entry.get("incident", {}), **info}

    def snapshot(self) -> List[Dict[str, Any]]:
        """Most-recent-first copy of BOTH rings, merged by timestamp
        (the /stats?debug=1 body).  Shallow-copied entries: incident
        finalization swaps top-level values on live entries, and a
        serializer must not iterate a dict being rebound under it."""
        with self._lock:
            merged = list(self._ring) + list(self._incidents)
        merged.sort(key=lambda e: e.get("seq", 0), reverse=True)
        return [dict(e) for e in merged]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
