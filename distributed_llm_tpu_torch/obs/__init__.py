"""Request-level observability: span traces, metrics, flight recorder,
and the SLO monitor, state sampler and tick profiler beside them.

Counterpart of ``distributed_llm_tpu/obs/`` (the port's own copy; the
port imports nothing of the JAX package).  The bundle class
``Observability`` ties three surfaces together:

- ``obs.trace(...)`` — a fresh per-request span tree (obs/spans.py),
  created by the router at request entry and threaded through tiers and
  engines (``spans.use_trace`` / ``spans.current_trace``).
- ``obs.m`` — the standard serving metric set (obs/metrics.py
  ServingMetrics) over ``obs.metrics``, rendered at ``GET /metrics``.
- ``obs.recorder`` — the failed/degraded/slow flight recorder
  (obs/recorder.py), dumped at ``GET /stats?debug=1``.

One process-global default instance (``get_observability()``) backs the
serving entry points and everything that lacks an injection path (the
engines' tick and program metrics, the managers' drain and wedge
counters); the Router takes an ``observability=`` override so tests and
bench legs read a registry no other traffic writes to.  The JAX
package's ``DLLM_OBS_SLOW_MS`` and ``DLLM_OBS_FLIGHT_CAPACITY`` knobs are
the arguments ``slow_ms`` (ms; default 30000; None or <= 0 disables the
slow trigger of the global recorder — failed/degraded requests still
record) and ``flight_capacity`` (default 32).
"""

from __future__ import annotations

import threading
from typing import Optional

from . import metrics, recorder, spans                       # noqa: F401
from .metrics import BoundedLabels, MetricsRegistry, ServingMetrics
from .recorder import DEFAULT_CAPACITY, FlightRecorder
from .spans import RequestTrace, current_trace, use_trace    # noqa: F401


class Observability:
    """One registry + metric set + recorder + trace factory."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 slow_ms: Optional[float] = 30000.0,
                 flight_capacity: Optional[int] = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.m = ServingMetrics(self.metrics)
        # One label bound per registry for tenant ids: every
        # dllm_tenant_* family takes its tenant label through it.
        self.tenant_labels = BoundedLabels()
        self.recorder = (flight if flight is not None
                         else FlightRecorder(
                             capacity=(flight_capacity
                                       if flight_capacity is not None
                                       else DEFAULT_CAPACITY),
                             slow_ms=slow_ms))

    def trace(self, name: str = "request", **attrs) -> RequestTrace:
        return RequestTrace(name, **attrs)


_GLOBAL: Optional[Observability] = None
_GLOBAL_LOCK = threading.Lock()


def get_observability(slow_ms: Optional[float] = 30000.0,
                      flight_capacity: int = 32) -> Observability:
    """The process-global default bundle, created on first use with
    ``slow_ms`` (None or <= 0: no slow trigger — a zero threshold would
    record every request and evict the post-mortems the ring exists to
    keep) and ``flight_capacity``; later calls return it as it is."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                if slow_ms is not None and slow_ms <= 0:
                    slow_ms = None
                _GLOBAL = Observability(
                    slow_ms=slow_ms,
                    flight_capacity=max(1, int(flight_capacity)))
    return _GLOBAL
