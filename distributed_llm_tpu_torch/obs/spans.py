"""Per-request span trees — the serving stack's trace substrate.

Counterpart of ``distributed_llm_tpu/obs/spans.py`` (the port's own
copy, the same tree, timings and ``to_dict`` shape).  A
``RequestTrace`` is ONE request's wall-clock story as a tree of named
spans (route → cache lookup → admission → queue wait → prefill →
per-token decode → detokenize) plus point EVENTS for the control-flow
the fault-tolerance layer adds (retry, failover, mid-stream replay,
breaker veto, degraded service).  The serving layer creates a trace per
request (serving/router.py), threads it through the tier clients into
the engines, and at completion derives the request's metrics
(obs/metrics.py) and — for failed/degraded/slow requests — hands the
whole tree to the flight recorder (obs/recorder.py) for post-mortems.

Design constraints, in priority order:

- **Allocation-light.**  A span is a ``__slots__`` object holding two
  perf_counter floats, a name, and (lazily) attrs/children; per-token
  decode progress is NOT a span per token but one float append per
  token into a flat timeline (``add_token``) — a span object per token
  would dominate the cost of tracing a 128-token decode.  The whole
  instrumentation budget is < 1 ms per request.
- **Thread-safe.**  One request crosses threads (TierClient's timeout
  worker, the batching engine's scheduler); all tree mutation goes
  through the trace's lock.  The flat token timeline is a plain list
  append (atomic under the GIL).
- **Tolerant of absence.**  Engines run with or without a trace
  (serving/gpu_api.py and unit tests drive them directly): every
  module-level helper (``span``/``event``/``annotate``/``add_token``)
  no-ops on ``trace=None``, so instrumented code never branches.

Propagation: the serving layer binds the trace to a ``contextvars``
context (``use_trace``); same-thread callees read it via
``current_trace()``.  Context vars do NOT cross thread spawns — a
caller handing work to another thread captures the trace object and
re-binds it there (serving/tiers.py worker threads) or attaches it to
the work item (engine/batching.py ``_Request.trace``).

Span-exit discipline: spans are context managers and are ONLY entered
via ``with`` — so every enter has a matching exit on every
return/raise path by construction.
The two request-lifetime spans that cannot be ``with``-scoped (a
stream's decode outlives the function that opened it) are therefore
not spans at all: stream progress is the token timeline, closed by the
router's exactly-once completion callback.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

_TRACE_VAR: "contextvars.ContextVar[Optional[RequestTrace]]" = \
    contextvars.ContextVar("dllm_current_trace", default=None)
_REQUEST_IDS = itertools.count(1)


class Span:
    """One named, timed node in a request's span tree."""

    __slots__ = ("name", "t0", "t1", "attrs", "children", "_trace")

    def __init__(self, name: str, trace: "RequestTrace"):
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs: Optional[Dict[str, Any]] = None
        self.children: Optional[List["Span"]] = None
        self._trace = trace

    # -- context-manager protocol (the ONLY way spans open/close) ----------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        if exc_type is not None:
            self.annotate(error=f"{exc_type.__name__}: {exc}"[:200])
        return None                       # never swallow the exception

    # -- mutation ----------------------------------------------------------

    def annotate(self, **attrs: Any) -> None:
        with self._trace._lock:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)

    def span(self, name: str, **attrs: Any) -> "Span":
        """Open a child span.  Use as ``with parent.span("name"):``."""
        child = Span(name, self._trace)
        if attrs:
            child.attrs = dict(attrs)
        with self._trace._lock:
            if self.children is None:
                self.children = []
            self.children.append(child)
        return child

    def event(self, name: str, **attrs: Any) -> None:
        """A zero-duration annotation child (retry/failover/veto marks)."""
        mark = Span(name, self._trace)
        mark.t1 = mark.t0
        if attrs:
            mark.attrs = dict(attrs)
        with self._trace._lock:
            if self.children is None:
                self.children = []
            self.children.append(mark)

    # -- read --------------------------------------------------------------

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t1 is None:
            return None
        return (self.t1 - self.t0) * 1000.0

    def to_dict(self, origin: float) -> Dict[str, Any]:
        # Snapshot mutable fields under the trace lock, then recurse
        # OUTSIDE it (the lock is not reentrant): a timeout-abandoned
        # worker thread can still be annotating its spans while the
        # router serializes the tree for the flight recorder.
        with self._trace._lock:
            t1 = self.t1
            attrs = dict(self.attrs) if self.attrs else None
            children = list(self.children) if self.children else None
        out: Dict[str, Any] = {
            "name": self.name,
            "start_ms": round((self.t0 - origin) * 1000.0, 3),
        }
        if t1 is not None:
            out["duration_ms"] = round((t1 - self.t0) * 1000.0, 3)
        if attrs:
            out["attrs"] = attrs
        if children:
            out["children"] = [c.to_dict(origin) for c in children]
        return out


class RequestTrace:
    """The per-request context object threaded through the serving stack.

    ``root`` is the request span; stage spans hang off it.  The token
    timeline (``token_times``, perf_counter stamps) is flat: the
    batching engine appends once per accepted token (tick-granular — a
    tick's T tokens land together, which IS when they become
    observable).  Deliberately NO consumer-side stamping: stream deltas
    arrive at the reader's pace, and timing them would blame slow SSE
    clients on the engine.  TTFT/TBT therefore prefer the engine's own
    GenerationResult numbers (``annotate``\\ d by the router at
    completion) and fall back to the timeline; sequential-engine
    streams abandoned before a result exists report neither — they
    count in ``dllm_requests_total`` but skip the latency histograms
    rather than contribute consumer-paced values."""

    __slots__ = ("root", "request_id", "attrs", "token_times", "_lock",
                 "_t_wall", "device_time_ms", "kv_block_ticks")

    def __init__(self, name: str = "request", **attrs: Any):
        self._lock = threading.Lock()
        self.request_id = next(_REQUEST_IDS)
        self.attrs: Dict[str, Any] = dict(attrs)
        self.token_times: List[float] = []
        self._t_wall = time.time()
        # Per-request cost attribution (obs/profiler.py): the
        # batched engine charges each decode tick's device time evenly
        # across the slots it served, and blocks-held × ticks (shared
        # prefix blocks at 1/refcount each).  Single-writer (the
        # scheduler thread) float accumulators — plain adds, GIL-safe,
        # read at the router's exactly-once completion exit.
        self.device_time_ms: float = 0.0
        self.kv_block_ticks: float = 0.0
        self.root = Span(name, self)

    # -- producers ---------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> Span:
        """Open a stage span under the root (``with trace.span(...)``)."""
        return self.root.span(name, **attrs)

    def event(self, name: str, **attrs: Any) -> None:
        self.root.event(name, **attrs)

    def annotate(self, **attrs: Any) -> None:
        with self._lock:
            self.attrs.update(attrs)

    def add_token(self) -> None:
        """Stamp one unit of decode progress (token or stream delta)."""
        self.token_times.append(time.perf_counter())

    def finish(self, ok: bool = True) -> None:
        """Close the root span (idempotent; first close wins)."""
        if self.root.t1 is None:
            self.root.t1 = time.perf_counter()
            self.attrs.setdefault("ok", ok)

    # -- derived metrics ---------------------------------------------------

    @property
    def duration_ms(self) -> Optional[float]:
        return self.root.duration_ms

    def ttft_ms(self) -> Optional[float]:
        """Engine-reported TTFT when the router annotated one, else the
        first token-timeline stamp relative to request start."""
        val = self.attrs.get("ttft_ms")
        if val is not None:
            return float(val)
        if self.token_times:
            return (self.token_times[0] - self.root.t0) * 1000.0
        return None

    def tbt_ms(self) -> Optional[float]:
        """Mean time between tokens.  Preferred source: the engine-true
        total/ttft/gen_tokens annotations ((total-ttft)/(n-1), immune to
        consumer pacing); fallback: the observed token timeline."""
        total = self.attrs.get("total_ms")
        ttft = self.attrs.get("ttft_ms")
        n = self.attrs.get("gen_tokens")
        if total is not None and ttft is not None and n and n > 1:
            return max(0.0, (float(total) - float(ttft)) / (int(n) - 1))
        if len(self.token_times) > 1:
            span_s = self.token_times[-1] - self.token_times[0]
            return max(0.0, span_s * 1000.0 / (len(self.token_times) - 1))
        return None

    def tbt_p95_ms(self) -> Optional[float]:
        """Per-request p95 time-between-tokens — the SLO monitor's
        cadence criterion (one long stall mid-stream breaks a user's
        reading flow even when the MEAN looks fine).  Source: the
        observed token timeline's inter-token gaps when ≥3 stamps exist
        (tick-granular on the batched engine — a tick's T tokens land
        together, so the gaps measured are the gaps a stream consumer
        actually sees); fallback: the mean TBT (engine-true when
        annotated).  None when neither exists."""
        times = self.token_times
        if len(times) >= 3:
            from .metrics import nearest_rank
            gaps = [(b - a) * 1000.0 for a, b in zip(times, times[1:])]
            return max(0.0, nearest_rank(gaps, 0.95))
        return self.tbt_ms()

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            attrs = dict(self.attrs)
        out = {
            "request_id": self.request_id,
            "start_unix": round(self._t_wall, 3),
            "attrs": attrs,
            "tokens": len(self.token_times),
            "spans": self.root.to_dict(self.root.t0),
        }
        ttft = self.ttft_ms()
        if ttft is not None:
            out["ttft_ms"] = round(ttft, 3)
        tbt = self.tbt_ms()
        if tbt is not None:
            out["tbt_ms"] = round(tbt, 3)
        # Cost attribution rides every serialized trace (so flight-
        # recorder entries carry who-paid-what), but only once the
        # engine actually charged something — sequential engines and
        # engines built with profile=False keep the plain shape.
        if self.device_time_ms or self.kv_block_ticks:
            out["device_time_ms"] = round(self.device_time_ms, 3)
            out["kv_block_ticks"] = round(self.kv_block_ticks, 3)
        return out


# =============================================================================
# None-tolerant helpers (instrumented code never branches on trace presence)
# =============================================================================

class _NullSpan:
    """Shared no-op span for trace-less calls."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def annotate(self, **attrs: Any) -> None:
        pass

    def span(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(trace: Optional[RequestTrace], name: str, **attrs: Any):
    """``with spans.span(trace, "prefill", ...):`` — no-op when trace is
    None."""
    if trace is None:
        return NULL_SPAN
    return trace.span(name, **attrs)


def event(trace: Optional[RequestTrace], name: str, **attrs: Any) -> None:
    if trace is not None:
        trace.event(name, **attrs)


def annotate(trace: Optional[RequestTrace], **attrs: Any) -> None:
    if trace is not None:
        trace.annotate(**attrs)


def add_token(trace: Optional[RequestTrace]) -> None:
    if trace is not None:
        trace.token_times.append(time.perf_counter())


def charge(trace: Optional[RequestTrace], device_ms: float,
           kv_block_ticks: float = 0.0) -> None:
    """Accumulate one tick's attributed cost onto a request (no-op when
    trace is None — direct engine use stays uninstrumented).  Called
    once per active slot per decode tick from the scheduler thread;
    plain float adds, no lock (single writer, GIL-atomic)."""
    if trace is not None:
        trace.device_time_ms += device_ms
        trace.kv_block_ticks += kv_block_ticks


# =============================================================================
# Propagation
# =============================================================================

def current_trace() -> Optional[RequestTrace]:
    """The trace bound to this thread's context (None outside a traced
    request, in worker threads that didn't re-bind, and in tests that
    drive engines directly)."""
    return _TRACE_VAR.get()


class use_trace:
    """Bind ``trace`` as the current trace for a block::

        with use_trace(trace):
            ...  # current_trace() is `trace` on THIS thread

    Used at request entry (serving/router.py) and re-asserted inside
    worker threads the request hops to (serving/tiers.py)."""

    __slots__ = ("_trace", "_token")

    def __init__(self, trace: Optional[RequestTrace]):
        self._trace = trace
        self._token = None

    def __enter__(self) -> Optional[RequestTrace]:
        self._token = _TRACE_VAR.set(self._trace)
        return self._trace

    def __exit__(self, *exc) -> None:
        _TRACE_VAR.reset(self._token)
        return None
