"""Tick-phase profiler: where each scheduler tick's milliseconds go.

Counterpart of ``distributed_llm_tpu/obs/profiler.py`` (the port's own
copy: the same records, statistics and Chrome-trace export).  The
request-level layer answers "what happened" (goodput, queues,
incidents); this module answers "why, and who pays".  A
``TickProfiler`` lives on each ``ContinuousBatchingEngine`` and records,
per scheduler pass, a structured breakdown of the tick into phases —
admission/slot bookkeeping (``admit``), the prefill/suffix-chunk device
calls inside an admission (``prefill``), COW boundary copies
(``cow_copy``), host block-table uploads (``table_upload``), the fused
decode dispatch + its one sanctioned device sync (``decode``), token
fanout/detokenize (``emit``), and interleaved chunk-prefill grants
(``chunk_prefill``) — as a bounded ring of typed tick records.  Compile
events (``_note_compile``: on the card a tick program's CUDA-graph
capture) and the admission-time host syncs are stitched into the same
timeline as instant events, so a mid-serve capture or an unexpected
sync shows up ON the timeline it stalls.

Design constraints, in priority order:

- **Cheap when on.**  A phase stamp is two ``perf_counter`` calls and a
  list append on a stack the single scheduler thread owns — no locks,
  no allocation beyond the record tuples.  Phase context managers are
  preallocated per
  name and reused; per-entry state lives on the profiler's stack, not
  the CM object.
- **Zero-cost when off.**  ``make_profiler(enabled=False)`` (the
  engine's ``profile=False``) gives the shared
  ``NULL_PROFILER`` singleton: every stamp is a no-op method on a
  ``__slots__ = ()`` object returning a shared null context manager —
  the off path allocates nothing and records nothing, and the engine's
  attribution branch (gated on ``profiler.enabled``) never runs.
- **Never inside a captured program.**  A ``perf_counter`` stamp
  inside a tick program's body would run once, at its CUDA-graph
  capture, and measure nothing at its replays: the engine stamps around
  a program's run, never in its body.

**Self-time vs duration.**  Phases nest (``prefill`` runs inside
``admit``); each recorded span carries both its full duration (what the
Chrome trace renders as a nested slice) and its SELF time (duration
minus children).  Self-times partition the tick wall, so the per-phase
p50/p95 table and the ≥95%-coverage acceptance check sum self-times —
never double-counting a parent and its child.

**Attribution.**  The engine divides each decode tick's device time
evenly across the slots it served and charges every slot's
``RequestTrace`` (``spans.charge``) with its ``device_time_ms`` share
plus ``kv_block_ticks`` — blocks held × ticks, each block weighted
1/refcount so a shared prefix block bills 1/k to each of its k
holders.  The router's exactly-once ``_finish_request`` exit aggregates
the totals per (tier, strategy, session) into the
``dllm_device_time_ms_total`` / ``dllm_kv_block_ticks_total`` metric
families and the bounded cost ledger ``GET /stats`` exposes.

Export: ``chrome_trace`` renders any set of per-tier profiler snapshots
as Chrome-trace/Perfetto JSON (``GET /debug/trace``, the bench profile
leg's artifact) — one synthetic thread per tier, ticks as enclosing
slices, phases as properly nested child slices, compile/host-sync
events as instants.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

# Canonical phase taxonomy (DESIGN.md "Tick forensics").  The profiler
# accepts any name — this tuple is the documented set the engine stamps
# and the bench table orders by.  ``demote``/``promote`` are
# the hierarchical-KV spill tier's dispatch costs: the async gather
# snapshot of an evicted prefix and the host→device write-back grants —
# the device↔host DRAIN itself lives on the copier thread and never
# stamps a tick phase.
PHASES = ("admit", "prefill", "cow_copy", "table_upload", "decode",
          "draft", "verify", "emit", "chunk_prefill", "demote", "promote")

DEFAULT_CAPACITY = 512
EVENT_CAPACITY = 512


class _NullPhase:
    """Shared no-op context manager for the disabled profiler."""

    __slots__ = ()

    def __enter__(self) -> "_NullPhase":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_PHASE = _NullPhase()


class NullProfiler:
    """The disabled profiler: every stamp is a no-op on a shared
    singleton — the off path allocates nothing per call (the overhead
    test pins ``phase()`` returning the same object every time)."""

    __slots__ = ()
    enabled = False

    def phase(self, name: str) -> _NullPhase:
        return _NULL_PHASE

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def commit(self, slots: int = 0) -> None:
        pass

    def records(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        return []

    def events(self) -> List[Any]:
        return []

    def snapshot(self) -> Dict[str, Any]:
        return {"records": [], "events": []}

    def phase_stats(self, last: Optional[int] = None) -> Dict[str, Any]:
        return {"phases": {}, "coverage": None, "ticks": 0, "totals": {}}

    def summary(self) -> Dict[str, Any]:
        return {"enabled": False}


NULL_PROFILER = NullProfiler()


class _Phase:
    """Reusable per-name context manager: enter/exit delegate to the
    profiler's stack, so one object serves every occurrence of its
    phase (nesting state lives on the stack, not here)."""

    __slots__ = ("_prof", "_name")

    def __init__(self, prof: "TickProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self) -> "_Phase":
        self._prof._push(self._name)
        return self

    def __exit__(self, *exc) -> None:
        self._prof._pop()
        return None


class TickProfiler:
    """Bounded ring of per-tick phase breakdowns for ONE engine.

    Single-writer discipline: only the scheduler thread stamps phases
    and commits records (same ownership model as ``_slots`` and the
    ``tick_ms`` ring); readers (``records``/``phase_stats``/``summary``,
    the sampler, ``GET /debug/trace``) take advisory GIL-safe snapshots
    with the same retry-don't-block policy as ``tick_stats``."""

    enabled = True

    def __init__(self, tier: str = "", capacity: int = DEFAULT_CAPACITY):
        self.tier = tier
        self.capacity = max(16, int(capacity))
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        # Compile / host-sync instants, independent of tick records (a
        # warmup compile lands before any tick exists).  Own bounded
        # ring: (name, t_perf, attrs | None).
        self._events: "deque[tuple]" = deque(maxlen=EVENT_CAPACITY)
        self._cms: Dict[str, _Phase] = {}
        # Open-record state (scheduler thread only): phase stack entries
        # are [name, t0, child_seconds]; spans collect on _pop.
        self._stack: List[List[Any]] = []
        self._spans: List[tuple] = []
        self._t0: Optional[float] = None
        self._seq = 0
        # Lifetime per-phase self-time accumulators {name: [n, total_ms]}
        # — the attribution-conservation denominator must cover EVERY
        # tick ever served, not just the ring's tail.
        self._totals: Dict[str, List[float]] = {}

    # -- stamping (scheduler thread) ---------------------------------------

    def phase(self, name: str) -> _Phase:
        cm = self._cms.get(name)
        if cm is None:
            cm = self._cms[name] = _Phase(self, name)
        return cm

    def _push(self, name: str) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._stack.append([name, now, 0.0])

    def _pop(self) -> None:
        name, t0, child_s = self._stack.pop()
        now = time.perf_counter()
        dur_s = now - t0
        if self._stack:
            # The parent's self-time excludes this whole child.
            self._stack[-1][2] += dur_s
        self._spans.append((name, t0, dur_s, max(0.0, dur_s - child_s)))

    def event(self, name: str, **attrs: Any) -> None:
        """Instant event on the timeline (compile, sanctioned host
        sync).  Valid outside any tick — warmup compiles predate the
        first record."""
        self._events.append((name, time.perf_counter(),
                             attrs if attrs else None))

    def commit(self, slots: int = 0) -> None:
        """Close the open record (no-op when nothing was stamped this
        pass — idle loop passes leave no record)."""
        if self._t0 is None:
            return
        now = time.perf_counter()
        t0 = self._t0
        self._seq += 1
        spans = []
        for name, t, dur_s, self_s in self._spans:
            spans.append((name, (t - t0) * 1000.0, dur_s * 1000.0,
                          self_s * 1000.0))
            acc = self._totals.get(name)
            if acc is None:
                acc = self._totals[name] = [0, 0.0]
            acc[0] += 1
            acc[1] += self_s * 1000.0
        self._ring.append({
            "seq": self._seq,
            "t0": t0,
            "dur_ms": (now - t0) * 1000.0,
            "slots": slots,
            "spans": spans,
        })
        self._t0 = None
        self._spans = []
        # A raise mid-phase can strand stack entries past the `with`
        # that owns them only if the CM protocol itself was bypassed;
        # clear defensively so one bad pass cannot skew every later one.
        self._stack.clear()

    # -- reads (any thread; advisory snapshots) ----------------------------

    def _snap_ring(self, ring) -> List[Any]:
        """GIL-safe deque copy with the tick_stats retry policy: a
        concurrent append can abort one iteration pass — retry, and
        report empty rather than block or raise."""
        for _ in range(3):
            try:
                return list(ring)
            except RuntimeError:
                continue
        return []

    def records(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        recs = self._snap_ring(self._ring)
        if last is not None and last > 0:
            recs = recs[-last:]
        return recs

    def events(self) -> List[tuple]:
        return self._snap_ring(self._events)

    def snapshot(self) -> Dict[str, Any]:
        """Everything the Chrome-trace export needs for this engine."""
        return {"records": self.records(), "events": self.events()}

    def phase_stats(self, last: Optional[int] = None) -> Dict[str, Any]:
        """Per-phase self-time quantiles over the ring's tail plus the
        lifetime totals and the coverage fraction (self-time sum / tick
        wall sum) — the bench profile leg's table and the ≥95% coverage
        acceptance check."""
        from .metrics import nearest_rank
        recs = self.records(last)
        per_phase: Dict[str, List[float]] = {}
        wall = 0.0
        covered = 0.0
        for rec in recs:
            wall += rec["dur_ms"]
            by_name: Dict[str, float] = {}
            for name, _rel, _dur, self_ms in rec["spans"]:
                by_name[name] = by_name.get(name, 0.0) + self_ms
                covered += self_ms
            for name, ms in by_name.items():
                per_phase.setdefault(name, []).append(ms)
        phases = {}
        for name, vals in per_phase.items():
            vals.sort()
            phases[name] = {
                "n": len(vals),
                "p50_ms": round(nearest_rank(vals, 0.5, presorted=True), 4),
                "p95_ms": round(nearest_rank(vals, 0.95, presorted=True), 4),
                "total_ms": round(sum(vals), 3),
            }
        return {
            "phases": phases,
            "ticks": len(recs),
            "coverage": (round(covered / wall, 4) if wall > 0 else None),
            "totals": {name: {"n": int(acc[0]),
                              "total_ms": round(acc[1], 3)}
                       for name, acc in dict(self._totals).items()},
        }

    def total_ms(self, phase: str) -> float:
        """Lifetime self-time total for one phase (the attribution-
        conservation denominator in tests and the bench leg)."""
        acc = self._totals.get(phase)
        return float(acc[1]) if acc else 0.0

    def summary(self) -> Dict[str, Any]:
        """Cheap health()/GET /stats sideband: enabled flag, tick count,
        and coverage over the ring's recent tail."""
        st = self.phase_stats(last=64)
        return {"enabled": True, "ticks_recorded": self._seq,
                "ring": len(self._ring), "capacity": self.capacity,
                "coverage": st["coverage"]}


def make_profiler(tier: str = "", enabled: bool = True,
                  capacity: int = DEFAULT_CAPACITY):
    """The engine's profiler: a live ring of ``capacity`` tick records
    (default on), or, with ``enabled=False``, the shared zero-cost
    ``NULL_PROFILER`` (the JAX package's ``DLLM_PROFILE`` and
    ``DLLM_PROFILE_TICKS`` knobs, as arguments)."""
    if not enabled:
        return NULL_PROFILER
    return TickProfiler(tier, capacity=capacity)


# =============================================================================
# Chrome-trace / Perfetto export
# =============================================================================

def chrome_trace(by_tier: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Render per-tier profiler snapshots (``TickProfiler.snapshot``)
    as Chrome-trace JSON (the ``chrome://tracing`` / Perfetto "JSON
    Array Format" with metadata): one pid, one synthetic thread per
    tier, each tick an enclosing ``X`` slice with its phases as nested
    child slices (full durations — nesting is the point; self-times
    ride in ``args``), compile/host-sync events as ``i`` instants.

    Timestamps are microseconds from the earliest stamp across ALL
    tiers (perf_counter is one process-wide monotonic clock, so
    cross-tier ordering is real).  Deterministic output ordering:
    tiers sorted by name, events by timestamp within a tier."""
    # Global time origin: earliest stamp anywhere, so every ts >= 0.
    origin: Optional[float] = None
    for snap in by_tier.values():
        for rec in snap.get("records", ()):
            t = rec["t0"]
            origin = t if origin is None else min(origin, t)
        for ev in snap.get("events", ()):
            t = ev[1]
            origin = t if origin is None else min(origin, t)
    if origin is None:
        origin = 0.0

    def us(t_perf: float) -> float:
        return round((t_perf - origin) * 1e6, 1)

    events: List[Dict[str, Any]] = []
    for tid, name in enumerate(sorted(by_tier), start=1):
        snap = by_tier[name]
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": f"tier:{name}"}})
        for rec in snap.get("records", ()):
            t0 = rec["t0"]
            events.append({
                "name": "tick", "ph": "X", "pid": 1, "tid": tid,
                "ts": us(t0), "dur": round(rec["dur_ms"] * 1000.0, 1),
                "args": {"seq": rec["seq"], "slots": rec["slots"]},
            })
            for span in rec.get("spans", ()):
                pname, rel_ms, dur_ms, self_ms = span
                events.append({
                    "name": pname, "ph": "X", "pid": 1, "tid": tid,
                    "ts": us(t0 + rel_ms / 1000.0),
                    "dur": round(dur_ms * 1000.0, 1),
                    "args": {"self_ms": round(self_ms, 4)},
                })
        for ev in snap.get("events", ()):
            ename, t, attrs = ev[0], ev[1], (ev[2] if len(ev) > 2 else None)
            events.append({
                "name": ename, "ph": "i", "pid": 1, "tid": tid,
                "ts": us(t), "s": "t", "args": dict(attrs or {}),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
