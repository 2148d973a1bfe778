"""Injectable fault model for tier engines.

Counterpart of ``distributed_llm_tpu/utils/faults.py``.  An in-process
engine has no network layer to fail, so failover, the perf strategy's
fail penalty, the breaker and the health plumbing need a fault model to
be testable:

- ``FaultInjector`` scripts failures per tier: one-shot error queues,
  sticky outages, artificial latency, transient (retryable) error shapes,
  mid-stream kills (``fail_stream_after``: the stream dies after N
  delivered chunks) and warm-standby publish failures.  The error
  payloads are the reference client's shapes, so ``Router._is_error`` and
  failover behave as for a real outage;
- ``crash_replica_engine`` kills a batched engine's scheduler loop with
  no cleanup (the replica-crash fault);
- ``BlockStarver`` confiscates free blocks of a paged engine's allocator
  (memory pressure);
- ``FaultSchedule`` layers scripted timelines on top (flaps, outages,
  latency spikes, starvation windows, stream and replica kills, a wedged
  spill copier), driven on a background thread while load runs.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class FaultInjector:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._one_shot: Dict[str, deque] = defaultdict(deque)
        self._down: Dict[str, Optional[Dict[str, Any]]] = {}
        self._delay_s: Dict[str, float] = {}
        self._stream_kills: Dict[str, deque] = defaultdict(deque)
        self._publish_fails: Dict[str, deque] = defaultdict(deque)

    # -- scripting ---------------------------------------------------------

    def fail_next(self, tier: str, error: str = "injected fault") -> None:
        """Queue a one-shot failure for the next request to ``tier``."""
        with self._lock:
            self._one_shot[tier].append({"error": error})

    def timeout_next(self, tier: str) -> None:
        """One-shot timeout with the reference client's error shape."""
        self.fail_next(
            tier, f"Request timed out on {tier.capitalize()} "
                  "(model cold start / slow inference).")

    def fail_transient(self, tier: str) -> None:
        """One-shot TRANSIENT failure: an error shape the Router's bounded
        retry treats as retryable (connection level, not a timeout)."""
        self.fail_next(
            tier, f"Request failed: connection reset by peer on "
                  f"{tier} (transient)")

    def set_down(self, tier: str, error: str = "tier offline") -> None:
        """Sticky outage until ``restore``."""
        with self._lock:
            self._down[tier] = {"error": error}

    def restore(self, tier: str) -> None:
        with self._lock:
            self._down.pop(tier, None)
            self._one_shot.pop(tier, None)
            self._delay_s.pop(tier, None)
            self._stream_kills.pop(tier, None)
            self._publish_fails.pop(tier, None)

    def add_latency(self, tier: str, seconds: float) -> None:
        """Artificial per-request latency."""
        with self._lock:
            self._delay_s[tier] = seconds

    def fail_stream_after(self, tier: str, n_chunks: int,
                          error: str = "injected mid-stream fault") -> None:
        """Queue a one-shot MID-STREAM kill: the next stream started on
        ``tier`` raises after delivering ``n_chunks`` deltas, the failure
        setup-time failover can never catch.  ``restore`` clears pending
        kills."""
        with self._lock:
            self._stream_kills[tier].append((max(0, int(n_chunks)), error))

    def fail_standby_publish(self, tier: str,
                             error: str = "injected standby publish "
                                          "failure") -> None:
        """Queue a one-shot warm-standby PUBLISH failure for ``tier``:
        the next scale-up that promotes a parked standby loses it.  Its
        consumer, the warm standby pool, is not ported yet."""
        with self._lock:
            self._publish_fails[tier].append(error)

    # -- hooks called by the tier clients ----------------------------------

    def intercept(self, tier: str) -> Optional[Dict[str, Any]]:
        """An error payload that short-circuits the request, else None.
        Applies scripted latency as a side effect."""
        with self._lock:
            delay = self._delay_s.get(tier, 0.0)
            down = self._down.get(tier)
            shot = (self._one_shot[tier].popleft()
                    if self._one_shot[tier] else None)
        if delay > 0:
            time.sleep(delay)
        if down is not None:
            return dict(down)
        return shot

    def stream_kill(self, tier: str) -> Optional[Tuple[int, str]]:
        """Pop the next scheduled mid-stream kill for ``tier`` (one-shot):
        (chunks to deliver before dying, error message), or None."""
        with self._lock:
            kills = self._stream_kills.get(tier)
            return kills.popleft() if kills else None

    def standby_publish_fail(self, tier: str) -> Optional[str]:
        """Pop the next scheduled standby-publish failure for ``tier``
        (one-shot): the error message, or None."""
        with self._lock:
            fails = self._publish_fails.get(tier)
            return fails.popleft() if fails else None


def crash_replica_engine(engine) -> bool:
    """Kill a batched engine's scheduler loop mid-decode with NO cleanup:
    the loop thread exits, its slots and queued requests strand (callers
    block, streams stall) and the progress heartbeat goes stale, so the
    decode watchdog reads the engine wedged and the HealthMonitor's next
    probe restarts the replica through ``restart_replica``.  False when
    there is no running loop to kill."""
    stop = getattr(engine, "_stop", None)
    if stop is None or getattr(engine, "_thread", None) is None:
        return False
    stop.set()
    wake = getattr(engine, "_wake", None)
    if wake is not None:
        wake.set()
    return True


def maybe_break_stream(faults: Optional[FaultInjector], tier: str, handle):
    """Apply a scripted mid-stream kill to a freshly built stream handle:
    pop the next ``fail_stream_after`` entry for ``tier`` and wrap the
    handle so it dies after that many chunks.  No injector, or no kill
    scheduled: the handle unchanged."""
    if faults is None:
        return handle
    kill = faults.stream_kill(tier)
    if kill is None:
        return handle
    n, err = kill
    logger.warning("tier %s: scripted mid-stream kill after %d chunks",
                   tier, n)
    return BrokenStream(handle, n, err)


class BrokenStream:
    """A stream that dies after ``n_chunks`` deltas: what a card wedging
    mid-decode looks like to the consumer.  Keeps the wrapped handle's
    ``.result`` (None unless the underlying stream finished, which a
    killed one never does)."""

    def __init__(self, handle, n_chunks: int, error: str):
        self._handle = handle
        self._n = n_chunks
        self._error = error

    def __iter__(self):
        served = 0
        it = iter(self._handle)
        while True:
            if served >= self._n:
                close = getattr(self._handle, "close", None)
                if callable(close):
                    close()
                raise RuntimeError(self._error)
            try:
                delta = next(it)
            except StopIteration:
                return                    # shorter than the kill point
            served += 1
            yield delta

    @property
    def result(self):
        return getattr(self._handle, "result", None)


class BlockStarver:
    """Memory-pressure fault: confiscate free blocks of a paged engine's
    ``BlockAllocator`` (engine/paged_kv.py), as a co-tenant grabbing
    device memory would.  The KV admission gate starts rejecting, and
    running slots that cannot grow take the preempt-and-replay path.
    ``starve(n)`` takes up to ``n`` free blocks (holdings accumulate);
    ``release()`` returns them all.  Allocated blocks are never touched,
    so in-flight sequences keep their KV."""

    def __init__(self, allocator):
        self.allocator = allocator
        self._held: List[int] = []
        self._lock = threading.Lock()

    def starve(self, n: int) -> int:
        """Confiscate up to ``n`` free blocks; returns how many were
        taken (the pool may already be tighter than asked)."""
        take = min(max(0, int(n)), self.allocator.available)
        got = self.allocator.alloc(take) if take else None
        if not got:
            return 0
        with self._lock:
            self._held.extend(got)
        return len(got)

    def release(self) -> int:
        """Return every confiscated block to the pool."""
        with self._lock:
            held, self._held = self._held, []
        if held:
            self.allocator.free(held)
        return len(held)

    @property
    def held(self) -> int:
        with self._lock:
            return len(self._held)


class FaultSchedule:
    """A scripted fault timeline over a ``FaultInjector``, driven on a
    background thread.  Events are (offset_s, label, fn) applied relative
    to ``start()``; the builders cover the common shapes.  ``stop()``
    halts the driver and restores every tier it touched, releases every
    confiscated block and resumes every paused spill copier, so a
    schedule never leaks a fault past its run."""

    def __init__(self, injector: FaultInjector):
        self.injector = injector
        self._events: List[Tuple[float, str, Callable[[], None]]] = []
        self._tiers: set = set()
        self._starvers: List[BlockStarver] = []
        self._paused_spills: List[Any] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.applied: List[Tuple[float, str]] = []   # (offset_s, label)
        self._lock = threading.Lock()

    # -- builders -----------------------------------------------------------

    def at(self, offset_s: float, label: str, fn: Callable[[], None],
           tier: Optional[str] = None) -> "FaultSchedule":
        self._events.append((float(offset_s), label, fn))
        if tier:
            self._tiers.add(tier)
        return self

    def outage(self, tier: str, start_s: float, end_s: float,
               error: str = "tier offline (scheduled outage)"
               ) -> "FaultSchedule":
        """Sticky down from start_s to end_s."""
        self.at(start_s, f"down:{tier}",
                lambda: self.injector.set_down(tier, error), tier)
        self.at(end_s, f"up:{tier}",
                lambda: self.injector.restore(tier), tier)
        return self

    def flaps(self, tier: str, n: int, period_s: float, down_s: float,
              start_s: float = 0.0) -> "FaultSchedule":
        """n down/up cycles: down for down_s out of every period_s."""
        for i in range(n):
            t0 = start_s + i * period_s
            self.outage(tier, t0, t0 + down_s,
                        error=f"tier offline (flap {i + 1}/{n})")
        return self

    def latency_spike(self, tier: str, start_s: float, end_s: float,
                      seconds: float) -> "FaultSchedule":
        self.at(start_s, f"lag:{tier}",
                lambda: self.injector.add_latency(tier, seconds), tier)
        self.at(end_s, f"unlag:{tier}",
                lambda: self.injector.add_latency(tier, 0.0), tier)
        return self

    def starve_blocks(self, allocator, start_s: float, end_s: float, n: int,
                      tier: Optional[str] = None) -> "FaultSchedule":
        """Memory-pressure window: confiscate up to ``n`` free blocks of
        ``allocator`` at ``start_s``, return them at ``end_s`` (``stop()``
        releases them too)."""
        starver = BlockStarver(allocator)
        self._starvers.append(starver)
        label = tier or "pool"
        self.at(start_s, f"starve:{label}:{n}",
                lambda: starver.starve(n), tier)
        self.at(end_s, f"unstarve:{label}", starver.release, tier)
        return self

    def kill_stream(self, tier: str, at_s: float, after_chunks: int
                    ) -> "FaultSchedule":
        self.at(at_s, f"streamkill:{tier}",
                lambda: self.injector.fail_stream_after(
                    tier, after_chunks, error="scheduled mid-stream kill"),
                tier)
        return self

    def kill_replica(self, engine_getter: Callable[[], Any], at_s: float,
                     tier: Optional[str] = None) -> "FaultSchedule":
        """Crash one replica's scheduler loop at ``at_s``
        (``crash_replica_engine``).  ``engine_getter`` resolves the victim
        when the event fires: engines are rebuilt across restarts, so a
        handle taken now could be a dead engine by then."""
        def _kill():
            crash_replica_engine(engine_getter())
        self.at(at_s, f"replicakill:{tier or 'replica'}", _kill, tier)
        return self

    def wedge_spill_copier(self, spill_getter: Callable[[], Any],
                           start_s: float, end_s: float,
                           tier: Optional[str] = None) -> "FaultSchedule":
        """Hold the host-KV spill copier from ``start_s`` to ``end_s``
        (``HostKVSpill.pause``/``resume``): demote copies stay COPYING,
        promotion claims wait, and the promote race-fallback path runs, as
        under a host memcpy stall."""
        def _hold(fn_name):
            def _apply():
                spill = spill_getter()
                fn = getattr(spill, fn_name, None)
                if callable(fn):
                    fn()
                if fn_name == "pause" and spill is not None:
                    self._paused_spills.append(spill)
                elif fn_name == "resume" and spill in self._paused_spills:
                    self._paused_spills.remove(spill)
            return _apply
        self.at(start_s, f"spillwedge:{tier or 'spill'}", _hold("pause"),
                tier)
        self.at(end_s, f"spillunwedge:{tier or 'spill'}", _hold("resume"),
                tier)
        return self

    def fail_standby_publish(self, tier: str, at_s: float
                             ) -> "FaultSchedule":
        """Queue a one-shot warm-standby publish failure at ``at_s``."""
        self.at(at_s, f"publishfail:{tier}",
                lambda: self.injector.fail_standby_publish(tier), tier)
        return self

    # -- driver -------------------------------------------------------------

    def duration_s(self) -> float:
        return max((t for t, _, _ in self._events), default=0.0)

    def start(self) -> "FaultSchedule":
        if self._thread is not None:
            return self
        self._stop.clear()
        events = sorted(self._events, key=lambda e: e[0])
        t0 = time.monotonic()

        def drive():
            for offset, label, fn in events:
                wait = offset - (time.monotonic() - t0)
                if wait > 0 and self._stop.wait(wait):
                    return
                if self._stop.is_set():
                    return
                try:
                    fn()
                except Exception:
                    logger.exception("fault schedule event %s failed", label)
                with self._lock:
                    self.applied.append(
                        (round(time.monotonic() - t0, 3), label))

        self._thread = threading.Thread(target=drive, daemon=True,
                                        name="fault-schedule")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def stop(self) -> None:
        """Halt the driver, restore every touched tier, release every
        confiscated block and resume every paused copier."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        for tier in self._tiers:
            self.injector.restore(tier)
        for starver in self._starvers:
            starver.release()
        for spill in list(self._paused_spills):
            spill.resume()
        self._paused_spills = []
