"""Hierarchical KV: a host-RAM spill tier under the device prefix cache.

Counterpart of ``distributed_llm_tpu/engine/kv_spill.py``.  Without it
the KV universe ends at ``kv_pool_blocks`` of device memory: at a session
population larger than the pool, parked prefixes are evicted long before
they are re-hit.  This module adds the tier below: when the device prefix
cache evicts an unpinned, sole-owner entry, the engine DEMOTES it here:
its blocks are snapshot off the pool by a device gather
(``paged_kv.gather_blocks``, on the engine's stream) and freed at once
(the snapshot owns its data); the device-to-host copy then drains on the
COPIER thread below, off the tick path, into pinned host tiles bounded by
a ``host_kv_bytes`` budget with its own LRU.  A later prompt that extends
a demoted prefix PROMOTES it: the admission becomes an in-flight chunked
prefill whose leading blocks are host-to-device copies instead of
compute, granted per tick under the chunk budget
(``ContinuousBatchingEngine._advance_promotion``); if the promotion loses
the race (entry invalidated, copier never landed, engine draining) the
request falls back to a cold prefill with byte-identical greedy output.

A demoted entry's tiles are the pool's own bytes, int8 scales included,
kept block-major on the host (``[nb, L, N_kv, bs, D]``, scales
``[nb, L, N_kv, bs]``) so that a grant of blocks ``lo:hi`` is one
contiguous pinned slice: the promote copy is asynchronous and the scatter
back (``paged_kv.scatter_blocks``) is bit-identical.

Concurrency (the engine's single-writer discipline):

- the SCHEDULER thread calls ``accepts``/``offer`` (demote),
  ``claim``/``release``/``entry_state`` (promote) and ``peek``;
  list and state changes take the store lock;
- the COPIER thread (a daemon, started lazily) is the only place that
  waits for a device-to-host copy: it waits for the gather's event on a
  side stream of its own (never the legacy default stream the engine's
  ticks run on), copies into pinned tiles there, and synchronizes on
  that stream alone;
- host-LRU eviction never drops an entry with a promotion in flight
  (``pins > 0``), and invalidation marks entries DEAD in place, so an
  in-flight promotion observes the race instead of reading dropped
  tiles.

A copy that fails marks its entry DEAD with the error on it; a promotion
that claimed that entry raises it (the request fails; it never turns into
a cold prefill).  ``pause``/``resume`` hold the copier before its next
job: the deterministic way to exercise the hit-during-demotion and
promotion-race paths.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..obs import get_observability

logger = logging.getLogger(__name__)

COPYING = "copying"      # demote snapshot queued or draining to the host
RESIDENT = "resident"    # host tiles landed; promotable
DEAD = "dead"            # invalidated, evicted or failed; promotions abort

Tiles = Dict[str, torch.Tensor]


class HostEntry:
    """One demoted prefix: token ids and host K/V tiles for ``nb`` blocks.

    ``tiles`` is None until the copier lands the snapshot (state
    COPYING); ``pins`` counts promotions in flight, which exempt the
    entry from host-LRU eviction; ``error`` holds the exception of a
    copy that failed."""

    __slots__ = ("ids", "nb", "nbytes", "state", "pins", "tiles", "error")

    def __init__(self, ids: Tuple[int, ...], nb: int, nbytes: int):
        self.ids = ids
        self.nb = nb
        self.nbytes = nbytes
        self.state = COPYING
        self.pins = 0
        # Pinned host tiles, block-major; promote grants read [lo:hi]
        # slices off a LOCAL reference (a concurrent invalidation nulls
        # this field: the engine snapshots it with the state check).
        self.tiles: Optional[Tiles] = None
        self.error: Optional[BaseException] = None


class HostKVSpill:
    """Budgeted host-RAM LRU of demoted prefix KV for ONE engine."""

    def __init__(self, budget_bytes: int, block_bytes: int,
                 copier_depth: int = 8, min_prefix: int = 4,
                 tier: str = ""):
        self.budget_bytes = max(0, int(budget_bytes))
        self.block_bytes = max(1, int(block_bytes))
        self.min_prefix = min_prefix
        self.tier = tier
        self._lock = threading.Lock()
        self._entries: List[HostEntry] = []     # LRU order: oldest first
        self._bytes = 0
        self._jobs: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(copier_depth)))
        self._copier: Optional[threading.Thread] = None
        self._stream = None                     # the copier's side stream
        self._stopping = threading.Event()
        self._paused = threading.Event()
        # Counters (store lock): the kv_stats and metrics source.
        self.demotions_total = 0                # host copies LANDED
        self.demotions_dropped = 0              # refused, or died mid-copy
        self.promotions_total = 0               # promotions completed
        self.promotion_races_total = 0          # promotions lost the race
        self.evictions_total = 0                # host-LRU drops
        self.host_hits = 0
        self.host_misses = 0

    # -- demote (scheduler thread) -----------------------------------------

    def accepts(self, nbytes: int) -> bool:
        """Whether ``offer`` could hold an ``nbytes`` entry now (evicting
        unpinned LRU entries counts as room).  Advisory: the engine asks
        BEFORE paying for the device gather."""
        if self._stopping.is_set() or nbytes > self.budget_bytes:
            return False
        with self._lock:
            reclaimable = sum(e.nbytes for e in self._entries
                              if e.pins == 0)
            return self._bytes - reclaimable + nbytes <= self.budget_bytes

    def _reserve(self, entry: HostEntry, nbytes: int) -> bool:
        """Make room for ``entry`` and register it, all or nothing.  Two
        kill sets, planned before anything is touched: the unpinned
        entries the new one extends or duplicates (the device cache's
        put() rule: a stale shorter copy per session would halve the
        budget's reach) and the unpinned LRU victims evicted to fit.
        When even evicting every unpinned entry cannot fit the newcomer,
        nothing is destroyed."""
        with self._lock:
            ids_t = entry.ids
            twins = [e for e in self._entries
                     if (e.pins == 0 and e.state != DEAD
                         and ids_t[:len(e.ids)] == e.ids)]
            avail = self._bytes - sum(e.nbytes for e in twins)
            victims = []
            if avail + nbytes > self.budget_bytes:
                for e in self._entries:
                    if e.pins != 0 or e in twins:
                        continue
                    victims.append(e)
                    avail -= e.nbytes
                    if avail + nbytes <= self.budget_bytes:
                        break
                if avail + nbytes > self.budget_bytes:
                    return False          # everything pinned: no room
            for e in twins + victims:
                e.state = DEAD
                e.tiles = None
                self._entries.remove(e)
                self._bytes -= e.nbytes
            self.evictions_total += len(victims)
            self._bytes += nbytes
            self._entries.append(entry)
            return True

    def offer(self, ids: Sequence[int], snapshot: Tuple[Tiles, object],
              nbytes: int, nb: int) -> bool:
        """Register a demotion: reserve budget (evicting unpinned LRU
        entries to fit, never one with a promotion in flight) and queue
        ``snapshot`` = (device tiles, the event recorded after their
        gather, or None on the CPU) for the copier.  False = not taken
        (budget or queue pressure): the blocks were already freed and the
        snapshot is simply dropped."""
        if self._stopping.is_set() or nbytes > self.budget_bytes:
            return False
        entry = HostEntry(tuple(ids), nb, int(nbytes))
        if not self._reserve(entry, int(nbytes)):
            with self._lock:
                self.demotions_dropped += 1
            return False
        try:
            self._jobs.put_nowait((entry, snapshot))
        except queue.Full:
            with self._lock:
                entry.state = DEAD
                if entry in self._entries:
                    self._entries.remove(entry)
                self._bytes -= nbytes
                self.demotions_dropped += 1
            return False
        self._ensure_copier()
        return True

    # -- copier worker (the one place a device-to-host copy is waited on) --

    def _ensure_copier(self) -> None:
        t = self._copier
        if t is not None and t.is_alive():
            return
        with self._lock:
            t = self._copier
            if t is not None and t.is_alive():
                return
            self._copier = threading.Thread(
                target=self._copier_loop, daemon=True,
                name=f"kv-spill-copier-{self.tier}")
            self._copier.start()

    def _to_host(self, snapshot: Tuple[Tiles, object]) -> Tiles:
        """The snapshot's tiles as pinned host tensors.  On the card the
        copies run on the copier's side stream after the gather's event,
        the snapshot is recorded on that stream (its memory is not reused
        before the copies have read it) and only that stream is waited
        on.  A CPU snapshot is already host memory of its own."""
        tiles, ready = snapshot
        first = next(iter(tiles.values()))
        if first.device.type != "cuda":
            return dict(tiles)
        if self._stream is None:
            self._stream = torch.cuda.Stream(first.device)
        stream = self._stream
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host = {}
            for name, t in tiles.items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
                host[name] = h
        stream.synchronize()
        return host

    def _copier_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:                     # stop sentinel
                return
            while self._paused.is_set() and not self._stopping.is_set():
                time.sleep(0.002)               # test hook: hold the copy
            entry, snapshot = job
            error: Optional[BaseException] = None
            try:
                host = self._to_host(snapshot)
            except Exception as exc:
                logger.exception("kv-spill copier (%s): demote copy failed",
                                 self.tier)
                host, error = None, exc
            del snapshot, job
            with self._lock:
                if entry.state == DEAD:
                    # Invalidated mid-copy: its budget was released then.
                    self.demotions_dropped += 1
                    continue
                if host is None:
                    # The entry must not hold budget in COPYING forever;
                    # a promotion that claimed it raises the error.
                    entry.error = error
                    entry.state = DEAD
                    if entry in self._entries:
                        self._entries.remove(entry)
                    self._bytes -= entry.nbytes
                    self.demotions_dropped += 1
                    continue
                entry.tiles = host
                entry.state = RESIDENT
                self.demotions_total += 1
            self._mirror_counter("kv_demotions")

    # -- promote / probe ----------------------------------------------------

    def _best(self, ids: Sequence[int],
              max_len: Optional[int]) -> Tuple[int, int]:
        """(entry index, matched length) of the longest non-DEAD common
        prefix: the device cache's ``_best_match`` policy (lock held by
        the caller)."""
        ids = tuple(ids)
        cap = len(ids) - 1
        if max_len is not None:
            cap = min(cap, max_len)
        best_i, best_len = -1, 0
        for i, e in enumerate(self._entries):
            if e.state == DEAD:
                continue
            bound = min(len(e.ids), cap)
            if bound < max(self.min_prefix, best_len + 1):
                continue
            if e.ids[:bound] == ids[:bound]:
                m = bound
            else:
                m = 0
                for x, y in zip(e.ids[:bound], ids[:bound]):
                    if x != y:
                        break
                    m += 1
            if m >= max(self.min_prefix, best_len + 1):
                best_i, best_len = i, m
        return best_i, best_len

    def claim(self, ids: Sequence[int], max_len: Optional[int] = None
              ) -> Optional[Tuple[HostEntry, int]]:
        """Longest demoted prefix of ``ids``, PINNED for a promotion and
        LRU-touched (a COPYING entry is claimable: the promotion waits the
        copier out).  Pair every claim with exactly one ``release``."""
        with self._lock:
            best_i, m = self._best(ids, max_len)
            if best_i < 0:
                self.host_misses += 1
                return None
            entry = self._entries.pop(best_i)
            self._entries.append(entry)
            entry.pins += 1
            self.host_hits += 1
            return entry, m

    def release(self, entry: HostEntry, promoted: bool,
                race: bool = False) -> None:
        """End of a promotion attempt: unpin and count the outcome
        (``promoted``: the blocks landed; ``race``: the cold fallback
        fired)."""
        with self._lock:
            entry.pins = max(0, entry.pins - 1)
            if promoted:
                self.promotions_total += 1
            elif race:
                self.promotion_races_total += 1
        if promoted:
            self._mirror_counter("kv_promotions")
        elif race:
            self._mirror_counter("kv_promotion_races")

    def entry_state(self, entry: HostEntry) -> str:
        return entry.state                       # single-word GIL read

    def peek(self, ids: Sequence[int],
             max_len: Optional[int] = None) -> int:
        """Longest demoted-prefix match with no pin, no LRU touch and no
        hit or miss counted."""
        with self._lock:
            _, m = self._best(ids, max_len)
        return m

    # -- invalidation / lifecycle -------------------------------------------

    def clear(self) -> None:
        """Invalidate everything: entries go DEAD in place (an in-flight
        promotion observes the race), tiles drop, the budget empties."""
        with self._lock:
            for e in self._entries:
                e.state = DEAD
                e.tiles = None
            self._entries = []
            self._bytes = 0

    def pending(self) -> int:
        """Demote copies not landed yet (queued jobs included: an entry
        leaves COPYING only when its copy lands or it dies)."""
        with self._lock:
            return sum(1 for e in self._entries if e.state == COPYING)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Wait (bounded) for every queued demote copy to land."""
        deadline = time.monotonic() + timeout_s
        while self.pending() > 0:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)
        return True

    def stop(self, timeout_s: float = 5.0) -> None:
        """Drain in-flight copies (bounded), then stop the copier.
        Idempotent."""
        self.flush(timeout_s)
        self._stopping.set()
        t = self._copier
        if t is not None and t.is_alive():
            try:
                self._jobs.put_nowait(None)
            except queue.Full:
                pass
            t.join(timeout=timeout_s)

    # -- test and bench hooks ------------------------------------------------

    def pause(self) -> None:
        """Hold the copier before its next job."""
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "resident_entries": sum(1 for e in self._entries
                                        if e.state == RESIDENT),
                "copying_entries": sum(1 for e in self._entries
                                       if e.state == COPYING),
                "blocks": sum(e.nb for e in self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "pinned_entries": sum(1 for e in self._entries
                                      if e.pins > 0),
                "demotions_total": self.demotions_total,
                "demotions_dropped": self.demotions_dropped,
                "promotions_total": self.promotions_total,
                "promotion_races_total": self.promotion_races_total,
                "evictions_total": self.evictions_total,
                "host_hits": self.host_hits,
                "host_misses": self.host_misses,
                "copy_queue_depth": self._jobs.qsize(),
            }

    def _mirror_counter(self, name: str) -> None:
        """One event on the process-global metric registry's
        ``dllm_kv_{demotions,promotions,promotion_races}_total``."""
        getattr(get_observability().m, name).labels(self.tier).inc()
