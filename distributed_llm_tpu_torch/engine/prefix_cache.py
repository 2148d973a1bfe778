"""Session KV prefix reuse: skip re-prefilling shared prompt prefixes.

The port's own copy of ``distributed_llm_tpu/engine/prefix_cache.py``.
After a generation the engine parks the request's prompt token ids and
the KV holding them here (the batched engine's pool blocks, the
sequential engine's whole contiguous cache); the next prompt that
extends a parked prompt (a multi-turn chat: old prompt + reply + new
turn) reclaims them and prefills only the suffix.

Two reuse modes:

- **take** (``TierConfig.share_prefix_kv=False``): a reclaimed entry is
  REMOVED and the slot owns its blocks;
- **share** (the default): a hit PINS the entry in place and the slot
  maps its blocks read-only (``BlockAllocator.share`` increfs them),
  copying the partially filled boundary block before writing its suffix
  (copy-on-write).  ``unpin`` drops the pin when the slot releases;
  pinned entries are never evicted.

Matching is exact-prefix on token ids; a truncated prompt simply misses.
A plain lock guards the entry list and pin counts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class PrefixEntry:
    ids: Tuple[int, ...]     # prompt token ids whose KV the entry holds
    cache: Any               # {"blocks": [pool block ids]} or a KV cache
    pins: int = 0            # live sharers mapping the blocks


def select_reuse(store: "Optional[PrefixCache]", ids: Sequence[int],
                 buckets: Sequence[int], max_seq: int,
                 allow_long_suffix: bool = False, share: bool = False):
    """(entry, matched_len, suffix_ids, suffix_bucket) when a parked
    prefix can be extended by a suffix that fits one of ``buckets``
    within ``max_seq``; else None, with any taken or pinned entry given
    back.  ``allow_long_suffix``: a suffix no bucket holds still reuses
    the entry, with suffix_bucket None, when its largest-bucket stride
    from the matched position fits ``max_seq`` (the sequential engine
    chunk-prefills it from there)."""
    if store is None or not buckets:
        return None
    if share:
        entry, m = store.share(ids, max_len=max_seq - buckets[0])
    else:
        entry, m = store.take(ids, max_len=max_seq - buckets[0])
    if entry is None:
        return None
    suffix = ids[m:]
    sb = next((b for b in buckets
               if len(suffix) <= b and m + b <= max_seq), None)
    if sb is None:
        cb = buckets[-1]
        if allow_long_suffix and m + -(-len(suffix) // cb) * cb <= max_seq:
            return entry, m, suffix, None
        if share:
            store.unshare(entry, m)
        else:
            store.untake(entry, m)
        return None
    return entry, m, suffix, sb


class PrefixCache:
    """Small LRU of (token-id prefix -> parked pool blocks) for one engine.

    ``on_evict(entry)`` is called for every entry dropped by put(),
    clear() or pop_oldest(); the engine frees the entry's blocks there (a
    refcounted decref: blocks a live slot still shares stay resident).
    ``block_refcounts`` (the allocator's batch reader) keeps
    ``reclaimable_blocks`` honest under sharing."""

    def __init__(self, capacity: int = 4, min_prefix: int = 4,
                 on_evict: Optional[Callable[[PrefixEntry], None]] = None,
                 block_refcounts: Optional[
                     Callable[[List[int]], List[int]]] = None):
        self.capacity = capacity
        self.min_prefix = min_prefix       # in tokens
        self.on_evict = on_evict
        self.block_refcounts = block_refcounts
        self._entries: List[PrefixEntry] = []   # LRU order: oldest first
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hits_exclusive = 0
        self.hits_shared = 0
        self.tokens_saved_exclusive = 0
        self.tokens_saved_shared = 0

    def _best_match(self, ids: Sequence[int], max_len: Optional[int],
                    skip_pinned: bool = False) -> Tuple[int, int]:
        """(entry index, matched length) of the longest parked common
        prefix of ``ids``, or (-1, 0).  The match is capped at
        len(ids) - 1 (the caller needs >= 1 suffix token to forward) and
        at ``max_len`` (suffix-bucket headroom).  Lock held by caller."""
        ids = tuple(ids)
        cap = len(ids) - 1
        if max_len is not None:
            cap = min(cap, max_len)
        best_i, best_len = -1, 0
        for i, e in enumerate(self._entries):
            if skip_pinned and e.pins > 0:
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

    def take(self, ids: Sequence[int], max_len: Optional[int] = None
             ) -> Tuple[Optional[PrefixEntry], int]:
        """Longest parked prefix of ``ids``, REMOVED from the cache;
        pinned entries are skipped (a taker writes its boundary block)."""
        with self._lock:
            best_i, best_len = self._best_match(ids, max_len,
                                                skip_pinned=True)
            if best_i < 0:
                self.misses += 1
                return None, 0
            entry = self._entries.pop(best_i)
            self.hits += 1
            self.hits_exclusive += 1
            self.tokens_saved_exclusive += best_len
            return entry, best_len

    def share(self, ids: Sequence[int], max_len: Optional[int] = None
              ) -> Tuple[Optional[PrefixEntry], int]:
        """Pinning twin of ``take``: the entry stays parked (LRU-touched)
        with its pin count raised.  Pair with ``unpin`` or ``unshare``."""
        with self._lock:
            best_i, best_len = self._best_match(ids, max_len)
            if best_i < 0:
                self.misses += 1
                return None, 0
            entry = self._entries.pop(best_i)
            self._entries.append(entry)
            entry.pins += 1
            self.hits += 1
            self.hits_shared += 1
            self.tokens_saved_shared += best_len
            return entry, best_len

    def peek(self, ids: Sequence[int], max_len: Optional[int] = None) -> int:
        """Longest reusable common-prefix length a take() would find, with
        no removal, no LRU touch and no hit/miss accounting: the router's
        prefix-affinity probe must not perturb the cache.  ``max_len``
        mirrors take()'s cap."""
        with self._lock:
            _, best = self._best_match(ids, max_len)
        return best

    def unpin(self, entry: PrefixEntry) -> None:
        """Drop one sharer's pin (its slot released)."""
        with self._lock:
            entry.pins = max(0, entry.pins - 1)

    def unshare(self, entry: PrefixEntry, matched_len: int) -> None:
        """Undo a ``share`` whose hit the caller could not use."""
        with self._lock:
            entry.pins = max(0, entry.pins - 1)
            self.hits -= 1
            self.hits_shared -= 1
            self.tokens_saved_shared -= matched_len
            self.misses += 1

    def untake(self, entry: PrefixEntry, matched_len: int) -> None:
        """Undo a ``take`` whose entry the caller could not use."""
        evicted: List[PrefixEntry] = []
        with self._lock:
            self.hits -= 1
            self.hits_exclusive -= 1
            self.tokens_saved_exclusive -= matched_len
            self.misses += 1
            self._entries.append(entry)
            self._evict_over_capacity(evicted)
        self._drop(evicted)

    def _evict_over_capacity(self, evicted: List[PrefixEntry]) -> None:
        """Pop the oldest UNPINNED entries until within capacity, never
        the just-appended last one (lock held by the caller)."""
        while len(self._entries) > self.capacity:
            ix = next((i for i, e in enumerate(self._entries[:-1])
                       if e.pins == 0), None)
            if ix is None:
                return
            evicted.append(self._entries.pop(ix))

    def _drop(self, evicted: List[PrefixEntry]) -> None:
        for e in evicted:
            if self.on_evict is not None:
                self.on_evict(e)

    def put(self, ids: Sequence[int], cache: Any) -> bool:
        """Park ``cache`` for ``ids``.  False (ownership NOT taken) for a
        prompt shorter than ``min_prefix``.  Unpinned entries this one
        extends are replaced."""
        if len(ids) < self.min_prefix:
            return False
        ids = tuple(ids)
        evicted: List[PrefixEntry] = []
        with self._lock:
            keep = []
            for e in self._entries:
                extends = ids[:len(e.ids)] == e.ids and e.pins == 0
                (evicted if extends else keep).append(e)
            keep.append(PrefixEntry(ids, cache))
            self._entries = keep
            self._evict_over_capacity(evicted)
        self._drop(evicted)
        return True

    def pop_oldest(self, match=None) -> Optional[PrefixEntry]:
        """Evict (after on_evict) the LRU unpinned entry, or None.
        ``match`` (entry -> bool) restricts the candidates: the engine's
        per-tenant KV budgets evict over-quota tenants' entries first.
        It runs under the lock and must not call back into this cache."""
        with self._lock:
            ix = next((i for i, e in enumerate(self._entries)
                       if e.pins == 0 and (match is None or match(e))),
                      None)
            if ix is None:
                return None
            entry = self._entries.pop(ix)
        self._drop([entry])
        return entry

    def entries_snapshot(self) -> List[PrefixEntry]:
        """A point-in-time copy of the entries (advisory reads: resident
        KV billing, the scale-down victim's parked tokens)."""
        with self._lock:
            return list(self._entries)

    def reclaimable_blocks(self) -> int:
        """Blocks an eviction sweep could actually free: unpinned entries'
        blocks whose refcount is 1."""
        with self._lock:
            total = 0
            for e in self._entries:
                if e.pins > 0:
                    continue
                blocks = e.cache.get("blocks") if isinstance(e.cache, dict) else None
                if not blocks:
                    continue
                if self.block_refcounts is None:
                    total += len(blocks)
                else:
                    total += sum(1 for r in self.block_refcounts(blocks)
                                 if r == 1)
            return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "pinned_entries": sum(1 for e in self._entries if e.pins > 0),
                "hits": self.hits,
                "hits_exclusive": self.hits_exclusive,
                "hits_shared": self.hits_shared,
                "misses": self.misses,
                "tokens_saved": (self.tokens_saved_exclusive
                                 + self.tokens_saved_shared),
                "tokens_saved_exclusive": self.tokens_saved_exclusive,
                "tokens_saved_shared": self.tokens_saved_shared,
            }

    def clear(self) -> None:
        with self._lock:
            entries, self._entries = self._entries, []
        self._drop(entries)
