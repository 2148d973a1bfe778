"""Predictive routing cache.

The port's own copy of ``distributed_llm_tpu/routing/cache.py`` (host
code, no device work), with the same semantics:

- thread-safe LRU + TTL store keyed by ``md5(context_key || lowercased
  query)``;
- exact-match lookup first, then one vectorized cosine scan over the
  entries of the same context_key at a similarity threshold;
- per-entry ``routing_history`` (capped at 20) with a recency-decayed
  (0.85^i), confidence-weighted vote that predicts the device (ties go to
  "orin"), and ``use_hybrid_fallback`` when the winning share is below
  the prediction-confidence threshold;
- stale-preferred eviction, then LRU; JSON persistence dropping expired
  entries on load; a stats snapshot with the top-5 hot queries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import re
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# Below this winning-vote share the caller should re-route with the live
# router instead of trusting the cached prediction (reference: cache.py:42).
PREDICTION_CONFIDENCE_THRESHOLD = 0.60

# Per-position decay applied to older routing records, newest first
# (reference: cache.py:46).
RECENCY_DECAY = 0.85

MAX_HISTORY = 20


def _utcnow() -> float:
    return time.time()


@dataclasses.dataclass
class RoutingRecord:
    """One live routing decision recorded for a cached query."""

    device: str
    confidence: float
    method: str
    timestamp: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RoutingRecord":
        return cls(
            device=d["device"],
            confidence=float(d["confidence"]),
            method=d.get("method", "unknown"),
            timestamp=d.get("timestamp", ""),
        )


@dataclasses.dataclass
class CacheEntry:
    query: str
    query_hash: str
    context_key: str
    embedding: Optional[np.ndarray]
    timestamp: float                       # epoch seconds (monotonic enough for TTL)
    device_used: str
    response_time: Optional[float] = None
    hit_count: int = 0
    routing_history: List[RoutingRecord] = dataclasses.field(default_factory=list)

    def record_routing(self, device: str, confidence: float, method: str) -> None:
        self.routing_history.append(
            RoutingRecord(device=device, confidence=float(confidence),
                          method=method, timestamp=_iso_now()))
        del self.routing_history[:-MAX_HISTORY]
        self.device_used = device

    def predict_device(self) -> Tuple[str, float]:
        """Recency-decayed confidence-weighted vote over routing history.

        Returns ``(device, vote_share)``.  Empty or zero-weight history falls
        back to ``(device_used, 0.5)``; ties favor "orin"
        (reference: cache.py:106-140).
        """
        if not self.routing_history:
            return self.device_used, 0.5

        scores = {"nano": 0.0, "orin": 0.0}
        total = 0.0
        for age, rec in enumerate(reversed(self.routing_history)):
            w = (RECENCY_DECAY ** age) * rec.confidence
            scores["orin" if rec.device == "orin" else "nano"] += w
            total += w

        if total < 1e-9:
            return self.device_used, 0.5

        winner = "orin" if scores["orin"] >= scores["nano"] else "nano"
        return winner, float(min(scores[winner] / total, 1.0))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "query": self.query,
            "query_hash": self.query_hash,
            "context_key": self.context_key,
            "embedding": None if self.embedding is None else np.asarray(self.embedding).tolist(),
            "timestamp": self.timestamp,
            "device_used": self.device_used,
            "response_time": self.response_time,
            "hit_count": self.hit_count,
            "routing_history": [r.to_dict() for r in self.routing_history],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CacheEntry":
        emb = d.get("embedding")
        return cls(
            query=d["query"],
            query_hash=d["query_hash"],
            context_key=d["context_key"],
            embedding=None if emb is None else np.asarray(emb, dtype=np.float32),
            timestamp=float(d["timestamp"]),
            device_used=d["device_used"],
            response_time=d.get("response_time"),
            hit_count=int(d.get("hit_count", 0)),
            routing_history=[RoutingRecord.from_dict(r) for r in d.get("routing_history", [])],
        )


def _iso_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime())


@dataclasses.dataclass
class CacheLookupResult:
    entry: CacheEntry
    predicted_device: str
    predicted_confidence: float
    use_hybrid_fallback: bool


class QueryCache:
    """Thread-safe LRU+TTL routing cache with semantic lookup and predictive
    device voting."""

    def __init__(
        self,
        max_size: int = 100,
        ttl_seconds: int = 300,
        similarity_threshold: float = 0.40,   # = config.DEFAULT_CACHE_SIMILARITY
        use_semantic: bool = True,
        prediction_confidence_threshold: float = PREDICTION_CONFIDENCE_THRESHOLD,
    ):
        self.max_size = max_size
        self.ttl_seconds = ttl_seconds
        self.similarity_threshold = similarity_threshold
        self.use_semantic = use_semantic
        self.prediction_confidence_threshold = prediction_confidence_threshold

        self._store: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._attempts = 0
        self._evictions = 0
        self._hybrid_fallbacks = 0

    # -- lookup ------------------------------------------------------------

    def lookup(
        self,
        query: str,
        context_key: str,
        q_emb: Optional[np.ndarray] = None,
    ) -> Optional[CacheLookupResult]:
        """Exact-hash match first, then semantic similarity; None on miss."""
        self._evict_expired()

        qhash = self._make_hash(query, context_key)
        entry: Optional[CacheEntry] = None
        snapshot: List[Tuple[str, np.ndarray]] = []

        with self._lock:
            # Counter mutated under the lock (the reference increments it
            # outside — a stats race we deliberately fix, SURVEY.md §7 quirks).
            self._attempts += 1
            cand = self._store.get(qhash)
            if cand is not None and cand.context_key == context_key:
                if self._is_valid(cand):
                    entry = self._touch(qhash, cand)
                else:
                    self._delete(qhash)

            if entry is None:
                if not self.use_semantic or q_emb is None:
                    return None
                # Snapshot embeddings under the lock; similarity math happens
                # outside it (reference discipline: cache.py:267-305).
                snapshot = [
                    (h, np.array(e.embedding, copy=True))
                    for h, e in self._store.items()
                    if e.context_key == context_key
                    and e.embedding is not None
                    and self._is_valid(e)
                ]

        if entry is None:
            best = self._best_semantic_match(q_emb, snapshot)
            if best is None:
                return None
            with self._lock:
                cand = self._store.get(best)
                if cand is None or not self._is_valid(cand):
                    return None
                entry = self._touch(best, cand)

        device, conf = entry.predict_device()
        fallback = conf < self.prediction_confidence_threshold
        if fallback:
            self._hybrid_fallbacks += 1

        return CacheLookupResult(
            entry=entry,
            predicted_device=device,
            predicted_confidence=conf,
            use_hybrid_fallback=fallback,
        )

    def _best_semantic_match(
        self, q_emb: np.ndarray, snapshot: Sequence[Tuple[str, np.ndarray]]
    ) -> Optional[str]:
        """Single vectorized cosine scan over the snapshot."""
        if not snapshot:
            return None
        q = np.asarray(q_emb, dtype=np.float32)
        qn = float(np.linalg.norm(q))
        if qn < 1e-9:
            return None
        # Entries persisted under a different embedding_model (e.g. a
        # hashed-384 cache file loaded into a trained-encoder-128
        # session) are incomparable — skip them rather than crash the
        # stack; they age out by TTL/LRU.
        snapshot = [(h, emb) for h, emb in snapshot if emb.shape == q.shape]
        if not snapshot:
            return None
        mat = np.stack([emb for _, emb in snapshot]).astype(np.float32)
        norms = np.linalg.norm(mat, axis=1)
        safe = norms > 1e-9
        sims = np.zeros(len(snapshot), dtype=np.float32)
        sims[safe] = (mat[safe] @ q) / (norms[safe] * qn)
        idx = int(np.argmax(sims))
        if sims[idx] < self.similarity_threshold:
            return None
        return snapshot[idx][0]

    def _touch(self, qhash: str, entry: CacheEntry) -> CacheEntry:
        """Register a hit on an entry. Lock must be held."""
        entry.hit_count += 1
        self._store.move_to_end(qhash)
        self._hits += 1
        return entry

    # -- insert ------------------------------------------------------------

    def insert(
        self,
        query: str,
        context_key: str,
        device: str,
        confidence: float = 1.0,
        method: str = "unknown",
        q_emb: Optional[np.ndarray] = None,
        response_time: Optional[float] = None,
    ) -> None:
        """Insert or refresh-in-place, recording the decision in history."""
        qhash = self._make_hash(query, context_key)
        with self._lock:
            existing = self._store.get(qhash)
            if existing is not None:
                existing.timestamp = _utcnow()
                existing.record_routing(device, confidence, method)
                if q_emb is not None:
                    existing.embedding = np.array(q_emb, copy=True)
                if response_time is not None:
                    existing.response_time = response_time
                self._store.move_to_end(qhash)
                return

            if len(self._store) >= self.max_size:
                self._evict_one()

            entry = CacheEntry(
                query=query,
                query_hash=qhash,
                context_key=context_key,
                embedding=None if q_emb is None else np.array(q_emb, copy=True),
                timestamp=_utcnow(),
                device_used=device,
                response_time=response_time,
            )
            entry.record_routing(device, confidence, method)
            self._store[qhash] = entry

    # -- maintenance -------------------------------------------------------

    def invalidate(
        self,
        context_key: Optional[str] = None,
        query_pattern: Optional[str] = None,
    ) -> int:
        """Remove entries matching context_key and/or a query regex.
        Neither filter → remove everything. Returns removal count."""
        pattern = re.compile(query_pattern, re.IGNORECASE) if query_pattern else None
        with self._lock:
            doomed = [
                h for h, e in self._store.items()
                if (context_key is None or e.context_key == context_key)
                and (pattern is None or pattern.search(e.query))
            ]
            for h in doomed:
                self._delete(h)
        return len(doomed)

    def warm_up(self, pairs: Sequence[Tuple[str, str, str]], embedder: Any = None) -> None:
        """Pre-populate from ``(query, context_key, device)`` triples,
        optionally encoding embeddings with the given embedder."""
        embeddings: List[Optional[np.ndarray]] = [None] * len(pairs)
        if embedder is not None:
            try:
                embeddings = list(embedder.encode([q for q, _, _ in pairs]))
            except Exception as exc:  # embedding failure → insert without vectors
                logger.warning("warm_up embedding failed: %s", exc)
        for (query, ctx, device), emb in zip(pairs, embeddings):
            self.insert(query, ctx, device, q_emb=emb)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        self._evict_expired()
        with self._lock:
            payload = [e.to_dict() for e in self._store.values()]
        Path(path).write_text(json.dumps(payload, indent=2), encoding="utf-8")

    def load(self, path: str) -> int:
        p = Path(path)
        if not p.exists():
            logger.warning("cache load: no such file %s", path)
            return 0
        try:
            raw = json.loads(p.read_text(encoding="utf-8"))
        except json.JSONDecodeError as exc:
            logger.error("cache load: bad JSON: %s", exc)
            return 0

        loaded = 0
        with self._lock:
            for d in raw:
                try:
                    entry = CacheEntry.from_dict(d)
                except Exception as exc:
                    logger.warning("cache load: skipping malformed entry: %s", exc)
                    continue
                if not self._is_valid(entry):
                    continue
                self._store[entry.query_hash] = entry
                loaded += 1
        return loaded

    # -- stats -------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            valid = sum(1 for e in self._store.values() if self._is_valid(e))
            size = len(self._store)
            hot = sorted(self._store.values(), key=lambda e: e.hit_count, reverse=True)[:5]
            top = []
            for e in hot:
                dev, conf = e.predict_device()
                top.append({
                    "query": e.query[:60],
                    "hits": e.hit_count,
                    "predicted_device": dev,
                    "predicted_confidence": round(conf, 3),
                    "history_len": len(e.routing_history),
                })
            # Counters read under the same lock (the reference reads size
            # outside it, cache.py:481 — SURVEY.md §7 quirks).
            return {
                "size": size,
                "max_size": self.max_size,
                "valid": valid,
                "stale": size - valid,
                "hits": self._hits,
                "attempts": self._attempts,
                "hit_rate": round(self._hits / max(self._attempts, 1), 4),
                "evictions": self._evictions,
                "hybrid_fallbacks": self._hybrid_fallbacks,
                "top_queries": top,
            }

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self._hits = self._attempts = self._evictions = self._hybrid_fallbacks = 0

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _make_hash(query: str, context_key: str) -> str:
        return hashlib.md5(f"{context_key}||{query.lower().strip()}".encode("utf-8")).hexdigest()

    def _is_valid(self, entry: CacheEntry) -> bool:
        return (_utcnow() - entry.timestamp) <= self.ttl_seconds

    def _delete(self, qhash: str) -> None:
        self._store.pop(qhash, None)

    def _evict_expired(self) -> None:
        with self._lock:
            for h in [h for h, e in self._store.items() if not self._is_valid(e)]:
                self._delete(h)
                self._evictions += 1

    def _evict_one(self) -> None:
        """Evict a stale entry if any exists, else the LRU head. Lock held."""
        for h, e in self._store.items():
            if not self._is_valid(e):
                self._delete(h)
                self._evictions += 1
                return
        if self._store:
            self._delete(next(iter(self._store)))
            self._evictions += 1
