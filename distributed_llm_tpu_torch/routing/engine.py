"""QueryRouter — strategy selector backed by the predictive QueryCache.

The port's own copy of ``distributed_llm_tpu/routing/engine.py``; its
embedder runs on the router's ``device``.  Cache-hit logic:

1. Heavy context + cached "nano" prediction → re-route with the live strategy
   (a long conversation can make a previously-simple query complex).
2. Low prediction confidence (mixed routing history) → re-route live.
3. Otherwise return the history-predicted device directly.

``change_strategy`` swaps the strategy object but keeps the cache and perf
state (the Flask app relies on this, src/app.py:46-53).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..config import BENCHMARK_CFG, DEFAULT_CACHE_SIMILARITY
from ..device import DeviceLike
from .cache import QueryCache
from .embedder import get_embedder
from .strategies import AVAILABLE_STRATEGIES, HybridStrategy, SemanticStrategy
from .types import RoutingDecision

logger = logging.getLogger(__name__)


class QueryRouter:
    AVAILABLE_STRATEGIES = AVAILABLE_STRATEGIES

    def __init__(self, strategy: str = "token",
                 config: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        self.config = dict(config) if config is not None else dict(BENCHMARK_CFG)
        self.device = device

        if strategy not in AVAILABLE_STRATEGIES:
            raise ValueError(
                f"Unknown strategy={strategy}. Available={list(AVAILABLE_STRATEGIES)}")

        self.strategy_name = strategy
        self.cache_enabled = bool(self.config.get("cache_enabled", True))

        # One shared embedder: encodes each query once, reused for the
        # semantic strategy, cache lookup, and cache insert.  Selected by
        # config "embedding_model": the trained semantic encoder when its
        # weights file exists, hashed n-grams otherwise.
        self.cache_embedder = None
        if self.config.get("use_semantic_cache", True):
            self.cache_embedder = get_embedder(
                self.config.get("embedding_model"), device)

        # The cache threshold is calibrated PER EMBEDDER: if the config
        # asked for the trained/hybrid embedder but the artifact is
        # missing (hashed fallback in play), the trained-scale threshold
        # (0.17) would false-hit constantly on hashed scores — swap in
        # the hashed calibration.  (SemanticStrategy recalibrates its
        # own "irrelevant" floor the same way at ITS embedder selection,
        # strategies.py.)
        sim_threshold = float(self.config.get("cache_similarity_threshold",
                                              DEFAULT_CACHE_SIMILARITY))
        from .embedder import HashedNgramEmbedder
        if (isinstance(self.cache_embedder, HashedNgramEmbedder)
                and str(self.config.get("embedding_model", "")
                        ).startswith(("trained-encoder", "hybrid-lexsem"))):
            sim_threshold = DEFAULT_CACHE_SIMILARITY

        self._cache = QueryCache(
            max_size=int(self.config.get("cache_max_size", 500)),
            ttl_seconds=int(self.config.get("cache_ttl_seconds", 3600)),
            similarity_threshold=sim_threshold,
            use_semantic=bool(self.config.get("use_semantic_cache", True)),
            prediction_confidence_threshold=float(
                self.config.get("prediction_confidence_threshold", 0.70)),
        )

        self.router = self._build_strategy(strategy)

    def _build_strategy(self, strategy: str):
        cls = AVAILABLE_STRATEGIES[strategy]
        if cls in (SemanticStrategy, HybridStrategy):
            return cls(self.config,
                       embedder=self.cache_embedder or get_embedder(
                           self.config.get("embedding_model"), self.device))
        return cls(self.config)

    @property
    def strategy(self) -> str:
        return self.strategy_name

    # ------------------------------------------------------------------

    def route_query(
        self,
        query: str,
        context: Optional[str] = None,
        context_key: Optional[str] = None,
    ) -> RoutingDecision:
        ctx_key = context_key or "default"

        q_emb: Optional[np.ndarray] = None
        if self.cache_enabled and self.cache_embedder is not None:
            try:
                q_emb = self.cache_embedder.encode([query])[0]
            except Exception as exc:
                logger.warning("cache embedding failed, continuing uncached: %s", exc)

        if self.cache_enabled:
            hit = self._cache.lookup(query, ctx_key, q_emb)
            if hit is not None:
                context_len = len(context) if context else 0
                context_threshold = int(self.config.get("heuristic_context_chars", 800))

                context_override = (context_len >= context_threshold
                                    and hit.predicted_device == "nano")
                low_confidence = hit.use_hybrid_fallback

                if context_override or low_confidence:
                    reason = (
                        f"context_len={context_len}>={context_threshold} overrides cached nano"
                        if context_override
                        else f"low prediction confidence={hit.predicted_confidence:.2f}"
                    )
                    decision = self.router.route(query, context)
                    if not decision.transient:
                        self._cache.insert(
                            query, ctx_key,
                            device=decision.device,
                            confidence=decision.confidence,
                            method=decision.method,
                            q_emb=q_emb,
                        )
                        # A transient perf probe is NOT a cache-derived
                        # decision — leave its labeling alone so accuracy
                        # attribution and logs don't credit the cache.
                        decision.reasoning = (
                            f"cache hit (hybrid re-route: {reason}) | "
                            + decision.reasoning)
                        decision.cache_hit = True
                    return decision

                age = int(time.time() - hit.entry.timestamp)
                return RoutingDecision(
                    device=hit.predicted_device,
                    confidence=hit.predicted_confidence,
                    method=f"{self.strategy_name}_cached",
                    reasoning=(
                        f"cache hit age={age}s hits={hit.entry.hit_count} "
                        f"predicted={hit.predicted_device} "
                        f"conf={hit.predicted_confidence:.2f} "
                        f"context_len={context_len} "
                        f"history={len(hit.entry.routing_history)}"
                    ),
                    cache_hit=True,
                )

        decision = self.router.route(query, context)

        # Transient decisions (perf exploration probes) never seed the
        # cache — see RoutingDecision.transient.
        if self.cache_enabled and not decision.transient:
            self._cache.insert(
                query, ctx_key,
                device=decision.device,
                confidence=decision.confidence,
                method=decision.method,
                q_emb=q_emb,
            )

        return decision

    # -- cache passthroughs (reference: query_router_engine.py:651-677) ----

    def warm_up_cache(self, pairs: List[Tuple[str, str, str]]) -> None:
        self._cache.warm_up(pairs, embedder=self.cache_embedder)

    def save_cache(self, path: str) -> None:
        self._cache.save(path)

    def load_cache(self, path: str) -> int:
        return self._cache.load(path)

    def invalidate_cache(self, context_key: Optional[str] = None,
                         query_pattern: Optional[str] = None) -> int:
        return self._cache.invalidate(context_key=context_key, query_pattern=query_pattern)

    def get_cache_stats(self) -> Dict[str, Any]:
        return self._cache.stats()

    def clear_cache(self) -> None:
        self._cache.clear()

    # -- perf feedback + strategy switching --------------------------------

    def update_perf(self, device: str, latency_ms: float, tokens: int, ok: bool = True) -> None:
        if hasattr(self.router, "update"):
            self.router.update(device=device, latency_ms=latency_ms, tokens=tokens, ok=ok)

    def update_load(self, device: str, **load: Any) -> None:
        """Feed a tier's live queue/slot load into a queue-aware strategy
        (PerfStrategy.update_load); no-op for the others."""
        if hasattr(self.router, "update_load"):
            self.router.update_load(device=device, **load)

    def update_breaker(self, device: str, is_open: bool) -> None:
        """Feed a tier's circuit-breaker state into a breaker-aware
        strategy (PerfStrategy.update_breaker); no-op for the others."""
        if hasattr(self.router, "update_breaker"):
            self.router.update_breaker(device=device, is_open=is_open)

    @property
    def wants_load(self) -> bool:
        """True iff the active strategy actually SCORES load (queue-aware
        perf) — a reference-semantics perf run must not pay per-request
        admission-lock and slot-stat reads for a penalty that is
        unconditionally zero."""
        return (hasattr(self.router, "update_load")
                and getattr(self.router, "queue_aware", False))

    def change_strategy(self, strategy: str) -> None:
        if strategy not in AVAILABLE_STRATEGIES:
            raise ValueError(f"Unknown strategy={strategy}")
        self.strategy_name = strategy
        self.router = self._build_strategy(strategy)
