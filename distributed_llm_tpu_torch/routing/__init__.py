"""The routing layer: five strategies behind ``QueryRouter`` with its
predictive routing cache and the embedders, on the router's device."""

from .cache import (CacheEntry, CacheLookupResult, QueryCache, RoutingRecord,
                    PREDICTION_CONFIDENCE_THRESHOLD, RECENCY_DECAY)
from .embedder import (HashedNgramEmbedder, HybridEmbedder, default_embedder,
                       get_embedder)
from .encoder import TrainedEncoder, encoder_available
from .engine import QueryRouter
from .strategies import (AVAILABLE_STRATEGIES, HeuristicStrategy,
                         HybridStrategy, PerfStrategy, SemanticStrategy,
                         TokenStrategy)
from .token_counter import TokenCounter, approx_token_count
from .types import RoutingDecision

__all__ = [
    "RoutingDecision", "CacheEntry", "CacheLookupResult", "QueryCache",
    "RoutingRecord", "PREDICTION_CONFIDENCE_THRESHOLD", "RECENCY_DECAY",
    "HashedNgramEmbedder", "HybridEmbedder", "default_embedder",
    "get_embedder", "TrainedEncoder", "encoder_available", "QueryRouter",
    "AVAILABLE_STRATEGIES", "HeuristicStrategy", "HybridStrategy",
    "PerfStrategy", "SemanticStrategy", "TokenStrategy",
    "TokenCounter", "approx_token_count",
]
