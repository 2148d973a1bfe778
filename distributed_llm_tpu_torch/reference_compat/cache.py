"""Bare-module alias for the routing cache (reference src/cache.py)."""
from distributed_llm_tpu_torch.routing.cache import (  # noqa: F401
    CacheEntry, CacheLookupResult, QueryCache, RoutingRecord)
