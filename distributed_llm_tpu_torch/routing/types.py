"""Core routing datatypes.

The port's own copy of ``distributed_llm_tpu/routing/types.py``:
``RoutingDecision`` is the seam between the routing layer and the tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DEVICES = ("nano", "orin")


@dataclasses.dataclass
class RoutingDecision:
    device: str                                # "nano" | "orin"
    confidence: float
    method: str
    reasoning: str
    complexity_score: Optional[float] = None
    cache_hit: bool = False
    # Transient decisions (e.g. perf exploration probes) must not seed
    # the predictive routing cache: a lone cached probe record would
    # normalize to vote_share 1.0 and pin similar queries to an
    # arbitrarily-probed tier for a whole TTL (routing/engine.py skips
    # the insert).
    transient: bool = False
