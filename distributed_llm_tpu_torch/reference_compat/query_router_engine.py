"""Bare-module alias for the reference's routing-engine module surface
(src/router.py:8, src/tests/routing_chatbot_tester.py:34)."""
from distributed_llm_tpu_torch.config import (BENCHMARK_CFG,  # noqa: F401
                                              PRODUCTION_CFG)
from distributed_llm_tpu_torch.routing.engine import QueryRouter  # noqa: F401
from distributed_llm_tpu_torch.routing.strategies import (  # noqa: F401
    AVAILABLE_STRATEGIES, HeuristicStrategy, HybridStrategy, PerfStrategy,
    SemanticStrategy, TokenStrategy)
from distributed_llm_tpu_torch.routing.types import (  # noqa: F401
    RoutingDecision)
