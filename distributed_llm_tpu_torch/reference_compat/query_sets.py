"""Bare-module alias: `from query_sets import query_sets`
(reference src/tests/routing_chatbot_tester.py:35)."""
from distributed_llm_tpu_torch.bench.query_sets import query_sets  # noqa: F401
