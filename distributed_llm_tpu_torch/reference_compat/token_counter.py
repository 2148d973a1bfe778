"""Bare-module alias: `from token_counter import TokenCounter`
(reference src/router.py:7)."""
from distributed_llm_tpu_torch.routing.token_counter import (  # noqa: F401
    TokenCounter)
