"""Bare-module alias: `from router import Router` (reference src/app.py:3)."""
from distributed_llm_tpu_torch.serving.router import Router  # noqa: F401
