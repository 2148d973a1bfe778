"""The web surface the serving modules import: the stdlib micro-framework
(utils/webapp.py) and the shared server-sent-event framing.

Counterpart of ``distributed_llm_tpu/utils/http_compat.py``; the port
always serves through its own stdlib framework (the machine with the
card has no Flask).
"""

from __future__ import annotations

import json

from .webapp import Flask, StreamingResponse, jsonify, request  # noqa: F401


def sse_event(obj) -> str:
    """One server-sent event frame."""
    return f"data: {json.dumps(obj)}\n\n"


def sse_done_event(result) -> str:
    """The terminal event: token count, engine-true TTFT and total time
    from a GenerationResult (or None)."""
    return sse_event({
        "done": True,
        "tokens": result.gen_tokens if result else 0,
        "ttft_ms": round(result.ttft_ms, 2) if result else None,
        "total_ms": round(result.total_ms, 2) if result else None,
    })

