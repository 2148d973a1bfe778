"""The web surface the serving modules import: the stdlib micro-framework
(utils/webapp.py), the shared server-sent-event framing and the response
helpers of the ``/chat`` app.

Counterpart of ``distributed_llm_tpu/utils/http_compat.py``; the port
always serves through its own stdlib framework (the machine with the
card has no Flask).
"""

from __future__ import annotations

import json

from .webapp import (Flask, Response, StreamingResponse, jsonify,  # noqa: F401
                     request)


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



def streaming_response(chunks, content_type: str = "text/event-stream"):
    """A chunked (SSE) response."""
    return StreamingResponse(chunks, content_type)


def static_response(body: bytes, content_type: str):
    """A raw-body response with an explicit content type (the frontend's
    files)."""
    return Response(body, 200, content_type)


def enable_cors(app) -> None:
    """Nothing to do: webapp.py sends Access-Control-Allow-Origin on
    every response."""
