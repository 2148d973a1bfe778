"""Token counting for routing thresholds and response accounting.

The port's own copy of ``distributed_llm_tpu/routing/token_counter.py``:
``TokenCounter`` counts with the serving BPE tokenizer (engine/bpe.py) and
``approx_token_count`` is the calibrated estimate the token strategy uses
(word pieces of about 4 characters plus punctuation, at least 1).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

_TOKEN_RE = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def approx_token_count(text: str) -> int:
    """Estimate BPE token count: each run of 4 alphanumeric chars or single
    punctuation mark counts as one token.  Empty text counts as 1 (the
    reference floor, src/query_router_engine.py:96)."""
    if not text:
        return 1
    count = 0
    for piece in _TOKEN_RE.findall(text):
        if piece[0].isalnum():
            count += max(1, (len(piece) + 3) // 4)
        else:
            count += 1
    return max(1, count)


def _serving_tokenizer():
    try:
        from ..engine.bpe import load_default
        return load_default()
    except Exception:       # no artifact (byte-level fallback deployment)
        return None


class TokenCounter:
    """Same surface as the reference's TokenCounter (src/token_counter.py:4-12)."""

    def __init__(self):
        self._tok = _serving_tokenizer()

    def count_tokens(self, message: Dict[str, Any]) -> int:
        text = str(message.get("content", ""))
        if not text:
            return 1
        if self._tok is not None:
            return max(1, len(self._tok.encode(text, add_bos=False)))
        return approx_token_count(text)

    def get_context_size(self, history: List[Dict[str, Any]]) -> int:
        return sum(self.count_tokens(m) for m in history if isinstance(m, dict))
