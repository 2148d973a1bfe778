"""Tokenizer selection, the special ids and the streaming decoder.

The port's own copy of ``distributed_llm_tpu/engine/tokenizer.py``.
Every preset uses the trained subword BPE (engine/bpe.py); the JAX
package's byte-level fallback tokenizer is not ported (no preset uses
it).  Ids 0-255 are raw UTF-8 bytes, then PAD/BOS/EOS.
"""

from __future__ import annotations

import codecs
from typing import Any, Dict, Sequence, Union

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258


def format_history(history: Union[str, Sequence[Dict[str, Any]]]) -> str:
    """Conversation history -> prompt string: one "role: content" line per
    message."""
    if isinstance(history, str):
        return history.strip()
    lines = [
        f"{m.get('role', 'user')}: {m.get('content', '')}"
        for m in history
    ]
    return "\n".join(lines).strip()


def get_tokenizer(cfg):
    """The committed BPE vocabulary; its size must match the preset's."""
    if cfg.tokenizer != "bpe":
        raise NotImplementedError(
            f"model {cfg.name}: tokenizer {cfg.tokenizer!r} is not ported "
            "(only the BPE vocabulary is)")
    from .bpe import load_default
    tok = load_default()
    if tok.vocab_size != cfg.vocab_size:
        raise ValueError(
            f"model {cfg.name}: vocab_size {cfg.vocab_size} != BPE "
            f"artifact vocab {tok.vocab_size}")
    return tok


class StreamDecoder:
    """Incremental token -> text-delta decoder over the tokenizer's
    ``token_bytes``: multi-byte UTF-8 sequences are held back until
    complete; special and padding ids give no text."""

    def __init__(self, tokenizer):
        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")
        self._table = tokenizer.token_bytes

    def feed(self, token: int) -> str:
        data = self._table[token] if 0 <= token < len(self._table) else b""
        return self._decoder.decode(data) if data else ""

    def flush(self) -> str:
        return self._decoder.decode(b"", final=True)
