"""Tokenizer selection, the special ids and the streaming decoder.

The port's own copy of ``distributed_llm_tpu/engine/tokenizer.py``.
Every preset uses the trained subword BPE (engine/bpe.py); the
byte-level ``ByteTokenizer`` is the training data's default
(``training/data.py``) and serves ``tokenizer="byte"`` configs.  Ids
0-255 are raw UTF-8 bytes, then PAD/BOS/EOS, in a vocabulary of 512.
"""

from __future__ import annotations

import codecs
import dataclasses
from typing import Any, Dict, Iterable, List, Sequence, Union

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 512


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


@dataclasses.dataclass(frozen=True)
class ByteTokenizer:
    """UTF-8 bytes as ids 0-255, BOS first; decoding drops the specials."""

    pad_id: int = PAD_ID
    bos_id: int = BOS_ID
    eos_id: int = EOS_ID
    vocab_size: int = VOCAB_SIZE

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def format_history(self, history) -> str:
        return format_history(history)

    def encode_history(self, history) -> List[int]:
        return self.encode(self.format_history(history))

    @property
    def token_bytes(self) -> List[bytes]:
        """Each id's UTF-8 bytes (the specials and padding none)."""
        return [bytes([i]) if i < 256 else b""
                for i in range(self.vocab_size)]


def get_tokenizer(cfg):
    """The committed BPE vocabulary for ``tokenizer="bpe"`` (its size must
    match the preset's), the byte-level one otherwise."""
    if cfg.tokenizer != "bpe":
        return ByteTokenizer()
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
