"""Byte-level BPE subword tokenizer over the committed vocabulary.

The port's own copy of ``distributed_llm_tpu/engine/bpe.py`` (encode and
decode only; training the vocabulary stays with the JAX package).  As
there, an ASCII text of at least 256 characters takes the C++ merge loop
(``native/bpe_encoder.cc``, built at first use); shorter texts, where the
per-chunk cache usually hits, and non-ASCII text take the Python loop,
which the C++ loop equals id for id on ASCII.

Id layout: 0-255 raw UTF-8 bytes, 256/257/258 PAD/BOS/EOS, 259+ learned
merges in rank order, padded up to ``vocab_size`` (padding ids decode to
"").  Merges never cross ``\\s*\\S+`` pre-token chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterable, List, Optional, Tuple

from .tokenizer import BOS_ID, EOS_ID, PAD_ID, format_history

_CHUNK_RE = re.compile(r"\s*\S+|\s+$")

_FIRST_MERGE_ID = 259
DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "bpe_vocab.json")


@dataclasses.dataclass(frozen=True)
class BPETokenizer:
    """``token_bytes[id]`` is the exact UTF-8 expansion of every id (b""
    for specials and padding)."""

    merges: Tuple[Tuple[int, int], ...]
    vocab_size: int = 4096
    pad_id: int = PAD_ID
    bos_id: int = BOS_ID
    eos_id: int = EOS_ID

    def __post_init__(self):
        if _FIRST_MERGE_ID + len(self.merges) > self.vocab_size:
            raise ValueError(
                f"{len(self.merges)} merges overflow vocab {self.vocab_size}")
        ranks = {tuple(p): i for i, p in enumerate(self.merges)}
        table: List[bytes] = [bytes([i]) for i in range(256)]
        table += [b""] * (self.vocab_size - 256)       # specials + padding
        for i, (a, b) in enumerate(self.merges):
            table[_FIRST_MERGE_ID + i] = table[a] + table[b]
        object.__setattr__(self, "_ranks", ranks)
        object.__setattr__(self, "token_bytes", tuple(table))
        object.__setattr__(self, "_cache", {})

    def _encode_chunk(self, chunk: str) -> List[int]:
        hit = self._cache.get(chunk)
        if hit is not None:
            return hit
        ids = list(chunk.encode("utf-8"))
        ranks = self._ranks
        while len(ids) > 1:
            best_rank, best_i = None, -1
            for i in range(len(ids) - 1):
                r = ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            new_id = _FIRST_MERGE_ID + best_rank
            pair = (ids[best_i], ids[best_i + 1])
            out: List[int] = []
            i = 0
            while i < len(ids):
                if i + 1 < len(ids) and (ids[i], ids[i + 1]) == pair:
                    out.append(new_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        if len(self._cache) < 65536:       # bound the per-process cache
            self._cache[chunk] = ids
        return ids

    def _native_handle(self) -> int:
        """This vocabulary's merge table in the C++ loop, registered at
        first use."""
        handle = self.__dict__.get("_handle")
        if handle is None:
            from .. import native
            handle = native.bpe_load(self.merges)
            object.__setattr__(self, "_handle", handle)
        return handle

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        # Long ASCII prompts take the C++ merge loop (on ASCII, C's
        # byte-wise whitespace test and Python's \s agree); the rest stays
        # on the Python loop, as in the JAX package.
        if len(text) >= 256 and text.isascii():
            from .. import native
            ids.extend(native.bpe_encode(self._native_handle(), text))
            return ids
        for m in _CHUNK_RE.finditer(text):
            ids.extend(self._encode_chunk(m.group()))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        table = self.token_bytes
        data = b"".join(table[int(i)] for i in ids
                        if 0 <= int(i) < len(table))
        return data.decode("utf-8", errors="replace")

    def format_history(self, history) -> str:
        return format_history(history)

    def encode_history(self, history) -> List[int]:
        return self.encode(self.format_history(history))

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != "dllm-bpe-v1":
            raise ValueError(f"{path}: not a dllm-bpe-v1 vocabulary")
        return cls(merges=tuple(tuple(p) for p in payload["merges"]),
                   vocab_size=int(payload["vocab_size"]))


_DEFAULT: Optional[BPETokenizer] = None


def load_default() -> BPETokenizer:
    """The committed vocabulary (bpe_vocab.json), loaded once so every
    engine in the process shares one encode cache."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = BPETokenizer.load(DEFAULT_VOCAB_PATH)
    return _DEFAULT
