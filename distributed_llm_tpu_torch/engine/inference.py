"""Prompt preparation and the generation result shared by the engines.

Counterpart of the engine-agnostic part of
``distributed_llm_tpu/engine/inference.py`` (``GenerationResult``,
``pick_bucket``, ``prepare_prompt``, ``trim_at_eos``).  The sequential
``InferenceEngine`` comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    prompt_tokens: int
    gen_tokens: int
    ttft_ms: float
    total_ms: float


def pick_bucket(buckets: Sequence[int], n: int, max_seq: int) -> int:
    """Smallest prefill bucket holding ``n`` tokens (capped at max_seq)."""
    for b in buckets:
        if n <= b and b <= max_seq:
            return b
    return min(max(buckets), max_seq)


def prepare_prompt(tokenizer, history, buckets: Sequence[int], max_seq: int,
                   reserve: int) -> Tuple[List[int], int]:
    """Tokenize and tail-truncate a prompt, and pick its bucket.
    ``reserve`` tokens stay free for generation; an overlong prompt keeps
    its TAIL (the latest turns), and a prompt past the largest bucket is
    cut to it."""
    ids = tokenizer.encode_history(history)
    max_prompt = max_seq - reserve
    if len(ids) > max_prompt:
        ids = ids[-max_prompt:]
    bucket = pick_bucket(buckets, len(ids), max_seq)
    if len(ids) > bucket:
        ids = ids[-bucket:]
    return ids, bucket


def trim_at_eos(tokens: Sequence[int], eos_id: int, pad_id: int) -> List[int]:
    """Generated ids up to (excluding) the first EOS/PAD."""
    out: List[int] = []
    for t in tokens:
        if t in (eos_id, pad_id):
            break
        out.append(int(t))
    return out
