"""Training data: deterministic synthetic LM batches, numpy only.

The port's own copy of ``distributed_llm_tpu/training/data.py``: the
same word pools, templates and generators, so for the same seed and
tokenizer ``batches`` yields byte-identical arrays to the JAX package's.
No corpus can be downloaded, so the generator emits structured
pseudo-text (template sentences, and chat-shaped turns like the prompts
the tiers serve) that a model learns measurably within tens of steps;
batches are deterministic in (seed, step).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

from ..engine.tokenizer import ByteTokenizer

_WORDS = (
    "the chip mesh routes tokens across links while each core multiplies "
    "matrices and the compiler fuses kernels into one program so memory "
    "bandwidth stays busy and latency drops when batches grow"
).split()

_TEMPLATES = (
    "{} {} {} {}.",
    "when the {} runs, the {} waits for the {}.",
    "a {} is faster than a {} because of the {}.",
    "ask the {} about the {} and the {}.",
)


def synthetic_text(rng: np.random.Generator, n_sentences: int = 4) -> str:
    parts = []
    for _ in range(n_sentences):
        tpl = _TEMPLATES[rng.integers(len(_TEMPLATES))]
        k = tpl.count("{}")
        words = [_WORDS[rng.integers(len(_WORDS))] for _ in range(k)]
        parts.append(tpl.format(*words))
    return " ".join(parts)


# Chat-style generator: the serving engines see "role: content" prompts
# about everyday topics (bench/query_sets.py), so the corpus the BPE
# vocabulary and the pretrained checkpoints learn from should look like
# that — questions, short factual answers, and the occasional code-marked
# turn, over a broad everyday vocabulary (no downloadable corpora in this
# environment, so the word pool is built in).
_TOPICS = (
    "history geography science music art weather cooking travel sports "
    "animals plants oceans mountains cities countries languages books "
    "movies planets stars physics biology chemistry computers networks "
    "engines bridges markets trade money health medicine schools"
).split()
_NOUNS = (
    "capital river mountain ocean continent country city language king "
    "queen president war treaty empire republic planet moon star atom "
    "cell protein molecule engine bridge road train plane ship library "
    "book poem song painting recipe ingredient vitamin muscle bone brain "
    "heart forest desert island volcano earthquake storm cloud rainbow "
    "function variable loop array list cache thread process server model "
    "answer question example detail reason result summary comparison"
).split()
_VERBS = (
    "explain describe compare summarize list name define discuss outline "
    "analyze trace derive prove show write implement debug refactor "
    "translate compute estimate measure predict design build test"
).split()
_ADJS = (
    "largest smallest deepest oldest fastest brightest famous ancient "
    "modern simple complex common rare important useful detailed short "
    "long thorough concrete careful efficient reliable accurate"
).split()
_CHAT_TEMPLATES = (
    "user: What is the {adj} {noun} in {topic}?\n"
    "assistant: The {adj} {noun} in {topic} is the {noun2}.",
    "user: {verb} the {noun} and the {noun2} with a {adj} example.\n"
    "assistant: First, the {noun} relates to {topic}; second, the {noun2} "
    "shows a {adj} case. For example, when the {noun} changes, the {noun2} "
    "responds.",
    "user: Why does the {noun} affect the {noun2}?\n"
    "assistant: Because the {noun} drives the {noun2} through {topic}: "
    "the {adj} effect appears when both interact.",
    "user: Can you {verb} how {topic} works?\n"
    "assistant: In short: {topic} depends on the {noun}. A {adj} {noun2} "
    "makes it easier to {verb2} the details step by step.",
    "user: Write a function that returns the {adj} {noun}.\n"
    "assistant: def get_{noun}(items):\n"
    "    return max(items, key=lambda x: x.{noun2})",
    "user: How many {noun}s are there in the {adj} {noun2}?\n"
    "assistant: There are several; the exact count depends on the {topic}.",
)


def chat_text(rng: np.random.Generator, n_turns: int = 3) -> str:
    """Multi-turn chat-shaped pseudo-text over the built-in vocabulary."""
    parts = []
    for _ in range(n_turns):
        tpl = _CHAT_TEMPLATES[rng.integers(len(_CHAT_TEMPLATES))]
        parts.append(tpl.format(
            topic=_TOPICS[rng.integers(len(_TOPICS))],
            noun=_NOUNS[rng.integers(len(_NOUNS))],
            noun2=_NOUNS[rng.integers(len(_NOUNS))],
            verb=_VERBS[rng.integers(len(_VERBS))],
            verb2=_VERBS[rng.integers(len(_VERBS))],
            adj=_ADJS[rng.integers(len(_ADJS))],
        ))
    return "\n".join(parts)


def bpe_corpus(n_synthetic: int = 2000, n_chat: int = 4000,
               seed: int = 0) -> list:
    """The corpus the BPE vocabulary trains on (engine/bpe.py CLI):
    generated synthetic + chat text plus the bench query/label texts, so
    the learned pieces cover both the pretraining distribution and the
    prompts the bench actually serves."""
    rng = np.random.default_rng(seed)
    texts = [synthetic_text(rng) for _ in range(n_synthetic)]
    texts += [chat_text(rng) for _ in range(n_chat)]
    from ..bench.query_sets import query_sets
    for qset in query_sets.values():
        texts += [f"user: {item['query']}" for item in qset]
    import json
    import os
    labels = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "routing", "semantic_labels.json")
    with open(labels) as f:
        texts += [row["text"] for row in json.load(f)]
    return texts


def batches(batch_size: int, seq_len: int, seed: int = 0, tokenizer=None,
            mix_chat: bool = True
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens [B,S] int32, loss_mask [B,S] float32) forever.
    Rows alternate between the sentence generator and the chat generator
    (serving prompts are chat-shaped), encoded with the model's tokenizer
    (``get_tokenizer`` — subword BPE for serving presets)."""
    tok = tokenizer or ByteTokenizer()
    step = 0
    while True:
        rng = np.random.default_rng((seed << 20) ^ step)
        toks = np.full((batch_size, seq_len), tok.pad_id, np.int32)
        mask = np.zeros((batch_size, seq_len), np.float32)
        for b in range(batch_size):
            text = (chat_text(rng) if mix_chat and b % 2
                    else synthetic_text(rng))
            ids = tok.encode(text)[:seq_len]
            toks[b, : len(ids)] = ids
            mask[b, : len(ids)] = 1.0
        yield toks, mask
        step += 1


def pack_documents(texts: Sequence[str], seq_len: int,
                   tokenizer=None) -> np.ndarray:
    """Tokenize documents and pack them into [N, seq_len] rows with EOS
    separators — the standard LM pretraining layout (no padding waste;
    a document may span row boundaries).  Pass the MODEL's tokenizer
    (``engine.tokenizer.get_tokenizer(cfg)``) when training a serving
    preset — the byte-level default only matches ``tokenizer="byte"``
    models."""
    tok = tokenizer or ByteTokenizer()
    stream: list = []
    for text in texts:
        stream.extend(tok.encode(text))
        stream.append(tok.eos_id)
    n = len(stream) // seq_len
    if n == 0:
        raise ValueError(f"corpus too small to fill one {seq_len}-token row")
    return np.asarray(stream[: n * seq_len], np.int32).reshape(n, seq_len)


def corpus_batches(paths: Sequence[str], batch_size: int, seq_len: int,
                   seed: int = 0, loop: bool = True, tokenizer=None
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream (tokens, loss_mask) batches from text files on disk.

    Documents are split on blank lines, packed densely (pack_documents),
    and row order is reshuffled each epoch; every position carries loss
    (mask of ones) since packing leaves no padding.  ``tokenizer``: the
    model's tokenizer (get_tokenizer(cfg)); byte-level fallback only
    suits ``tokenizer="byte"`` presets.
    """
    texts: list = []
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            raw = f.read()
        texts.extend(t.strip() for t in raw.split("\n\n") if t.strip())
    rows = pack_documents(texts, seq_len, tokenizer=tokenizer)
    if len(rows) < batch_size:
        raise ValueError(f"corpus packs to {len(rows)} rows < "
                         f"batch_size={batch_size}")
    epoch = 0
    while True:
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(rows))
        for start in range(0, len(rows) - batch_size + 1, batch_size):
            # Fresh mask per batch: consumers may mask in place.
            yield (rows[order[start:start + batch_size]],
                   np.ones((batch_size, seq_len), np.float32))
        if not loop:
            return
        epoch += 1
