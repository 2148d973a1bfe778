"""The sequential engine: one request at a time over a contiguous KV cache.

Counterpart of ``distributed_llm_tpu/engine/inference.py``: the shared
prompt helpers (``GenerationResult``, ``pick_bucket``, ``prepare_prompt``,
``trim_at_eos``) and ``InferenceEngine``, which serves a tier with
``decode_batch=1``:

- tokenize, then a bucketed cold prefill (the flash causal kernel) that
  seeds a cache sized for the conversation from a short ladder of
  lengths {256, 1024, max_seq};
- a prompt past the largest bucket prefills in largest-bucket chunks
  against the cache (the flash chunk kernel), instead of being cut;
- a prompt that extends a parked one (multi-turn chat) reclaims the
  parked cache, grown to a longer rung if it must be, and prefills only
  the suffix over the whole allocated span, or chunk by chunk from the
  matched position when the new turn is longer than a bucket;
- decode runs one ``decode_step`` per token (the flash decode kernel,
  int8 with ``kv_quantize="int8"``) with sampled tokens fed back on the
  device, and reads the tokens back once per ``SEGMENT`` (8) steps;
  tokens after an EOS are replaced by PAD exactly as the JAX loop does,
  so the output is the JAX engine's at up to 7 wasted steps.

Each request is timed by phase in ``self.phases``
(``utils/telemetry.PhaseTimer``: "tokenize", "prefill", each decode
segment's "decode", "detokenize") with the roofline work the JAX engine
accounts (``utils/roofline.py``).  The prefill phase closes after the
first token's host read and a decode segment's after its tokens' read,
so on the card each covers the device work it launched.  A segment may
run up to 7 steps past an EOS, and its work counts the steps it ran.

The JAX engine's mesh, sequence- and tensor-parallel hooks are not
ported.  Calls are not thread-safe: callers serialize them (the
``/query`` server holds one lock per engine).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.transformer import KVCache, Transformer
from ..ops import quant
from ..ops.attention import decode_kv_span
from ..ops.sampling import sample_token_dynamic
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .tokenizer import StreamDecoder, get_tokenizer

History = Union[str, Sequence[Dict[str, Any]]]

# Decode steps launched between two host reads of the tokens: the most a
# request decodes past its EOS.
SEGMENT = 8


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    prompt_tokens: int
    gen_tokens: int
    ttft_ms: float
    total_ms: float

    @property
    def tokens_per_s(self) -> float:
        """Generated tokens over the request's whole time."""
        if self.total_ms <= 0 or self.gen_tokens == 0:
            return 0.0
        return 1000.0 * self.gen_tokens / self.total_ms


def pick_bucket(buckets: Sequence[int], n: int, max_seq: int) -> int:
    """Smallest prefill bucket holding ``n`` tokens (capped at max_seq)."""
    for b in buckets:
        if n <= b and b <= max_seq:
            return b
    return min(max(buckets), max_seq)


def prepare_prompt(tokenizer, history, buckets: Sequence[int], max_seq: int,
                   reserve: int, allow_long: bool = False
                   ) -> Tuple[List[int], int]:
    """Tokenize and tail-truncate a prompt, and pick its bucket.
    ``reserve`` tokens stay free for generation; an overlong prompt keeps
    its TAIL (the latest turns), and a prompt past the largest bucket is
    cut to it unless ``allow_long`` (an engine that prefills long prompts
    in chunks)."""
    ids = tokenizer.encode_history(history)
    max_prompt = max_seq - reserve
    if len(ids) > max_prompt:
        ids = ids[-max_prompt:]
    bucket = pick_bucket(buckets, len(ids), max_seq)
    if len(ids) > bucket and not allow_long:
        ids = ids[-bucket:]
    return ids, bucket


def to_device(values, device: torch.device,
              dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A small host list as a tensor on ``device``."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def padded_tokens(ids: Sequence[int], width: int, pad_id: int,
                  device: torch.device) -> torch.Tensor:
    """``ids`` right-padded to ``width`` as a [1, width] token tensor."""
    tokens = [pad_id] * width
    tokens[:len(ids)] = ids
    return to_device([tokens], device, torch.long)


def trim_at_eos(tokens: Sequence[int], eos_id: int, pad_id: int) -> List[int]:
    """Generated ids up to (excluding) the first EOS/PAD."""
    out: List[int] = []
    for t in tokens:
        if t in (eos_id, pad_id):
            break
        out.append(int(t))
    return out


@dataclasses.dataclass
class _Prefilled:
    """What a prefill hands to decode."""
    first: int                  # the sampled first token
    cache: KVCache
    cache_len: int
    ids: List[int]
    budget: int                 # tokens to generate, the first included
    temperature: float
    ttft_ms: float
    t0: float


class InferenceEngine:
    """Single-sequence engine: synchronous ``generate()`` and
    ``generate_stream()``.  Runs on the card unless ``device="cpu"`` is
    asked for (the plain PyTorch path); ``params`` replaces the seeded
    random weights."""

    def __init__(self, tier: TierConfig, seed: int = 0,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None):
        tier.check_ported()
        self.tier = tier
        self.device = resolve_device(device)
        self.cfg = tier.model()
        self.tokenizer = get_tokenizer(self.cfg)
        if self.device.type == "cuda":
            # Every kernel compiles (in parallel) before the first request.
            from ..ops import _build
            _build.build_all()
        if params is None:
            params = transformer.init_params(self.cfg, seed=seed,
                                             device=self.device)
        self.model = quant.maybe_quantize(params.to(self.device), tier,
                                          self.cfg)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
        self._max_seq = self.cfg.max_seq_len
        self._buckets = sorted(set(
            b for b in tier.prefill_buckets if b <= self._max_seq))
        # Suffix buckets a prefix hit prefills through (the <=256-token
        # rungs, typical chat turns); a longer new turn chunk-strides.
        self._reuse_buckets = ([b for b in self._buckets if b <= 256][:3]
                               or self._buckets[:1])
        # Cache lengths: decode reads the cache up to its position every
        # step, and the cache is sized to the conversation, not max_seq.
        self._cache_lens = sorted(
            {c for c in (256, 1024) if c < self._max_seq} | {self._max_seq})
        self._kv_quantize = tier.kv_quantize
        self.phases = PhaseTimer()
        self._wbytes = roofline.weight_bytes(self.cfg, tier.quantize)
        from .prefix_cache import PrefixCache
        self.prefix_cache = (
            PrefixCache(capacity=tier.prefix_cache_entries)
            if tier.enable_prefix_cache and tier.prefix_cache_entries > 0
            else None)

    # -- device work -------------------------------------------------------

    def _pick_cache_len(self, needed: int) -> int:
        """Smallest cache-length rung covering ``needed`` positions."""
        return next(c for c in self._cache_lens
                    if c >= min(needed, self._max_seq))

    def _suffix_window(self, needed: int) -> int:
        """Smallest bucketed attention window covering ``needed`` cache
        positions (else the whole sequence)."""
        return next((b for b in self._buckets if b >= needed), self._max_seq)

    def _padded(self, ids: Sequence[int], width: int) -> torch.Tensor:
        return padded_tokens(ids, width, self.tokenizer.pad_id, self.device)

    def _sample(self, hidden_row: torch.Tensor, temp: float) -> torch.Tensor:
        logits = transformer.logits_from_hidden(self.model, hidden_row)
        return sample_token_dynamic(logits, self._gen, temp)

    def _prefill(self, ids: List[int], bucket: int, cache_len: int,
                 temp: float):
        """Cold prefill of one bucket: (first token [1], seeded cache)."""
        tokens = self._padded(ids, bucket)
        positions = torch.arange(bucket, device=self.device)[None]
        hidden, (k_all, v_all) = transformer.prefill(self.cfg, self.model,
                                                     tokens, positions)
        first = self._sample(hidden[:, len(ids) - 1], temp)
        cache = transformer.seed_kv_cache(self.cfg, k_all, v_all, cache_len,
                                          self._kv_quantize)
        return first, cache

    def _suffix_prefill(self, cache: KVCache, ids: Sequence[int], width: int,
                        start: int, true_len: int, window: int, temp: float,
                        sample: bool = True):
        """Prefill ``ids`` (padded to ``width``) at ``start`` against the
        cache's first ``window`` positions, in place; the first token is
        sampled at position ``true_len - 1`` when ``sample``."""
        hidden = transformer.chunk_prefill(
            self.cfg, self.model, self._padded(ids, width),
            to_device([start], self.device), to_device([true_len], self.device),
            cache, window)
        if sample:
            return self._sample(hidden[:, true_len - start - 1], temp)
        return None

    def _long_prefill(self, ids: List[int], cache_len: int, temp: float,
                      cache: Optional[KVCache] = None, start0: int = 0):
        """Chunked prefill of a prompt past the largest bucket: stride it
        in largest-bucket chunks, each attending the bucketed window of
        everything before it.  ``cache``/``start0`` resume from a
        reclaimed cache holding positions < start0.  Returns (first
        token, cache); only the last chunk samples."""
        n = len(ids)
        cb = self._buckets[-1]
        if cache is None:
            cache = transformer.init_kv_cache(self.cfg, 1, cache_len,
                                              self._kv_quantize, self.device)
        first = None
        for start in range(start0, n, cb):
            window = min(self._suffix_window(start + cb), cache_len)
            first = self._suffix_prefill(cache, ids[start:start + cb], cb,
                                         start, n, window, temp,
                                         sample=start + cb >= n)
        return first, cache

    def _grow(self, cache: KVCache, dst_len: int) -> KVCache:
        """A parked cache copied into a longer one (zeros past it; int8
        scale planes grow as ones)."""
        src_len = cache["k"].shape[2]
        big = transformer.init_kv_cache(self.cfg, cache["k"].shape[1],
                                        dst_len, self._kv_quantize,
                                        self.device)
        for key in big:
            big[key][:, :, :src_len] = cache[key]
        return big

    def _decode_segments(self, pre: _Prefilled, segment: int
                         ) -> Iterator[List[int]]:
        """Decode after the first token, ``segment`` steps per host read:
        yields each segment's new tokens until an EOS/PAD (the rest of
        its segment masked to PAD, as the JAX loop writes after EOS) or
        the budget."""
        stops = (self.tokenizer.eos_id, self.tokenizer.pad_id)
        if pre.first in stops:
            return
        made = 1
        cur = to_device([pre.first], self.device, torch.long)
        pos = to_device([len(pre.ids)], self.device)   # position of ``cur``
        while made < pre.budget:
            steps = []
            with self.phases.phase("decode"):
                for _ in range(min(segment, pre.budget - made)):
                    logits = transformer.decode_step(self.cfg, self.model,
                                                     cur, pos, pre.cache)
                    cur = sample_token_dynamic(logits, self._gen,
                                               pre.temperature)
                    steps.append(cur)
                    pos = pos + 1
                toks = torch.cat(steps).tolist()     # the segment's one sync
            start = len(pre.ids) + made - 1          # its first query
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg, len(toks), pre.cache_len, wbytes=self._wbytes,
                kv_quantize=self._kv_quantize,
                kv_ctx=decode_kv_span(pre.cache_len,
                                      range(start, start + len(toks)),
                                      self.device)))
            made += len(toks)
            stop = next((i for i, t in enumerate(toks) if t in stops), None)
            if stop is not None:
                toks[stop + 1:] = [self.tokenizer.pad_id] * (len(toks)
                                                             - stop - 1)
                yield toks
                return
            yield toks

    # -- host orchestration ------------------------------------------------

    def _prepare_and_prefill(self, history: History,
                             max_new_tokens: Optional[int],
                             temperature: Optional[float]) -> _Prefilled:
        """Tokenize, size the cache, and run the reuse-aware, chunked or
        bucketed prefill; ends in the first token's host read (TTFT)."""
        t0 = time.perf_counter()
        with self.phases.phase("tokenize"):
            ids, bucket = prepare_prompt(self.tokenizer, history,
                                         self._buckets, self._max_seq,
                                         self.tier.max_new_tokens,
                                         allow_long=True)
        n = len(ids)
        # The chunk stride must fit max_seq: otherwise keep the longest
        # tail it can serve.
        cb = self._buckets[-1] if self._buckets else bucket
        span = -(-n // cb) * cb
        if n > cb and span > self._max_seq:
            limit = min((self._max_seq // cb) * cb,
                        self._max_seq - self.tier.max_new_tokens)
            ids = ids[-limit:]
            n = len(ids)
            span = -(-n // cb) * cb
        is_long = bool(self._buckets) and n > cb
        temp = float(self.tier.temperature if temperature is None
                     else temperature)
        budget = self.tier.max_new_tokens
        if max_new_tokens and max_new_tokens > 0:
            budget = min(budget, max_new_tokens)

        from .prefix_cache import select_reuse
        sel = select_reuse(self.prefix_cache, ids, self._reuse_buckets,
                           self._max_seq, allow_long_suffix=True)

        # Size the cache with the TIER's decode cap (not the request's),
        # so a conversation keeps its rung across turns.
        needed = max(n + self.tier.max_new_tokens, bucket)
        if is_long:
            needed = max(needed, span)
        if sel is not None:
            _, m, _, sb = sel
            if sb is None:     # a new turn past every bucket: chunked from m
                needed = max(needed, m + -(-(n - m) // cb) * cb)
            else:
                needed = max(needed, m + sb)
        cache_len = self._pick_cache_len(needed)

        # The work each path computes (the JAX engine's accounting): the
        # bucket, the chunk strides, or the suffix over the allocated span.
        with self.phases.phase("prefill"):
            if sel is not None:
                entry, m, suffix, sb = sel
                cache = entry.cache
                parked_len = cache["k"].shape[2]
                if parked_len < cache_len:
                    cache = self._grow(cache, cache_len)
                else:
                    cache_len = parked_len    # a longer parked cache: keep it
                if sb is None:
                    first, cache = self._long_prefill(ids, cache_len, temp,
                                                      cache=cache, start0=m)
                    chunks = -(-(n - m) // cb)
                    pwork = roofline.prefill_work(
                        self.cfg, m + chunks * cb, m,
                        wbytes=chunks * self._wbytes)
                else:
                    # The suffix attends the whole allocated span.
                    first = self._suffix_prefill(cache, suffix, sb, m, n,
                                                 cache_len, temp)
                    pwork = roofline.prefill_work(self.cfg, cache_len,
                                                  cache_len - sb,
                                                  wbytes=self._wbytes)
            elif is_long:
                first, cache = self._long_prefill(ids, cache_len, temp)
                chunks = -(-n // cb)
                pwork = roofline.prefill_work(self.cfg, chunks * cb, 0,
                                              wbytes=chunks * self._wbytes)
            else:
                first, cache = self._prefill(ids, bucket, cache_len, temp)
                pwork = roofline.prefill_work(self.cfg, bucket, 0,
                                              wbytes=self._wbytes)
            first = int(first[0])
        self.phases.add_work("prefill", **pwork)
        ttft_ms = (time.perf_counter() - t0) * 1000.0
        # The decode cap must fit the sized cache.
        budget = min(budget, cache_len - n)
        return _Prefilled(first, cache, cache_len, ids, budget, temp,
                          ttft_ms, t0)

    def _finish(self, pre: _Prefilled, gen: List[int]) -> GenerationResult:
        """Park the cache for prefix reuse (its first n positions hold
        this prompt's KV; decode wrote past them, masked until a later
        suffix overwrites) and build the result."""
        if self.prefix_cache is not None:
            self.prefix_cache.put(pre.ids, pre.cache)
        with self.phases.phase("detokenize"):
            gen_ids = trim_at_eos(gen[:pre.budget], self.tokenizer.eos_id,
                                  self.tokenizer.pad_id)
            text = self.tokenizer.decode(gen_ids)
        return GenerationResult(
            text=text, token_ids=gen_ids,
            prompt_tokens=len(pre.ids), gen_tokens=len(gen_ids),
            ttft_ms=pre.ttft_ms,
            total_ms=(time.perf_counter() - pre.t0) * 1000.0)

    def generate(self, history: History, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None) -> GenerationResult:
        """Synchronous generation from a prompt string or chat history.
        ``max_new_tokens`` may only shrink the tier's cap; ``temperature``
        overrides the tier's per request."""
        pre = self._prepare_and_prefill(history, max_new_tokens, temperature)
        gen = [pre.first]
        for toks in self._decode_segments(pre, SEGMENT):
            gen += toks
        return self._finish(pre, gen)

    def generate_stream(self, history: History,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None,
                        segment: int = SEGMENT):
        """Text deltas, ``segment`` tokens per host read, with the same
        tokens as ``generate``; ``.result`` once the stream is exhausted.
        All work, the prefill included, runs as the stream is read."""
        from .batching import StreamHandle, _Request

        req = _Request(history=history, max_new_tokens=max_new_tokens,
                       temperature=temperature)

        def deltas():
            stops = (self.tokenizer.eos_id, self.tokenizer.pad_id)
            decoder = StreamDecoder(self.tokenizer)
            try:
                pre = self._prepare_and_prefill(history, max_new_tokens,
                                                temperature)
                gen: List[int] = []
                for toks in itertools.chain(
                        [[pre.first]], self._decode_segments(pre, segment)):
                    gen += toks
                    for tok in toks:
                        if tok in stops:
                            break
                        text = decoder.feed(tok)
                        if text:
                            yield text
                tail = decoder.flush()
                if tail:
                    yield tail
                req.result = self._finish(pre, gen)
            except BaseException as exc:
                req.error = exc
                raise
            finally:
                req.done.set()

        return StreamHandle(deltas(), req)

    def prefix_affinity(self, history) -> int:
        """Longest parked-prefix token match this engine could reuse for
        ``history`` (tokenized as admission would): the router's
        non-destructive prefix-affinity probe (0 when reuse is off or
        nothing matches)."""
        if self.prefix_cache is None or not self._reuse_buckets:
            return 0
        ids, _ = prepare_prompt(self.tokenizer, history, self._buckets,
                                self._max_seq, self.tier.max_new_tokens,
                                allow_long=True)
        return self.prefix_affinity_tokens(ids)

    def prefix_affinity_tokens(self, ids) -> int:
        """Longest parked-prefix match for tokenized ``ids``, capped as
        select_reuse's take() is (a peek: nothing moves)."""
        if self.prefix_cache is None or not self._reuse_buckets:
            return 0
        return self.prefix_cache.peek(
            ids, max_len=self._max_seq - self._reuse_buckets[0])

    def warmup(self) -> None:
        """One short request through prefill and decode before traffic
        (PyTorch compiles nothing ahead; the kernels were built in the
        constructor).  The phases restart after it, as the JAX engine's
        do: they describe serving, not warmup."""
        self.generate("warmup", max_new_tokens=2)
        self.phases = PhaseTimer()
