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
- decode runs a fixed segment of ``SEGMENT`` (8) steps per program run
  (the flash decode kernel, int8 with ``kv_quantize="int8"``) with the
  loop's state on the device, and reads the tokens back once per
  segment; steps after an EOS, or past the budget, emit PAD exactly as
  the JAX loop's body does, so the output is the JAX engine's at up to
  7 wasted steps.  The JAX engine reads a whole ``generate`` back once;
  this one reads once per segment, in ``generate`` as in the stream.

Every device stage is a program (``engine/programs.py``), keyed as the
JAX engine keys its compiled functions: ``(bucket, cache_len)`` the cold
prefill, ``("init", cache_len)`` and ``("grow", src_len, dst_len)`` the
cache copies, ``("suffix", bucket, window)`` a suffix or chunk prefill
on a rung, and ``cache_len`` the rung's decode segment.  On the card
each is a CUDA graph captured once and replayed on static inputs (the
prompt or chunk, its start and true length, the temperature, the decode
state), staged in place before a run; the temperature and the token
budget are runtime operands.  Each rung has one working cache that
every program of the rung reads and writes in place.  A parked prefix
is a copy of it, and a prefix hit copies the parked entry back into the
working cache of its rung (then ``grow`` copies it to a longer rung):
no program reads storage a parked entry owns.  The JAX engine donates
the cache instead of copying it.  ``warmup()`` builds the JAX engine's
warm set (``warm_set``); any other program is built at its first use,
as JAX compiles it.

Each request is timed by phase in ``self.phases``
(``utils/telemetry.PhaseTimer``: "tokenize", "prefill", each decode
segment's "decode", "detokenize") with the roofline work the JAX engine
accounts (``utils/roofline.py``).  The prefill phase closes after the
first token's host read and a decode segment's after its tokens' read,
so on the card each covers the device work it launched.  A segment's
work counts its steps up to the budget, an EOS's masked ones included
(up to 7): the steps the eager loop ran.

A ``group`` runs the engine tensor-, sequence- or expert-parallel (see
``InferenceEngine``).  Calls are not thread-safe: callers serialize them
(the ``/query`` server holds one lock per engine).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import torch

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from .. import models
from ..models import transformer
from ..models.checkpoint import load_params_for_tier
from ..models.transformer import KVCache, Transformer, kv_shards
from ..ops import quant
from ..ops.attention import decode_kv_span
from ..ops.sampling import sample_batched
from ..parallel.mesh import DeviceGroup
from ..parallel.ring_attention import ring
from ..parallel.sharding import kv_cache_shards, shard_params
from ..parallel.sp_attention import sp_decode_attn
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .programs import SequentialPrograms
from .tokenizer import StreamDecoder, get_tokenizer

logger = logging.getLogger(__name__)

History = Union[str, Sequence[Dict[str, Any]]]

# Decode steps of one decode program run, between two host reads of the
# tokens: the most a request decodes past its EOS.
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
    cache: KVCache              # the rung's working cache
    cache_len: int
    ids: List[int]
    budget: int                 # tokens to generate, the first included
    temperature: float
    ttft_ms: float
    t0: float


class InferenceEngine(SequentialPrograms):
    """Single-sequence engine: synchronous ``generate()`` and
    ``generate_stream()``.  Runs on the card unless ``device="cpu"`` is
    asked for (the plain PyTorch path); ``params`` replaces the seeded
    random weights (whole: a ``group`` shards them).  ``group``: the
    tier's device group (``parallel/mesh.DeviceGroup``), JAX's mesh
    engine; it replaces ``device``, and a one-slot group is its device.

    - ``tp`` > 1: the weights split by ``parallel/sharding.shard_params``,
      one contiguous cache per head shard, every program running each
      shard's heads on its own cache (``parallel/tp_attention.
      tp_layers``);
    - ``sp`` > 1 (a dense model): the prefill ladder extends to max_seq,
      so a prompt past the tier's largest bucket prefills at once; a
      bucket ``sp`` divides prefills through ring attention
      (``parallel/ring_attention``) in place of K2, others through K2;
      with a bf16 cache the cache's sequence splits over the sp slots
      and decode merges per-piece partials (``parallel/sp_attention``)
      where ``sp`` divides the cache length, else runs K9 per head
      shard; the prefix cache is off (JAX's rule);
    - ``ep`` > 1 (a MoE model): each ep slot runs its E / ep experts
      (``models/moe``), the attention runs on the tensor shards."""

    def __init__(self, tier: TierConfig, seed: int = 0,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None,
                 group: Optional[DeviceGroup] = None):
        tier.check_ported()
        self.tier = tier
        self.device = (group.lead if group is not None
                       else resolve_device(device))
        self.group = group if group is not None and group.parallel else None
        self.cfg = tier.model()
        self.tokenizer = get_tokenizer(self.cfg)
        if self.device.type == "cuda":
            # Every kernel compiles (in parallel) before the first request.
            from ..ops import _build
            _build.build_all()
        if params is None and tier.checkpoint_path:
            # The tier's trained weights win over random init.
            params = load_params_for_tier(tier.checkpoint_path, self.cfg,
                                          device=self.device)
        if params is None:
            params = models.init_params(self.cfg, seed=seed,
                                        device=self.device)
        self.model = quant.maybe_quantize(params.to(self.device), tier,
                                          self.cfg)
        del params
        if self.group is not None:
            # Quantized whole, then split (JAX's quantized_param_specs).
            self.model = shard_params(self.model, self.group)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0x5EED)
        self._generators = (self._gen,)
        self._max_seq = self.cfg.max_seq_len
        self._buckets = sorted(set(
            b for b in tier.prefill_buckets if b <= self._max_seq))
        # The tier's own ladder: chunk strides and prefix-hit suffixes
        # keep it when an sp tier extends the prompt ladder.
        self._suffix_buckets = list(self._buckets)
        # Suffix buckets a prefix hit prefills through (the <=256-token
        # rungs, typical chat turns); a longer new turn chunk-strides.
        self._reuse_buckets = ([b for b in self._buckets if b <= 256][:3]
                               or self._buckets[:1])
        # Sequence parallelism (dense only): the ladder doubles up to
        # max_seq, so a long prompt prefills as ONE ring call.
        self._sp = (self.group.sp if self.group is not None
                    and self.cfg.num_experts == 1 else 1)
        if self._sp > 1 and self._buckets and self._buckets[-1] < self._max_seq:
            ladder = self._buckets[-1]
            while ladder * 2 <= self._max_seq:
                ladder *= 2
                self._buckets.append(ladder)
            if self._buckets[-1] < self._max_seq:
                self._buckets.append(self._max_seq)
        # Cache lengths: decode reads the cache up to its position every
        # step, and the cache is sized to the conversation, not max_seq.
        self._cache_lens = sorted(
            {c for c in (256, 1024) if c < self._max_seq} | {self._max_seq})
        self._family = models.model_module(self.cfg)
        # The MoE family keeps a bf16 cache: the JAX engine's rule, with
        # its warning.
        self._kv_quantize = tier.kv_quantize
        if self._kv_quantize != "none" and self.cfg.num_experts > 1:
            logger.warning("tier %s: kv_quantize=%s ignored for the MoE "
                           "family (bf16 cache)", tier.name,
                           self._kv_quantize)
            self._kv_quantize = "none"
        self.phases = PhaseTimer()
        self._wbytes = roofline.weight_bytes(self.cfg, tier.quantize)
        from .prefix_cache import PrefixCache
        self.prefix_cache = (
            PrefixCache(capacity=tier.prefix_cache_entries)
            if tier.enable_prefix_cache and tier.prefix_cache_entries > 0
            else None)
        # Sequence-parallel decode over a bf16 cache split on 'sp'; the
        # prefix cache's suffix paths would read the pieces whole, so it
        # is off there (JAX's rule).
        self._sp_shard = self._sp > 1 and self._kv_quantize == "none"
        if self._sp_shard and self.prefix_cache is not None:
            logger.info("tier %s: prefix cache disabled under "
                        "sequence-parallel decode", tier.name)
            self.prefix_cache = None
        # The programs' static inputs: a prompt or chunk (``tokens``, its
        # ``start`` and the prompt's ``true_len``), the request's
        # temperature, and the decode loop's state (the current token, its
        # position, the done mask, the tokens made and the budget).
        width = max(self._buckets or [self._max_seq])
        self._init_programs((
            ("tokens", (1, width), torch.long),
            ("start", (1,), torch.int32), ("true_len", (1,), torch.int32),
            ("temp", (1,), torch.float32), ("cur", (1,), torch.long),
            ("pos", (1,), torch.int32), ("done", (1,), torch.bool),
            ("made", (1,), torch.int32), ("budget", (1,), torch.int32)))
        self._first = torch.zeros(1, dtype=torch.long, device=self.device)
        self._segment = torch.zeros(SEGMENT, dtype=torch.long,
                                    device=self.device)
        # One working cache per rung, allocated at its first use: every
        # program of the rung reads and writes it in place.
        self._caches: Dict[int, KVCache] = {}

    # -- programs ----------------------------------------------------------

    def _cache(self, cache_len: int) -> KVCache:
        """The working cache of rung ``cache_len``."""
        cache = self._caches.get(cache_len)
        if cache is None:
            cache = self._caches[cache_len] = (
                kv_cache_shards(self.cfg, 1, cache_len, self._kv_quantize,
                                self.group,
                                sequence=self._sp_decode(cache_len)
                                is not None)
                if self.group is not None
                else transformer.init_kv_cache(
                    self.cfg, 1, cache_len, self._kv_quantize, self.device))
        return cache

    def _sp_decode(self, cache_len: int) -> Optional[Callable]:
        """The sequence-parallel decode hook of rung ``cache_len`` (its
        cache split on 'sp'), or None (a whole cache per head shard)."""
        if not self._sp_shard:
            return None
        return sp_decode_attn(self.group, self.cfg, cache_len)

    def _sp_attn(self, bucket: int) -> Optional[Callable]:
        """The prefill's attention override: ring attention over head
        shard ``t``'s sp column when ``sp`` divides the bucket, else None
        (K2 per head shard)."""
        if self._sp <= 1 or bucket % self._sp:
            return None
        group = self.group
        return lambda q, k, v, t: ring(q, k, v, group.column(t))

    def _suffix_window(self, needed: int) -> int:
        """Smallest bucketed attention window covering ``needed`` cache
        positions (else the whole sequence)."""
        return next((b for b in self._buckets if b >= needed), self._max_seq)

    def _sample_first(self, hidden: torch.Tensor,
                      row: torch.Tensor) -> torch.Tensor:
        """The first token, sampled at the static temperature from the
        hidden row ``row`` [1] of ``hidden`` [1, S, H], into ``_first``."""
        logits = transformer.logits_from_hidden(
            self.model, hidden.index_select(1, row.long())[:, 0])
        self._first.copy_(sample_batched(logits, self._dev["temp"],
                                         self._gen))
        return self._first

    def _body(self, key, rung: int) -> Callable[[], torch.Tensor]:
        """The body of program ``key`` (JAX's keys: ``(bucket, cache_len)``
        the cold prefill, ``("init", cache_len)``, ``("grow", src, dst)``,
        ``("suffix", bucket, window)`` on rung ``rung``, and ``cache_len``
        the decode segment), on the static inputs and the rung's working
        cache."""
        if isinstance(key, int):
            return self._decode_body(key)
        kind = key[0]
        if kind == "init":
            return self._init_body(rung)
        if kind == "grow":
            return self._grow_body(*key[1:])
        if kind == "suffix":
            return self._suffix_body(key[1], key[2], rung)
        return self._prefill_body(*key)

    def _prefill_body(self, bucket: int, cache_len: int):
        """The cold prefill of one bucket (K2 in every layer): seeds the
        rung's cache, bf16 or int8 with its scale planes, as
        ``seed_kv_cache`` does, and samples the first token at position
        ``true_len - 1``."""
        tokens = self._dev["tokens"][:, :bucket]
        true_len = self._dev["true_len"]
        positions = torch.arange(bucket, device=self.device)[None]
        cache = self._cache(cache_len)
        attn = self._sp_attn(bucket)

        def body() -> torch.Tensor:
            hidden, (k_all, v_all) = models.serving_prefill(
                self.cfg, self.model, tokens, positions, attn=attn)
            transformer.seed_kv_cache_into(cache, k_all, v_all)
            return self._sample_first(hidden, true_len - 1)

        return body

    def _init_body(self, cache_len: int):
        """A zeroed cache (int8 scales ones): a chunked prefill's start."""
        cache = self._cache(cache_len)
        return lambda: transformer.reset_kv_cache(cache)

    def _grow_body(self, src_len: int, dst_len: int):
        """The cache of rung ``src_len`` copied into rung ``dst_len``'s:
        zeros past it, int8 scale planes ones."""
        src, dst = self._cache(src_len), self._cache(dst_len)

        def body() -> None:
            for s, d in zip(kv_shards(src), kv_shards(dst)):
                for name, x in s.items():
                    d[name][:, :, :src_len].copy_(x)
            transformer.reset_kv_cache(dst, src_len)

        return body

    def _suffix_body(self, bucket: int, window: int, cache_len: int):
        """A suffix or chunk of ``bucket`` tokens prefilled at ``start``
        into rung ``cache_len``'s cache, attending its first ``window``
        positions (K11, K12 int8); samples at ``true_len - start - 1``
        (clamped into the chunk: meaningful for a final chunk)."""
        tokens = self._dev["tokens"][:, :bucket]
        start, true_len = self._dev["start"], self._dev["true_len"]
        cache = self._cache(cache_len)

        def body() -> torch.Tensor:
            hidden = self._family.chunk_prefill(
                self.cfg, self.model, tokens, start, true_len, cache, window)
            return self._sample_first(
                hidden, torch.clamp(true_len - start - 1, 0, bucket - 1))

        return body

    def _decode_body(self, cache_len: int):
        """One decode segment on rung ``cache_len``: SEGMENT steps (K9, K10
        int8) from the device state, each sampled at the static
        temperature and fed back.  A step after an EOS, or past the
        budget, emits PAD, as the JAX loop's body does; positions clamp
        at the cache's last cell.  The state is written back for the
        next segment and the tokens into ``_segment``."""
        cache = self._cache(cache_len)
        d = self._dev
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        attn = self._sp_decode(cache_len)

        def body() -> torch.Tensor:
            cur, pos, done, made = d["cur"], d["pos"], d["done"], d["made"]
            toks = []
            for _ in range(SEGMENT):
                logits = self._family.decode_step(self.cfg, self.model,
                                                  cur, pos, cache, attn)
                nxt = sample_batched(logits, d["temp"], self._gen)
                nxt = torch.where(done | (made >= d["budget"]), pad, nxt)
                toks.append(nxt)
                done = done | (nxt == eos)
                cur, made = nxt, made + 1
                pos = torch.clamp(pos + 1, max=cache_len - 1)
            for name, x in (("cur", cur), ("pos", pos), ("done", done),
                            ("made", made)):
                d[name].copy_(x)
            self._segment.copy_(torch.cat(toks))
            return self._segment

        return body

    def _load(self, parked: KVCache) -> int:
        """A parked cache copied into the working cache of its own rung (a
        prefix hit: no program reads a parked entry's storage); returns
        the rung."""
        parked_len = kv_shards(parked)[0]["k"].shape[2]
        cache = self._cache(parked_len)
        for c, p in zip(kv_shards(cache), kv_shards(parked)):
            for name, x in p.items():
                c[name].copy_(x)
        return parked_len

    def _park(self, cache_len: int) -> KVCache:
        """A copy of rung ``cache_len``'s working cache for the prefix
        cache (its owner, from now on)."""
        parked = [{name: x.clone() for name, x in c.items()}
                  for c in kv_shards(self._cache(cache_len))]
        return parked if self.group is not None else parked[0]

    # -- device work -------------------------------------------------------

    def _prefill(self, ids: List[int], bucket: int, cache_len: int,
                 temp: float) -> torch.Tensor:
        """Cold prefill of one bucket: the first token [1], unread."""
        self._stage(ids, bucket, true_len=len(ids), temp=temp)
        return self._built((bucket, cache_len), cache_len).run()

    def _long_prefill(self, ids: List[int], cache_len: int, temp: float,
                      start0: int = 0) -> torch.Tensor:
        """Chunked prefill of a prompt past the largest bucket into rung
        ``cache_len``'s cache (holding positions < ``start0`` on a
        reclaimed prefix): largest-bucket chunks, each attending the
        bucketed window of everything before it.  Returns the last
        chunk's sample, the first token [1], unread."""
        n = len(ids)
        cb = self._suffix_buckets[-1]
        first = None
        for start in range(start0, n, cb):
            window = min(self._suffix_window(start + cb), cache_len)
            self._stage(ids[start:start + cb], cb, start=start, true_len=n,
                        temp=temp)
            first = self._built(("suffix", cb, window), cache_len).run()
        return first

    def _decode_segments(self, pre: _Prefilled) -> Iterator[List[int]]:
        """Decode after the first token, one replay of the rung's decode
        program (SEGMENT steps) per host read: yields each segment's new
        tokens until an EOS/PAD (the device masks the rest of its segment
        to PAD) or the budget."""
        made = 1
        self._stage(cur=pre.first, pos=len(pre.ids), done=False, made=made,
                    budget=pre.budget, temp=pre.temperature)
        prog = self._built(pre.cache_len, pre.cache_len)
        stops = (self.tokenizer.eos_id, self.tokenizer.pad_id)
        if pre.first in stops:
            return
        while made < pre.budget:
            with self.phases.phase("decode"):
                toks = prog.run().tolist()           # the segment's one sync
            toks = toks[:min(SEGMENT, pre.budget - made)]
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
                yield toks[:stop + 1]
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
        scb = self._suffix_buckets[-1] if self._suffix_buckets else cb
        if sel is not None:
            _, m, _, sb = sel
            if sb is None:     # a new turn past every bucket: chunked from m
                needed = max(needed, m + -(-(n - m) // scb) * scb)
            else:
                needed = max(needed, m + sb)
        cache_len = self._pick_cache_len(needed)

        # The work each path computes (the JAX engine's accounting): the
        # bucket, the chunk strides, or the suffix over the allocated span.
        with self.phases.phase("prefill"):
            if sel is not None:
                entry, m, suffix, sb = sel
                parked_len = self._load(entry.cache)
                if parked_len < cache_len:
                    self._built(("grow", parked_len, cache_len),
                                cache_len).run()
                else:
                    cache_len = parked_len    # a longer parked cache: keep it
                if sb is None:
                    first = self._long_prefill(ids, cache_len, temp, start0=m)
                    chunks = -(-(n - m) // scb)
                    pwork = roofline.prefill_work(
                        self.cfg, m + chunks * scb, m,
                        wbytes=chunks * self._wbytes)
                else:
                    # The suffix attends the whole allocated span.
                    self._stage(suffix, sb, start=m, true_len=n, temp=temp)
                    first = self._built(("suffix", sb, cache_len),
                                        cache_len).run()
                    pwork = roofline.prefill_work(self.cfg, cache_len,
                                                  cache_len - sb,
                                                  wbytes=self._wbytes)
            elif is_long:
                self._built(("init", cache_len), cache_len).run()
                first = self._long_prefill(ids, cache_len, temp)
                chunks = -(-n // scb)
                pwork = roofline.prefill_work(self.cfg, chunks * scb, 0,
                                              wbytes=chunks * self._wbytes)
            else:
                first = self._prefill(ids, bucket, cache_len, temp)
                pwork = roofline.prefill_work(self.cfg, bucket, 0,
                                              wbytes=self._wbytes)
            first = int(first[0])
        self.phases.add_work("prefill", **pwork)
        ttft_ms = (time.perf_counter() - t0) * 1000.0
        # The decode cap must fit the sized cache.
        budget = min(budget, cache_len - n)
        return _Prefilled(first, self._cache(cache_len), cache_len, ids,
                          budget, temp, ttft_ms, t0)

    def _finish(self, pre: _Prefilled, gen: List[int]) -> GenerationResult:
        """Park a copy of the cache for prefix reuse (its first n
        positions hold this prompt's KV; decode wrote past them, masked
        until a later suffix overwrites) and build the result."""
        if self.prefix_cache is not None:
            self.prefix_cache.put(pre.ids, self._park(pre.cache_len))
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
        overrides the tier's per request.  Both are runtime operands of
        the programs: neither builds a new one."""
        pre = self._prepare_and_prefill(history, max_new_tokens, temperature)
        gen = [pre.first]
        for toks in self._decode_segments(pre):
            gen += toks
        return self._finish(pre, gen)

    def generate_stream(self, history: History,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None):
        """Text deltas, one decode segment (SEGMENT tokens) per host
        read, with the same tokens as ``generate``; ``.result`` once the
        stream is exhausted.  All work, the prefill included, runs as the
        stream is read."""
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
                for toks in itertools.chain([[pre.first]],
                                            self._decode_segments(pre)):
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

    def warm_set(self) -> List[tuple]:
        """The JAX engine's warm set (``warmup``'s programs past its first
        request), as (key, rung): every bucket's prefill at both ends of
        the rungs it can land on and each such rung's decode; with prefix
        reuse, each reuse bucket's suffix at every rung a conversation
        with it can grow into; below max_seq, the chunked long prefill's
        ``init``, its windows and decode at the rung of a max-length
        prompt."""
        cap = self.tier.max_new_tokens
        pick = self._pick_cache_len
        keys: List[tuple] = []
        for bucket in self._buckets:
            for c in sorted({pick(bucket), pick(bucket + cap)}):
                keys += [((bucket, c), c), (c, c)]
        if self.prefix_cache is not None:
            # JAX warms a suffix on a cache its own prefill made: a rung
            # no bucket lands on gets the smallest bucket's prefill first.
            minted = {rung for _, rung in keys}
            for sb in self._reuse_buckets:
                floor = pick(sb + 1 + cap)
                for c in [c for c in self._cache_lens if c >= floor]:
                    if c not in minted:
                        minted.add(c)
                        keys.append(((self._buckets[0], c), c))
                    keys.append((("suffix", sb, c), c))
        if self._buckets and self._buckets[-1] < self._max_seq:
            cb = self._buckets[-1]
            limit = min((self._max_seq // cb) * cb, self._max_seq - cap)
            c = pick(max(limit + cap, -(-limit // cb) * cb))
            keys.append((("init", c), c))
            keys += [(("suffix", cb, w), c) for w in sorted({
                min(self._suffix_window(s + cb), c)
                for s in range(0, limit, cb)})]
            keys.append((c, c))
        return list(dict.fromkeys(keys))

    def warmup(self) -> None:
        """One short request, then every program of the JAX engine's warm
        set (``warm_set``) built: captured on the card, so no request of
        those shapes captures mid-serve.  The phases restart after it, as
        the JAX engine's do: they describe serving, not warmup."""
        self.generate("warmup", max_new_tokens=1)
        for key, rung in self.warm_set():
            self._built(key, rung)
        self._warmed = True
        self.phases = PhaseTimer()
