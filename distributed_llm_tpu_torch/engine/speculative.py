"""Sequential speculative decoding: a draft model proposes, the target
verifies.

Counterpart of ``distributed_llm_tpu/engine/speculative.py``.  Each
round the draft runs γ+1 greedy ``decode_step``s from the last accepted
token (the extra step writes the last draft's K/V into the draft cache at
pos+γ, so a fully accepted round leaves no hole there), the target scores
the γ+1 chunk [last token, drafts] in ONE ``decode_chunk`` (the flash
chunk kernel), and greedy acceptance keeps the drafts that agree with
the target's picks up to the first disagreement, plus the target's own
pick there: the output is token for token the target's greedy decode.
The whole round runs on the device; the host reads its tokens and accept
count once per round.  Rejected positions' K/V stay in both caches past
the accepted frontier, masked until later write-before-attend steps
overwrite them.

The prefill and each round are timed as "prefill" and "decode" phases
of ``self.phases`` with the JAX engine's roofline work (both models'
prefills; per round the draft's γ+1 steps and one target step of γ+1
rows sharing one read of its cache), each phase closed after its host
read.

Greedy only: a temperature raises ``NotImplementedError``.  Both caches
are bf16 whatever the tier's ``kv_quantize`` (as in the JAX package),
and the prompt is cut to the largest bucket (no chunked long prefill).
Calls are not thread-safe: callers serialize them.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.transformer import KVCache, Transformer
from ..ops import attention, quant
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .inference import (GenerationResult, padded_tokens, prepare_prompt,
                        to_device, trim_at_eos)
from .tokenizer import StreamDecoder, get_tokenizer


@torch.no_grad()
def decode_chunk(cfg, model: Transformer, tokens: torch.Tensor,
                 start_pos: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Multi-token decode: ``tokens`` [B, G] at positions
    [start_pos, start_pos + G) against the cache, their K/V written in
    place first; query g attends cache positions <= start_pos + g.
    Returns logits [B, G, V] float32."""
    b, g = tokens.shape
    d = cfg.head_dim
    pos = (start_pos[:, None]
           + torch.arange(g, device=tokens.device)[None]).to(torch.int32)
    x = quant.embed_rows(model.embed, tokens)                     # [B, G, H]
    sin, cos = transformer.rope_sincos(pos, d, cfg.rope_theta)
    rows = transformer.chunk_rows(start_pos, g, cache)
    for i, lp in enumerate(model.layers):
        h_in = transformer.rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, g, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, g, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, g, cfg.num_kv_heads, d)
        q = transformer.apply_rope(q, sin, cos)
        k = transformer.apply_rope(k, sin, cos)
        quant.put_kv_rows(cache, i, rows, k, v)
        attn = attention.chunk(q, cache["k"][i], cache["v"][i], pos,
                               *transformer.layer_scales(cache, i))
        x = x + quant.matmul(attn.reshape(b, g, cfg.num_heads * d), lp.wo)
        x = x + transformer._swiglu(
            transformer.rms_norm(x, lp.ln2, cfg.norm_eps),
            lp.w_gate, lp.w_up, lp.w_down)
    hidden = transformer.rms_norm(x, model.final_ln, cfg.norm_eps)
    return transformer.logits_from_hidden(model, hidden)


class SpeculativeEngine:
    """Greedy speculative generation over a (target, draft) tier pair,
    with ``InferenceEngine``'s ``generate()``/``generate_stream()``/
    ``warmup()`` surface; ``.tier``/``.cfg``/``.model`` are the target's.
    Runs on the card unless ``device="cpu"``.  ``target_params`` /
    ``draft_params`` replace the seeded random weights (the draft's seed
    is ``seed + 1``, even when both tiers share a preset)."""

    def __init__(self, target: TierConfig, draft: TierConfig,
                 gamma: int = 4, seed: int = 0,
                 target_params: Optional[Transformer] = None,
                 draft_params: Optional[Transformer] = None,
                 device: DeviceLike = None):
        if target.model().vocab_size != draft.model().vocab_size:
            raise ValueError("speculative decoding needs a shared vocab")
        if target.temperature and target.temperature > 0:
            raise ValueError(
                "speculative engine is greedy-only; tier temperature "
                f"{target.temperature} would be silently ignored")
        target.check_ported()
        draft.check_ported()
        self.target = target
        self.draft = draft
        self.tier = target
        self.device = resolve_device(device)
        self.cfg_t = target.model()
        self.cfg_d = draft.model()
        self.cfg = self.cfg_t
        self.gamma = gamma
        self.tokenizer = get_tokenizer(self.cfg_t)
        self._max_seq = min(self.cfg_t.max_seq_len, self.cfg_d.max_seq_len)
        # The same cache-length ladder as InferenceEngine: every draft
        # step and the verify attend up to their own positions of caches
        # sized to the conversation.
        self._cache_lens = sorted(
            {c for c in (256, 1024) if c < self._max_seq} | {self._max_seq})
        if self.device.type == "cuda":
            from ..ops import _build
            _build.build_all()

        def init(cfg, params, salt):
            if params is None:
                params = transformer.init_params(cfg, seed=seed + salt,
                                                 device=self.device)
            return params.to(self.device)
        self.model_t = init(self.cfg_t, target_params, 0)
        self.model_d = init(self.cfg_d, draft_params, 1)
        self.accept_history: list = []
        self.phases = PhaseTimer()
        self._wbytes_t = roofline.weight_bytes(self.cfg_t, target.quantize)
        self._wbytes_d = roofline.weight_bytes(self.cfg_d, target.quantize)

    @property
    def model(self) -> Transformer:
        """The target's weights: greedy speculation serves the target's
        answers."""
        return self.model_t

    # -- device work -------------------------------------------------------

    def _prefill(self, ids: List[int], bucket: int, cache_len: int):
        """Prefill BOTH models on the prompt into bf16 caches of
        ``cache_len``; the target picks the first token."""
        tokens = padded_tokens(ids, bucket, self.tokenizer.pad_id, self.device)
        positions = torch.arange(bucket, device=self.device)[None]

        def seed_cache(cfg, model):
            hidden, (k_all, v_all) = transformer.prefill(cfg, model, tokens,
                                                         positions)
            return hidden, transformer.seed_kv_cache(cfg, k_all, v_all,
                                                     cache_len)

        hidden, cache_t = seed_cache(self.cfg_t, self.model_t)
        _, cache_d = seed_cache(self.cfg_d, self.model_d)
        first = transformer.logits_from_hidden(
            self.model_t, hidden[:, len(ids) - 1]).argmax(-1)
        return first, cache_t, cache_d

    @torch.no_grad()
    def _round(self, cache_t: KVCache, cache_d: KVCache, cur: torch.Tensor,
               pos: torch.Tensor):
        """One round on the device from ``cur`` [1] (the last accepted
        token) at ``pos`` [1] int32: returns (out [1, γ+1] — the accepted
        drafts, then the target's pick — and n_acc [1] in [0, γ], the next
        token, its position)."""
        gamma = self.gamma
        tok, p = cur, pos
        drafted = []
        for _ in range(gamma + 1):
            logits = transformer.decode_step(self.cfg_d, self.model_d, tok,
                                             p, cache_d)
            tok = logits.argmax(-1)
            drafted.append(tok)
            p = p + 1
        drafted = torch.stack(drafted[:gamma], dim=1)             # [1, γ]
        chunk = torch.cat([cur[:, None], drafted], dim=1)         # [1, γ+1]
        picks = decode_chunk(self.cfg_t, self.model_t, chunk, pos,
                             cache_t).argmax(-1)                  # [1, γ+1]
        agree = (drafted == picks[:, :gamma]).to(torch.int32)
        n_acc = torch.cumprod(agree, dim=1).sum(dim=1)            # [1]
        idx = torch.arange(gamma + 1, device=self.device)[None]
        out = torch.where(
            idx < n_acc[:, None],
            torch.nn.functional.pad(drafted, (0, 1)),
            picks.gather(1, torch.minimum(idx, n_acc[:, None])))
        new_cur = out.gather(1, n_acc[:, None])[:, 0]
        return out, n_acc, new_cur, (pos + n_acc + 1).to(torch.int32)

    # -- host orchestration ------------------------------------------------

    def _prepare_and_prefill(self, history, max_new_tokens):
        """Tokenize (cut to the largest bucket), size both caches (prompt
        + budget + a round of headroom), prefill both models; ends in the
        first token's host read.  Returns (first, cache_t, cache_d,
        cache_len, n, budget, ttft_ms, t0)."""
        t0 = time.perf_counter()
        ids, bucket = prepare_prompt(
            self.tokenizer, history, self.target.prefill_buckets,
            self._max_seq, self.target.max_new_tokens)
        n = len(ids)
        budget = self.target.max_new_tokens
        if max_new_tokens and max_new_tokens > 0:
            budget = min(budget, max_new_tokens)
        needed = max(bucket, n + budget + self.gamma + 2)
        cache_len = next(c for c in self._cache_lens
                         if c >= min(needed, self._max_seq))
        with self.phases.phase("prefill"):
            first, cache_t, cache_d = self._prefill(ids, bucket, cache_len)
            first = int(first[0])
        self.phases.add_work("prefill", **roofline.prefill_work(
            self.cfg_t, bucket, 0, wbytes=self._wbytes_t))
        self.phases.add_work("prefill", **roofline.prefill_work(
            self.cfg_d, bucket, 0, wbytes=self._wbytes_d))
        ttft_ms = (time.perf_counter() - t0) * 1000.0
        return first, cache_t, cache_d, cache_len, n, budget, ttft_ms, t0

    def _rounds(self, first: int, cache_t, cache_d, cache_len: int, n: int):
        """Rounds from the first token while the next one fits the cache
        (pos + γ + 1 < cache_len): yields each round's (tokens [γ+1],
        n_acc) after its one host read.  The next round runs only when
        the caller asks for it."""
        cur = to_device([first], self.device, torch.long)
        pos = to_device([n], self.device)
        p = n
        while p + self.gamma + 1 < cache_len:
            with self.phases.phase("decode"):
                out, n_acc, cur, pos = self._round(cache_t, cache_d, cur, pos)
                host = torch.cat([out[0], n_acc]).tolist()   # the round's sync
            # The draft's γ+1 steps, then the target's γ+1 rows over its
            # allocated span in one read (kv_batch=1).
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg_d, self.gamma + 1, cache_len, wbytes=self._wbytes_d))
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg_t, 1, cache_len, batch=self.gamma + 1,
                wbytes=self._wbytes_t, kv_batch=1))
            p += host[-1] + 1
            yield host[:-1], host[-1]

    def _check_greedy(self, temperature) -> None:
        if temperature:
            raise NotImplementedError(
                "speculative engine is greedy-only (reference default, "
                "src/devices/nano_api.py:21)")

    def generate(self, history, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None) -> GenerationResult:
        """The whole speculative loop, one host read per round, with the
        JAX engine's fused-loop bookkeeping (a round's tokens kept up to
        the budget and the first EOS/PAD)."""
        self._check_greedy(temperature)
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        (first, cache_t, cache_d, cache_len, n, budget, ttft_ms,
         t0) = self._prepare_and_prefill(history, max_new_tokens)
        out = [first]
        rounds = accepted = 0
        if first not in (eos, pad) and len(out) < budget:
            for emitted, n_acc in self._rounds(first, cache_t, cache_d,
                                               cache_len, n):
                take = min(n_acc + 1, budget - len(out))
                stop = next((i for i, t in enumerate(emitted[:take])
                             if t in (eos, pad)), None)
                out += emitted[:take if stop is None else stop + 1]
                rounds += 1
                accepted += n_acc
                if stop is not None or len(out) >= budget:
                    break
        if rounds:
            # The JAX fused loop reports only totals: its history keeps
            # the mean per round.
            self.accept_history.extend([accepted / rounds] * rounds)
        gen_ids = trim_at_eos(out[:budget], eos, pad)
        return GenerationResult(
            text=self.tokenizer.decode(gen_ids), token_ids=gen_ids,
            prompt_tokens=n, gen_tokens=len(gen_ids), ttft_ms=ttft_ms,
            total_ms=(time.perf_counter() - t0) * 1000.0)

    def generate_stream(self, history, max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None):
        """Text deltas, one round's accepted tokens at a time (the same
        tokens as ``generate``); ``.result`` once exhausted.  Raises
        ``NotImplementedError`` at once for a temperature; everything
        else runs as the stream is read."""
        self._check_greedy(temperature)
        from .batching import StreamHandle, _Request

        req = _Request(history=history, max_new_tokens=max_new_tokens,
                       temperature=temperature)

        def deltas():
            decoder = StreamDecoder(self.tokenizer)
            eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
            try:
                (first, cache_t, cache_d, cache_len, n, budget, ttft_ms,
                 t0) = self._prepare_and_prefill(history, max_new_tokens)
                out = [first]
                if first not in (eos, pad):
                    text = decoder.feed(first)
                    if text:
                        yield text
                rounds = self._rounds(first, cache_t, cache_d, cache_len, n)
                while len(out) < budget and out[-1] not in (eos, pad):
                    emitted, n_acc = next(rounds, (None, None))
                    if emitted is None:
                        break
                    self.accept_history.append(n_acc)
                    for tok in emitted[:n_acc + 1]:
                        out.append(tok)
                        if tok in (eos, pad) or len(out) > budget:
                            break
                        text = decoder.feed(tok)
                        if text:
                            yield text
                tail = decoder.flush()
                if tail:
                    yield tail
                gen_ids = trim_at_eos(out[:budget], eos, pad)
                req.result = GenerationResult(
                    text=self.tokenizer.decode(gen_ids), token_ids=gen_ids,
                    prompt_tokens=n, gen_tokens=len(gen_ids),
                    ttft_ms=ttft_ms,
                    total_ms=(time.perf_counter() - t0) * 1000.0)
            except BaseException as exc:
                req.error = exc
                raise
            finally:
                req.done.set()

        return StreamHandle(deltas(), req)

    @property
    def acceptance_rate(self) -> float:
        """Mean accepted draft tokens per round / γ."""
        if not self.accept_history:
            return 0.0
        return float(np.mean(self.accept_history)) / self.gamma

    def warmup(self) -> None:
        """One short request through both paths (the whole loop and the
        stream) before traffic; the acceptance history starts empty."""
        self.generate("warmup", max_new_tokens=self.gamma + 2)
        for _ in self.generate_stream("warmup", max_new_tokens=self.gamma):
            pass
        self.accept_history.clear()
