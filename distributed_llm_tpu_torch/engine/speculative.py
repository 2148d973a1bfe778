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
Rejected positions' K/V stay in both caches past the accepted frontier,
masked until later write-before-attend steps overwrite them.

Every device stage is a program (``engine/programs.py``) over one pair
of working caches per rung, keyed as the JAX engine keys its compiled
functions: ``(bucket, cache_len)`` both models' prefill and the target's
first pick; ``("loop", cache_len)`` the fused loop (JAX's
``_spec_loop``), LOOP_ROUNDS rounds per run with the emit, EOS, budget
and cache-end logic on the device, which ``generate`` replays with one
host read per run where JAX's ``while_loop`` reads once; and
``("round", cache_len)``, one round (JAX's ``_spec_step``, whose one jit
JAX traces per cache shape), the stream's unit with one host read per
round.  ``warmup()`` builds the JAX engine's warm set (``warm_set``).
``accept_history`` keeps JAX's bookkeeping: the fused path's totals as
their mean per round, the stream's per-round counts.

The prefill and each run are timed as "prefill" and "decode" phases of
``self.phases`` with the JAX engine's roofline work (both models'
prefills; per round the draft's γ+1 steps and one target step of γ+1
rows sharing one read of its cache; a fused run counts the rounds the
JAX loop runs), each phase closed after its host read.

Greedy only: a temperature raises ``NotImplementedError``.  Both caches
are bf16 whatever the tier's ``kv_quantize`` (as in the JAX package),
and the prompt is cut to the largest bucket (no chunked long prefill).
Calls are not thread-safe: callers serialize them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.transformer import KVCache, Transformer
from ..ops import attention, quant
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .inference import GenerationResult, prepare_prompt, trim_at_eos
from .programs import SequentialPrograms
from .tokenizer import StreamDecoder, get_tokenizer

# Rounds of one fused loop program run, between two host reads: the most
# a request computes past its last round is LOOP_ROUNDS - 1 rounds.
LOOP_ROUNDS = 2


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


class SpeculativeEngine(SequentialPrograms):
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
            # The target tier's quantize mode applies to both models (the
            # draft gains the most: it runs gamma small steps per round).
            return quant.maybe_quantize(params.to(self.device), target, cfg)
        self.model_t = init(self.cfg_t, target_params, 0)
        self.model_d = init(self.cfg_d, draft_params, 1)
        self.accept_history: list = []
        self.phases = PhaseTimer()
        self._wbytes_t = roofline.weight_bytes(self.cfg_t, target.quantize)
        self._wbytes_d = roofline.weight_bytes(self.cfg_d, target.quantize)
        # The programs' static inputs: the prompt and its length, the
        # last accepted token and its position, and the fused loop's
        # state (its budget, the tokens out, the done mask, the rounds
        # and the accepted drafts so far).
        self._buckets = sorted(set(b for b in target.prefill_buckets
                                   if b <= self._max_seq))
        self._init_programs((
            ("tokens", (1, max(self._buckets)), torch.long),
            ("true_len", (1,), torch.int32), ("cur", (1,), torch.long),
            ("pos", (1,), torch.int32), ("budget", (1,), torch.int32),
            ("n_out", (1,), torch.int32), ("done", (1,), torch.bool),
            ("rounds", (1,), torch.int32), ("accepted", (1,), torch.int32)))
        self._first = torch.zeros(1, dtype=torch.long, device=self.device)
        # A round's tokens [γ+1] then its accept count; the loop's status
        # (tokens out, rounds, accepted drafts, whether a next round runs)
        # then its output row, with a round of slack as JAX's has.
        self._round_out = torch.zeros(gamma + 2, dtype=torch.long,
                                      device=self.device)
        self._loop_out = torch.zeros(4 + target.max_new_tokens + gamma + 1,
                                     dtype=torch.long, device=self.device)
        # (target, draft) working caches per rung, at their first use.
        self._caches: Dict[int, Tuple[KVCache, KVCache]] = {}

    @property
    def model(self) -> Transformer:
        """The target's weights: greedy speculation serves the target's
        answers."""
        return self.model_t

    # -- programs ----------------------------------------------------------

    def _cache(self, cache_len: int) -> Tuple[KVCache, KVCache]:
        """The (target, draft) working caches of rung ``cache_len``."""
        pair = self._caches.get(cache_len)
        if pair is None:
            pair = self._caches[cache_len] = tuple(
                transformer.init_kv_cache(cfg, 1, cache_len,
                                          device=self.device)
                for cfg in (self.cfg_t, self.cfg_d))
        return pair

    def _body(self, key, rung: int) -> Callable[[], torch.Tensor]:
        """The body of program ``key``: ``(bucket, cache_len)`` both
        models' prefill, ``("round", cache_len)`` one round (the stream's
        unit, JAX's ``_spec_step`` on that rung) and ``("loop",
        cache_len)`` the fused loop's LOOP_ROUNDS rounds."""
        if key[0] == "round":
            return self._round_body(rung)
        if key[0] == "loop":
            return self._loop_body(rung)
        return self._prefill_body(*key)

    def _prefill_body(self, bucket: int, cache_len: int):
        """BOTH models' prefill of one bucket (K2) into the rung's bf16
        caches; the target picks the first token at ``true_len - 1``."""
        tokens = self._dev["tokens"][:, :bucket]
        true_len = self._dev["true_len"]
        positions = torch.arange(bucket, device=self.device)[None]
        caches = self._cache(cache_len)

        def body() -> torch.Tensor:
            hidden = None
            for cfg, model, cache in zip((self.cfg_t, self.cfg_d),
                                         (self.model_t, self.model_d),
                                         caches):
                h, (k_all, v_all) = transformer.prefill(cfg, model, tokens,
                                                        positions)
                transformer.seed_kv_cache_into(cache, k_all, v_all)
                hidden = h if hidden is None else hidden
            last = hidden.index_select(1, true_len.long() - 1)[:, 0]
            self._first.copy_(transformer.logits_from_hidden(
                self.model_t, last).argmax(-1))
            return self._first

        return body

    def _round_body(self, cache_len: int):
        """One round from the static token and position, which it advances
        in place; its tokens and accept count into ``_round_out``."""
        cache_t, cache_d = self._cache(cache_len)
        d = self._dev

        def body() -> torch.Tensor:
            out, n_acc, cur, pos = self._round(cache_t, cache_d, d["cur"],
                                               d["pos"])
            d["cur"].copy_(cur)
            d["pos"].copy_(pos)
            self._round_out.copy_(torch.cat([out[0], n_acc]))
            return self._round_out

        return body

    def _loop_body(self, cache_len: int):
        """LOOP_ROUNDS rounds of JAX's fused loop (``_spec_loop``) with its
        emit, EOS, budget and cache-end logic on the device: a round runs
        while ``not done``, ``n_out < budget`` and ``pos + γ + 1 <
        cache_len``; its tokens land in the output row at ``n_out``, which
        advances by the accepted drafts and the target's pick, cut at the
        budget and after the first EOS/PAD.  A round that may not run
        still computes (at a position clamped into the cache) and changes
        nothing but the caches past the generation.  The loop's state is
        written back, and its status (tokens out, rounds, accepted
        drafts, whether a next round runs) then the row into
        ``_loop_out``."""
        cache_t, cache_d = self._cache(cache_len)
        d, gamma = self._dev, self.gamma
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        idx = torch.arange(gamma + 1, device=self.device)
        row = self._loop_out[4:]

        def runs(done, n_out, pos):
            return (~done & (n_out < d["budget"])
                    & (pos + gamma + 1 < cache_len))

        def body() -> torch.Tensor:
            cur, pos, n_out, done = d["cur"], d["pos"], d["n_out"], d["done"]
            rounds, accepted = d["rounds"], d["accepted"]
            for _ in range(LOOP_ROUNDS):
                live = runs(done, n_out, pos)
                out, n_acc, nxt, nxt_pos = self._round(
                    cache_t, cache_d, cur,
                    torch.clamp(pos, max=cache_len - gamma - 2))
                emitted = out[0]                                  # [γ+1]
                take = torch.minimum(n_acc + 1, d["budget"] - n_out)
                hit = ((emitted == eos) | (emitted == pad)) & (idx < take)
                first_stop = torch.where(hit, idx, gamma + 1).min()
                n_keep = torch.minimum(take, first_stop + 1)
                at = (n_out.long() + idx).clamp(max=row.shape[0] - 1)
                row.index_copy_(0, at, torch.where(live, emitted,
                                                   row.index_select(0, at)))
                n_out = torch.where(live, n_out + n_keep, n_out)
                done = done | (live & (hit.any() | (n_out >= d["budget"])))
                rounds = rounds + live.int()
                accepted = accepted + torch.where(live, n_acc, 0).int()
                cur = torch.where(live, nxt, cur)
                pos = torch.where(live, nxt_pos, pos)
            for name, x in (("cur", cur), ("pos", pos), ("n_out", n_out),
                            ("done", done), ("rounds", rounds),
                            ("accepted", accepted)):
                d[name].copy_(x)
            self._loop_out[:4].copy_(torch.cat([
                n_out, rounds, accepted, runs(done, n_out, pos).int()]))
            return self._loop_out

        return body

    # -- device work -------------------------------------------------------

    def _prefill(self, ids: List[int], bucket: int, cache_len: int):
        """Prefill BOTH models on the prompt into the rung's bf16 caches
        of ``cache_len`` (its prefill program); the target picks the
        first token.  Returns (first [1] unread, cache_t, cache_d)."""
        self._stage(ids, bucket, true_len=len(ids))
        first = self._built((bucket, cache_len), cache_len).run()
        return (first, *self._cache(cache_len))

    @torch.no_grad()
    def _round(self, cache_t: KVCache, cache_d: KVCache, cur: torch.Tensor,
               pos: torch.Tensor):
        """One round on the device from ``cur`` [1] (the last accepted
        token) at ``pos`` [1] int32: returns (out [1, γ+1] — the accepted
        drafts, then the target's pick — and n_acc [1] in [0, γ], the next
        token, its position).  The round programs' body."""
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

    def _round_work(self, cache_len: int, rounds: int) -> None:
        """``rounds`` rounds' roofline work: per round the draft's γ+1
        steps, then the target's γ+1 rows over its allocated span in one
        read (kv_batch=1)."""
        self.phases.add_work("decode", **roofline.decode_work(
            self.cfg_d, (self.gamma + 1) * rounds, cache_len,
            wbytes=self._wbytes_d))
        self.phases.add_work("decode", **roofline.decode_work(
            self.cfg_t, rounds, cache_len, batch=self.gamma + 1,
            wbytes=self._wbytes_t, kv_batch=1))

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
        cache_len = self._pick_cache_len(
            max(bucket, n + budget + self.gamma + 2))
        with self.phases.phase("prefill"):
            first, cache_t, cache_d = self._prefill(ids, bucket, cache_len)
            first = int(first[0])
        self.phases.add_work("prefill", **roofline.prefill_work(
            self.cfg_t, bucket, 0, wbytes=self._wbytes_t))
        self.phases.add_work("prefill", **roofline.prefill_work(
            self.cfg_d, bucket, 0, wbytes=self._wbytes_d))
        ttft_ms = (time.perf_counter() - t0) * 1000.0
        return first, cache_t, cache_d, cache_len, n, budget, ttft_ms, t0

    def _rounds(self, first: int, cache_len: int, n: int):
        """Rounds of the rung's round program from the first token while
        the next one fits the cache (pos + γ + 1 < cache_len): yields each
        round's (tokens [γ+1], n_acc) after its one host read.  The next
        round runs only when the caller asks for it."""
        self._stage(cur=first, pos=n)
        prog = self._built(("round", cache_len), cache_len)
        p = n
        while p + self.gamma + 1 < cache_len:
            with self.phases.phase("decode"):
                host = prog.run().tolist()           # the round's sync
            self._round_work(cache_len, 1)
            p += host[-1] + 1
            yield host[:-1], host[-1]

    def _check_greedy(self, temperature) -> None:
        if temperature:
            raise NotImplementedError(
                "speculative engine is greedy-only (reference default, "
                "src/devices/nano_api.py:21)")

    def generate(self, history, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None) -> GenerationResult:
        """The whole speculative loop on the rung's fused loop program,
        LOOP_ROUNDS rounds a replay and one host read each, with the JAX
        fused loop's bookkeeping (a round's tokens kept up to the budget
        and the first EOS/PAD; totals only)."""
        self._check_greedy(temperature)
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
        (first, _, _, cache_len, n, budget, ttft_ms,
         t0) = self._prepare_and_prefill(history, max_new_tokens)
        self._stage(cur=first, pos=n, budget=budget, n_out=1, done=False,
                    rounds=0, accepted=0)
        prog = self._built(("loop", cache_len), cache_len)
        out = [first]
        rounds = accepted = 0
        if first not in (eos, pad) and budget > 1:
            live = True
            while live:
                with self.phases.phase("decode"):
                    host = prog.run().tolist()       # the replay's sync
                self._round_work(cache_len, host[1] - rounds)
                n_out, rounds, accepted, live = host[:4]
            out += host[4 + 1:4 + n_out]
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
        """Text deltas, one round's accepted tokens at a time (the rung's
        round program, the same tokens as ``generate``); ``.result`` once
        exhausted.  Raises ``NotImplementedError`` at once for a
        temperature; everything else runs as the stream is read."""
        self._check_greedy(temperature)
        from .batching import StreamHandle, _Request

        req = _Request(history=history, max_new_tokens=max_new_tokens,
                       temperature=temperature)

        def deltas():
            decoder = StreamDecoder(self.tokenizer)
            eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id
            try:
                (first, _, _, cache_len, n, budget, ttft_ms,
                 t0) = self._prepare_and_prefill(history, max_new_tokens)
                out = [first]
                if first not in (eos, pad):
                    text = decoder.feed(first)
                    if text:
                        yield text
                rounds = self._rounds(first, cache_len, n)
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

    def warm_set(self) -> List[tuple]:
        """The JAX engine's warm set, as (key, rung): every (bucket, rung)
        prefill a request can pick (both ends of the rungs a bucket can
        land on), and at each such rung both round programs, the fused
        loop and the stream's round."""
        cap = self.target.max_new_tokens + self.gamma + 2
        pick = self._pick_cache_len
        keys: List[tuple] = []
        for bucket in self._buckets:
            for c in sorted({pick(bucket), pick(bucket + cap)}):
                if c >= bucket:              # else unreachable by serving
                    keys += [((bucket, c), c), (("loop", c), c),
                             (("round", c), c)]
        return list(dict.fromkeys(keys))

    def warmup(self) -> None:
        """One short request through both paths (the whole loop and the
        stream), then every program of the JAX engine's warm set
        (``warm_set``) built; the acceptance history starts empty."""
        self.generate("warmup", max_new_tokens=self.gamma + 2)
        for _ in self.generate_stream("warmup", max_new_tokens=self.gamma):
            pass
        for key, rung in self.warm_set():
            self._built(key, rung)
        self._warmed = True
        self.accept_history.clear()
