"""The bench's engine legs: ``skew``, ``spec_phase``, ``mixed`` and
``shared``.

Counterparts of the root ``bench.py``'s ``skew_phase`` (:1244),
``spec_phase`` (:1368), ``mixed_phase`` (:1498) and
``shared_prefix_phase`` (:1757), with their keys and hard invariants.
Each measures one mechanism of the batched engine on two modes of the
same tier at one seed and the same prompts, so that only the mode flips:

- ``skew_phase``: the dense windowed tick (K7) against the ragged tick
  (K1) at full occupancy under length skew; the ragged engine must hold
  exactly one decode program;
- ``spec_phase``: batched speculation (a draft, the fused verify K4)
  against plain decode; the speculative program count may not exceed the
  γ-bucket family;
- ``mixed_phase``: a long prompt arriving beside a short stream, chunked
  prefill (K3 chunks) against one-shot prefill (K2): the short stream's
  p95 inter-token gap and the stall;
- ``shared_prefix_phase``: K sessions over one system prompt, refcounted
  prefix sharing (copy-on-write) on and off: peak resident blocks.

Each leg serves JAX's pinned configuration by default (the tiny nano
tier; ``mixed`` on ``mini_bench``); ``tier`` serves another with the
same mode flips (chip_smoke passes nano_1b and orin_8b at full width).

Greedy tokens must be identical across each leg's two modes.  The kernels
of the two modes sum in another order, so on the card in bf16 a greedy
near-tie can flip.  ``tie_check(engine, ids, want, got)`` (chip_smoke
passes its ``near_tie``) then judges each flip on an engine of the
reference mode, and the leg lists them under ``flips``; a leg that fails
on divergence (``spec_phase``, ``shared_prefix_phase``) fails only on a
flip that is no near-tie.  ``outputs_identical`` stays JAX's verdict.
With no ``tie_check`` every divergence counts, as in JAX.

The port keys its programs as JAX's engine does, but for speculation:
one ``"spec"`` program per γ bucket where JAX has ``"draft"`` and
``"verify"``, so ``verify_programs`` counts the ``"spec"`` programs.  In
place of JAX's ``dispatch_provenance()`` the skew leg reports each mode's
kernel launches and plain attention calls (``ops/launches.py``).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

from ..obs.metrics import nearest_rank

# Length-skew prompts of the skew and spec legs (root bench.py:1272-1276).
SHORT_Q = "short question about rivers please"
LONG_Q = ("long question: " + "rivers lakes mountains oceans deltas " * 16)


def _pct(values, q):
    """Nearest-rank percentile, rounded for the artifact (bench.py's)."""
    v = nearest_rank(values, q)
    return None if v is None else round(v, 3)


def _skew_prompts(n: int) -> List[str]:
    return [(SHORT_Q if i % 2 else LONG_Q) + f" variant {i}"
            for i in range(n)]


def _flips(ref_tier, prompts: Sequence[str], want: Sequence[tuple],
           got: Sequence[tuple], tie_check: Callable, seed: int,
           device) -> List[dict]:
    """Each request whose tokens differ between two modes, judged by
    ``tie_check`` on a fresh engine of the reference mode (the same seed,
    so the same weights)."""
    from ..engine.batching import ContinuousBatchingEngine
    from ..engine.inference import prepare_prompt

    eng = ContinuousBatchingEngine(ref_tier, seed=seed, device=device)
    try:
        out = []
        for i, (p, w, g) in enumerate(zip(prompts, want, got)):
            if w == g:
                continue
            ids, _ = prepare_prompt(eng.tokenizer, p,
                                    ref_tier.prefill_buckets,
                                    eng.cfg.max_seq_len,
                                    ref_tier.max_new_tokens)
            out.append({"request": i, **tie_check(eng, ids, list(w),
                                                  list(g))})
        return out
    finally:
        eng.stop()


def _judge(out: dict, n: int, modes, token_ids: dict, prompts, ref_tier,
           tie_check, seed: int, device) -> bool:
    """JAX's identity verdict (not vacuous: every request produced a
    result in both modes) into ``out["outputs_identical"]``; where it
    fails and ``tie_check`` is given, the flips into ``out["flips"]``.
    Returns whether every difference is a near-tie."""
    a, b = (token_ids.get(m, ()) for m in modes)
    complete = len(a) == n and len(b) == n
    out["outputs_identical"] = complete and a == b
    if out["outputs_identical"] or not complete or tie_check is None:
        return out["outputs_identical"]
    out["flips"] = _flips(ref_tier, prompts, a, b, tie_check, seed, device)
    return all(f.get("near_tie") for f in out["flips"])


def skew_phase(device=None, n_requests: int = 32, beat=lambda: None,
               tier=None, tie_check: Optional[Callable] = None) -> dict:
    """The length-skew decode leg: mixed short and long prompts at full
    ``decode_batch`` occupancy, the dense windowed tick against the
    ragged tick: the same engine, seed and prompts, only
    ``attention_ragged`` flips.  Per mode: decode-tick p50/p95 from the
    engine's tick ring, req/s over the batch, the decode program count
    and the ``dllm_compiled_programs`` gauge, the tick's attention
    (``pallas``: a hand-written kernel on the card, ``xla``: the plain
    version on the CPU) and the kernels launched and plain attention
    calls made by the measured batch.  Hard invariant (``error``): the
    ragged engine holds exactly one decode program and the gauge agrees.
    ``tier``: default JAX's pinned tiny nano (24 new tokens, no prefix
    cache)."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine
    from ..obs import get_observability
    from ..ops import launches

    print("[bench] length-skew decode leg", file=sys.stderr, flush=True)
    base = tier or dataclasses.replace(tiny_batched_cluster().nano,
                                       max_new_tokens=24,
                                       enable_prefix_cache=False)
    prompts = _skew_prompts(n_requests)
    out: dict = {"decode_batch": base.decode_batch,
                 "requests": n_requests,
                 "steps_per_tick": base.decode_steps_per_tick,
                 "launches": {}}

    token_ids: dict = {}
    for mode, ragged in (("dense", False), ("ragged", True)):
        mtier = dataclasses.replace(base, attention_ragged=ragged)
        eng = ContinuousBatchingEngine(mtier, seed=7, device=device)
        try:
            # Every program either mode can touch mid-measurement: one
            # long and one short solo request cover the dense rung ladder;
            # the ragged tick's one program rides the first.
            eng.generate(LONG_Q, max_new_tokens=base.max_new_tokens)
            eng.generate(SHORT_Q, max_new_tokens=base.max_new_tokens)
            beat()
            eng.tick_ms.clear()
            k0, c0 = launches.counts(), launches.call_counts()
            t0 = time.perf_counter()
            reqs = [eng.submit(p) for p in prompts]
            for r in reqs:
                r.done.wait(timeout=300)
            wall = time.perf_counter() - t0
            out["launches"][mode] = {
                "kernels": launches.since(k0),
                "plain_calls": launches.since(c0, launches.call_counts())}
            errors = sum(1 for r in reqs if r.error is not None)
            token_ids[mode] = [tuple(r.result.token_ids)
                               for r in reqs if r.result is not None]
            ticks = list(eng.tick_ms)
            gauge = get_observability().m.compiled_programs.labels(
                mtier.name, "decode").value
            out[mode] = {
                "req_per_s": round(n_requests / max(wall, 1e-9), 4),
                "decode_tick_p50_ms": _pct(ticks, 0.50),
                "decode_tick_p95_ms": _pct(ticks, 0.95),
                "ticks": len(ticks),
                "errors": errors,
                "compiled_decode_programs":
                    len(eng._compiled.get("decode", ())),
                "compiled_programs_gauge": gauge,
                "attention_impl": ("pallas" if eng.device.type == "cuda"
                                   else "xla"),
                "attention_ragged": eng.ragged,
            }
        finally:
            eng.stop()
        beat()
    rg = out.get("ragged") or {}
    if rg and not rg.get("errors"):
        programs = rg.get("compiled_decode_programs")
        gauge = rg.get("compiled_programs_gauge")
        if programs != 1 or (gauge is not None and gauge != 1.0):
            out["error"] = (
                f"decode program churn: ragged built {programs} "
                f"program(s), dllm_compiled_programs gauge read "
                f"{gauge}: the one-program invariant is broken")
    d50 = (out.get("dense") or {}).get("decode_tick_p50_ms")
    r50 = (out.get("ragged") or {}).get("decode_tick_p50_ms")
    if d50 and r50:
        out["tick_p50_ratio_ragged_over_dense"] = round(r50 / d50, 3)
    _judge(out, n_requests, ("dense", "ragged"), token_ids, prompts,
           dataclasses.replace(base, attention_ragged=False), tie_check, 7,
           device)
    return out


def spec_phase(device=None, n_requests: int = 16, gamma_max: int = 12,
               beat=lambda: None, tier=None,
               tie_check: Optional[Callable] = None) -> dict:
    """The batched-speculation leg: the skew prompt mix, speculation on
    (the tier's ``draft_preset``, by default ``draft_test``) against off
    at the same seed and prompts, engines warmed.  The judged number is
    ``tok_ratio``: decode tok/s (tokens over the tick ring's time, where
    speculation acts) on over off; ``wall_tok_ratio`` includes both
    modes' admissions.  Per mode: the acceptance aggregate and per slot,
    and the speculative program count against the γ-bucket family.  Hard
    invariants (``error``): greedy outputs identical across modes (the
    acceptance rule), and no more speculative programs than γ buckets.
    ``tier``: default JAX's pinned tiny nano (24 new tokens, no prefix
    cache); the random tiny models accept nearly everything, so the leg
    pins the mechanism, not a trained acceptance."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine

    print("[bench] batched speculation leg", file=sys.stderr, flush=True)
    base = tier or dataclasses.replace(tiny_batched_cluster().nano,
                                       max_new_tokens=24,
                                       enable_prefix_cache=False)
    draft = base.draft_preset or "draft_test"
    prompts = _skew_prompts(n_requests)
    out: dict = {"decode_batch": base.decode_batch,
                 "requests": n_requests,
                 "gamma_max": gamma_max,
                 "draft_preset": draft,
                 "steps_per_tick": base.decode_steps_per_tick}

    token_ids: dict = {}
    for mode, on in (("off", False), ("on", True)):
        mtier = dataclasses.replace(
            base, spec_decode=on, draft_preset=draft if on else None,
            spec_gamma_max=gamma_max)
        eng = ContinuousBatchingEngine(mtier, seed=7, device=device)
        try:
            eng.warmup()
            eng.generate(LONG_Q, max_new_tokens=base.max_new_tokens)
            eng.generate(SHORT_Q, max_new_tokens=base.max_new_tokens)
            beat()
            eng.tick_ms.clear()
            t0 = time.perf_counter()
            reqs = [eng.submit(p) for p in prompts]
            for r in reqs:
                r.done.wait(timeout=300)
            wall = time.perf_counter() - t0
            errors = sum(1 for r in reqs if r.error is not None)
            token_ids[mode] = [tuple(r.result.token_ids)
                               for r in reqs if r.result is not None]
            gen_tokens = sum(r.result.gen_tokens for r in reqs
                             if r.result is not None)
            ttfts = sorted(r.result.ttft_ms for r in reqs
                           if r.result is not None)
            decode_s = sum(eng.tick_ms) / 1000.0
            st = eng.spec_stats()
            out[mode] = {
                "tok_per_s": round(gen_tokens / max(decode_s, 1e-9), 3),
                "wall_tok_per_s": round(gen_tokens / max(wall, 1e-9), 3),
                "req_per_s": round(n_requests / max(wall, 1e-9), 4),
                "ttft_p50_ms": round(_pct(ttfts, 0.5), 2) if ttfts else None,
                "gen_tokens": gen_tokens,
                "decode_s": round(decode_s, 4),
                "ticks": len(eng.tick_ms),
                "errors": errors,
                "accept_ratio": st["accept_ratio"],
                "drafted_total": st["drafted_total"],
                "accepted_total": st["accepted_total"],
                "per_slot_accept": {ix: s["ratio"]
                                    for ix, s in st["per_slot"].items()},
                "verify_programs": len(eng._compiled.get("spec", ())),
                "gamma_buckets": st["gamma_buckets"],
            }
            if on and not errors:
                family = len(eng._gamma_buckets)
                built = len(eng._compiled.get("spec", ()))
                if built > family:
                    out["error"] = (
                        f"verify program churn: {built} speculative "
                        f"program(s) built for a (γ bucket) family of "
                        f"{family}")
        finally:
            eng.stop()
        beat()
    t_on = (out.get("on") or {}).get("tok_per_s")
    t_off = (out.get("off") or {}).get("tok_per_s")
    if t_on and t_off:
        out["tok_ratio"] = round(t_on / t_off, 3)
    w_on = (out.get("on") or {}).get("wall_tok_per_s")
    w_off = (out.get("off") or {}).get("wall_tok_per_s")
    if w_on and w_off:
        out["wall_tok_ratio"] = round(w_on / w_off, 3)
    ties = _judge(out, n_requests, ("off", "on"), token_ids, prompts,
                  dataclasses.replace(base, spec_decode=False,
                                      draft_preset=None),
                  tie_check, 7, device)
    if not ties and "error" not in out:
        out["error"] = ("speculative outputs diverged from plain greedy "
                        "decode: the acceptance rule is broken")
    return out


# The mixed leg's prompts (root bench.py:1571-1575).
MEASURED_Q = "measured short question about rivers please"
CO_Q = "co-tenant short question about lakes please"
LONG_DOC = ("long document: " + "rivers lakes mountains oceans deltas "
            * 150)                      # about 1500 tokens: the 1792 bucket
ARRIVAL_NEW = 24                        # both round kinds' decode budget


def mixed_phase(device=None, repeats: int = 2, beat=lambda: None,
                tier=None, tie_check: Optional[Callable] = None) -> dict:
    """The mixed-phase prefill-interference leg: a long prompt arrives
    mid-stream beside a short streaming request, chunked prefill (chunk
    256, budget 768) against one-shot prefill, the same engine family,
    seed and prompts.  Calm rounds give the stream a short co-tenant
    where injected rounds give it the long prompt; rounds alternate calm
    and injected, and the two modes interleave round by round.

    Per mode: the stream's pooled calm and injected p95 TBT, the headline
    ``tbt95_ratio`` (median over injected rounds of p95(whole-life gaps)
    / p95(the same round's gaps outside the absorption window)),
    ``stall_max_ms`` (the largest gap inside the window [arrival submit,
    arrival first token]; ``stall_calm_ms`` the same for the short
    co-tenant), the long request's TTFT and its own p95 TBT.  Greedy
    outputs of every class must be identical between modes
    (``outputs_identical``).  ``tier``: default JAX's pinned
    ``mini_bench`` (2 slots, one decode step a tick, buckets (16, 64,
    1792), 64 new tokens, no prefix cache)."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine

    print("[bench] mixed-phase chunked-prefill leg", file=sys.stderr,
          flush=True)
    chunk, budget = 256, 768
    base = tier or dataclasses.replace(
        tiny_batched_cluster().nano,
        model_preset="mini_bench", decode_batch=2,
        decode_steps_per_tick=1, max_new_tokens=64,
        prefill_buckets=(16, 64, 1792),
        enable_prefix_cache=False)
    out: dict = {"model_preset": base.model_preset,
                 "decode_batch": base.decode_batch,
                 "short_max_new": base.max_new_tokens,
                 "arrival_max_new": ARRIVAL_NEW,
                 "chunk_tokens": chunk, "chunk_budget": budget,
                 "repeats": repeats}

    def med(vals):
        vals = sorted(v for v in vals if v is not None)
        return (round(vals[len(vals) // 2], 3) if vals else None)

    token_ids: dict = {}
    modes = (("monolithic", dict(prefill_chunk_tokens=None)),
             ("chunked", dict(prefill_chunk_tokens=chunk,
                              prefill_chunk_budget=budget)))
    engines: dict = {}
    acc = {m: {"calm_pool": [], "inj_pool": [], "pair_ratios": [],
               "calm_stalls": [], "inj_stalls": [], "ttfts": [],
               "ltbts": [], "errors": 0, "fatal": None}
           for m, _ in modes}

    def run_round(eng, inject: bool):
        """One round: the measured stream decodes; once primed, the
        arrival (long when injecting, short otherwise) lands mid-stream.
        Returns the stream's gaps, the absorption-window stall and both
        results."""
        stamps: list = []
        stream_res: dict = {}
        errors: list = []

        def client():
            try:
                h = eng.generate_stream(MEASURED_Q)
                for _ in h:
                    stamps.append(time.perf_counter())
                stream_res["r"] = h.request.result
            except Exception as exc:
                errors.append(str(exc))

        t = threading.Thread(target=client, daemon=True)
        t.start()
        deadline = time.time() + 120
        # Primed: genuinely mid-stream.  A stream that ends before its
        # first delta (its first token is EOS) stops the wait; JAX's leg
        # then waits out the whole 120 s.
        while not stamps and t.is_alive() and time.time() < deadline:
            time.sleep(0.002)
        t_sub = time.perf_counter()
        ah = eng.generate_stream(LONG_DOC if inject else CO_Q,
                                 max_new_tokens=ARRIVAL_NEW)
        at: list = []
        for _ in ah:
            at.append(time.perf_counter())
        ares = ah.request.result
        t.join(timeout=300)
        gaps = [(b - a) * 1000.0 for a, b in zip(stamps, stamps[1:])]
        t_first = t_sub + ((ares.ttft_ms / 1000.0)
                           if ares is not None else 0.0)
        # A gap belongs to the absorption when its interval overlaps the
        # window (the one-shot prefill's gap ends one tick after the
        # long prompt's first token); the round's other gaps are its own
        # baseline.
        stall, rest = [], []
        for g, (a, b) in zip(gaps, zip(stamps, stamps[1:])):
            (stall if (b >= t_sub and a <= t_first) else rest).append(g)
        return {
            "gaps": gaps,
            "base_gaps": rest,
            "stall": max(stall) if stall else None,
            "ttft_ms": (round(ares.ttft_ms, 3)
                        if ares is not None else None),
            "arrival_gaps": [(b - a) * 1000.0
                             for a, b in zip(at, at[1:])],
            "stream_tokens": (tuple(stream_res["r"].token_ids)
                              if stream_res.get("r") is not None else ()),
            "arrival_tokens": (tuple(ares.token_ids)
                               if ares is not None else ()),
            "errors": errors,
        }

    try:
        for mode, cfgkw in modes:
            try:
                eng = ContinuousBatchingEngine(
                    dataclasses.replace(base, **cfgkw), seed=11,
                    device=device)
                engines[mode] = eng
                eng.warmup()
                beat()
                # The long path's programs (one-shot: the top bucket's
                # prefill; chunked: warmup's chunk family), then one
                # untimed concurrent round.
                eng.generate(LONG_DOC, max_new_tokens=2)
                beat()
                run_round(eng, inject=True)
                beat()
            except Exception as exc:
                acc[mode]["fatal"] = str(exc)[:200]
        # Rounds interleave the two modes so that a load swing lands on
        # both; each mode's calm and injected rounds stay back to back.
        for _ in range(repeats):
            for mode, _ in modes:
                a = acc[mode]
                if a["fatal"] is not None or mode not in engines:
                    continue
                try:
                    calm = run_round(engines[mode], inject=False)
                    beat()
                    inj = run_round(engines[mode], inject=True)
                    beat()
                except Exception as exc:
                    a["fatal"] = str(exc)[:200]
                    continue
                a["errors"] += len(calm["errors"]) + len(inj["errors"])
                a["calm_pool"].extend(calm["gaps"])
                a["inj_pool"].extend(inj["gaps"])
                i95 = _pct(inj["gaps"], 0.95)
                b95 = _pct(inj["base_gaps"], 0.95)
                if i95 and b95:
                    a["pair_ratios"].append(round(i95 / b95, 3))
                a["calm_stalls"].append(calm["stall"])
                a["inj_stalls"].append(inj["stall"])
                a["ttfts"].append(inj["ttft_ms"])
                a["ltbts"].append(_pct(inj["arrival_gaps"], 0.95))
                ids = token_ids.setdefault(mode, {})
                ids["short"] = inj["stream_tokens"]
                ids["long"] = inj["arrival_tokens"]
                ids["co"] = calm["arrival_tokens"]
    finally:
        for eng in engines.values():
            eng.stop()
    for mode, _ in modes:
        a = acc[mode]
        entry = {
            "repeats": repeats,
            "calm_tbt_p95_ms": _pct(a["calm_pool"], 0.95),
            "short_tbt_p95_ms": _pct(a["inj_pool"], 0.95),
            "tbt95_ratio": med(a["pair_ratios"]),
            "tbt95_ratios": a["pair_ratios"],
            "stall_max_ms": med(a["inj_stalls"]),
            "stall_calm_ms": med(a["calm_stalls"]),
            "long_ttft_ms": med(a["ttfts"]),
            "long_tbt_p95_ms": med(a["ltbts"]),
            "errors": a["errors"],
        }
        if a["fatal"] is not None:
            entry["error"] = a["fatal"]
        out[mode] = entry
        beat()
    # Chunked prefill changes when prompt K/V is written, never what it
    # holds: every class's tokens equal between modes (not vacuous).
    classes = ("short", "long", "co")
    ids_c = token_ids.get("chunked") or {}
    ids_m = token_ids.get("monolithic") or {}
    complete = all(ids_c.get(k) and ids_m.get(k) for k in classes)
    if complete:
        _judge(out, len(classes), ("chunked", "monolithic"),
               {m: [ids[k] for k in classes]
                for m, ids in (("chunked", ids_c), ("monolithic", ids_m))},
               (MEASURED_Q, LONG_DOC, CO_Q),
               dataclasses.replace(base, **dict(modes)["chunked"]),
               tie_check, 11, device)
    else:
        out["outputs_identical"] = False
    return out


# The shared leg's system prompt (root bench.py:1800-1802).
SHARED_PREFIX = ("system: you are a concise geography assistant for rivers "
                 "lakes mountains oceans deltas streams glaciers valleys. "
                 "answer with one short sentence. " * 2)


def shared_prefix_phase(k_sessions: int = 4, beat=lambda: None,
                        device=None, tier=None, prefix: Optional[str] = None,
                        tie_check: Optional[Callable] = None) -> dict:
    """The shared-prefix KV leg: K concurrent sessions over one long
    system prompt, cross-request block sharing on against off at the same
    seed and prompts.  Per mode: peak resident blocks while the K
    sessions are live (polled off ``kv_stats`` as JAX's leg polls, and
    taken to the pool allocator's high-water mark over the burst, which a
    poll can miss; JAX's bar is peak on < 0.6 x peak off at K >= 4), warm-session TTFT p50, req/s over the
    burst, the prefix cache's tokens-saved split and the live shared and
    dedup peaks.  Hard invariant (``error``): greedy outputs identical
    across modes.  ``tier``: default JAX's pinned tiny nano (6 new
    tokens, buckets (16, 32, 64, 128)); ``prefix``: the system prompt
    (default JAX's), so that a tier with larger blocks keeps the prefix
    dominant."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine
    from ..engine.inference import prepare_prompt

    print("[bench] shared-prefix KV leg", file=sys.stderr, flush=True)
    base = tier or dataclasses.replace(tiny_batched_cluster().nano,
                                       max_new_tokens=6,
                                       prefill_buckets=(16, 32, 64, 128))
    prefix = prefix or SHARED_PREFIX
    k = min(k_sessions, base.decode_batch)
    prompts = [prefix + f" user: question {i}?" for i in range(k)]
    out: dict = {"k_sessions": k, "decode_batch": base.decode_batch}

    token_ids: dict = {}
    for mode, share in (("on", True), ("off", False)):
        mtier = dataclasses.replace(base, share_prefix_kv=share)
        eng = ContinuousBatchingEngine(mtier, seed=11, device=device)
        try:
            if mode == "on":
                ids, _ = prepare_prompt(eng.tokenizer, prefix,
                                        mtier.prefill_buckets,
                                        eng.cfg.max_seq_len,
                                        mtier.max_new_tokens)
                out["prefix_tokens"] = len(ids)
            # Every program the burst can touch (suffix chunks, the
            # copy-on-write copy, decode), then the shared prefix parked.
            eng.warmup()
            beat()
            eng.generate(prefix)
            beat()
            cst0 = eng.prefix_cache.stats()
            total = eng.kv_stats()["total_blocks"]
            peak = shared_peak = 0
            dedup_peak = 1.0
            eng.allocator.reset_peak()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, token_queue=queue.Queue())
                    for p in prompts]
            # The peak the fixed pool must cover, polled while the burst
            # is live.
            while not all(r.done.is_set() for r in reqs):
                st = eng.kv_stats()
                peak = max(peak, total - st["free_blocks"])
                shared_peak = max(shared_peak, st["shared_blocks"])
                dedup_peak = max(dedup_peak, st["dedup_ratio"])
                time.sleep(0.001)
            wall = time.perf_counter() - t0
            # A burst of a few milliseconds (the tiny tiers on the card)
            # can end between two polls: the allocator's high-water mark
            # is the peak itself.
            peak = max(peak, eng.allocator.peak())
            for r in reqs:
                r.done.wait(timeout=120)
            errors = sum(1 for r in reqs if r.error is not None)
            token_ids[mode] = [tuple(r.result.token_ids)
                               for r in reqs if r.result is not None]
            ttfts = sorted(r.result.ttft_ms for r in reqs
                           if r.result is not None)
            cst = eng.prefix_cache.stats()
            out[mode] = {
                "peak_resident_blocks": peak,
                "peak_shared_blocks": shared_peak,
                "peak_dedup_ratio": round(dedup_peak, 3),
                "warm_ttft_p50_ms": _pct(ttfts, 0.50),
                "ttft_max_ms": round(ttfts[-1], 2) if ttfts else None,
                "req_per_s": round(k / max(wall, 1e-9), 4),
                "errors": errors,
                # Deltas over the measured burst.
                "hits_shared": cst["hits_shared"] - cst0["hits_shared"],
                "hits_exclusive": (cst["hits_exclusive"]
                                   - cst0["hits_exclusive"]),
                "tokens_saved_shared": (cst["tokens_saved_shared"]
                                        - cst0["tokens_saved_shared"]),
                "tokens_saved_exclusive": (
                    cst["tokens_saved_exclusive"]
                    - cst0["tokens_saved_exclusive"]),
            }
        finally:
            eng.stop()
        beat()
    on, off = out.get("on") or {}, out.get("off") or {}
    if on.get("peak_resident_blocks") and off.get("peak_resident_blocks"):
        out["peak_ratio"] = round(on["peak_resident_blocks"]
                                  / off["peak_resident_blocks"], 3)
    if on.get("warm_ttft_p50_ms") and off.get("warm_ttft_p50_ms"):
        out["ttft_p50_ratio"] = round(on["warm_ttft_p50_ms"]
                                      / off["warm_ttft_p50_ms"], 3)
    # Sharing must not move a single token against the exclusive path.
    ties = _judge(out, k, ("on", "off"), token_ids, prompts,
                  dataclasses.replace(base, share_prefix_kv=True),
                  tie_check, 11, device)
    if not ties:
        out["error"] = ("shared-prefix outputs diverged from the "
                        "exclusive path: the copy-on-write identity "
                        "contract is broken")
    return out
