#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases
(any failure exits non-zero before the last line):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the three attention kernels (``csrc/*.cu``) compile with nvcc
   for sm_90a, in parallel;
3. kernels: each kernel, at the nano tier's main-path shapes in bf16, is
   held against its plain PyTorch version on the same inputs, and timed
   beside the plain version, one PyTorch library call computing the same
   function (SDPA on the gathered K/V, timed here only) and the card's
   bound (bytes at 3.35 TB/s, bf16 operations at 989 TFLOP/s); each is
   also checked at its other instantiations (head dim, block, group);
4. serve: the default nano tier (nano_1b at full width, seeded random
   weights) under EngineManager behind the /query server on 127.0.0.1;
   cold, chunked, prefix-hit, concurrent and streaming requests go over
   HTTP, every kernel must have launched on that run and no plain
   attention version may have run; then the decode step's logits on the
   live pool with the kernel and with the plain attention must agree, and
   one decode step is timed eager and as a replayed CUDA graph.

It prints the kernel table as one JSON line, the serving numbers as one
JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
REPORT_DIR = os.path.join(REPO, "chiprun_out")

# Kernel vs plain tolerance, |kernel - plain| <= ATOL + RTOL * |plain|,
# bf16 inputs drawn N(0, 1): the kernels scale q in float32 before QK and
# keep the logits in float32 where the plain versions round the logits
# to bf16, so outputs differ by a couple of bf16 ulps (2^-8 relative)
# of outputs that reach |4| on rows that attend few keys.
KERNEL_ATOL = 2e-2
KERNEL_RTOL = 2e-2
TOL = f"{KERNEL_ATOL:g} + {KERNEL_RTOL:g} * |plain|"
# Decode logits after 16 bf16 layers, kernel vs plain attention in every
# layer: the few-ulp attention differences pass through every later
# layer, so the bound is relative to the logits' own scale.
LOGITS_RTOL = 0.05
SERVE_MAX_NEW = 32               # random weights rarely stop at EOS


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# -- timing ------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, each timed
    by CUDA events; ``flush`` (run untimed before each call) evicts L2 so
    every call finds its inputs cold, as the serving path does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def compare(a, b, rows=None):
    """(max abs error, max of |a - b| / (ATOL + RTOL |b|)) over the first
    ``rows`` rows of dim 1; the kernel agrees when the second is <= 1."""
    if rows is not None:
        a, b = a[:, :rows], b[:, :rows]
    d = (a.float() - b.float()).abs()
    scaled = d / (KERNEL_ATOL + KERNEL_RTOL * b.float().abs())
    return d.max().item(), scaled.max().item()


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels ----------------------------------------------------------

def kernel_phase(torch, cfg, bs: int):
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = nq // nkv
    mb = -(-cfg.max_seq_len // bs)
    n_slots = 8
    nb = n_slots * mb + 1
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
    rows = []

    # K1: ragged decode, 8 slots of skewed length, slot 0 idle (trash).
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = perm[:n_slots * mb].reshape(n_slots, mb).to(torch.int32)
    tables[0] = 0
    pos = torch.tensor([0, 40, 200, 700, 1500, 3000, 5000,
                        cfg.max_seq_len - 1], dtype=torch.int32, device=dev)
    q = randn(n_slots, nq, d)
    out = TR.ragged_paged_decode_attention(q, k_pool, v_pool, tables, pos)
    ref = TA._gather_decode_paged(q, k_pool, v_pool, tables, pos)
    torch.cuda.synchronize()
    e1, r1 = compare(out, ref)
    require(r1 <= 1, f"ragged_decode disagrees: max abs err {e1}")
    k_seq, v_seq = TA._gather_pool_seq(k_pool, v_pool, tables)
    k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    cols = torch.arange(mb * bs, device=dev)
    mask = (cols[None, :] <= pos[:, None])[:, None, None, :]
    q_l = q[:, :, None, :]
    pos_h = pos.tolist()
    blocks = sum(p // bs + 1 for p in pos_h)
    b1, by1 = bound(2 * blocks * nkv * bs * d * 2 + 2 * q.numel() * 2
                    + tables.numel() * 4 + pos.numel() * 4,
                    sum(4 * nq * (p + 1) * d for p in pos_h))
    rows.append({
        "name": "ragged_decode", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/ragged_decode.cu",
        "replaces": "distributed_llm_tpu/ops/ragged_attention.py:59",
        "shape": f"B={n_slots} Nq={nq} Nkv={nkv} D={d} bs={bs} MB={mb} "
                 f"NB={nb} pos={pos_h}",
        "max_abs_err": e1, "tol": TOL,
        "ms": time_ms(torch, lambda: TR.ragged_paged_decode_attention(
            q, k_pool, v_pool, tables, pos), flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_decode_paged(
            q, k_pool, v_pool, tables, pos), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_l, v_l, attn_mask=mask), flush=flush),
        "bound_ms": b1, "bound_by": by1})

    # K2: causal prefill; checked at every cold bucket up to a chunk,
    # timed at 256 (the largest monolithic prefill of the default tier).
    e2 = r2 = 0.0
    for s in (64, 128, 256):
        qc, kc, vc = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
        out = TF.flash_causal_attention(qc, kc, vc)
        ref = TA.causal_attention(qc, kc, vc)
        torch.cuda.synchronize()
        e, r = compare(out, ref)
        e2, r2 = max(e2, e), max(r2, r)
    require(r2 <= 1, f"flash_causal disagrees: max abs err {e2}")
    s = 256
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (qc, kc, vc))
    ks, vs = ks.repeat_interleave(g, 1), vs.repeat_interleave(g, 1)
    b2, by2 = bound(2 * (qc.numel() + kc.numel() + vc.numel() + qc.numel()),
                    4 * nq * d * s * (s + 1) // 2)
    rows.append({
        "name": "flash_causal", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/flash_causal.cu",
        "replaces": "distributed_llm_tpu/ops/pallas_attention.py:57",
        "shape": f"B=1 S={s} Nq={nq} Nkv={nkv} D={d} (checked at S=64,128,256)",
        "max_abs_err": e2, "tol": TOL,
        "ms": time_ms(torch, lambda: TF.flash_causal_attention(qc, kc, vc),
                      flush=flush),
        "plain_ms": time_ms(torch, lambda: TA.causal_attention(qc, kc, vc),
                            flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), flush=flush),
        "bound_ms": b2, "bound_by": by2})

    # K3: paged chunk.  Checked at a prefix hit (64 rows at start 37,
    # window 256) and timed at the long prompt's second chunk (256 rows at
    # start 256, window 1024).
    table = (torch.randperm(nb - 1, generator=gen, device=dev)[:mb] + 1).to(
        torch.int32)
    e3 = r3 = 0.0
    for start, s_c, window, true_len in ((37, 64, 256, 38), (256, 256, 1024, 512)):
        qc = randn(1, s_c, nq, d)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                            max=true_len - 1)[None]
        out = TF.paged_chunk_attention(qc, k_pool, v_pool, table, st, window)
        ref = TA._gather_chunk_paged(qc, k_pool, v_pool, table, q_pos, window)
        torch.cuda.synchronize()
        e, r = compare(out, ref, rows=true_len - start)
        e3, r3 = max(e3, e), max(r3, r)
    require(r3 <= 1, f"paged_chunk disagrees: max abs err {e3}")
    wb = window // bs
    kw = k_pool[:, table[:wb].long()].reshape(nkv, window, d)
    vw = v_pool[:, table[:wb].long()].reshape(nkv, window, d)
    kw = kw.repeat_interleave(g, 0)[None].contiguous()
    vw = vw.repeat_interleave(g, 0)[None].contiguous()
    qs = qc.transpose(1, 2).contiguous()
    wcols = torch.arange(window, device=dev)
    wmask = (wcols[None, :] <= (start + torch.arange(s_c, device=dev))[:, None])
    last = start + s_c - 1
    b3, by3 = bound(2 * (last // bs + 1) * nkv * bs * d * 2 + 2 * qc.numel() * 2
                    + table.numel() * 4,
                    sum(4 * nq * d * (start + r + 1) for r in range(s_c)))
    rows.append({
        "name": "paged_chunk", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/paged_chunk.cu",
        "replaces": "distributed_llm_tpu/ops/pallas_attention.py:571",
        "shape": f"S_c={s_c} start={start} window={window} Nq={nq} Nkv={nkv} "
                 f"D={d} bs={bs} (checked at S_c=64 start=37 window=256 too)",
        "max_abs_err": e3, "tol": TOL,
        "ms": time_ms(torch, lambda: TF.paged_chunk_attention(
            qc, k_pool, v_pool, table, st, window), flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_chunk_paged(
            qc, k_pool, v_pool, table, q_pos, window), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kw, vw, attn_mask=wmask[None, None]), flush=flush),
        "bound_ms": b3, "bound_by": by3})
    del flush_buf, k_pool, v_pool
    variant_errs = variant_checks(torch, gen)
    for row in rows:
        err, ratio = variant_errs[row["name"]]
        row["variants_max_abs_err"] = err
        require(ratio <= 1, f"{row['name']} disagrees at another head dim / "
                f"block size / group: max abs err {err}")
    torch.cuda.empty_cache()
    return rows


def variant_checks(torch, gen) -> dict:
    """Each kernel against its plain version at the other instantiations
    it accepts (head dim 64/128, block 32/64/128, GQA group 1/4/8) on
    small ragged shapes: idle slot, partial tiles, padded chunk rows.
    Returns (max abs error, max scaled error) per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    worst = {"ragged_decode": (0.0, 0.0), "flash_causal": (0.0, 0.0),
             "paged_chunk": (0.0, 0.0)}

    def note(name, a, b):
        e, r = compare(a, b)
        worst[name] = (max(worst[name][0], e), max(worst[name][1], r))

    for d in (64, 128):
        for bs in (32, 64, 128):
            for nq, nkv in ((32, 8), (16, 2), (8, 8)):
                b, mb = 4, 12
                nb = b * mb + 1
                kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
                tables = (torch.randperm(nb - 1, generator=gen, device=dev)
                          + 1)[:b * mb].reshape(b, mb).to(torch.int32)
                tables[1] = 0
                pos = torch.tensor([mb * bs - 1, 0, 5, 100], dtype=torch.int32,
                                   device=dev)
                q = randn(b, nq, d)
                note("ragged_decode",
                     TR.ragged_paged_decode_attention(q, kp, vp, tables, pos),
                     TA._gather_decode_paged(q, kp, vp, tables, pos))
                qc, kc, vc = randn(2, 100, nq, d), randn(2, 100, nkv, d), \
                    randn(2, 100, nkv, d)
                note("flash_causal", TF.flash_causal_attention(qc, kc, vc),
                     TA.causal_attention(qc, kc, vc))
                start, s_c, true_len = 20, 70, 80
                table = tables[0].contiguous()
                qq = randn(1, s_c, nq, d)
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                                    max=true_len - 1)[None]
                valid = true_len - start
                note("paged_chunk",
                     TF.paged_chunk_attention(qq, kp, vp, table, st,
                                              4 * bs)[:, :valid],
                     TA._gather_chunk_paged(qq, kp, vp, table, q_pos,
                                            4 * bs)[:, :valid])
    return worst


# -- phase 4: serve ------------------------------------------------------------

def post(url: str, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def query(base: str, q, **extra) -> dict:
    status, text = post(base + "/query", {"query": q, "stats": True,
                                          "num_predict": SERVE_MAX_NEW, **extra})
    require(status == 200, f"/query returned {status}: {text}")
    body = json.loads(text)
    require(isinstance(body.get("response"), str) and body["response"].strip(),
            f"/query returned an empty reply: {body}")
    return body


WORDS = ("rivers lakes mountains oceans deltas weather systems clouds rain "
         "snow glaciers valleys forests deserts islands coasts tides storms "
         "winds seasons").split()


def words(n: int, offset: int = 0) -> str:
    return " ".join(WORDS[(i + offset) % len(WORDS)] for i in range(n))


def serve_phase(torch, tier, device: str = "cuda"):
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR
    from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app
    from distributed_llm_tpu_torch.utils.webapp import _ThreadingWSGIServer

    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, device=device)
    manager.start_server()                   # build + warm (one request)
    startup_s = time.perf_counter() - t0
    app = create_tier_app("nano", manager=manager)
    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):       # no per-request access log
            pass

    server = make_server("127.0.0.1", 0, app, server_class=_ThreadingWSGIServer,
                         handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    engine = manager.engine()
    kernels = (TR.ragged_paged_decode_attention, TF.flash_causal_attention,
               TF.paged_chunk_attention)
    plains = (TA.causal_attention, TA.chunk_attention, TA.decode_attention)
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            require(resp.status == 200 and json.loads(resp.read())["ok"],
                    "/health not ok")
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t_main = time.perf_counter()

        # Cold prefill (flash_causal), twice: greedy must repeat itself.
        turn1 = [{"role": "user", "content": "tell me about " + words(12)}]
        first = query(base, turn1)
        again = query(base, turn1)
        require(first["response"] == again["response"],
                "the same greedy prompt gave two different replies")
        # Prompt past one 256-token chunk: chunked prefill (paged_chunk).
        long_reply = query(base, "summarise: " + words(420, 3))
        require(long_reply["stats"]["prompt_tokens"] > 256,
                f"long prompt only {long_reply['stats']['prompt_tokens']} tokens")
        # Multi-turn follow-up of the first: shared prefix hit (paged_chunk
        # over the parked blocks, copy-on-write boundary block).
        hits0 = engine.prefix_cache.stats()["hits_shared"]
        turn2 = turn1 + [{"role": "assistant", "content": first["response"]},
                         {"role": "user", "content": "and " + words(6, 5) + "?"}]
        query(base, turn2)
        require(engine.prefix_cache.stats()["hits_shared"] > hits0,
                "the follow-up did not hit the parked prefix")
        # 8 concurrent requests of skewed length: ragged ticks.
        lengths = (4, 20, 45, 80, 120, 160, 200, 240)
        results = [None] * len(lengths)

        def worker(i, n):
            results[i] = query(base, f"request {i}: " + words(n, i))

        threads = [threading.Thread(target=worker, args=(i, n))
                   for i, n in enumerate(lengths)]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        require(all(r is not None for r in results),
                "a concurrent request did not complete")
        # One streamed request.
        status, text = post(base + "/query/stream",
                            {"query": "stream about " + words(10, 7),
                             "num_predict": SERVE_MAX_NEW})
        events = [json.loads(line[6:]) for line in text.split("\n")
                  if line.startswith("data: ")]
        require(status == 200 and events and events[-1].get("done")
                and events[-1]["tokens"] > 0
                and "".join(e.get("delta", "") for e in events).strip(),
                f"/query/stream failed: {text[:500]}")
        main_s = time.perf_counter() - t_main
        launches = {"ragged_decode": TR.ragged_paged_decode_attention.launches,
                    "flash_causal": TF.flash_causal_attention.launches,
                    "paged_chunk": TF.paged_chunk_attention.launches}
        plain_calls = {fn.__name__: fn.calls for fn in plains}
        require(all(n > 0 for n in launches.values()),
                f"a kernel did not run on the main path: {launches}")
        require(not any(plain_calls.values()),
                f"plain attention ran on the main path: {plain_calls}")
        n_requests = 5 + len(lengths)

        logits_err, logits_max = logits_check(torch, engine, TA)
        require(logits_err <= LOGITS_RTOL * logits_max,
                f"decode logits kernel vs plain differ by {logits_err} "
                f"(max |logit| {logits_max})")

        breakdown = step_breakdown(torch, engine)

        gen_tokens = sum(r["stats"]["gen_tokens"] for r in results)
        ttfts = [r["stats"]["ttft_ms"] for r in results]
        serve = {
            "tier": tier.name, "model": tier.model_preset,
            "startup_s": startup_s, "main_path_s": main_s,
            "requests": n_requests, "launches": launches,
            "plain_calls": plain_calls,
            "launches_per_request": {k: v / n_requests
                                     for k, v in launches.items()},
            "concurrent": {"requests": len(lengths), "wall_s": burst_s,
                           "gen_tokens": gen_tokens,
                           "tokens_per_s": gen_tokens / burst_s,
                           "p50_ttft_ms": statistics.median(ttfts),
                           "ttft_ms": ttfts,
                           "prompt_tokens": [r["stats"]["prompt_tokens"]
                                             for r in results]},
            "cold_ttft_ms": first["stats"]["ttft_ms"],
            "chunked_ttft_ms": long_reply["stats"]["ttft_ms"],
            "tick_stats": engine.tick_stats(),
            "decode_step": breakdown,
            "decode_logits_max_abs_err": logits_err,
            "decode_logits_max_abs": logits_max,
            "logits_tol": LOGITS_RTOL * logits_max,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device == "cuda" else None),
        }
        return serve, launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        manager.stop_server()


def _live_decode_state(torch, engine):
    """Every slot continuing the longest parked conversation by one token:
    (tables, pos, cur, length) for decode_step_paged on the live pool."""
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    blocks = entry.cache["blocks"]
    n = len(entry.ids)
    b = engine.paged.max_slots
    tables = torch.zeros((b, engine.paged.blocks_per_slot), dtype=torch.int32)
    tables[:, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    pos = torch.full((b,), n - 1, dtype=torch.int32)
    cur = torch.full((b,), entry.ids[-1], dtype=torch.long)
    return (tables.to(engine.device), pos.to(engine.device),
            cur.to(engine.device), n)


def step_breakdown(torch, engine) -> dict:
    """Where one 8-slot decode step's time goes: its eager wall time
    (enqueue and run, then synchronize) against the same step captured
    once as a CUDA graph and replayed, which is its device time with no
    host launch gaps; their ratio is the device's idle share in eager
    mode.  Plus the ragged decode kernel's part (one launch per layer)."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    tables, pos, cur, n = _live_decode_state(torch, engine)
    pool = {k: v.clone() for k, v in engine.pool.items()}
    cfg = engine.cfg

    def step():
        decode_step_paged(cfg, engine.model, cur, pos, pool, tables)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph_ms = time_ms(torch, graph.replay, iters=iters)
    q = torch.randn((engine.paged.max_slots, cfg.num_heads, cfg.head_dim),
                    device=engine.device).to(pool["k"].dtype)
    attn_ms = cfg.num_layers * time_ms(
        torch, lambda: TR.ragged_paged_decode_attention(
            q, pool["k"][0], pool["v"][0], tables, pos))
    del graph, pool
    return {"slots": engine.paged.max_slots, "position": n - 1,
            "wall_ms": wall_ms, "graph_ms": graph_ms,
            "ragged_decode_ms": attn_ms,
            "device_idle_share": max(0.0, 1.0 - graph_ms / wall_ms)}


def logits_check(torch, engine, TA):
    """Decode-step logits on the live pool: the parked prefix of the
    served conversation, continued by one token, with the kernel and with
    the plain attention (each on its own copy of the pool).  Returns
    (max abs difference, max abs plain logit)."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, _ = _live_decode_state(torch, engine)
    out = []
    for attn in (None, TA._gather_decode_paged):
        pool = {k: v.clone() for k, v in engine.pool.items()}
        out.append(decode_step_paged(engine.cfg, engine.model, cur, pos, pool,
                                     tables, attn=attn)[0])
        del pool
    return ((out[0] - out[1]).abs().max().item(),
            out[1].abs().max().item())


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(REPO, "distributed_llm_tpu_torch")):
        fail("run from the root of a checkout: distributed_llm_tpu_torch/ "
             "is missing")
    sys.path.insert(0, REPO)
    t_all = time.perf_counter()

    # 1. Environment.
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. Build.
    from distributed_llm_tpu_torch.config import ClusterConfig
    from distributed_llm_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        with open(path + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln
                           or "spill" in ln]
    log(f"built {sorted(paths)} in {build_s:.1f}s")

    # 3. Kernels.
    tier = ClusterConfig().nano
    rows = kernel_phase(torch, tier.model(), tier.kv_block_size)

    # 4. Serve.
    serve, launches = serve_phase(torch, tier)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["kernel_ms"] = row["ms"]

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "kernels": rows, "serve": serve,
              "total_s": time.perf_counter() - t_all}
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "variants_max_abs_err")
    log(json.dumps({"card": card, "serve": {
        k: serve[k] for k in ("model", "requests", "launches_per_request",
                              "concurrent", "cold_ttft_ms", "chunked_ttft_ms",
                              "tick_stats", "decode_step",
                              "decode_logits_max_abs_err",
                              "decode_logits_max_abs", "peak_memory_gb")},
        "total_s": report["total_s"]}))
    log(f"{card}")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
