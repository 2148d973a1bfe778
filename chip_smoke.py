#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases
(any failure exits non-zero before the last line):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the twelve attention kernels (``csrc/*.cu``) compile with nvcc
   for sm_90a, in parallel;
3. kernels: each kernel, at its main-path shapes (the nano tier's for the
   ragged decode, causal prefill and paged chunk kernels; the orin tier's
   for the ragged verify and the int8 ragged decode and verify kernels),
   is held against its plain PyTorch version on the same inputs (every
   output row within KERNEL_REL_TOL of the plain version in float32), and
   timed beside the plain version, one PyTorch library call computing the
   same function (SDPA on the gathered, dequantized K/V, timed here only)
   and the card's bound (bytes at 3.35 TB/s, operations at the bf16 rate
   of 989 TFLOP/s); each is also checked at its other instantiations
   (head dim, block, group, verify width); the dense windowed tick's
   paged decode kernels (bf16 at the nano tier's shape, int8 at the orin
   tier's, each through a column slice of the full table) and the
   contiguous-cache decode and chunk kernels of the sequential engines
   (bf16 and int8) likewise, at their serving shapes;
4. serve nano: the default nano tier (nano_1b at full width, seeded
   random weights) under EngineManager behind the /query server on
   127.0.0.1; cold, chunked, prefix-hit, concurrent and streaming
   requests go over HTTP;
5. serve orin, bf16 KV, with nano_1b drafting (batched speculation), and
6. serve orin, int8 KV, drafting with itself: orin_8b at full width and
   depth, the same requests plus a sampled one;
7. serve orin sequentially (``decode_batch=1``: InferenceEngine over the
   contiguous bf16 cache), 8. the same with the nano_1b draft
   (SpeculativeEngine), and 9. nano_1b sequentially with the int8 cache,
   at full width and depth: a short prompt, one past the 2048 bucket, a
   multi-turn follow-up, 3 concurrent (serialized) requests, a stream
   and a sampled request (which the speculative tier refuses with the
   JAX package's 500 / 501);
10. the two-tier ``/chat`` service: ``create_app`` over a production-mode
   Router (``BASE_CONFIG``) of nano_1b (8 slots, bf16 pool) and orin_8b
   (4 slots, int8 pool), both on the dense windowed tick, over HTTP;
   every routing strategy in turn sends a concurrent burst, a repeated
   query (a response-cache hit), follow-up turns and streams.

Each serve phase sets every kernel's launch count and every plain
version's call count to 0 before its requests and reads them after: the
phase's kernels must have launched and no plain attention version may
have run (the /chat phase: no ragged decode kernel either, and both tiers
must have served).  Then, on the live pool or cache, the decode step's logits
with the kernel and with the plain attention (in bf16 and in float32)
must agree (speculating tiers: the verify's rows against as many
sequential decode steps, and the verify with the kernel against the
verify with the plain attention), and one decode step is timed eager and
as a replayed CUDA graph.

It prints the serving numbers as one JSON line, the /chat phase's numbers
per strategy as another, the card's name and power limit, the kernel
table as one JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
REPORT_DIR = os.path.join(REPO, "chiprun_out")

# Kernel vs plain, bf16 inputs drawn N(0, 1).  Every output row (one
# query head's D values) of the kernel is held against the same row of
# the plain version run in float32 on the same inputs (bf16 widened
# exactly, int8 dequantized in float32): ||kernel - plain32|| / ||plain32||
# <= KERNEL_REL_TOL.  The kernels round P (the bf16 ones) and their output
# to bf16: their worst rows read 0.0019-0.0034 on an H100, the plain
# versions in bf16 0.005-0.019 (they round the logits and, for int8, the
# dequantized K/V to bf16).  A row's output shrinks as its
# frontier N grows (it averages N random values, about sqrt(e / N)), so
# the bound is relative to each row: a row that misses one 64-position
# tile moves by about sqrt(64 / N) of itself, 9% at N = 8192, and the
# contiguous-cache checks assert that the plain version one tile short
# lands outside the bound at every timed shape.  The plain version in
# bf16 against float32 (``plain_rel_err``) is reported beside it.
KERNEL_REL_TOL = 1e-2
TOL = f"per-row ||kernel - plain32|| / ||plain32|| <= {KERNEL_REL_TOL:g}"
KV_TILE = 64                     # positions per staged K/V tile (K9-K12)
# Decode (and verify) logits after 16 or 32 bf16 layers, the kernel in
# every layer against the plain attention, in bf16 and in float32: the
# few-ulp attention differences pass through every later layer, and a
# model of seeded random weights amplifies them (its matrices have a gain
# above 1), the more the deeper it is.  So the bound is LOGITS_RTOL of the
# logits' own scale above the model's rounding floor, measured on the
# same state: how far the plain attention in bf16 lands from the same in
# float32.  A fault in the path (a wrong layer, table,
# position or scale plane) moves the logits by their whole scale.
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


def widen(args):
    """``args`` with every bf16 tensor as float32 (exact); int8 caches,
    float32 scales, tables and positions as they are."""
    return [a.float() if hasattr(a, "is_floating_point")
            and a.is_floating_point() and a.element_size() == 2 else a
            for a in args]


def row_rel_err(a, b) -> float:
    """The worst row's ||a - b|| / ||b||, a row being the last dim."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


NO_ERR = {"max_abs_err": 0.0, "rel_err": 0.0, "plain_rel_err": 0.0}


def compare(out, plain, args, rows=None) -> dict:
    """A kernel's ``out`` against ``plain(*args)`` and against ``plain``
    on the float32-widened ``args``, over the first ``rows`` rows of dim
    1: the max abs error against the plain version, the worst row's
    relative error against it in float32 (``rel_err``, the one held to
    KERNEL_REL_TOL) and the plain version's own (``plain_rel_err``)."""
    ref, ref32 = plain(*args), plain(*widen(args))
    if rows is not None:
        out, ref, ref32 = (x[:, :rows] for x in (out, ref, ref32))
    return {"max_abs_err": (out.float() - ref.float()).abs().max().item(),
            "rel_err": row_rel_err(out, ref32),
            "plain_rel_err": row_rel_err(ref, ref32)}


def worst(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def agrees(name: str, res: dict, where: str = "") -> None:
    require(res["rel_err"] <= KERNEL_REL_TOL,
            f"{name} disagrees with its plain version{where}: {res}")


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
    torch.cuda.synchronize()
    a1 = compare(out, TA._gather_decode_paged, (q, k_pool, v_pool, tables, pos))
    agrees("ragged_decode", a1)
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
        **a1, "tol": TOL,
        "ms": time_ms(torch, lambda: TR.ragged_paged_decode_attention(
            q, k_pool, v_pool, tables, pos), flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_decode_paged(
            q, k_pool, v_pool, tables, pos), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_l, v_l, attn_mask=mask), flush=flush),
        "bound_ms": b1, "bound_by": by1})

    # K2: causal prefill; checked at every cold bucket up to a chunk,
    # timed at 256 (the largest monolithic prefill of the default tier).
    a2 = NO_ERR
    for s in (64, 128, 256):
        qc, kc, vc = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
        out = TF.flash_causal_attention(qc, kc, vc)
        torch.cuda.synchronize()
        a2 = worst(a2, compare(out, TA.causal_attention, (qc, kc, vc)))
    agrees("flash_causal", a2)
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
        **a2, "tol": TOL,
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
    a3 = NO_ERR
    for start, s_c, window, true_len in ((37, 64, 256, 38), (256, 256, 1024, 512)):
        qc = randn(1, s_c, nq, d)
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                            max=true_len - 1)[None]
        out = TF.paged_chunk_attention(qc, k_pool, v_pool, table, st, window)
        torch.cuda.synchronize()
        a3 = worst(a3, compare(out, TA._gather_chunk_paged,
                               (qc, k_pool, v_pool, table, q_pos, window),
                               rows=true_len - start))
    agrees("paged_chunk", a3)
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
        **a3, "tol": TOL,
        "ms": time_ms(torch, lambda: TF.paged_chunk_attention(
            qc, k_pool, v_pool, table, st, window), flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_chunk_paged(
            qc, k_pool, v_pool, table, q_pos, window), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kw, vw, attn_mask=wmask[None, None]), flush=flush),
        "bound_ms": b3, "bound_by": by3})
    del flush_buf, k_pool, v_pool
    note_variants(rows, variant_checks(torch, gen))
    torch.cuda.empty_cache()
    return rows


def note_variants(rows, errs: dict) -> None:
    """Each row's kernel must have agreed at its other instantiations."""
    for row in rows:
        res = errs[row["name"]]
        row["variants_max_abs_err"] = res["max_abs_err"]
        row["variants_rel_err"] = res["rel_err"]
        agrees(row["name"], res, " at another instantiation")


def variant_checks(torch, gen) -> dict:
    """Each kernel against its plain version at the other instantiations
    it accepts (head dim 64/128, block 32/64/128, GQA group 1/4/8) on
    small ragged shapes: idle slot, partial tiles, padded chunk rows.
    Returns the worst ``compare`` per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("ragged_decode", "flash_causal", "paged_chunk")}

    def note(name, out, plain, *args, rows=None):
        errs[name] = worst(errs[name], compare(out, plain, args, rows))

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
                     TA._gather_decode_paged, q, kp, vp, tables, pos)
                qc, kc, vc = randn(2, 100, nq, d), randn(2, 100, nkv, d), \
                    randn(2, 100, nkv, d)
                note("flash_causal", TF.flash_causal_attention(qc, kc, vc),
                     TA.causal_attention, qc, kc, vc)
                start, s_c, true_len = 20, 70, 80
                table = tables[0].contiguous()
                qq = randn(1, s_c, nq, d)
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                q_pos = torch.clamp(start + torch.arange(s_c, device=dev),
                                    max=true_len - 1)[None]
                note("paged_chunk",
                     TF.paged_chunk_attention(qq, kp, vp, table, st, 4 * bs),
                     TA._gather_chunk_paged, qq, kp, vp, table, q_pos, 4 * bs,
                     rows=true_len - start)
    return errs


# -- phase 3, continued: the speculation and int8 kernels ----------------------

def verify_bound(cfg, pos_h, g: int, bs: int, kv_bytes: float, q_bytes: int,
                 table_bytes: int):
    """Bytes: each slot's own ceil((pos + g) / bs) blocks of K and V once
    (``kv_bytes`` per position and kv head, scales included), q and out
    once, the tables and positions; operations: QK and PV multiply-adds
    of every query row over the keys it sees."""
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    blocks = sum((p + g - 1) // bs + 1 for p in pos_h)
    return bound(blocks * nkv * bs * kv_bytes + 2 * q_bytes + table_bytes,
                 sum(4 * nq * d * (p + r + 1) for p in pos_h for r in range(g)))


def spec_kernel_phase(torch, cfg, draft_cfg, bs: int, n_slots: int):
    """The ragged verify kernel (bf16) and the int8 ragged decode and
    verify kernels at the orin tier's shapes: 4 slots at positions 0
    (idle, trash row), 100, 3000 and the context's end, the pool of a
    4-slot orin engine ([8, 513, 64, 128]), verify widths G = 2, 3, 5 (the
    γ buckets 1, 2, 4) checked and G = 5 timed; the int8 decode at D=128
    (self-draft, γ=0 ticks) timed and at D=64 (the nano draft's pool)
    checked.  The bf16 ragged decode is also checked at the nano draft's
    shape (B=4, D=64, 513 blocks).  Returns the three rows and the bf16
    decode's error at the draft shape."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    grp = nq // nkv
    mb = -(-cfg.max_seq_len // bs)
    nb = n_slots * mb + 1
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    def slot_tables(n_blocks):
        perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
        t = perm[:n_slots * mb].reshape(n_slots, mb).to(torch.int32)
        t[0] = 0                                    # idle slot: trash row
        return t.contiguous()

    def positions(g):
        return torch.tensor([0, 100, 3000, cfg.max_seq_len - g],
                            dtype=torch.int32, device=dev)

    k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
    kq, ks = quant.quantize_kv_rows(k_pool)
    vq, vs = quant.quantize_kv_rows(v_pool)
    tables = slot_tables(nb)
    table_bytes = tables.numel() * 4 + n_slots * 4
    rows = []

    def sdpa_inputs(q, pool, tbl, pos):
        """[B, Nq, G, D] q, GQA-expanded gathered (dequantized) K/V and
        the per-row causal mask, for one SDPA call (the gather is not
        timed)."""
        g = q.shape[1]
        k_seq, v_seq = TA._gather_pool_seq(pool[0], pool[1], tbl, pool[2],
                                           pool[3], bf)
        k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
        v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
        cols = torch.arange(k_seq.shape[1], device=dev)
        rowpos = pos.long()[:, None] + torch.arange(g, device=dev)[None]
        mask = (cols[None, None, :] <= rowpos[:, :, None])[:, None]
        return q.permute(0, 2, 1, 3).contiguous(), k_l, v_l, mask

    # K4 / K6: ragged verify over the bf16 and the int8 pool.
    for name, src, replaces, pool, kv_bytes in (
            ("ragged_verify", "ragged_verify.cu", "ragged_attention.py:170",
             (k_pool, v_pool, None, None), 2 * d * 2),
            ("ragged_verify_q8", "ragged_verify_q8.cu",
             "ragged_attention.py:389", (kq, vq, ks, vs), 2 * (d + 4))):
        q8 = pool[2] is not None
        kern = (TR.ragged_paged_verify_attention_q8 if q8
                else TR.ragged_paged_verify_attention)
        agree = NO_ERR
        for g in (2, 3, 5):
            pos = positions(g)
            q = randn(n_slots, g, nq, d)
            kargs = ((q, *pool, tables, pos) if q8
                     else (q, pool[0], pool[1], tables, pos))
            out = kern(*kargs)
            torch.cuda.synchronize()
            agree = worst(agree, compare(
                out, TA._gather_verify_paged,
                (q, pool[0], pool[1], tables, pos, pool[2], pool[3])))
        agrees(name, agree)
        pos_h = pos.tolist()
        lib = sdpa_inputs(q, pool, tables, pos)
        b_ms, b_by = verify_bound(cfg, pos_h, g, bs, kv_bytes, q.numel() * 2,
                                  table_bytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{src}",
            "replaces": f"distributed_llm_tpu/ops/{replaces}",
            "shape": f"B={n_slots} G={g} Nq={nq} Nkv={nkv} D={d} bs={bs} "
                     f"MB={mb} NB={nb} pos={pos_h} (checked at G=2,3,5)",
            **agree, "tol": TOL,
            "ms": time_ms(torch, lambda: kern(*kargs), flush=flush),
            "plain_ms": time_ms(torch, lambda: TA._gather_verify_paged(
                q, pool[0], pool[1], tables, pos, pool[2], pool[3]),
                flush=flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                lib[0], lib[1], lib[2], attn_mask=lib[3]), flush=flush),
            "bound_ms": b_ms, "bound_by": b_by})
        del lib

    # K5: int8 ragged decode, timed at the orin pool (D=128), checked at the
    # nano draft's pool (D=64) too.
    pos = positions(1)
    q = randn(n_slots, nq, d)
    args = (q, kq, vq, ks, vs, tables, pos)
    out = TR.ragged_paged_decode_attention_q8(*args)
    torch.cuda.synchronize()
    a5 = compare(out, TA._gather_decode_paged,
                 (q, kq, vq, tables, pos, ks, vs))
    dnq, dnkv, dd = draft_cfg.num_heads, draft_cfg.num_kv_heads, \
        draft_cfg.head_dim
    dk, dv = randn(dnkv, nb, bs, dd), randn(dnkv, nb, bs, dd)
    dkq, dks = quant.quantize_kv_rows(dk)
    dvq, dvs = quant.quantize_kv_rows(dv)
    dq = randn(n_slots, dnq, dd)
    out = TR.ragged_paged_decode_attention_q8(dq, dkq, dvq, dks, dvs, tables,
                                              pos)
    torch.cuda.synchronize()
    a5 = worst(a5, compare(out, TA._gather_decode_paged,
                           (dq, dkq, dvq, tables, pos, dks, dvs)))
    agrees("ragged_decode_q8", a5)
    # K1 at the nano draft's shape (bf16 pool of a 4-slot engine).
    out = TR.ragged_paged_decode_attention(dq, dk, dv, tables, pos)
    torch.cuda.synchronize()
    a1 = compare(out, TA._gather_decode_paged, (dq, dk, dv, tables, pos))
    agrees("ragged_decode", a1, " at the draft shape")
    pos_h = pos.tolist()
    lib = sdpa_inputs(q[:, None], (kq, vq, ks, vs), tables, pos)
    b_ms, b_by = verify_bound(cfg, pos_h, 1, bs, 2 * (d + 4), q.numel() * 2,
                              table_bytes)
    rows.append({
        "name": "ragged_decode_q8", "route": "cuda",
        "source": "distributed_llm_tpu_torch/csrc/ragged_decode_q8.cu",
        "replaces": "distributed_llm_tpu/ops/ragged_attention.py:285",
        "shape": f"B={n_slots} Nq={nq} Nkv={nkv} D={d} bs={bs} MB={mb} "
                 f"NB={nb} pos={pos_h} (checked at the nano draft's "
                 f"Nq={dnq} D={dd} too)",
        **a5, "tol": TOL,
        "ms": time_ms(torch, lambda: TR.ragged_paged_decode_attention_q8(*args),
                      flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_decode_paged(
            q, kq, vq, tables, pos, ks, vs), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            lib[0], lib[1], lib[2], attn_mask=lib[3]), flush=flush),
        "bound_ms": b_ms, "bound_by": b_by})
    del lib, flush_buf, k_pool, v_pool, kq, vq, dk, dv, dkq, dvq
    note_variants(rows, spec_variant_checks(torch, gen))
    torch.cuda.empty_cache()
    return rows, a1


def spec_variant_checks(torch, gen) -> dict:
    """The verify kernels (bf16, int8) at every instantiation they accept
    (head dim 64/128, block 32/64/128, GQA group 1/4/8, G 1..5) and the
    int8 decode kernel (G=1) on small ragged shapes with an idle slot and
    a chunk ending at the table's end; returns the worst ``compare`` per
    kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("ragged_verify", "ragged_verify_q8",
                                "ragged_decode_q8")}

    def note(name, out, plain, *args):
        errs[name] = worst(errs[name], compare(out, plain, args))

    for d in (64, 128):
        for bs in (32, 64, 128):
            for nq, nkv in ((32, 8), (16, 2), (8, 8)):
                b, mb = 4, 12
                nb = b * mb + 1
                kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
                kq, ks = quant.quantize_kv_rows(kp)
                vq, vs = quant.quantize_kv_rows(vp)
                tables = (torch.randperm(nb - 1, generator=gen, device=dev)
                          + 1)[:b * mb].reshape(b, mb).to(torch.int32)
                tables[1] = 0
                for g in range(1, 6):
                    pos = torch.tensor([mb * bs - g, 0, 5, 100],
                                       dtype=torch.int32, device=dev)
                    q = randn(b, g, nq, d)
                    note("ragged_verify",
                         TR.ragged_paged_verify_attention(q, kp, vp, tables,
                                                          pos),
                         TA._gather_verify_paged, q, kp, vp, tables, pos)
                    note("ragged_verify_q8",
                         TR.ragged_paged_verify_attention_q8(
                             q, kq, vq, ks, vs, tables, pos),
                         TA._gather_verify_paged, q, kq, vq, tables, pos, ks,
                         vs)
                    if g == 1:
                        q1 = q[:, 0].contiguous()
                        note("ragged_decode_q8",
                             TR.ragged_paged_decode_attention_q8(
                                 q1, kq, vq, ks, vs, tables, pos),
                             TA._gather_decode_paged, q1, kq, vq, tables, pos,
                             ks, vs)
    return errs


# -- phase 3, continued: the contiguous-cache kernels (sequential engines) ----

def contiguous_cases(nano, orin):
    """K9-K12 at the sequential engines' shapes, (kernel, q8, cfg, cache
    length, window, start, rows): decode at the end of the 8192 cache and
    at 700 in a 1024 cache (D=128 orin, D=64 nano); chunks as the 5-row
    verify at 3000 in an 8192 cache (D=128), a 256-row prefix-hit suffix
    at 768 in a 1024 cache and a long prompt's 2048-row chunk at 2048
    against a 4096 window of an 8192 cache.  The first case of each
    kernel is its row's timed shape (int8 chunks are the nano int8
    tier's, D=64)."""
    dec = [(orin, 8192, 8192, 8191, 1), (orin, 1024, 1024, 700, 1),
           (nano, 8192, 8192, 8191, 1), (nano, 1024, 1024, 700, 1)]
    verify = (orin, 8192, 8192, 3000, 5)
    return {
        "flash_decode": (False, dec),
        "flash_decode_q8": (True, dec),
        "flash_chunk": (False, [verify, (orin, 1024, 1024, 768, 256),
                                (orin, 8192, 4096, 2048, 2048)]),
        "flash_chunk_q8": (True, [(nano, 1024, 1024, 768, 256),
                                  (nano, 8192, 4096, 2048, 2048), verify]),
    }


def contiguous_kernel_phase(torch, nano, orin):
    """K9-K12 against their plain versions at ``contiguous_cases``, each
    timed beside its plain version, one SDPA call on the dequantized,
    GQA-expanded window with the per-row causal mask (timed here only)
    and the card's bound: bytes at 3.35 TB/s (each sequence's own
    frontier+1 cache rows of K and V once, scales included, plus q and
    out) or operations at 989 TFLOP/s.  Then every kernel at its other
    instantiations (``contiguous_variant_checks``)."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    bf = torch.bfloat16
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    wrappers = kernel_wrappers()
    plain = {"flash_decode": TA._decode_contiguous,
             "flash_decode_q8": TA._decode_contiguous_q8,
             "flash_chunk": TA._chunk_contiguous,
             "flash_chunk_q8": TA._chunk_contiguous_q8}
    replaces = {"flash_decode": "pallas_attention.py:877",
                "flash_decode_q8": "pallas_attention.py:994",
                "flash_chunk": "pallas_attention.py:153",
                "flash_chunk_q8": "pallas_attention.py:358"}

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    rows = []
    for name, (q8, cases) in contiguous_cases(nano, orin).items():
        timings, agree = [], NO_ERR
        for cfg, s_max, w, start, s_c in cases:
            nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            k, v = randn(1, s_max, nkv, d), randn(1, s_max, nkv, d)
            cache = ((*quant.quantize_kv_rows(k), *quant.quantize_kv_rows(v))
                     if q8 else (k, None, v, None))
            kc, ks, vc, vs = (None if t is None else t[:, :w] for t in cache)
            window = (kc, vc, ks, vs) if q8 else (kc, vc)
            positions = start + torch.arange(s_c, device=dev, dtype=torch.int32)
            if name.startswith("flash_decode"):
                q, pos = randn(1, nq, d), positions
            else:
                q, pos = randn(1, s_c, nq, d), positions[None]
            args = (q, *window, pos)
            out = wrappers[name](*args)
            torch.cuda.synchronize()
            res = compare(out, plain[name], args)
            agree = worst(agree, res)
            # The bound's resolution: every row's frontier one tile short.
            res["one_tile_short_rel_err"] = row_rel_err(
                plain[name](*widen((*args[:-1], pos - KV_TILE))),
                plain[name](*widen(args)))
            require(res["one_tile_short_rel_err"] > KERNEL_REL_TOL,
                    f"{name}: a missed tile would pass at this shape: {res}")
            kd, vd = ((TA._dequant_cache(kc, vc, ks, vs, bf)) if q8
                      else (kc, vc))
            grp = nq // nkv
            k_l = kd.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            v_l = vd.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            q_l = q.reshape(1, -1, nq, d).permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(w, device=dev)[None, :]
                    <= positions[:, None])[None, None]
            kv_row = nkv * (d + 4) if q8 else nkv * d * 2
            b_ms, b_by = bound(2 * (start + s_c) * kv_row + 2 * q.numel() * 2
                               + positions.numel() * 4,
                               sum(4 * nq * d * (start + r + 1)
                                   for r in range(s_c)))
            timings.append({
                "shape": f"{cfg.name} Nq={nq} Nkv={nkv} D={d} S={s_max} "
                         f"W={w} rows={s_c} start={start}",
                **res,
                "ms": time_ms(torch, lambda: wrappers[name](*args),
                              flush=flush),
                "plain_ms": time_ms(torch, lambda: plain[name](*args),
                                    flush=flush),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_l, k_l, v_l, attn_mask=mask), flush=flush),
                "bound_ms": b_ms, "bound_by": b_by})
            del k, v, cache, kc, vc, ks, vs, window, args, kd, vd, k_l, v_l
        agrees(name, agree)
        first = timings[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{name}.cu",
            "replaces": f"distributed_llm_tpu/ops/{replaces[name]}",
            "shape": first["shape"] + f" (checked at {len(timings)} shapes)",
            **agree, "tol": TOL,
            **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
            "timings": timings})
    del flush_buf
    note_variants(rows, contiguous_variant_checks(torch, gen))
    torch.cuda.empty_cache()
    return rows


def contiguous_variant_checks(torch, gen) -> dict:
    """K9-K12 at every instantiation they accept (head dim 64/128, GQA
    group 1/4/8, B 1-4, chunk rows 1-5 and 64) over a window of a longer
    cache (W=200 of S=300: a batch stride that is not W's, a partial last
    tile), decode positions up to W-1 and chunk rows clamped to a true
    length; returns the worst ``compare`` per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    wrappers = kernel_wrappers()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("flash_decode", "flash_decode_q8",
                                "flash_chunk", "flash_chunk_q8")}

    def note(name, plain, *args):
        errs[name] = worst(errs[name],
                           compare(wrappers[name](*args), plain, args))

    s_max, w = 300, 200
    for d in (64, 128):
        for nq, nkv in ((32, 8), (16, 2), (8, 8)):
            for b in (1, 2, 3, 4):
                k, v = randn(b, s_max, nkv, d), randn(b, s_max, nkv, d)
                kq, ks = quant.quantize_kv_rows(k)
                vq, vs = quant.quantize_kv_rows(v)
                bf_win = (k[:, :w], v[:, :w])
                q8_win = (kq[:, :w], vq[:, :w], ks[:, :w], vs[:, :w])
                pos = torch.tensor([w - 1, 0, 63, 64][:b], dtype=torch.int32,
                                   device=dev)
                q = randn(b, nq, d)
                note("flash_decode", TA._decode_contiguous, q, *bf_win, pos)
                note("flash_decode_q8", TA._decode_contiguous_q8, q, *q8_win,
                     pos)
                for s_c in (1, 2, 3, 4, 5, 64):
                    starts = torch.tensor([0, 37, 130, 136][:b],
                                          device=dev)[:, None]
                    rows = torch.arange(s_c, device=dev)[None]
                    q_pos = torch.minimum(starts + rows, starts + max(1, s_c - 2)
                                          ).to(torch.int32)
                    qc = randn(b, s_c, nq, d)
                    note("flash_chunk", TA._chunk_contiguous, qc, *bf_win,
                         q_pos)
                    note("flash_chunk_q8", TA._chunk_contiguous_q8, qc,
                         *q8_win, q_pos)
    return errs


# -- phase 3, continued: the dense windowed tick's paged decode kernels ------

def paged_decode_cases(nano, orin):
    """K7 and K8 at the dense tick's shapes, (kernel, cfg, slots,
    positions, window blocks of 64): K7 at the nano tier's 8 slots in a
    2048 window (timed) and at K1's timed shape, the full 8192 table (for
    a direct comparison with K1); K8 at the orin tier's 4 slots in a 2048
    window.  Slot 0 is idle (its whole row on the trash block)."""
    return {
        "paged_decode": [
            (nano, 8, [0, 40, 200, 700, 1500, 1900, 1100, 2047], 32),
            (nano, 8, [0, 40, 200, 700, 1500, 3000, 5000, 8191], 128)],
        "paged_decode_q8": [(orin, 4, [0, 100, 700, 1900], 32)],
    }


def paged_decode_kernel_phase(torch, nano, orin, bs: int = 64):
    """K7 (bf16 pool) and K8 (int8 pool) at ``paged_decode_cases``, each
    window a column slice of a full [B, 128] table (the kernel reads it
    through its row stride, as the engine passes it): every output row
    within KERNEL_REL_TOL of the plain version in float32, the plain
    version with every frontier one 64-position tile short outside it,
    then timed beside the plain version, one SDPA call on the gathered
    (dequantized), GQA-expanded window with the per-slot mask (timed here
    only) and the byte bound at 3.35 TB/s.  Then both kernels at their
    other instantiations (``paged_decode_variant_checks``)."""
    import torch.nn.functional as F

    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf = torch.bfloat16
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    wrappers = kernel_wrappers()

    def flush():
        flush_buf.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(bf)

    rows = []
    for name, cases in paged_decode_cases(nano, orin).items():
        q8 = name.endswith("_q8")
        timings, agree = [], NO_ERR
        for cfg, b, pos_h, wb in cases:
            nq, nkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            mb = -(-cfg.max_seq_len // bs)
            nb = b * mb + 1
            k_pool, v_pool = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
            if q8:
                kq, ks = quant.quantize_kv_rows(k_pool)
                vq, vs = quant.quantize_kv_rows(v_pool)
                pool = (kq, vq, ks, vs)
            else:
                pool = (k_pool, v_pool)
            full = (torch.randperm(nb - 1, generator=gen, device=dev)[:b * mb]
                    + 1).reshape(b, mb).to(torch.int32)
            full[0] = 0
            window = full[:, :wb]
            pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
            q = randn(b, nq, d)
            args = (q, *pool, window, pos)
            out = wrappers[name](*args)
            torch.cuda.synchronize()
            plain_args = (q, pool[0], pool[1], window, pos, *pool[2:])
            res = compare(out, TA._gather_decode_windowed, plain_args)
            agree = worst(agree, res)
            short = (q, pool[0], pool[1], window, pos - KV_TILE, *pool[2:])
            res["one_tile_short_rel_err"] = row_rel_err(
                TA._gather_decode_windowed(*widen(short)),
                TA._gather_decode_windowed(*widen(plain_args)))
            require(res["one_tile_short_rel_err"] > KERNEL_REL_TOL,
                    f"{name}: a missed tile would pass at this shape: {res}")
            k_seq, v_seq = TA._gather_pool_seq(pool[0], pool[1], window,
                                               *pool[2:], dtype=bf)
            grp = nq // nkv
            k_l = k_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            v_l = v_seq.permute(0, 2, 1, 3).repeat_interleave(grp, 1).contiguous()
            mask = (torch.arange(wb * bs, device=dev)[None, :]
                    <= pos[:, None])[:, None, None, :]
            q_l = q[:, :, None, :]
            kv_bytes = 2 * (d + 4) if q8 else 2 * d * 2
            blocks = sum(p // bs + 1 for p in pos_h)
            b_ms, b_by = bound(blocks * nkv * bs * kv_bytes + 2 * q.numel() * 2
                               + window.numel() * 4 + pos.numel() * 4,
                               sum(4 * nq * d * (p + 1) for p in pos_h))
            timings.append({
                "shape": f"{cfg.name} B={b} Nq={nq} Nkv={nkv} D={d} bs={bs} "
                         f"window={wb * bs} (table stride {mb}) NB={nb} "
                         f"pos={pos_h}",
                **res,
                "ms": time_ms(torch, lambda: wrappers[name](*args),
                              flush=flush),
                "plain_ms": time_ms(torch, lambda: TA._gather_decode_windowed(
                    *plain_args), flush=flush),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_l, k_l, v_l, attn_mask=mask), flush=flush),
                "bound_ms": b_ms, "bound_by": b_by})
            del k_pool, v_pool, pool, args, plain_args, short, k_seq, v_seq, \
                k_l, v_l
        agrees(name, agree)
        first = timings[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"distributed_llm_tpu_torch/csrc/{name}.cu",
            "replaces": ("distributed_llm_tpu/ops/pallas_attention.py:"
                         + ("776" if q8 else "673")),
            "shape": first["shape"] + f" (checked at {len(timings)} shapes)",
            **agree, "tol": TOL,
            **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
            "timings": timings})
    del flush_buf
    note_variants(rows, paged_decode_variant_checks(torch, gen))
    torch.cuda.empty_cache()
    return rows


def paged_decode_variant_checks(torch, gen) -> dict:
    """K7 and K8 at every instantiation they take (head dim 64/128, block
    32/64/128, GQA group 1/4/8) on small windows (1-3 of 12 table columns,
    read through the row stride): an idle slot, position 0, mid-block and
    the window's last position; returns the worst ``compare`` per
    kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant

    dev = torch.device("cuda")
    wrappers = kernel_wrappers()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    errs = {n: NO_ERR for n in ("paged_decode", "paged_decode_q8")}
    for d in (64, 128):
        for bs in (32, 64, 128):
            for nq, nkv in ((32, 8), (16, 2), (8, 8)):
                b, mb = 4, 12
                nb = b * mb + 1
                kp, vp = randn(nkv, nb, bs, d), randn(nkv, nb, bs, d)
                kq, ks = quant.quantize_kv_rows(kp)
                vq, vs = quant.quantize_kv_rows(vp)
                full = (torch.randperm(nb - 1, generator=gen, device=dev)
                        + 1)[:b * mb].reshape(b, mb).to(torch.int32)
                full[0] = 0
                q = randn(b, nq, d)
                for wb in (1, 2, 3):
                    window = full[:, :wb]
                    pos = torch.tensor([0, 0, (wb - 1) * bs + bs // 2,
                                        wb * bs - 1], dtype=torch.int32,
                                       device=dev)
                    for name, pool in (("paged_decode", (kp, vp)),
                                       ("paged_decode_q8", (kq, vq, ks, vs))):
                        out = wrappers[name](q, *pool, window, pos)
                        errs[name] = worst(errs[name], compare(
                            out, TA._gather_decode_windowed,
                            (q, pool[0], pool[1], window, pos, *pool[2:])))
    return errs


# -- phases 4-6: serve ------------------------------------------------------------

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


def kernel_wrappers():
    """Every kernel's wrapper, by the kernel's name (its source's stem)."""
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR
    return {"ragged_decode": TR.ragged_paged_decode_attention,
            "flash_causal": TF.flash_causal_attention,
            "paged_chunk": TF.paged_chunk_attention,
            "paged_decode": TF.paged_decode_attention,
            "paged_decode_q8": TF.paged_decode_attention_q8,
            "ragged_verify": TR.ragged_paged_verify_attention,
            "ragged_decode_q8": TR.ragged_paged_decode_attention_q8,
            "ragged_verify_q8": TR.ragged_paged_verify_attention_q8,
            "flash_decode": TF.flash_decode_attention,
            "flash_decode_q8": TF.flash_decode_attention_q8,
            "flash_chunk": TF.flash_chunk_attention,
            "flash_chunk_q8": TF.flash_chunk_attention_q8}


def plain_versions():
    """The plain version of every kernel (none may run on a main path)."""
    from distributed_llm_tpu_torch.ops import attention as TA
    return (TA.causal_attention, TA._gather_decode_paged,
            TA._gather_decode_windowed,
            TA._gather_verify_paged, TA._gather_chunk_paged,
            TA._decode_contiguous, TA._decode_contiguous_q8,
            TA._chunk_contiguous, TA._chunk_contiguous_q8)


@contextlib.contextmanager
def http_served(app):
    """``app`` behind a threaded WSGI server on 127.0.0.1: yields its base
    URL, then shuts the server down."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from distributed_llm_tpu_torch.utils.webapp import _ThreadingWSGIServer

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):       # no per-request access log
            pass

    server = make_server("127.0.0.1", 0, app, server_class=_ThreadingWSGIServer,
                         handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def fresh_peak(torch, on_card: bool) -> None:
    """Collect the previous phase's engines, so the peak-memory count that
    follows is this phase's."""
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


@contextlib.contextmanager
def served(torch, tier, device: str = "cuda"):
    """``tier`` built and warmed under EngineManager (startup timed) behind
    its /query app on 127.0.0.1: yields (engine, base URL, startup
    seconds), then stops the server and the engine."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app

    fresh_peak(torch, device == "cuda")
    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, device=device)
    manager.start_server()                   # build + warm (one request)
    startup_s = time.perf_counter() - t0
    try:
        with http_served(create_tier_app(tier.name, manager=manager)) as base:
            yield manager.engine(), base, startup_s
    finally:
        manager.stop_server()


def reset_counts() -> None:
    """Every kernel's launch count and every plain version's call count
    (the int8 suffix chunk's too) set to 0, just before a main path."""
    from distributed_llm_tpu_torch.ops import attention as TA
    for fn in kernel_wrappers().values():
        fn.launches = 0
    for fn in plain_versions() + (TA._dequant_chunk_paged,):
        fn.calls = 0


def read_counts(expect, on_card: bool):
    """(launches by kernel, calls by plain version) since ``reset_counts``:
    every kernel in ``expect`` must have launched and, on the card, no
    plain version may have run."""
    launches = {name: fn.launches for name, fn in kernel_wrappers().items()}
    plain_calls = {fn.__name__: fn.calls for fn in plain_versions()}
    require(all(launches[name] > 0 for name in expect),
            f"a kernel did not run on the main path: {launches}")
    require(not on_card or not any(plain_calls.values()),
            f"plain attention ran on the main path: {plain_calls}")
    return launches, plain_calls


def drive(base: str, *, long_words: int, lengths, hits=None,
          repeat: bool = False) -> dict:
    """The main path's requests over HTTP: /health, a cold prompt (with
    ``repeat``, twice: greedy must repeat itself), a prompt of
    ``long_words`` words, a multi-turn follow-up of the first (``hits()``,
    where given, must grow across it: the parked prefix was reused),
    ``len(lengths)`` concurrent requests of skewed length and one stream.
    Returns the replies, the burst's wall time and the request count."""
    with urllib.request.urlopen(base + "/health", timeout=30) as resp:
        require(resp.status == 200 and json.loads(resp.read())["ok"],
                "/health not ok")
    turn1 = [{"role": "user", "content": "tell me about " + words(12)}]
    first = query(base, turn1)
    if repeat:
        again = query(base, turn1)
        require(first["response"] == again["response"],
                "the same greedy prompt gave two different replies")
    long_reply = query(base, "summarise: " + words(long_words, 3))
    hits0 = hits() if hits else 0
    turn2 = turn1 + [{"role": "assistant", "content": first["response"]},
                     {"role": "user", "content": "and " + words(6, 5) + "?"}]
    query(base, turn2)
    require(hits is None or hits() > hits0,
            "the follow-up did not reuse the parked prefix")
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
    status, text = post(base + "/query/stream",
                        {"query": "stream about " + words(10, 7),
                         "num_predict": SERVE_MAX_NEW})
    events = [json.loads(line[6:]) for line in text.split("\n")
              if line.startswith("data: ")]
    require(status == 200 and events and events[-1].get("done")
            and events[-1]["tokens"] > 0
            and "".join(e.get("delta", "") for e in events).strip(),
            f"/query/stream failed: {text[:500]}")
    return {"first": first, "long": long_reply, "burst": results,
            "burst_s": burst_s, "requests": 4 + int(repeat) + len(lengths)}


def serve_numbers(tier, engine, startup_s: float, main_s: float, drove: dict,
                  launches: dict, plain_calls: dict) -> dict:
    """What every serve phase reports of its main path."""
    results, n = drove["burst"], drove["requests"]
    gen_tokens = sum(r["stats"]["gen_tokens"] for r in results)
    ttfts = [r["stats"]["ttft_ms"] for r in results]
    decode_tps = [(r["stats"]["gen_tokens"] - 1) * 1e3
                  / (r["stats"]["total_ms"] - r["stats"]["ttft_ms"])
                  for r in results if r["stats"]["gen_tokens"] > 1]
    return {
        "tier": tier.name, "model": tier.model_preset,
        "engine": type(engine).__name__, "kv_quantize": tier.kv_quantize,
        "startup_s": startup_s, "main_path_s": main_s,
        "requests": n, "launches": launches, "plain_calls": plain_calls,
        "launches_per_request": {k: v / n for k, v in launches.items() if v},
        "concurrent": {"requests": len(results), "wall_s": drove["burst_s"],
                       "gen_tokens": gen_tokens,
                       "tokens_per_s": gen_tokens / drove["burst_s"],
                       "decode_tokens_per_s": decode_tps,
                       "p50_ttft_ms": statistics.median(ttfts),
                       "ttft_ms": ttfts,
                       "prompt_tokens": [r["stats"]["prompt_tokens"]
                                         for r in results]},
        "cold_ttft_ms": drove["first"]["stats"]["ttft_ms"],
        "chunked_ttft_ms": drove["long"]["stats"]["ttft_ms"],
        "long_prompt_tokens": drove["long"]["stats"]["prompt_tokens"],
    }


def peak_memory_gb(torch, on_card: bool):
    return torch.cuda.max_memory_allocated() / 1e9 if on_card else None


def serve_phase(torch, tier, *, lengths, expect, repeat=False, sampled=False,
                device: str = "cuda"):
    """Serve a batched tier over HTTP (``drive``: the long prompt is past
    one 256-token chunk, the follow-up hits the parked blocks) and, with
    ``sampled``, one request at temperature 0.8.  Every kernel in
    ``expect`` must launch and no plain version may run; with speculation
    on, drafts must have been made.  Then the numerics checks on the live
    pool and the decode step's breakdown.  Returns (serve numbers,
    launches by kernel)."""
    from distributed_llm_tpu_torch.ops import attention as TA

    on_card = device == "cuda"
    with served(torch, tier, device) as (engine, base, startup_s):
        reset_counts()
        spec0 = engine.spec_stats()
        t_main = time.perf_counter()
        drove = drive(base, long_words=420, lengths=lengths, repeat=repeat,
                      hits=lambda: engine.prefix_cache.stats()["hits_shared"])
        require(drove["long"]["stats"]["prompt_tokens"] > 256,
                f"long prompt only {drove['long']['stats']['prompt_tokens']} "
                f"tokens")
        if sampled:
            # A sampled request rides γ=0 beside the greedy slots.
            query(base, "imagine " + words(8, 2), temperature=0.8)
            drove["requests"] += 1
        main_s = time.perf_counter() - t_main
        launches, plain_calls = read_counts(expect, on_card)
        int8_chunk_calls = TA._dequant_chunk_paged.calls
        spec = engine.spec_stats()
        drafted = spec["drafted_total"] - spec0["drafted_total"]
        accepted = spec["accepted_total"] - spec0["accepted_total"]
        if engine.spec:
            require(drafted > 0, f"speculation drafted nothing: {spec}")
        serve = serve_numbers(tier, engine, startup_s, main_s, drove, launches,
                              plain_calls)
        serve.update({
            "draft": tier.draft_preset if engine.spec else None,
            "int8_chunk_calls": int8_chunk_calls,
            "tick_stats": engine.tick_stats(),
            "spec": ({"drafted": drafted, "accepted": accepted,
                      "accept_ratio": accepted / drafted if drafted else None,
                      "slot_gammas_at_end": spec["slot_gammas"]}
                     if engine.spec else None),
            "decode_logits_check": logits_check(torch, engine),
            "verify_check": verify_check(torch, engine) if engine.spec else None,
            "decode_step": paged_step_breakdown(torch, engine) if on_card else None,
            "peak_memory_gb": peak_memory_gb(torch, on_card)})
        return serve, launches


def _live_decode_state(torch, engine, spare=()):
    """Every slot continuing the longest parked conversation by one token:
    (tables, pos, cur, length) for decode_step_paged on the live pool;
    ``spare`` blocks follow the parked ones in every table row."""
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    blocks = list(entry.cache["blocks"]) + list(spare)
    n = len(entry.ids)
    b = engine.paged.max_slots
    tables = torch.zeros((b, engine.paged.blocks_per_slot), dtype=torch.int32)
    tables[:, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
    pos = torch.full((b,), n - 1, dtype=torch.int32)
    cur = torch.full((b,), entry.ids[-1], dtype=torch.long)
    return (tables.to(engine.device), pos.to(engine.device),
            cur.to(engine.device), n)


def step_breakdown(torch, step, attn, layers: int) -> dict:
    """Where one decode step's time goes: ``step()``'s eager wall time
    (enqueue and run, then synchronize) against the same step captured
    once as a CUDA graph and replayed, which is its device time with no
    host launch gaps (their ratio is the device's idle share in eager
    mode); and the attention kernel's part, ``attn()`` (one layer's
    launch) times ``layers``."""
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
    attn_ms = layers * time_ms(torch, attn)
    del graph
    return {"wall_ms": wall_ms, "graph_ms": graph_ms, "attention_ms": attn_ms,
            "device_idle_share": max(0.0, 1.0 - graph_ms / wall_ms)}


def paged_step_breakdown(torch, engine) -> dict:
    """``step_breakdown`` of one batched decode step on a copy of the live
    pool, every slot at the longest parked conversation's end; the
    attention is the ragged decode kernel."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged
    from distributed_llm_tpu_torch.models.transformer import layer_scales
    from distributed_llm_tpu_torch.ops import attention as TA

    tables, pos, cur, n = _live_decode_state(torch, engine)
    pool = {k: v.clone() for k, v in engine.pool.items()}
    cfg = engine.cfg
    q = torch.randn((engine.paged.max_slots, cfg.num_heads, cfg.head_dim),
                    device=engine.device).to(engine.model.embed.dtype)
    res = step_breakdown(
        torch, lambda: decode_step_paged(cfg, engine.model, cur, pos, pool,
                                         tables),
        lambda: TA.ragged_decode(q, pool["k"][0], pool["v"][0], tables, pos,
                                 *layer_scales(pool, 0)), cfg.num_layers)
    del pool
    return {"slots": engine.paged.max_slots, "position": n - 1, **res}


def seq_step_breakdown(torch, engine) -> dict:
    """``step_breakdown`` of one B=1 decode step on a copy of the live
    cache of the longest parked conversation (the long prompt's); the
    attention is the contiguous decode kernel."""
    from distributed_llm_tpu_torch.models import transformer as TT
    from distributed_llm_tpu_torch.ops import attention as TA

    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    n = len(entry.ids)
    cache = {k: v.clone() for k, v in entry.cache.items()}
    cur = torch.tensor([entry.ids[-1]], device=engine.device)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=engine.device)
    cfg = engine.cfg
    q = torch.randn((1, cfg.num_heads, cfg.head_dim), device=engine.device
                    ).to(engine.model.embed.dtype)
    res = step_breakdown(
        torch, lambda: TT.decode_step(cfg, engine.model, cur, pos, cache),
        lambda: TA.decode(q, cache["k"][0], cache["v"][0], pos,
                          *TT.layer_scales(cache, 0)), cfg.num_layers)
    del cache
    return {"position": n - 1, "cache_len": int(entry.cache["k"].shape[2]),
            **res}


# -- numerics on live state ----------------------------------------------------

@contextlib.contextmanager
def plain_attention(float32: bool = False):
    """The model's attention dispatchers (``attention.decode``, ``chunk``,
    ``ragged_decode`` and ``ragged_verify``) swapped for the kernels'
    plain versions, run on float32-widened inputs when asked (the output
    cast back to q's dtype): for the numerics checks only, after a main
    path's counts were read."""
    from distributed_llm_tpu_torch.ops import attention as TA

    def run(plain, q, *args):
        return plain(*(widen((q, *args)) if float32 else (q, *args))
                     ).to(q.dtype)

    def decode(q, k, v, pos, ks=None, vs=None):
        return (run(TA._decode_contiguous, q, k, v, pos) if ks is None
                else run(TA._decode_contiguous_q8, q, k, v, ks, vs, pos))

    def chunk(q, k, v, q_pos, ks=None, vs=None):
        return (run(TA._chunk_contiguous, q, k, v, q_pos) if ks is None
                else run(TA._chunk_contiguous_q8, q, k, v, ks, vs, q_pos))

    def ragged_decode(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_decode_paged, q, k, v, tables, pos, ks, vs)

    def paged_decode(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_decode_windowed, q, k, v, tables, pos, ks, vs)

    def ragged_verify(q, k, v, tables, pos, ks=None, vs=None):
        return run(TA._gather_verify_paged, q, k, v, tables, pos, ks, vs)

    swapped = {"decode": decode, "chunk": chunk,
               "ragged_decode": ragged_decode, "paged_decode": paged_decode,
               "ragged_verify": ragged_verify}
    saved = {name: getattr(TA, name) for name in swapped}
    for name, fn in swapped.items():
        setattr(TA, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(TA, name, fn)


def three_ways(fn, state: dict):
    """``fn(copy)`` on its own copy of ``state`` (a KV cache or pool) with
    the kernels, with the plain attention and with the plain attention in
    float32."""
    out = []
    for ctx in (contextlib.nullcontext(), plain_attention(),
                plain_attention(float32=True)):
        copy = {k: v.clone() for k, v in state.items()}
        with ctx:
            out.append(fn(copy))
        del copy
    return out


def check_three(res: dict, kernel, plain, ref, also=()) -> dict:
    """``res`` with the logits of the kernels against the plain attention
    and against it in float32, each within LOGITS_RTOL of the logits'
    scale above the model's rounding floor (how far the plain attention
    in bf16 lands from the same in float32); so must be every key of
    ``res`` named in ``also``."""
    scale = ref.abs().max().item()
    floor = (plain - ref).abs().max().item()
    res.update({"kernel_vs_plain_max_abs_err": (kernel - plain).abs().max().item(),
                "kernel_vs_float32_max_abs_err": (kernel - ref).abs().max().item(),
                "plain_vs_float32_max_abs_err": floor,
                "logits_max_abs": scale, "tol": LOGITS_RTOL * scale + floor})
    for key in ("kernel_vs_plain_max_abs_err",
                "kernel_vs_float32_max_abs_err", *also):
        require(res[key] <= res["tol"], f"logits disagree ({key}): {res}")
    return res


def logits_check(torch, engine) -> dict:
    """Decode-step logits on the live pool: the parked prefix of the
    served conversation, continued by one token, ``three_ways``."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, _ = _live_decode_state(torch, engine)
    kernel, plain, ref = three_ways(lambda pool: decode_step_paged(
        engine.cfg, engine.model, cur, pos, pool, tables)[0], engine.pool)
    return check_three({}, kernel, plain, ref)


def verify_check(torch, engine) -> dict:
    """The verify step on the live pool at the top γ bucket (G rows),
    ``three_ways``, its kernel logits also against G sequential greedy
    decode steps from the same state (two spare blocks after the parked
    ones hold the new rows)."""
    from distributed_llm_tpu_torch.engine.paged_kv import (decode_step_paged,
                                                           verify_step_paged)

    g = engine.spec_gamma_max + 1
    spare = engine.allocator.alloc(2)
    require(spare is not None, "no spare blocks for the verify check")
    try:
        tables, pos, cur, _ = _live_decode_state(torch, engine, spare)
        cfg, model = engine.cfg, engine.model
        pool = {k: v.clone() for k, v in engine.pool.items()}
        seq, toks, p = [], [cur], pos
        for _ in range(g):
            logits = decode_step_paged(cfg, model, toks[-1], p, pool, tables)
            seq.append(logits)
            toks.append(logits.argmax(dim=-1))
            p = p + 1
        seq = torch.stack(seq, dim=1)                       # [B, G, V]
        del pool
        chunk = torch.stack(toks[:g], dim=1)                # [B, G]
        kernel, plain, ref = three_ways(lambda pool: verify_step_paged(
            cfg, model, chunk, pos, pool, tables), engine.pool)
    finally:
        engine.allocator.free(spare)
    return check_three(
        {"rows": g,
         "verify_vs_sequential_max_abs_err": (kernel - seq).abs().max().item(),
         "argmax_agree": (kernel.argmax(-1) == seq.argmax(-1)).float()
         .mean().item()},
        kernel, plain, ref, also=("verify_vs_sequential_max_abs_err",))


def seq_logits_check(torch, engine) -> dict:
    """Decode-step logits on a live cache: the long prompt served again
    (and parked), continued by one token, ``three_ways``."""
    from distributed_llm_tpu_torch.models import transformer as TT

    engine.generate("summarise: " + words(LONG_WORDS, 3), max_new_tokens=2)
    entry = max(engine.prefix_cache._entries, key=lambda e: len(e.ids))
    n = len(entry.ids)
    cur = torch.tensor([entry.ids[-1]], device=engine.device)
    pos = torch.tensor([n - 1], dtype=torch.int32, device=engine.device)
    kernel, plain, ref = three_ways(lambda c: TT.decode_step(
        engine.cfg, engine.model, cur, pos, c)[0], entry.cache)
    return check_three({"position": n - 1,
                        "cache_len": int(entry.cache["k"].shape[2])},
                       kernel, plain, ref)


def seq_verify_check(torch, engine) -> dict:
    """The target's γ+1-row ``decode_chunk`` on a live prefill (a
    675-token prompt), ``three_ways``, its kernel logits also against γ+1
    sequential greedy ``decode_step``s from the same state."""
    from distributed_llm_tpu_torch.engine.speculative import decode_chunk
    from distributed_llm_tpu_torch.models import transformer as TT

    first, cache, _, _, n, _, _, _ = engine._prepare_and_prefill(
        "summarise: " + words(300, 3), SERVE_MAX_NEW)
    g = engine.gamma + 1
    seq_cache = {k: v.clone() for k, v in cache.items()}
    toks = [torch.tensor([first], device=engine.device)]
    seq = []
    for i in range(g):
        pos = torch.tensor([n + i], dtype=torch.int32, device=engine.device)
        seq.append(TT.decode_step(engine.cfg_t, engine.model_t, toks[-1], pos,
                                  seq_cache)[0])
        toks.append(seq[-1].argmax(-1)[None])
    seq = torch.stack(seq)                                   # [G, V]
    del seq_cache
    chunk = torch.cat(toks[:g])[None]                        # [1, G]
    start = torch.tensor([n], dtype=torch.int32, device=engine.device)
    kernel, plain, ref = three_ways(lambda c: decode_chunk(
        engine.cfg_t, engine.model_t, chunk, start, c)[0], cache)
    return check_three(
        {"rows": g, "position": n,
         "verify_vs_sequential_max_abs_err": (kernel - seq).abs().max().item(),
         "argmax_agree": (kernel.argmax(-1) == seq.argmax(-1)).float()
         .mean().item()},
        kernel, plain, ref, also=("verify_vs_sequential_max_abs_err",))


# -- phases 7-9: serve the sequential engines ---------------------------------------

LONG_WORDS = 1000            # about 2250 tokens: past the 2048 bucket


def post_status(url: str, body: dict):
    """(status, text) of a POST, error statuses included."""
    try:
        return post(url, body)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode("utf-8")


def serve_sequential_phase(torch, tier, *, expect, device: str = "cuda"):
    """Serve a ``decode_batch=1`` tier over HTTP (the sequential
    InferenceEngine, or SpeculativeEngine with a draft): ``drive`` with
    a long prompt past the 2048 bucket (chunk stride; the speculative
    engine cuts it to the bucket, as the JAX one does) and 3 concurrent
    requests (serialized by the app), then one request at temperature
    0.8 (200 on the plain engine; the speculative engine answers the JAX
    package's 500 on /query and 501 on /query/stream).  Every kernel in
    ``expect`` must launch and no plain version may run.  Then the
    numerics checks on live caches and, for the plain engine on the
    card, the decode step's breakdown.  Returns (serve numbers, launches
    by kernel)."""
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine

    on_card = device == "cuda"
    with served(torch, tier, device) as (engine, base, startup_s):
        spec = isinstance(engine, SpeculativeEngine)
        reset_counts()
        t_main = time.perf_counter()
        drove = drive(base, long_words=LONG_WORDS, lengths=(4, 60, 150),
                      hits=None if spec else
                      (lambda: engine.prefix_cache.stats()["hits"]))
        n_long = drove["long"]["stats"]["prompt_tokens"]
        top = max(tier.prefill_buckets)
        require(n_long == top if spec else n_long > top,
                f"long prompt served at {n_long} tokens")
        sampled = {"query": "imagine " + words(8, 2), "temperature": 0.8,
                   "num_predict": SERVE_MAX_NEW}
        if spec:
            got = (post_status(base + "/query", sampled)[0],
                   post_status(base + "/query/stream", sampled)[0])
            require(got == (500, 501), f"sampled request on the speculative "
                    f"tier answered {got}, not the JAX package's (500, 501)")
        else:
            query(base, sampled["query"], temperature=0.8)
            drove["requests"] += 1
        main_s = time.perf_counter() - t_main
        launches, plain_calls = read_counts(expect, on_card)
        serve = serve_numbers(tier, engine, startup_s, main_s, drove, launches,
                              plain_calls)
        serve.update({
            "draft": tier.draft_preset if spec else None,
            "spec": ({"rounds": len(engine.accept_history),
                      "acceptance_rate": engine.acceptance_rate}
                     if spec else None),
            "decode_logits_check": None if spec else seq_logits_check(torch,
                                                                      engine),
            "verify_check": seq_verify_check(torch, engine) if spec else None,
            "decode_step": (seq_step_breakdown(torch, engine)
                            if on_card and not spec else None),
            "peak_memory_gb": peak_memory_gb(torch, on_card)})
        return serve, launches


# -- phase 10: the two-tier /chat service ---------------------------------------

# A few general_knowledge queries of the JAX package's bench query sets
# (copied here: the port reads nothing of that package), and two long or
# code prompts.
CHAT_QUERIES = [
    "What is the capital of Japan?",
    "How many continents are there?",
    "Name the largest ocean on Earth.",
    "What year did the first person walk on the moon?",
    "What is photosynthesis?",
    "Define the word 'ephemeral'.",
    "Explain in detail how plate tectonics drives earthquakes, volcanic "
    "arcs, and mountain building, and compare the mechanisms at divergent, "
    "convergent, and transform boundaries with concrete examples of each.",
    "Implement a thread-safe LRU cache in Python with O(1) get and put:\n"
    "```python\nclass LRUCache:\n    def __init__(self, capacity: int):\n"
    "        ...\n```\nthen analyze its time and space complexity and "
    "debug the race condition in this version:\nif key in self.map: "
    "self.map[key] = value; self.order.remove(key)",
]
STRATEGIES = ("token", "semantic", "heuristic", "hybrid", "perf")
CHAT_KEYS = {"reply", "device", "reasoning", "method", "confidence",
             "cache_hit", "tokens"}


CHAT_MAX_NEW = 64


def chat_cluster(nano, orin):
    """The /chat phase's tiers: nano at its default 8 slots and orin at 4
    (``tp=1``, int8 KV), both on the dense windowed tick, with a decode
    cap of CHAT_MAX_NEW tokens (random weights rarely stop at EOS; a
    follow-up's suffix, the reply plus the new turn, then fits the
    prefix-reuse buckets)."""
    from distributed_llm_tpu_torch.config import ClusterConfig
    return ClusterConfig(
        nano=dataclasses.replace(nano, attention_ragged=False,
                                 max_new_tokens=CHAT_MAX_NEW),
        orin=dataclasses.replace(orin, tp=1, attention_ragged=False,
                                 kv_quantize="int8",
                                 max_new_tokens=CHAT_MAX_NEW))


def chat_post(base: str, path: str, body: dict) -> dict:
    status, text = post(base + path, body)
    require(status == 200, f"{path} returned {status}: {text[:300]}")
    return json.loads(text)


def chat_stream(base: str, body: dict) -> dict:
    """One /chat/stream request read as it arrives: the meta event, the
    client-side time to the first delta, and the done event."""
    req = urllib.request.Request(base + "/chat/stream",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    meta, ttft_ms, text, done = None, None, "", None
    with urllib.request.urlopen(req, timeout=600) as resp:
        require(resp.status == 200, f"/chat/stream returned {resp.status}")
        for raw in resp:
            line = raw.decode("utf-8").strip()
            if not line.startswith("data: "):
                continue
            event = json.loads(line[6:])
            require("error" not in event, f"/chat/stream failed: {event}")
            if event.get("meta"):
                meta = event
            elif "delta" in event:
                if ttft_ms is None:
                    ttft_ms = (time.perf_counter() - t0) * 1e3
                text += event["delta"]
            elif event.get("done"):
                done = event
    require(meta is not None and done is not None and done["tokens"] > 0
            and text.strip(), f"/chat/stream incomplete: {meta} {done}")
    return {"meta": meta, "ttft_ms": ttft_ms, "done": done}


def drive_chat(base: str, strategy: str, burst: int, streams: int) -> dict:
    """One strategy's traffic: ``burst`` concurrent /chat requests (each
    its own session), a repeated query (a response-cache hit), two
    follow-up turns (a nano one and a code one, each first turn made
    unique so the response cache cannot answer it: prefix hits on both
    tiers) and ``streams`` /chat/stream requests."""
    results = [None] * burst

    def worker(i):
        results[i] = chat_post(base, "/chat", {
            "message": CHAT_QUERIES[i % len(CHAT_QUERIES)],
            "strategy": strategy, "session_id": f"{strategy}-burst-{i}"})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(burst)]
    t_burst = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    burst_s = time.perf_counter() - t_burst
    require(all(r is not None for r in results),
            "a concurrent /chat request did not complete")
    replies = list(results)
    again = chat_post(base, "/chat", {"message": CHAT_QUERIES[0],
                                      "strategy": strategy,
                                      "session_id": f"{strategy}-again"})
    require(again["cache_hit"] is True,
            f"the repeated query missed the response cache: {again}")
    replies.append(again)
    for k, (first, follow) in enumerate((
            (CHAT_QUERIES[1], "And how many oceans?"),
            (CHAT_QUERIES[-1], "Now write unit tests for it and analyze "
                               "the time complexity of each test."))):
        session = f"{strategy}-follow-{k}"
        for message in (f"{first} ({strategy})", follow):
            replies.append(chat_post(base, "/chat", {
                "message": message, "strategy": strategy,
                "session_id": session}))
    for r in replies:
        require(set(r) == CHAT_KEYS and r["device"] in ("nano", "orin"),
                f"/chat broke the contract: {r}")
    streamed = [chat_stream(base, {
        "message": CHAT_QUERIES[(i * 6) % len(CHAT_QUERIES)],
        "strategy": strategy, "session_id": f"{strategy}-stream-{i}"})
        for i in range(streams)]
    devices = [r["device"] for r in replies] + [s["meta"]["device"]
                                                for s in streamed]
    ttfts = [s["ttft_ms"] for s in streamed]
    return {"requests": len(replies) + streams,
            "burst_requests": burst, "burst_s": burst_s,
            "burst_req_per_s": burst / burst_s,
            "p50_stream_ttft_ms": statistics.median(ttfts),
            "stream_ttft_ms": ttfts,
            "nano": devices.count("nano"), "orin": devices.count("orin"),
            "p50_routing_overhead_ms": statistics.median(
                s["meta"]["routing_overhead_ms"] for s in streamed),
            "methods": sorted({r["method"] for r in replies}),
            "cache_hits": sum(1 for r in replies if r["cache_hit"])}


def routing_device_check(device: str) -> dict:
    """The routing layer's device path in the production config's hybrid
    space (the trained encoder with the hashed n-grams): embeddings of
    the chat queries on ``device`` against the same on the CPU (max abs
    within 1e-4: another float32 summation order), and every strategy's
    decision on ``device`` equal to the CPU's."""
    import numpy as np

    from distributed_llm_tpu_torch.config import PRODUCTION_CFG
    from distributed_llm_tpu_torch.routing.embedder import get_embedder
    from distributed_llm_tpu_torch.routing.strategies import (
        AVAILABLE_STRATEGIES)

    name = PRODUCTION_CFG["embedding_model"]
    err = float(np.abs(get_embedder(name, device).encode(CHAT_QUERIES)
                       - get_embedder(name, "cpu").encode(CHAT_QUERIES)).max())
    require(err <= 1e-4, f"the {name} embedding on {device} is off by {err}")
    decisions = {}
    for strategy, cls in AVAILABLE_STRATEGIES.items():
        embeds = strategy in ("semantic", "hybrid")
        got = [cls(dict(PRODUCTION_CFG), **({"device": device} if embeds
                                            else {})).route(q)
               for q in CHAT_QUERIES]
        want = [cls(dict(PRODUCTION_CFG), **({"device": "cpu"} if embeds
                                             else {})).route(q)
                for q in CHAT_QUERIES]
        require([(d.device, d.method) for d in got]
                == [(d.device, d.method) for d in want],
                f"{strategy} decides otherwise on {device}")
        decisions[strategy] = [d.device for d in got]
    return {"embedding_model": name, "max_abs_err_vs_cpu": err,
            "decisions": decisions}


def dense_logits_check(torch, engine) -> dict:
    """The dense tick's decode-step logits on the live pool, every slot
    continuing the longest parked conversation through the window its
    tick would take, ``three_ways``."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, n = _live_decode_state(torch, engine)
    wb = engine._suffix_window(n + engine.steps_per_tick) \
        // engine.paged.block_size
    kernel, plain, ref = three_ways(lambda pool: decode_step_paged(
        engine.cfg, engine.model, cur, pos, pool, tables[:, :wb],
        ragged=False)[0], engine.pool)
    return check_three({"position": n - 1, "window": wb *
                        engine.paged.block_size}, kernel, plain, ref)


def chat_phase(torch, cluster, *, burst: int = len(CHAT_QUERIES),
               streams: int = 2,
               expect=(), device: str = "cuda"):
    """Serve ``create_app`` over a production-mode Router (``BASE_CONFIG``)
    of ``cluster`` over HTTP, and drive every routing strategy
    (``drive_chat``, the strategy selected per request; the routing cache
    is cleared before each strategy, so each one's split of traffic is its
    own decisions, not the previous strategy's cached ones).  Both tiers must
    serve, the kernels in ``expect`` launch, the ragged decode kernels
    and every plain version stay at 0 and, with the orin tier on an int8
    pool, the int8 suffix chunk run.  Then the dense tick's logits on both
    live pools.  Returns (numbers, launches by kernel)."""
    from distributed_llm_tpu_torch.serving.app import BASE_CONFIG, create_app
    from distributed_llm_tpu_torch.serving.router import Router

    on_card = device == "cuda"
    fresh_peak(torch, on_card)
    t0 = time.perf_counter()
    router = Router(strategy="hybrid", config=dict(BASE_CONFIG),
                    cluster=cluster, device=device)
    for tier in router.tiers.values():
        tier.server_manager.start_server()      # build + warm
    startup_s = time.perf_counter() - t0
    try:
        with http_served(create_app(router=router)) as base:
            return chat_traffic(torch, router, cluster, base, burst, streams,
                                expect, on_card, startup_s)
    finally:
        router.drain(timeout_s=30)


def chat_traffic(torch, router, cluster, base: str, burst: int,
                 streams: int, expect, on_card: bool, startup_s: float):
    """``chat_phase``'s main path and checks against the served app."""
    from distributed_llm_tpu_torch.ops import attention as TA

    with urllib.request.urlopen(base + "/health", timeout=30) as resp:
        require(resp.status == 200, "/health not ok")
    reset_counts()
    t_main = time.perf_counter()
    by_strategy = {}
    for st in STRATEGIES:
        router.query_router.clear_cache()
        by_strategy[st] = drive_chat(base, st, burst, streams)
    main_s = time.perf_counter() - t_main
    launches, plain_calls = read_counts(expect, on_card)
    int8_chunk_calls = TA._dequant_chunk_paged.calls
    require(launches["ragged_decode"] == 0
            and launches["ragged_decode_q8"] == 0,
            f"a ragged decode kernel ran on the dense tick: {launches}")
    nano_n = sum(v["nano"] for v in by_strategy.values())
    orin_n = sum(v["orin"] for v in by_strategy.values())
    require(nano_n > 0 and orin_n > 0,
            f"a tier served no traffic (nano {nano_n}, orin {orin_n})")
    if cluster.orin.kv_quantize == "int8":
        require(int8_chunk_calls > 0, "the int8 suffix chunk did not run")
    engines = {n: t.server_manager.engine() for n, t in
               router.tiers.items()}
    numbers = {
        "startup_s": startup_s, "main_path_s": main_s,
        "tiers": {n: {"model": e.tier.model_preset, "slots":
                      e.paged.max_slots, "kv_quantize": e.tier.kv_quantize,
                      "ragged": e.ragged, "tick_stats": e.tick_stats()}
                  for n, e in engines.items()},
        "by_strategy": by_strategy, "launches": launches,
        "plain_calls": plain_calls, "int8_chunk_calls": int8_chunk_calls,
        "cache": router.query_router.get_cache_stats()["hit_rate"],
        "dense_logits_check": {n: dense_logits_check(torch, e)
                               for n, e in engines.items()},
        "routing_device_check": routing_device_check(
            "cuda" if on_card else "cpu"),
        "peak_memory_gb": peak_memory_gb(torch, on_card)}
    return numbers, launches


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
    cluster = ClusterConfig()
    nano, orin = cluster.nano, cluster.orin
    rows = kernel_phase(torch, nano.model(), nano.kv_block_size)
    spec_rows, draft_shape = spec_kernel_phase(
        torch, orin.model(), nano.model(), orin.kv_block_size,
        orin.decode_batch)
    rows[0]["draft_shape"] = draft_shape
    rows += spec_rows
    rows += paged_decode_kernel_phase(torch, nano.model(), orin.model())
    rows += contiguous_kernel_phase(torch, nano.model(), orin.model())
    log(f"kernels checked in {time.perf_counter() - t_all:.1f}s")

    # 4-6. Serve: nano; orin with bf16 KV and the nano_1b draft; orin with
    # int8 KV drafting with itself.
    phases = {}
    phases["nano"], nano_launches = serve_phase(
        torch, nano, lengths=(4, 20, 45, 80, 120, 160, 200, 240),
        expect=("ragged_decode", "flash_causal", "paged_chunk"), repeat=True)
    log(f"nano served in {time.perf_counter() - t_all:.1f}s")
    orin_lengths = (4, 60, 150, 240)
    phases["orin_spec_bf16"], spec_launches = serve_phase(
        torch, dataclasses.replace(orin, draft_preset=nano.model_preset),
        lengths=orin_lengths, sampled=True,
        expect=("ragged_decode", "flash_causal", "paged_chunk",
                "ragged_verify"))
    log(f"orin (bf16 KV, nano_1b draft) served in "
        f"{time.perf_counter() - t_all:.1f}s")
    phases["orin_spec_int8"], int8_launches = serve_phase(
        torch, dataclasses.replace(orin, draft_preset=orin.model_preset,
                                   kv_quantize="int8"),
        lengths=orin_lengths, sampled=True,
        expect=("flash_causal", "ragged_decode_q8", "ragged_verify_q8"))
    require(phases["orin_spec_int8"]["int8_chunk_calls"] > 0,
            "the int8 suffix chunk did not run")
    log(f"orin (int8 KV, self-draft) served in "
        f"{time.perf_counter() - t_all:.1f}s")

    # 7-9. Serve the sequential engines (decode_batch=1): orin_8b with bf16
    # KV; orin_8b with the nano_1b draft; nano_1b with int8 KV.
    seq_orin = dataclasses.replace(orin, decode_batch=1)
    phases["orin_seq_bf16"], seq_launches = serve_sequential_phase(
        torch, seq_orin, expect=("flash_causal", "flash_decode", "flash_chunk"))
    log(f"orin sequential served in {time.perf_counter() - t_all:.1f}s")
    phases["orin_seq_spec"], seq_spec_launches = serve_sequential_phase(
        torch, dataclasses.replace(seq_orin, draft_preset=nano.model_preset),
        expect=("flash_causal", "flash_decode", "flash_chunk"))
    log(f"orin sequential speculative served in "
        f"{time.perf_counter() - t_all:.1f}s")
    phases["nano_seq_int8"], seq_int8_launches = serve_sequential_phase(
        torch, dataclasses.replace(nano, decode_batch=1, kv_quantize="int8"),
        expect=("flash_causal", "flash_decode_q8", "flash_chunk_q8"))
    log(f"nano sequential int8 served in {time.perf_counter() - t_all:.1f}s")

    # 10. The two-tier /chat service on the dense windowed tick: nano_1b
    # (bf16 pool) and orin_8b (int8 pool) behind the Router, every
    # routing strategy.
    chat, chat_launches = chat_phase(
        torch, chat_cluster(nano, orin),
        expect=("flash_causal", "paged_chunk", "paged_decode",
                "paged_decode_q8"))
    log(f"/chat served in {time.perf_counter() - t_all:.1f}s")
    by_phase = {"nano": nano_launches, "orin_spec_bf16": spec_launches,
                "orin_spec_int8": int8_launches, "orin_seq_bf16": seq_launches,
                "orin_seq_spec": seq_spec_launches,
                "nano_seq_int8": seq_int8_launches, "chat": chat_launches}
    for row in rows:
        row["launches_by_phase"] = {p: n[row["name"]]
                                    for p, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        row["kernel_ms"] = row["ms"]
    require(all(row["launches"] > 0 for row in rows),
            "a kernel never launched on a main path")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "kernels": rows, "serve": phases, "chat": chat,
              "total_s": time.perf_counter() - t_all}
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "rel_err", "plain_rel_err", "tol", "ms", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape",
            "variants_max_abs_err", "variants_rel_err")
    summary = {}
    for name, serve in phases.items():
        summary[name] = {k: serve[k] for k in (
            "model", "engine", "draft", "kv_quantize", "requests",
            "launches_per_request", "int8_chunk_calls", "cold_ttft_ms",
            "chunked_ttft_ms", "tick_stats", "spec", "decode_step",
            "decode_logits_check", "verify_check", "peak_memory_gb")
            if k in serve}
        summary[name]["concurrent"] = {
            k: serve["concurrent"][k] for k in ("requests", "gen_tokens",
                                                "tokens_per_s", "p50_ttft_ms")}
    log(json.dumps({"card": card, "serve": summary,
                    "total_s": report["total_s"]}))
    log(json.dumps({"chat": {
        "startup_s": chat["startup_s"], "main_path_s": chat["main_path_s"],
        "by_strategy": {st: {k: v[k] for k in (
            "requests", "burst_req_per_s", "p50_stream_ttft_ms", "nano",
            "orin", "p50_routing_overhead_ms")}
            for st, v in chat["by_strategy"].items()},
        "int8_chunk_calls": chat["int8_chunk_calls"],
        "dense_logits_check": chat["dense_logits_check"],
        "routing_device_check": chat["routing_device_check"],
        "peak_memory_gb": chat["peak_memory_gb"]}}))
    log(f"{card}")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
