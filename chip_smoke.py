#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  Phases
(any failure exits non-zero before the last line):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the six attention kernels (``csrc/*.cu``) compile with nvcc for
   sm_90a, in parallel;
3. kernels: each kernel, at its main-path shapes (the nano tier's for the
   ragged decode, causal prefill and paged chunk kernels; the orin tier's
   for the ragged verify and the int8 ragged decode and verify kernels),
   is held against its plain PyTorch version on the same inputs, and
   timed beside the plain version, one PyTorch library call computing the
   same function (SDPA on the gathered, dequantized K/V, timed here only)
   and the card's bound (bytes at 3.35 TB/s, operations at the bf16 rate
   of 989 TFLOP/s); each is also checked at its other instantiations
   (head dim, block, group, verify width);
4. serve nano: the default nano tier (nano_1b at full width, seeded
   random weights) under EngineManager behind the /query server on
   127.0.0.1; cold, chunked, prefix-hit, concurrent and streaming
   requests go over HTTP;
5. serve orin, bf16 KV, with nano_1b drafting (batched speculation), and
6. serve orin, int8 KV, drafting with itself: orin_8b at full width and
   depth, the same requests plus a sampled one.

Each serve phase sets every kernel's launch count and every plain
version's call count to 0 before its requests and reads them after: the
phase's kernels must have launched and no plain attention version may
have run.  Then, on the live pool, the decode step's logits with the
kernel and with the plain attention (in bf16 and in float32) must agree
(orin: also the verify step's rows against as many sequential decode
steps, and the verify with the kernel against the verify with the plain
attention), and one decode step is timed eager and as a replayed CUDA
graph.

It prints the serving numbers as one JSON line, the card's name and power
limit, the kernel table as one JSON line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A fuller report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import dataclasses
import gc
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
# Decode (and verify) logits after 16 or 32 bf16 layers, the kernel in
# every layer against the plain attention, in bf16 and in float32: the
# few-ulp attention differences pass through every later layer, and a
# model of seeded random weights amplifies them (its matrices have a gain
# above 1), the more the deeper it is.  So the bound is LOGITS_RTOL of the
# logits' own scale above the model's rounding floor, measured on the
# same state: how far the plain attention in bf16 lands from the same in
# float32 (``logits_tol``).  A fault in the path (a wrong layer, table,
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
        err = ratio = 0.0
        for g in (2, 3, 5):
            pos = positions(g)
            q = randn(n_slots, g, nq, d)
            kargs = ((q, *pool, tables, pos) if q8
                     else (q, pool[0], pool[1], tables, pos))
            out = kern(*kargs)
            ref = TA._gather_verify_paged(q, pool[0], pool[1], tables, pos,
                                          pool[2], pool[3])
            torch.cuda.synchronize()
            e, r = compare(out, ref)
            err, ratio = max(err, e), max(ratio, r)
        require(ratio <= 1, f"{name} disagrees: max abs err {err}")
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
            "max_abs_err": err, "tol": TOL,
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
    ref = TA._gather_decode_paged(q, kq, vq, tables, pos, ks, vs)
    torch.cuda.synchronize()
    e5, r5 = compare(out, ref)
    dnq, dnkv, dd = draft_cfg.num_heads, draft_cfg.num_kv_heads, \
        draft_cfg.head_dim
    dk, dv = randn(dnkv, nb, bs, dd), randn(dnkv, nb, bs, dd)
    dkq, dks = quant.quantize_kv_rows(dk)
    dvq, dvs = quant.quantize_kv_rows(dv)
    dq = randn(n_slots, dnq, dd)
    out = TR.ragged_paged_decode_attention_q8(dq, dkq, dvq, dks, dvs, tables,
                                              pos)
    ref = TA._gather_decode_paged(dq, dkq, dvq, tables, pos, dks, dvs)
    torch.cuda.synchronize()
    e, r = compare(out, ref)
    e5, r5 = max(e5, e), max(r5, r)
    require(r5 <= 1, f"ragged_decode_q8 disagrees: max abs err {e5}")
    # K1 at the nano draft's shape (bf16 pool of a 4-slot engine).
    out = TR.ragged_paged_decode_attention(dq, dk, dv, tables, pos)
    ref = TA._gather_decode_paged(dq, dk, dv, tables, pos)
    torch.cuda.synchronize()
    e1, r1 = compare(out, ref)
    require(r1 <= 1, f"ragged_decode disagrees at the draft shape: {e1}")
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
        "max_abs_err": e5, "tol": TOL,
        "ms": time_ms(torch, lambda: TR.ragged_paged_decode_attention_q8(*args),
                      flush=flush),
        "plain_ms": time_ms(torch, lambda: TA._gather_decode_paged(
            q, kq, vq, tables, pos, ks, vs), flush=flush),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            lib[0], lib[1], lib[2], attn_mask=lib[3]), flush=flush),
        "bound_ms": b_ms, "bound_by": b_by})
    del lib, flush_buf, k_pool, v_pool, kq, vq, dk, dv, dkq, dvq
    worst = spec_variant_checks(torch, gen)
    for row in rows:
        err, ratio = worst[row["name"]]
        row["variants_max_abs_err"] = err
        require(ratio <= 1, f"{row['name']} disagrees at another head dim / "
                f"block size / group / verify width: max abs err {err}")
    torch.cuda.empty_cache()
    return rows, e1


def spec_variant_checks(torch, gen) -> dict:
    """The verify kernels (bf16, int8) at every instantiation they accept
    (head dim 64/128, block 32/64/128, GQA group 1/4/8, G 1..5) and the
    int8 decode kernel (G=1) on small ragged shapes with an idle slot and
    a chunk ending at the table's end; returns (max abs error, max scaled
    error) per kernel."""
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.ops import quant
    from distributed_llm_tpu_torch.ops import ragged_attention as TR

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    worst = {"ragged_verify": (0.0, 0.0), "ragged_verify_q8": (0.0, 0.0),
             "ragged_decode_q8": (0.0, 0.0)}

    def note(name, a, b):
        e, r = compare(a, b)
        worst[name] = (max(worst[name][0], e), max(worst[name][1], r))

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
                         TA._gather_verify_paged(q, kp, vp, tables, pos))
                    note("ragged_verify_q8",
                         TR.ragged_paged_verify_attention_q8(
                             q, kq, vq, ks, vs, tables, pos),
                         TA._gather_verify_paged(q, kq, vq, tables, pos, ks,
                                                 vs))
                    if g == 1:
                        q1 = q[:, 0].contiguous()
                        note("ragged_decode_q8",
                             TR.ragged_paged_decode_attention_q8(
                                 q1, kq, vq, ks, vs, tables, pos),
                             TA._gather_decode_paged(q1, kq, vq, tables, pos,
                                                     ks, vs))
    return worst


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


# Every kernel's wrapper and the main-path phases that must launch it.
KERNEL_NAMES = ("ragged_decode", "flash_causal", "paged_chunk",
                "ragged_verify", "ragged_decode_q8", "ragged_verify_q8")


def kernel_wrappers():
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    from distributed_llm_tpu_torch.ops import ragged_attention as TR
    return {"ragged_decode": TR.ragged_paged_decode_attention,
            "flash_causal": TF.flash_causal_attention,
            "paged_chunk": TF.paged_chunk_attention,
            "ragged_verify": TR.ragged_paged_verify_attention,
            "ragged_decode_q8": TR.ragged_paged_decode_attention_q8,
            "ragged_verify_q8": TR.ragged_paged_verify_attention_q8}


def plain_versions():
    """The plain version of every kernel (none may run on a main path)."""
    from distributed_llm_tpu_torch.ops import attention as TA
    return (TA.causal_attention, TA._gather_decode_paged,
            TA._gather_verify_paged, TA._gather_chunk_paged)


def serve_phase(torch, tier, *, lengths, expect, repeat=False, sampled=False,
                device: str = "cuda"):
    """Serve ``tier`` over HTTP: a cold prompt (with ``repeat``, twice:
    greedy must repeat itself), a prompt past one 256-token chunk, a
    multi-turn follow-up hitting the parked prefix, ``len(lengths)``
    concurrent requests of skewed length, one stream and (``sampled``) one
    request at temperature 0.8.  Every kernel in ``expect`` must launch and
    no plain version may run; with speculation on, drafts must have been
    made.  Then the numerics checks on the live pool and the decode step's
    breakdown.  Returns (serve numbers, launches by kernel)."""
    from wsgiref.simple_server import WSGIRequestHandler, make_server

    from distributed_llm_tpu_torch.engine.manager import EngineManager
    from distributed_llm_tpu_torch.ops import attention as TA
    from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app
    from distributed_llm_tpu_torch.utils.webapp import _ThreadingWSGIServer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    manager = EngineManager(tier, seed=0, device=device)
    manager.start_server()                   # build + warm (one request)
    startup_s = time.perf_counter() - t0
    app = create_tier_app(tier.name, manager=manager)

    class QuietHandler(WSGIRequestHandler):
        def log_message(self, *args):       # no per-request access log
            pass

    server = make_server("127.0.0.1", 0, app, server_class=_ThreadingWSGIServer,
                         handler_class=QuietHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    engine = manager.engine()
    kernels = kernel_wrappers()
    plains = plain_versions()
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            require(resp.status == 200 and json.loads(resp.read())["ok"],
                    "/health not ok")
        for fn in kernels.values():
            fn.launches = 0
        for fn in plains + (TA._dequant_chunk_paged,):
            fn.calls = 0
        spec0 = engine.spec_stats()
        t_main = time.perf_counter()

        # Cold prefill (flash_causal).
        turn1 = [{"role": "user", "content": "tell me about " + words(12)}]
        first = query(base, turn1)
        if repeat:
            again = query(base, turn1)
            require(first["response"] == again["response"],
                    "the same greedy prompt gave two different replies")
        # Prompt past one 256-token chunk: chunked prefill (paged_chunk on a
        # bf16 pool; never speculates).
        long_reply = query(base, "summarise: " + words(420, 3))
        require(long_reply["stats"]["prompt_tokens"] > 256,
                f"long prompt only {long_reply['stats']['prompt_tokens']} tokens")
        # Multi-turn follow-up of the first: shared prefix hit (paged_chunk
        # over the parked blocks, copy-on-write boundary block; the draft
        # writes its suffix too).
        hits0 = engine.prefix_cache.stats()["hits_shared"]
        turn2 = turn1 + [{"role": "assistant", "content": first["response"]},
                         {"role": "user", "content": "and " + words(6, 5) + "?"}]
        query(base, turn2)
        require(engine.prefix_cache.stats()["hits_shared"] > hits0,
                "the follow-up did not hit the parked prefix")
        # Concurrent requests of skewed length: ragged ticks / rounds.
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
        n_requests = 4 + int(repeat) + len(lengths)
        if sampled:
            # A sampled request rides γ=0 beside the greedy slots.
            query(base, "imagine " + words(8, 2), temperature=0.8)
            n_requests += 1
        main_s = time.perf_counter() - t_main
        launches = {name: fn.launches for name, fn in kernels.items()}
        plain_calls = {fn.__name__: fn.calls for fn in plains}
        dequant_chunk_calls = TA._dequant_chunk_paged.calls
        require(all(launches[name] > 0 for name in expect),
                f"a kernel did not run on the main path: {launches}")
        require(not any(plain_calls.values()),
                f"plain attention ran on the main path: {plain_calls}")
        spec = engine.spec_stats()
        drafted = spec["drafted_total"] - spec0["drafted_total"]
        accepted = spec["accepted_total"] - spec0["accepted_total"]
        if engine.spec:
            require(drafted > 0, f"speculation drafted nothing: {spec}")

        logits = logits_check(torch, engine, TA)
        verify = verify_check(torch, engine, TA) if engine.spec else None
        breakdown = step_breakdown(torch, engine)

        gen_tokens = sum(r["stats"]["gen_tokens"] for r in results)
        ttfts = [r["stats"]["ttft_ms"] for r in results]
        serve = {
            "tier": tier.name, "model": tier.model_preset,
            "draft": tier.draft_preset if engine.spec else None,
            "kv_quantize": tier.kv_quantize,
            "startup_s": startup_s, "main_path_s": main_s,
            "requests": n_requests, "launches": launches,
            "plain_calls": plain_calls,
            "int8_chunk_calls": dequant_chunk_calls,
            "launches_per_request": {k: v / n_requests
                                     for k, v in launches.items() if v},
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
            "spec": ({"drafted": drafted, "accepted": accepted,
                      "accept_ratio": accepted / drafted if drafted else None,
                      "slot_gammas_at_end": spec["slot_gammas"]}
                     if engine.spec else None),
            "decode_step": breakdown,
            "decode_logits_check": logits,
            "verify_check": verify,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device == "cuda" else None),
        }
        return serve, launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        manager.stop_server()
        del engine
        gc.collect()
        torch.cuda.empty_cache()


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


def _scales(pool, layer):
    return (pool["ks"][layer], pool["vs"][layer]) if "ks" in pool else ()


def step_breakdown(torch, engine) -> dict:
    """Where one decode step's time goes: its eager wall time (enqueue
    and run, then synchronize) against the same step captured once as a
    CUDA graph and replayed, which is its device time with no host launch
    gaps; their ratio is the device's idle share in eager mode.  Plus the
    ragged decode kernel's part (one launch per layer)."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged
    from distributed_llm_tpu_torch.ops import attention as TA

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
                    device=engine.device).to(engine.model.embed.dtype)
    attn_ms = cfg.num_layers * time_ms(
        torch, lambda: TA.ragged_decode(q, pool["k"][0], pool["v"][0], tables,
                                        pos, *_scales(pool, 0)))
    del graph, pool
    return {"slots": engine.paged.max_slots, "position": n - 1,
            "wall_ms": wall_ms, "graph_ms": graph_ms,
            "ragged_decode_ms": attn_ms,
            "device_idle_share": max(0.0, 1.0 - graph_ms / wall_ms)}


def float32_attention(plain):
    """``plain`` (a plain attention version) run on float32 copies of q
    and a bf16 pool (an int8 pool dequantizes to q's float32), its output
    cast back to q's dtype: the attention without bf16 rounding inside."""
    def attn(q, k_pool, v_pool, tables, pos, k_scale=None, v_scale=None):
        if k_scale is None:
            k_pool, v_pool = k_pool.float(), v_pool.float()
        return plain(q.float(), k_pool, v_pool, tables, pos, k_scale,
                     v_scale).to(q.dtype)
    return attn


def logits_tol(scale: float, floor: float) -> float:
    """LOGITS_RTOL of the logits' scale above the model's rounding floor
    (the plain attention in bf16 against the same in float32)."""
    return LOGITS_RTOL * scale + floor


def logits_check(torch, engine, TA) -> dict:
    """Decode-step logits on the live pool: the parked prefix of the
    served conversation, continued by one token, with the kernel, with
    the plain attention and with the plain attention in float32 (each on
    its own copy of the pool).  The kernel's logits must agree with both
    within ``logits_tol``."""
    from distributed_llm_tpu_torch.engine.paged_kv import decode_step_paged

    tables, pos, cur, _ = _live_decode_state(torch, engine)
    out = []
    for attn in (None, TA._gather_decode_paged,
                 float32_attention(TA._gather_decode_paged)):
        pool = {k: v.clone() for k, v in engine.pool.items()}
        out.append(decode_step_paged(engine.cfg, engine.model, cur, pos, pool,
                                     tables, attn=attn)[0])
        del pool
    kernel, plain, ref = out
    scale = ref.abs().max().item()
    floor = (plain - ref).abs().max().item()
    res = {"kernel_vs_plain_max_abs_err": (kernel - plain).abs().max().item(),
           "kernel_vs_float32_max_abs_err": (kernel - ref).abs().max().item(),
           "plain_vs_float32_max_abs_err": floor,
           "logits_max_abs": scale, "tol": logits_tol(scale, floor)}
    for key in ("kernel_vs_plain_max_abs_err", "kernel_vs_float32_max_abs_err"):
        require(res[key] <= res["tol"],
                f"decode logits with the kernel disagree ({key}): {res}")
    return res


def verify_check(torch, engine, TA) -> dict:
    """The verify step on the live pool at the top γ bucket (G rows): its
    logits rows against G sequential greedy decode steps from the same
    state, and the verify with the kernel against the verify with the
    plain attention and with the plain attention in float32 (each on its
    own copy of the pool, two spare blocks after the parked ones for the
    new rows).  All three must agree within ``logits_tol``."""
    from distributed_llm_tpu_torch.engine.paged_kv import (decode_step_paged,
                                                           verify_step_paged)

    g = engine.spec_gamma_max + 1
    spare = engine.allocator.alloc(2)
    require(spare is not None, "no spare blocks for the verify check")
    try:
        tables, pos, cur, _ = _live_decode_state(torch, engine, spare)
        cfg, model = engine.cfg, engine.model

        def pool_copy():
            return {k: v.clone() for k, v in engine.pool.items()}

        pool = pool_copy()
        seq, toks, p = [], [cur], pos
        for _ in range(g):
            logits = decode_step_paged(cfg, model, toks[-1], p, pool, tables)
            seq.append(logits)
            toks.append(logits.argmax(dim=-1))
            p = p + 1
        seq = torch.stack(seq, dim=1)                       # [B, G, V]
        del pool
        chunk = torch.stack(toks[:g], dim=1)                # [B, G]
        ver = {}
        for name, attn in (("kernel", None),
                           ("plain", TA._gather_verify_paged),
                           ("float32", float32_attention(
                               TA._gather_verify_paged))):
            pool = pool_copy()
            ver[name] = verify_step_paged(cfg, model, chunk, pos, pool,
                                          tables, attn=attn)
            del pool
        scale = ver["float32"].abs().max().item()
        floor = (ver["plain"] - ver["float32"]).abs().max().item()
        out = {"rows": g,
               "verify_vs_sequential_max_abs_err":
                   (ver["kernel"] - seq).abs().max().item(),
               "verify_kernel_vs_plain_max_abs_err":
                   (ver["kernel"] - ver["plain"]).abs().max().item(),
               "verify_kernel_vs_float32_max_abs_err":
                   (ver["kernel"] - ver["float32"]).abs().max().item(),
               "plain_vs_float32_max_abs_err": floor,
               "logits_max_abs": scale, "tol": logits_tol(scale, floor),
               "argmax_agree": (ver["kernel"].argmax(-1) == seq.argmax(-1))
               .float().mean().item()}
    finally:
        engine.allocator.free(spare)
    for key in ("verify_vs_sequential_max_abs_err",
                "verify_kernel_vs_plain_max_abs_err",
                "verify_kernel_vs_float32_max_abs_err"):
        require(out[key] <= out["tol"],
                f"verify logits disagree ({key}): {out}")
    return out


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
    spec_rows, draft_shape_err = spec_kernel_phase(
        torch, orin.model(), nano.model(), orin.kv_block_size,
        orin.decode_batch)
    rows[0]["draft_shape_max_abs_err"] = draft_shape_err
    rows += spec_rows
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
    by_phase = {"nano": nano_launches, "orin_spec_bf16": spec_launches,
                "orin_spec_int8": int8_launches}
    for row in rows:
        row["launches_by_phase"] = {p: n[row["name"]]
                                    for p, n in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        row["kernel_ms"] = row["ms"]
    require(all(row["launches"] > 0 for row in rows),
            "a kernel never launched on a main path")

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "ptxas": ptxas, "kernels": rows, "serve": phases,
              "total_s": time.perf_counter() - t_all}
    os.makedirs(REPORT_DIR, exist_ok=True)
    with open(os.path.join(REPORT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "tol", "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "variants_max_abs_err")
    summary = {}
    for name, serve in phases.items():
        summary[name] = {k: serve[k] for k in (
            "model", "draft", "kv_quantize", "requests",
            "launches_per_request", "int8_chunk_calls", "cold_ttft_ms",
            "chunked_ttft_ms", "tick_stats", "spec", "decode_step",
            "decode_logits_check", "verify_check", "peak_memory_gb")}
        summary[name]["concurrent"] = {
            k: serve["concurrent"][k] for k in ("requests", "gen_tokens",
                                                "tokens_per_s", "p50_ttft_ms")}
    log(json.dumps({"card": card, "serve": summary,
                    "total_s": report["total_s"]}))
    log(f"{card}")
    log(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
