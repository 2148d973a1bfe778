"""Attention for prefill, chunked prefill, batched paged decode,
speculative verify and the sequential engines' contiguous cache.

Counterpart of ``distributed_llm_tpu/ops/attention.py``.  The functions
here are the plain PyTorch versions (einsum + softmax, the JAX package's
XLA path, rounding at the same points) and the dispatchers the model
calls.  A dispatcher sends a CUDA tensor to its hand-written kernel and
a CPU tensor to the plain version; there is no switch and no fallback
from a kernel to its plain version.

Shapes follow the JAX package: sequences [B, S, N_kv, D], queries
[B, S, N_q, D] with N_q a multiple of N_kv (GQA, query head h reads kv
head h // (N_q / N_kv)), and paged pools [N_kv, NB, bs, D] per layer.
An int8 pool comes with float32 per-row scales [N_kv, NB, bs]
(``k_scale``/``v_scale``), an int8 contiguous cache with [B, S, N_kv];
the plain versions dequantize what they read to the query's dtype, the
int8 kernels dequantize in the kernel.

Each kernel's plain version counts its calls in ``.calls``, so a run can
show that a CUDA main path never reached them.  The int8 suffix chunk
(``_dequant_chunk_paged``) has no kernel on either package, by design: it
is plain PyTorch on the card as the JAX package leaves it to XLA, and
counts its own calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from .quant import dequantize_kv_rows

NEG_INF = -1e30


def causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention for prefill: q [B, S, Nq, D], k/v [B, S, Nkv, D]."""
    if q.is_cuda:
        from .flash_attention import flash_causal_attention
        return flash_causal_attention(q, k, v)
    return causal_attention(q, k, v)


def ragged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, tables: torch.Tensor,
                  pos: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged batched decode over a paged pool: q [B, Nq, D], pools
    [Nkv, NB, bs, D], tables [B, MB] (each slot's FULL row), pos [B]
    (each slot's TRUE position) -> [B, Nq, D].  ``k_scale``/``v_scale``
    ([Nkv, NB, bs]) mark an int8 pool."""
    if q.is_cuda:
        from . import ragged_attention as RA
        if k_scale is None:
            return RA.ragged_paged_decode_attention(q, k_pool, v_pool,
                                                    tables, pos)
        return RA.ragged_paged_decode_attention_q8(q, k_pool, v_pool, k_scale,
                                                   v_scale, tables, pos)
    return _gather_decode_paged(q, k_pool, v_pool, tables, pos,
                                k_scale, v_scale)


def ragged_verify(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, tables: torch.Tensor,
                  pos: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged speculative-verify attention over a paged pool: q
    [B, G, Nq, D], the G = γ+1 chunk queries of each slot at positions
    ``pos[b] + g`` (their K/V already written), pools [Nkv, NB, bs, D],
    tables [B, MB], pos [B] the FIRST query's position -> [B, G, Nq, D].
    Row g of slot b attends positions 0 .. pos[b] + g."""
    if q.is_cuda:
        from . import ragged_attention as RA
        if k_scale is None:
            return RA.ragged_paged_verify_attention(q, k_pool, v_pool,
                                                    tables, pos)
        return RA.ragged_paged_verify_attention_q8(q, k_pool, v_pool, k_scale,
                                                   v_scale, tables, pos)
    return _gather_verify_paged(q, k_pool, v_pool, tables, pos,
                                k_scale, v_scale)


def paged_chunk(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                table: torch.Tensor, start: torch.Tensor, q_pos: torch.Tensor,
                window: int, k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Suffix-chunk attention over a paged pool: q [1, S_c, Nq, D], pools
    [Nkv, NB, bs, D], table [MB], start [1], q_pos [1, S_c] clamped
    absolute positions, ``window`` a multiple of bs.  The kernel rebuilds
    positions from ``start`` (row r sees cols <= start + r); the plain
    version masks by ``q_pos``.  The two differ only on rows past the
    true length, which no caller reads.  An int8 pool takes
    ``_dequant_chunk_paged`` on every device (no kernel, as in the JAX
    package)."""
    if k_scale is not None:
        return _dequant_chunk_paged(q, k_pool, v_pool, table, q_pos, window,
                                    k_scale, v_scale)
    if q.is_cuda:
        from .flash_attention import paged_chunk_attention
        return paged_chunk_attention(q, k_pool, v_pool, table, start, window)
    return _gather_chunk_paged(q, k_pool, v_pool, table, q_pos, window)


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
           v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode over a contiguous cache: q [B, Nq, D], caches
    [B, S, Nkv, D], pos [B] int32 the query's position -> [B, Nq, D].
    ``k_scale``/``v_scale`` ([B, S, Nkv]) mark an int8 cache."""
    if q.is_cuda:
        from . import flash_attention as FA
        if k_scale is None:
            return FA.flash_decode_attention(q, k_cache, v_cache, pos)
        return FA.flash_decode_attention_q8(q, k_cache, v_cache, k_scale,
                                            v_scale, pos)
    if k_scale is None:
        return _decode_contiguous(q, k_cache, v_cache, pos)
    return _decode_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale, pos)


def chunk(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          q_positions: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
          v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A chunk of queries over a contiguous cache window: q
    [B, S_c, Nq, D], caches [B, W, Nkv, D] already holding the chunk's
    own K/V, q_positions [B, S_c] int32 -> [B, S_c, Nq, D]; a query sees
    cache positions <= its own.  ``k_scale``/``v_scale`` ([B, W, Nkv])
    mark an int8 cache.  Every chunk length goes to the kernel on the
    card: the JAX package keeps lengths not divisible by 8 (the
    speculative verify's γ+1) on XLA for the TPU compiler's sake, a limit
    the card does not have; the numerics are the same."""
    if q.is_cuda:
        from . import flash_attention as FA
        if k_scale is None:
            return FA.flash_chunk_attention(q, k_cache, v_cache, q_positions)
        return FA.flash_chunk_attention_q8(q, k_cache, v_cache, k_scale,
                                           v_scale, q_positions)
    if k_scale is None:
        return _chunk_contiguous(q, k_cache, v_cache, q_positions)
    return _chunk_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale,
                                q_positions)


def _dequant_cache(k_cache, v_cache, k_scale, v_scale, dtype):
    """An int8 contiguous cache ([.., S, Nkv, D] + [.., S, Nkv] scales)
    dequantized to ``dtype`` for the plain attention."""
    return (dequantize_kv_rows(k_cache, k_scale, dtype),
            dequantize_kv_rows(v_cache, v_scale, dtype))


def _decode_contiguous(q, k_cache, v_cache, pos):
    """Plain version of the contiguous decode kernel."""
    _decode_contiguous.calls += 1
    return decode_attention(q, k_cache, v_cache, pos)


def _decode_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale, pos):
    """Plain version of the int8 contiguous decode kernel: the cache
    dequantized to the query's dtype, then ``decode_attention``."""
    _decode_contiguous_q8.calls += 1
    k, v = _dequant_cache(k_cache, v_cache, k_scale, v_scale, q.dtype)
    return decode_attention(q, k, v, pos)


def _chunk_contiguous(q, k_cache, v_cache, q_positions):
    """Plain version of the contiguous chunk kernel."""
    _chunk_contiguous.calls += 1
    return chunk_attention(q, k_cache, v_cache, q_positions)


def _chunk_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale, q_positions):
    """Plain version of the int8 contiguous chunk kernel: the window
    dequantized to the query's dtype, then ``chunk_attention``."""
    _chunk_contiguous_q8.calls += 1
    k, v = _dequant_cache(k_cache, v_cache, k_scale, v_scale, q.dtype)
    return chunk_attention(q, k, v, q_positions)


def _gather_pool_seq(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     tables: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     dtype: Optional[torch.dtype] = None):
    """Pools [Nkv, NB, bs, D] + tables [B, MB] -> contiguous
    [B, MB*bs, Nkv, D] views of every slot's table; an int8 pool is
    dequantized through the gathered scales to ``dtype``.  Shared by the
    decode and verify plain versions, so the two agree block for block."""
    b, mb = tables.shape
    nkv, bs, d = k_pool.shape[0], k_pool.shape[2], k_pool.shape[3]
    t = tables.long()
    # [Nkv, B, MB, bs, D] -> [B, S, Nkv, D]
    k_seq = k_pool[:, t].reshape(nkv, b, mb * bs, d).permute(1, 2, 0, 3)
    v_seq = v_pool[:, t].reshape(nkv, b, mb * bs, d).permute(1, 2, 0, 3)
    if k_scale is not None:
        k_sc = k_scale[:, t].reshape(nkv, b, mb * bs).permute(1, 2, 0)
        v_sc = v_scale[:, t].reshape(nkv, b, mb * bs).permute(1, 2, 0)
        k_seq = dequantize_kv_rows(k_seq, k_sc, dtype)
        v_seq = dequantize_kv_rows(v_seq, v_sc, dtype)
    return k_seq, v_seq


def _gather_decode_paged(q, k_pool, v_pool, tables, pos, k_scale=None,
                         v_scale=None):
    """Plain version of the ragged decode kernels (bf16 and int8): gather
    every slot's table into a contiguous view and run
    ``decode_attention`` masked by ``pos``."""
    _gather_decode_paged.calls += 1
    k_seq, v_seq = _gather_pool_seq(k_pool, v_pool, tables, k_scale, v_scale,
                                    q.dtype)
    return decode_attention(q, k_seq, v_seq, pos)


def _gather_verify_paged(q, k_pool, v_pool, tables, pos, k_scale=None,
                         v_scale=None):
    """Plain version of the ragged verify kernels (bf16 and int8): the
    decode version's gather, attended through ``chunk_attention`` at the
    per-query positions ``pos + g``."""
    _gather_verify_paged.calls += 1
    g = q.shape[1]
    k_seq, v_seq = _gather_pool_seq(k_pool, v_pool, tables, k_scale, v_scale,
                                    q.dtype)
    q_pos = pos.long()[:, None] + torch.arange(g, device=q.device)[None]
    return chunk_attention(q, k_seq, v_seq, q_pos)


def _gather_window(k_pool, v_pool, table, window: int, k_scale=None,
                   v_scale=None, dtype=None):
    """The first ``window // bs`` blocks of one table row as contiguous
    [1, window, Nkv, D] sequences (int8 dequantized to ``dtype``)."""
    nkv, bs, d = k_pool.shape[0], k_pool.shape[2], k_pool.shape[3]
    t = table[:window // bs].long()
    k_seq = k_pool[:, t].reshape(nkv, window, d).transpose(0, 1)[None]
    v_seq = v_pool[:, t].reshape(nkv, window, d).transpose(0, 1)[None]
    if k_scale is not None:
        k_sc = k_scale[:, t].reshape(nkv, window).transpose(0, 1)[None]
        v_sc = v_scale[:, t].reshape(nkv, window).transpose(0, 1)[None]
        k_seq = dequantize_kv_rows(k_seq, k_sc, dtype)
        v_seq = dequantize_kv_rows(v_seq, v_sc, dtype)
    return k_seq, v_seq


def _gather_chunk_paged(q, k_pool, v_pool, table, q_pos, window: int):
    """Plain version of the paged chunk kernel: gather the first
    ``window // bs`` table blocks and run ``chunk_attention``."""
    _gather_chunk_paged.calls += 1
    k_seq, v_seq = _gather_window(k_pool, v_pool, table, window)
    return chunk_attention(q, k_seq, v_seq, q_pos)


def _dequant_chunk_paged(q, k_pool, v_pool, table, q_pos, window: int,
                         k_scale, v_scale):
    """Suffix-chunk attention over an int8 pool: gather the window,
    dequantize it to the query's dtype and run ``chunk_attention``.  The
    JAX package has no Pallas kernel for this (its XLA gather serves it),
    so it is plain PyTorch on every device, not the plain version of a
    kernel."""
    _dequant_chunk_paged.calls += 1
    k_seq, v_seq = _gather_window(k_pool, v_pool, table, window, k_scale,
                                  v_scale, q.dtype)
    return chunk_attention(q, k_seq, v_seq, q_pos)


def _expand_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, N_kv, D] -> [B, S, N_kv*groups, D], each kv head repeated
    for its group of query heads."""
    if groups == 1:
        return x
    return x.repeat_interleave(groups, dim=2)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention (prefill).

    q [B, S, N_q, D], k/v [B, S, N_kv, D] -> [B, S, N_q, D].  Logits are
    taken in the input dtype, then scaled and softmaxed in float32; the
    probabilities are cast to ``v.dtype`` before the PV product.  The
    plain version of the causal prefill kernel."""
    causal_attention.calls += 1
    groups = q.shape[2] // k.shape[2]
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() * scale
    s = q.shape[1]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor,
                    q_positions: torch.Tensor) -> torch.Tensor:
    """A chunk of queries against a cache: q [B, S_c, N_q, D] (RoPE
    applied at absolute positions), caches [B, S_max, N_kv, D] already
    holding the chunk's own K/V, q_positions [B, S_c]; cache index > a
    query's position is masked.  Returns [B, S_c, N_q, D]."""
    groups = q.shape[2] // k_cache.shape[2]
    k = _expand_kv(k_cache, groups)
    v = _expand_kv(v_cache, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).float() * scale
    s_max = k.shape[1]
    cols = torch.arange(s_max, device=q.device)
    valid = cols[None, None, :] <= q_positions[:, :, None]      # [B, S_c, S]
    logits = logits.masked_fill(~valid[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One-token decode: q [B, N_q, D], caches [B, S_max, N_kv, D], pos [B]
    the query's position; keys past ``pos`` are masked.  -> [B, N_q, D]."""
    groups = q.shape[1] // k_cache.shape[2]
    k = _expand_kv(k_cache, groups)
    v = _expand_kv(v_cache, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnd,bknd->bnk", q, k).float() * scale
    s_max = k.shape[1]
    cols = torch.arange(s_max, device=q.device)
    valid = cols[None, :] <= pos[:, None]                        # [B, S_max]
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnk,bknd->bnd", probs, v)


causal_attention.calls = 0
_gather_decode_paged.calls = 0
_gather_verify_paged.calls = 0
_gather_chunk_paged.calls = 0
_dequant_chunk_paged.calls = 0
_decode_contiguous.calls = 0
_decode_contiguous_q8.calls = 0
_chunk_contiguous.calls = 0
_chunk_contiguous_q8.calls = 0
