"""Flash attention kernels: cold causal prefill, suffix chunks read
straight out of the paged KV pool, and the sequential engines' decode
and chunk over the contiguous KV cache.

Counterpart of ``distributed_llm_tpu/ops/pallas_attention.py``.
Wrappers of hand-written CUDA kernels:

- ``flash_causal_attention`` (``csrc/flash_causal.cu``) replaces the
  Pallas ``_flash_kernel`` (forward only; training comes later);
- ``paged_chunk_attention`` (``csrc/paged_chunk.cu``) replaces the
  Pallas ``_paged_chunk_kernel``;
- ``paged_decode_attention`` / ``paged_decode_attention_q8``
  (``csrc/paged_decode.cu``, ``paged_decode_q8.cu``) replace
  ``_paged_decode_kernel`` / ``_paged_decode_kernel_q8``: the dense
  windowed tick's decode through a window-truncated block table;
- ``flash_decode_attention`` / ``flash_decode_attention_q8``
  (``csrc/flash_decode.cu``, ``flash_decode_q8.cu``) replace
  ``_decode_kernel`` / ``_decode_kernel_q8``;
- ``flash_chunk_attention`` / ``flash_chunk_attention_q8``
  (``csrc/flash_chunk.cu``, ``flash_chunk_q8.cu``) replace
  ``_chunk_kernel_native`` + ``_chunk_kernel`` and their q8 twins.

At the serving shapes the prefill and chunk kernels sit near the
balance of bytes and bf16 operations (bytes below about 700 rows), the
decode kernels are bound by bytes; the first designs run their products
on the CUDA cores in float32 and skip KV tiles past each query tile's
causal frontier (see each source for the design and its bound).

A CPU tensor takes the plain version beside it (``causal_attention``,
``_gather_chunk_paged``, ``_gather_decode_windowed`` and the contiguous
plain versions in
``attention.py``, the JAX package's XLA paths); a CUDA tensor launches
the kernel or raises.  The contiguous kernels read a cache window in
place through its batch stride and raise on any other layout instead of
copying it; so do the paged decode kernels, which read a column slice
of the block table through its row stride.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import (_chunk_contiguous, _chunk_contiguous_q8,
                        _decode_contiguous, _decode_contiguous_q8,
                        _gather_chunk_paged, _gather_decode_windowed,
                        causal_attention)
from .ragged_attention import _check as _check_paged

_SUPPORTED_D = (64, 128)
_SUPPORTED_BS = (32, 64, 128)


def _require(cond: bool, fn: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_common(fn: str, q: torch.Tensor, named) -> None:
    for name, t in named:
        _require(t.device == q.device, fn, f"{name} on {t.device}, q on {q.device}")
        _require(t.is_contiguous(), fn, f"{name} must be contiguous")
    _require(q.is_contiguous(), fn, "q must be contiguous")


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """q [B, S, Nq, D], k/v [B, S, Nkv, D] -> [B, S, Nq, D]; row r attends
    keys 0 .. r, query head h reads kv head h // (Nq / Nkv)."""
    if not q.is_cuda:
        return causal_attention(q, k, v)
    fn = "flash_causal_attention"
    b, s, nq, d = q.shape
    nkv = k.shape[2]
    _check_common(fn, q, (("k", k), ("v", v)))
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16, fn,
             "q/k/v must be bf16")
    _require(k.shape == v.shape == (b, s, nkv, d), fn,
             f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(d in _SUPPORTED_D, fn, f"head dim {d} (need 64 or 128)")
    _require(nq % nkv == 0, fn, f"Nq={nq} not a multiple of Nkv={nkv}")
    out = torch.empty_like(q)
    err = _build.entry("flash_causal")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, nq, nkv, d, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_causal")
    flash_causal_attention.launches += 1
    return out


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          start: torch.Tensor, window: int,
                          q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [1, S_c, Nq, D] at positions start + r, one layer's pools
    [Nkv, NB, bs, D], table [MB] int32, start [1] int32, ``window`` a
    multiple of bs -> [1, S_c, Nq, D]; row r attends positions
    0 .. start + r.  The plain version (CPU) masks by ``q_pos`` (the
    positions clamped to the true length, required there); the two agree
    on every row below the true length."""
    if not q.is_cuda:
        if q_pos is None:
            raise ValueError("paged_chunk_attention: the plain version needs "
                             "q_pos")
        return _gather_chunk_paged(q, k_pool, v_pool, table, q_pos, window)
    fn = "paged_chunk_attention"
    _, s_c, nq, d = q.shape
    nkv, nb, bs, dk = k_pool.shape
    _check_common(fn, q, (("k_pool", k_pool), ("v_pool", v_pool),
                          ("table", table), ("start", start)))
    _require(q.shape[0] == 1, fn, "one slot per call (q batch must be 1)")
    _require(q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16, fn,
             "q and pools must be bf16")
    _require(table.dtype == torch.int32 and start.dtype == torch.int32, fn,
             "table and start must be int32")
    _require(v_pool.shape == k_pool.shape, fn, "k_pool/v_pool shapes differ")
    _require(dk == d and d in _SUPPORTED_D, fn, f"head dim {d} (need 64 or 128)")
    _require(bs in _SUPPORTED_BS, fn, f"block size {bs} (need 32, 64 or 128)")
    _require(nq % nkv == 0, fn, f"Nq={nq} not a multiple of Nkv={nkv}")
    _require(window % bs == 0 and 0 < window // bs <= table.shape[0], fn,
             f"window {window} must be a multiple of bs={bs} within the table")
    _require(start.numel() == 1, fn, "start must hold one position")
    out = torch.empty_like(q)
    err = _build.entry("paged_chunk")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        start.data_ptr(), out.data_ptr(), s_c, nq, nkv, nb, bs, d,
        window // bs, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_chunk")
    paged_chunk_attention.launches += 1
    return out


def _paged_decode(wrapper, name: str, q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], tables: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Check a paged decode kernel's inputs (the table may be a column
    slice: read through its row stride), launch kernel ``name`` and count
    the launch on ``wrapper``."""
    _check_paged(wrapper.__name__, q, k_pool, v_pool, tables, pos, k_scale,
                 v_scale, 1, strided_tables=True)
    b, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    scales = (() if k_scale is None
              else (k_scale.data_ptr(), v_scale.data_ptr()))
    out = torch.empty_like(q)
    err = _build.entry(name)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, nq, nkv, nb, bs,
        d, tables.shape[1], tables.stride(0), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    wrapper.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's pools [Nkv, NB, bs, D] bf16, tables
    [B, wb] int32 (a window of each slot's row; a column slice of the
    full table is read in place), pos [B] int32 with every pos < wb * bs
    -> [B, Nq, D]; slot b attends positions 0 .. pos[b]."""
    if not q.is_cuda:
        return _gather_decode_windowed(q, k_pool, v_pool, tables, pos)
    return _paged_decode(paged_decode_attention, "paged_decode", q, k_pool,
                         v_pool, None, None, tables, pos)


def paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, tables: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """``paged_decode_attention`` over an int8 pool: pools
    [Nkv, NB, bs, D] int8, scales [Nkv, NB, bs] float32, dequantized in the
    kernel."""
    if not q.is_cuda:
        return _gather_decode_windowed(q, k_pool, v_pool, tables, pos,
                                       k_scale, v_scale)
    return _paged_decode(paged_decode_attention_q8, "paged_decode_q8", q,
                         k_pool, v_pool, k_scale, v_scale, tables, pos)


def _check_cache(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q8: bool):
    """A contiguous cache window [B, W, Nkv, D] whose rows are dense (any
    batch stride): returns (W, Nkv, batch stride in elements)."""
    _require(k.dim() == 4 and v.shape == k.shape, fn,
             f"k/v must be [B, W, Nkv, D] of one shape, got {tuple(k.shape)} "
             f"and {tuple(v.shape)}")
    b, w, nkv, d = k.shape
    _require(b == q.shape[0] and d == q.shape[-1], fn,
             f"cache {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(d in _SUPPORTED_D, fn, f"head dim {d} (need 64 or 128)")
    want = torch.int8 if q8 else torch.bfloat16
    _require(k.dtype == v.dtype == want, fn, f"k/v must be {want}")
    _require(k.stride()[1:] == (nkv * d, d, 1) and v.stride() == k.stride(),
             fn, "k/v rows must be dense [Nkv, D] (only the batch stride is "
             "free)")
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, fn, f"{name} on {t.device}, q on {q.device}")
        _require(t.data_ptr() % 16 == 0, fn, f"{name} must be 16-byte aligned")
    return w, nkv, k.stride(0)


def _check_scales(fn: str, k: torch.Tensor, k_scale: torch.Tensor,
                  v_scale: torch.Tensor) -> int:
    """float32 row scales [B, W, Nkv] beside an int8 window (any batch
    stride): returns the batch stride in elements."""
    b, w, nkv, _ = k.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _require(t.device == k.device, fn, f"{name} on {t.device}")
        _require(t.dtype == torch.float32 and t.shape == (b, w, nkv), fn,
                 f"{name} must be float32 [B, W, Nkv] = {(b, w, nkv)}")
    _require(k_scale.stride()[1:] == (nkv, 1)
             and v_scale.stride() == k_scale.stride(), fn,
             "scale rows must be dense [Nkv] (only the batch stride is free)")
    return k_scale.stride(0)


def _check_query(fn: str, q: torch.Tensor, nkv: int, positions: torch.Tensor,
                 max_group: int) -> None:
    nq = q.shape[-2]
    _require(q.dtype == torch.bfloat16 and q.is_contiguous(), fn,
             "q must be contiguous bf16")
    _require(nq % nkv == 0 and nq // nkv <= max_group, fn,
             f"Nq={nq} must be a multiple of Nkv={nkv}, at most {max_group} "
             "query heads per kv head")
    _require(positions.device == q.device and positions.dtype == torch.int32
             and positions.is_contiguous()
             and positions.shape == q.shape[:-2], fn,
             f"positions must be contiguous int32 {tuple(q.shape[:-2])}")


def _contiguous(wrapper, name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor],
                positions: torch.Tensor) -> torch.Tensor:
    """Check a contiguous-cache kernel's inputs, launch kernel ``name``
    and count the launch on ``wrapper``."""
    fn = wrapper.__name__
    decode = name.startswith("flash_decode")
    _require(q.dim() == (3 if decode else 4), fn,
             "q must be [B, Nq, D]" if decode else "q must be [B, S_c, Nq, D]")
    q8 = k_scale is not None
    w, nkv, kv_bstride = _check_cache(fn, q, k, v, q8)
    sc_bstride = _check_scales(fn, k, k_scale, v_scale) if q8 else 0
    _check_query(fn, q, nkv, positions, max_group=8 if decode else 64)
    s_q = 1 if decode else q.shape[1]
    nq, d = q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    err = _build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if q8 else None, v_scale.data_ptr() if q8 else None,
        positions.data_ptr(), out.data_ptr(), q.shape[0], s_q, nq, nkv, d, w,
        kv_bstride, sc_bstride, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    wrapper.launches += 1
    return out


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's cache [B, W, Nkv, D], pos [B] int32 ->
    [B, Nq, D]; row h attends kv head h // (Nq / Nkv) at positions
    0 .. pos[b]."""
    if not q.is_cuda:
        return _decode_contiguous(q, k_cache, v_cache, pos)
    return _contiguous(flash_decode_attention, "flash_decode", q, k_cache,
                       v_cache, None, None, pos)


def flash_decode_attention_q8(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """``flash_decode_attention`` over an int8 cache [B, W, Nkv, D] with
    float32 row scales [B, W, Nkv], dequantized in the kernel."""
    if not q.is_cuda:
        return _decode_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale,
                                     pos)
    return _contiguous(flash_decode_attention_q8, "flash_decode_q8", q,
                       k_cache, v_cache, k_scale, v_scale, pos)


def flash_chunk_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          q_positions: torch.Tensor) -> torch.Tensor:
    """q [B, S_c, Nq, D], one layer's cache window [B, W, Nkv, D] (read
    in place; a window of a longer cache keeps its batch stride),
    q_positions [B, S_c] int32 -> [B, S_c, Nq, D]; each row attends
    positions 0 .. min(its position, W - 1)."""
    if not q.is_cuda:
        return _chunk_contiguous(q, k_cache, v_cache, q_positions)
    return _contiguous(flash_chunk_attention, "flash_chunk", q, k_cache,
                       v_cache, None, None, q_positions)


def flash_chunk_attention_q8(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor,
                             q_positions: torch.Tensor) -> torch.Tensor:
    """``flash_chunk_attention`` over an int8 window [B, W, Nkv, D] with
    float32 row scales [B, W, Nkv], dequantized in the kernel."""
    if not q.is_cuda:
        return _chunk_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale,
                                    q_positions)
    return _contiguous(flash_chunk_attention_q8, "flash_chunk_q8", q, k_cache,
                       v_cache, k_scale, v_scale, q_positions)


flash_causal_attention.launches = 0
paged_chunk_attention.launches = 0
paged_decode_attention.launches = 0
paged_decode_attention_q8.launches = 0
flash_decode_attention.launches = 0
flash_decode_attention_q8.launches = 0
flash_chunk_attention.launches = 0
flash_chunk_attention_q8.launches = 0
