"""Ragged paged attention: one launch over the whole mixed-length batch,
for decode (one query per slot) and speculative verify (G = γ+1 queries
per slot), over a bf16 or an int8 pool.

Wrappers of four hand-written CUDA kernels, each replacing a Pallas TPU
kernel of ``distributed_llm_tpu/ops/ragged_attention.py``:

- ``ragged_paged_decode_attention`` (``csrc/ragged_decode.cu``) replaces
  ``_ragged_decode_kernel``;
- ``ragged_paged_verify_attention`` (``csrc/ragged_verify.cu``) replaces
  ``_ragged_verify_kernel``;
- ``ragged_paged_decode_attention_q8`` (``csrc/ragged_decode_q8.cu``)
  replaces ``_ragged_decode_kernel_q8``;
- ``ragged_paged_verify_attention_q8`` (``csrc/ragged_verify_q8.cu``)
  replaces ``_ragged_verify_kernel_q8``.

All four are bound by bytes: each slot streams its own
ceil((pos + G) / bs) pool blocks once, and each staged K/V tile is read
by every query row of its kv head (the group's heads times the G verify
positions) from shared memory.  The int8 kernels stage half the bytes
plus one float32 scale per row and dequantize in the kernel; the
dequantized window never reaches device memory (see each source for the
design and its known limits).

A CPU tensor takes the plain version (``_gather_decode_paged`` /
``_gather_verify_paged``, the JAX package's XLA paths); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import _gather_decode_paged, _gather_verify_paged

_SUPPORTED_D = (64, 128)
_SUPPORTED_BS = (32, 64, 128)
_MAX_GROUP = 8
# Query rows one block serves (kv-head group x verify positions): the
# verify kernels hold at most 10 rows in each of their 4 warps.
_MAX_ROWS = 40


def _check(fn: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, tables: torch.Tensor, pos: torch.Tensor,
           k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
           g: int, strided_tables: bool = False) -> None:
    """Raise ``ValueError`` on any input the kernel does not take.
    ``strided_tables`` admits a table whose rows are a column slice of a
    wider table (dense rows, any row stride): the kernel reads it in
    place through that stride, nothing is copied."""

    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{fn}: {msg}")

    b, nq, d = q.shape[0], q.shape[-2], q.shape[-1]
    nkv, nb, bs, dk = k_pool.shape
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("tables", tables), ("pos", pos)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        require(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
        if name == "tables" and strided_tables:
            require(t.dim() == 2 and t.stride(1) == 1
                    and t.stride(0) >= t.shape[1],
                    "tables rows must be dense (only the row stride is free)")
        else:
            require(t.is_contiguous(), f"{name} must be contiguous")
    require(q.dtype == torch.bfloat16, "q must be bf16")
    if k_scale is None:
        require(k_pool.dtype == v_pool.dtype == torch.bfloat16,
                "pools must be bf16")
    else:
        require(k_pool.dtype == v_pool.dtype == torch.int8,
                "pools must be int8")
        require(k_scale.dtype == v_scale.dtype == torch.float32,
                "scales must be float32")
        require(tuple(k_scale.shape) == tuple(v_scale.shape) == (nkv, nb, bs),
                f"scales must be [Nkv, NB, bs] = {(nkv, nb, bs)}")
    require(tables.dtype == torch.int32 and pos.dtype == torch.int32,
            "tables and pos must be int32")
    require(v_pool.shape == k_pool.shape, "k_pool/v_pool shapes differ")
    require(dk == d and d in _SUPPORTED_D, f"head dim {d} (need 64 or 128)")
    require(bs in _SUPPORTED_BS, f"block size {bs} (need 32, 64 or 128)")
    require(nq % nkv == 0 and nq // nkv <= _MAX_GROUP,
            f"Nq={nq} over Nkv={nkv} (group <= {_MAX_GROUP})")
    require(g >= 1 and (nq // nkv) * g <= _MAX_ROWS,
            f"G={g} x group {nq // nkv} rows (at most {_MAX_ROWS})")
    require(tables.dim() == 2 and tables.shape[0] == b
            and tuple(pos.shape) == (b,), "tables/pos batch mismatch")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def ragged_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, tables: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's pools [Nkv, NB, bs, D], tables [B, MB]
    int32 (each slot's FULL row), pos [B] int32 (TRUE positions)
    -> [B, Nq, D]; slot b attends positions 0 .. pos[b]."""
    if not q.is_cuda:
        return _gather_decode_paged(q, k_pool, v_pool, tables, pos)
    fn = "ragged_paged_decode_attention"
    _check(fn, q, k_pool, v_pool, tables, pos, None, None, 1)
    b, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _build.entry("ragged_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, nq, nkv, nb, bs, d,
        tables.shape[1], d ** -0.5, _stream(q))
    _build.check(err, "ragged_decode")
    ragged_paged_decode_attention.launches += 1
    return out


def ragged_paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, tables: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """q [B, G, Nq, D] (the G = γ+1 verify chunk of each slot, query g at
    position pos[b] + g, K/V already written), one layer's pools
    [Nkv, NB, bs, D] bf16, tables [B, MB] int32, pos [B] int32 the FIRST
    query's position -> [B, G, Nq, D]; row g attends 0 .. pos[b] + g."""
    if not q.is_cuda:
        return _gather_verify_paged(q, k_pool, v_pool, tables, pos)
    fn = "ragged_paged_verify_attention"
    _check(fn, q, k_pool, v_pool, tables, pos, None, None, q.shape[1])
    b, g, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _build.entry("ragged_verify")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, g, nq, nkv, nb, bs, d,
        tables.shape[1], d ** -0.5, _stream(q))
    _build.check(err, "ragged_verify")
    ragged_paged_verify_attention.launches += 1
    return out


def ragged_paged_decode_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     tables: torch.Tensor,
                                     pos: torch.Tensor) -> torch.Tensor:
    """``ragged_paged_decode_attention`` over an int8 pool: pools
    [Nkv, NB, bs, D] int8, scales [Nkv, NB, bs] float32."""
    if not q.is_cuda:
        return _gather_decode_paged(q, k_pool, v_pool, tables, pos,
                                    k_scale, v_scale)
    fn = "ragged_paged_decode_attention_q8"
    _check(fn, q, k_pool, v_pool, tables, pos, k_scale, v_scale, 1)
    b, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _build.entry("ragged_decode_q8")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, nq, nkv, nb, bs, d, tables.shape[1], d ** -0.5, _stream(q))
    _build.check(err, "ragged_decode_q8")
    ragged_paged_decode_attention_q8.launches += 1
    return out


def ragged_paged_verify_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     k_scale: torch.Tensor,
                                     v_scale: torch.Tensor,
                                     tables: torch.Tensor,
                                     pos: torch.Tensor) -> torch.Tensor:
    """``ragged_paged_verify_attention`` over an int8 pool: pools
    [Nkv, NB, bs, D] int8, scales [Nkv, NB, bs] float32."""
    if not q.is_cuda:
        return _gather_verify_paged(q, k_pool, v_pool, tables, pos,
                                    k_scale, v_scale)
    fn = "ragged_paged_verify_attention_q8"
    _check(fn, q, k_pool, v_pool, tables, pos, k_scale, v_scale, q.shape[1])
    b, g, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _build.entry("ragged_verify_q8")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, g, nq, nkv, nb, bs, d, tables.shape[1], d ** -0.5, _stream(q))
    _build.check(err, "ragged_verify_q8")
    ragged_paged_verify_attention_q8.launches += 1
    return out


ragged_paged_decode_attention.launches = 0
ragged_paged_verify_attention.launches = 0
ragged_paged_decode_attention_q8.launches = 0
ragged_paged_verify_attention_q8.launches = 0
