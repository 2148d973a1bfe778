"""Ragged paged decode attention: one launch over the whole mixed-length
batch.

Wrapper of the hand-written CUDA kernel ``csrc/ragged_decode.cu``, which
replaces the Pallas TPU kernel ``_ragged_decode_kernel``
(``distributed_llm_tpu/ops/ragged_attention.py``).  Decode is bound by
bytes: the kernel streams each slot's own ceil((pos + 1) / bs) pool
blocks once and shares each staged K/V tile among the G query heads of
its kv head (see the source for the design and its known limits).

A CPU tensor takes the plain version beside it (``_gather_decode_paged``,
the JAX package's XLA path); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import _gather_decode_paged

_SUPPORTED_D = (64, 128)
_SUPPORTED_BS = (32, 64, 128)
_MAX_GROUP = 8


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ragged_paged_decode_attention: {msg}")


def ragged_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, tables: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's pools [Nkv, NB, bs, D], tables [B, MB]
    int32 (each slot's FULL row), pos [B] int32 (TRUE positions)
    -> [B, Nq, D]; slot b attends positions 0 .. pos[b]."""
    if not q.is_cuda:
        return _gather_decode_paged(q, k_pool, v_pool, tables, pos)
    b, nq, d = q.shape
    nkv, nb, bs, dk = k_pool.shape
    mb = tables.shape[1]
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos", pos)):
        _require(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos", pos)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.dtype == torch.bfloat16 and k_pool.dtype == torch.bfloat16
             and v_pool.dtype == torch.bfloat16, "q and pools must be bf16")
    _require(tables.dtype == torch.int32 and pos.dtype == torch.int32,
             "tables and pos must be int32")
    _require(v_pool.shape == k_pool.shape, "k_pool/v_pool shapes differ")
    _require(dk == d and d in _SUPPORTED_D, f"head dim {d} (need 64 or 128)")
    _require(bs in _SUPPORTED_BS, f"block size {bs} (need 32, 64 or 128)")
    _require(nq % nkv == 0 and nq // nkv <= _MAX_GROUP,
             f"Nq={nq} over Nkv={nkv} (group <= {_MAX_GROUP})")
    _require(tables.shape[0] == b and pos.shape == (b,),
             "tables/pos batch mismatch")
    out = torch.empty_like(q)
    err = _build.entry("ragged_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, nq, nkv, nb, bs, d, mb,
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ragged_decode")
    ragged_paged_decode_attention.launches += 1
    return out


ragged_paged_decode_attention.launches = 0
