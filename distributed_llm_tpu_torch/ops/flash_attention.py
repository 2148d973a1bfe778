"""Flash attention kernels for prefill: cold causal prefill and suffix
chunks read straight out of the paged KV pool.

Counterpart of ``distributed_llm_tpu/ops/pallas_attention.py``.  Two
wrappers of hand-written CUDA kernels:

- ``flash_causal_attention`` (``csrc/flash_causal.cu``) replaces the
  Pallas ``_flash_kernel`` (forward only; training comes later);
- ``paged_chunk_attention`` (``csrc/paged_chunk.cu``) replaces the
  Pallas ``_paged_chunk_kernel``.

At the serving shapes both sit near the balance of bytes and bf16
operations (bytes below about 700 rows); the first designs run their
products on the CUDA cores in float32 and skip KV tiles past each query
tile's causal frontier (see each source for the design and its bound).

A CPU tensor takes the plain version beside it (``causal_attention`` and
``_gather_chunk_paged``, the JAX package's XLA paths); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import _gather_chunk_paged, causal_attention

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


flash_causal_attention.launches = 0
paged_chunk_attention.launches = 0
