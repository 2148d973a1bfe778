"""Flash attention kernels: cold causal prefill, suffix chunks read
straight out of the paged KV pool, and the sequential engines' decode
and chunk over the contiguous KV cache.

Counterpart of ``distributed_llm_tpu/ops/pallas_attention.py``.
Wrappers of hand-written CUDA kernels:

- ``flash_causal_attention`` (``csrc/flash_causal.cu`` over
  ``csrc/flash_tc.cuh``) replaces the Pallas ``_flash_kernel``, with
  its ``custom_vjp``: ``FlashCausal``, whose backward is autograd of the
  plain version recomputed in float32 from the saved inputs;
- ``paged_chunk_attention`` (``csrc/paged_chunk.cu`` over
  ``csrc/flash_tc.cuh``) replaces the Pallas ``_paged_chunk_kernel``;
- ``paged_decode_attention`` / ``paged_decode_attention_q8``
  (``csrc/paged_decode.cu``, ``paged_decode_q8.cu``, both over
  ``ragged_verify.cuh``) replace
  ``_paged_decode_kernel`` / ``_paged_decode_kernel_q8``: the dense
  windowed tick's decode through a window-truncated block table;
- ``flash_decode_attention`` / ``flash_decode_attention_q8``
  (``csrc/flash_decode.cu``, ``flash_decode_q8.cu``) replace
  ``_decode_kernel`` / ``_decode_kernel_q8``;
- ``flash_chunk_attention`` / ``flash_chunk_attention_q8``
  (``csrc/flash_chunk.cu`` over ``flash_tc.cuh`` and
  ``ragged_verify.cuh``; ``flash_chunk_q8.cu`` over ``flash_tc.cuh``)
  replace ``_chunk_kernel_native`` + ``_chunk_kernel`` and their q8
  twins.

At the serving shapes the prefill and chunk kernels sit near the
balance of bytes and bf16 operations (bytes below about 700 rows).  The
causal prefill, the paged suffix chunk and the contiguous chunks (the
int8 one, and the bf16 one's wide chunks) are one tensor-core flash
kernel (``csrc/flash_tc.cuh``) with three tile sources: a block of 64
rows packs a kv head's GQA group (16 positions times nano's 4 heads),
stages each 128-key tile once for them through a ``cp.async`` ring,
scores it with ``mma.sync`` on two warps a 16-row slab keeping P in
registers, masks only the tiles that straddle a row's frontier and stops
at the block's furthest one.  A row gets the same bits from the prefill
and from a prefix hit's suffix chunk.  ``flash_tc_mirror`` below repeats
that algorithm in plain PyTorch for the tests.  The decode kernels are
bound by bytes: one query position per sequence does Nq / Nkv
multiply-adds per element of K/V read.  At B = 1, as the sequential
engines run, one block per (kv head, sequence) left 8 blocks on the
H100's 132 SMs; so the contiguous decode kernels are
``csrc/ragged_verify.cuh``'s split-K kernel reading the window's
64-position tiles through its strides: the window is split over many
blocks (``ragged_attention.decode_split_plan``, from shapes only: 2 tiles
a split at orin's B = 1 over an 8192 window, 144 live blocks at position
2255), each keeping its tiles' copies in flight by ``cp.async`` and
scoring on the tensor cores, and a merge pass combines each row's float32
partials.  The bf16 chunk kernel sends chunks of a few rows (the
sequential speculative verify) down the same split route at G = S_c
(``chunk_route``, from shapes only), each row's frontier read from its
position.  The dense tick's decode, bf16 and int8, is the same split
kernel over the pool at G = 1, as the ragged decode kernels run it
(``ragged_attention.ragged_decode_split_plan`` over the window's wb
blocks: at nano's 8 slots in a 2048 window, 4 blocks a split and 8
splits, 264 live blocks at the timed positions where one block per (kv
head, slot) was 64; at orin's 4 slots, 2 blocks a split and 16 splits,
184 live blocks where there were 32); its window ``tables[:, :wb]`` is a
column slice of the full table, read in place through the table's row
stride.  See each source for the design and its bound.

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
from .attention import (NEG_INF, _chunk_contiguous, _chunk_contiguous_q8,
                        _decode_contiguous, _decode_contiguous_q8,
                        _gather_chunk_paged, _gather_decode_windowed,
                        causal_attention)
from .ragged_attention import _MAX_GROUP
from .ragged_attention import _check as _check_paged
from .ragged_attention import (PADDED_D, _launch_verify, chunk_split_plan,
                               decode_split_plan, pad_head_dim)

# Head dims of the cold prefill and the paged chunk (16: the tiny test
# presets; 8, the tiny draft's, through the 16 instance: ``PADDED_D``),
# block sizes of the paged chunk, and head dims of the contiguous-cache
# kernels.  The tiny presets' sequential tiers (head dim 16, the bench's
# perf-steering leg) reach the contiguous-cache kernels through the 64
# instance, on zero-padded copies of q and the window with the true
# softmax scale (``_CACHE_PADDED_D``): exact, as ``PADDED_D`` is.
_SUPPORTED_D = (16, 64, 128)
_SUPPORTED_BS = (16, 32, 64, 128)
_CACHE_D = (64, 128)
_CACHE_PADDED_D = {16: 64}
TC_ROWS = 64        # query rows per block of the tensor-core flash kernel
TC_WARPS = 2        # warps a 16-row slab, each with its own flash state
TC_TILE = 128       # keys per staged tile, every other 16-key chunk a warp
TC_MAX_GROUP = TC_ROWS
_LOG2E = 1.4426950408889634


def _require(cond: bool, fn: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def _check_common(fn: str, q: torch.Tensor, named) -> None:
    for name, t in named:
        _require(t.device == q.device, fn, f"{name} on {t.device}, q on {q.device}")
        _require(t.is_contiguous(), fn, f"{name} must be contiguous")
    _require(q.is_contiguous(), fn, "q must be contiguous")


def _check_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse what the causal prefill kernel does not take."""
    fn = "flash_causal_attention"
    _require(q.dim() == 4 and k.dim() == 4, fn,
             "q must be [B, S, Nq, D] and k/v [B, S, Nkv, D]")
    b, s, nq, d = q.shape
    nkv = k.shape[2]
    _check_common(fn, q, (("k", k), ("v", v)))
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16, fn,
             "q/k/v must be bf16")
    _require(k.shape == v.shape == (b, s, nkv, d), fn,
             f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    _require(d in _SUPPORTED_D, fn, f"head dim {d} (need one of {_SUPPORTED_D})")
    _require(nq % nkv == 0 and nq // nkv <= TC_MAX_GROUP, fn,
             f"Nq={nq} must be a multiple of Nkv={nkv}, at most "
             f"{TC_MAX_GROUP} query heads per kv head")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.data_ptr() % 16 == 0, fn, f"{name} must be 16-byte aligned")


def _flash_causal_launch(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """K2's forward on CUDA tensors: launch ``csrc/flash_causal.cu``."""
    d_true = q.shape[-1]
    if d_true in PADDED_D:
        q, k, v = pad_head_dim(q, k, v)
    _check_causal(q, k, v)
    b, s, nq, d = q.shape
    nkv = k.shape[2]
    out = torch.empty_like(q)
    err = _build.entry("flash_causal")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, nq, nkv, d, d_true ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_causal")
    flash_causal_attention.launches += 1
    return out[..., :d_true]


class FlashCausal(torch.autograd.Function):
    """K2 under autograd, the JAX package's ``custom_vjp`` of the Pallas
    kernel: the forward launches the kernel and saves q/k/v; the backward
    is autograd of the plain ``causal_attention``, recomputed from them
    (JAX's ``_flash_bwd`` is the XLA VJP of the plain function).  K2 has
    no backward kernel, in JAX or here.  The recompute runs in float32
    and each gradient is rounded to its input's dtype once: in bf16 the
    VJP's softmax backward cancels (a causal row's first query has a
    zero gradient), so its dq rows can sit far beyond a bf16 rounding of
    float32's; these are within one."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _flash_causal_launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        q, k, v = (t.detach().float().requires_grad_(True) for t in saved)
        with torch.enable_grad():
            out = causal_attention(q, k, v)
        grads = torch.autograd.grad(out, (q, k, v), grad_out.float())
        return tuple(g.to(t.dtype) for g, t in zip(grads, saved))


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """q [B, S, Nq, D], k/v [B, S, Nkv, D] -> [B, S, Nq, D]; row r attends
    keys 0 .. r, query head h reads kv head h // (Nq / Nkv).  On CUDA
    tensors, ``FlashCausal`` (the kernel, differentiable); a serving call
    under ``no_grad`` gets the kernel's bits unchanged."""
    if not q.is_cuda:
        return causal_attention(q, k, v)
    return FlashCausal.apply(q, k, v)


def _check_paged_chunk(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       start: torch.Tensor, window: int) -> None:
    """Refuse what the paged chunk kernel does not take."""
    fn = "paged_chunk_attention"
    nq, d = q.shape[2:]
    nkv, _, bs, dk = k_pool.shape
    _check_common(fn, q, (("k_pool", k_pool), ("v_pool", v_pool),
                          ("table", table), ("start", start)))
    _require(q.shape[0] == 1, fn, "one slot per call (q batch must be 1)")
    _require(q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16, fn,
             "q and pools must be bf16")
    _require(table.dtype == torch.int32 and start.dtype == torch.int32, fn,
             "table and start must be int32")
    _require(v_pool.shape == k_pool.shape, fn, "k_pool/v_pool shapes differ")
    _require(dk == d and d in _SUPPORTED_D, fn,
             f"head dim {d} (need one of {_SUPPORTED_D})")
    _require(bs in _SUPPORTED_BS, fn,
             f"block size {bs} (need one of {_SUPPORTED_BS})")
    _require(nq % nkv == 0 and nq // nkv <= TC_MAX_GROUP, fn,
             f"Nq={nq} must be a multiple of Nkv={nkv}, at most "
             f"{TC_MAX_GROUP} query heads per kv head")
    _require(q.data_ptr() % 16 == 0, fn, "q must be 16-byte aligned")
    _require(window % bs == 0 and 0 < window // bs <= table.shape[0], fn,
             f"window {window} must be a multiple of bs={bs} within the table")
    _require(start.numel() == 1, fn, "start must hold one position")


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
    d_true = q.shape[-1]
    if d_true in PADDED_D:
        q, k_pool, v_pool = pad_head_dim(q, k_pool, v_pool)
    _check_paged_chunk(q, k_pool, v_pool, table, start, window)
    _, s_c, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    err = _build.entry("paged_chunk")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        start.data_ptr(), out.data_ptr(), s_c, nq, nkv, nb, bs, d,
        window // bs, d_true ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_chunk")
    paged_chunk_attention.launches += 1
    return out[..., :d_true]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's pools [Nkv, NB, bs, D] bf16, tables
    [B, wb] int32 (a window of each slot's row; a column slice of the
    full table is read in place), pos [B] int32 with every pos < wb * bs
    -> [B, Nq, D]; slot b attends positions 0 .. pos[b] (the split kernel
    at G = 1, planned over the window's wb blocks)."""
    if not q.is_cuda:
        return _gather_decode_windowed(q, k_pool, v_pool, tables, pos)
    _check_paged("paged_decode_attention", q, k_pool, v_pool, tables, pos,
                 None, None, 1, strided_tables=True)
    out = _launch_verify("paged_decode", q[:, None], k_pool, v_pool, (),
                         tables, pos)
    paged_decode_attention.launches += 1
    return out[:, 0]


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
    _check_paged("paged_decode_attention_q8", q, k_pool, v_pool, tables, pos,
                 k_scale, v_scale, 1, strided_tables=True)
    out = _launch_verify("paged_decode_q8", q[:, None], k_pool, v_pool,
                         (k_scale, v_scale), tables, pos)
    paged_decode_attention_q8.launches += 1
    return out[:, 0]


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
    _require(d in _CACHE_D, fn, f"head dim {d} (need one of {_CACHE_D})")
    want = torch.int8 if q8 else torch.bfloat16
    _require(k.dtype == v.dtype == want, fn, f"k/v must be {want}")
    _require(k.stride()[1:] == (nkv * d, d, 1) and v.stride() == k.stride(),
             fn, "k/v rows must be dense [Nkv, D] (only the batch stride is "
             "free)")
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, fn, f"{name} on {t.device}, q on {q.device}")
        _require(t.data_ptr() % 16 == 0
                 and t.stride(0) * t.element_size() % 16 == 0, fn,
                 f"{name} must be 16-byte aligned, rows and batch stride")
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
    _require(q.dtype == torch.bfloat16 and q.is_contiguous()
             and q.data_ptr() % 16 == 0, fn,
             "q must be contiguous bf16, 16-byte aligned")
    _require(nq % nkv == 0 and nq // nkv <= max_group, fn,
             f"Nq={nq} must be a multiple of Nkv={nkv}, at most {max_group} "
             "query heads per kv head")
    _require(positions.device == q.device and positions.dtype == torch.int32
             and positions.is_contiguous()
             and positions.shape == q.shape[:-2], fn,
             f"positions must be contiguous int32 {tuple(q.shape[:-2])}")


def _check_window(fn: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], positions: torch.Tensor,
                  q_dims: int, max_group: int):
    """Refuse what a contiguous-cache kernel does not take: q of
    ``q_dims`` dims, the window (and an int8 window's scales), the
    positions.  Returns (W, Nkv, kv batch stride, scale batch stride)."""
    _require(q.dim() == q_dims, fn,
             "q must be [B, Nq, D]" if q_dims == 3 else
             "q must be [B, S_c, Nq, D]")
    q8 = k_scale is not None
    w, nkv, kv_bstride = _check_cache(fn, q, k, v, q8)
    sc_bstride = _check_scales(fn, k, k_scale, v_scale) if q8 else 0
    _check_query(fn, q, nkv, positions, max_group)
    return w, nkv, kv_bstride, sc_bstride


def pad_cache_head_dim(*tensors: torch.Tensor) -> tuple:
    """Each tensor's last (head) dim zero-padded to its ``_CACHE_PADDED_D``
    instance, contiguous (a window's copy keeps no batch stride)."""
    return tuple(torch.nn.functional.pad(
        t, (0, _CACHE_PADDED_D[t.shape[-1]] - t.shape[-1])).contiguous()
        for t in tensors)


def _padded_window(launch, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """``launch(q, k, v, scale)`` on the kernel's own head dim: a head dim
    in ``_CACHE_PADDED_D`` runs on zero-padded copies with its true scale,
    and the padded columns are cut off the output."""
    d = q.shape[-1]
    if d in _CACHE_PADDED_D:
        q, k, v = pad_cache_head_dim(q, k, v)
    return launch(q, k, v, d ** -0.5)[..., :d]


def _launch_window(wrapper, name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, k_scale: Optional[torch.Tensor],
                   v_scale: Optional[torch.Tensor], positions: torch.Tensor,
                   window: tuple, plan: Optional[tuple],
                   scale: float) -> torch.Tensor:
    """Launch contiguous-cache kernel ``name`` on inputs ``_check_window``
    passed (``window`` is what it returned) at softmax ``scale`` and count
    the launch on ``wrapper``.  ``plan`` (tiles per split, splits) takes the split route,
    with float32 partials that are scratch of this call; None the
    tensor-core route (the entry reads no scratch at 0 tiles a split)."""
    w, nkv, kv_bstride, sc_bstride = window
    b, s_q = q.shape[0], q.shape[1] if q.dim() == 4 else 1
    nq, d = q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    scratch, tiles, splits = (None, None), 0, 0
    if plan is not None:
        tiles, splits = plan
        shape = (b, nkv, splits, nq // nkv * s_q)
        part_acc = torch.empty(shape + (d,), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(shape + (2,), dtype=torch.float32,
                              device=q.device)
        scratch = (part_acc.data_ptr(), part_ml.data_ptr())
    q8 = k_scale is not None
    err = _build.entry(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if q8 else None, v_scale.data_ptr() if q8 else None,
        positions.data_ptr(), out.data_ptr(), *scratch, b, s_q, nq, nkv, d, w,
        tiles, splits, kv_bstride, sc_bstride, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)
    wrapper.launches += 1
    return out


def _decode_window(wrapper, name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, k_scale: Optional[torch.Tensor],
                   v_scale: Optional[torch.Tensor],
                   pos: torch.Tensor) -> torch.Tensor:
    """A contiguous decode kernel (K9, K10): the split route at G = 1,
    planned by ``decode_split_plan`` from shapes alone."""
    def launch(q, k, v, scale):
        window = _check_window(wrapper.__name__, q, k, v, k_scale, v_scale,
                               pos, q_dims=3, max_group=_MAX_GROUP)
        w, nkv = window[:2]
        return _launch_window(wrapper, name, q, k, v, k_scale, v_scale, pos,
                              window, decode_split_plan(w, q.shape[0], nkv),
                              scale)
    return _padded_window(launch, q, k, v)


# The bf16 contiguous chunk kernel (K11) takes one of two routes, chosen
# from shapes alone by ``chunk_route``.  A chunk whose block rows (the
# group's heads x its S_c positions) fit one split-kernel block, at most
# SPLIT_MAX_ROWS (three 16-row tensor-core tiles), is the split-K kernel
# over the window at G = S_c, each row's frontier read from q_positions:
# the sequential speculative verify's 4 x 5 = 20 rows at orin, whose one
# block per kv head would leave 8 blocks on the card.  A wider chunk is the
# tensor-core flash kernel, the int8 chunk kernel's bf16 instance.  Both
# count as one kernel on ``flash_chunk_attention.launches``, and by route
# on its ``route_launches``.
SPLIT_MAX_ROWS = 48


def chunk_route(s_c: int, nq: int, nkv: int) -> str:
    """The bf16 chunk kernel's route for ``s_c`` positions of ``nq`` query
    heads over ``nkv`` kv heads: "split" or "tc" (shapes in, nothing read
    from the device)."""
    return "split" if nq // nkv * s_c <= SPLIT_MAX_ROWS else "tc"


def _split_chunk(wrapper, name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, q_positions: torch.Tensor) -> torch.Tensor:
    """The bf16 chunk kernel's split route: at most SPLIT_MAX_ROWS block
    rows, planned by ``chunk_split_plan`` from shapes alone."""
    fn = wrapper.__name__

    def launch(q, k, v, scale):
        window = _check_window(fn, q, k, v, None, None, q_positions,
                               q_dims=4, max_group=SPLIT_MAX_ROWS)
        w, nkv = window[:2]
        b, s_c, nq, d = q.shape
        rows = nq // nkv * s_c
        _require(rows <= SPLIT_MAX_ROWS, fn,
                 f"{rows} block rows (group x S_c) on the split route, at "
                 f"most {SPLIT_MAX_ROWS}")
        return _launch_window(wrapper, name, q, k, v, None, None,
                              q_positions, window,
                              chunk_split_plan(w, b, nkv, rows, d), scale)
    return _padded_window(launch, q, k, v)


def _tc_chunk(wrapper, name: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, k_scale: Optional[torch.Tensor],
              v_scale: Optional[torch.Tensor],
              q_positions: torch.Tensor) -> torch.Tensor:
    """A chunk on the tensor-core flash kernel (K12, K11's wide chunks):
    a group of at most TC_MAX_GROUP, no plan."""
    def launch(q, k, v, scale):
        window = _check_window(wrapper.__name__, q, k, v, k_scale, v_scale,
                               q_positions, q_dims=4,
                               max_group=TC_MAX_GROUP)
        return _launch_window(wrapper, name, q, k, v, k_scale, v_scale,
                              q_positions, window, None, scale)
    return _padded_window(launch, q, k, v)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B, Nq, D], one layer's cache [B, W, Nkv, D], pos [B] int32 ->
    [B, Nq, D]; row h attends kv head h // (Nq / Nkv) at positions
    0 .. pos[b]."""
    if not q.is_cuda:
        return _decode_contiguous(q, k_cache, v_cache, pos)
    return _decode_window(flash_decode_attention, "flash_decode", q, k_cache,
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
    return _decode_window(flash_decode_attention_q8, "flash_decode_q8", q,
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
    _require(q.dim() == 4, "flash_chunk_attention",
             "q must be [B, S_c, Nq, D]")
    route = chunk_route(q.shape[1], q.shape[2], k_cache.shape[-2])
    if route == "split":
        out = _split_chunk(flash_chunk_attention, "flash_chunk", q, k_cache,
                           v_cache, q_positions)
    else:
        out = _tc_chunk(flash_chunk_attention, "flash_chunk", q, k_cache,
                        v_cache, None, None, q_positions)
    flash_chunk_attention.route_launches[route] += 1
    return out


def flash_chunk_attention_q8(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor,
                             q_positions: torch.Tensor) -> torch.Tensor:
    """``flash_chunk_attention`` over an int8 window [B, W, Nkv, D] with
    float32 row scales [B, W, Nkv], dequantized in the kernel."""
    if not q.is_cuda:
        return _chunk_contiguous_q8(q, k_cache, v_cache, k_scale, v_scale,
                                    q_positions)
    return _tc_chunk(flash_chunk_attention_q8, "flash_chunk_q8", q, k_cache,
                     v_cache, k_scale, v_scale, q_positions)


# -- the tensor-core flash kernel's algorithm in plain PyTorch (tests only) --

def flash_tc_grid(s_q: int, nq: int, nkv: int, b: int):
    """The tensor-core flash kernel's grid for ``s_q`` query positions,
    ``nq`` query heads over ``nkv`` kv heads and ``b`` sequences: (query
    tiles, kv heads, sequences), a query tile being TC_ROWS // group
    positions times the group's heads."""
    per_block = TC_ROWS // (nq // nkv)
    return -(-s_q // per_block), nkv, b


def flash_tc_mirror(q, k, v, q_positions=None, k_scale=None, v_scale=None,
                    p_dtype=torch.bfloat16, stats=None):
    """The tensor-core flash kernel (``csrc/flash_tc.cuh``: the causal
    prefill K2, the int8 chunk K12 and the paged chunk K3) in plain
    float32 PyTorch, block by block as the card runs it.

    q [B, S_q, Nq, D]; k/v [B, W, Nkv, D], bf16 or float32, or int8 with
    float32 row scales [B, W, Nkv]; ``q_positions`` [B, S_q] (each row's
    frontier min(position, W - 1)), or None for the prefill's implicit
    positions (row i at i, W = S_q).  (K3's table-gathered window is the
    first W positions of its slot, rows at start + r.)  A block owns one
    kv head and TC_ROWS rows, the group's heads at TC_ROWS // group
    positions, in four 16-row slabs of TC_WARPS warps.  It walks TC_TILE-key
    tiles up to its furthest frontier (keys past it zero-filled, never
    read); warp j of a slab scores the tile's 16-key chunks j, j + 2, ...
    with its own flash state, and a slab's two states merge at the end.  Per slab a tile past every row's frontier is skipped,
    one at or below every real row's frontier runs unmasked, and only a
    tile that straddles one is masked.  Scores are in log2 units (scale
    times log2 e, and the int8 K row scale); the int8 V row scale is folded
    into P, and P is rounded to ``p_dtype`` before PV (bf16 on the card;
    float32 gives the plain versions' arithmetic).  ``stats``, a dict,
    counts tiles loaded and slab-tiles run masked, unmasked and skipped.
    Returns [B, S_q, Nq, D] float32."""
    b, s_q, nq, d = q.shape
    w, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    per_block = TC_ROWS // group
    tile, kw = TC_TILE, TC_WARPS
    if q_positions is None:
        q_positions = torch.arange(s_q).expand(b, s_q)
    front = torch.clamp(q_positions.long(), max=w - 1)
    kf, vf = k.float(), v.float()                 # int8 widened exactly
    q8 = k_scale is not None
    qk_scale = d ** -0.5 * _LOG2E
    # owner[j, c]: key c of a tile belongs to warp j of its slab.
    owner = (torch.arange(tile) // 16 % kw)[None] == torch.arange(kw)[:, None]
    out = torch.zeros((b, s_q, nq, d), dtype=torch.float32)
    stats = {} if stats is None else stats
    for key in ("tiles", "masked", "unmasked", "skipped"):
        stats.setdefault(key, 0)
    n_qt, _, _ = flash_tc_grid(s_q, nq, nkv, b)
    for bi in range(b):
        for hk in range(nkv):
            heads = slice(hk * group, (hk + 1) * group)
            for qt in range(n_qt):
                i0 = qt * per_block
                n_pos = min(per_block, s_q - i0)
                rows = n_pos * group
                qb = torch.zeros((TC_ROWS, d))
                qb[:rows] = q[bi, i0:i0 + n_pos, heads].reshape(rows, d).float()
                f = torch.full((TC_ROWS,), -1, dtype=torch.long)
                f[:rows] = front[bi, i0:i0 + n_pos].repeat_interleave(group)
                real = torch.arange(TC_ROWS) < rows
                last = int(f[:rows].max())
                # Per 16-row slab: padded rows mask nothing.
                slab_f = torch.where(real, f, 1 << 30).view(4, 1, 16)
                slab_min = slab_f.amin(-1)[:, 0]
                slab_max = torch.where(real, f, -1).view(4, 16).amax(1)
                qs = qb.view(4, 1, 16, d)
                m = torch.full((4, kw, 16), NEG_INF)
                l = torch.zeros((4, kw, 16))
                acc = torch.zeros((4, kw, 16, d))
                for t0 in range(0, last + 1, tile):
                    stats["tiles"] += 1
                    keys = torch.arange(t0, t0 + tile)
                    read = keys <= last
                    kt, vt = torch.zeros((tile, d)), torch.zeros((tile, d))
                    kt[read] = kf[bi, keys[read], hk]
                    vt[read] = vf[bi, keys[read], hk]
                    x = torch.einsum("sjrd,kd->sjrk", qs, kt) * qk_scale
                    if q8:
                        kst, vst = torch.zeros(tile), torch.zeros(tile)
                        kst[read] = k_scale[bi, keys[read], hk].float()
                        vst[read] = v_scale[bi, keys[read], hk].float()
                        x = x * kst
                    live = t0 <= slab_max
                    straddle = live & (t0 + tile - 1 > slab_min)
                    below = keys <= slab_f[..., None]          # [4, 1, 16, T]
                    assert below[live & ~straddle].all()   # unmasked: all valid
                    stats["masked"] += int(straddle.sum())
                    stats["unmasked"] += int((live & ~straddle).sum())
                    stats["skipped"] += int((~live).sum())
                    valid = (live[:, None, None, None]
                             & (~straddle[:, None, None, None] | below)
                             & owner[None, :, None, :])    # [4, kw, 16, T]
                    x = torch.where(valid, x, NEG_INF)
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(x - m_new[..., None]),
                                    0.0)
                    l = l * alpha + p.sum(-1)
                    if q8:
                        p = p * vst
                    p = p.to(p_dtype).float()
                    acc = acc * alpha[..., None] + torch.einsum(
                        "sjrk,kd->sjrd", p, vt)
                    m = m_new
                # Merge the slab's warps: M = max m_j, weights 2^(m_j - M).
                wgt = torch.exp2(m - m.amax(1, keepdim=True))
                l = (l * wgt).sum(1)
                acc = (acc * wgt[..., None]).sum(1)
                o = (acc / l.clamp_min(1e-30)[..., None]).view(TC_ROWS, d)
                out[bi, i0:i0 + n_pos, heads] = o[:rows].view(n_pos, group, d)
    return out


flash_causal_attention.launches = 0
paged_chunk_attention.launches = 0
paged_decode_attention.launches = 0
paged_decode_attention_q8.launches = 0
flash_decode_attention.launches = 0
flash_decode_attention_q8.launches = 0
flash_chunk_attention.launches = 0
flash_chunk_attention.route_launches = {"split": 0, "tc": 0}
flash_chunk_attention_q8.launches = 0
