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
dequantized window never reaches device memory.  All four are one
split-K kernel (``csrc/ragged_verify.cuh``), the decode kernels at
G = 1: each slot's blocks are split over many blocks and the float32
partials merged in a second pass, with the products on the tensor cores.
The plans are functions of shapes only, so the wrappers read nothing
from the device: ``split_plan`` for the verify kernels (8 blocks a split
at orin's 4-slot pool, 192 live blocks at its timed verify),
``ragged_decode_split_plan`` for the decode kernels (16 blocks a split
at nano's 8-slot pool, 176 live blocks at its timed batch; 8 at the
nano draft's and orin's 4 slots).  The kernel reads a slot's table row
through the table's row stride, so the dense windowed tick's decode
(``flash_attention.paged_decode_attention`` and its int8 twin) runs it
too, over a column slice ``tables[:, :wb]`` of the full table (4 blocks a
split at nano's 2048 window, 2 at orin's).

A CPU tensor takes the plain version (``_gather_decode_paged`` /
``_gather_verify_paged``, the JAX package's XLA paths); a CUDA tensor
launches the kernel or raises.  ``split_verify_mirror`` repeats the
split kernel's split-and-merge algorithm over the pool in plain PyTorch
for the tests (the verify kernels, and the decode kernels at G = 1),
and ``split_window_mirror`` the same algorithm over a contiguous cache
window, as the contiguous decode kernels and the bf16 chunk kernel's
split route run it (``flash_attention.py``, planned by
``decode_split_plan`` / ``chunk_split_plan``); no serving path calls
either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .attention import (NEG_INF, _gather_decode_paged, _gather_pool_seq,
                        _gather_verify_paged)

_SUPPORTED_D = (64, 128)
_SUPPORTED_BS = (32, 64, 128)
_MAX_GROUP = 8
# Query rows one block serves (kv-head group x verify positions); the
# verify kernels pad them to at most three 16-row tensor-core tiles.
_MAX_ROWS = 40

# The verify kernels' split-K plan.  A split is at least SPLIT_MIN_TILES
# tiles, so that its float32 partials (written once, read once by the
# merge) stay a small share of the K/V bytes it reads: at D = 128, bs = 64
# and 20 rows, 8 tiles read 256 KB of bf16 K/V (135 KB int8) against
# 21 KB of partials written and read, 8% (15%).  Above that the split is as fine as
# SPLIT_TARGET_BLOCKS blocks over a batch of full slots asks: four per SM
# of the H100's 132, so that a skewed batch, whose short slots take one
# split each, still has more live blocks than SMs (192 at orin's timed
# verify: MB = 128, 8 tiles a split).
SPLIT_MIN_TILES = 8
SPLIT_TARGET_BLOCKS = 4 * 132


def split_plan(mb: int, b: int, nkv: int) -> Tuple[int, int]:
    """(tiles per split, splits) of the verify kernels for a table of
    ``mb`` blocks per slot, ``b`` slots and ``nkv`` kv heads: shapes in,
    ints out, nothing read from the device.  Splits past a slot's
    frontier exit at once on the card."""
    per_slot = -(-SPLIT_TARGET_BLOCKS // (nkv * b))
    tiles = max(SPLIT_MIN_TILES, -(-mb // per_slot))
    return tiles, -(-mb // tiles)


# The decode kernels on the split kernel run its split pass at G = 1: the
# ragged decode kernels (``ragged_paged_decode_attention`` and its int8
# twin) over each slot's pool blocks, the dense tick's decode
# (``flash_attention.paged_decode_attention`` and its int8 twin) over a
# window of them, the contiguous decode kernels
# (``flash_attention.flash_decode_attention`` and its int8 twin) over
# DECODE_TILE-position tiles of the cache window.
# A decode block holds only the group's Nq / Nkv rows, so its partials
# (4 x D floats at orin, 2 KB) are small beside even one tile of K and V
# (32 KB bf16 at D = 128, 17 KB int8 with its scales): a split may be a
# single tile, with no SPLIT_MIN_TILES floor.  Splits are as fine as
# SPLIT_TARGET_BLOCKS blocks over the whole table or window ask, so that a
# slot a quarter of the way into its context still has more live blocks
# than the card has SMs: orin at B = 1 and W = 8192 gets 2 tiles a split
# and 64 splits, 144 live blocks at the served position 2255; orin's int8
# pool at B = 4 and MB = 128 gets 8 blocks a split and 16 splits, 128 live
# blocks for a slot at its end; nano's bf16 pool at B = 8 gets 16 blocks a
# split and 8 splits; the dense tick in a 2048 window (wb = 32) 4 blocks
# a split and 8 splits at nano's B = 8, 2 and 16 at orin's B = 4.
DECODE_TILE = 64


def _fine_split(n_tiles: int, b: int, nkv: int) -> Tuple[int, int]:
    """(tiles per split, splits) as fine as SPLIT_TARGET_BLOCKS blocks over
    ``b`` sequences of ``n_tiles`` tiles and ``nkv`` kv heads ask."""
    tiles = -(-(b * nkv * n_tiles) // SPLIT_TARGET_BLOCKS)
    return tiles, -(-n_tiles // tiles)


def decode_split_plan(w: int, b: int, nkv: int) -> Tuple[int, int]:
    """(tiles per split, splits) of the contiguous decode kernels for a
    window of ``w`` positions, ``b`` sequences and ``nkv`` kv heads:
    shapes in, ints out, nothing read from the device."""
    return _fine_split(-(-w // DECODE_TILE), b, nkv)


def ragged_decode_split_plan(mb: int, b: int, nkv: int) -> Tuple[int, int]:
    """(blocks per split, splits) of the decode kernels over the pool (the
    ragged decode and the dense tick's decode, bf16 and int8) for a
    table or window of ``mb`` blocks per slot, ``b`` slots and ``nkv`` kv
    heads: shapes in, ints out, nothing read from the device."""
    return _fine_split(mb, b, nkv)


# The bf16 chunk kernel's split route (``flash_attention.chunk_route``:
# the sequential speculative verify's few rows) runs the split pass at
# G = S_c over the window's tiles.  Its block holds group x S_c rows (20 at
# orin's 5-row verify), so its partials are larger than a decode block's;
# the plan is the decode plan, but a split never reads fewer bytes of K/V
# than its partials move (2 x rows x (D + 2) floats, written once and read
# once).  At orin's verify (20 rows, D = 128, W = 8192) that floor is one
# tile, so T = 2: the partials, 21 KB, are a third of the split's 64 KB of
# K/V, and at position 3000 the 47 live tiles are 24 splits, 192 live
# blocks, two an SM in one wave.  T = 4 would halve that share but leave
# 96 blocks on 132 SMs and double each block's walk; at B = 1 the walk's
# latency, not the bytes, sets the time (the bound is 0.004 ms).
def chunk_split_plan(w: int, b: int, nkv: int, rows: int,
                     d: int) -> Tuple[int, int]:
    """(tiles per split, splits) of the bf16 chunk kernel's split route for
    a window of ``w`` positions, ``b`` sequences, ``nkv`` kv heads and
    ``rows`` rows a block (group x S_c) at head dim ``d``: shapes in, ints
    out, nothing read from the device."""
    n_tiles = -(-w // DECODE_TILE)
    tiles, _ = _fine_split(n_tiles, b, nkv)
    partial_bytes = 2 * rows * (d + 2) * 4
    tile_bytes = 2 * DECODE_TILE * d * 2            # one bf16 K/V tile pair
    tiles = max(tiles, -(-partial_bytes // tile_bytes))
    return tiles, -(-n_tiles // tiles)


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
    _check("ragged_paged_decode_attention", q, k_pool, v_pool, tables, pos,
           None, None, 1)
    out = _launch_verify("ragged_decode", q[:, None], k_pool, v_pool, (),
                         tables, pos)
    ragged_paged_decode_attention.launches += 1
    return out[:, 0]


def ragged_paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor, tables: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """q [B, G, Nq, D] (the G = γ+1 verify chunk of each slot, query g at
    position pos[b] + g, K/V already written), one layer's pools
    [Nkv, NB, bs, D] bf16, tables [B, MB] int32, pos [B] int32 the FIRST
    query's position -> [B, G, Nq, D]; row g attends 0 .. pos[b] + g."""
    if not q.is_cuda:
        return _gather_verify_paged(q, k_pool, v_pool, tables, pos)
    _check("ragged_paged_verify_attention", q, k_pool, v_pool, tables, pos,
           None, None, q.shape[1])
    out = _launch_verify("ragged_verify", q, k_pool, v_pool, (), tables, pos)
    ragged_paged_verify_attention.launches += 1
    return out


# Entries of the split kernel at G = 1 (they take no G), planned by
# ``ragged_decode_split_plan``; the dense tick's ``paged_decode`` and
# ``paged_decode_q8`` also take the table's row stride (their window is a
# column slice).
_DECODE_ENTRIES = ("ragged_decode", "ragged_decode_q8", "paged_decode",
                   "paged_decode_q8")
_STRIDED_ENTRIES = ("paged_decode", "paged_decode_q8")


def _launch_verify(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, scales: tuple, tables: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Launch split kernel ``name`` (its split and merge passes) on
    checked inputs, q [B, G, Nq, D]; ``scales`` is () for a bf16 pool,
    (k_scale, v_scale) for an int8 one.  The verify kernels are planned by
    ``split_plan``, the decode kernels (``_DECODE_ENTRIES``, G = 1) by
    ``ragged_decode_split_plan``.  The float32 partials are scratch of
    this call."""
    b, g, nq, d = q.shape
    nkv, nb, bs, _ = k_pool.shape
    mb = tables.shape[1]
    decode = name in _DECODE_ENTRIES
    plan = ragged_decode_split_plan if decode else split_plan
    tiles, splits = plan(mb, b, nkv)
    rows = nq // nkv * g
    out = torch.empty_like(q)
    part_acc = torch.empty((b, nkv, splits, rows, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, nkv, splits, rows, 2), dtype=torch.float32,
                          device=q.device)
    stride = (tables.stride(0),) if name in _STRIDED_ENTRIES else ()
    err = _build.entry(name)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        *(t.data_ptr() for t in scales), tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b,
        *(() if decode else (g,)), nq, nkv, nb, bs, d, mb, tiles, splits,
        *stride, d ** -0.5, _stream(q))
    _build.check(err, name)
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
    _check("ragged_paged_decode_attention_q8", q, k_pool, v_pool, tables, pos,
           k_scale, v_scale, 1)
    out = _launch_verify("ragged_decode_q8", q[:, None], k_pool, v_pool,
                         (k_scale, v_scale), tables, pos)
    ragged_paged_decode_attention_q8.launches += 1
    return out[:, 0]


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
    _check("ragged_paged_verify_attention_q8", q, k_pool, v_pool, tables,
           pos, k_scale, v_scale, q.shape[1])
    out = _launch_verify("ragged_verify_q8", q, k_pool, v_pool,
                         (k_scale, v_scale), tables, pos)
    ragged_paged_verify_attention_q8.launches += 1
    return out


# -- the split kernel's algorithm in plain PyTorch (tests only) --------------

def _row_frontiers(pos, g: int):
    """[B, G] frontiers of a split kernel's queries: ``pos`` [B] is the
    first query's position over the pool (query g at pos + g), ``pos``
    [B, G] each query's own frontier (a window's, already clamped to
    W - 1)."""
    if pos.dim() == 2:
        return pos.long()
    return pos.long()[:, None] + torch.arange(g, device=pos.device)


def split_verify_partials(q, k_pool, v_pool, tables, pos, tiles: int,
                          k_scale=None, v_scale=None):
    """The split kernel's split pass, in float32: for every (slot, kv
    head, split of ``tiles`` tiles, row) the partial (m, l, acc) of the
    row's scores over the split's keys, rows r = head_in_group * G + g,
    row r's frontier ``_row_frontiers(pos, G)[:, g]``.
    Returns m, l [B, Nkv, S, R] and acc [B, Nkv, S, R, D].  A row that
    sees no key of a split (its frontier ends before the split, or the
    split lies past the slot's frontier) has m = NEG_INF, l = 0, acc = 0.
    m is in natural-log units (the kernel keeps log2 units) and P stays
    float32 (the kernel rounds it to bf16 for PV)."""
    b, g, nq, d = q.shape
    nkv, bs = k_pool.shape[0], k_pool.shape[2]
    mb = tables.shape[1]
    splits = -(-mb // tiles)
    grp = nq // nkv
    rows = grp * g
    k_seq, v_seq = _gather_pool_seq(k_pool, v_pool, tables, k_scale, v_scale,
                                    torch.float32)
    k_seq, v_seq = k_seq.float(), v_seq.float()         # [B, MB*bs, Nkv, D]
    pad = splits * tiles * bs - mb * bs
    k_seq = torch.nn.functional.pad(k_seq, (0, 0, 0, 0, 0, pad))
    v_seq = torch.nn.functional.pad(v_seq, (0, 0, 0, 0, 0, pad))
    qr = q.float().reshape(b, g, nkv, grp, d).permute(0, 2, 3, 1, 4).reshape(
        b, nkv, rows, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qr, k_seq) * d ** -0.5
    row_g = torch.arange(rows, device=q.device) % g
    frontier = _row_frontiers(pos, g)[:, row_g]              # [B, R]
    cols = torch.arange(s.shape[-1], device=q.device)
    valid = (cols[None, None] <= frontier[:, :, None])[:, None].expand(s.shape)
    shape = (b, nkv, rows, splits, tiles * bs)
    s = s.masked_fill(~valid, NEG_INF).reshape(shape)
    valid = valid.reshape(shape)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhrsk,bskhd->bhrsd", p,
                       v_seq.reshape(b, splits, tiles * bs, nkv, d))
    return (m.transpose(2, 3), p.sum(-1).transpose(2, 3),
            acc.transpose(2, 3))


def merge_split_partials(m, l, acc, pos, g: int, bs: int, mb: int,
                         tiles: int):
    """The split kernel's merge pass: each row's partials over the splits
    its slot's furthest frontier reaches (worked out from ``pos``, as in
    ``split_verify_partials``), M = max m_s, L = sum l_s e^(m_s - M),
    O = sum acc_s e^(m_s - M) / max(L, 1e-30); an empty partial (l = 0)
    weighs 0.  Returns [B, G, Nq, D] float32."""
    b, nkv, splits, rows, d = acc.shape
    last = _row_frontiers(pos, g).amax(1)
    n_tiles = torch.clamp(last // bs + 1, max=mb)
    live = (torch.arange(splits, device=acc.device)[None]
            < (-(-n_tiles // tiles))[:, None])[:, None, :, None]
    m = torch.where(live, m, NEG_INF)                  # dead splits: unread
    l = torch.where(live, l, 0.0)
    acc = torch.where(live[..., None], acc, 0.0)
    w = torch.where(l > 0, torch.exp(m - m.amax(2, keepdim=True)), 0.0)
    out = ((acc * w[..., None]).sum(2)
           / (l * w).sum(2).clamp_min(1e-30)[..., None])   # [B, Nkv, R, D]
    grp = rows // g
    return out.reshape(b, nkv, grp, g, d).permute(0, 3, 1, 2, 4).reshape(
        b, g, nkv * grp, d)


def split_verify_mirror(q, k_pool, v_pool, tables, pos, tiles: int,
                        k_scale=None, v_scale=None):
    """The split kernel's whole algorithm over the pool in plain float32
    PyTorch, with ``tiles`` tiles per split: ``split_verify_partials`` then
    ``merge_split_partials`` -> [B, G, Nq, D] float32.  The verify kernels
    at q [B, G, Nq, D]; the decode kernels over the pool at G = 1 (the
    dense tick's decode with its window as ``tables``)."""
    m, l, acc = split_verify_partials(q, k_pool, v_pool, tables, pos, tiles,
                                      k_scale, v_scale)
    return merge_split_partials(m, l, acc, pos, q.shape[1], k_pool.shape[2],
                                tables.shape[1], tiles)


def window_as_pool(k_cache, v_cache, k_scale=None, v_scale=None):
    """A contiguous cache window [B, W, Nkv, D] (+ scales [B, W, Nkv]) as
    the decode kernels tile it: a pool [Nkv, B * MB, DECODE_TILE, D] of
    each sequence's MB = ceil(W / DECODE_TILE) tiles in order (the ragged
    end zero-filled, as the kernels' copies fill it), scales
    [Nkv, B * MB, DECODE_TILE] and tables [B, MB] naming them.  Returns
    k_pool, v_pool, k_scale, v_scale (None for bf16) and tables."""
    b, w, nkv, d = k_cache.shape
    mb = -(-w // DECODE_TILE)
    pad = mb * DECODE_TILE - w

    def tiles(x):
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.reshape(b * mb, DECODE_TILE, *x.shape[2:])
        return x.movedim(2, 0).contiguous()

    scales = ((None, None) if k_scale is None
              else (tiles(k_scale), tiles(v_scale)))
    tables = torch.arange(b * mb, dtype=torch.int32,
                          device=k_cache.device).reshape(b, mb)
    return tiles(k_cache), tiles(v_cache), *scales, tables


def split_window_mirror(q, k_cache, v_cache, q_pos, tiles: int,
                        k_scale=None, v_scale=None):
    """The split kernel's whole algorithm over a contiguous cache window
    in plain float32 PyTorch, with ``tiles`` tiles per split: q
    [B, G, Nq, D], q_pos [B, G]; the window tiled as a pool
    (``window_as_pool``), each query's frontier its own position clamped to
    W - 1, and the split and merge passes -> [B, G, Nq, D] float32.  The
    bf16 chunk kernel's split route at G = S_c."""
    k_pool, v_pool, ks, vs, tables = window_as_pool(k_cache, v_cache,
                                                    k_scale, v_scale)
    front = torch.clamp(q_pos, max=k_cache.shape[1] - 1)
    return split_verify_mirror(q, k_pool, v_pool, tables, front, tiles, ks,
                               vs)


def split_decode_mirror(q, k_cache, v_cache, pos, tiles: int, k_scale=None,
                        v_scale=None):
    """The contiguous decode kernels' whole algorithm: ``split_window_mirror``
    at G = 1, q [B, Nq, D] and pos [B] -> [B, Nq, D] float32."""
    return split_window_mirror(q[:, None], k_cache, v_cache, pos[:, None],
                               tiles, k_scale, v_scale)[:, 0]


ragged_paged_decode_attention.launches = 0
ragged_paged_verify_attention.launches = 0
ragged_paged_decode_attention_q8.launches = 0
ragged_paged_verify_attention_q8.launches = 0
