"""The split-K algorithm of the contiguous decode kernels (K9 bf16, K10
int8).

On the card the one-token decode over the sequential engines' contiguous
cache is the verify kernels' split pass at G = 1 (``csrc/ragged_verify.cuh``
with its contiguous tile source): the window is cut into 64-position
tiles, split over many blocks by ``decode_split_plan`` (shapes in, ints
out), each block writes float32 partials (m, l, acc) per query row and a
merge pass combines them over the splits the sequence's frontier
reaches.  ``ops/ragged_attention.py`` repeats that in plain PyTorch:
``window_as_pool`` tiles the window as the kernels read it and
``split_decode_mirror`` runs the split and merge passes over it.  Here,
on the CPU:

- the mirror, at 1, 2 and 3 tiles a split, over a bf16 and an int8 cache,
  GQA groups 1, 4 and 8, B = 3, on a window of a longer cache whose last
  tile is partial, with frontiers on a split boundary, on the first key
  past it and one tile past it, at 0, at W - 1 and past the window (read
  as W - 1), against the port's plain versions ``_decode_contiguous`` /
  ``_decode_contiguous_q8`` in float32 (atol 1e-5: the same arithmetic in
  another summation order) and the JAX Pallas decode kernels in
  interpret mode (atol 2e-5, float32, as tests/test_torch_contiguous.py);
- the merge never reads a split past the frontier (NaN there changes
  nothing), and the tiling zero-fills the window's ragged end;
- the plan is ints from shapes, finer than the verify plan, and at
  orin's served position gives more live blocks than the H100's 132 SMs;
- the CUDA wrappers read no device value and refuse what the kernels do
  not take.
"""

from __future__ import annotations

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.ops import pallas_attention as JP
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import ragged_attention as TR

NKV, D = 2, 16
S_MAX, W = 800, 660            # a window of a longer cache; 660 = 10 tiles + 20
TILE = TR.DECODE_TILE


def _positions(kind: str, tiles: int) -> np.ndarray:
    """Three frontiers: around the first split boundary (``edge`` is the
    first key of split 1), or at the window's ends."""
    edge = tiles * TILE
    if kind == "boundary":         # on it, the first key past it, a tile past
        return np.asarray([edge - 1, edge, edge + TILE], np.int32)
    return np.asarray([0, W - 1, W + 50], np.int32)


def _case(cache: str, group: int, kind: str, tiles: int):
    """q and a cache (bf16 values held in float32, or int8 with the JAX
    quantizer's scales) for 3 sequences; numpy arrays q, k, v, k_scale,
    v_scale (None for bf16), pos."""
    rng = np.random.default_rng(10 * group + (cache == "int8"))
    b = 3

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()

    q = bf16(rng.standard_normal((b, NKV * group, D)))
    k = rng.standard_normal((b, S_MAX, NKV, D))
    v = rng.standard_normal((b, S_MAX, NKV, D))
    if cache == "int8":
        (k, ks), (v, vs) = ((np.array(a) for a in JQ.quantize_kv_rows(
            jnp.asarray(x, jnp.float32))) for x in (k, v))
    else:
        k, v, ks, vs = bf16(k), bf16(v), None, None
    return q, k, v, ks, vs, _positions(kind, tiles)


def _window(case):
    """The case as torch tensors, the cache read through a [:, :W] window
    of the longer cache (not contiguous, as the kernels take it)."""
    q, k, v, ks, vs, pos = case
    t = [None if a is None else torch.from_numpy(a) for a in (k, v, ks, vs)]
    k, v, ks, vs = [None if a is None else a[:, :W] for a in t]
    return torch.from_numpy(q), k, v, ks, vs, torch.from_numpy(pos)


_JAX = {}


def _jax_decode(cache: str, group: int, kind: str, tiles: int) -> np.ndarray:
    """The JAX Pallas decode kernel (interpret mode on the CPU) on the
    case's window in float32, computed once per case."""
    key = (cache, group, kind, tiles if kind == "boundary" else 0)
    if key not in _JAX:
        q, k, v, ks, vs, pos = _case(cache, group, kind, tiles)
        q, pos = jnp.asarray(q), jnp.asarray(pos)
        k, v = jnp.asarray(k[:, :W]), jnp.asarray(v[:, :W])
        if cache == "int8":
            out = JP.flash_decode_attention_q8(q, k, v, jnp.asarray(ks[:, :W]),
                                               jnp.asarray(vs[:, :W]), pos)
        else:
            out = JP.flash_decode_attention(q, k, v, pos)
        _JAX[key] = np.asarray(out, np.float32)
    return _JAX[key]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("tiles", [1, 2, 3])
@pytest.mark.parametrize("kind", ["boundary", "ends"])
def test_split_mirror_matches_plain_and_jax(cache, group, tiles, kind):
    q, k, v, ks, vs, pos = _window(_case(cache, group, kind, tiles))
    assert not k.is_contiguous()
    out = TR.split_decode_mirror(q, k, v, pos, tiles, ks, vs)
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = (TA._decode_contiguous_q8(q, k, v, ks, vs, pos) if ks is not None
             else TA._decode_contiguous(q, k, v, pos))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(),
                               _jax_decode(cache, group, kind, tiles),
                               atol=2e-5, rtol=0)


def test_window_as_pool_tiles_the_window_in_order():
    """Tile j of sequence b is positions 64 j .. 64 j + 63 of its window;
    the ragged end past W is zero (the kernels' copies zero-fill it)."""
    q, k, v, ks, vs, pos = _window(_case("int8", 4, "ends", 1))
    k_pool, v_pool, k_sc, v_sc, tables = TR.window_as_pool(k, v, ks, vs)
    mb = -(-W // TILE)
    assert tables.tolist() == np.arange(3 * mb).reshape(3, mb).tolist()
    assert tuple(k_pool.shape) == (NKV, 3 * mb, TILE, D)
    assert k_pool.dtype == torch.int8 and tuple(k_sc.shape) == (NKV, 3 * mb,
                                                                TILE)
    for b in range(3):
        for p in (0, 63, 64, 300, W - 1):
            j, r = divmod(p, TILE)
            assert torch.equal(v_pool[:, b * mb + j, r], v[b, p])
            assert torch.equal(k_sc[:, b * mb + j, r], ks[b, p])
        last = b * mb + mb - 1
        assert not k_pool[:, last, W % TILE:].any()
        assert not v_sc[:, last, W % TILE:].any()


def test_merge_reads_only_the_splits_the_frontier_reaches():
    """Splits past a sequence's frontier are never read: NaN there changes
    nothing."""
    tiles = 2
    q, k, v, ks, vs, pos = _window(_case("bf16", 4, "boundary", tiles))
    k_pool, v_pool, _, _, tables = TR.window_as_pool(k, v)
    m, l, acc = TR.split_verify_partials(q[:, None], k_pool, v_pool, tables,
                                         pos, tiles)
    mb = tables.shape[1]
    want = TR.merge_split_partials(m, l, acc, pos, 1, TILE, mb, tiles)
    for b, p in enumerate(pos.tolist()):
        live = -(-(p // TILE + 1) // tiles)
        m[b, :, live:], l[b, :, live:], acc[b, :, live:] = (float("nan"),) * 3
    assert torch.isnan(m).any()
    got = TR.merge_split_partials(m, l, acc, pos, 1, TILE, mb, tiles)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("w,b,nkv", [(8192, 1, 8), (1024, 1, 8), (256, 1, 8),
                                     (8192, 4, 8), (660, 3, 2), (64, 1, 1),
                                     (2200, 4, 8), (65, 2, 8)])
def test_decode_split_plan_is_ints_from_shapes(w, b, nkv):
    tiles, splits = TR.decode_split_plan(w, b, nkv)
    assert type(tiles) is int and type(splits) is int
    n_tiles = -(-w // TILE)
    assert tiles >= 1 and splits * tiles >= n_tiles > (splits - 1) * tiles
    # As fine as SPLIT_TARGET_BLOCKS blocks over the whole window ask.
    assert b * nkv * n_tiles <= tiles * TR.SPLIT_TARGET_BLOCKS
    assert tiles == 1 or b * nkv * n_tiles > (tiles - 1) * TR.SPLIT_TARGET_BLOCKS


def test_decode_split_plan_fills_the_card_at_orins_served_position():
    """orin_8b decoding sequentially (B = 1, 8 kv heads) over its 8192
    cache: 2 tiles a split, 64 splits; at position 2255 (the served long
    prompt's) 18 splits are live, 144 blocks, more than the H100's 132
    SMs.  The verify plan at the same shape would give 16 splits of 8
    tiles, 5 live, 40 blocks."""
    w, b, nkv, pos = 8192, 1, 8, 2255
    tiles, splits = TR.decode_split_plan(w, b, nkv)
    assert (tiles, splits) == (2, 64)
    live = nkv * -(-(pos // TILE + 1) // tiles)
    assert live == 144 > 132
    v_tiles, _ = TR.split_plan(w // TILE, b, nkv)
    assert nkv * -(-(pos // TILE + 1) // v_tiles) == 40


def test_decode_wrappers_read_no_device_value():
    """The CUDA path of both wrappers plans from shapes only: no
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` anywhere in
    them, their launch helper, its checks or the plan."""
    for fn in (TF.flash_decode_attention, TF.flash_decode_attention_q8,
               TF._decode_window, TF._launch_window, TF._check_window,
               TF._check_cache, TF._check_scales, TF._check_query,
               TR.decode_split_plan):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)


@pytest.mark.parametrize("bad", ["group", "q_dims", "pos_dtype", "cache_dtype",
                                 "head_dim", "batch_stride"])
def test_decode_launch_refuses_what_the_kernels_do_not_take(bad):
    """The launch helper raises before any kernel is built or launched
    (here, on CPU tensors, it would need the CUDA toolkit)."""
    b, nkv, d, s_max = 2, 2, 64, 300
    nq = nkv * (16 if bad == "group" else 4)
    if bad == "head_dim":
        d = 32
    q = torch.zeros((b, nq, d), dtype=torch.bfloat16)
    if bad == "q_dims":
        q = q[:, None]
    cache = torch.zeros((b, s_max, nkv, d),
                        dtype=torch.float32 if bad == "cache_dtype"
                        else torch.bfloat16)
    window = cache[:, :200]
    if bad == "batch_stride":
        flat = torch.zeros(b * s_max * nkv * d + 4, dtype=torch.bfloat16)
        window = flat.as_strided((b, 200, nkv, d),
                                 (s_max * nkv * d - 4, nkv * d, d, 1))
    pos = torch.zeros(b, dtype=torch.int64 if bad == "pos_dtype"
                      else torch.int32)
    with pytest.raises(ValueError):
        TF._decode_window(TF.flash_decode_attention, "flash_decode", q,
                          window, window, None, None, pos)
