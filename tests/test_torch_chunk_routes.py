"""The two routes of the bf16 contiguous chunk kernel (K11).

On the card ``flash_chunk_attention`` picks a route from shapes alone
(``chunk_route``): a chunk whose block rows (the GQA group's heads x its
S_c positions) fit one block of the split kernel, at most 48, runs
``csrc/ragged_verify.cuh``'s split-K kernel over the cache window at
G = S_c, each row's frontier min(q_pos, W - 1) read row by row, planned
by ``chunk_split_plan``; a wider chunk runs ``csrc/flash_tc.cuh``'s
tensor-core flash kernel with the window tile source, in bf16.
``ops/ragged_attention.py`` and ``ops/flash_attention.py`` repeat both in
plain PyTorch (``split_window_mirror``, ``flash_tc_mirror``).  Here, on
the CPU, with inputs from a numpy seed:

- the split route's mirror at 1 and 3 tiles a split and at the plan's
  own, chunks of 1-12 rows at GQA groups 1, 4 and 8 (up to the route's
  48 block rows), head dim 16, over a window of a longer cache: rows
  straddling a split boundary and rows whose positions pass W - 1 (read
  as W - 1) over a 384-key window, rows over a 100-key window whose last
  64-key tile is partial; against the port's plain version
  ``_chunk_contiguous`` in float32 (atol 1e-5: the same arithmetic in
  another summation order) and the JAX Pallas kernel
  ``flash_chunk_attention`` in interpret mode (atol 2e-5, float32, as
  tests/test_torch_contiguous.py); rows clamped to a chunk's true length
  (padding) against the plain version, which they match (the Pallas
  kernel rebuilds positions as start + r, so its padded rows differ and
  are never read);
- the tensor-core route's mirror over a bf16 window at 16-256 rows (and
  384, the Pallas wide regime, at a group of 1), head dim 64 and 128,
  groups 1, 4 and 8, against the same two, and at 600 rows and on padded
  rows against the plain version;
- the tensor-core mirror as the card rounds (P in bf16) within
  chip_smoke's 1e-2 row bound, at a few rows and at a wide chunk;
- the route and the plan are ints from shapes, the wrapper reads no
  device value, and each route's launch refuses what its kernel does not
  take.
"""

from __future__ import annotations

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.ops import pallas_attention as JP
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import ragged_attention as TR

NKV = 2
TILE = TR.DECODE_TILE
ROW_TOL = 1e-2                 # chip_smoke's per-row bound (KERNEL_REL_TOL)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Values a bf16 tensor holds, as float32."""
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


# -- the split route: a few rows over the window -------------------------------

# (group, rows): chunks of 1-12 positions whose block rows fit the route.
SPLIT_SHAPES = [(1, 1), (1, 5), (1, 12), (4, 1), (4, 2), (4, 5), (4, 12),
                (8, 1), (8, 2), (8, 5), (8, 6)]


def _split_case(group: int, s_c: int, kind: str, tiles: int):
    """q, a bf16 cache (values held in float32) and each row's position
    start + r for 3 sequences.  ``edge``: a 384-key window of a 448-key
    cache, the first sequence's rows straddling the first split boundary
    (``tiles`` tiles), the second at 0, the third's rows passing W - 1;
    ``partial``: a 100-key window of 160 (its second 64-key tile partial),
    rows at 59, 0 and 95.  Returns numpy q, k, v, pos and W."""
    w, s_max = (384, 448) if kind == "edge" else (100, 160)
    starts = ((tiles * TILE - 2, 0, w - 3) if kind == "edge"
              else (59, 0, 95))
    rng = np.random.default_rng(1000 * group + 10 * s_c + tiles
                                + (kind == "edge"))
    d = 16
    q = _bf16(rng.standard_normal((3, s_c, NKV * group, d)))
    k = _bf16(rng.standard_normal((3, s_max, NKV, d)))
    v = _bf16(rng.standard_normal((3, s_max, NKV, d)))
    pos = (np.asarray(starts)[:, None] + np.arange(s_c)[None]).astype(np.int32)
    return q, k, v, pos, w


def _window(q, k, v, pos, w):
    """The case as torch tensors, the cache read through a [:, :W] window
    of the longer cache (not contiguous, as the kernels take it)."""
    k, v = (torch.from_numpy(a)[:, :w] for a in (k, v))
    return torch.from_numpy(q), k, v, torch.from_numpy(pos)


_JAX = {}


def _jax_chunk(key, q, k, v, pos, w) -> np.ndarray:
    """The JAX Pallas chunk kernel (interpret mode on the CPU) on a case
    in float32, computed once per case."""
    if key not in _JAX:
        _JAX[key] = np.asarray(JP.flash_chunk_attention(
            jnp.asarray(q), jnp.asarray(k[:, :w]), jnp.asarray(v[:, :w]),
            jnp.asarray(pos)), np.float32)
    return _JAX[key]


def _plan_tiles(w: int, group: int, s_c: int) -> int:
    tiles, _ = TR.chunk_split_plan(w, 3, NKV, group * s_c, 16)
    return tiles


@pytest.mark.parametrize("tiles", [1, 3, "plan"])
@pytest.mark.parametrize("kind", ["edge", "partial"])
@pytest.mark.parametrize("group,s_c", SPLIT_SHAPES)
def test_split_route_mirror_matches_plain_and_jax(group, s_c, kind, tiles):
    w = 384 if kind == "edge" else 100
    tiles = _plan_tiles(w, group, s_c) if tiles == "plan" else tiles
    case = _split_case(group, s_c, kind, tiles)
    assert TF.chunk_route(s_c, NKV * group, NKV) == "split"
    q, k, v, pos = _window(*case)
    assert not k.is_contiguous()
    out = TR.split_window_mirror(q, k, v, pos, tiles)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(
        out.numpy(), _jax_chunk(("split", group, s_c, kind, tiles), *case),
        atol=2e-5, rtol=0)


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("group,s_c", [(4, 5), (1, 12), (8, 6)])
def test_split_route_mirror_matches_plain_on_padded_rows(group, s_c, tiles):
    """Rows past a chunk's true length carry positions clamped to it (the
    kernel reads each row's position): they match the plain version."""
    q, k, v, pos = _window(*_split_case(group, s_c, "edge", tiles))
    pos = torch.minimum(pos, pos[:, :1] + max(0, s_c - 3))
    out = TR.split_window_mirror(q, k, v, pos, tiles)
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)


def test_split_route_rows_past_the_window_read_its_last_key():
    """A row whose position passes W - 1 attends the whole window, as if
    at W - 1, and no key at or past W is read: NaN there changes
    nothing."""
    q, k, v, pos = _window(*_split_case(4, 12, "edge", 2))
    assert (pos[2] > 383).any()
    want = TR.split_window_mirror(q, k, v, pos, 2)
    clamped = TR.split_window_mirror(q, k, v, pos.clamp(max=383), 2)
    torch.testing.assert_close(want, clamped, atol=0, rtol=0)
    k_full, v_full = k.clone(), v.clone()
    assert k_full.shape[1] == 384
    cache = torch.full((3, 448, NKV, 16), float("nan"))
    cache_v = cache.clone()
    cache[:, :384], cache_v[:, :384] = k_full, v_full
    got = TR.split_window_mirror(q, cache[:, :384], cache_v[:, :384], pos, 2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# -- the tensor-core route: wide chunks over a bf16 window ---------------------

# name -> (rows, W, cache length, each sequence's first position).
TC_CHUNKS = {
    "rows16": (16, 100, 160, (48, 0, 84)),
    "rows37": (37, 100, 160, (27, 0, 63)),
    "rows128": (128, 256, 320, (0, 100)),
    "rows256": (256, 384, 448, (0, 128)),
    "rows384": (384, 512, 576, (0, 128)),
}


def _tc_case(d: int, group: int, name: str):
    s_c, w, s_max, starts = TC_CHUNKS[name]
    rng = np.random.default_rng(10 * d + group + 3 * s_c)
    b = len(starts)
    q = _bf16(rng.standard_normal((b, s_c, NKV * group, d)))
    k = _bf16(rng.standard_normal((b, s_max, NKV, d)))
    v = _bf16(rng.standard_normal((b, s_max, NKV, d)))
    pos = (np.asarray(starts)[:, None] + np.arange(s_c)[None]).astype(np.int32)
    return q, k, v, pos, w


# The Pallas wide regime (384 rows) at a group of 1: 64 positions a block,
# so the mirror's block loop stays short.
TC_SHAPES = [(group, name) for group in (1, 4, 8) for name in sorted(TC_CHUNKS)
             if name != "rows384" or group == 1]


@pytest.mark.parametrize("group,name", TC_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
def test_tc_route_mirror_matches_plain_and_jax(d, group, name):
    case = _tc_case(d, group, name)
    q, k, v, pos = _window(*case)
    s_c = q.shape[1]
    if group * s_c > TF.SPLIT_MAX_ROWS:
        assert TF.chunk_route(s_c, NKV * group, NKV) == "tc"
    kb, vb = k.bfloat16(), v.bfloat16()             # the card's bf16 window
    out = TF.flash_tc_mirror(q, kb, vb, pos, p_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(
        out.numpy(), _jax_chunk(("tc", d, group, name), *case), atol=2e-5,
        rtol=0)


def test_tc_route_mirror_matches_plain_at_600_rows_and_padded_rows():
    """600 rows at 300-399 over W = 1000 of 1100 (a grid past the card's
    SM count at orin's group), the last rows clamped to a true length."""
    rng = np.random.default_rng(600)
    b, s_c, w, d, group = 2, 600, 1000, 64, 4
    q = torch.from_numpy(_bf16(rng.standard_normal((b, s_c, NKV * group, d))))
    k = torch.from_numpy(_bf16(rng.standard_normal((b, 1100, NKV, d))))[:, :w]
    v = torch.from_numpy(_bf16(rng.standard_normal((b, 1100, NKV, d))))[:, :w]
    pos = (torch.tensor([300, 399])[:, None] + torch.arange(s_c)[None])
    pos = torch.minimum(pos, torch.tensor([[850], [w + 20]])).to(torch.int32)
    out = TF.flash_tc_mirror(q, k.bfloat16(), v.bfloat16(), pos,
                             p_dtype=torch.float32)
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous(q, k, v, pos).numpy(), atol=1e-5,
        rtol=0)


@pytest.mark.parametrize("shape", ["rows5", "rows256"])
def test_tc_route_rounding_p_stays_within_the_row_bound(shape):
    """P rounded to bf16 before PV, as the card and the Pallas chunk
    kernels round it: every output row within chip_smoke's 1e-2 of the
    plain version in float32, and not equal to it (the rounding is
    there); at the verify's few rows and at a wide chunk."""
    if shape == "rows5":
        q, k, v, pos = _window(*_split_case(4, 5, "edge", 1))
    else:
        q, k, v, pos = _window(*_tc_case(64, 4, "rows256"))
    plain = TA._chunk_contiguous(q, k, v, pos)
    out = TF.flash_tc_mirror(q, k.bfloat16(), v.bfloat16(), pos)
    err = _row_rel_err(out, plain)
    assert 1e-4 < err <= ROW_TOL


# -- the route choice, the plans and the launches ------------------------------

@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 48])
def test_chunk_route_turns_at_48_block_rows(group):
    """The route is a function of shapes: the split kernel up to 48 block
    rows (48 // group positions), the tensor-core kernel from one more."""
    nq = NKV * group
    fit = TF.SPLIT_MAX_ROWS // group
    assert TF.SPLIT_MAX_ROWS == 48
    assert TF.chunk_route(fit, nq, NKV) == "split"
    assert TF.chunk_route(fit + 1, nq, NKV) == "tc"
    assert TF.chunk_route(2048, nq, NKV) == "tc"


def test_orins_verify_takes_the_split_route_and_fills_the_card():
    """orin_8b's sequential verify (γ = 4: 5 rows, Nq = 32, Nkv = 8,
    D = 128) over its 8192 cache at position 3000: 20 block rows, the
    split route, 2 tiles a split (the partials, 21 KB, a third of a
    split's 64 KB of K/V), 64 splits of which 24 are live, 192 blocks on
    132 SMs; the long prompt's 2048-row chunk and a 256-row suffix take
    the tensor-core route."""
    assert TF.chunk_route(5, 32, 8) == "split"
    assert TF.chunk_route(2048, 32, 8) == "tc"
    assert TF.chunk_route(256, 32, 8) == "tc"
    tiles, splits = TR.chunk_split_plan(8192, 1, 8, 20, 128)
    assert (tiles, splits) == (2, 64)
    partials = 2 * 20 * (128 + 2) * 4
    assert partials < tiles * 2 * TILE * 128 * 2 / 3
    live = 8 * -(-((3000 + 4) // TILE + 1) // tiles)
    assert live == 192 > 132


@pytest.mark.parametrize("w,b,nkv,rows,d", [
    (8192, 1, 8, 20, 128), (1024, 1, 8, 20, 128), (100, 3, 2, 48, 16),
    (384, 3, 2, 4, 16), (8192, 4, 8, 48, 64), (64, 1, 1, 48, 64),
    (2200, 2, 8, 12, 128)])
def test_chunk_split_plan_is_ints_from_shapes(w, b, nkv, rows, d):
    tiles, splits = TR.chunk_split_plan(w, b, nkv, rows, d)
    assert type(tiles) is int and type(splits) is int
    n_tiles = -(-w // TILE)
    assert tiles >= 1 and splits * tiles >= n_tiles > (splits - 1) * tiles
    fine, _ = TR.decode_split_plan(w, b, nkv)
    # The decode plan, unless a split would read fewer K/V bytes than its
    # partials move, and then no finer than that.
    partials, pair = 2 * rows * (d + 2) * 4, 2 * TILE * d * 2
    assert tiles >= fine and tiles * pair >= partials
    assert tiles == fine or (tiles - 1) * pair < partials


def test_chunk_wrapper_reads_no_device_value():
    """The CUDA path of the chunk wrapper picks its route and plans from
    shapes only: no ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()``
    in it, either route's launch helper, their checks or the plan."""
    for fn in (TF.flash_chunk_attention, TF.chunk_route, TF._split_chunk,
               TF._tc_chunk, TF._launch_window, TF._check_window,
               TR.chunk_split_plan, TR._fine_split):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)


@pytest.mark.parametrize("bad", ["rows", "cache_dtype", "head_dim", "pos_dtype",
                                 "pos_shape", "misaligned", "batch_stride"])
def test_split_route_launch_refuses_what_the_kernel_does_not_take(bad):
    """The split route's launch helper raises before any kernel is built
    or launched (here, on CPU tensors, a launch would need the CUDA
    toolkit): more than 48 block rows among the rest."""
    b, nkv, s_max, w = 2, 2, 300, 200
    d = 32 if bad == "head_dim" else 64
    s_c = 13 if bad == "rows" else 5
    q = torch.zeros((b, s_c, nkv * 4, d), dtype=torch.bfloat16)
    if bad == "misaligned":
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    cache = torch.zeros((b, s_max, nkv, d), dtype=torch.int8
                        if bad == "cache_dtype" else torch.bfloat16)[:, :w]
    if bad == "batch_stride":
        flat = torch.zeros(b * s_max * nkv * d + 4, dtype=torch.bfloat16)
        cache = flat.as_strided((b, w, nkv, d),
                                (s_max * nkv * d - 4, nkv * d, d, 1))
    pos = torch.zeros((b, s_c + (bad == "pos_shape")),
                      dtype=torch.int64 if bad == "pos_dtype"
                      else torch.int32)
    with pytest.raises(ValueError):
        TF._split_chunk(TF.flash_chunk_attention, "flash_chunk", q, cache,
                        cache, pos)


@pytest.mark.parametrize("bad", ["group", "cache_dtype", "q_dims"])
def test_tc_route_launch_refuses_what_the_kernel_does_not_take(bad):
    """The tensor-core route's launch helper raises before any kernel is
    built or launched: a group past 64 query heads a kv head among the
    rest."""
    b, nkv, d, w = 1, 2, 64, 200
    nq = nkv * (65 if bad == "group" else 4)
    q = torch.zeros((b, 100, nq, d), dtype=torch.bfloat16)
    if bad == "q_dims":
        q = q[:, 0]
    cache = torch.zeros((b, w, nkv, d), dtype=torch.int8
                        if bad == "cache_dtype" else torch.bfloat16)
    pos = torch.zeros(q.shape[:-2], dtype=torch.int32)
    with pytest.raises(ValueError):
        TF._tc_chunk(TF.flash_chunk_attention, "flash_chunk", q, cache, cache,
                     None, None, pos)


def test_chunk_wrapper_counts_no_launch_on_the_cpu():
    """A CPU tensor takes the plain version: no launch and no route is
    counted."""
    q, k, v, pos = _window(*_split_case(4, 5, "edge", 1))
    before = (TF.flash_chunk_attention.launches,
              dict(TF.flash_chunk_attention.route_launches))
    calls = TA._chunk_contiguous.calls
    TF.flash_chunk_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), pos)
    assert TA._chunk_contiguous.calls == calls + 1
    assert (TF.flash_chunk_attention.launches,
            TF.flash_chunk_attention.route_launches) == before
