"""The tensor-core flash kernel's algorithm: K2 (the causal prefill), K12
(the int8 contiguous chunk) and K3 (the paged suffix chunk).

On the card all three are ``csrc/flash_tc.cuh``: a block owns one kv head
and 64 rows (the GQA group's heads at 64 / group positions) in four 16-row
slabs of two warps, walks 128-key K/V tiles (every other 16-key chunk a
warp, each warp with its own flash state, merged at the end) up to its
furthest frontier, masks only the tiles that straddle a row's frontier,
widens int8 exactly, puts the K row scale on the scores and folds the V row
scale into P, and rounds P to bf16 with m in log2 units.
``ops/flash_attention.py`` repeats that in plain PyTorch
(``flash_tc_mirror``).  Here, on the CPU, with inputs from a numpy seed:

- the mirror with P in float32 against the port's plain versions
  ``causal_attention`` / ``_chunk_contiguous_q8`` / ``_gather_chunk_paged``
  (atol 1e-5: the same arithmetic in another summation order) and against
  the JAX Pallas kernels ``flash_causal_attention`` /
  ``flash_chunk_attention_q8`` / ``paged_chunk_attention`` in interpret
  mode (atol 2e-5, float32, as tests/test_torch_contiguous.py and
  tests/test_torch_split_decode.py): head dim 64 and 128, GQA groups 1, 4
  and 8; the prefill at 5, 16, 20, 37 and 256 rows; the int8 chunk at 5,
  16, 20, 37 and 256 rows (the Pallas native regime) and 384 (its
  transposed regime) over windows of a longer cache, the short ones over a
  100-key window whose last tile is partial, with frontiers on a tile
  boundary, one key past it, at 0 and at W - 1; the paged chunk over
  table-scattered blocks of 32, 64 and 128 positions;
- the mirror as the card rounds (P in bf16) within the 1e-2 row bound
  that chip_smoke holds the kernels to, and not equal to float32; and a
  prompt's rows bit-identical between the cold prefill (K2) and a prefix
  hit's suffix chunk over the K/V it wrote (K3);
- nothing past a block's frontier is read, only straddling tiles are
  masked, and the grid packs 16 positions x 4 heads at nano's shape;
- the CUDA wrappers read no device value and refuse what the kernel does
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

NKV = 2
ROW_TOL = 1e-2                 # chip_smoke's per-row bound (KERNEL_REL_TOL)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Values a bf16 tensor holds, as float32."""
    return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()


def _row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max().item()


# -- K2: the causal prefill ---------------------------------------------------

def _causal_case(d: int, group: int, s: int):
    rng = np.random.default_rng(1000 * d + 10 * group + s)
    q = _bf16(rng.standard_normal((2, s, NKV * group, d)))
    k = _bf16(rng.standard_normal((2, s, NKV, d)))
    v = _bf16(rng.standard_normal((2, s, NKV, d)))
    return q, k, v


_JAX = {}


def _jax_causal(d: int, group: int, s: int) -> np.ndarray:
    key = ("causal", d, group, s)
    if key not in _JAX:
        q, k, v = (jnp.asarray(x) for x in _causal_case(d, group, s))
        _JAX[key] = np.asarray(JP.flash_causal_attention(q, k, v), np.float32)
    return _JAX[key]


@pytest.mark.parametrize("s", [5, 16, 20, 37, 256])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_causal_mirror_matches_plain_and_jax(d, group, s):
    q, k, v = (torch.from_numpy(x) for x in _causal_case(d, group, s))
    out = TF.flash_tc_mirror(q, k, v, p_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), TA.causal_attention(q, k, v).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_causal(d, group, s),
                               atol=2e-5, rtol=0)


# -- K12: the int8 chunk over a window of the contiguous cache ----------------

# name -> (rows, W, cache length, each sequence's first position): the
# short chunks over a 100-key window (one full 64-key tile and a partial
# one) with last frontiers at 63 (a tile's last key), 64 (one past it), a
# first row at 0 and a last at W - 1; 256 rows (the Pallas native regime's
# largest) and 384 (its transposed regime) over windows of 384 and 512.
CHUNKS = {
    "rows5": (5, 100, 160, (59, 60, 0, 95)),
    "rows16": (16, 100, 160, (48, 49, 0, 84)),
    "rows20": (20, 100, 160, (44, 45, 0, 80)),
    "rows37": (37, 100, 160, (27, 28, 0, 63)),
    "rows256": (256, 384, 448, (0, 128)),
    "rows384": (384, 512, 576, (0, 128)),
}


def _chunk_case(d: int, group: int, name: str):
    """q, the int8 cache and its scales (the JAX quantizer's, handed to
    both packages) and the positions start + r of each sequence."""
    s_c, w, s_max, starts = CHUNKS[name]
    rng = np.random.default_rng(100 * d + group + 7 * s_c)
    b = len(starts)
    q = _bf16(rng.standard_normal((b, s_c, NKV * group, d)))
    (k, ks), (v, vs) = ((np.array(a) for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.standard_normal((b, s_max, NKV, d)), jnp.float32)))
        for _ in range(2))
    pos = (np.asarray(starts)[:, None] + np.arange(s_c)[None]).astype(np.int32)
    return q, k, v, ks, vs, pos, w


def _window(case):
    """The case as torch tensors, the cache read through a [:, :W] window
    of the longer cache (not contiguous, as the kernel takes it)."""
    q, k, v, ks, vs, pos, w = case
    k, v, ks, vs = (torch.from_numpy(a)[:, :w] for a in (k, v, ks, vs))
    return torch.from_numpy(q), k, v, ks, vs, torch.from_numpy(pos)


def _jax_chunk(d: int, group: int, name: str) -> np.ndarray:
    key = ("chunk", d, group, name)
    if key not in _JAX:
        q, k, v, ks, vs, pos, w = _chunk_case(d, group, name)
        _JAX[key] = np.asarray(JP.flash_chunk_attention_q8(
            jnp.asarray(q), jnp.asarray(k[:, :w]), jnp.asarray(v[:, :w]),
            jnp.asarray(ks[:, :w]), jnp.asarray(vs[:, :w]), jnp.asarray(pos)),
            np.float32)
    return _JAX[key]


@pytest.mark.parametrize("name", sorted(CHUNKS))
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_chunk_q8_mirror_matches_plain_and_jax(d, group, name):
    q, k, v, ks, vs, pos = _window(_chunk_case(d, group, name))
    assert not k.is_contiguous()
    out = TF.flash_tc_mirror(q, k, v, pos, ks, vs,
                             p_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous_q8(q, k, v, ks, vs, pos).numpy(),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_chunk(d, group, name),
                               atol=2e-5, rtol=0)


def test_chunk_q8_mirror_matches_plain_on_padded_rows():
    """Rows past a chunk's true length carry positions clamped to it (the
    kernel reads each row's position): they match the plain version too."""
    q, k, v, ks, vs, pos = _window(_chunk_case(64, 4, "rows37"))
    pos = torch.minimum(pos, pos[:, :1] + 30)
    out = TF.flash_tc_mirror(q, k, v, pos, ks, vs,
                             p_dtype=torch.float32)
    np.testing.assert_allclose(
        out.numpy(), TA._chunk_contiguous_q8(q, k, v, ks, vs, pos).numpy(),
        atol=1e-5, rtol=0)


# -- K3: the suffix chunk over a slot's paged pool blocks ---------------------

def _paged_case(d: int, group: int, bs: int):
    """q at positions start + r, one layer's pools [Nkv, NB, bs, D] and a
    table of scattered blocks: a 40-row chunk at 60 in a 128-key window."""
    rng = np.random.default_rng(10 * d + group + bs)
    start, s_c, window = 60, 40, 128
    nb = 2 * (window // bs) + 1
    q = _bf16(rng.standard_normal((1, s_c, NKV * group, d)))
    kp = _bf16(rng.standard_normal((NKV, nb, bs, d)))
    vp = _bf16(rng.standard_normal((NKV, nb, bs, d)))
    table = rng.permutation(nb - 1)[:window // bs].astype(np.int32) + 1
    return q, kp, vp, table, start, window


@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_mirror_matches_plain_and_jax(d, group, bs):
    q, kp, vp, table, start, window = _paged_case(d, group, bs)
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, kp, vp, table))
    q_pos = start + torch.arange(q.shape[1])[None]
    k_win, v_win = TA._gather_window(tk, tv, tt, window)
    out = TF.flash_tc_mirror(tq, k_win, v_win, q_pos, p_dtype=torch.float32)
    np.testing.assert_allclose(
        out.numpy(),
        TA._gather_chunk_paged(tq, tk, tv, tt, q_pos, window).numpy(),
        atol=1e-5, rtol=0)
    kern = JP.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray([start], jnp.int32), window)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern, np.float32),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("m", [37, 64, 100, 255])
def test_prefix_hit_suffix_rows_equal_the_cold_prefill_bit_for_bit(m):
    """A prompt of 256 positions prefilled cold (K2 over its fresh K/V)
    and the same prompt's suffix from position m served on a prefix hit (K3
    over the K/V the prefill wrote) give the suffix rows the same bits, P
    rounded to bf16 as on the card: one arithmetic per row, whatever the
    block around it."""
    q, k, v = (torch.from_numpy(x) for x in _causal_case(64, 4, 256))
    q, k, v = q[:1], k[:1], v[:1]
    cold = TF.flash_tc_mirror(q, k, v)
    pos = torch.arange(m, 256)[None]
    hit = TF.flash_tc_mirror(q[:, m:].contiguous(), k, v, pos)
    assert torch.equal(hit, cold[:, m:])


# -- the card's rounding, the walk and the grid --------------------------------

@pytest.mark.parametrize("kernel", ["causal", "chunk_q8"])
def test_mirror_rounding_p_stays_within_the_row_bound(kernel):
    """P rounded to bf16, as the card rounds it: every output row within
    chip_smoke's 1e-2 of the plain version in float32, and not equal to
    the float32 arithmetic (the rounding is there)."""
    if kernel == "causal":
        q, k, v = (torch.from_numpy(x) for x in _causal_case(64, 4, 256))
        plain = TA.causal_attention(q, k, v)
        out = TF.flash_tc_mirror(q, k, v)
    else:
        q, k, v, ks, vs, pos = _window(_chunk_case(64, 4, "rows256"))
        plain = TA._chunk_contiguous_q8(q, k, v, ks, vs, pos)
        out = TF.flash_tc_mirror(q, k, v, pos, ks, vs)
    err = _row_rel_err(out, plain)
    assert 1e-4 < err <= ROW_TOL


def test_mirror_reads_nothing_past_the_block_frontier():
    """Cache rows past every block's furthest frontier are never read: NaN
    there (values and scales) changes nothing."""
    q, k, v, ks, vs, pos = _window(_chunk_case(64, 4, "rows20"))
    pos = pos.clamp(max=70)
    want = TF.flash_tc_mirror(q, k, v, pos, ks, vs)
    ks, vs = ks.clone(), vs.clone()
    ks[:, 71:], vs[:, 71:] = float("nan"), float("nan")
    k, v = k.clone(), v.clone()
    k[:, 71:], v[:, 71:] = 127, -127
    got = TF.flash_tc_mirror(q, k, v, pos, ks, vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_mirror_masks_only_straddling_tiles():
    """The prefill at nano's group of 4 and S = 256: a block's 16 positions
    lie inside one tile, so every slab masks exactly one tile (its
    diagonal), walks the tiles below it unmasked, and every block stops at
    its own diagonal."""
    q, k, v = (torch.from_numpy(x) for x in _causal_case(64, 4, 256))
    stats = {}
    TF.flash_tc_mirror(q, k, v, stats=stats)
    tile = TF.TC_TILE
    n_blocks = 2 * NKV * (256 // 16)
    walks = [(i0 + 15) // tile + 1 for i0 in range(0, 256, 16)]
    assert stats["masked"] == 4 * n_blocks
    assert stats["skipped"] == 0
    assert stats["tiles"] == 2 * NKV * sum(walks)
    assert stats["unmasked"] == 4 * 2 * NKV * sum(n - 1 for n in walks)


def test_grid_packs_the_group_into_64_row_blocks():
    """nano's prefill at S = 256 (Nq = 32, Nkv = 8): 16 positions x 4
    heads a block, 16 x 8 = 128 blocks; orin's 5-row verify is one query
    tile per kv head; a group of 1 takes 64 positions a block."""
    assert TF.flash_tc_grid(256, 32, 8, 1) == (16, 8, 1)
    assert TF.flash_tc_grid(2048, 32, 8, 1) == (128, 8, 1)
    assert TF.flash_tc_grid(5, 32, 8, 1) == (1, 8, 1)
    assert TF.flash_tc_grid(200, 8, 8, 2) == (4, 8, 2)
    assert TF.flash_tc_grid(100, 64 * 2, 2, 1) == (100, 2, 1)


# -- the CUDA wrappers ---------------------------------------------------------

def test_wrappers_read_no_device_value():
    """The CUDA path of the three wrappers launches from shapes only: no
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` in them, their
    launch helper or its checks."""
    for fn in (TF.flash_causal_attention, TF._check_causal,
               TF.flash_chunk_attention_q8, TF._tc_chunk, TF._launch_window,
               TF._check_window, TF._check_cache,
               TF._check_scales, TF._check_query, TF._check_common,
               TF.paged_chunk_attention, TF._check_paged_chunk):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)


@pytest.mark.parametrize("bad", ["group", "head_dim", "dtype", "kv_shape",
                                 "not_multiple", "misaligned", "q_dims"])
def test_causal_checks_refuse_what_the_kernel_does_not_take(bad):
    """The prefill's checks raise before any kernel is built or launched
    (here, on CPU tensors, a launch would need the CUDA toolkit)."""
    b, s, nkv, d = 1, 32, 2, 64
    nq = {"group": 2 * 65, "not_multiple": 3}.get(bad, 8)
    if bad == "head_dim":
        d = 32
    dt = torch.float32 if bad == "dtype" else torch.bfloat16
    q = torch.zeros((b, s, nq, d), dtype=dt)
    k = torch.zeros((b, s, nkv, d), dtype=dt)
    v = torch.zeros((b, s + (bad == "kv_shape"), nkv, d), dtype=dt)
    if bad == "misaligned":
        q = torch.zeros(q.numel() + 1, dtype=dt)[1:].view(q.shape)
    if bad == "q_dims":
        q = q[0]
    with pytest.raises(ValueError):
        TF._check_causal(q, k, v)


def test_causal_checks_accept_the_serving_shapes():
    for nq, nkv, d in ((32, 8, 64), (32, 8, 128), (8, 8, 64), (128, 2, 64)):
        q = torch.zeros((1, 100, nq, d), dtype=torch.bfloat16)
        k = torch.zeros((1, 100, nkv, d), dtype=torch.bfloat16)
        TF._check_causal(q, k, k.clone())


@pytest.mark.parametrize("bad", ["group", "cache_dtype", "scale_dtype",
                                 "head_dim", "pos_dtype", "misaligned"])
def test_chunk_q8_launch_refuses_what_the_kernel_does_not_take(bad):
    """The int8 chunk's launch helper raises before any kernel is built or
    launched."""
    b, s_c, nkv, d, s_max, w = 2, 5, 2, 64, 300, 200
    nq = nkv * (65 if bad == "group" else 4)
    if bad == "head_dim":
        d = 32
    q = torch.zeros((b, s_c, nq, d), dtype=torch.bfloat16)
    if bad == "misaligned":
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    cache = torch.zeros((b, s_max, nkv, d), dtype=torch.bfloat16
                        if bad == "cache_dtype" else torch.int8)[:, :w]
    scales = torch.ones((b, s_max, nkv), dtype=torch.float64
                        if bad == "scale_dtype" else torch.float32)[:, :w]
    pos = torch.zeros((b, s_c), dtype=torch.int64 if bad == "pos_dtype"
                      else torch.int32)
    with pytest.raises(ValueError):
        TF._tc_chunk(TF.flash_chunk_attention_q8, "flash_chunk_q8", q, cache,
                     cache, scales, scales, pos)


@pytest.mark.parametrize("bad", ["group", "misaligned"])
def test_paged_chunk_refuses_what_the_kernel_does_not_take(bad):
    """The paged chunk's CUDA path raises before any kernel is built or
    launched (a CUDA-like tensor is not at hand here: its checks run on
    CPU tensors through the wrapper's own helper)."""
    nkv, nb, bs, d, s_c = 2, 5, 64, 64, 5
    nq = nkv * (65 if bad == "group" else 4)
    q = torch.zeros((1, s_c, nq, d), dtype=torch.bfloat16)
    if bad == "misaligned":
        q = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    pool = torch.zeros((nkv, nb, bs, d), dtype=torch.bfloat16)
    table = torch.arange(1, 3, dtype=torch.int32)
    start = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TF._check_paged_chunk(q, pool, pool, table, start, 2 * bs)
