"""The split-K algorithm of the ragged verify kernels (K4 bf16, K6 int8).

The card's kernels (``csrc/ragged_verify.cuh``) split each slot's tiles
over many blocks, write float32 partials (m, l, acc) per row and merge
them in a second pass.  ``ops/ragged_attention.py`` repeats that
algorithm in plain PyTorch (``split_verify_partials``,
``merge_split_partials``, ``split_verify_mirror``) and plans the split
from shapes alone (``split_plan``).  Here, on the CPU:

- the mirror, at 1, 2 and 3 tiles a split, over a bf16 and an int8 pool,
  G in {1, 3, 5} and GQA groups 1, 2, 4, with an idle slot, a slot ending
  at the table's end and slots whose G rows straddle a split boundary,
  against the port's plain version ``_gather_verify_paged`` in float32
  (atol 1e-5: the same arithmetic, another summation order) and the JAX
  Pallas verify kernels in interpret mode (atol 2e-5, float32, as
  tests/test_torch_spec.py);
- a row whose frontier ends before a live split leaves an empty partial
  there (l = 0, m at the sentinel) that the merge weighs 0, and the merge
  reads only the splits the slot's frontier reaches;
- the plan is ints in, ints out, and at orin's timed verify gives more
  live blocks than the H100's 132 SMs; the CUDA wrappers read no device
  value.
"""

from __future__ import annotations

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu.ops import ragged_attention as JR
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import ragged_attention as TR

NKV, D, BS, MB = 2, 16, 8, 8


def _case(pool: str, g: int, group: int):
    """q and a pool (bf16 values, or int8 with the JAX quantizer's scales)
    for 4 slots: 0 idle (its row on the trash block), 1 at 14 and 2 at 22
    (a G = 3 or 5 chunk straddles the tile edges at 16 and 24, split
    boundaries at 1, 2 and 3 tiles a split), 3 ending at the table's end.
    Returns numpy arrays: q, k, v, k_scale, v_scale, tables, pos."""
    rng = np.random.default_rng(100 * g + 10 * group + (pool == "int8"))
    b, nq, nb = 4, NKV * group, 4 * MB + 1

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()

    q = bf16(rng.standard_normal((b, g, nq, D)))
    k = rng.standard_normal((NKV, nb, BS, D))
    v = rng.standard_normal((NKV, nb, BS, D))
    if pool == "int8":
        (k, ks), (v, vs) = ((np.array(a) for a in JQ.quantize_kv_rows(
            jnp.asarray(x, jnp.float32))) for x in (k, v))
    else:
        k, v, ks, vs = bf16(k), bf16(v), None, None
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, MB)
    tables[0] = 0
    pos = np.asarray([0, 14, 22, MB * BS - g], np.int32)
    return q, k, v, ks, vs, tables, pos


def _torch(case, pool: str):
    """The case as the kernel takes it: q bf16, the pool bf16 or int8."""
    q, k, v, ks, vs, tables, pos = (None if a is None else torch.from_numpy(a)
                                    for a in case)
    q = q.bfloat16()
    if pool == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    return q, k, v, ks, vs, tables, pos


_JAX = {}


def _jax_verify(pool: str, g: int, group: int) -> np.ndarray:
    """The JAX Pallas verify kernel (interpret mode on the CPU) on the
    case in float32, computed once per case."""
    key = (pool, g, group)
    if key not in _JAX:
        q, k, v, ks, vs, tables, pos = (None if a is None else jnp.asarray(a)
                                        for a in _case(pool, g, group))
        if pool == "int8":
            out = JR.ragged_paged_verify_attention_q8(q, k, v, ks, vs, tables,
                                                      pos)
        else:
            out = JR.ragged_paged_verify_attention(q, k, v, tables, pos)
        _JAX[key] = np.asarray(out, np.float32)
    return _JAX[key]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("tiles", [1, 2, 3])
@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_split_mirror_matches_plain_and_jax(pool, tiles, g, group):
    q, k, v, ks, vs, tables, pos = _torch(_case(pool, g, group), pool)
    out = TR.split_verify_mirror(q, k, v, tables, pos, tiles, ks, vs)
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = TA._gather_verify_paged(q.float(), k if ks is not None else k.float(),
                                    v if vs is not None else v.float(), tables,
                                    pos, ks, vs)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_verify(pool, g, group),
                               atol=2e-5, rtol=0)


def test_row_before_a_live_split_leaves_an_empty_partial():
    """Slot 2 at 22 with G = 5 and one tile a split: rows g = 0, 1
    (frontiers 22, 23) see nothing of split 3 (keys 24..31), which rows
    g = 2..4 reach.  Their partial there is empty, weighs 0, and the
    merged output stays finite and right."""
    pool, g, tiles = "bf16", 5, 1
    q, k, v, ks, vs, tables, pos = _torch(_case(pool, g, 2), pool)
    m, l, acc = TR.split_verify_partials(q, k, v, tables, pos, tiles)
    rows_g = torch.arange(m.shape[-1]) % g
    empty = m[2, :, 3][:, rows_g < 2]
    assert torch.all(empty == TA.NEG_INF)
    assert torch.all(l[2, :, 3][:, rows_g < 2] == 0)
    assert torch.all(acc[2, :, 3][:, rows_g < 2] == 0)
    assert torch.all(l[2, :, 3][:, rows_g >= 2] > 0)
    out = TR.merge_split_partials(m, l, acc, pos, g, BS, MB, tiles)
    assert torch.isfinite(out).all()
    plain = TA._gather_verify_paged(q.float(), k.float(), v.float(), tables,
                                    pos)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)


def test_merge_reads_only_the_splits_a_slot_reaches():
    """Splits past a slot's frontier are never read: NaN there changes
    nothing."""
    pool, g, tiles = "int8", 3, 2
    q, k, v, ks, vs, tables, pos = _torch(_case(pool, g, 4), pool)
    m, l, acc = TR.split_verify_partials(q, k, v, tables, pos, tiles, ks, vs)
    want = TR.merge_split_partials(m, l, acc, pos, g, BS, MB, tiles)
    n_tiles = torch.clamp((pos.long() + g - 1) // BS + 1, max=MB)
    for b, n in enumerate(n_tiles.tolist()):
        dead = -(-n // tiles)
        m[b, :, dead:], l[b, :, dead:], acc[b, :, dead:] = (float("nan"),) * 3
    assert torch.isnan(m).any()
    got = TR.merge_split_partials(m, l, acc, pos, g, BS, MB, tiles)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("mb,b,nkv", [(128, 4, 8), (128, 8, 8), (12, 4, 8),
                                      (20, 5, 2), (3, 1, 1), (512, 2, 1)])
def test_split_plan_is_ints_from_shapes(mb, b, nkv):
    tiles, splits = TR.split_plan(mb, b, nkv)
    assert type(tiles) is int and type(splits) is int
    assert tiles >= TR.SPLIT_MIN_TILES and splits >= 1
    assert splits * tiles >= mb > (splits - 1) * tiles


def test_split_plan_fills_the_card_at_orins_timed_verify():
    """orin_8b's verify as chip_smoke times it: 4 slots of an 8192-token
    context in 64-token blocks (MB = 128), 8 kv heads, G = 5 at positions
    0 (idle), 100, 3000 and 8187: 192 live blocks, more than 132 SMs."""
    mb, b, nkv, g = 8192 // 64, 4, 8, 5
    tiles, splits = TR.split_plan(mb, b, nkv)
    assert (tiles, splits) == (8, 16)
    live = nkv * sum(-(-min(mb, (p + g - 1) // 64 + 1) // tiles)
                     for p in (0, 100, 3000, 8187))
    assert live == 192 > 132


def test_verify_wrappers_read_no_device_value():
    """The CUDA path of both wrappers plans from shapes only: no
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` anywhere in
    them, their launch helper or the plan."""
    for fn in (TR.ragged_paged_verify_attention,
               TR.ragged_paged_verify_attention_q8, TR._launch_verify,
               TR.split_plan):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)
