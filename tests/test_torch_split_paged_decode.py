"""The split-K algorithm of the bf16 ragged decode kernel (K1) and the
dense-tick decode kernels, bf16 (K7) and int8 (K8).

On the card all three are the split kernel's split pass and merge over
the pool at G = 1 (``csrc/ragged_verify.cuh``, entered by
``csrc/ragged_decode.cu``, ``csrc/paged_decode.cu`` and
``csrc/paged_decode_q8.cu``), planned by ``ragged_decode_split_plan``
(shapes in, ints out).  K1 walks each slot's full table row over a bf16
pool; K7 and K8 walk a window ``full[:, :wb]`` of the table over a bf16
and an int8 pool, a column slice the kernel reads through the full
table's row stride.  ``ops/ragged_attention.py`` repeats the
algorithm in plain PyTorch (``split_verify_mirror`` at G = 1).  Here, on
the CPU, with inputs from a numpy seed:

- K1: the mirror over a bf16 pool (values held in float32) at 1, 2 and 3
  blocks a split and at the plan's own, head dim 16 and 64, GQA groups 1,
  4 and 8, 16-position blocks, with an idle slot (its row on the trash
  block, position 0), frontiers on the last key of a split and on the
  first key past it for 1, 2 and 3 blocks a split, and at the table's
  end, against the port's plain version ``_gather_decode_paged`` in
  float32 (atol 1e-5: the same arithmetic in another summation order) and
  the JAX Pallas kernel ``ragged_paged_decode_attention`` in interpret
  mode (atol 2e-5, float32);
- K7: the same mirror over a bf16 pool through a window ``full[:, :wb]``
  of a wider table, at wb = 1, a middle wb and wb = MB, the frontiers
  clipped to the window, head dim 64 and 128, against
  ``_gather_decode_windowed`` and the JAX Pallas kernel
  ``paged_decode_attention`` in interpret mode, at the same tolerances;
- K8: the same mirror over an int8 pool (the JAX quantizer's values and
  scales) through such a window, against ``_gather_decode_windowed`` and
  the JAX Pallas kernel ``paged_decode_attention_q8`` in interpret mode,
  at the same tolerances;
- the plan is ints from shapes and gives the live-block counts of the
  timed shapes: 176 at nano's 8 slots, 264 at nano's dense tick and 184
  at orin's in a 2048 window, at most 16 splits a row at every window
  rung;
- the CUDA wrappers read no device value and refuse what the kernel does
  not take, including a table whose columns are not dense.
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
from distributed_llm_tpu.ops import ragged_attention as JR
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import ragged_attention as TR
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


NKV, BS, MB, B = 2, 16, 12, 6


def _positions(limit: int) -> np.ndarray:
    """6 slots: 0 idle, then the last key of a split and the first key
    past it at 2 and at 3 blocks a split (both boundaries of 1 block a
    split too), and the last position, each clipped below ``limit``."""
    pos = [0, 2 * BS - 1, 2 * BS, 3 * BS - 1, 3 * BS, limit - 1]
    return np.minimum(np.asarray(pos, np.int32), limit - 1)


def _pools(rng, d: int, group: int, q8: bool):
    """q (bf16 values held in float32) and a pool of B * MB + 1 blocks:
    bf16 values held in float32, or int8 with the JAX quantizer's scales.
    Returns q, k, v, k_scale, v_scale (None for bf16) and a shuffled full
    table [B, MB] with slot 0's row on the trash block 0."""
    nq, nb = NKV * group, B * MB + 1
    q = torch.from_numpy(rng.standard_normal((B, nq, d)).astype(
        np.float32)).bfloat16().float().numpy()
    raw = [rng.standard_normal((NKV, nb, BS, d)).astype(np.float32)
           for _ in range(2)]
    if q8:
        (k, ks), (v, vs) = ((np.array(a) for a in JQ.quantize_kv_rows(
            jnp.asarray(x))) for x in raw)
    else:
        k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in raw)
        ks = vs = None
    full = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(B, MB)
    full[0] = 0
    return q, k, v, ks, vs, full


def _k1_case(d: int, group: int):
    """K1's inputs as numpy: q, k, v, tables (full rows), pos."""
    rng = np.random.default_rng(10 * d + group)
    q, k, v, _, _, tables = _pools(rng, d, group, q8=False)
    return q, k, v, tables, _positions(MB * BS)


def _k8_case(d: int, group: int, wb: int):
    """K8's inputs as numpy: q, k, v, k_scale, v_scale, the full table
    [B, MB] (the window is its first ``wb`` columns) and pos, every
    position below wb * BS."""
    rng = np.random.default_rng(100 * d + 10 * group + wb)
    q, k, v, ks, vs, full = _pools(rng, d, group, q8=True)
    return q, k, v, ks, vs, full, _positions(wb * BS)


def _k7_case(d: int, group: int, wb: int):
    """K7's inputs as numpy: q, k, v (bf16 values held in float32), the
    full table [B, MB] (the window is its first ``wb`` columns) and pos,
    every position below wb * BS."""
    rng = np.random.default_rng(1000 + 100 * d + 10 * group + wb)
    q, k, v, _, _, full = _pools(rng, d, group, q8=False)
    return q, k, v, full, _positions(wb * BS)


_JAX = {}


def _jax_k1(d: int, group: int) -> np.ndarray:
    """The JAX Pallas bf16 ragged decode kernel (interpret mode on the
    CPU) on the case in float32, computed once per case."""
    key = ("k1", d, group)
    if key not in _JAX:
        args = (jnp.asarray(a) for a in _k1_case(d, group))
        _JAX[key] = np.asarray(JR.ragged_paged_decode_attention(*args),
                               np.float32)
    return _JAX[key]


def _jax_k8(d: int, group: int, wb: int) -> np.ndarray:
    """The JAX Pallas int8 paged decode kernel (interpret mode on the CPU)
    on the case's window in float32, computed once per case."""
    key = ("k8", d, group, wb)
    if key not in _JAX:
        q, k, v, ks, vs, full, pos = _k8_case(d, group, wb)
        args = (jnp.asarray(a) for a in (q, k, v, ks, vs,
                                         np.ascontiguousarray(full[:, :wb]),
                                         pos))
        _JAX[key] = np.asarray(JP.paged_decode_attention_q8(*args),
                               np.float32)
    return _JAX[key]


def _jax_k7(d: int, group: int, wb: int) -> np.ndarray:
    """The JAX Pallas bf16 paged decode kernel (interpret mode on the CPU)
    on the case's window in float32, computed once per case."""
    key = ("k7", d, group, wb)
    if key not in _JAX:
        q, k, v, full, pos = _k7_case(d, group, wb)
        args = (jnp.asarray(a) for a in (q, k, v,
                                         np.ascontiguousarray(full[:, :wb]),
                                         pos))
        _JAX[key] = np.asarray(JP.paged_decode_attention(*args), np.float32)
    return _JAX[key]


def _tiles(tiles, mb: int) -> int:
    return TR.ragged_decode_split_plan(mb, B, NKV)[0] if tiles == "plan" \
        else tiles


@pytest.mark.parametrize("tiles", [1, 2, 3, "plan"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 64])
def test_k1_split_mirror_matches_plain_and_jax(d, group, tiles):
    tiles = _tiles(tiles, MB)
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _k1_case(d, group))
    out = TR.split_verify_mirror(q[:, None], k, v, tables, pos, tiles)[:, 0]
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = TA._gather_decode_paged(q, k, v, tables, pos)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_k1(d, group), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("tiles", [1, 2, 3, "plan"])
@pytest.mark.parametrize("wb", [1, 7, MB])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 64])
def test_k8_split_mirror_through_a_window_matches_plain_and_jax(d, group, wb,
                                                                tiles):
    tiles = _tiles(tiles, wb)
    q, k, v, ks, vs, full, pos = (torch.from_numpy(a)
                                  for a in _k8_case(d, group, wb))
    window = full[:, :wb]                   # read in place, row stride MB
    assert window.stride() == (MB, 1)
    assert window.is_contiguous() == (wb == MB)
    out = TR.split_verify_mirror(q[:, None], k, v, window, pos, tiles, ks,
                                 vs)[:, 0]
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = TA._gather_decode_windowed(q, k, v, window, pos, ks, vs)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_k8(d, group, wb), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("tiles", [1, 2, 3, "plan"])
@pytest.mark.parametrize("wb", [1, 7, MB])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_k7_split_mirror_through_a_window_matches_plain_and_jax(d, group, wb,
                                                                tiles):
    """K7 over a bf16 pool through ``full[:, :wb]``: frontiers on the last
    key of a 2- and a 3-block split and one key past each (clipped to the
    window), an idle slot and the window's last position."""
    tiles = _tiles(tiles, wb)
    q, k, v, full, pos = (torch.from_numpy(a) for a in _k7_case(d, group, wb))
    window = full[:, :wb]                   # read in place, row stride MB
    assert window.stride() == (MB, 1)
    out = TR.split_verify_mirror(q[:, None], k, v, window, pos, tiles)[:, 0]
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = TA._gather_decode_windowed(q, k, v, window, pos)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_k7(d, group, wb), atol=2e-5,
                               rtol=0)


def test_k8_window_reads_only_its_columns():
    """Blocks named only past column wb - 1 never reach the output:
    poisoning them (NaN scales) leaves the mirror's window output as it
    was.  (The trash block 0 fills the idle slot's whole row, so it is
    inside the window too and stays clean.)"""
    q, k, v, ks, vs, full, pos = (torch.from_numpy(a)
                                  for a in _k8_case(16, 4, 7))
    window = full[:, :7]
    want = TR.split_verify_mirror(q[:, None], k, v, window, pos, 2, ks,
                                  vs)[:, 0]
    outside = torch.tensor(sorted(set(full[:, 7:].reshape(-1).tolist())
                                  - set(window.reshape(-1).tolist())))
    assert len(outside) == B * (MB - 7) - (MB - 7)
    ks2, vs2 = ks.clone(), vs.clone()
    ks2[:, outside] = float("nan")
    vs2[:, outside] = float("nan")
    got = TR.split_verify_mirror(q[:, None], k, v, window, pos, 2, ks2,
                                 vs2)[:, 0]
    assert torch.equal(got, want)


def test_k1_idle_slot_and_splits_past_the_frontier_weigh_nothing():
    """The idle slot (position 0 on the trash block) has one live split of
    one key; its other splits are empty partials (m at the sentinel, l 0)
    and its output is that key's V row, per kv head."""
    tiles = 1
    q, k, v, tables, pos = (torch.from_numpy(a) for a in _k1_case(16, 4))
    m, l, acc = TR.split_verify_partials(q[:, None], k, v, tables, pos, tiles)
    assert torch.all(l[0, :, 0] > 0)
    assert torch.all(m[0, :, 1:] == TA.NEG_INF) and not l[0, :, 1:].any()
    out = TR.merge_split_partials(m, l, acc, pos, 1, BS, MB, tiles)[:, 0]
    want = v[:, 0, 0].repeat_interleave(4, 0)
    np.testing.assert_allclose(out[0].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


def _live_blocks(pos, tiles: int, nkv: int, bs: int = 64) -> int:
    return nkv * sum(-(-(p // bs + 1) // tiles) for p in pos)


def test_plan_at_k1s_timed_shape():
    """nano_1b's 8-slot bf16 pool as chip_smoke times K1 (8 kv heads, 128
    blocks of 64 a row, positions 0 to 8191): 16 blocks a split, 8
    splits, 22 live splits and 176 live blocks where one block per (kv
    head, slot) was 64; a split reads at most 16 tiles.  The nano draft's
    4 slots in orin's speculative path: 8 blocks a split, 16 splits."""
    assert TR.ragged_decode_split_plan(128, 8, 8) == (16, 8)
    pos = (0, 40, 200, 700, 1500, 3000, 5000, 8191)
    assert _live_blocks(pos, 16, 8) == 176 == 8 * 22
    assert TR.ragged_decode_split_plan(128, 4, 8) == (8, 16)


def test_plan_at_k7s_timed_shapes():
    """nano_1b's dense tick as chip_smoke times K7 (8 slots, 8 kv heads, a
    2048 window: wb = 32 of the 128-column table, positions 0 to 2047): 4
    blocks a split, 8 splits, 33 live splits and 264 live blocks where
    one block per (kv head, slot) was 64; a live block reads at most 4
    tiles of 16 KB.  In the whole table (wb = MB = 128, K1's shape) the
    plan is K1's own."""
    assert TR.ragged_decode_split_plan(32, 8, 8) == (4, 8)
    pos = (0, 40, 200, 700, 1500, 1900, 1100, 2047)
    assert _live_blocks(pos, 4, 8) == 264 == 8 * 33
    assert TR.ragged_decode_split_plan(128, 8, 8) == (16, 8)


def test_plan_at_k8s_timed_shape_and_every_rung():
    """orin_8b's dense tick as chip_smoke times K8 (4 slots, 8 kv heads, a
    2048 window: wb = 32 of the 128-column table, positions 0, 100, 700,
    1900): 2 blocks a split, 16 splits, 23 live splits and 184 live
    blocks where there were 32.  At the rungs wb = 64 and 128, 4 and 8
    blocks a split; no rung gives a row more than 16 splits to merge."""
    assert TR.ragged_decode_split_plan(32, 4, 8) == (2, 16)
    assert _live_blocks((0, 100, 700, 1900), 2, 8) == 184 == 8 * 23
    assert TR.ragged_decode_split_plan(64, 4, 8) == (4, 16)
    assert TR.ragged_decode_split_plan(128, 4, 8) == (8, 16)
    for wb in (1, 2, 4, 8, 16, 32, 64, 128):
        tiles, splits = TR.ragged_decode_split_plan(wb, 4, 8)
        assert type(tiles) is int and type(splits) is int
        assert splits <= 16 and splits * tiles >= wb > (splits - 1) * tiles


def test_wrappers_read_no_device_value():
    """The CUDA paths plan from shapes only: no ``.item()``,
    ``.tolist()``, ``.cpu()`` or ``.numpy()`` in K1's, K7's and K8's
    wrappers, the launch helper, the checks or the plan."""
    for fn in (TR.ragged_paged_decode_attention, TF.paged_decode_attention,
               TF.paged_decode_attention_q8,
               TR._launch_verify, TR._check, TR.ragged_decode_split_plan,
               TR._fine_split):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)


def test_both_are_decode_entries_of_the_split_kernel():
    """K1, K7 and K8 launch the split kernel's decode entries (no G,
    planned by ``ragged_decode_split_plan``); the dense tick's K7 and K8
    alone take the table's row stride, a long long after the plan."""
    from distributed_llm_tpu_torch.ops import _build
    dense = {"paged_decode", "paged_decode_q8"}
    assert {"ragged_decode"} | dense <= set(TR._DECODE_ENTRIES)
    assert set(TR._STRIDED_ENTRIES) == dense
    for name, n_ptr in (("ragged_decode", 8), ("paged_decode", 8),
                        ("paged_decode_q8", 10)):
        _, argtypes = _build.SIGNATURES[name]
        assert argtypes[:n_ptr] == [_build._P] * n_ptr
        assert argtypes[n_ptr:n_ptr + 9] == [_build._I] * 9
    assert _build.SIGNATURES["ragged_decode"][1][-2:] == [_build._F,
                                                          _build._P]
    for name in dense:
        assert _build.SIGNATURES[name][1][-3:] == [_build._L, _build._F,
                                                   _build._P]


_BAD = ["group", "head_dim", "pool_dtype", "pos_dtype", "block",
        "column_stride", "overlapping_rows"]


def _bad_inputs(bad: str, q8: bool):
    b, nkv, nb, mb, wb = 2, 2, 9, 4, 3
    bs = 8 if bad == "block" else 64
    d = 32 if bad == "head_dim" else 64
    nq = nkv * (16 if bad == "group" else 4)
    q = torch.zeros((b, nq, d), dtype=torch.bfloat16)
    pool_dtype = torch.int8 if q8 else torch.bfloat16
    if bad == "pool_dtype":
        pool_dtype = torch.bfloat16 if q8 else torch.int8
    pool = torch.zeros((nkv, nb, bs, d), dtype=pool_dtype)
    scales = torch.ones((nkv, nb, bs)) if q8 else None
    full = torch.zeros((b, 2 * mb), dtype=torch.int32)
    tables = full[:, :wb] if q8 else full[:, :mb].contiguous()
    if bad == "column_stride":
        tables = full[:, ::2]
    if bad == "overlapping_rows":
        tables = torch.as_strided(full, (b, wb), (wb - 1, 1))
    pos = torch.zeros(b, dtype=torch.int64 if bad == "pos_dtype"
                      else torch.int32)
    return q, pool, scales, tables, pos


@pytest.mark.parametrize("bad", _BAD)
def test_k1_checks_refuse_what_the_kernel_does_not_take(bad):
    """K1 takes full table rows: any table that is not contiguous is
    refused, as every other input the kernel does not take (here, on CPU
    tensors, a launch would need the CUDA toolkit)."""
    q, pool, _, tables, pos = _bad_inputs(bad, q8=False)
    with pytest.raises(ValueError):
        TR._check("ragged_paged_decode_attention", q, pool, pool, tables, pos,
                  None, None, 1)


@pytest.mark.parametrize("bad", _BAD + ["scale_dtype"])
def test_k8_checks_refuse_what_the_kernel_does_not_take(bad):
    """K8 takes a window whose rows are dense at any row stride of at
    least wb: a table with a column stride, or rows that overlap, is
    refused, as every other input the kernel does not take."""
    q, pool, scales, tables, pos = _bad_inputs(bad, q8=True)
    if bad == "scale_dtype":
        scales = scales.double()
    with pytest.raises(ValueError):
        TR._check("paged_decode_attention_q8", q, pool, pool, tables, pos,
                  scales, scales, 1, strided_tables=True)


def test_k8_checks_take_a_column_slice():
    """The engine's window ``tables[:, :wb]`` passes the checks as it is
    (nothing copied)."""
    q, pool, scales, tables, pos = _bad_inputs("none", q8=True)
    assert not tables.is_contiguous()
    TR._check("paged_decode_attention_q8", q, pool, pool, tables, pos,
              scales, scales, 1, strided_tables=True)


@pytest.mark.parametrize("bad", _BAD)
def test_k7_checks_refuse_what_the_kernel_does_not_take(bad):
    """K7 takes a window whose rows are dense at any row stride of at
    least wb over a bf16 pool: a table with a column stride, rows that
    overlap or an int8 pool are refused, as every other input the kernel
    does not take."""
    q, pool, _, tables, pos = _bad_inputs(bad, q8=False)
    with pytest.raises(ValueError):
        TR._check("paged_decode_attention", q, pool, pool, tables, pos,
                  None, None, 1, strided_tables=True)


def test_k7_checks_take_a_column_slice():
    """K7's window ``tables[:, :wb]`` passes the checks as it is."""
    q, pool, _, tables, pos = _bad_inputs("none", q8=True)
    assert not tables.is_contiguous()
    TR._check("paged_decode_attention", q, pool.to(torch.bfloat16),
              pool.to(torch.bfloat16), tables, pos, None, None, 1,
              strided_tables=True)
