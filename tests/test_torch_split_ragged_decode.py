"""The split-K algorithm of the int8 ragged decode kernel (K5).

On the card the one-token decode over the int8 paged pool is the int8
verify kernel's split pass and merge at G = 1 (``csrc/ragged_verify.cuh``
over the pool, entered by ``csrc/ragged_decode_q8.cu``): each slot's
blocks are split over many blocks by ``ragged_decode_split_plan`` (shapes
in, ints out), each block writes float32 partials (m, l, acc) per query
row, and a merge pass combines them over the splits the slot's frontier
reaches.  ``ops/ragged_attention.py`` repeats that in plain PyTorch
(``split_verify_mirror`` at G = 1).  Here, on the CPU, with inputs from a
numpy seed:

- the mirror at 1, 2 and 3 blocks a split and at the plan's own, over an
  int8 pool (the JAX quantizer's values and scales), head dim 16 and 64,
  GQA groups 1, 4 and 8, 16-position blocks, with an idle slot (its row
  on the trash block, position 0), frontiers on a split boundary, on the
  first key past it, one block past it and at the table's end, against
  the port's plain version ``_gather_decode_paged`` in float32 (atol
  1e-5: the same arithmetic in another summation order) and the JAX
  Pallas kernel ``ragged_paged_decode_attention_q8`` in interpret mode
  (atol 2e-5, float32, as tests/test_torch_kv_int8.py);
- the plan is ints from shapes, as fine as the contiguous decode's, and
  at orin's int8 pool gives a slot at its context's end 128 live blocks;
- the CUDA wrapper reads no device value and refuses what the kernel
  does not take.
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

NKV, BS, MB = 2, 16, 12


def _case(d: int, group: int, tiles: int):
    """q (bf16 values held in float32) and an int8 pool with the JAX
    quantizer's scales for 5 slots: 0 idle (its whole row on the trash
    block 0, position 0), then frontiers on the first split boundary
    (``edge - 1``, the last key of split 0), on the first key past it, one
    block past it, and at the table's end.  Returns numpy arrays q, k, v,
    k_scale, v_scale, tables, pos."""
    rng = np.random.default_rng(100 * d + 10 * group + tiles)
    b, nq, nb = 5, NKV * group, 5 * MB + 1
    q = torch.from_numpy(rng.standard_normal((b, nq, d)).astype(
        np.float32)).bfloat16().float().numpy()
    (k, ks), (v, vs) = ((np.array(a) for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.standard_normal((NKV, nb, BS, d)), jnp.float32)))
        for _ in range(2))
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, MB)
    tables[0] = 0
    edge = tiles * BS
    pos = np.asarray([0, edge - 1, edge, edge + BS, MB * BS - 1], np.int32)
    return q, k, v, ks, vs, tables, pos


_JAX = {}


def _jax_decode(d: int, group: int, tiles: int) -> np.ndarray:
    """The JAX Pallas int8 decode kernel (interpret mode on the CPU) on the
    case in float32, computed once per case."""
    key = (d, group, tiles)
    if key not in _JAX:
        args = (jnp.asarray(a) for a in _case(d, group, tiles))
        _JAX[key] = np.asarray(JR.ragged_paged_decode_attention_q8(*args),
                               np.float32)
    return _JAX[key]


def _plan_tiles() -> int:
    tiles, _ = TR.ragged_decode_split_plan(MB, 5, NKV)
    return tiles


@pytest.mark.parametrize("tiles", [1, 2, 3, "plan"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("d", [16, 64])
def test_split_mirror_matches_plain_and_jax(d, group, tiles):
    tiles = _plan_tiles() if tiles == "plan" else tiles
    q, k, v, ks, vs, tables, pos = (torch.from_numpy(a)
                                    for a in _case(d, group, tiles))
    out = TR.split_verify_mirror(q[:, None], k, v, tables, pos, tiles, ks,
                                 vs)[:, 0]
    assert out.dtype == torch.float32 and out.shape == q.shape
    plain = TA._gather_decode_paged(q, k, v, tables, pos, ks, vs)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), _jax_decode(d, group, tiles),
                               atol=2e-5, rtol=0)


def test_idle_slot_reads_only_the_trash_block():
    """The idle slot (position 0 on the trash block) has one live split of
    one key; its other splits are empty partials that weigh 0."""
    tiles = 1
    q, k, v, ks, vs, tables, pos = (torch.from_numpy(a)
                                    for a in _case(16, 4, tiles))
    m, l, acc = TR.split_verify_partials(q[:, None], k, v, tables, pos, tiles,
                                         ks, vs)
    assert torch.all(l[0, :, 0] > 0)
    assert torch.all(m[0, :, 1:] == TA.NEG_INF) and not l[0, :, 1:].any()
    out = TR.merge_split_partials(m, l, acc, pos, 1, BS, MB, tiles)[:, 0]
    # One key: the output is that key's dequantized V row, per kv head.
    v0 = v[:, 0, 0].float() * vs[:, 0, 0, None]
    want = v0.repeat_interleave(4, 0)
    np.testing.assert_allclose(out[0].numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("mb,b,nkv", [(128, 4, 8), (128, 8, 8), (12, 5, 2),
                                      (3, 1, 1), (512, 2, 1), (128, 1, 8)])
def test_ragged_decode_split_plan_is_ints_from_shapes(mb, b, nkv):
    tiles, splits = TR.ragged_decode_split_plan(mb, b, nkv)
    assert type(tiles) is int and type(splits) is int
    assert tiles >= 1 and splits * tiles >= mb > (splits - 1) * tiles
    # As fine as SPLIT_TARGET_BLOCKS blocks over the whole table ask, the
    # contiguous decode's plan over as many tiles.
    assert b * nkv * mb <= tiles * TR.SPLIT_TARGET_BLOCKS
    assert tiles == 1 or b * nkv * mb > (tiles - 1) * TR.SPLIT_TARGET_BLOCKS
    assert (tiles, splits) == TR.decode_split_plan(mb * TR.DECODE_TILE, b,
                                                   nkv)


def test_ragged_decode_split_plan_at_orins_int8_pool():
    """orin_8b's int8 pool as chip_smoke times it (4 slots, 8 kv heads,
    128 blocks of 64 a row): 8 blocks a split, 16 splits; the slot at its
    context's end streams from 128 blocks, the batch at positions 0, 100,
    3000 and 8191 from 8 x (1 + 1 + 6 + 16) = 192, where one block per
    (kv head, slot) was 32.  The verify's plan at this shape is the same;
    a decode block's partials are 5x smaller, so no floor holds it back."""
    tiles, splits = TR.ragged_decode_split_plan(128, 4, 8)
    assert (tiles, splits) == (8, 16)
    live = 8 * sum(-(-(p // 64 + 1) // tiles) for p in (0, 100, 3000, 8191))
    assert live == 192 > 132


def test_ragged_decode_q8_wrapper_reads_no_device_value():
    """The CUDA path plans from shapes only: no ``.item()``, ``.tolist()``,
    ``.cpu()`` or ``.numpy()`` in the wrapper, its launch helper, its
    checks or the plan."""
    for fn in (TR.ragged_paged_decode_attention_q8, TR._launch_verify,
               TR._check, TR.ragged_decode_split_plan, TR._fine_split):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        reads = [n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                 and n.attr in ("item", "tolist", "cpu", "numpy")]
        assert not reads, (fn.__name__, reads)


@pytest.mark.parametrize("bad", ["group", "head_dim", "pool_dtype",
                                 "scale_dtype", "pos_dtype", "block"])
def test_ragged_decode_q8_checks_refuse_what_the_kernel_does_not_take(bad):
    """The wrapper's checks raise before any kernel is built or launched
    (here, on CPU tensors, a launch would need the CUDA toolkit)."""
    b, nkv, nb, mb = 2, 2, 9, 4
    bs = 16 if bad == "block" else 64
    d = 32 if bad == "head_dim" else 64
    nq = nkv * (16 if bad == "group" else 4)
    q = torch.zeros((b, nq, d), dtype=torch.bfloat16)
    pool = torch.zeros((nkv, nb, bs, d), dtype=torch.bfloat16
                       if bad == "pool_dtype" else torch.int8)
    scales = torch.ones((nkv, nb, bs), dtype=torch.float64
                        if bad == "scale_dtype" else torch.float32)
    tables = torch.zeros((b, mb), dtype=torch.int32)
    pos = torch.zeros(b, dtype=torch.int64 if bad == "pos_dtype"
                      else torch.int32)
    with pytest.raises(ValueError):
        TR._check("ragged_paged_decode_attention_q8", q, pool, pool, tables,
                  pos, scales, scales, 1)
