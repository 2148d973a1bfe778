"""Attention parity between the PyTorch port and the JAX package.

The same numpy inputs (seeded) go through the port's plain attention
versions (what a CPU tensor takes) and through the JAX package's plain
XLA functions and its Pallas kernels (interpret mode off-TPU, as
tests/test_pallas_attention.py and tests/test_ragged_parity.py run
them).  Tolerances: float32 atol 1e-5 (same algorithm, different
summation order); bf16 atol 2e-2 (the Pallas kernels round at other
points than the plain path: they scale q in float32 before QK and keep
the logits in float32, the plain path rounds the logits to bf16 first).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.ops import attention as JA
from distributed_llm_tpu.ops import pallas_attention as JP
from distributed_llm_tpu.ops import ragged_attention as JR
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import ragged_attention as TR

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _arr(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, jdt, tdt):
    """One numpy array -> (jax array, torch tensor), same dtype."""
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _ragged_case(rng, *, b=4, nq=4, nkv=2, d=16, bs=16, mb=8, idle=(0,)):
    """Pools with a shuffled block assignment, skewed per-slot positions,
    and idle slots pointing their whole row at the trash block 0."""
    nb = b * mb + 1
    q, kp, vp = _arr(rng, (b, nq, d)), _arr(rng, (nkv, nb, bs, d)), \
        _arr(rng, (nkv, nb, bs, d))
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    pos = np.asarray([5, 37, 120, mb * bs - 1][:b], np.int32)
    for s in idle:
        tables[s] = 0
        pos[s] = 0
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
def test_ragged_decode_plain_matches_jax(dtype, groups):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, kp, vp, tables, pos = _ragged_case(rng, nq=2 * groups, nkv=2)
    jq, tq = _both(q, jdt, tdt)
    jk, tk = _both(kp, jdt, tdt)
    jv, tv = _both(vp, jdt, tdt)
    t_tables, t_pos = torch.from_numpy(tables), torch.from_numpy(pos)
    port = TA.ragged_decode(tq, tk, tv, t_tables, t_pos)
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA._gather_decode_paged(jq, jk, jv, jnp.asarray(tables),
                                         jnp.asarray(pos), None, None), atol)
    _close(port, JR.ragged_paged_decode_attention(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos)), atol)
    # The kernel wrapper takes the same plain version for CPU tensors.
    _close(TR.ragged_paged_decode_attention(tq, tk, tv, t_tables, t_pos),
           port, 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", [16, 32])
def test_causal_plain_matches_jax(dtype, s):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    q, k, v = (_arr(rng, (2, s, 4, 16)), _arr(rng, (2, s, 2, 16)),
               _arr(rng, (2, s, 2, 16)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, k, v))
    port = TA.causal(tq, tk, tv)
    assert port.dtype == tdt
    _close(port, JA.causal_attention(jq, jk, jv), atol)
    _close(port, JP.flash_causal_attention(jq, jk, jv), atol)
    _close(TF.flash_causal_attention(tq, tk, tv), port, 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("start,s_c,window", [(0, 16, 32), (20, 16, 64),
                                              (37, 32, 96)])
def test_paged_chunk_plain_matches_jax(dtype, start, s_c, window):
    """Suffix chunk at ``start`` against a window shorter than the
    table's span; rows past the true length are don't-care (the kernel's
    frontier is start + r unclamped, the plain path clamps)."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(2)
    nq, nkv, d, bs, mb = 4, 2, 16, 16, 8
    nb = mb + 3
    q = _arr(rng, (1, s_c, nq, d))
    kp, vp = _arr(rng, (nkv, nb, bs, d)), _arr(rng, (nkv, nb, bs, d))
    table = rng.permutation(np.arange(1, nb))[:mb].astype(np.int32)
    true_len = start + s_c - 3                      # three padded rows
    q_pos = np.minimum(start + np.arange(s_c), true_len - 1)[None]
    valid = true_len - start
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, kp, vp))
    t_table = torch.from_numpy(table)
    t_start = torch.tensor([start], dtype=torch.int32)
    port = TA.paged_chunk(tq, tk, tv, t_table, t_start,
                          torch.from_numpy(q_pos), window)
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA.paged_chunk(jq, jk, jv, jnp.asarray(table),
                                jnp.asarray([start], jnp.int32),
                                jnp.asarray(q_pos), window, impl="xla"), atol)
    kern = JP.paged_chunk_attention(jq, jk, jv, jnp.asarray(table),
                                    jnp.asarray([start], jnp.int32), window)
    _close(port[:, :valid], kern[:, :valid], atol)
    _close(TF.paged_chunk_attention(tq, tk, tv, t_table, t_start, window,
                                    q_pos=torch.from_numpy(q_pos)), port, 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_and_chunk_attention_match_jax(dtype):
    """The contiguous-cache plain functions behind the paged ones."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q1, qc = _arr(rng, (3, 4, 16)), _arr(rng, (3, 8, 4, 16))
    kc, vc = _arr(rng, (3, 48, 2, 16)), _arr(rng, (3, 48, 2, 16))
    pos = np.asarray([0, 17, 47], np.int32)
    qpos = (np.asarray([0, 9, 40])[:, None] + np.arange(8)[None]).astype(np.int32)
    (jq1, tq1), (jqc, tqc), (jk, tk), (jv, tv) = (
        _both(x, jdt, tdt) for x in (q1, qc, kc, vc))
    _close(TA.decode_attention(tq1, tk, tv, torch.from_numpy(pos)),
           JA.decode_attention(jq1, jk, jv, jnp.asarray(pos)), atol)
    _close(TA.chunk_attention(tqc, tk, tv, torch.from_numpy(qpos)),
           JA.chunk_attention(jqc, jk, jv, jnp.asarray(qpos)), atol)


def test_plain_versions_count_their_calls():
    rng = np.random.default_rng(4)
    q, kp, vp, tables, pos = _ragged_case(rng)
    before = TA._gather_decode_paged.calls
    TA.ragged_decode(*(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)))
    assert TA._gather_decode_paged.calls == before + 1


def test_cpu_tensors_never_launch_kernels():
    """A kernel wrapper given CPU tensors runs the plain version and
    counts no launch; the paged chunk's plain version needs q_pos."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, pos = _ragged_case(rng)
    before = TR.ragged_paged_decode_attention.launches
    TR.ragged_paged_decode_attention(
        *(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)))
    assert TR.ragged_paged_decode_attention.launches == before
    with pytest.raises(ValueError):
        TF.paged_chunk_attention(torch.zeros(1, 4, 4, 16),
                                 torch.zeros(2, 3, 16, 16),
                                 torch.zeros(2, 3, 16, 16),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32), 32)
