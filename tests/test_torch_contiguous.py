"""The contiguous KV cache of the sequential engines: the port against
the JAX package.

- The plain versions of the contiguous decode and chunk kernels (bf16
  and int8), which a CPU tensor takes, against the JAX plain XLA
  functions and the Pallas kernels in interpret mode (as
  tests/test_pallas_attention.py and tests/test_kv_quant.py run them):
  float32 atol 2e-5 (same algorithm, another summation order), bf16 atol
  2e-2 (the Pallas kernels scale q in float32 before QK and keep the
  logits, and for int8 the dequantized K/V and the probabilities, in
  float32 where the plain path rounds to bf16).  The Pallas chunk
  kernels rebuild positions as start + r, so rows past a chunk's true
  length are compared with the XLA function only.
- ``init_kv_cache``, ``seed_kv_cache``, ``chunk_prefill``,
  ``decode_step`` (bf16 and int8 caches) and ``decode_chunk`` against
  JAX at float32: logits atol 1e-4, float caches atol 1e-5.  An int8
  cache seeded from the same K/V is equal to JAX's, values and scales;
  once the two packages' own float32 products make the K/V (their sums
  run in another order), a row's scale may differ in its last bit and a
  value sitting on a rounding boundary by one step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import speculative as JS
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu.ops import attention as JA
from distributed_llm_tpu.ops import pallas_attention as JP
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import speculative as TS
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ATOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _arr(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, jdt, tdt):
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _q8(rng, shape):
    """A quantized cache (the JAX quantizer's values and scales, handed
    to both packages)."""
    q, s = JQ.quantize_kv_rows(jnp.asarray(_arr(rng, shape)))
    return np.array(q), np.array(s)


def _positions(b, s_max):
    """Skewed decode positions, 0 and S_max - 1 included."""
    return np.asarray([0, s_max - 1, s_max // 3][:b] if b > 1 else [s_max - 1],
                      np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("b,s_max", [(1, 256), (3, 512)])
def test_decode_plain_matches_jax(dtype, groups, b, s_max):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(groups * 10 + b)
    nkv, d = 2, 16
    q = _arr(rng, (b, nkv * groups, d))
    k, v = _arr(rng, (b, s_max, nkv, d)), _arr(rng, (b, s_max, nkv, d))
    pos = _positions(b, s_max)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, k, v))
    t_pos = torch.from_numpy(pos)
    calls = TA._decode_contiguous.calls
    port = TA.decode(tq, tk, tv, t_pos)
    assert TA._decode_contiguous.calls == calls + 1
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA.decode_attention(jq, jk, jv, jnp.asarray(pos)), atol)
    _close(port, JP.flash_decode_attention(jq, jk, jv, jnp.asarray(pos)), atol)
    launches = TF.flash_decode_attention.launches
    _close(TF.flash_decode_attention(tq, tk, tv, t_pos), port, 0)
    assert TF.flash_decode_attention.launches == launches


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 4])
def test_decode_q8_plain_matches_jax(dtype, groups):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(20 + groups)
    b, s_max, nkv, d = 3, 256, 2, 16
    q = _arr(rng, (b, nkv * groups, d))
    (kq, ks), (vq, vs) = _q8(rng, (b, s_max, nkv, d)), _q8(rng, (b, s_max, nkv, d))
    pos = _positions(b, s_max)
    jq, tq = _both(q, jdt, tdt)
    jargs = [jnp.asarray(a) for a in (kq, vq, ks, vs)]
    targs = [torch.from_numpy(a) for a in (kq, vq, ks, vs)]
    t_pos = torch.from_numpy(pos)
    calls = TA._decode_contiguous_q8.calls
    port = TA.decode(tq, targs[0], targs[1], t_pos, targs[2], targs[3])
    assert TA._decode_contiguous_q8.calls == calls + 1
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA.decode(jq, jargs[0], jargs[1], jnp.asarray(pos), impl="xla",
                           k_scale=jargs[2], v_scale=jargs[3]), atol)
    _close(port, JP.flash_decode_attention_q8(jq, *jargs, jnp.asarray(pos)),
           atol)
    launches = TF.flash_decode_attention_q8.launches
    _close(TF.flash_decode_attention_q8(tq, *targs, t_pos), port, 0)
    assert TF.flash_decode_attention_q8.launches == launches


def _chunk_case(rng, s_c, w, start, pad, b=2, nq=4, nkv=2, d=16):
    """A chunk of ``s_c`` rows at ``start`` (the second sequence 16
    positions later) over a W-position window, its last ``pad`` rows
    past the true length (their positions clamped, as chunk_prefill
    does)."""
    q = _arr(rng, (b, s_c, nq, d))
    starts = start + 16 * np.arange(b)[:, None]
    raw = starts + np.arange(s_c)[None]
    q_pos = np.minimum(raw, starts + s_c - pad - 1).astype(np.int32)
    return q, raw.astype(np.int32), q_pos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s_c,w,start", [(16, 64, 0), (32, 128, 40),
                                         (512, 640, 100)])
def test_chunk_plain_matches_jax(dtype, s_c, w, start):
    """Both Pallas regimes: the native kernel (S_c <= 256) and the wide
    one (S_c = 512)."""
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(s_c)
    q, raw, q_pos = _chunk_case(rng, s_c, w, start, pad=3)
    k, v = _arr(rng, (2, w, 2, 16)), _arr(rng, (2, w, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, jdt, tdt) for x in (q, k, v))
    calls = TA._chunk_contiguous.calls
    port = TA.chunk(tq, tk, tv, torch.from_numpy(q_pos))
    assert TA._chunk_contiguous.calls == calls + 1
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA.chunk_attention(jq, jk, jv, jnp.asarray(q_pos)), atol)
    real = s_c - 3
    kern = JP.flash_chunk_attention(jq, jk, jv, jnp.asarray(raw))
    _close(port[:, :real], kern[:, :real], atol)
    _close(TF.flash_chunk_attention(tq, tk, tv, torch.from_numpy(q_pos)),
           port, 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s_c,w,start", [(16, 64, 0), (512, 640, 100)])
def test_chunk_q8_plain_matches_jax(dtype, s_c, w, start):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(100 + s_c)
    q, raw, q_pos = _chunk_case(rng, s_c, w, start, pad=3)
    (kq, ks), (vq, vs) = _q8(rng, (2, w, 2, 16)), _q8(rng, (2, w, 2, 16))
    jq, tq = _both(q, jdt, tdt)
    jargs = [jnp.asarray(a) for a in (kq, vq, ks, vs)]
    targs = [torch.from_numpy(a) for a in (kq, vq, ks, vs)]
    calls = TA._chunk_contiguous_q8.calls
    port = TA.chunk(tq, targs[0], targs[1], torch.from_numpy(q_pos), targs[2],
                    targs[3])
    assert TA._chunk_contiguous_q8.calls == calls + 1
    _close(port, JA.chunk(jq, jargs[0], jargs[1], jnp.asarray(q_pos),
                          impl="xla", k_scale=jargs[2], v_scale=jargs[3]), atol)
    real = s_c - 3
    kern = JP.flash_chunk_attention_q8(jq, *jargs, jnp.asarray(raw))
    _close(port[:, :real], kern[:, :real], atol)
    _close(TF.flash_chunk_attention_q8(tq, *targs, torch.from_numpy(q_pos)),
           port, 0)


def test_kernel_wrappers_check_the_cache_layout():
    """The kernels read a window of a longer cache in place through its
    batch stride; any other layout raises instead of being copied."""
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    cache = torch.zeros(2, 300, 2, 64, dtype=torch.bfloat16)
    window = cache[:, :200]
    assert not window.is_contiguous()
    assert TF._check_cache("f", q, window, window, q8=False) == (200, 2,
                                                                 300 * 128)
    with pytest.raises(ValueError, match="dense"):
        TF._check_cache("f", q, cache.transpose(1, 2), cache.transpose(1, 2),
                        q8=False)
    with pytest.raises(ValueError, match="int8"):
        TF._check_cache("f", q, window, window, q8=True)
    scales = torch.ones(2, 300, 2)
    assert TF._check_scales("f", window, scales[:, :200],
                            scales[:, :200]) == 600
    with pytest.raises(ValueError, match="positions"):
        TF._check_query("f", q, 2, torch.zeros(2, dtype=torch.int64), 8)


# -- the model functions ------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    jparams = JT.init_params(jcfg, 0)
    return jcfg, jparams, tcfg, params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams))


def _caches_match(tcache, jcache, exact=False):
    """Float caches within 1e-5; int8 values and scales equal when
    ``exact`` (the same K/V went in), else scales within 1e-6 relative
    and values within one step on at most 1% of them."""
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        t, j = tcache[name].numpy(), np.asarray(jcache[name])
        assert t.shape == j.shape and str(t.dtype) == str(j.dtype)
        if tcache["k"].dtype != torch.int8:
            _close(t, j, 1e-5)
        elif exact:
            np.testing.assert_array_equal(t, j)
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        else:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("kvq", ["none", "int8"])
def test_cache_prefill_chunk_and_decode_match_jax(models, kvq):
    """A prefill seeded into a 64-position cache, a suffix chunk with
    three padded rows against a 32-position window, and three decode
    steps, all against JAX at float32."""
    jcfg, jparams, tcfg, model = models
    _caches_match(TT.init_kv_cache(tcfg, 1, 64, kvq),
                  JT.init_kv_cache(jcfg, 1, 64, kvq), exact=True)
    rng = np.random.default_rng(7)
    s, n = 16, 13
    toks = rng.integers(0, jcfg.vocab_size, (1, s)).astype(np.int32)
    positions = np.arange(s, dtype=np.int32)[None]
    _, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks),
                             jnp.asarray(positions))
    _, (tk, tv) = TT.prefill(tcfg, model, torch.from_numpy(toks).long(),
                             torch.from_numpy(positions))
    _caches_match(TT.seed_kv_cache(tcfg, torch.from_numpy(np.array(jk)),
                                   torch.from_numpy(np.array(jv)), 64, kvq),
                  JT.seed_kv_cache(jcfg, jk, jv, 64, kvq), exact=True)
    jcache = JT.seed_kv_cache(jcfg, jk, jv, 64, kvq)
    tcache = TT.seed_kv_cache(tcfg, tk, tv, 64, kvq)
    _caches_match(tcache, jcache)

    chunk = rng.integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    true_len = n + 13
    jh, jcache = JT.chunk_prefill(jcfg, jparams, jnp.asarray(chunk),
                                  jnp.asarray([n], jnp.int32),
                                  jnp.asarray([true_len], jnp.int32), jcache,
                                  window=32)
    th = TT.chunk_prefill(tcfg, model, torch.from_numpy(chunk).long(),
                          torch.tensor([n], dtype=torch.int32),
                          torch.tensor([true_len], dtype=torch.int32), tcache,
                          window=32)
    _close(TT.logits_from_hidden(model, th[:, :13]),
           JT.logits_from_hidden(jparams, jh[:, :13]))
    _caches_match(tcache, jcache)

    cur, pos = np.asarray([7], np.int32), true_len
    for _ in range(3):
        jl, jcache = JT.decode_step(jcfg, jparams, jnp.asarray(cur),
                                    jnp.asarray([pos], jnp.int32), jcache)
        tl = TT.decode_step(tcfg, model, torch.from_numpy(cur).long(),
                            torch.tensor([pos], dtype=torch.int32), tcache)
        _close(tl, jl)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        pos += 1
    _caches_match(tcache, jcache)


def test_decode_chunk_matches_jax(models):
    """The verify chunk (γ+1 = 5 rows at position 9 of a 32-position
    cache) against JAX at float32, and its greedy picks against five
    sequential decode steps."""
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (1, 5)).astype(np.int32)
    start = 9
    jcache = JT.init_kv_cache(jcfg, 1, 32)
    tcache = TT.init_kv_cache(tcfg, 1, 32)
    jl, jcache = JS.decode_chunk(jcfg, jparams, jnp.asarray(toks),
                                 jnp.asarray([start], jnp.int32), jcache)
    tl = TS.decode_chunk(tcfg, model, torch.from_numpy(toks).long(),
                         torch.tensor([start], dtype=torch.int32), tcache)
    assert tl.shape == (1, 5, tcfg.vocab_size)
    _close(tl, jl)
    _caches_match(tcache, jcache)
    seq_cache = TT.init_kv_cache(tcfg, 1, 32)
    seq = torch.stack([TT.decode_step(
        tcfg, model, torch.from_numpy(toks[:, i]).long(),
        torch.tensor([start + i], dtype=torch.int32), seq_cache)
        for i in range(5)], dim=1)
    _close(tl, seq)
    assert torch.equal(tl.argmax(-1), seq.argmax(-1))
