"""The int8 KV pool of the port against the JAX package.

- ``quantize_kv_rows`` must be bit-identical to JAX's (values and scales;
  rounding half to even, zero rows at scale 1), or the engines could not
  agree token for token.
- The plain versions of the int8 ragged decode and verify kernels against
  the JAX plain functions and the Pallas q8 kernels (interpret mode):
  float32 atol 2e-5, bf16 atol 2e-2 (the Pallas q8 kernels keep the
  dequantized K/V and the probabilities in float32 where the plain path
  casts them to the model dtype).
- The int8 branches of the pool (init, prefill write, copy-on-write,
  suffix chunk, decode step) against JAX at float32 (logits atol 1e-4).
- The engine with ``kv_quantize="int8"`` against the JAX engine: identical
  greedy tokens (speculation on is covered in test_torch_spec.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import paged_kv as JKV
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxEngine)
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu.ops import attention as JA
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu.ops import ragged_attention as JR
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import paged_kv as TKV
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchEngine)
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import quant as TQ
from distributed_llm_tpu_torch.ops import ragged_attention as TR
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ATOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_kv_rows_bit_identical_to_jax(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 9, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                # zero row: scale 1
    # amax 127 (scale 1): exact halves must round to even.
    x[1, 2, 3, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    x[1, 2, 3, 6:] = 0.0
    jq, js = JQ.quantize_kv_rows(jnp.asarray(x, jdt))
    tq, ts = TQ.quantize_kv_rows(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[1, 2, 3, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert ts[0, 0, 0].item() == 1.0 and not tq[0, 0, 0].any()
    np.testing.assert_array_equal(
        TQ.dequantize_kv_rows(tq, ts, tdt).float().numpy(),
        np.asarray(JQ.dequantize_kv_rows(jq, js, jdt), np.float32))


def _q8_case(rng, *, g, b=4, nq=4, nkv=2, d=16, bs=16, mb=8):
    """Quantized pools (the JAX quantizer, handed to both), a shuffled
    block assignment, skewed positions and slot 0 idle on the trash
    block.  ``g`` None gives decode queries [B, Nq, D]."""
    nb = b * mb + 1
    qshape = (b, nq, d) if g is None else (b, g, nq, d)
    q = rng.standard_normal(qshape).astype(np.float32)
    kq, ks = (np.array(a) for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.standard_normal((nkv, nb, bs, d)), jnp.float32)))
    vq, vs = (np.array(a) for a in JQ.quantize_kv_rows(
        jnp.asarray(rng.standard_normal((nkv, nb, bs, d)), jnp.float32)))
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    pos = np.asarray([0, 14, 70, mb * bs - (g or 1)][:b], np.int32)
    tables[0] = 0
    return q, kq, vq, ks, vs, tables, pos


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
def test_ragged_decode_q8_plain_matches_jax(dtype, groups):
    jdt, tdt, atol = DTYPES[dtype]
    q, kq, vq, ks, vs, tables, pos = _q8_case(np.random.default_rng(1),
                                              g=None, nq=2 * groups)
    tq = torch.from_numpy(q).to(tdt)
    targs = [torch.from_numpy(a) for a in (kq, vq, ks, vs, tables, pos)]
    jq = jnp.asarray(q, jdt)
    jargs = [jnp.asarray(a) for a in (kq, vq, ks, vs, tables, pos)]
    port = TA.ragged_decode(tq, targs[0], targs[1], targs[4], targs[5],
                            targs[2], targs[3])
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA._gather_decode_paged(jq, jargs[0], jargs[1], jargs[4],
                                         jargs[5], jargs[2], jargs[3]), atol)
    _close(port, JR.ragged_paged_decode_attention_q8(jq, *jargs), atol)
    before = TR.ragged_paged_decode_attention_q8.launches
    _close(TR.ragged_paged_decode_attention_q8(tq, *targs), port, 0)
    assert TR.ragged_paged_decode_attention_q8.launches == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("g", [1, 3, 5])
def test_ragged_verify_q8_plain_matches_jax(dtype, groups, g):
    jdt, tdt, atol = DTYPES[dtype]
    q, kq, vq, ks, vs, tables, pos = _q8_case(np.random.default_rng(g),
                                              g=g, nq=2 * groups)
    tq = torch.from_numpy(q).to(tdt)
    targs = [torch.from_numpy(a) for a in (kq, vq, ks, vs, tables, pos)]
    jq = jnp.asarray(q, jdt)
    jargs = [jnp.asarray(a) for a in (kq, vq, ks, vs, tables, pos)]
    port = TA.ragged_verify(tq, targs[0], targs[1], targs[4], targs[5],
                            targs[2], targs[3])
    assert port.dtype == tdt and port.shape == tq.shape
    _close(port, JA._gather_verify_paged(jq, jargs[0], jargs[1], jargs[4],
                                         jargs[5], jargs[2], jargs[3]), atol)
    _close(port, JR.ragged_paged_verify_attention_q8(jq, *jargs), atol)
    before = TR.ragged_paged_verify_attention_q8.launches
    _close(TR.ragged_paged_verify_attention_q8(tq, *targs), port, 0)
    assert TR.ragged_paged_verify_attention_q8.launches == before


def test_int8_chunk_is_plain_by_design_and_counted():
    """The int8 suffix chunk has no kernel: its own plain function serves
    it (and counts), never the bf16 chunk kernel's plain version."""
    q, kq, vq, ks, vs, tables, _ = _q8_case(np.random.default_rng(4), g=None)
    rng = np.random.default_rng(5)
    qc = torch.from_numpy(rng.standard_normal((1, 20, 4, 16)).astype(np.float32))
    table = torch.from_numpy(tables[1])
    q_pos = torch.clamp(10 + torch.arange(20), max=25)[None]
    plain0, dq0 = TA._gather_chunk_paged.calls, TA._dequant_chunk_paged.calls
    out = TA.paged_chunk(qc, torch.from_numpy(kq), torch.from_numpy(vq), table,
                         torch.tensor([10], dtype=torch.int32), q_pos, 64,
                         torch.from_numpy(ks), torch.from_numpy(vs))
    assert (TA._gather_chunk_paged.calls, TA._dequant_chunk_paged.calls) == \
        (plain0, dq0 + 1)
    _close(out, JA.paged_chunk(jnp.asarray(qc.numpy()), jnp.asarray(kq),
                               jnp.asarray(vq), jnp.asarray(tables[1]),
                               jnp.asarray([10], jnp.int32),
                               jnp.asarray(q_pos.numpy()), 64,
                               k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs)), 2e-5)


def test_init_pool_int8_layout_matches_jax():
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    kw = dict(block_size=16, max_slots=2, max_seq_len=64)
    jpool = JKV.init_pool(jcfg, JKV.PagedConfig(**kw), "int8")
    tpool = TKV.init_pool(tcfg, TKV.PagedConfig(**kw), "int8")
    assert sorted(tpool) == sorted(jpool) == ["k", "ks", "v", "vs"]
    for name in tpool:
        assert tuple(tpool[name].shape) == tuple(jpool[name].shape)
        assert str(tpool[name].dtype).split(".")[-1] == str(jpool[name].dtype)
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]))
    for kvq in ("none", "int8"):
        for cfg in ("nano_test", "orin_8b"):
            assert TKV.pool_block_bytes(torch_config.MODEL_PRESETS[cfg], 64,
                                        kvq) == JKV.pool_block_bytes(
                jax_config.MODEL_PRESETS[cfg], 64, kvq)
    with pytest.raises(ValueError):
        TKV.init_pool(tcfg, TKV.PagedConfig(**kw), "int4")


def test_int8_pool_writes_chunk_and_decode_match_jax():
    """Cold prefill paged into an int8 pool, a copy-on-write block copy, a
    suffix chunk into the pool and three ragged decode steps over skewed
    slots with an idle trash slot, all against JAX at float32."""
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                               dtype="float32")
    jparams = JT.init_params(jcfg, 0)
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    bs, mb, b = 16, 8, 3
    kw = dict(block_size=bs, max_slots=b, max_seq_len=mb * bs)
    jpool = JKV.init_pool(jcfg, JKV.PagedConfig(**kw), "int8")
    tpool = TKV.init_pool(tcfg, TKV.PagedConfig(**kw), "int8")

    def pools_match():
        for name in tpool:
            _close(tpool[name][:, :, 1:], jpool[name][:, :, 1:],
                   1 if name in ("k", "v") else 1e-6)

    s, n = 32, 27
    toks = rng.integers(0, jcfg.vocab_size, (1, s)).astype(np.int32)
    positions = np.arange(s, dtype=np.int32)[None]
    _, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks),
                             jnp.asarray(positions))
    _, (tk, tv) = TT.prefill(tcfg, model, torch.from_numpy(toks).long(),
                             torch.from_numpy(positions))
    blocks = np.asarray([5, 2], np.int32)
    jpool = JKV.write_prefill_blocks(jpool, jnp.asarray(blocks), jk[:, 0],
                                     jv[:, 0])
    TKV.write_prefill_blocks(tpool, torch.from_numpy(blocks).long(),
                             tk[:, 0], tv[:, 0])
    pools_match()
    jpool = JKV.copy_block(jpool, jnp.int32(2), jnp.int32(9))
    TKV.copy_block(tpool, 2, 9)
    pools_match()

    table = np.zeros(mb, np.int32)
    table[:3] = [5, 9, 11]
    chunk = rng.integers(0, jcfg.vocab_size, (1, 16)).astype(np.int32)
    true_len = n + 12
    jh, jpool = JKV.chunk_prefill_paged(
        jcfg, jparams, jnp.asarray(chunk), jnp.asarray([n], jnp.int32),
        jnp.asarray([true_len], jnp.int32), jpool, jnp.asarray(table), 64)
    th = TKV.chunk_prefill_paged(
        tcfg, model, torch.from_numpy(chunk).long(),
        torch.tensor([n], dtype=torch.int32),
        torch.tensor([true_len], dtype=torch.int32), tpool,
        torch.from_numpy(table), 64)
    _close(TT.logits_from_hidden(model, th[:, :12]),
           JT.logits_from_hidden(jparams, jh[:, :12]))
    pools_match()

    tables = np.zeros((b, mb), np.int32)
    tables[0] = table
    tables[2, 0] = 12
    pos = np.asarray([true_len, 0, 0], np.int32)
    cur = np.asarray([7, 0, 42], np.int32)
    for _ in range(3):
        jl, jpool = JKV.decode_step_paged(
            jcfg, jparams, jnp.asarray(cur), jnp.asarray(pos), jpool,
            jnp.asarray(tables), ragged=True)
        tl = TKV.decode_step_paged(
            tcfg, model, torch.from_numpy(cur).long(),
            torch.from_numpy(pos), tpool, torch.from_numpy(tables))
        _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + np.asarray([1, 0, 1], np.int32)
    pools_match()


def test_int8_engine_emits_jax_tokens():
    """Cold, concurrent, chunked and prefix-hit requests on an int8-KV
    engine: greedy tokens identical to the JAX engine's."""
    preset = "nano_test_f32"
    kw = dict(model_preset=preset, kv_quantize="int8",
              prefill_chunk_tokens=32, prefill_buckets=(16, 32, 64, 128))
    with pytest.MonkeyPatch.context() as mp:
        for cfgmod in (jax_config, torch_config):
            mp.setitem(cfgmod.MODEL_PRESETS, preset, dataclasses.replace(
                cfgmod.MODEL_PRESETS["nano_test"], name=preset,
                dtype="float32"))
        tree = _tree(torch_config.MODEL_PRESETS[preset])
        engines = (
            JaxEngine(dataclasses.replace(jax_config.tiny_batched_cluster().nano,
                                          **kw),
                      params=jax.tree_util.tree_map(jnp.asarray, tree)),
            TorchEngine(dataclasses.replace(
                torch_config.tiny_batched_cluster().nano, **kw), device="cpu",
                params=params_from_jax(torch_config.MODEL_PRESETS[preset],
                                       tree)))
        outs = []
        try:
            for engine in engines:
                reqs = [engine.submit(p) for p in (
                    "rivers carry water down to the sea",
                    "bright stars shine over quiet hills",
                    "long question: " + "rivers lakes mountains oceans " * 20)]
                for r in reqs:
                    assert r.done.wait(timeout=120) and r.error is None
                turn1 = [{"role": "user", "content": "tell me about lakes"}]
                first = engine.generate(turn1)
                turn2 = turn1 + [{"role": "assistant", "content": first.text},
                                 {"role": "user", "content": "and rivers?"}]
                outs.append([r.result.token_ids for r in reqs]
                            + [first.token_ids,
                               engine.generate(turn2).token_ids,
                               engine.prefix_cache.stats()["hits_shared"]])
        finally:
            for engine in engines:
                engine.stop()
    assert engines[1].pool["k"].dtype == torch.int8
    assert outs[1] == outs[0] and outs[1][-1] >= 1
    assert engines[1].allocator.ref_stats()["allocated_blocks"] == 0
