"""Model parity: the JAX ``init_params`` pytree carried to the port.

``params_from_jax`` converts the JAX package's parameters (as numpy) to
the port's ``Transformer``; prefill, the paged suffix chunk and the
paged decode step must then give the JAX package's logits and pool
contents at float32 (atol 1e-4; same math, different summation order).
Both packages run their plain attention paths on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.config import MODEL_PRESETS as JAX_PRESETS
from distributed_llm_tpu.engine import paged_kv as JKV
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu_torch.config import MODEL_PRESETS
from distributed_llm_tpu_torch.engine import paged_kv as TKV
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax

ATOL = 1e-4


def _f32(preset):
    return (dataclasses.replace(JAX_PRESETS[preset], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS[preset], dtype="float32"))


def _pair(preset, seed=0):
    jcfg, tcfg = _f32(preset)
    jparams = JT.init_params(jcfg, seed)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, params_from_jax(tcfg, tree)


def _close(a, b, atol=ATOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("preset", ["nano_test", "orin_test"])
def test_params_from_jax_copies_every_leaf(preset):
    _, tcfg, jparams, model = _pair(preset)
    _close(model.embed.data, jparams["embed"], 0)
    _close(model.final_ln.data, jparams["final_ln"], 0)
    for i, layer in enumerate(model.layers):
        for key in ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
                    "w_down"):
            _close(getattr(layer, key).data, jparams["layers"][key][i], 0)
    assert sum(p.numel() for p in model.parameters()) == tcfg.param_count()


def test_params_from_jax_rejects_wrong_shapes():
    jcfg, tcfg, jparams, _ = _pair("nano_test")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tree["embed"] = tree["embed"][:, :8]
    with pytest.raises(ValueError):
        params_from_jax(tcfg, tree)


def test_init_params_scheme():
    cfg = MODEL_PRESETS["nano_test"]
    a = TT.init_params(cfg, seed=3)
    b = TT.init_params(cfg, seed=3)
    assert torch.equal(a.layers[1].wq, b.layers[1].wq)
    assert a.embed.dtype == torch.bfloat16
    assert torch.all(a.layers[0].ln1 == 1) and torch.all(a.final_ln == 1)
    std = a.layers[0].w_up.float().std().item()
    assert 0.015 < std < 0.025


@pytest.mark.parametrize("preset", ["nano_test", "orin_test"])
def test_prefill_chunk_and_decode_match_jax(preset):
    """Cold prefill of a prompt, paged into blocks; a suffix chunk written
    straight into the pool (start > 0, padded rows); three ragged decode
    steps over skewed slots with an idle trash slot."""
    jcfg, tcfg, jparams, model = _pair(preset)
    rng = np.random.default_rng(7)
    bs, mb, b = 16, 8, 3
    pcfg = JKV.PagedConfig(block_size=bs, max_slots=b, max_seq_len=mb * bs)
    tpcfg = TKV.PagedConfig(block_size=bs, max_slots=b, max_seq_len=mb * bs)
    jpool = JKV.init_pool(jcfg, pcfg)
    tpool = TKV.init_pool(tcfg, tpcfg)

    # 1. Cold prefill of a 32-token bucket (27 real tokens).
    s, n = 32, 27
    toks = rng.integers(0, jcfg.vocab_size, (1, s)).astype(np.int32)
    positions = np.arange(s, dtype=np.int32)[None]
    jh, (jk, jv) = JT.prefill(jcfg, jparams, jnp.asarray(toks),
                              jnp.asarray(positions))
    th, (tk, tv) = TT.prefill(tcfg, model, torch.from_numpy(toks).long(),
                              torch.from_numpy(positions))
    _close(TT.logits_from_hidden(model, th), JT.logits_from_hidden(jparams, jh))
    _close(tk, jk)
    _close(tv, jv)

    blocks = np.asarray([5, 2], np.int32)
    jpool = JKV.write_prefill_blocks(jpool, jnp.asarray(blocks), jk[:, 0], jv[:, 0])
    TKV.write_prefill_blocks(tpool, torch.from_numpy(blocks).long(), tk[:, 0], tv[:, 0])
    _close(tpool["k"], jpool["k"])

    # 2. A 16-token suffix chunk at start = n into the same slot's table.
    table = np.zeros(mb, np.int32)
    table[:3] = [5, 2, 9]
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
    # Pool contents at every written valid position (prompt + suffix).
    for p in range(true_len):
        blk, off = table[p // bs], p % bs
        _close(tpool["k"][:, :, blk, off], jpool["k"][:, :, blk, off])
        _close(tpool["v"][:, :, blk, off], jpool["v"][:, :, blk, off])

    # 3. Ragged decode: slot 0 continues the prompt, slot 1 is idle
    # (trash row), slot 2 starts a fresh 1-token sequence in block 11.
    tables = np.zeros((b, mb), np.int32)
    tables[0] = table
    tables[2, 0] = 11
    pos = np.asarray([true_len, 0, 0], np.int32)
    cur = np.asarray([7, 0, 42], np.int32)
    for _ in range(3):
        jl, jpool = JKV.decode_step_paged(
            jcfg, jparams, jnp.asarray(cur), jnp.asarray(pos), jpool,
            jnp.asarray(tables), ragged=True)
        tl = TKV.decode_step_paged(
            tcfg, model, torch.from_numpy(cur).long(),
            torch.from_numpy(pos), tpool, torch.from_numpy(tables))
        assert tl.dtype == torch.float32
        _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + np.asarray([1, 0, 1], np.int32)
    for p in range(true_len + 3):
        blk, off = table[p // bs], p % bs
        _close(tpool["v"][:, :, blk, off], jpool["v"][:, :, blk, off])
