"""Batched speculative decoding in the port against the JAX package.

- ``ragged_verify``'s plain version (what a CPU tensor takes) against the
  JAX plain function and the Pallas verify kernel (interpret mode), at
  skewed positions with an idle trash slot, GQA groups 1 and 2, G in
  {1, 3, 5}, and G=1 against decode.  Tolerances: float32 atol 2e-5
  (same algorithm, other summation order), bf16 atol 2e-2 (the Pallas
  kernel keeps float32 logits where the plain path rounds them).
- ``verify_step_paged``'s logits and pool writes against JAX at float32
  (atol 1e-4), rows past ``max_seq_len`` included, and row g's argmax
  against the g-th sequential greedy decode step.
- The engine (``device="cpu"``) against the JAX ``ContinuousBatchingEngine``
  with ``spec_decode=True`` at float32, with a self-draft and with a
  disagreeing ``draft_test`` draft: both get the same seeded numpy
  weights (0.2 scale, so no near-tied logits), their greedy tokens and
  draft/accept totals must be IDENTICAL, and equal to the port's
  spec-off run, over concurrent, chunked (spec-ineligible) and
  prefix-hit requests.
- The port's own speculation policy: sampled co-slots, adaptive γ, the
  all-degraded plain tick, the manager's AUTO arming and its off switch.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import paged_kv as JKV
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxEngine)
from distributed_llm_tpu.ops import attention as JA
from distributed_llm_tpu.ops import ragged_attention as JR
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import paged_kv as TKV
from distributed_llm_tpu_torch.engine.batching import (
    SPEC_EWMA_FLOOR, ContinuousBatchingEngine as TorchEngine)
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import ragged_attention as TR
from test_torch_engine import _tree

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
PRESET, DRAFT = "nano_test_f32", "draft_test_f32"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def verify_case(rng, *, g, b=4, nq=4, nkv=2, d=16, bs=16, mb=8):
    """Pools with a shuffled block assignment, skewed first positions
    (one chunk crossing a block edge, one ending at the table's end) and
    slot 0 idle: its whole row on the trash block at position 0."""
    nb = b * mb + 1
    q = rng.standard_normal((b, g, nq, d)).astype(np.float32)
    kp = rng.standard_normal((nkv, nb, bs, d)).astype(np.float32)
    vp = rng.standard_normal((nkv, nb, bs, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    pos = np.asarray([0, 14, 70, mb * bs - g][:b], np.int32)
    tables[0] = 0
    return q, kp, vp, tables, pos


# -- op level ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("g", [1, 3, 5])
def test_ragged_verify_plain_matches_jax(dtype, groups, g):
    jdt, tdt, atol = DTYPES[dtype]
    q, kp, vp, tables, pos = verify_case(np.random.default_rng(g),
                                         g=g, nq=2 * groups)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, kp, vp))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, kp, vp))
    t_tables, t_pos = torch.from_numpy(tables), torch.from_numpy(pos)
    port = TA.ragged_verify(tq, tk, tv, t_tables, t_pos)
    assert port.dtype == tdt and port.shape == tq.shape
    j_tables, j_pos = jnp.asarray(tables), jnp.asarray(pos)
    _close(port, JA._gather_verify_paged(jq, jk, jv, j_tables, j_pos,
                                         None, None), atol)
    _close(port, JR.ragged_paged_verify_attention(jq, jk, jv, j_tables,
                                                  j_pos), atol)
    # The kernel wrapper takes the same plain version for CPU tensors.
    before = TR.ragged_paged_verify_attention.launches
    _close(TR.ragged_paged_verify_attention(tq, tk, tv, t_tables, t_pos),
           port, 0)
    assert TR.ragged_paged_verify_attention.launches == before


def test_ragged_verify_g1_is_decode():
    q, kp, vp, tables, pos = (torch.from_numpy(x) for x in
                              verify_case(np.random.default_rng(7), g=1))
    _close(TA.ragged_verify(q, kp, vp, tables, pos)[:, 0],
           TA.ragged_decode(q[:, 0], kp, vp, tables, pos), 2e-5)


def test_verify_plain_version_counts_its_calls():
    q, kp, vp, tables, pos = (torch.from_numpy(x) for x in
                              verify_case(np.random.default_rng(8), g=3))
    before = TA._gather_verify_paged.calls
    TA.ragged_verify(q, kp, vp, tables, pos)
    assert TA._gather_verify_paged.calls == before + 1


# -- verify_step_paged ------------------------------------------------------------

@pytest.fixture(scope="module")
def presets():
    """float32 copies of nano_test / draft_test in both packages' preset
    tables for the module; yields {name: (jax cfg, port cfg)}."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for name, base in ((PRESET, "nano_test"), (DRAFT, "draft_test")):
            jcfg = dataclasses.replace(jax_config.MODEL_PRESETS[base],
                                       name=name, dtype="float32")
            tcfg = dataclasses.replace(torch_config.MODEL_PRESETS[base],
                                       name=name, dtype="float32")
            mp.setitem(jax_config.MODEL_PRESETS, name, jcfg)
            mp.setitem(torch_config.MODEL_PRESETS, name, tcfg)
            out[name] = (jcfg, tcfg)
        yield out


def _jax_tree(tree):
    return {"embed": jnp.asarray(tree["embed"]),
            "final_ln": jnp.asarray(tree["final_ln"]),
            "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()}}


def _filled_pools(jcfg, tcfg, pcfg_kw, kv_quantize="none", seed=0):
    """The same random K/V written into a JAX pool and a port pool."""
    jpool = JKV.init_pool(jcfg, JKV.PagedConfig(**pcfg_kw), kv_quantize)
    tpool = TKV.init_pool(tcfg, TKV.PagedConfig(**pcfg_kw), kv_quantize)
    nb, bs = jpool["k"].shape[2], jpool["k"].shape[3]
    l, nkv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    rng = np.random.default_rng(seed)
    k_all = rng.standard_normal((l, (nb - 1) * bs, nkv, d)).astype(np.float32)
    v_all = rng.standard_normal((l, (nb - 1) * bs, nkv, d)).astype(np.float32)
    blocks = np.arange(1, nb, dtype=np.int32)
    jpool = JKV.write_prefill_blocks(jpool, jnp.asarray(blocks),
                                     jnp.asarray(k_all), jnp.asarray(v_all))
    TKV.write_prefill_blocks(tpool, torch.from_numpy(blocks).long(),
                             torch.from_numpy(k_all), torch.from_numpy(v_all))
    return jpool, tpool


def _pools_equal_outside_trash(tpool, jpool, atol):
    """Every block but the trash block 0; int8 values may differ by one
    step where the float32 K/V being quantized differ in the last ulp."""
    for name in tpool:
        tol = 1 if tpool[name].dtype == torch.int8 else atol
        _close(tpool[name][:, :, 1:], jpool[name][:, :, 1:], tol)


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_verify_step_paged_matches_jax(presets, kv_quantize):
    """Logits and pool writes of one verify forward, with slot 1's chunk
    starting at max_seq_len - 2 so its last three rows overflow the
    context and must go to the trash block."""
    jcfg, tcfg = presets[PRESET]
    tree = _tree(tcfg)
    model = params_from_jax(tcfg, tree)
    bs, max_seq = 16, tcfg.max_seq_len
    pcfg_kw = dict(block_size=bs, max_slots=2, max_seq_len=max_seq)
    jpool, tpool = _filled_pools(jcfg, tcfg, pcfg_kw, kv_quantize)
    mb = max_seq // bs
    tables = np.stack([np.arange(1, mb + 1), np.arange(mb + 1, 2 * mb + 1)]
                      ).astype(np.int32)
    pos = np.asarray([37, max_seq - 2], np.int32)
    chunk = np.asarray([[5, 9, 13, 17, 21], [7, 8, 9, 10, 11]], np.int64)
    jl, jpool = JKV.verify_step_paged(jcfg, _jax_tree(tree),
                                      jnp.asarray(chunk, jnp.int32),
                                      jnp.asarray(pos), jpool,
                                      jnp.asarray(tables))
    last_block = tables[1, -1]
    before = tpool["k"][:, :, last_block].clone()
    tl = TKV.verify_step_paged(tcfg, model, torch.from_numpy(chunk),
                               torch.from_numpy(pos), tpool,
                               torch.from_numpy(tables))
    assert tl.shape == (2, 5, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, 1e-4)
    _pools_equal_outside_trash(tpool, jpool, 1e-4)
    # Only row max_seq - 2 and max_seq - 1 of the last block changed.
    changed = (tpool["k"][:, :, last_block] != before).any(-1).any(0).any(0)
    assert set(torch.nonzero(changed).flatten().tolist()) <= {
        (max_seq - 2) % bs, (max_seq - 1) % bs}


def test_verify_rows_are_sequential_greedy_decode(presets):
    """Row g's argmax == the g-th sequential greedy decode token: the
    verify forward is greedy decode unrolled over the chunk."""
    _, tcfg = presets[PRESET]
    model = params_from_jax(tcfg, _tree(tcfg, seed=3))
    pcfg = TKV.PagedConfig(block_size=16, max_slots=2,
                           max_seq_len=tcfg.max_seq_len)
    pool = TKV.init_pool(tcfg, pcfg)
    tables = torch.zeros((2, pcfg.blocks_per_slot), dtype=torch.int32)
    tables[0, :4] = torch.tensor([1, 2, 3, 4])
    tables[1, :4] = torch.tensor([5, 6, 7, 8])
    pos = torch.tensor([5, 9], dtype=torch.int32)
    cur = torch.tensor([7, 11])
    seq_pool = {k: v.clone() for k, v in pool.items()}
    p, c, seq = pos, cur, []
    for _ in range(3):
        c = TKV.decode_step_paged(tcfg, model, c, p, seq_pool,
                                  tables).argmax(-1)
        p = p + 1
        seq.append(c)
    chunk = torch.stack([cur, seq[0], seq[1]], dim=1)
    picks = TKV.verify_step_paged(tcfg, model, chunk, pos, pool,
                                  tables).argmax(-1)
    for g in range(3):
        assert picks[:, g].tolist() == seq[g].tolist(), g


# -- engine parity ------------------------------------------------------------

LONG = "long question: " + "rivers lakes mountains oceans " * 20
PROMPTS = [f"question about rivers number {i}" for i in range(3)]
# Prompts up to a 32-token bucket prefill at once (spec-eligible); LONG
# prefills in 32-token chunks (spec-ineligible).
ENGINE_KW = dict(prefill_chunk_tokens=32, prefill_buckets=(16, 32, 64, 128))


@pytest.fixture(scope="module")
def weights(presets):
    return {name: _tree(tcfg, seed=i)
            for i, (name, (_, tcfg)) in enumerate(sorted(presets.items()))}


def build_pair(presets, weights, draft, **overrides):
    """(JAX engine, port engine) over the same weights, target and draft."""
    kw = dict(ENGINE_KW, model_preset=PRESET, **overrides)
    if draft is not None:
        kw.update(draft_preset=draft, spec_decode=True)
    jtier = dataclasses.replace(jax_config.tiny_batched_cluster().nano, **kw)
    ttier = dataclasses.replace(torch_config.tiny_batched_cluster().nano, **kw)
    jax_engine = JaxEngine(jtier, params=_jax_tree(weights[PRESET]))
    draft_params = None
    if draft == DRAFT:
        # The round reads params_d at call time, so replacing it before
        # the first request hands the JAX engine the test's draft.
        jax_engine.params_d = _jax_tree(weights[DRAFT])
        draft_params = params_from_jax(presets[DRAFT][1], weights[DRAFT])
    port = TorchEngine(ttier, device="cpu",
                       params=params_from_jax(presets[PRESET][1],
                                              weights[PRESET]),
                       draft_params=draft_params)
    return jax_engine, port


def drive(engine):
    """Concurrent greedy requests beside a chunked long prompt, then a
    multi-turn follow-up that hits the first turn's parked prefix."""
    reqs = [engine.submit(p) for p in PROMPTS + [LONG]]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    out = [r.result.token_ids for r in reqs]
    turn1 = [{"role": "user", "content": "tell me about the tallest hills"}]
    first = engine.generate(turn1)
    hits = engine.prefix_cache.stats()["hits_shared"]
    turn2 = turn1 + [{"role": "assistant", "content": first.text},
                     {"role": "user", "content": "and the lakes?"}]
    second = engine.generate(turn2)
    assert engine.prefix_cache.stats()["hits_shared"] == hits + 1
    return out + [first.token_ids, second.token_ids]


@pytest.fixture(scope="module")
def spec_off_tokens(presets, weights):
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               model_preset=PRESET, **ENGINE_KW)
    engine = TorchEngine(tier, device="cpu", params=params_from_jax(
        presets[PRESET][1], weights[PRESET]))
    try:
        return drive(engine)
    finally:
        engine.stop()


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
@pytest.mark.parametrize("draft", [PRESET, DRAFT])
def test_spec_engine_matches_jax(presets, weights, spec_off_tokens, draft,
                                 kv_quantize):
    jax_engine, port = build_pair(presets, weights, draft,
                                  kv_quantize=kv_quantize)
    try:
        want = drive(jax_engine)
        got = drive(port)
        assert got == want
        js, ts = jax_engine.spec_stats(), port.spec_stats()
    finally:
        jax_engine.stop()
        port.stop()
    assert port.allocator.ref_stats()["allocated_blocks"] == 0
    assert ts["enabled"] and ts["drafted_total"] > 0
    assert (ts["drafted_total"], ts["accepted_total"]) == \
        (js["drafted_total"], js["accepted_total"])
    if draft == PRESET:
        assert ts["accept_ratio"] == 1.0     # the draft IS the target
    if kv_quantize == "none":
        # Speculation never changes greedy output.
        assert got == spec_off_tokens


# -- the port's speculation policy ----------------------------------------------

def _spec_engine(presets, weights, **overrides):
    return build_pair(presets, weights, PRESET, **overrides)[1]


def test_adapt_gamma_matches_jax(presets, weights):
    jax_engine, port = build_pair(presets, weights, PRESET)
    try:
        assert port._gamma_buckets == jax_engine._gamma_buckets == (1, 2, 4)
        for g in range(1, 5):
            assert port._gamma_bucket(g) == jax_engine._gamma_bucket(g)
        grid = sorted(set(np.linspace(0, 1, 41).tolist())
                      | {SPEC_EWMA_FLOOR, SPEC_EWMA_FLOOR - 1e-6})
        assert [port._adapt_gamma(e) for e in grid] == \
            [jax_engine._adapt_gamma(e) for e in grid]
    finally:
        jax_engine.stop()
        port.stop()


def test_sampled_co_slot_rides_gamma_zero(presets, weights, spec_off_tokens):
    port = _spec_engine(presets, weights)
    seen = []
    real_emit = port._emit_spec

    def spy(active, out, n_acc, gammas):
        seen.append({ix: (port._slots[ix].temperature, int(gammas[ix]))
                     for ix in active if port._slots[ix] is not None})
        real_emit(active, out, n_acc, gammas)

    port._emit_spec = spy
    try:
        sampled = port.submit("sampled request about rivers", temperature=0.9)
        greedy = [port.submit(p) for p in PROMPTS]
        for r in [sampled] + greedy:
            assert r.done.wait(timeout=120) and r.error is None
        assert sampled.result.gen_tokens > 0
        assert [r.result.token_ids for r in greedy] == spec_off_tokens[:3]
    finally:
        port.stop()
    sampled_gammas = [g for rnd in seen for t, g in rnd.values() if t > 0]
    assert sampled_gammas and set(sampled_gammas) == {0}


def test_all_degraded_engine_takes_the_plain_tick(presets, weights):
    port = _spec_engine(presets, weights)
    ticks = {"plain": 0, "spec": 0}
    real_tick, real_spec = port._decode_tick, port._spec_tick

    def plain():
        ticks["plain"] += 1
        return real_tick()

    def spec(gb, gammas):
        ticks["spec"] += 1
        return real_spec(gb, gammas)

    port._decode_tick, port._spec_tick = plain, spec
    # Every slot goes live at γ=0, as if its acceptance had decayed.
    port.spec_gamma_max = 0
    try:
        port.generate(PROMPTS[0])
        assert ticks["spec"] == 0 and ticks["plain"] > 0
        assert port.spec_stats()["drafted_total"] == 0
    finally:
        port.stop()


def test_manager_arms_spec_and_the_off_switch_serves_plain(presets):
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    base = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               model_preset=PRESET, draft_preset=DRAFT)
    for spec_decode, armed in ((None, True), (False, False)):
        manager = EngineManager(
            dataclasses.replace(base, spec_decode=spec_decode),
            device="cpu", warmup_on_start=False)
        try:
            engine = manager.engine()
            assert engine.spec is armed
            assert (engine.cfg_d is not None) is armed
            assert engine.generate(PROMPTS[0]).gen_tokens > 0
            assert (engine.spec_stats()["drafted_total"] > 0) is armed
        finally:
            manager.stop_server()
    # A sampled tier default never speculates.
    manager = EngineManager(dataclasses.replace(base, temperature=0.7),
                            device="cpu", warmup_on_start=False)
    try:
        assert not manager.engine().spec
    finally:
        manager.stop_server()


def test_spec_warmup_runs_every_gamma_bucket(presets, weights):
    port = _spec_engine(presets, weights)
    buckets = []
    real_spec = port._spec_tick
    port._spec_tick = lambda gb, gammas: (buckets.append(gb),
                                          real_spec(gb, gammas))[1]
    try:
        port.warmup()
    finally:
        port.stop()
    assert set(port._gamma_buckets) <= set(buckets)
    assert port.allocator.ref_stats()["allocated_blocks"] == 0
