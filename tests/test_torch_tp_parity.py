"""Tensor-parallel serving in the port against tp=1 and JAX's mesh engines.

On the CPU in float32, with the same seeded numpy weights (0.2 scale, so
no near-tied logits) in both packages, on repeated CPU slots
(``tp_mesh(["cpu"] * 8, tp)``, the port's counterpart of JAX's 8 host
devices):

- prefill at tp=2 and tp=4: the port's ``prefill`` over a
  ``ShardedModel`` against JAX's ``prefill`` jitted over params placed by
  ``param_shardings`` on a tp mesh: hidden states and logits within
  atol 1e-4 (float32, other summation order), each shard's K/V equal to
  JAX's K/V heads of that shard within the same tolerance;
- the batched engine at tp=2 and tp=4 across the interaction matrix of
  tests/test_tp_parity.py: greedy tokens IDENTICAL to the port's tp=1
  engine (shared-prefix copy-on-write, a preemption's replay, chunked
  prefill, host-KV demotion and promotion, a speculative round with a
  disagreeing draft, a self-draft that accepts everything), the plain
  run and the disagreeing draft also identical to JAX's
  ``ContinuousBatchingEngine`` on a tp mesh (with the same draft totals),
  and ONE decode program per engine;
- the sequential engine at tp=4 identical to JAX's ``InferenceEngine`` on
  ``tiny_cluster()``'s orin over a 4-device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxEngine)
from distributed_llm_tpu.engine.inference import (
    InferenceEngine as JaxSequential)
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu.parallel.mesh import tp_mesh as jax_tp_mesh
from distributed_llm_tpu.parallel.sharding import param_shardings
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching as TB
from distributed_llm_tpu_torch.engine.inference import InferenceEngine
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
from distributed_llm_tpu_torch.parallel.sharding import shard_params
from test_torch_engine import _tree

PRESET, DRAFT = "orin_test_f32", "draft_test_f32"
TPS = [2, 4]
SYS = ("system: you are a helpful assistant that answers questions about "
       "rivers lakes and mountains in short sentences")
PROMPTS = ["short question about rivers please",
           "long question: " + "rivers lakes mountains oceans deltas " * 8,
           "what is the tallest mountain on the continent of asia today"]


@pytest.fixture(scope="module")
def presets():
    """float32 copies of orin_test (8 q heads, 4 kv heads: tp 2 and 4
    divide them) and draft_test in both packages, with their seeded
    weights: {name: (jax cfg, port cfg, numpy tree)}."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for name, base in ((PRESET, "orin_test"), (DRAFT, "draft_test")):
            jcfg = dataclasses.replace(jax_config.MODEL_PRESETS[base],
                                       name=name, dtype="float32")
            tcfg = dataclasses.replace(torch_config.MODEL_PRESETS[base],
                                       name=name, dtype="float32")
            mp.setitem(jax_config.MODEL_PRESETS, name, jcfg)
            mp.setitem(torch_config.MODEL_PRESETS, name, tcfg)
            out[name] = (jcfg, tcfg, _tree(tcfg, seed=7))
        yield out


def _jax_tree(tree):
    return {"embed": jnp.asarray(tree["embed"]),
            "final_ln": jnp.asarray(tree["final_ln"]),
            "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()}}


def _tier(pkg, **kw):
    base = dict(model_preset=PRESET, decode_batch=4, max_new_tokens=12,
                enable_prefix_cache=False)
    base.update(kw)
    return dataclasses.replace(pkg.tiny_batched_cluster().orin, **base)


def _port(presets, tp, **kw):
    """The port's batched engine at ``tp`` (0: no group at all)."""
    tier = _tier(torch_config, **kw)
    draft = None
    if tier.draft_preset == DRAFT:
        draft = params_from_jax(presets[DRAFT][1], presets[DRAFT][2])
    return TB.ContinuousBatchingEngine(
        tier, device="cpu",
        params=params_from_jax(presets[PRESET][1], presets[PRESET][2]),
        draft_params=draft,
        group=tp_mesh(["cpu"] * 8, tp) if tp else None)


def _jax(presets, tp, **kw):
    tier = _tier(jax_config, **kw)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:tp]), ("tp",))
    engine = JaxEngine(tier, seed=0, params=_jax_tree(presets[PRESET][2]),
                       mesh=mesh)
    if tier.draft_preset == DRAFT:
        engine.params_d = _jax_tree(presets[DRAFT][2])
    return engine


def _drain(engine, prompts):
    try:
        reqs = [engine.submit(p) for p in prompts]
        for r in reqs:
            assert r.done.wait(timeout=120)
        for r in reqs:
            if r.error is not None:
                raise r.error
        return [tuple(r.result.token_ids) for r in reqs]
    finally:
        engine.stop()


def _queued(engine, prompts):
    """Queue every prompt before the scheduler starts (one admission pass
    takes them in order: deterministic preemptions), then run them."""
    reqs = [TB._Request(history=p, max_new_tokens=None, temperature=None)
            for p in prompts]
    for r in reqs:
        engine._queue.put(r)
    engine.start()
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    return [tuple(r.result.token_ids) for r in reqs]


@pytest.fixture(scope="module")
def base(presets):
    """The port's tp=1 greedy tokens over PROMPTS."""
    return _drain(_port(presets, 0), PROMPTS)


# -- prefill -----------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
def test_tp_prefill_matches_jax_mesh(presets, tp):
    jcfg, tcfg, tree = presets[PRESET]
    rng = np.random.default_rng(tp)
    tokens = rng.integers(1, tcfg.vocab_size, (2, 24))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    mesh = jax_tp_mesh(jax.devices(), tp)
    params = jax.device_put(_jax_tree(tree), param_shardings(jcfg, mesh))
    h_j, (k_j, v_j) = jax.jit(partial(JT.prefill, jcfg))(
        params, jnp.asarray(tokens), jnp.asarray(pos))
    logits_j = np.asarray(JT.logits_from_hidden(params, h_j))
    model = shard_params(params_from_jax(tcfg, tree),
                         tp_mesh(["cpu"] * 8, tp))
    h_t, (k_t, v_t) = TT.prefill(tcfg, model, torch.from_numpy(tokens),
                                 torch.from_numpy(np.array(pos)))
    logits_t = TT.logits_from_hidden(model, h_t)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(logits_t.numpy(), logits_j, atol=1e-4, rtol=0)
    assert len(k_t) == len(v_t) == tp
    per = tcfg.num_kv_heads // tp
    for s in range(tp):
        heads = slice(s * per, (s + 1) * per)
        np.testing.assert_allclose(k_t[s].numpy(),
                                   np.asarray(k_j)[..., heads, :],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(v_t[s].numpy(),
                                   np.asarray(v_j)[..., heads, :],
                                   atol=1e-4, rtol=0)


# -- the batched engine: basic parity and the one-program pin ---------------

@pytest.mark.parametrize("tp", TPS)
def test_tp_greedy_identical_to_tp1_and_jax_mesh_one_decode_program(
        presets, base, tp):
    engine = _port(presets, tp)
    assert engine.tp == tp and engine.ragged
    compiled = engine._compiled
    assert _drain(engine, PROMPTS) == base
    assert len(compiled.get("decode", ())) == 1
    jax_engine = _jax(presets, tp)
    assert _drain(jax_engine, PROMPTS) == base


def test_tp1_group_is_no_group(presets, base):
    engine = _port(presets, 1)
    assert engine.tp == 1 and engine.group is None
    assert _drain(engine, PROMPTS[:2]) == base[:2]


# -- the interaction matrix --------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
def test_tp_shared_prefix_cow_boundary(presets, tp):
    prompts = [SYS + f" q{i}?" for i in range(3)]

    def run(t):
        engine = _port(presets, t, enable_prefix_cache=True)
        engine.generate(SYS)                 # parks the prefix
        out = _drain(engine, prompts)
        assert engine.prefix_cache.stats()["hits_shared"] == 3
        return out

    assert run(tp) == run(0)


@pytest.mark.parametrize("tp", TPS)
def test_tp_preemption_replay_identical(presets, base, tp):
    engine = _port(presets, tp, decode_batch=2, max_new_tokens=24,
                   kv_pool_blocks=5)
    try:
        out = _queued(engine, [PROMPTS[0], PROMPTS[2]])
        assert engine.preempted_total >= 1
    finally:
        engine.stop()
    solo = _port(presets, 0, decode_batch=2, max_new_tokens=24)
    assert out == _drain(solo, [PROMPTS[0], PROMPTS[2]])


@pytest.mark.parametrize("tp", TPS)
def test_tp_chunked_prefill_identical(presets, tp):
    kw = dict(prefill_chunk_tokens=32, prefill_buckets=(16, 32, 64, 128))
    assert _drain(_port(presets, tp, **kw), PROMPTS) == \
        _drain(_port(presets, 0, **kw), PROMPTS)


@pytest.mark.parametrize("tp", TPS)
def test_tp_host_kv_promotion_identical(presets, tp):
    """park -> demote to host RAM -> promote: every shard's tile makes
    the round trip."""
    prompt = "user: tell me about rivers lakes mountains oceans and deltas"
    turn2 = prompt + " and also glaciers please"
    kw = dict(max_new_tokens=6, decode_batch=2, prefill_chunk_tokens=16,
              enable_prefix_cache=True, prefix_cache_entries=4,
              host_kv_bytes=64 * 1024 * 1024)

    def run(t):
        engine = _port(presets, t, **kw)
        try:
            r1 = engine.generate(prompt)
            assert engine.prefix_cache.pop_oldest() is not None
            assert engine.kv_spill.flush(10.0)
            assert engine.kv_spill.stats()["demotions_total"] == 1
            r2 = engine.generate(turn2)
            assert engine.kv_spill.stats()["promotions_total"] == 1
            return [tuple(r1.token_ids), tuple(r2.token_ids)]
        finally:
            engine.stop()

    assert run(tp) == run(0)


@pytest.mark.parametrize("tp", TPS)
def test_tp_spec_round_disagreeing_draft(presets, base, tp):
    """The separate draft is replicated (it runs whole on the group's
    first device), the verify runs per shard; tokens equal plain tp=1
    decode, and at tp=2 JAX's mesh engine's, draft totals included."""
    kw = dict(spec_decode=True, draft_preset=DRAFT)
    engine = _port(presets, tp, **kw)
    assert engine.spec and engine.tp == tp
    out = _drain(engine, PROMPTS)
    st = engine.spec_stats()
    # A random draft disagrees: every round rejects and rewinds.
    assert st["drafted_total"] > 0
    assert out == base
    if tp == 2:
        jax_engine = _jax(presets, tp, **kw)
        assert _drain(jax_engine, PROMPTS) == out
        js = jax_engine.spec_stats()
        assert (st["drafted_total"], st["accepted_total"]) == \
            (js["drafted_total"], js["accepted_total"])


@pytest.mark.parametrize("tp", TPS)
def test_tp_self_draft_accepts_everything(presets, base, tp):
    engine = _port(presets, tp, spec_decode=True, draft_preset=PRESET)
    assert engine.model_d is engine.model
    out = _drain(engine, PROMPTS[:2])
    assert engine.spec_stats()["accept_ratio"] == 1.0
    assert out == base[:2]


# -- the sequential engine ---------------------------------------------------

def test_tp4_sequential_engine_matches_jax_tiny_cluster(presets):
    """tiny_cluster()'s orin at tp=4 on both sides, bf16 KV and a prefix
    hit on the follow-up."""
    jcfg, tcfg, tree = presets[PRESET]
    jtier = dataclasses.replace(jax_config.tiny_cluster().orin,
                                model_preset=PRESET)
    ttier = dataclasses.replace(torch_config.tiny_cluster().orin,
                                model_preset=PRESET)
    assert jtier.tp == ttier.tp == 4
    prompts = [PROMPTS[0], PROMPTS[0] + " and lakes too"]
    je = JaxSequential(jtier, seed=0, params=_jax_tree(tree),
                       mesh=jax_tp_mesh(jax.devices(), 4))
    te = InferenceEngine(ttier, device="cpu", params=params_from_jax(
        tcfg, tree), group=tp_mesh(["cpu"] * 4, 4))
    assert te.group.tp == 4
    want = [tuple(je.generate(p).token_ids) for p in prompts]
    got = [tuple(te.generate(p).token_ids) for p in prompts]
    assert got == want
    assert len(set(want[0])) > 1          # not one repeated token
