"""The sequential engines of the port against the JAX package's.

The port's ``InferenceEngine`` and ``SpeculativeEngine`` (device="cpu")
and the JAX ones get the same float32 weights (the seeded numpy tree of
test_torch_engine at 0.2 scale, so greedy decoding does not collapse
onto one repeated token) on ``tiny_cluster()`` tiers, and must emit
IDENTICAL greedy tokens: cold prompts, a prompt past the largest bucket
(chunk stride), a multi-turn prefix-reuse follow-up, a follow-up longer
than a bucket (chunk stride from the matched prefix), a max_new_tokens
override and an int8 cache; the cache length each picks must be equal
too (a wrong rung would not change greedy tokens, masked positions
contributing exactly 0).  Speculation: identical tokens and acceptance
history to JAX's, and the target's own greedy tokens.  Float32 copies of
``nano_test``, ``orin_test`` and ``draft_test`` are registered in both
packages' preset tables for the module.
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.inference import InferenceEngine as JaxEngine
from distributed_llm_tpu.engine.speculative import SpeculativeEngine as JaxSpec
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import ContinuousBatchingEngine
from distributed_llm_tpu_torch.engine.inference import (InferenceEngine,
                                                        to_device)
from distributed_llm_tpu_torch.engine.manager import EngineManager
from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
from distributed_llm_tpu_torch.models.convert import params_from_jax
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


F32 = {name: f"{name}_f32" for name in ("nano_test", "orin_test",
                                        "draft_test")}

COLD = ["rivers carry water down from the mountains to the sea",
        "explain how a compiler turns source code into machine code"]
LONG = "user: " + " ".join(f"word{i}" for i in range(25))        # > 64 ids


@pytest.fixture(scope="module")
def weights():
    """preset -> (JAX params, numpy tree) of float32 copies registered
    in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for i, (base, name) in enumerate(F32.items()):
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32"))
            tree = _tree(torch_config.MODEL_PRESETS[name], seed=i)
            out[name] = ({"embed": jnp.asarray(tree["embed"]),
                          "final_ln": jnp.asarray(tree["final_ln"]),
                          "layers": {k: jnp.asarray(v)
                                     for k, v in tree["layers"].items()}},
                         tree)
        yield out


def _tiers(tier="nano", **overrides):
    """(JAX tier, port tier) of ``tiny_cluster()`` on the float32 preset."""
    jt = getattr(jax_config.tiny_cluster(), tier)
    tt = getattr(torch_config.tiny_cluster(), tier)
    kw = dict(model_preset=F32[jt.model_preset], tp=1, **overrides)
    return dataclasses.replace(jt, **kw), dataclasses.replace(tt, **kw)


def _pair(weights, tier="nano", **overrides):
    jtier, ttier = _tiers(tier, **overrides)
    jparams, tree = weights[ttier.model_preset]
    return (JaxEngine(jtier, params=jparams),
            InferenceEngine(ttier, device="cpu", params=params_from_jax(
                ttier.model(), tree)))


def _cache_len(engine) -> int:
    """The cache length of the last parked conversation."""
    return int(engine.prefix_cache._entries[-1].cache["k"].shape[2])


def _same(pair, history, **kw):
    """Both engines' results for ``history``: identical tokens and
    prompt lengths, and the same cache rung."""
    want, got = (e.generate(history, **kw) for e in pair)
    assert got.token_ids == want.token_ids
    assert got.prompt_tokens == want.prompt_tokens
    assert _cache_len(pair[1]) == _cache_len(pair[0])
    return want, got


@pytest.fixture(scope="module")
def nano_pair(weights):
    return _pair(weights)


def test_cold_prompts_emit_jax_tokens(nano_pair):
    for prompt in COLD:
        _, got = _same(nano_pair, prompt)
        assert len(set(got.token_ids)) > 3     # not a degenerate repeat


def test_max_new_tokens_override(nano_pair):
    _, got = _same(nano_pair, "user: how do glaciers move", max_new_tokens=3)
    assert got.gen_tokens <= 3


def test_long_prompt_chunk_stride_emits_jax_tokens(weights):
    pair = _pair(weights, enable_prefix_cache=True)
    _, got = _same(pair, LONG)
    assert got.prompt_tokens > 64                  # nothing truncated
    assert _cache_len(pair[1]) == 256


def test_prefix_reuse_follow_ups_emit_jax_tokens(weights):
    """A short follow-up (suffix prefill over the whole allocated span)
    and then a follow-up longer than the largest bucket (chunk stride
    from the matched prefix), each reusing the parked conversation."""
    pair = _pair(weights)
    turn1 = "user: " + " ".join(f"alpha{i}" for i in range(6))
    first, _ = _same(pair, turn1)
    turn2 = turn1 + "\nassistant: " + (first.text or "x") + "\nuser: and more?"
    _same(pair, turn2)
    assert [e.prefix_cache.stats()["hits"] for e in pair] == [1, 1]
    second = pair[0].generate(turn2)           # parks turn2 on both
    pair[1].generate(turn2)
    turn3 = (turn2 + "\nassistant: " + (second.text or "x") + "\nuser: "
             + " ".join(f"beta{i}" for i in range(30)))
    _, got = _same(pair, turn3)
    assert [e.prefix_cache.stats()["hits"] for e in pair] == [3, 3]
    assert got.prompt_tokens > 64


def test_stream_joins_to_generate(nano_pair):
    port = nano_pair[1]
    want = port.generate(COLD[1])
    handle = port.generate_stream(COLD[1])
    assert "".join(handle) == want.text
    assert handle.result.token_ids == want.token_ids


def test_int8_cache_emits_jax_tokens(weights):
    pair = _pair(weights, kv_quantize="int8")
    for prompt in (COLD[0], LONG):
        _same(pair, prompt)
    turn1 = [{"role": "user", "content": "tell me about lakes"}]
    first, _ = _same(pair, turn1)
    _same(pair, turn1 + [{"role": "assistant", "content": first.text},
                         {"role": "user", "content": "and rivers?"}])
    assert pair[1].prefix_cache.stats()["hits"] >= 1
    parked = pair[1].prefix_cache._entries[-1].cache
    assert parked["k"].dtype.itemsize == 1 and "ks" in parked


# -- speculation ----------------------------------------------------------------

def _spec_pair(weights, draft="draft_test", gamma=3, noise=None):
    """(JAX, port) SpeculativeEngine over orin_test, both packages handed
    the same target and draft weights: the ``draft`` preset's, or with
    ``noise`` the target's own plus seeded noise of that scale (0 = the
    target itself)."""
    jt, tt = _tiers("orin", max_new_tokens=12)
    jd, td = (dataclasses.replace(t, model_preset=F32[draft])
              for t in (jt, tt))
    jp_t, tree_t = weights[tt.model_preset]
    jp_d, tree_d = weights[td.model_preset]
    if noise is not None:
        rng = np.random.default_rng(5)
        tree_d = jax.tree_util.tree_map(
            lambda a: a + noise * rng.standard_normal(a.shape).astype(a.dtype),
            tree_t)
        jd, td, jp_d = jt, tt, jax.tree_util.tree_map(jnp.asarray, tree_d)
    return (JaxSpec(jt, jd, gamma=gamma, target_params=jp_t,
                    draft_params=jp_d),
            SpeculativeEngine(tt, td, gamma=gamma, device="cpu",
                              target_params=params_from_jax(tt.model(), tree_t),
                              draft_params=params_from_jax(td.model(), tree_d)))


@pytest.mark.parametrize("noise", [None, 0.03])
def test_speculative_emits_jax_and_target_greedy_tokens(weights, noise):
    """An independent draft (draft_test: nothing accepted) and a draft
    near the target (some rounds accepted, some not)."""
    pair = _spec_pair(weights, noise=noise)
    prompt = "user: tell me about oceans"
    want, got = (e.generate(prompt) for e in pair)
    assert got.token_ids == want.token_ids
    assert pair[1].accept_history == pair[0].accept_history
    if noise is not None:
        assert 0 < pair[1].acceptance_rate < 1
    plain = _pair(weights, "orin", max_new_tokens=12)[1]
    assert plain.generate(prompt).token_ids == got.token_ids


def test_speculative_self_draft_accepts_everything(weights):
    pair = _spec_pair(weights, gamma=4, noise=0.0)
    want, got = (e.generate("user: hi there") for e in pair)
    assert got.token_ids == want.token_ids
    assert pair[1].acceptance_rate == 1.0 == pair[0].acceptance_rate


def test_draft_cache_has_no_hole_after_full_accept(weights):
    """A fully accepted round advances γ+1 positions; the draft cache
    holds real K/V at every one of them."""
    spec = _spec_pair(weights, gamma=3, noise=0.0)[1]
    ids = spec.tokenizer.encode_history("user: abcd")
    n = len(ids)
    first, cache_t, cache_d = spec._prefill(ids, 16, spec._cache_lens[0])
    out, n_acc, _, pos = spec._round(cache_t, cache_d, first,
                                     to_device([n], spec.device))
    assert int(n_acc[0]) == 3 and int(pos[0]) == n + 4
    for p in range(n, n + 4):                  # pos .. pos+γ inclusive
        assert cache_d["k"][:, 0, p].abs().sum() > 0, p


def test_speculative_stream_matches_generate(weights):
    port = _spec_pair(weights)[1]
    want = port.generate("user: stream the speculation")
    handle = port.generate_stream("user: stream the speculation")
    assert "".join(handle) == want.text
    assert handle.result.token_ids == want.token_ids


def test_speculative_rejects_temperature_and_vocab_mismatch(weights):
    port = _spec_pair(weights)[1]
    with pytest.raises(NotImplementedError):
        port.generate("user: x", temperature=0.7)
    with pytest.raises(NotImplementedError):
        port.generate_stream("user: x", temperature=0.7)
    _, tt = _tiers("orin")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(torch_config.MODEL_PRESETS, "small_vocab", dataclasses.replace(
            torch_config.MODEL_PRESETS["draft_test"], name="small_vocab",
            vocab_size=512))
        with pytest.raises(ValueError, match="vocab"):
            SpeculativeEngine(tt, dataclasses.replace(
                tt, model_preset="small_vocab"), device="cpu")


@pytest.mark.parametrize("overrides,kind", [
    ({}, InferenceEngine),
    ({"draft_preset": "nano_test"}, SpeculativeEngine),
    ({"draft_preset": "nano_test", "temperature": 0.7}, InferenceEngine),
    ({"decode_batch": 2}, ContinuousBatchingEngine),
])
def test_manager_selects_the_jax_engine(overrides, kind, caplog):
    tier = dataclasses.replace(torch_config.tiny_cluster().orin, **overrides)
    manager = EngineManager(tier, device="cpu", warmup_on_start=False)
    with caplog.at_level(logging.WARNING):
        engine = manager.engine()
    try:
        assert type(engine) is kind
        warned = any("draft_preset" in r.message for r in caplog.records)
        assert warned == ("temperature" in overrides)
        if kind is SpeculativeEngine:
            assert engine.draft.name == "orin-draft"
            assert engine.gamma == tier.speculative_gamma
        assert engine.generate("user: spec tier", max_new_tokens=3).gen_tokens <= 3
    finally:
        manager.stop_server()


def test_tiny_cluster_matches_jax():
    """The port's tiny_cluster() tiers equal the JAX ones on every field
    the port declares, orin's tp=4 included (the carve shrinks it to the
    devices at hand)."""
    jc, tc = jax_config.tiny_cluster(), torch_config.tiny_cluster()
    for name in ("nano", "orin"):
        jt, tt = getattr(jc, name), getattr(tc, name)
        for field in dataclasses.fields(tt):
            assert getattr(tt, field.name) == getattr(jt, field.name), \
                (name, field.name)
    assert (jc.orin.tp, tc.orin.tp) == (4, 4)
    assert tc.nano.decode_batch == tc.orin.decode_batch == 1
