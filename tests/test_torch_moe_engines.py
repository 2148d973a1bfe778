"""MoE at ``ep = 1`` through the port's engines against the JAX
package's: greedy tokens of ``moe_test`` (a float32 copy, weights at 0.2
scale, so greedy decoding does not collapse onto one token) identical
to the JAX engines' through the sequential engine (its int8 cache request
ignored for MoE, as JAX ignores it; int8 weights; a prefix hit) and the
batched engine on the ragged and the dense tick, with int8 weights, the
int8 pool, chunked prefill, a prefix hit and a ``draft_test`` draft (the
same drafted and accepted totals); the sequential speculative engine
refuses a MoE tier (the JAX one builds dense weights for it).
``tests/test_torch_moe.py`` holds the model's functions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxBatched)
from distributed_llm_tpu.engine.inference import InferenceEngine as JaxSeq
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchBatched)
from distributed_llm_tpu_torch.engine.inference import InferenceEngine
from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
from distributed_llm_tpu_torch.models import moe as TM
from distributed_llm_tpu_torch.models.convert import params_from_jax
from test_torch_engine import _tree
from test_torch_moe import DRAFT, PRESET, presets  # noqa: F401
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


PROMPTS = ["rivers carry water down from the mountains to the sea",
           "bright stars shine over quiet hills tonight",
           "a long question about rivers lakes mountains oceans deltas "
           "and the weather systems that move between them " * 3]


def _batched_run(engine):
    reqs = [engine.submit(p) for p in PROMPTS]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    turn1 = [{"role": "user", "content": "tell me about the tallest hills"}]
    first = engine.generate(turn1)
    turn2 = turn1 + [{"role": "assistant", "content": first.text},
                     {"role": "user", "content": "and the lakes?"}]
    return ([r.result.token_ids for r in reqs]
            + [first.token_ids, engine.generate(turn2).token_ids])


BATCHED = {
    "ragged": {},
    "dense_tick": {"attention_ragged": False},
    "int8_weights": {"quantize": "int8"},
    "int8_pool": {"kv_quantize": "int8"},
    "chunked": {"prefill_chunk_tokens": 32,
                "prefill_buckets": (16, 32, 64, 128)},
    "draft": {"draft_preset": DRAFT, "spec_decode": True},
}


@pytest.mark.parametrize("mode", sorted(BATCHED))
def test_batched_engine_emits_jax_tokens(presets, mode):
    kw = dict(model_preset=PRESET, **BATCHED[mode])
    jtier = dataclasses.replace(jax_config.tiny_batched_cluster().nano, **kw)
    ttier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                                **kw)
    jax_engine = JaxBatched(jtier, params=jax.tree_util.tree_map(
        jnp.asarray, presets))
    draft_params = None
    if mode == "draft":
        dtree = _tree(torch_config.MODEL_PRESETS[DRAFT], seed=7)
        jax_engine.params_d = jax.tree_util.tree_map(jnp.asarray, dtree)
        draft_params = params_from_jax(torch_config.MODEL_PRESETS[DRAFT],
                                       dtree)
    port = TorchBatched(ttier, device="cpu", draft_params=draft_params,
                        params=params_from_jax(ttier.model(), presets))
    try:
        assert isinstance(port.model.layers[0], TM.MoELayer)
        assert port.spec == (mode == "draft")
        want, got = _batched_run(jax_engine), _batched_run(port)
        assert got == want
        assert len(set(got[0])) > 3
        assert port.prefix_cache.stats()["hits"] >= 1
        if mode == "draft":
            assert (port.spec_drafted_total, port.spec_accepted_total) == (
                jax_engine.spec_drafted_total, jax_engine.spec_accepted_total)
    finally:
        jax_engine.stop()
        port.stop()


@pytest.mark.parametrize("mode", ["bf16", "kv_int8_ignored", "int8_weights"])
def test_inference_engine_emits_jax_tokens(presets, mode):
    kw = {"bf16": {}, "kv_int8_ignored": {"kv_quantize": "int8"},
          "int8_weights": {"quantize": "int8"}}[mode]
    jt, tt = (dataclasses.replace(pkg.tiny_cluster().nano,
                                  model_preset=PRESET, **kw)
              for pkg in (jax_config, torch_config))
    pair = (JaxSeq(jt, params=jax.tree_util.tree_map(jnp.asarray, presets)),
            InferenceEngine(tt, device="cpu",
                            params=params_from_jax(tt.model(), presets)))
    assert pair[1]._kv_quantize == "none"
    assert "ks" not in pair[1]._cache(256)
    long = "user: " + " ".join(f"word{i}" for i in range(25))
    for history in (PROMPTS[0], long):
        want, got = (e.generate(history) for e in pair)
        assert got.token_ids == want.token_ids
    turn1 = [{"role": "user", "content": PROMPTS[1]}]
    want, got = (e.generate(turn1) for e in pair)
    assert got.token_ids == want.token_ids
    turn2 = turn1 + [{"role": "assistant", "content": want.text},
                     {"role": "user", "content": "and then?"}]
    hits = [e.prefix_cache.stats()["hits"] for e in pair]
    want, got = (e.generate(turn2) for e in pair)
    assert got.token_ids == want.token_ids
    assert [e.prefix_cache.stats()["hits"] for e in pair] == [
        h + 1 for h in hits]


def test_sequential_speculative_engine_refuses_moe():
    tier = dataclasses.replace(torch_config.tiny_cluster().nano,
                               model_preset="moe_test")
    draft = dataclasses.replace(tier, model_preset="draft_test")
    with pytest.raises(ValueError, match="dense models only"):
        SpeculativeEngine(tier, draft, device="cpu")
    with pytest.raises(ValueError, match="dense models only"):
        SpeculativeEngine(draft, tier, device="cpu")
