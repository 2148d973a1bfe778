"""Engine parity: the port's ContinuousBatchingEngine (device="cpu")
against the JAX package's, on the nano tier of ``tiny_batched_cluster()``.

Both engines get the same float32 weights (a seeded numpy tree at 0.2
scale, so greedy decoding does not collapse onto one repeated token) and
greedy decoding; their emitted tokens must be IDENTICAL for cold
requests, chunked prefills, a multi-turn prefix-hit follow-up and
concurrent requests.  A float32 copy of ``nano_test`` is registered in
both packages' preset tables for the duration of the module.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxEngine)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchEngine)
from distributed_llm_tpu_torch.models.convert import params_from_jax

PRESET = "nano_test_f32"

COLD = ["rivers carry water down from the mountains to the sea",
        "explain how a compiler turns source code into machine code"]
CONCURRENT = ["alpha particles and their decay",
              "bright stars shine over quiet hills tonight",
              "cold weather makes the lakes freeze early this year"]
LONG = ("a long question about rivers lakes mountains oceans deltas "
        "and the weather systems that move between them " * 3)


def _tree(cfg, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    h, f, l, d = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, cfg.head_dim

    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"embed": n(cfg.vocab_size, h),
            "final_ln": np.ones(h, np.float32),
            "layers": {"ln1": np.ones((l, h), np.float32),
                       "ln2": np.ones((l, h), np.float32),
                       "wq": n(l, h, cfg.num_heads * d),
                       "wk": n(l, h, cfg.num_kv_heads * d),
                       "wv": n(l, h, cfg.num_kv_heads * d),
                       "wo": n(l, cfg.num_heads * d, h),
                       "w_gate": n(l, h, f), "w_up": n(l, h, f),
                       "w_down": n(l, f, h)}}


@pytest.fixture(scope="module")
def make_pair():
    """Build (jax_engine, port_engine) pairs over the same weights; every
    pair is stopped, and must hold no pool block after stop."""
    built = []
    with pytest.MonkeyPatch.context() as mp:
        base = jax_config.MODEL_PRESETS["nano_test"]
        mp.setitem(jax_config.MODEL_PRESETS, PRESET,
                   dataclasses.replace(base, name=PRESET, dtype="float32"))
        mp.setitem(torch_config.MODEL_PRESETS, PRESET,
                   dataclasses.replace(torch_config.MODEL_PRESETS["nano_test"],
                                       name=PRESET, dtype="float32"))
        tree = _tree(torch_config.MODEL_PRESETS[PRESET])
        jax_params = {"embed": jnp.asarray(tree["embed"]),
                      "final_ln": jnp.asarray(tree["final_ln"]),
                      "layers": {k: jnp.asarray(v)
                                 for k, v in tree["layers"].items()}}

        def build(**overrides):
            jtier = dataclasses.replace(
                jax_config.tiny_batched_cluster().nano, model_preset=PRESET,
                **overrides)
            ttier = dataclasses.replace(
                torch_config.tiny_batched_cluster().nano, model_preset=PRESET,
                **overrides)
            pair = (JaxEngine(jtier, params=jax_params),
                    TorchEngine(ttier, device="cpu", params=params_from_jax(
                        torch_config.MODEL_PRESETS[PRESET], tree)))
            built.append(pair)
            return pair

        yield build
        for jax_engine, port_engine in built:
            jax_engine.stop()
            port_engine.stop()
            assert port_engine.allocator.ref_stats()["allocated_blocks"] == 0


@pytest.fixture(scope="module")
def default_pair(make_pair):
    return make_pair()


def _run(engine, prompts):
    reqs = [engine.submit(p) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    return [r.result.token_ids for r in reqs]


def test_cold_requests_emit_identical_tokens(default_pair):
    jax_engine, port_engine = default_pair
    for prompt in COLD:
        want = jax_engine.generate(prompt).token_ids
        got = port_engine.generate(prompt).token_ids
        assert got == want
        assert len(set(got)) > 3            # not a degenerate repeat


@pytest.mark.parametrize("share", [True, False])
def test_prefix_hit_follow_up_emits_identical_tokens(make_pair, share):
    """Multi-turn follow-up over the parked first turn: shared (pinned,
    copy-on-write boundary block) and exclusive (take) reuse."""
    pair = make_pair(share_prefix_kv=share)
    turn1 = [{"role": "user", "content": "tell me about the tallest mountains"}]
    first = [e.generate(turn1) for e in pair]
    assert first[1].token_ids == first[0].token_ids
    turn2 = turn1 + [{"role": "assistant", "content": first[0].text},
                     {"role": "user", "content": "and the deepest lakes?"}]
    key = "hits_shared" if share else "hits_exclusive"
    hits = [e.prefix_cache.stats()[key] for e in pair]
    second = [e.generate(turn2) for e in pair]
    assert second[1].token_ids == second[0].token_ids
    # Both engines reused the parked prefix the same way.
    assert [e.prefix_cache.stats()[key] for e in pair] == [h + 1 for h in hits]


def test_concurrent_requests_emit_identical_tokens(default_pair):
    jax_engine, port_engine = default_pair
    assert _run(port_engine, CONCURRENT) == _run(jax_engine, CONCURRENT)


def test_chunked_prefill_emits_identical_tokens(make_pair):
    jax_engine, port_engine = make_pair(prefill_chunk_tokens=16,
                                        prefill_buckets=(16, 32, 64, 128))
    prompts = [LONG, "short prompt about rivers and lakes", LONG + " why?"]
    started = []
    real_start = port_engine._start_prefill
    port_engine._start_prefill = lambda *a, **k: (started.append(a[0]),
                                                  real_start(*a, **k))
    got = _run(port_engine, prompts)
    assert len(started) == 2                 # both long prompts chunked
    assert port_engine.prefill_cancelled_total == 0
    assert got == _run(jax_engine, prompts)


def _port_engine(**overrides):
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               **overrides)
    return TorchEngine(tier, device="cpu")


def test_stop_fails_pending_requests_instead_of_hanging():
    engine = _port_engine()
    req = engine.submit("will never run", max_new_tokens=4)
    engine.stop()
    assert req.done.wait(timeout=5)
    if req.error is not None:
        # Failed by stop(), with the reference error shape.
        assert "stopped" in req.error.shape["error"]
    assert engine.allocator.ref_stats()["allocated_blocks"] == 0


def test_decode_error_fails_slot_but_scheduler_survives():
    engine = _port_engine()
    real_tick = engine._decode_tick
    calls = {"n": 0}

    def flaky_tick():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("tick exploded")
        return real_tick()

    engine._decode_tick = flaky_tick
    try:
        with pytest.raises(RuntimeError, match="tick exploded"):
            engine.generate("first request", max_new_tokens=6)
        result = engine.generate("second request", max_new_tokens=6)
        assert result is not None and result.gen_tokens <= 6
    finally:
        engine.stop()
    assert engine.allocator.ref_stats()["allocated_blocks"] == 0


def test_engine_refuses_unported_features():
    """ep=2 on a dense tier is served and ignored, as JAX's carve ignores
    it (nothing to shard on 'ep'); decode_batch=1 is still the
    sequential engine's, not this one's."""
    engine = _port_engine(ep=2)
    try:
        assert engine.group is None
        assert engine.generate("ep on a dense tier", max_new_tokens=3
                               ).gen_tokens <= 3
    finally:
        engine.stop()
    with pytest.raises(NotImplementedError):
        _port_engine(decode_batch=1)


def test_failing_prefix_hit_metric_leaks_no_shared_blocks(monkeypatch):
    """A shared prefix hit hands its blocks off before the hit's metric
    is noted, and a failing metric never fails the admission, as in the
    JAX engine (``_note_prefix_hit`` swallows it there).  Before, a raise
    from ``dllm_prefix_hits_total`` escaped ``_reuse_blocks`` after the
    share incref and the private allocation: the follow-up turn failed
    and the pool kept every one of those blocks after ``stop()``."""
    from distributed_llm_tpu_torch.obs import get_observability

    class Broken:
        def labels(self, *values):
            raise RuntimeError("metric registry unavailable")

    engine = _port_engine(share_prefix_kv=True)
    try:
        turn1 = [{"role": "user", "content": "tell me about the tallest "
                                             "mountains"}]
        first = engine.generate(turn1, max_new_tokens=6)
        monkeypatch.setattr(get_observability().m, "prefix_hits", Broken())
        hits = engine.prefix_cache.stats()["hits_shared"]
        turn2 = turn1 + [{"role": "assistant", "content": first.text},
                         {"role": "user", "content": "and the lakes?"}]
        second = engine.generate(turn2, max_new_tokens=6)
        assert second.gen_tokens > 0
        assert engine.prefix_cache.stats()["hits_shared"] == hits + 1
    finally:
        engine.stop()
    assert engine.allocator.ref_stats()["allocated_blocks"] == 0
