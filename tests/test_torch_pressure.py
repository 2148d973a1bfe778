"""The constrained KV pool of the port's batched engine (device="cpu"):
KV-aware admission, mid-decode preemption with replay, and parity with
the JAX engine under the same pool.

The engine-level cases of tests/test_pressure.py run against the port,
on a float32 copy of ``nano_test`` (greedy replay must give the
unpreempted run's tokens exactly); the parity cases run the JAX engine
and the port on the same weights (``models/convert.params_from_jax``) and
the same constrained pool and compare tokens and ``preempted_total``
exactly.  The one tolerance is the K/V check of blocks a preemption freed
and another slot re-took: decode-written K/V against a fresh float32
prefill of the same tokens, rtol = atol = 1e-4.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import batching as JB
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching as TB
from distributed_llm_tpu_torch.engine.inference import prepare_prompt
from distributed_llm_tpu_torch.engine.manager import EngineManager
from distributed_llm_tpu_torch.engine.paged_kv import TRASH_BLOCK
from distributed_llm_tpu_torch.models import transformer
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.serving.errors import is_error_shape
from distributed_llm_tpu_torch.serving.tiers import (AdmissionController,
                                                     TierClient)

PRESET = "nano_test_f32"

# Long enough prompts that two concurrent requests outgrow a 5-block pool
# (bucket 16 + a 24-token budget each): the deterministic preemption setup.
PROBE_A = "tell me about rivers and lakes and streams and oceans please"
PROBE_B = "what is the tallest mountain on the continent of asia today"


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
def f32():
    """A float32 nano_test in both packages' preset tables, and its
    seeded weights: (jax params, port tree)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_config.MODEL_PRESETS, PRESET, dataclasses.replace(
            jax_config.MODEL_PRESETS["nano_test"], name=PRESET,
            dtype="float32"))
        mp.setitem(torch_config.MODEL_PRESETS, PRESET, dataclasses.replace(
            torch_config.MODEL_PRESETS["nano_test"], name=PRESET,
            dtype="float32"))
        tree = _tree(torch_config.MODEL_PRESETS[PRESET])
        jax_params = {"embed": jnp.asarray(tree["embed"]),
                      "final_ln": jnp.asarray(tree["final_ln"]),
                      "layers": {k: jnp.asarray(v)
                                 for k, v in tree["layers"].items()}}
        yield jax_params, tree


def _tier(pkg=torch_config, **kw):
    base = dict(model_preset=PRESET, decode_batch=2, max_new_tokens=24)
    base.update(kw)
    return dataclasses.replace(pkg.tiny_cluster().nano, **base)


def _port(f32, **kw):
    return TB.ContinuousBatchingEngine(
        _tier(**kw), device="cpu",
        params=params_from_jax(torch_config.MODEL_PRESETS[PRESET], f32[1]))


def _tight(f32, **kw):
    kw.setdefault("kv_pool_blocks", 5)
    kw.setdefault("enable_prefix_cache", False)
    return _port(f32, **kw)


@pytest.fixture(scope="module")
def solo(f32):
    """Unpreempted greedy baselines on a full-residency pool."""
    engine = _port(f32)
    try:
        return {"a": engine.generate(PROBE_A), "b": engine.generate(PROBE_B)}
    finally:
        engine.stop()


def _queued_together(engine, module, prompts, **kw):
    """Queue every prompt BEFORE the scheduler starts (the first admission
    pass takes them in order, in one pass: deterministic admit order and
    preemptions), then run them.  Returns the requests."""
    reqs = [module._Request(history=p, max_new_tokens=None,
                            temperature=None, **kw) for p in prompts]
    for r in reqs:
        engine._queue.put(r)
    engine.start()
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    return reqs


# -- KV-aware admission ------------------------------------------------------

def test_kv_admission_boundary():
    """Demand == supply admits (the request CAN be served once parked
    blocks are evicted); demand > supply rejects with the KV reason."""
    ac = AdmissionController(dataclasses.replace(
        torch_config.tiny_cluster().nano, decode_batch=4))
    assert ac.try_admit(kv_demand=4, kv_supply=4) is None
    err = ac.try_admit(kv_demand=5, kv_supply=4)
    assert err is not None and "KV demand" in err, err
    assert ac.kv_rejected == 1
    assert ac.snapshot()["kv_rejected"] == 1
    # Either side None skips the gate entirely.
    assert ac.try_admit(kv_demand=99, kv_supply=None) is None
    assert ac.try_admit() is None


def test_kv_admission_tier_client_reject_and_retry_hint(f32):
    """A running constrained engine under pressure rejects with the
    reference error shape plus retry_after_s; the error dict carries no
    unsanctioned keys; once blocks return, the same client serves."""
    tier = _tier(kv_pool_blocks=5, enable_prefix_cache=False)
    manager = EngineManager(tier, warmup_on_start=False, device="cpu")
    client = TierClient(tier, manager)
    manager.start_server()
    try:
        engine = manager.engine()
        # The gate is armed: the engine has a demand estimate, the prompt's
        # bucket plus the decode budget in blocks.
        _, bucket = prepare_prompt(engine.tokenizer, PROBE_A,
                                   tier.prefill_buckets, 256, 24)
        assert engine.projected_demand_blocks(PROBE_A) == \
            -(-(bucket + 24) // 16)
        assert engine.projected_demand_blocks(PROBE_A, 8) == \
            -(-(bucket + 8) // 16)
        assert engine.max_demand_blocks() == -(-(64 + 24) // 16)
        # Confiscate the whole pool: projected demand exceeds supply 0.
        held = engine.allocator.alloc(engine.allocator.available)
        out = client.process(PROBE_A)
        assert is_error_shape(out), out
        assert "KV demand" in out["error"]
        assert "retry_after_s" in out and out["retry_after_s"] > 0
        assert set(out) <= {"error", "retry_after_s"}
        engine.allocator.free(held)
        ok = client.process("short question about rivers")
        assert "response" in ok, ok
    finally:
        manager.stop_server()


def test_kv_admission_gate_off_or_engine_stopped_is_noop():
    tier_off = dataclasses.replace(torch_config.tiny_cluster().nano,
                                   decode_batch=2, kv_admission=False)
    client = TierClient(tier_off, EngineManager(
        tier_off, warmup_on_start=False, device="cpu"))
    assert client._kv_admission_args("hello") == (None, None)
    tier_on = dataclasses.replace(torch_config.tiny_cluster().nano,
                                  decode_batch=2)
    stopped = TierClient(tier_on, EngineManager(
        tier_on, warmup_on_start=False, device="cpu"))
    # Engine never started: nothing to gate on (and no lazy start).
    assert stopped._kv_admission_args("hello") == (None, None)
    assert not stopped.server_manager.is_server_running()


def test_kv_gate_skips_tokenizing_when_supply_covers_worst_case():
    """A full-residency pool always covers the worst case: the gate does
    not apply (None, None) without tokenizing the prompt."""
    tier = dataclasses.replace(torch_config.tiny_cluster().nano,
                               decode_batch=2)
    manager = EngineManager(tier, warmup_on_start=False, device="cpu")
    client = TierClient(tier, manager)
    manager.start_server()
    try:
        engine = manager.engine()
        calls = []
        real = engine.projected_demand_blocks
        engine.projected_demand_blocks = lambda *a: calls.append(a) or real(*a)
        assert client._kv_admission_args(PROBE_A) == (None, None)
        assert calls == []
    finally:
        manager.stop_server()


# -- mid-decode preemption with replay ---------------------------------------

def test_preempt_replay_byte_identical(f32, solo):
    """Two concurrent requests on a 5-block pool: the youngest slot is
    preempted when the elder's growth empties the pool, replays on
    re-admission, and BOTH final texts match their unpreempted runs."""
    engine = _tight(f32)
    res = {}
    try:
        threads = [threading.Thread(
            target=lambda k, q: res.__setitem__(k, engine.generate(q)),
            args=(k, q)) for k, q in (("a", PROBE_A), ("b", PROBE_B))]
        threads[0].start()
        time.sleep(0.02)
        threads[1].start()
        for t in threads:
            t.join(timeout=120)
        assert engine.preempted_total >= 1
        assert res["a"].token_ids == solo["a"].token_ids
        assert res["b"].token_ids == solo["b"].token_ids
        assert res["a"].text == solo["a"].text
        assert res["b"].text == solo["b"].text
        # Every block back in the pool (no prefix cache: nothing parked).
        assert engine.allocator.available == engine.paged.num_blocks - 1
    finally:
        engine.stop()
    assert engine.allocator.available == engine.paged.num_blocks - 1


def test_preempted_stream_stalls_never_errors(f32, solo):
    """A STREAMING request that gets preempted sees a stall, then its
    remaining tokens: never an error, and no token is re-emitted."""
    engine = _tight(f32)
    try:
        out = {}

        def elder():
            out["a"] = engine.generate(PROBE_A)

        t = threading.Thread(target=elder)
        t.start()
        time.sleep(0.02)
        handle = engine.generate_stream(PROBE_B)    # youngest: the victim
        deltas = list(handle)
        t.join(timeout=120)
        assert engine.preempted_total >= 1
        assert handle.request.preempt_count >= 1
        assert "".join(deltas) == solo["b"].text
        assert handle.result.token_ids == solo["b"].token_ids
    finally:
        engine.stop()


def test_preemption_victim_is_youngest(f32, solo):
    """The victim policy frees the MOST recently admitted slot: the elder
    request completes without ever being preempted, the victim keeps its
    age across the replay and its first TTFT."""
    engine = _tight(f32)
    try:
        a, b = _queued_together(engine, TB, [PROBE_A, PROBE_B])
        assert engine.preempted_total >= 1
        assert (a.admit_seq, b.admit_seq) == (0, 1)
        assert a.preempt_count == 0 and b.preempt_count >= 1
        assert b.replay_tokens is None           # consumed by the replay
        assert b.result.token_ids == solo["b"].token_ids
        assert b.result.ttft_ms <= a.result.total_ms + b.result.total_ms
    finally:
        engine.stop()


def test_sole_occupant_that_cannot_grow_finishes_with_what_it_has(f32):
    """One slot on a pool that holds its bucket plus one tick only: it
    cannot be preempted into the same wall, so it finishes early (the JAX
    engine's sole-occupant rule) and every block returns."""
    engine = _tight(f32, kv_pool_blocks=5, max_new_tokens=200)
    try:
        # 12 prompt tokens + 200: wants 14 blocks, the pool has 5.
        res = engine.generate(PROBE_A)
        assert 0 < res.gen_tokens < 200
        # Every position but the last token's holds K/V in the 5 blocks.
        assert res.prompt_tokens + res.gen_tokens - 1 <= 5 * 16
        assert engine.preempted_total == 0
        assert engine.allocator.available == engine.paged.num_blocks - 1
    finally:
        engine.stop()


def test_kv_pool_blocks_validation(f32):
    """A pool that cannot fit one largest-bucket prefill plus a decode
    tick raises JAX's ValueError at build (before any weight is made);
    the smallest legal pool builds."""
    with pytest.raises(ValueError, match="kv_pool_blocks=2 cannot fit"):
        _port(f32, kv_pool_blocks=2)
    with pytest.raises(ValueError, match="needs >= 5 blocks"):
        TB.ContinuousBatchingEngine(_tier(kv_pool_blocks=4), device="cpu")
    engine = _port(f32, kv_pool_blocks=5)
    assert engine.paged.num_blocks == 6 and engine.allocator.available == 5
    engine.stop()


def test_freed_blocks_retaken_hold_the_new_owners_kv(f32, solo):
    """Stale table rows under replayed ticks: after the preemption the
    victim's row reads the trash block at the next tick, and the blocks it
    freed, re-taken by the elder as it grows, hold the ELDER's K/V (a
    dead slot's stale row would write its own K/V there): the elder's
    pool rows equal a fresh float32 prefill of its tokens."""
    engine = _tight(f32, max_new_tokens=40)
    freed, rows_after, snapshot = [], [], {}
    real_preempt, real_tick, real_finish = (
        engine._preempt, engine._decode_tick, engine._finish)

    def preempt(ix):
        freed.append((ix, list(engine._slots[ix].blocks)))
        real_preempt(ix)

    def tick(wb=None):
        out = real_tick(wb)
        if freed and len(rows_after) < 1:
            rows_after.append(engine._tables_dev[freed[0][0]].clone())
        return out

    def finish(ix):
        slot = engine._slots[ix]
        if slot.request.admit_seq == 0 and "blocks" not in snapshot:
            pos = int(engine._pos[ix])
            snapshot.update(blocks=list(slot.blocks), pos=pos,
                            seq=list(slot.prompt_ids) + slot.tokens[:-1],
                            k=engine.pool["k"].clone(),
                            v=engine.pool["v"].clone())
        real_finish(ix)

    engine._preempt, engine._decode_tick, engine._finish = (
        preempt, tick, finish)
    # The elder's longer budget makes it grow into the victim's blocks.
    a = TB._Request(history=PROBE_A, max_new_tokens=40, temperature=None)
    b = TB._Request(history=PROBE_B, max_new_tokens=24, temperature=None)
    try:
        engine._queue.put(a)
        engine._queue.put(b)
        engine.start()
        assert a.done.wait(timeout=120) and b.done.wait(timeout=120)
        assert a.error is None and b.error is None
    finally:
        engine.stop()
    assert freed and rows_after
    assert bool((rows_after[0] == TRASH_BLOCK).all())
    assert a.result.gen_tokens == 40
    assert b.result.token_ids == solo["b"].token_ids
    retaken = set(freed[0][1]) & set(snapshot["blocks"])
    assert retaken, (freed, snapshot["blocks"])
    seq, pos, bs = snapshot["seq"], snapshot["pos"], engine.paged.block_size
    assert len(seq) == pos
    tokens = torch.tensor([seq])
    _, (k_all, v_all) = transformer.prefill(
        engine.cfg, engine.model, tokens, torch.arange(pos)[None])
    blk = torch.tensor([snapshot["blocks"][p // bs] for p in range(pos)])
    off = torch.arange(pos) % bs
    for name, ref in (("k", k_all), ("v", v_all)):
        got = snapshot[name][:, :, blk, off]              # [L, N_kv, S, D]
        want = ref[:, 0].permute(0, 2, 1, 3)              # [L, N_kv, S, D]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# -- parity with the JAX engine ----------------------------------------------

PARITY_CASES = {
    "ragged": {},
    "dense": {"attention_ragged": False},
    "chunked_replay": {"prefill_chunk_tokens": 16, "max_new_tokens": 40},
    "spec": {"draft_preset": PRESET, "spec_decode": True},
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_constrained_pool_matches_jax(f32, case):
    """The JAX engine and the port on the same float32 weights and the
    same 5-block pool, both requests queued before the scheduler starts:
    the same tokens for both requests and the same preemption count."""
    kw = dict(kv_pool_blocks=5, enable_prefix_cache=False,
              **PARITY_CASES[case])
    jax_engine = JB.ContinuousBatchingEngine(_tier(jax_config, **kw),
                                             params=f32[0])
    port = _port(f32, **kw)
    try:
        want = _queued_together(jax_engine, JB, [PROBE_A, PROBE_B])
        got = _queued_together(port, TB, [PROBE_A, PROBE_B])
        assert [r.result.token_ids for r in got] == \
            [r.result.token_ids for r in want]
        assert port.preempted_total == jax_engine.preempted_total >= 1
        assert [r.preempt_count for r in got] == \
            [r.preempt_count for r in want]
        if case == "chunked_replay":
            assert port.prefill_cancelled_total == \
                jax_engine.prefill_cancelled_total
    finally:
        jax_engine.stop()
        port.stop()
    assert port.allocator.available == port.paged.num_blocks - 1


def test_kv_stats_and_slot_stats_carry_preemptions(f32):
    engine = _tight(f32)
    try:
        _queued_together(engine, TB, [PROBE_A, PROBE_B])
        ks, ss = engine.kv_stats(), engine.slot_stats()
        assert ks["preempted_total"] == ss["preempted_total"] \
            == engine.preempted_total >= 1
        assert ks["total_blocks"] == 5 and "host_blocks" not in ks
    finally:
        engine.stop()


def test_spec_private_cow_starved_preempts_never_writes_shared(f32, solo):
    """The copy-on-write backstop before a speculative round: a shared
    block at a speculating slot's write frontier, with a pool too dry to
    copy it, preempts the slot (it never writes a sharer-visible block);
    the request then replays to the unpreempted run's tokens."""
    engine = _tight(f32, draft_preset=PRESET, spec_decode=True)
    req = TB._Request(history=PROBE_A, max_new_tokens=None, temperature=None)
    try:
        assert engine.spec and engine._admit(req, 0)
        slot = engine._slots[0]
        assert slot.spec and slot.gamma > 0
        frontier = slot.blocks[int(engine._pos[0]) // 16]
        engine.allocator.share([frontier])           # another holder
        held = engine.allocator.alloc(engine.allocator.available)
        engine._ensure_spec_private([0], engine._gamma_buckets[-1])
        assert engine._slots[0] is None and engine.preempted_total == 1
        assert req.preempt_count == 1 and req.replay_tokens == slot.tokens
        assert list(engine._head) == [req]
        assert engine.allocator.refcount(frontier) == 1    # ours alone
        assert bool((torch.from_numpy(engine._tables[0])
                     == TRASH_BLOCK).all())
        engine.allocator.free(held + [frontier])
        engine.start()
        assert req.done.wait(timeout=120) and req.error is None
        assert req.result.token_ids == solo["a"].token_ids
    finally:
        engine.stop()
    assert engine.allocator.available == engine.paged.num_blocks - 1


def test_hit_that_cannot_materialize_admits_cold_when_idle(f32):
    """A prefix hit must materialize its prompt and budget at once; on a
    6-block pool a second 58-token prompt sharing the chat template with
    the parked first one needs 6 private blocks while the pinned entry
    holds 4 of the 6.  With nothing running that could free a block the
    port hands the hit back and admits cold (the JAX engine requeues the
    request forever, ROADMAP.md C); the tokens equal a cold run's."""
    words = ("rivers lakes mountains oceans deltas weather systems clouds "
             "rain snow glaciers valleys forests deserts islands coasts "
             "tides storms winds seasons").split()
    first, second = (f"short {i}: " + " ".join(
        words[(j + 7 * i) % len(words)] for j in range(24)) for i in (0, 1))
    cold = _port(f32, enable_prefix_cache=False)
    try:
        want = cold.generate(second).token_ids
    finally:
        cold.stop()
    engine = _port(f32, kv_pool_blocks=6, decode_batch=4,
                   prefill_chunk_tokens=16)
    try:
        engine.generate(first)
        assert engine.prefix_cache.stats()["entries"] == 1
        misses = engine.prefix_cache.stats()["misses"]
        req = engine.submit(second)
        assert req.done.wait(timeout=60) and req.error is None
        assert req.result.token_ids == want
        assert engine.prefix_cache.stats()["misses"] > misses
        assert engine.prefix_cache.stats()["hits"] == 0
    finally:
        engine.stop()
    assert engine.allocator.available == engine.paged.num_blocks - 1
