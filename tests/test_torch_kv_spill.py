"""The host KV spill tier of the port (engine/kv_spill.py; device="cpu"):
an eviction from the device prefix cache DEMOTES an unpinned sole-owner
entry to a budgeted host-RAM LRU, and a later prefix hit PROMOTES it back
through the chunked-prefill lane, with JAX's race rule (a promotion that
loses falls back to a cold prefill with identical greedy output).

The cases of tests/test_kv_spill.py run against the port (the
environment override and the replica affinity cases wait for the fleet
slice), plus parity with the JAX package: ``gather_blocks`` and
``scatter_blocks`` against JAX's on the same numpy pool (bf16 and int8:
bit-identical, tolerance 0), and the JAX engine against the port on the
same float32 weights over one session churn (the same tokens and the
same demote and promote counts, exactly).  The pause/resume hooks make
the races deterministic.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import batching as JB
from distributed_llm_tpu.engine import paged_kv as JKV
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching as TB
from distributed_llm_tpu_torch.engine import paged_kv as TKV
from distributed_llm_tpu_torch.engine.inference import prepare_prompt
from distributed_llm_tpu_torch.engine.kv_spill import (COPYING, DEAD,
                                                       RESIDENT, HostKVSpill)
from distributed_llm_tpu_torch.engine.prefix_cache import PrefixCache
from distributed_llm_tpu_torch.models.convert import params_from_jax

PROMPT = "user: tell me about rivers lakes mountains oceans and deltas"
TURN2 = PROMPT + " and also glaciers please"
PRESET = "nano_test_f32"


WEIGHTS: list = []           # (jax params, port tree), set by f32_weights


@pytest.fixture(scope="module", autouse=True)
def f32_weights():
    """A float32 nano_test in both packages' preset tables and its seeded
    weights at 0.2 scale (greedy output that depends on its context, so a
    promoted prefix with wrong K/V shows): (jax params, port tree).  Every
    engine of the module serves them."""
    with pytest.MonkeyPatch.context() as mp:
        for cfg_mod in (jax_config, torch_config):
            mp.setitem(cfg_mod.MODEL_PRESETS, PRESET, dataclasses.replace(
                cfg_mod.MODEL_PRESETS["nano_test"], name=PRESET,
                dtype="float32"))
        cfg = torch_config.MODEL_PRESETS[PRESET]
        rng = np.random.default_rng(0)
        h, f, l, d = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                      cfg.head_dim)

        def n(*shape):
            return (rng.standard_normal(shape) * 0.2).astype(np.float32)

        tree = {"embed": n(cfg.vocab_size, h),
                "final_ln": np.ones(h, np.float32),
                "layers": {"ln1": np.ones((l, h), np.float32),
                           "ln2": np.ones((l, h), np.float32),
                           "wq": n(l, h, cfg.num_heads * d),
                           "wk": n(l, h, cfg.num_kv_heads * d),
                           "wv": n(l, h, cfg.num_kv_heads * d),
                           "wo": n(l, cfg.num_heads * d, h),
                           "w_gate": n(l, h, f), "w_up": n(l, h, f),
                           "w_down": n(l, f, h)}}
        jax_params = {"embed": jnp.asarray(tree["embed"]),
                      "final_ln": jnp.asarray(tree["final_ln"]),
                      "layers": {k: jnp.asarray(v)
                                 for k, v in tree["layers"].items()}}
        WEIGHTS[:] = [jax_params, tree]
        yield jax_params, tree


def _tier(pkg=torch_config, **kw):
    defaults = dict(model_preset=PRESET, max_new_tokens=6, decode_batch=2,
                    prefill_chunk_tokens=16, prefix_cache_entries=4,
                    host_kv_bytes=64 * 1024 * 1024)
    defaults.update(kw)
    return dataclasses.replace(pkg.tiny_cluster().nano, **defaults)


def _engine(**kw):
    return TB.ContinuousBatchingEngine(
        _tier(**kw), device="cpu", params=params_from_jax(
            torch_config.MODEL_PRESETS[PRESET], WEIGHTS[1]))


def _cold_reference(prompts, **kw):
    """Greedy outputs of a spill-less engine over the same prompts: the
    identity oracle of every fallback path."""
    kw.setdefault("host_kv_bytes", None)
    eng = _engine(**kw)
    try:
        return [eng.generate(p).token_ids for p in prompts]
    finally:
        eng.stop()


def _demote_parked(eng, timeout=10.0):
    """Evict the (single) parked prefix and wait for its host copy."""
    assert eng.prefix_cache.pop_oldest() is not None
    assert eng.kv_spill.flush(timeout)


def _wait_host_hit(eng, timeout=10.0):
    deadline = time.time() + timeout
    while (eng.kv_spill.stats()["host_hits"] == 0
           and time.time() < deadline):
        time.sleep(0.001)


def _tiles(nb=2):
    """A store-level snapshot: (tiles, no event) on the CPU."""
    return ({"k": torch.zeros(nb, 1, 1, 4, 2), "v": torch.zeros(nb, 1, 1, 4, 2)},
            None)


TILE_BYTES = 2 * 2 * 4 * 2 * 4            # both tiles of _tiles(2), float32


# -- gather / scatter against the JAX package ---------------------------------

@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_gather_scatter_match_jax_bit_for_bit(kv_quantize):
    """The same numpy pool through both packages' ``gather_blocks`` and
    ``scatter_blocks``: equal bits (tolerance 0), and the port's round
    trip restores the pool exactly."""
    rng = np.random.default_rng(3)
    shape = (2, 2, 9, 4, 8)                       # [L, N_kv, NB, bs, D]
    if kv_quantize == "int8":
        arrays = {"k": rng.integers(-127, 128, shape, dtype=np.int8),
                  "v": rng.integers(-127, 128, shape, dtype=np.int8),
                  "ks": rng.random(shape[:-1], dtype=np.float32),
                  "vs": rng.random(shape[:-1], dtype=np.float32)}
    else:
        arrays = {n: rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
                  for n in ("k", "v")}

    def as_torch(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    def bits(t):
        if isinstance(t, torch.Tensor):
            return (t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy()
        a = np.asarray(t)
        return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a

    blocks = [7, 2, 5]
    jpool = {n: jnp.asarray(a) for n, a in arrays.items()}
    tpool = {n: as_torch(a) for n, a in arrays.items()}
    jg = JKV.gather_blocks(jpool, jnp.asarray(blocks, jnp.int32))
    tg = TKV.gather_blocks(tpool, torch.tensor(blocks))
    assert set(tg) == set(jg) == set(arrays)
    for n in arrays:
        assert tg[n].shape == tuple(jg[n].shape)
        np.testing.assert_array_equal(bits(tg[n]), bits(jg[n]))
    # Scatter the gathered tiles into other blocks: the same pool in both.
    dst = [1, 3, 8]
    js = JKV.scatter_blocks(jpool, jnp.asarray(dst, jnp.int32), jg)
    saved = {n: t.clone() for n, t in tpool.items()}
    ts = TKV.scatter_blocks(tpool, torch.tensor(dst), tg)
    for n in arrays:
        np.testing.assert_array_equal(bits(ts[n]), bits(js[n]))
    # The round trip: scatter back what was gathered from dst.
    TKV.scatter_blocks(tpool, torch.tensor(dst),
                       {n: saved[n][:, :, dst] for n in saved})
    for n in arrays:
        assert torch.equal(tpool[n], saved[n])


# -- construction gates ------------------------------------------------------

def test_spill_requires_chunked_prefill_and_budget():
    assert _engine(host_kv_bytes=None).kv_spill is None
    assert _engine(host_kv_bytes=0).kv_spill is None
    # No chunk machinery to ride: the spill tier stands down (warned).
    assert _engine(prefill_chunk_tokens=None).kv_spill is None
    # No prefix cache to spill from.
    assert _engine(enable_prefix_cache=False).kv_spill is None
    eng = _engine()
    assert eng.kv_spill is not None
    assert eng.kv_spill.budget_bytes == 64 * 1024 * 1024
    assert eng._spill_block_bytes == TKV.pool_block_bytes(
        eng.cfg, 16, "none")


# -- demote -> promote lifecycle ----------------------------------------------

def test_demote_on_eviction_then_promote_byte_identical():
    """park -> evict (demote) -> hit (promote): outputs identical to a
    spill-less engine, blocks conserved, the copies under JAX's keys."""
    ref = _cold_reference([PROMPT, TURN2])
    eng = _engine()
    try:
        r1 = eng.generate(PROMPT)
        assert r1.token_ids == ref[0]
        _demote_parked(eng)
        ss = eng.kv_spill.stats()
        assert ss["demotions_total"] == 1
        assert ss["resident_entries"] == 1 and ss["blocks"] > 0
        assert ss["bytes"] == ss["blocks"] * eng._spill_block_bytes
        entry = eng.kv_spill._entries[0]
        assert entry.tiles["k"].shape[0] == entry.nb   # block-major
        r2 = eng.generate(TURN2)
        assert r2.token_ids == ref[1]
        ss = eng.kv_spill.stats()
        assert ss["promotions_total"] == 1
        assert ss["promotion_races_total"] == 0
        assert ss["pinned_entries"] == 0      # promotion unpinned
        spill_keys = eng.tick_stats()["compiled"]["spill"]
        assert ("gather", entry.nb) in spill_keys
        assert any(k[0] == "write" for k in spill_keys)
    finally:
        eng.stop()
    assert eng.allocator.available == eng.paged.num_blocks - 1


def test_shared_refcount_blocks_never_demote():
    """Demotion is refcount-1-only: freeing a shared block is a decref
    (the data stays resident elsewhere), so the eviction falls through to
    the plain free."""
    eng = _engine()
    try:
        eng.generate(PROMPT)
        entry = eng.prefix_cache._entries[0]
        blocks = entry.cache["blocks"]
        eng.allocator.share(blocks)           # a second holder appears
        assert eng.prefix_cache.pop_oldest() is not None
        assert eng.kv_spill.stats()["entries"] == 0
        assert all(r == 1 for r in eng.allocator.refcounts(blocks))
        eng.allocator.free(blocks)
    finally:
        eng.stop()


def test_budget_too_small_skips_demotion():
    eng = _engine(host_kv_bytes=1)            # can't hold any entry
    try:
        eng.generate(PROMPT)
        free0 = eng.allocator.available
        assert eng.prefix_cache.pop_oldest() is not None
        assert eng.kv_spill.stats()["entries"] == 0
        assert eng.allocator.available > free0   # plain free happened
    finally:
        eng.stop()


def test_failed_reservation_destroys_nothing():
    """A refused offer destroys nothing: both kill sets (the twin and the
    LRU victims) are planned before anything is touched."""
    spill = HostKVSpill(budget_bytes=TILE_BYTES * 2,
                        block_bytes=TILE_BYTES // 2, min_prefix=4, tier="t")
    try:
        assert spill.offer(tuple(range(8)), _tiles(), TILE_BYTES, nb=2)
        assert spill.offer(tuple(range(100, 108)), _tiles(), TILE_BYTES,
                           nb=2)
        assert spill.flush(10)
        pinned = spill.claim(tuple(range(100, 110)))
        assert pinned is not None
        # A longer twin of the first entry, too big to fit: its twin kill
        # frees TILE_BYTES and the only other entry is pinned.
        assert not spill.offer(tuple(range(12)), _tiles(4),
                               TILE_BYTES * 2, nb=4)
        st = spill.stats()
        assert st["entries"] == 2 and st["demotions_dropped"] == 1
        assert st["evictions_total"] == 0
        still = spill.claim(tuple(range(10)))
        assert still is not None and still[1] == 8
        spill.release(still[0], promoted=True)
        spill.release(pinned[0], promoted=True)
    finally:
        spill.stop()


# -- the race matrix ---------------------------------------------------------

def test_hit_during_demotion_waits_out_the_copier():
    """A prompt hitting an entry whose demote copy is still in flight
    claims it anyway; the promotion stalls until the copier lands, then
    completes identically (no race, no cold fallback)."""
    ref = _cold_reference([PROMPT, TURN2])
    eng = _engine()
    try:
        assert eng.generate(PROMPT).token_ids == ref[0]
        eng.kv_spill.pause()
        assert eng.prefix_cache.pop_oldest() is not None
        assert eng.kv_spill.stats()["copying_entries"] == 1
        req = eng.submit(TURN2)
        _wait_host_hit(eng)
        assert eng.kv_spill.stats()["host_hits"] == 1
        assert not req.done.is_set()          # the promotion is waiting
        assert eng.kv_stats()["demote_inflight"] == 1
        eng.kv_spill.resume()
        assert req.done.wait(timeout=60) and req.error is None
        assert req.result.token_ids == ref[1]
        ss = eng.kv_spill.stats()
        assert ss["promotions_total"] == 1
        assert ss["promotion_races_total"] == 0
    finally:
        eng.kv_spill.resume()
        eng.stop()


def test_promotion_race_falls_back_to_cold_prefill_byte_identical():
    """Entry invalidated mid-promotion (a concurrent clear): the claimed
    entry goes DEAD, the promotion aborts, the prefill restarts COLD:
    identical output, the race counted, nothing pinned or leaked."""
    ref = _cold_reference([PROMPT, TURN2])
    eng = _engine()
    try:
        assert eng.generate(PROMPT).token_ids == ref[0]
        eng.kv_spill.pause()                  # hold the entry in COPYING
        assert eng.prefix_cache.pop_oldest() is not None
        req = eng.submit(TURN2)
        _wait_host_hit(eng)
        eng.kv_spill.clear()                  # the race: the entry dies
        eng.kv_spill.resume()
        assert req.done.wait(timeout=60) and req.error is None
        assert req.result.token_ids == ref[1]
        ss = eng.kv_spill.stats()
        assert ss["promotion_races_total"] == 1
        assert ss["promotions_total"] == 0
        assert ss["pinned_entries"] == 0
    finally:
        eng.kv_spill.resume()
        eng.stop()
    assert eng.allocator.available == eng.paged.num_blocks - 1


def test_failed_copy_raises_never_a_cold_prefill():
    """A demote copy that fails marks its entry DEAD with the error; the
    promotion that claimed it fails its request with that error instead
    of quietly prefilling cold, and counts no race."""
    eng = _engine()
    try:
        eng.generate(PROMPT)
        eng.kv_spill.pause()
        assert eng.prefix_cache.pop_oldest() is not None
        req = eng.submit(TURN2)
        _wait_host_hit(eng)

        def broken(snapshot):
            raise OSError("pinned allocation failed")

        eng.kv_spill._to_host = broken
        eng.kv_spill.resume()
        assert req.done.wait(timeout=60)
        assert isinstance(req.error, RuntimeError)
        assert "pinned allocation failed" in str(req.error)
        ss = eng.kv_spill.stats()
        assert ss["promotion_races_total"] == 0
        assert ss["promotions_total"] == 0 and ss["pinned_entries"] == 0
        assert ss["demotions_dropped"] == 1
    finally:
        eng.kv_spill.resume()
        eng.stop()
    assert eng.allocator.available == eng.paged.num_blocks - 1


def test_stop_mid_promotion_releases_pin_and_fails_with_shape():
    """Promotion vs a concurrent engine stop: the cancel path drops the
    pin and the request fails with the engine-stopped error shape (or
    legally raced to completion)."""
    eng = _engine()
    try:
        eng.generate(PROMPT)
        eng.kv_spill.pause()
        assert eng.prefix_cache.pop_oldest() is not None
        req = eng.submit(TURN2)
        _wait_host_hit(eng)
    finally:
        eng.kv_spill.resume()
        eng.stop()
    assert req.done.wait(timeout=10)
    if req.error is not None:                 # raced completion is legal
        assert isinstance(req.error, TB.EngineStoppedError)
        assert "error" in req.error.shape
    assert eng.kv_spill.stats()["pinned_entries"] == 0
    assert eng.allocator.available == eng.paged.num_blocks - 1


def test_host_lru_never_evicts_entry_with_promotion_in_flight():
    """Store-level pin contract: budget pressure evicts unpinned LRU
    entries only; an offer that could fit only by dropping a pinned entry
    is refused."""
    spill = HostKVSpill(budget_bytes=TILE_BYTES, block_bytes=TILE_BYTES // 2,
                        min_prefix=4, tier="t")
    try:
        assert spill.offer(tuple(range(8)), _tiles(), TILE_BYTES, nb=2)
        assert spill.flush(10)
        claimed = spill.claim(tuple(range(10)))
        assert claimed is not None
        entry, m = claimed
        assert m == 8 and entry.pins == 1
        assert not spill.offer(tuple(range(100, 108)), _tiles(), TILE_BYTES,
                               nb=2)
        assert spill.stats()["entries"] == 1
        assert spill.entry_state(entry) == RESIDENT
        spill.release(entry, promoted=True)
        # Unpinned now: the same offer evicts it and lands.
        assert spill.offer(tuple(range(100, 108)), _tiles(), TILE_BYTES,
                           nb=2)
        assert spill.flush(10)
        st = spill.stats()
        assert st["entries"] == 1 and st["evictions_total"] == 1
        assert spill.entry_state(entry) == DEAD
    finally:
        spill.stop()


def test_offer_replaces_entries_the_new_one_extends():
    """The device cache's put()-replace rule, host-side: a demotion whose
    ids extend (or duplicate) a host entry supersedes it; pinned entries
    survive (a promotion is reading their tiles)."""
    spill = HostKVSpill(budget_bytes=TILE_BYTES * 8,
                        block_bytes=TILE_BYTES // 2, min_prefix=4, tier="t")
    try:
        assert spill.offer(tuple(range(8)), _tiles(), TILE_BYTES, nb=2)
        assert spill.flush(10)
        assert spill.offer(tuple(range(12)), _tiles(), TILE_BYTES, nb=2)
        assert spill.flush(10)
        st = spill.stats()
        assert st["entries"] == 1 and st["bytes"] == TILE_BYTES
        claimed = spill.claim(tuple(range(14)))
        assert claimed is not None and claimed[1] == 12   # the longer one
        entry, _ = claimed
        assert spill.offer(tuple(range(12)), _tiles(), TILE_BYTES, nb=2)
        assert spill.flush(10)
        assert spill.entry_state(entry) == RESIDENT
        assert spill.stats()["entries"] == 2
        spill.release(entry, promoted=True)
    finally:
        spill.stop()


def test_stop_waits_out_inflight_copies():
    """An engine stop issued while a demote copy is queued blocks until
    the copy lands (bounded): the host tier is consistent at rest."""
    eng = _engine()
    eng.generate(PROMPT)
    eng.kv_spill.pause()
    assert eng.prefix_cache.pop_oldest() is not None
    assert eng.kv_spill.pending() >= 1
    assert eng.kv_spill.entry_state(eng.kv_spill._entries[0]) == COPYING
    box = {}

    def stopper():
        eng.stop()
        box["stopped_at"] = time.monotonic()

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    time.sleep(0.25)
    assert "stopped_at" not in box            # blocked in the flush
    eng.kv_spill.resume()
    t.join(timeout=30)
    assert "stopped_at" in box
    assert eng.kv_spill.stats()["demotions_total"] == 1
    assert not eng.kv_spill._copier.is_alive()


def test_demotion_during_take_is_structurally_impossible():
    """take/share and demotion cannot cross: eviction removes the entry
    under the cache lock BEFORE on_evict runs.  A taken entry's blocks
    are the taker's, and the following eviction sweep demotes nothing."""
    eng = _engine()
    try:
        eng.generate(PROMPT)
        ids, _ = prepare_prompt(eng.tokenizer, TURN2,
                                eng.tier.prefill_buckets,
                                eng.cfg.max_seq_len, eng.tier.max_new_tokens)
        entry, m = eng.prefix_cache.take(ids)
        assert entry is not None and m > 0
        assert eng.prefix_cache.pop_oldest() is None   # the cache is empty
        assert eng.kv_spill.stats()["entries"] == 0
        eng.prefix_cache.untake(entry, m)     # restore for cleanup
    finally:
        eng.stop()


@pytest.mark.parametrize("path", ["put", "untake", "pop_oldest", "clear"])
def test_prefix_cache_fires_on_evict_on_every_drop(path):
    """Every way an entry leaves the device cache reaches ``on_evict``
    (the spill tier's demote hook): a put that replaces or overflows, an
    untake past capacity, ``pop_oldest`` and ``clear``."""
    dropped = []
    cache = PrefixCache(capacity=1, on_evict=dropped.append)
    assert cache.put(tuple(range(6)), {"blocks": [1]})
    if path == "put":
        cache.put(tuple(range(100, 106)), {"blocks": [2]})   # overflow
        cache.put(tuple(range(100, 108)), {"blocks": [3]})   # extends
        assert [e.cache["blocks"] for e in dropped] == [[1], [2]]
        return
    if path == "untake":
        entry, m = cache.take(tuple(range(8)))
        cache.put(tuple(range(200, 206)), {"blocks": [4]})
        cache.untake(entry, m)                # back past capacity
        assert [e.cache["blocks"] for e in dropped] == [[4]]
        return
    if path == "pop_oldest":
        assert cache.pop_oldest() is dropped[0]
    else:
        cache.clear()
    assert [e.cache["blocks"] for e in dropped] == [[1]]


# -- integration: churn, stats, parity ---------------------------------------

NAMES = ("alpha", "bravo", "charlie", "delta")
CHURN = [f"{NAMES[i]} asks about the rivers and lakes of region {i}"
         for i in range(4)]
REVISITS = [p + " tell me more" for p in CHURN]


def test_session_churn_byte_identical_and_warm_hit_rate_improves():
    """A session population larger than the device cache, revisited:
    outputs identical with the spill ON and OFF, and ON converts
    revisits the device tier lost into promotions."""
    def run(host_bytes, share=True):
        eng = _engine(host_kv_bytes=host_bytes, prefix_cache_entries=1,
                      max_new_tokens=4, share_prefix_kv=share)
        try:
            out = [eng.generate(p).token_ids for p in CHURN]
            out += [eng.generate(p).token_ids for p in REVISITS]
            promoted = (eng.kv_spill.stats()["promotions_total"]
                        if eng.kv_spill is not None else 0)
            return out, promoted
        finally:
            eng.stop()

    off, promoted_off = run(None)
    on, promoted_on = run(64 * 1024 * 1024)
    assert on == off
    assert promoted_off == 0
    assert promoted_on >= 2
    # Exclusive-take mode exercises the untake hand-back when the host
    # match outranks a short cross-session device hit: the same tokens.
    excl, promoted_excl = run(64 * 1024 * 1024, share=False)
    assert excl == off
    assert promoted_excl >= 2


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_session_churn_matches_jax(f32_weights, kv_quantize):
    """The JAX engine and the port on the same float32 weights over one
    session churn (each revisit's device entry evicted, demoted, then
    promoted back): the same tokens, and the same demote, promote and
    race counts, with the bf16-sized and the int8 pool."""
    kw = dict(prefix_cache_entries=1, max_new_tokens=4,
              kv_quantize=kv_quantize)
    jax_engine = JB.ContinuousBatchingEngine(_tier(jax_config, **kw),
                                             params=f32_weights[0])
    port = TB.ContinuousBatchingEngine(
        _tier(**kw), device="cpu", params=params_from_jax(
            torch_config.MODEL_PRESETS[PRESET], f32_weights[1]))
    try:
        got, want = [], []
        for p in CHURN + REVISITS:
            want.append(jax_engine.generate(p).token_ids)
            assert jax_engine.kv_spill.flush(10)
            got.append(port.generate(p).token_ids)
            assert port.kv_spill.flush(10)
        assert got == want
        keys = ("demotions_total", "promotions_total",
                "promotion_races_total", "entries", "blocks", "bytes")
        js, ts = jax_engine.kv_spill.stats(), port.kv_spill.stats()
        assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
        assert ts["promotions_total"] >= 2
    finally:
        jax_engine.stop()
        port.stop()
    assert port.allocator.available == port.paged.num_blocks - 1


def test_kv_stats_surface_and_sampler_gauges():
    """kv_stats carries the host tier's occupancy and the promotion
    backlog; the router's sampler fields mirror them to the
    dllm_kv_host_* gauges."""
    from distributed_llm_tpu_torch.obs import get_observability
    from distributed_llm_tpu_torch.obs.sampler import SystemStateSampler
    from distributed_llm_tpu_torch.serving.router import Router

    eng = _engine()
    try:
        eng.generate(PROMPT)
        _demote_parked(eng)
        st = eng.kv_stats()
        for key in ("host_entries", "host_blocks", "host_bytes",
                    "host_budget_bytes", "demotions_total",
                    "promotions_total", "promotion_races_total",
                    "demote_inflight", "promote_backlog_blocks"):
            assert key in st, key
        assert st["host_blocks"] > 0 and st["host_bytes"] > 0
        fields = Router._collect_engine_state(eng)
        assert fields["kv_host_blocks"] == st["host_blocks"]
        assert fields["kv_host_bytes"] == st["host_bytes"]
        assert fields["kv_promote_backlog"] == 0
        # Spill-less engines keep the plain kv_stats shape.
        off = _engine(host_kv_bytes=None)
        try:
            assert "host_blocks" not in off.kv_stats()
            assert "kv_host_blocks" not in Router._collect_engine_state(off)
        finally:
            off.stop()
        m = get_observability().m
        sampler = SystemStateSampler(
            lambda: {"nano": dict(fields, kv_promote_backlog=3)}, metrics=m)
        sampler.sample_once()
        assert (m.kv_host_blocks_g.labels("nano").value
                == float(st["host_blocks"]))
        assert (m.kv_host_bytes_g.labels("nano").value
                == float(st["host_bytes"]))
        assert m.kv_promote_backlog_g.labels("nano").value == 3.0
    finally:
        eng.stop()


def test_spill_counters_reach_the_metric_families():
    """A demotion, a promotion, a race and a preemption each add one to
    their ``dllm_*_total`` family for the tier."""
    from distributed_llm_tpu_torch.obs import get_observability

    m = get_observability().m
    tier = "spill_metrics"
    before = [fam.labels(tier).value for fam in (
        m.kv_demotions, m.kv_promotions, m.kv_promotion_races)]
    spill = HostKVSpill(budget_bytes=TILE_BYTES * 4,
                        block_bytes=TILE_BYTES // 2, min_prefix=4, tier=tier)
    try:
        assert spill.offer(tuple(range(8)), _tiles(), TILE_BYTES, nb=2)
        assert spill.flush(10)
        entry, _ = spill.claim(tuple(range(9)))
        spill.release(entry, promoted=True)
        entry, _ = spill.claim(tuple(range(9)))
        spill.release(entry, promoted=False, race=True)
    finally:
        spill.stop()
    after = [fam.labels(tier).value for fam in (
        m.kv_demotions, m.kv_promotions, m.kv_promotion_races)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
