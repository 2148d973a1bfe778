"""Paged KV pool of the port: the refcounted allocator's semantics (as
tests/test_batching.py and tests/test_shared_prefix.py pin them for the
JAX package) and the in-place pool writes against the JAX package's
functional ones (exact: they only move values)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu.config import MODEL_PRESETS as JAX_PRESETS
from distributed_llm_tpu.engine import paged_kv as JKV
from distributed_llm_tpu_torch.config import MODEL_PRESETS
from distributed_llm_tpu_torch.engine import paged_kv as TKV
from distributed_llm_tpu_torch.engine.paged_kv import (BlockAllocator,
                                                       PagedConfig,
                                                       TRASH_BLOCK)
from distributed_llm_tpu_torch.engine.prefix_cache import (PrefixCache,
                                                           select_reuse)


def test_allocator_never_hands_out_trash_block():
    alloc = BlockAllocator(num_blocks=5)
    got = alloc.alloc(4)
    assert TRASH_BLOCK not in got and sorted(got) == [1, 2, 3, 4]
    assert alloc.alloc(1) is None
    alloc.free(got[:2])
    assert alloc.available == 2


def test_paged_config_geometry_matches_jax():
    for kw in ({}, {"block_size": 16, "max_slots": 4, "max_seq_len": 256},
               {"block_size": 64, "max_slots": 8, "max_seq_len": 8192},
               {"block_size": 64, "max_slots": 3, "max_seq_len": 100}):
        ours, ref = PagedConfig(**kw), JKV.PagedConfig(**kw)
        assert (ours.blocks_per_slot, ours.num_blocks) == \
            (ref.blocks_per_slot, ref.num_blocks)


def test_refcount_alloc_share_free_invariants():
    a = BlockAllocator(8)
    got = a.alloc(3)
    assert a.available == 4
    assert all(a.refcount(b) == 1 for b in got)
    a.share(got)
    assert all(a.refcount(b) == 2 for b in got) and a.available == 4
    a.free(got)
    assert a.available == 4 and all(a.refcount(b) == 1 for b in got)
    a.free(got)
    assert a.available == 7 and all(a.refcount(b) == 0 for b in got)
    with pytest.raises(ValueError):
        a.free([got[0]])                     # double free
    with pytest.raises(ValueError):
        a.share([got[0]])                    # share of a freed block
    a.free([0])                              # trash block: always a no-op
    assert a.available == 7


def test_refcount_free_is_all_or_nothing_on_double_free():
    a = BlockAllocator(8)
    got = a.alloc(2)
    a.free([got[0]])
    with pytest.raises(ValueError):
        a.free([got[1], got[0]])
    assert a.refcount(got[1]) == 1
    a.free([got[1]])
    assert a.available == 7


def test_ref_stats_sharing_picture():
    a = BlockAllocator(8)
    got = a.alloc(2)
    a.share([got[0]])
    assert a.ref_stats() == {"allocated_blocks": 2, "total_refs": 3,
                             "shared_blocks": 1}
    assert a.refcounts(got + [7]) == [2, 1, 0]


def test_prefix_cache_share_unshare_and_reclaimable():
    alloc = BlockAllocator(16)
    cache = PrefixCache(capacity=2,
                        on_evict=lambda e: alloc.free(e.cache["blocks"]),
                        block_refcounts=alloc.refcounts)
    blocks = alloc.alloc(2)
    assert cache.put(tuple(range(10)), {"blocks": blocks})
    assert cache.reclaimable_blocks() == 2
    hit = select_reuse(cache, list(range(12)), (16, 32), 256, share=True)
    entry, m, suffix, sb = hit
    assert (m, suffix, sb) == (10, [10, 11], 16) and entry.pins == 1
    assert cache.reclaimable_blocks() == 0   # pinned entries never evict
    assert cache.pop_oldest() is None
    cache.unpin(entry)
    alloc.share(blocks[:1])                  # a live slot maps block 0
    assert cache.reclaimable_blocks() == 1
    assert cache.stats()["hits_shared"] == 1
    cache.clear()
    alloc.free(blocks[:1])
    assert alloc.ref_stats()["allocated_blocks"] == 0
    # Too short to park: ownership stays with the caller.
    assert not cache.put((1, 2), {"blocks": []})


def _cfgs():
    return (dataclasses.replace(JAX_PRESETS["nano_test"], dtype="float32"),
            dataclasses.replace(MODEL_PRESETS["nano_test"], dtype="float32"))


def test_write_prefill_blocks_and_copy_block_match_jax():
    jcfg, tcfg = _cfgs()
    bs = 16
    pcfg = dict(block_size=bs, max_slots=2, max_seq_len=64)
    jpool = JKV.init_pool(jcfg, JKV.PagedConfig(**pcfg))
    tpool = TKV.init_pool(tcfg, TKV.PagedConfig(**pcfg))
    assert tuple(tpool["k"].shape) == tuple(jpool["k"].shape)
    rng = np.random.default_rng(0)
    l, nkv, d = tcfg.num_layers, tcfg.num_kv_heads, tcfg.head_dim
    k_all = rng.standard_normal((l, 3 * bs, nkv, d)).astype(np.float32)
    v_all = rng.standard_normal((l, 3 * bs, nkv, d)).astype(np.float32)
    blocks = np.asarray([4, 1, 7], np.int32)
    jpool = JKV.write_prefill_blocks(jpool, jnp.asarray(blocks),
                                     jnp.asarray(k_all), jnp.asarray(v_all))
    out = TKV.write_prefill_blocks(tpool, torch.from_numpy(blocks).long(),
                                   torch.from_numpy(k_all),
                                   torch.from_numpy(v_all))
    assert out is tpool                      # written in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]))
    jpool = JKV.copy_block(jpool, jnp.int32(1), jnp.int32(6))
    TKV.copy_block(tpool, 1, 6)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name].numpy(),
                                      np.asarray(jpool[name]))
