"""The port's serving memory budget against the JAX package's.

``tier_hbm_budget`` builds the port's weights and its KV (the paged pool
of a batched tier, the contiguous cache and its parked copies of a
sequential one) on the ``meta`` device; the JAX package evaluates its
own with ``jax.eval_shape``.  For one-device tiers (``tp=1``) every key
of the JAX budget must be equal: nano_1b and orin_8b, bf16 and int8
weights, bf16 and int8 KV, ``decode_batch`` 1 and 4, and the tiny
presets.  On the tiny presets the
budget's bytes must also be the bytes of the tensors the port's engines
allocate.  A tier whose ``hbm_gb_per_chip`` is too small is refused by
the manager before any engine is built.
"""

from __future__ import annotations

import dataclasses

import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.utils.hbm_budget import (
    cluster_hbm_budget as jax_cluster_budget)
from distributed_llm_tpu.utils.hbm_budget import (
    tier_hbm_budget as jax_budget)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import ContinuousBatchingEngine
from distributed_llm_tpu_torch.engine.inference import InferenceEngine
from distributed_llm_tpu_torch.engine.manager import (EngineManager,
                                                      TierOverCapacityError)
from distributed_llm_tpu_torch.models import transformer
from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
from distributed_llm_tpu_torch.utils.hbm_budget import (cluster_hbm_budget,
                                                        model_bytes,
                                                        tensor_bytes,
                                                        tier_hbm_budget)

JAX_KEYS = ("tier", "model", "chips", "quantize", "params_gb_per_chip",
            "kv_gb_per_chip", "total_gb_per_chip", "hbm_per_chip_gb",
            "fits", "headroom_gb")


@pytest.mark.parametrize("decode_batch", [1, 4])
@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
@pytest.mark.parametrize("preset", ["nano_1b", "orin_8b", "nano_test",
                                    "orin_test"])
def test_budget_matches_jax(preset, kv_quantize, decode_batch):
    _budgets_equal(dict(name="t", model_preset=preset,
                        kv_quantize=kv_quantize, decode_batch=decode_batch))


@pytest.mark.parametrize("decode_batch", [1, 4])
@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
@pytest.mark.parametrize("preset", ["nano_1b", "orin_8b"])
def test_budget_with_int8_weights_matches_jax(preset, kv_quantize,
                                              decode_batch):
    _budgets_equal(dict(name="t", model_preset=preset, quantize="int8",
                        kv_quantize=kv_quantize, decode_batch=decode_batch))


def _budgets_equal(kw):
    for gb in (16.0, 80.0):
        want = jax_budget(jax_config.TierConfig(tp=1, **kw),
                          hbm_per_chip_gb=gb)
        got = tier_hbm_budget(torch_config.TierConfig(**kw),
                              hbm_per_chip_gb=gb)
        assert {k: got[k] for k in JAX_KEYS} == want
        assert got["params_bytes"] / 1e9 == pytest.approx(
            want["params_gb_per_chip"], abs=5e-4)


def test_prefix_cache_entries_count_on_a_sequential_tier():
    kw = dict(name="t", model_preset="orin_8b", prefix_cache_entries=3)
    for enable in (True, False):
        want = jax_budget(jax_config.TierConfig(
            tp=1, enable_prefix_cache=enable, **kw))
        got = tier_hbm_budget(torch_config.TierConfig(
            enable_prefix_cache=enable, **kw))
        assert {k: got[k] for k in JAX_KEYS} == want


def test_cluster_budget_matches_jax():
    jc = jax_config.tiny_batched_cluster()
    jc = dataclasses.replace(jc, orin=dataclasses.replace(jc.orin, tp=1))
    want = jax_cluster_budget(jc, hbm_per_chip_gb=1.0)
    got = cluster_hbm_budget(torch_config.tiny_batched_cluster(),
                             hbm_per_chip_gb=1.0)
    assert set(got) == set(want) == {"nano", "orin"}
    for name in got:
        assert {k: got[name][k] for k in JAX_KEYS} == want[name]


def _group(tier):
    """The group a tier asks for, on repeated CPU slots (None at tp=1)."""
    return tp_mesh(["cpu"] * tier.tp, tier.tp) if tier.tp > 1 else None


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_batched_budget_is_the_engines_tensors(kv_quantize):
    """The budget is one shard's tensors: the whole engine's at tp=1, the
    first shard's weights and pool on the tiny orin's tp=4 group."""
    for tier in torch_config.tiny_batched_cluster().tiers():
        tier = dataclasses.replace(tier, kv_quantize=kv_quantize)
        eng = ContinuousBatchingEngine(tier, device="cpu", group=_group(tier))
        try:
            budget = tier_hbm_budget(tier)
            if tier.tp > 1:
                assert budget["params_bytes"] == model_bytes(
                    eng.model.shards[0])
                assert budget["kv_bytes"] == tensor_bytes(
                    eng.pool[0].values())
            else:
                assert budget["params_bytes"] == tensor_bytes(
                    eng.model.parameters())
                assert budget["kv_bytes"] == tensor_bytes(eng.pool.values())
        finally:
            eng.stop()


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_sequential_budget_is_the_engines_tensors(kv_quantize):
    for tier in torch_config.tiny_cluster().tiers():
        tier = dataclasses.replace(tier, kv_quantize=kv_quantize)
        eng = InferenceEngine(tier, device="cpu", group=_group(tier))
        cfg = tier.model()
        cache = transformer.init_kv_cache(
            cfg, 1, cfg.max_seq_len, kv_quantize, device="cpu",
            kv_heads=cfg.num_kv_heads // tier.tp)
        budget = tier_hbm_budget(tier)
        assert budget["params_bytes"] == (
            model_bytes(eng.model.shards[0]) if tier.tp > 1
            else tensor_bytes(eng.model.parameters()))
        assert budget["kv_bytes"] == tensor_bytes(cache.values()) * (
            1 + tier.prefix_cache_entries)


def test_manager_refuses_a_tier_over_its_budget(monkeypatch):
    built = []
    monkeypatch.setattr(EngineManager, "_build",
                        lambda self, tier: built.append(tier))
    tier = torch_config.tiny_batched_cluster().orin
    need = tier_hbm_budget(tier)["total_gb_per_chip"]
    small = dataclasses.replace(tier, hbm_gb_per_chip=0.75 + need / 2)
    with pytest.raises(TierOverCapacityError, match="hbm_gb_per_chip"):
        EngineManager(small, device="cpu").start_server()
    assert built == []
    roomy = dataclasses.replace(tier, hbm_gb_per_chip=2.0)
    EngineManager(roomy, device="cpu", warmup_on_start=False).start_server()
    assert built == [roomy]


def test_budget_refuses_unported_sharding():
    """Expert parallelism is budgeted (no longer refused): ep=2 on the
    dense orin_8b is ignored and moe_8x1b at ep=2 splits its experts,
    key for key as the JAX budget on 8 devices; orin_8b at tp=4 is
    budgeted per shard, key for key as the JAX budget on its 4-device
    mesh."""
    for preset in ("orin_8b", "moe_8x1b"):
        got = tier_hbm_budget(torch_config.TierConfig(
            name="t", model_preset=preset, ep=2), devices=["cpu"] * 8)
        want = jax_budget(jax_config.TierConfig(
            name="t", model_preset=preset, ep=2), hbm_per_chip_gb=16.0)
        assert {k: got[k] for k in JAX_KEYS} == want
        assert got["chips"] == (2 if preset == "moe_8x1b" else 1)
    for quantize in ("none", "int8"):
        got = tier_hbm_budget(torch_config.TierConfig(
            name="t", model_preset="orin_8b", tp=4, quantize=quantize,
            decode_batch=4))
        want = jax_budget(jax_config.TierConfig(
            name="t", model_preset="orin_8b", tp=4, quantize=quantize,
            decode_batch=4), hbm_per_chip_gb=16.0)
        assert {k: got[k] for k in JAX_KEYS} == want
