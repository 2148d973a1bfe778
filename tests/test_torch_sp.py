"""Sequence parallelism in the port against the JAX package's, on the CPU.

Seeded numpy inputs go through JAX on its 8 virtual CPU devices and
through the port on repeated CPU slots (``["cpu"] * n``), compared in
float32:

- ``ring_attention`` against JAX's within 1e-5, causal and not, GQA
  groups 1 and 2, on an ('sp',) group of 4 and an sp x tp = 2 x 2 group
  (``head_axis``);
- ``sp_flash_decode`` against JAX's within 1e-5, with a position that
  leaves three of four pieces all masked, groups 1 and 2, sp and sp x
  tp; the masked row write of the sequence-split cache;
- the sequential engine against JAX's sp engine, greedy tokens
  identical: nano_test at sp=4 with one prompt inside a bucket and one
  past the largest bucket (a counter proves the ring ran, and the ladder
  reaches max_seq), orin_test at sp=2 x tp=2, sp with int8 weights, the
  cache held in sequence pieces and the prefix cache off;
- the carve's sp groups against JAX's meshes (shapes, device ids), the
  share-from-front branch included, and sp ignored on MoE and batched
  tiers with JAX's warning;
- ``tier_hbm_budget`` and ``cluster_hbm_budget`` on sp tiers against
  JAX's, key for key.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.inference import (
    InferenceEngine as JaxSequential)
from distributed_llm_tpu.parallel import ring_attention as JRA
from distributed_llm_tpu.parallel import sp_attention as JSP
from distributed_llm_tpu.parallel.mesh import (carve_tier_meshes as jax_carve,
                                               sp_tp_mesh as jax_sp_tp_mesh)
from distributed_llm_tpu.utils.hbm_budget import (
    cluster_hbm_budget as jax_cluster_budget, tier_hbm_budget as jax_budget)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import inference as TI
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.parallel import ring_attention as TRA
from distributed_llm_tpu_torch.parallel import sp_attention as TSP
from distributed_llm_tpu_torch.parallel.mesh import (DeviceGroup,
                                                     carve_tier_meshes,
                                                     sp_tp_mesh)
from distributed_llm_tpu_torch.utils.hbm_budget import (cluster_hbm_budget,
                                                        tier_hbm_budget)
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


TOL = 1e-5
LONG = ("user: " + "tell me about sequence parallel rings, "
        "the blocks they pass and the softmax they merge. " * 5)
SHORT = "user: short enough to fit one bucket"
DECODE = ("user: " + "the mesh routes tokens and the compiler fuses "
          "kernels. " * 6).strip()


def _jmesh(layout: str):
    if layout == "sp4":
        return jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    return jax_sp_tp_mesh(jax.devices(), 2, 2)


def _tgroup(layout: str) -> DeviceGroup:
    if layout == "sp4":
        return DeviceGroup(("cpu",) * 4, ("sp",), (4,))
    return sp_tp_mesh(["cpu"] * 4, 2, 2)


def _qkv(b, s, nq, nkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, nq, d), (b, s, nkv, d), (b, s, nkv, d)))


# -- the ring and the merge -----------------------------------------------------

@pytest.mark.parametrize("layout", ["sp4", "sp2xtp2"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(layout, groups, causal):
    q, k, v = _qkv(2, 32, 4, 4 // groups, 16, seed=groups + 2 * causal)
    head_axis = "tp" if layout == "sp2xtp2" else None
    want = JRA.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              _jmesh(layout), "sp", causal=causal,
                              head_axis=head_axis)
    got = TRA.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), _tgroup(layout), "sp",
                             causal=causal, head_axis=head_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("layout", ["sp4", "sp2xtp2"])
@pytest.mark.parametrize("groups", [1, 2])
def test_sp_flash_decode_matches_jax_with_masked_pieces(layout, groups):
    """pos 3 lies in the first of four pieces: the other three are all
    masked and must add nothing."""
    q, k, v = _qkv(2, 64, 4, 4 // groups, 16, seed=11 + groups)
    q = q[:, 0]
    pos = np.asarray([3, 50], np.int32)
    head_axis = "tp" if layout == "sp2xtp2" else None
    want = JSP.sp_flash_decode(_jmesh(layout), "sp", head_axis=head_axis)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = TSP.sp_flash_decode(_tgroup(layout), "sp", head_axis=head_axis)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # One piece's partials with every position masked: l == 0, o == 0.
    m, l, o = TSP._partials(torch.from_numpy(q), torch.from_numpy(k[:, 16:32]),
                            torch.from_numpy(v[:, 16:32]),
                            torch.tensor([3, 3]), offset=16)
    assert torch.all(l == 0) and torch.all(o == 0)


def test_write_rows_lands_in_the_owning_piece():
    pieces = [{"k": torch.zeros(1, 2, 4, 1, 2), "v": torch.zeros(1, 2, 4, 1, 2)}
              for _ in range(3)]
    k = torch.full((2, 1, 2), 7.0)
    TSP.write_rows(pieces, 0, torch.tensor([5, 11]), k, -k)
    whole = torch.cat([p["k"][0] for p in pieces], dim=1)        # [2, 12, 1, 2]
    assert whole[0, 5].eq(7).all() and whole[1, 11].eq(7).all()
    assert whole.ne(0).sum() == 4                                 # nothing else
    assert torch.cat([p["v"][0] for p in pieces], dim=1)[1, 11].eq(-7).all()
    assert TSP.sp_decode_attn(sp_tp_mesh(["cpu"] * 4, 4, 1),
                              torch_config.MODEL_PRESETS["nano_test"],
                              cache_len=250) is None        # 4 does not divide


# -- the engines ----------------------------------------------------------------

@pytest.fixture(scope="module")
def presets():
    """float32 copies of nano_test and orin_test in both packages with a
    seeded numpy tree each: {name: (port cfg, tree)}."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for base in ("nano_test", "orin_test"):
            name = f"{base}_sp_f32"
            for pkg in (jax_config, torch_config):
                mp.setitem(pkg.MODEL_PRESETS, name, dataclasses.replace(
                    pkg.MODEL_PRESETS[base], name=name, dtype="float32"))
            cfg = torch_config.MODEL_PRESETS[name]
            out[base] = (name, cfg, _tree(cfg, seed=5))
        yield out


def _pair(presets, base, sp, tp, **kw):
    """(JAX engine, port engine) at sp x tp over the same weights."""
    name, cfg, tree = presets[base]
    tier = dict(model_preset=name, max_new_tokens=8,
                prefill_buckets=(16, 32, 64), **kw)
    jtier = jax_config.TierConfig(name="t", **tier)
    ttier = torch_config.TierConfig(name="t", **tier)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    je = JaxSequential(jtier, seed=0, params=jparams,
                       mesh=jax_sp_tp_mesh(jax.devices(), sp, tp))
    te = TI.InferenceEngine(ttier, device="cpu",
                            params=params_from_jax(cfg, tree),
                            group=sp_tp_mesh(["cpu"] * 8, sp, tp))
    return je, te


@pytest.fixture
def ring_calls(monkeypatch):
    calls = []
    real = TI.ring
    monkeypatch.setattr(TI, "ring",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


def test_sp4_engine_matches_jax_inside_and_past_the_buckets(presets,
                                                            ring_calls):
    je, te = _pair(presets, "nano_test", 4, 1)
    assert te._buckets[-1] == te._max_seq == je._buckets[-1]
    assert te._buckets == je._buckets
    for prompt in (SHORT, LONG):
        del ring_calls[:]
        want = je.generate(prompt).token_ids
        got = te.generate(prompt).token_ids
        assert ring_calls, f"the ring did not run for {prompt!r}"
        assert got == want
        assert len(set(want)) > 1
    assert len(te.tokenizer.encode_history(LONG)) > 64   # past bucket 64


def test_sp2_tp2_engine_matches_jax(presets, ring_calls):
    je, te = _pair(presets, "orin_test", 2, 2)
    assert te.group.shape == {"sp": 2, "tp": 2} and te.model.tp == 2
    for prompt in (DECODE, LONG):
        assert te.generate(prompt).token_ids == je.generate(prompt).token_ids
    assert ring_calls


def test_sp_decode_cache_split_and_int8_weights_match_jax(presets):
    je, te = _pair(presets, "orin_test", 4, 1, quantize="int8")
    assert te._sp_shard and je._sp_shard
    assert te.prefix_cache is None and je.prefix_cache is None
    assert te.generate(DECODE).token_ids == je.generate(DECODE).token_ids
    (pieces,) = te._caches[256]                  # one head shard, 4 pieces
    cfg = presets["orin_test"][1]
    assert [tuple(p["k"].shape) for p in pieces] == [
        (cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.head_dim)] * 4


def test_sp_int8_kv_keeps_whole_cache_and_prefix_cache(presets):
    """An int8 cache is not split (JAX's gate): the ring still prefills,
    decode runs per head shard and the prefix cache stays on."""
    je, te = _pair(presets, "orin_test", 2, 1, kv_quantize="int8")
    assert not te._sp_shard and te.prefix_cache is not None
    assert te.generate(DECODE).token_ids == je.generate(DECODE).token_ids
    assert isinstance(te._caches[256][0], dict)


# -- the carve and the budget --------------------------------------------------

def _sp_clusters(pkg):
    two_d = pkg.ClusterConfig(
        nano=pkg.TierConfig(name="nano", model_preset="nano_test", tp=1),
        orin=pkg.TierConfig(name="orin", model_preset="orin_test", tp=2, sp=2))
    tiny = pkg.tiny_cluster()
    sp4 = dataclasses.replace(tiny, orin=dataclasses.replace(
        tiny.orin, tp=1, sp=4))
    ignored = pkg.ClusterConfig(
        nano=pkg.TierConfig(name="nano", model_preset="moe_test", sp=4),
        orin=pkg.TierConfig(name="orin", model_preset="orin_test", sp=4,
                            decode_batch=4))
    return [("two_d", two_d, 8), ("sp4_tiny", sp4, 8),
            ("shared_front", two_d, 1), ("short", sp4, 3),
            ("ignored", ignored, 8)]


@pytest.mark.parametrize("case", range(5))
def test_carve_sp_groups_match_jax(case, caplog):
    name, jc, n = _sp_clusters(jax_config)[case]
    _, tc, _ = _sp_clusters(torch_config)[case]
    want = jax_carve(jc, devices=jax.devices()[:n])
    with caplog.at_level("WARNING"):
        got = carve_tier_meshes(tc, devices=["cpu"] * n)
    assert set(got) == set(want)
    for tier, group in got.items():
        assert group.shape == dict(want[tier].shape), (name, tier)
        assert list(group.slots) == [d.id for d in want[tier].devices.flat]
    if name == "two_d":
        assert got["orin"].shape == {"sp": 2, "tp": 2}
        assert set(got["nano"].slots).isdisjoint(got["orin"].slots)
    if name == "ignored":
        assert caplog.text.count("ignored") >= 2
        assert all(g.sp == 1 for g in got.values())


JAX_KEYS = ("tier", "model", "chips", "quantize", "params_gb_per_chip",
            "kv_gb_per_chip", "total_gb_per_chip", "hbm_per_chip_gb", "fits",
            "headroom_gb")


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_sp_tier_budget_matches_jax(sp, kv_quantize):
    kw = dict(name="orin", model_preset="orin_8b", tp=1, sp=sp,
              quantize="none", decode_batch=1, kv_quantize=kv_quantize)
    got = tier_hbm_budget(torch_config.TierConfig(**kw))
    want = jax_budget(jax_config.TierConfig(**kw))
    assert {k: got[k] for k in JAX_KEYS} == want
    assert got["chips"] == sp
    if kv_quantize == "none":
        # The cache splits over sp (and parks nothing): a 1/sp share.
        flat = dict(kw, enable_prefix_cache=False)
        one = tier_hbm_budget(torch_config.TierConfig(**dict(flat, sp=1)))
        mine = tier_hbm_budget(torch_config.TierConfig(**flat))
        assert mine["kv_bytes"] * sp == one["kv_bytes"]
        if sp > 1:
            assert got["kv_bytes"] == mine["kv_bytes"]


@pytest.mark.parametrize("case", range(4))
def test_sp_cluster_budget_matches_jax(case):
    _, jc, n = _sp_clusters(jax_config)[case]
    _, tc, _ = _sp_clusters(torch_config)[case]
    want = jax_cluster_budget(jc, devices=jax.devices()[:n])
    got = cluster_hbm_budget(tc, devices=["cpu"] * n)
    assert {t: {k: b[k] for k in JAX_KEYS} for t, b in got.items()} == want
