"""Expert parallelism and MoE at tp > 1 in the port against JAX's, on the CPU.

Seeded numpy weights go through JAX on its 8 virtual CPU devices and
through the port on repeated CPU slots (``["cpu"] * 8``), in float32:

- ``shard_params`` of a MoE model against JAX's ``param_specs`` /
  ``quantized_param_specs``: each ('ep', 'tp') slot's expert slice
  equals the JAX stack split on the spec's 'ep' and 'tp' axes, exactly
  (values and int8 scales); replicated leaves are one tensor, and at
  tp = 1 the slices are views of the whole stack where every slot
  shares its device, copies beside slots on other devices;
- the sharded routed FFN (capacity dispatch and decode) against the
  unsharded one and JAX's, within 1e-5, and in bf16 at tp = 1 equal to
  the unsplit one bit for bit;
- both engines at ep=4, ep=2 x tp=2 and tp=2 against JAX's engines on
  the same groups, greedy tokens identical, with a prompt whose expert
  capacity drops tokens (counted) and a prefix hit; each slot's expert
  work runs under its own launch tally (``launches.on_shard``, nested
  tallies exclusive);
- the carve's ep groups against JAX's (shapes, device ids), the
  share-from-front branch included;
- ``tier_hbm_budget`` and ``cluster_hbm_budget`` of moe_8x1b at ep
  against JAX's, key for key.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxBatched)
from distributed_llm_tpu.engine.inference import (
    InferenceEngine as JaxSequential)
from distributed_llm_tpu.models import moe as JM
from distributed_llm_tpu.ops.quant import quantize_params as jax_quantize
from distributed_llm_tpu.parallel.mesh import (carve_tier_meshes as jax_carve,
                                               ep_tp_mesh as jax_ep_tp_mesh,
                                               tp_mesh as jax_tp_mesh)
from distributed_llm_tpu.parallel.sharding import (param_specs,
                                                   quantized_param_specs)
from distributed_llm_tpu.utils.hbm_budget import (
    cluster_hbm_budget as jax_cluster_budget, tier_hbm_budget as jax_budget)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching as TB
from distributed_llm_tpu_torch.engine import inference as TI
from distributed_llm_tpu_torch.models import moe as TM
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import launches, quant
from distributed_llm_tpu_torch.parallel import mesh as mesh_mod
from distributed_llm_tpu_torch.parallel.mesh import (carve_tier_meshes,
                                                     ep_tp_mesh, tp_mesh)
from distributed_llm_tpu_torch.parallel.sharding import (EXPERT_SPLIT,
                                                         shard_params)
from distributed_llm_tpu_torch.utils.hbm_budget import (cluster_hbm_budget,
                                                        tier_hbm_budget)
from test_torch_moe import _moe_tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


PRESET = "moe_test_ep_f32"
LAYOUTS = [(4, 1), (2, 2), (1, 2)]             # (ep, tp)
CPU8 = ["cpu"] * 8
PROMPTS = ["user: route me through the experts please",
           "user: " + "experts share the load when the router spreads "
           "tokens across them. " * 3]


@pytest.fixture(scope="module")
def tree():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jax_config, torch_config):
            mp.setitem(pkg.MODEL_PRESETS, PRESET, dataclasses.replace(
                pkg.MODEL_PRESETS["moe_test"], name=PRESET, dtype="float32"))
        yield _moe_tree(torch_config.MODEL_PRESETS[PRESET], seed=3)


def _cfg():
    return torch_config.MODEL_PRESETS[PRESET]


def _group(ep, tp):
    return ep_tp_mesh(CPU8, ep, tp) if ep > 1 else tp_mesh(CPU8, tp)


def _jmesh(ep, tp):
    return (jax_ep_tp_mesh(jax.devices(), ep, tp) if ep > 1
            else jax_tp_mesh(jax.devices(), tp))


# -- the split ----------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("ep,tp", LAYOUTS)
def test_expert_slices_follow_param_specs(tree, ep, tp, quantize):
    cfg = _cfg()
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    model = params_from_jax(cfg, tree)
    if quantize == "int8":
        model = quant.quantize_params(model)
        jtree = jax.tree_util.tree_map(
            np.asarray, jax_quantize(jax.tree_util.tree_map(jnp.asarray,
                                                            tree)))
        specs = quantized_param_specs(jcfg)["layers"]
    else:
        jtree, specs = tree, param_specs(jcfg)["layers"]
    sharded = shard_params(model, _group(ep, tp))
    assert sharded.tp == tp and sharded.group.ep == ep

    def expect(arr, spec, e, t):
        for axis, name in enumerate(spec):
            if name == "ep":
                arr = np.split(arr, ep, axis=axis)[e]
            elif name == "tp":
                arr = np.split(arr, tp, axis=axis)[t]
        return arr

    for t, shard in enumerate(sharded.shards):
        for i, layer in enumerate(shard.layers):
            assert layer.w_router is shard.layers[i].w_router
            assert [sl.slot for sl in layer.slices] == [
                e * tp + t for e in range(ep)]
            for e, sl in enumerate(layer.slices):
                assert sl.first == e * cfg.num_experts // ep
                for key in EXPERT_SPLIT:
                    got, spec = getattr(sl, key), specs[key]
                    if isinstance(spec, dict):
                        for part in ("q", "s"):
                            want = expect(jtree["layers"][key][part],
                                          spec[part], e, t)[i]
                            np.testing.assert_array_equal(
                                getattr(got, part).float().numpy(),
                                np.asarray(want, np.float32))
                    else:
                        np.testing.assert_array_equal(
                            got.numpy(), expect(jtree["layers"][key], spec,
                                                e, t)[i])
        assert shard.embed is sharded.shards[0].embed
    if tp == 1 and quantize == "none":
        # A block of whole experts is a view of the stack: no copy.
        whole = model.layers[0].w_gate
        sl = sharded.shards[0].layers[0].slices[1]
        assert sl.w_gate.untyped_storage().data_ptr() == \
            whole.untyped_storage().data_ptr()


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("ep,tp", LAYOUTS)
def test_lead_pieces_own_their_bytes_beside_other_cards(tree, ep, tp,
                                                        quantize,
                                                        monkeypatch):
    # The group's other slots lie on another device ('meta' stands in for
    # the other cards): the lead's pieces of a split leaf are copies, so
    # none keeps the whole stack (or the whole wo) alive on the lead.
    monkeypatch.setattr(mesh_mod, "resolve_device", torch.device)
    devs = ["cpu"] + ["meta"] * 7
    group = ep_tp_mesh(devs, ep, tp) if ep > 1 else tp_mesh(devs, tp)
    model = params_from_jax(_cfg(), tree)
    if quantize == "int8":
        model = quant.quantize_params(model)
    layer = shard_params(model, group).shards[0].layers[0]
    pieces = [layer.wo] + [getattr(layer.slices[0], k) for k in EXPERT_SPLIT]
    tensors = [t for p in pieces
               for t in ((p.q, p.s) if quant.is_quantized(p) else (p,))]
    for t in tensors:
        assert t.device.type == "cpu"
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    assert all(sl.device.type == "meta" for sl in layer.slices[1:])


@pytest.mark.parametrize("ep,tp", LAYOUTS)
def test_sharded_ffn_matches_unsharded_and_jax(tree, ep, tp):
    cfg = _cfg()
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    model = params_from_jax(cfg, tree)
    sharded = shard_params(model, _group(ep, tp))
    jlp = {k: jnp.asarray(v[0]) for k, v in tree["layers"].items()}
    rng = np.random.default_rng(ep * 10 + tp)
    x = rng.standard_normal((2, 16, cfg.hidden_size)).astype(np.float32)
    rows = x[:, 0]
    # The tensor shards' parts summed, as tp_layers sums them.
    seq = sum(TM.moe_ffn_train(cfg, s.layers[0], torch.from_numpy(x))[0]
              for s in sharded.shards)
    dec = sum(TM.moe_ffn_decode(cfg, s.layers[0], torch.from_numpy(rows))
              for s in sharded.shards)
    want_seq = np.asarray(JM.moe_ffn_train(jcfg, jlp, jnp.asarray(x))[0])
    want_dec = np.asarray(JM.moe_ffn_decode(jcfg, jlp, jnp.asarray(rows)))
    for got, want, whole in (
            (seq, want_seq, TM.moe_ffn_train(cfg, model.layers[0],
                                             torch.from_numpy(x))[0]),
            (dec, want_dec, TM.moe_ffn_decode(cfg, model.layers[0],
                                              torch.from_numpy(rows)))):
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
        assert float((got - whole).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("ep", [2, 4])
def test_bf16_expert_split_equals_the_unsplit_combine(ep):
    # In the model's dtype the unsplit combine is one einsum rounded once;
    # the split's float32 partials hold at most two nonzero terms a row,
    # so their sum rounds to the same bits.
    cfg = torch_config.MODEL_PRESETS["moe_test"]
    assert cfg.dtype == "bfloat16"
    model = params_from_jax(cfg, _moe_tree(cfg, seed=3))
    sharded = shard_params(model, ep_tp_mesh(CPU8, ep, 1))
    rng = np.random.default_rng(ep)
    x = torch.from_numpy(rng.standard_normal(
        (2, 64, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    whole, split = model.layers[0], sharded.shards[0].layers[0]
    assert torch.equal(TM.moe_ffn_train(cfg, whole, x)[0],
                       TM.moe_ffn_train(cfg, split, x)[0])
    assert torch.equal(TM.moe_ffn_decode(cfg, whole, x[:, 0]),
                       TM.moe_ffn_decode(cfg, split, x[:, 0]))


def test_nested_shard_tallies_are_exclusive():
    from distributed_llm_tpu_torch.ops import flash_attention as TF
    fn = TF.flash_causal_attention
    launches.reset_shards()
    before = fn.launches
    with launches.on_shard(0):
        fn.launches += 1
        with launches.on_shard(2):
            fn.launches += 2
        with launches.on_shard(0):
            fn.launches += 4
    fn.launches = before
    assert launches.shard_counts() == {0: {"flash_causal": 5},
                                       2: {"flash_causal": 2}}
    launches.reset_shards()


# -- the engines ----------------------------------------------------------------

@pytest.fixture
def drops(monkeypatch):
    """Tokens dropped past their expert's capacity, per capacity-dispatch
    call (counted on the replicated router, before the split)."""
    seen = []
    real = TM.moe_ffn_train

    def counting(cfg, lp, x):
        xt = x.reshape(-1, x.shape[-1])
        gates, _ = TM._top2_gates(quant.matmul(xt, lp.w_router))
        sel = (gates > 0).to(torch.int32)
        pos = torch.cumsum(sel, dim=0) * sel - 1
        seen.append(int(((sel > 0) & (pos >= TM.capacity(cfg, xt.shape[0])))
                        .sum()))
        return real(cfg, lp, x)

    monkeypatch.setattr(TM, "moe_ffn_train", counting)
    return seen


def _tiers(**kw):
    base = dict(model_preset=PRESET, max_new_tokens=8,
                prefill_buckets=(16, 32, 64), kv_block_size=16, **kw)
    return (jax_config.TierConfig(name="moe", **base),
            torch_config.TierConfig(name="moe", **base))


@pytest.mark.parametrize("ep,tp", LAYOUTS)
def test_sequential_engine_matches_jax(tree, drops, ep, tp):
    jtier, ttier = _tiers(ep=ep, tp=tp)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    je = JaxSequential(jtier, seed=0, params=jparams, mesh=_jmesh(ep, tp))
    te = TI.InferenceEngine(ttier, device="cpu",
                            params=params_from_jax(_cfg(), tree),
                            group=_group(ep, tp))
    assert te.group is not None and te.model.group.ep == ep
    launches.reset_shards()
    # The second prompt extends the first: a prefix hit's suffix chunk.
    for prompt in (PROMPTS[0], PROMPTS[0] + " and back", PROMPTS[1]):
        want = je.generate(prompt).token_ids
        assert te.generate(prompt).token_ids == want
        assert len(set(want)) > 1
    assert max(drops) > 0, "no prompt overflowed an expert's capacity"


@pytest.mark.parametrize("ep,tp", LAYOUTS)
def test_batched_engine_matches_jax(tree, drops, ep, tp):
    jtier, ttier = _tiers(ep=ep, tp=tp, decode_batch=4,
                          enable_prefix_cache=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    je = JaxBatched(jtier, seed=0, params=jparams, mesh=_jmesh(ep, tp))
    te = TB.ContinuousBatchingEngine(ttier, device="cpu",
                                     params=params_from_jax(_cfg(), tree),
                                     group=_group(ep, tp))
    assert te.ragged and te.tp == tp
    try:
        for prompt in PROMPTS:
            want = je.generate(prompt).token_ids
            assert te.generate(prompt).token_ids == want
    finally:
        je.stop()
        te.stop()
    assert max(drops) > 0


# -- the carve and the budget --------------------------------------------------

def _ep_clusters(pkg):
    nano = pkg.TierConfig(name="nano", model_preset="nano_test", tp=1)
    ep4 = pkg.ClusterConfig(nano=nano, orin=pkg.TierConfig(
        name="orin", model_preset="moe_test", ep=4))
    ep3 = pkg.ClusterConfig(nano=nano, orin=pkg.TierConfig(
        name="orin", model_preset="moe_test", ep=3))
    ep2tp2 = pkg.ClusterConfig(nano=nano, orin=pkg.TierConfig(
        name="orin", model_preset="moe_test", ep=2, tp=2))
    front = pkg.ClusterConfig(
        nano=pkg.TierConfig(name="nano", model_preset="nano_test", tp=2),
        orin=pkg.TierConfig(name="orin", model_preset="moe_test", ep=4))
    return [("ep4", ep4, 8), ("ep3_to_2", ep3, 8), ("ep2tp2", ep2tp2, 8),
            ("short", ep4, 3), ("shared_front", front, 2)]


@pytest.mark.parametrize("case", range(5))
def test_carve_ep_groups_match_jax(case):
    name, jc, n = _ep_clusters(jax_config)[case]
    _, tc, _ = _ep_clusters(torch_config)[case]
    want = jax_carve(jc, devices=jax.devices()[:n])
    got = carve_tier_meshes(tc, devices=CPU8[:n])
    for tier, group in got.items():
        assert group.shape == dict(want[tier].shape), (name, tier)
        assert list(group.slots) == [d.id for d in want[tier].devices.flat]
    if name == "ep3_to_2":
        assert got["orin"].ep == 2
    if name == "shared_front":
        assert got["orin"].shape == {"ep": 2, "tp": 1}
        assert got["orin"].slots == (0, 1)


JAX_KEYS = ("tier", "model", "chips", "quantize", "params_gb_per_chip",
            "kv_gb_per_chip", "total_gb_per_chip", "hbm_per_chip_gb", "fits",
            "headroom_gb")


@pytest.mark.parametrize("kw", [dict(ep=8), dict(ep=8, quantize="int8"),
                                dict(ep=2, tp=2, decode_batch=8),
                                dict(ep=4, decode_batch=1),
                                dict(tp=4, quantize="int8")])
def test_moe_ep_budget_matches_jax(kw):
    base = dict(name="moe", model_preset="moe_8x1b", max_new_tokens=64)
    got = tier_hbm_budget(torch_config.TierConfig(**base, **kw),
                          devices=CPU8)
    want = jax_budget(jax_config.TierConfig(**base, **kw))
    assert {k: got[k] for k in JAX_KEYS} == want
    assert got["chips"] == kw.get("tp", 1) * kw.get("ep", 1)


@pytest.mark.parametrize("case", range(5))
def test_ep_cluster_budget_matches_jax(case):
    _, jc, n = _ep_clusters(jax_config)[case]
    _, tc, _ = _ep_clusters(torch_config)[case]
    want = jax_cluster_budget(jc, devices=jax.devices()[:n])
    got = cluster_hbm_budget(tc, devices=CPU8[:n])
    assert {t: {k: b[k] for k in JAX_KEYS} for t, b in got.items()} == want


def test_cluster_budget_sees_what_earlier_tiers_left():
    """nano (tp=1) + moe_8x1b (ep=8) on 8 devices deploys ep=4: the
    deployed budget carries about twice the standalone expert bytes."""
    moe = dict(name="orin", model_preset="moe_8x1b", ep=8, max_new_tokens=16)
    got = cluster_hbm_budget(torch_config.ClusterConfig(
        nano=torch_config.TierConfig(name="nano", model_preset="nano_test"),
        orin=torch_config.TierConfig(**moe)), devices=CPU8)
    alone = tier_hbm_budget(torch_config.TierConfig(**moe), devices=CPU8)
    assert alone["chips"] == 8 and got["orin"]["chips"] == 4
    assert got["orin"]["params_gb_per_chip"] > 1.5 * alone["params_gb_per_chip"]
    assert got["nano"]["chips"] == 1


def test_batched_tp2_int8_pool_matches_jax(tree):
    """MoE at tp=2 over the int8 pool (K5 per head shard on the card)."""
    jtier, ttier = _tiers(tp=2, decode_batch=4, kv_quantize="int8",
                          enable_prefix_cache=False)
    je = JaxBatched(jtier, seed=0, params=jax.tree_util.tree_map(
        jnp.asarray, tree), mesh=_jmesh(1, 2))
    te = TB.ContinuousBatchingEngine(ttier, device="cpu",
                                     params=params_from_jax(_cfg(), tree),
                                     group=_group(1, 2))
    try:
        for prompt in PROMPTS:
            assert (te.generate(prompt).token_ids
                    == je.generate(prompt).token_ids)
    finally:
        je.stop()
        te.stop()


@pytest.mark.parametrize("kind", ["sp", "ep"])
def test_build_tiers_serves_on_the_2d_groups(kind):
    """``build_tiers`` hands each tier its carved 2-D group and the
    engine serves on it: orin_test at sp=2 x tp=2 (sequential), moe_test
    at ep=4 (batched)."""
    from distributed_llm_tpu_torch.serving.tiers import build_tiers
    nano = torch_config.TierConfig(name="nano", model_preset="nano_test",
                                   prefill_buckets=(16, 32, 64))
    orin = (torch_config.TierConfig(name="orin", model_preset="orin_test",
                                    sp=2, tp=2, max_new_tokens=4,
                                    prefill_buckets=(16, 32, 64))
            if kind == "sp" else
            torch_config.TierConfig(name="orin", model_preset="moe_test",
                                    ep=4, decode_batch=4, kv_block_size=16,
                                    max_new_tokens=4,
                                    prefill_buckets=(16, 32, 64)))
    tiers = build_tiers(torch_config.ClusterConfig(nano=nano, orin=orin),
                        devices=CPU8, warmup_on_start=False)
    manager = tiers["orin"].server_manager
    want = {"sp": 2, "tp": 2} if kind == "sp" else {"ep": 4, "tp": 1}
    assert manager.group.shape == want
    assert manager.group.slots[0] == 1          # nano claimed slot 0
    manager.start_server()
    try:
        engine = manager.engine()
        assert engine.group is manager.group
        assert engine.generate("user: hello there", max_new_tokens=3
                               ).gen_tokens <= 3
    finally:
        manager.stop_server()
