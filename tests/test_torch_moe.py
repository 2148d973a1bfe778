"""MoE at ``ep = 1`` (``models/moe.py``) against the JAX package's.

- ``_top2_gates``, ``moe_ffn_train`` (capacity dispatch, drops included)
  and ``moe_ffn_decode`` on the same numpy inputs: outputs and the aux
  loss within 1e-5 relative, plain and with int8 experts
  (``expert_einsum``); ``quantize_params`` on a MoE layer bit-identical
  to JAX's (per-(expert, channel) scales, the router left alone) and
  ``params_from_jax`` of JAX's quantized MoE tree equal to it.
- ``prefill`` (with its aux), ``chunk_prefill`` and ``decode_step`` and
  the paged pool's three steps on a float32 ``moe_test``: logits within
  1e-4 of JAX's.
- The engines' greedy tokens are ``tests/test_torch_moe_engines.py``.
- ``check_ported`` takes ``moe_test`` and ``moe_8x1b`` at ``ep = 1`` and
  refuses ``ep > 1`` and ``tp != 1``; the memory budget of the MoE
  presets equals JAX's.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import paged_kv as JP
from distributed_llm_tpu.models import moe as JM
from distributed_llm_tpu.models import transformer as JT
from distributed_llm_tpu.ops import quant as JQ
from distributed_llm_tpu.utils.hbm_budget import (
    tier_hbm_budget as jax_budget)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch import models as TMODELS
from distributed_llm_tpu_torch.engine import paged_kv as TP
from distributed_llm_tpu_torch.models import moe as TM
from distributed_llm_tpu_torch.models import transformer as TT
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import quant as TQ
from distributed_llm_tpu_torch.utils.hbm_budget import tier_hbm_budget
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


PRESET = "moe_test_f32"
DRAFT = "draft_test_moe_f32"
REL = 1e-5
LOGITS_ATOL = 1e-4


def _moe_tree(cfg, seed=0, scale=0.2):
    """The dense test tree with the FFN replaced by a router [L, H, E]
    and E stacked experts."""
    tree = _tree(cfg, seed=seed, scale=scale)
    rng = np.random.default_rng(seed + 100)
    h, f, l, e = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, cfg.num_experts

    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    layers = dict(tree["layers"])
    layers.update(w_router=n(l, h, e), w_gate=n(l, e, h, f),
                  w_up=n(l, e, h, f), w_down=n(l, e, f, h))
    return {**tree, "layers": layers}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.fixture(scope="module")
def presets():
    """Float32 copies of moe_test and draft_test in both packages, and the
    MoE tree (numpy)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, base in ((PRESET, "moe_test"), (DRAFT, "draft_test")):
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32"))
        yield _moe_tree(torch_config.MODEL_PRESETS[PRESET])


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree["layers"].items()}


def _port_layer(cfg, tree, i=0):
    return params_from_jax(cfg, tree).layers[i]


# -- gates and the routed FFN -------------------------------------------------

def test_top2_gates_match_jax_with_near_ties():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    logits[::7, 3] = logits[::7, 5]           # exact ties: first occurrence
    logits[1::9, 2] = logits[1::9, 6] + 1e-7  # near ties
    jg, jp = JM._top2_gates(jnp.asarray(logits))
    tg, tp = TM._top2_gates(torch.from_numpy(logits))
    _close(tg, jg)
    _close(tp, jp)
    np.testing.assert_array_equal(_np(tg) > 0, _np(jg) > 0)
    assert ((_np(tg) > 0).sum(-1) == 2).all()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,s", [(1, 24), (4, 5)])
def test_moe_ffn_train_matches_jax(presets, int8, b, s):
    cfg = torch_config.MODEL_PRESETS[PRESET]
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    tree = presets
    jlp = {k: jnp.asarray(v) for k, v in _layer(tree).items()}
    lp = _port_layer(cfg, tree)
    if int8:
        jlp = JQ.quantize_params({"embed": jnp.zeros((4, 4)),
                                  "layers": jlp})["layers"]
        for key in TQ._QUANT_LAYER_KEYS:
            TQ.swap_in(lp, key, TQ.quantize_tensor(getattr(lp, key)))
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, cfg.hidden_size)).astype(np.float32)
    jo, jaux = JM.moe_ffn_train(jcfg, jlp, jnp.asarray(x))
    to, taux = lp.ffn(cfg, torch.from_numpy(x))
    _close(to, jo)
    _close(taux, jaux)
    # The capacity drops some tokens at these sizes: a dropped token's
    # output is zero for its expert in both.
    t = b * s
    assert TM.capacity(cfg, t) == max(1, int(1.25 * 2 * t / 4))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 8])
def test_moe_ffn_decode_matches_jax(presets, int8, rows):
    cfg = torch_config.MODEL_PRESETS[PRESET]
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    jlp = {k: jnp.asarray(v) for k, v in _layer(presets, 1).items()}
    lp = _port_layer(cfg, presets, 1)
    if int8:
        jlp = JQ.quantize_params({"embed": jnp.zeros((4, 4)),
                                  "layers": jlp})["layers"]
        for key in TQ._QUANT_LAYER_KEYS:
            TQ.swap_in(lp, key, TQ.quantize_tensor(getattr(lp, key)))
    x = np.random.default_rng(rows).standard_normal(
        (rows, cfg.hidden_size)).astype(np.float32)
    out, aux = lp.ffn(cfg, torch.from_numpy(x))
    assert aux is None
    _close(out, JM.moe_ffn_decode(jcfg, jlp, jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_moe_tree_matches_jax(presets, dtype):
    """The port's quantize_params on a MoE model gives JAX's q and s for
    every expert stack, keeps the router, and params_from_jax of JAX's
    quantized tree gives the same model."""
    name = f"moe_test_{dtype}_q"
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    with pytest.MonkeyPatch.context() as mp:
        for cfgmod in (jax_config, torch_config):
            mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                cfgmod.MODEL_PRESETS["moe_test"], name=name, dtype=dtype))
        cfg = torch_config.MODEL_PRESETS[name]
        jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), presets)
        rounded = jax.tree_util.tree_map(_np, jtree)
        jq = JQ.quantize_params(jtree)
        model = TQ.quantize_params(params_from_jax(cfg, rounded))
        from_jax = params_from_jax(cfg, jax.tree_util.tree_map(
            np.asarray, jq))
        assert not TQ.is_quantized(model.layers[0].w_router)
        for i in range(cfg.num_layers):
            for key in ("w_gate", "w_up", "w_down"):
                want = jq["layers"][key]
                for m in (model, from_jax):
                    got = getattr(m.layers[i], key)
                    assert tuple(got.s.shape) == (cfg.num_experts, 1,
                                                  want["s"].shape[-1])
                    np.testing.assert_array_equal(got.q.numpy(),
                                                  np.asarray(want["q"][i]))
                    np.testing.assert_array_equal(_np(got.s),
                                                  _np(want["s"][i]))


# -- the forward functions ------------------------------------------------------

def test_prefill_chunk_and_decode_match_jax(presets):
    cfg = torch_config.MODEL_PRESETS[PRESET]
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    jparams = jax.tree_util.tree_map(jnp.asarray, presets)
    model = params_from_jax(cfg, presets)
    assert TMODELS.model_module(cfg) is TM
    rng = np.random.default_rng(1)
    n = 20
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    positions = np.broadcast_to(np.arange(32)[None], (2, 32)).astype(np.int32)
    jh, (jk, jv), jaux = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                                    jnp.asarray(positions))
    th, (tk, tv), taux = TM.prefill(cfg, model, torch.from_numpy(toks).long(),
                                    torch.from_numpy(positions))
    np.testing.assert_allclose(_np(TT.logits_from_hidden(model, th)),
                               _np(JT.logits_from_hidden(jparams, jh)),
                               atol=LOGITS_ATOL, rtol=0)
    _close(taux, jaux)
    sh, skv = TMODELS.serving_prefill(cfg, model,
                                      torch.from_numpy(toks).long(),
                                      torch.from_numpy(positions))
    assert torch.equal(sh, th) and torch.equal(skv[0], tk)
    jcache = JT.seed_kv_cache(jcfg, jk[:, :1, :n], jv[:, :1, :n], 64)
    tcache = TT.seed_kv_cache(cfg, tk[:, :1, :n], tv[:, :1, :n], 64)
    chunk = rng.integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    true_len = n + 13
    jh, jcache = JM.chunk_prefill(jcfg, jparams, jnp.asarray(chunk),
                                  jnp.asarray([n], jnp.int32),
                                  jnp.asarray([true_len], jnp.int32), jcache,
                                  window=48)
    th = TM.chunk_prefill(cfg, model, torch.from_numpy(chunk).long(),
                          torch.tensor([n], dtype=torch.int32),
                          torch.tensor([true_len], dtype=torch.int32), tcache,
                          window=48)
    np.testing.assert_allclose(
        _np(TT.logits_from_hidden(model, th[:, :13])),
        _np(JT.logits_from_hidden(jparams, jh[:, :13])), atol=LOGITS_ATOL,
        rtol=0)
    cur, pos = np.asarray([7], np.int32), true_len
    for _ in range(3):
        jl, jcache = JM.decode_step(jcfg, jparams, jnp.asarray(cur),
                                    jnp.asarray([pos], jnp.int32), jcache)
        tl = TM.decode_step(cfg, model, torch.from_numpy(cur).long(),
                            torch.tensor([pos], dtype=torch.int32), tcache)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGITS_ATOL, rtol=0)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)
        pos += 1


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_paged_steps_match_jax(presets, kv_quantize):
    """chunk_prefill_paged and verify_step_paged (capacity dispatch over
    every slot's rows, idle slots included) and decode_step_paged (all
    experts) against JAX's MoE branches.  The int8 pool's bits may sit one
    quantization step apart (a stated difference), which the 0.2-scale
    test weights amplify past 1e-4 in the logits: the int8 pool runs
    JAX's own init (0.02 scale), as tests/test_torch_kv_int8.py does, and
    its pool is held within one step."""
    cfg = torch_config.MODEL_PRESETS[PRESET]
    jcfg = jax_config.MODEL_PRESETS[PRESET]
    tree = (presets if kv_quantize == "none" else jax.tree_util.tree_map(
        np.asarray, JM.init_params(jcfg, 0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree)
    pj = JP.PagedConfig(block_size=16, max_slots=3, max_seq_len=128)
    pt = TP.PagedConfig(block_size=16, max_slots=3, max_seq_len=128)
    jpool = JP.init_pool(jcfg, pj, kv_quantize)
    tpool = TP.init_pool(cfg, pt, kv_quantize)
    mb = pt.blocks_per_slot
    tables = np.zeros((3, mb), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]          # slot 2 idle: trash row
    rng = np.random.default_rng(5)
    for slot, n in ((0, 40), (1, 29)):
        toks = rng.integers(0, cfg.vocab_size, (1, 48)).astype(np.int32)
        jh, jpool = JP.chunk_prefill_paged(
            jcfg, jparams, jnp.asarray(toks), jnp.asarray([0], jnp.int32),
            jnp.asarray([n], jnp.int32), jpool, jnp.asarray(tables[slot]),
            64)
        th = TP.chunk_prefill_paged(
            cfg, model, torch.from_numpy(toks).long(),
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), tpool,
            torch.from_numpy(tables[slot]), 64)
        np.testing.assert_allclose(
            _np(TT.logits_from_hidden(model, th[:, :n])),
            _np(JT.logits_from_hidden(jparams, jh[:, :n])),
            atol=LOGITS_ATOL, rtol=0)
    pos = np.asarray([40, 29, 0], np.int32)
    cur = np.asarray([11, 12, 0], np.int32)
    for ragged in (True, False):
        jl, jpool = JP.decode_step_paged(jcfg, jparams, jnp.asarray(cur),
                                         jnp.asarray(pos), jpool,
                                         jnp.asarray(tables), ragged=ragged)
        tl = TP.decode_step_paged(cfg, model, torch.from_numpy(cur).long(),
                                  torch.from_numpy(pos), tpool,
                                  torch.from_numpy(tables), ragged=ragged)
        np.testing.assert_allclose(_np(tl[:2]), _np(jl[:2]),
                                   atol=LOGITS_ATOL, rtol=0)
    chunk = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    jl, jpool = JP.verify_step_paged(jcfg, jparams, jnp.asarray(chunk),
                                     jnp.asarray(pos), jpool,
                                     jnp.asarray(tables))
    tl = TP.verify_step_paged(cfg, model, torch.from_numpy(chunk).long(),
                              torch.from_numpy(pos), tpool,
                              torch.from_numpy(tables))
    np.testing.assert_allclose(_np(tl[:2]), _np(jl[:2]), atol=LOGITS_ATOL,
                               rtol=0)
    for name in tpool:
        np.testing.assert_allclose(
            _np(tpool[name][:, :, 1:]), _np(jpool[name][:, :, 1:]), rtol=0,
            atol=1 if name in ("k", "v") and kv_quantize == "int8" else 1e-5)


# -- config and budget ---------------------------------------------------------------

@pytest.mark.parametrize("preset", ["moe_test", "moe_8x1b"])
def test_check_ported_accepts_moe_at_ep_1(preset):
    tier = torch_config.TierConfig(name="m", model_preset=preset)
    tier.check_ported()
    assert tier.ep == 1
    cfg = tier.model()
    assert (cfg.moe_capacity_factor, cfg.moe_aux_weight) == (1.25, 0.01)


@pytest.mark.parametrize("field,value", [("ep", 2), ("ep", 4), ("tp", 2),
                                         ("tp", 4)])
def test_check_ported_refuses_multi_gpu(field, value):
    """moe_8x1b at ep or tp > 1 is accepted (it was refused until expert
    parallelism was ported): the carve over 8 slots gives it JAX's group,
    and its budget on that group is JAX's, key for key."""
    from distributed_llm_tpu.parallel.mesh import carve_tier_meshes as jcarve
    from distributed_llm_tpu_torch.parallel.mesh import carve_tier_meshes

    def cluster(pkg):
        return pkg.ClusterConfig(
            nano=pkg.TierConfig(name="nano", model_preset="nano_test"),
            orin=pkg.TierConfig(name="orin", model_preset="moe_8x1b",
                                **{field: value}))

    tier = cluster(torch_config).orin
    tier.check_ported()
    group = carve_tier_meshes(cluster(torch_config), devices=["cpu"] * 8)["orin"]
    mesh = jcarve(cluster(jax_config), devices=jax.devices())["orin"]
    assert group.shape == dict(mesh.shape)
    assert list(group.slots) == [d.id for d in mesh.devices.flat]
    assert getattr(group, field) == value
    got = tier_hbm_budget(tier, mesh=group)
    want = jax_budget(cluster(jax_config).orin, mesh=mesh)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("kw", [dict(decode_batch=8),
                                dict(decode_batch=1, kv_quantize="int8"),
                                dict(decode_batch=8, quantize="int8",
                                     kv_quantize="int8")])
@pytest.mark.parametrize("preset", ["moe_test", "moe_8x1b"])
def test_moe_budget_matches_jax(preset, kw):
    want = jax_budget(jax_config.TierConfig(name="m", model_preset=preset,
                                            **kw), hbm_per_chip_gb=80.0)
    got = tier_hbm_budget(torch_config.TierConfig(name="m",
                                                  model_preset=preset, **kw),
                          hbm_per_chip_gb=80.0)
    for key in ("params_gb_per_chip", "kv_gb_per_chip", "total_gb_per_chip",
                "fits"):
        assert got[key] == want[key], key
