"""The port's ``parallel/`` modules against the JAX package's, on the CPU.

- ``carve_tier_meshes`` over ``["cpu"] * 8`` (repeated slots) against
  JAX's carve over its 8 virtual devices: the same group sizes, the same
  slot positions (JAX's device ids), the same shapes, on the cases of
  tests/test_parallel.py plus a replicated tier and a remote tier;
- ``shard_params`` against ``param_specs`` / ``quantized_param_specs``
  leaf by leaf: each shard's piece of each leaf equals the JAX leaf
  split on the spec's ``tp`` axis (a replicated leaf: the whole leaf),
  float32 and int8 (values, scales), tp 2 and 4, exactly;
- the collectives: ``allgather_health`` (round trip, row-count error),
  ``psum_scalar``, ``summarize_perf_window`` as JAX's, and
  ``allreduce_sum`` in shard order;
- ``check_ported``: dense ``tp > 1``, ``ep != 1`` and MoE at ``tp > 1``
  accepted (the port's ragged gate holds where JAX's keeps the dense
  windowed tick).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.ops.quant import quantize_params
from distributed_llm_tpu.parallel import collectives as JC
from distributed_llm_tpu.parallel.mesh import (
    carve_tier_meshes as jax_carve, tp_mesh as jax_tp_mesh)
from distributed_llm_tpu.parallel.sharding import (param_specs,
                                                   quantized_param_specs)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import quant
from distributed_llm_tpu_torch.parallel import collectives as TC
from distributed_llm_tpu_torch.parallel.mesh import (DeviceGroup,
                                                     carve_tier_meshes,
                                                     describe_meshes,
                                                     tp_mesh)
from distributed_llm_tpu_torch.parallel.sharding import (LAYER_SPLIT,
                                                         check_tp,
                                                         shard_params)
from test_torch_engine import _tree

CPU8 = ["cpu"] * 8


def _clusters(pkg):
    """(name, cluster, device count) of each carve case."""
    tiny = pkg.tiny_cluster()
    shrink = pkg.ClusterConfig(
        nano=pkg.TierConfig(name="nano", model_preset="nano_test", tp=1),
        orin=pkg.TierConfig(name="orin", model_preset="orin_test", tp=4))
    replicated = dataclasses.replace(tiny, orin=dataclasses.replace(
        tiny.orin, tp=2, replicas=2, decode_batch=2))
    remote = dataclasses.replace(tiny, nano=dataclasses.replace(
        tiny.nano, endpoint="http://127.0.0.1:5999/query"))
    return [("disjoint", tiny, 8), ("single_device", tiny, 1),
            ("shrinks_to_divisor", shrink, 4), ("replicated", replicated, 8),
            ("remote_claims_nothing", remote, 8)]


@pytest.mark.parametrize("case", range(5))
def test_carve_matches_jax(case):
    name, jc, n = _clusters(jax_config)[case]
    _, tc, _ = _clusters(torch_config)[case]
    want = jax_carve(jc, devices=jax.devices()[:n])
    got = carve_tier_meshes(tc, devices=CPU8[:n])
    assert set(got) == set(want), name
    for tier, group in got.items():
        mesh = want[tier]
        assert isinstance(group, DeviceGroup)
        assert group.shape == dict(mesh.shape), (name, tier)
        assert list(group.slots) == [d.id for d in mesh.devices.flat], (
            name, tier)
        assert group.devices == tuple(torch.device("cpu")
                                      for _ in group.slots)
    if name == "disjoint":
        assert set(got["nano"].slots).isdisjoint(got["orin"].slots)
        assert got["orin"].tp == 4
    if name == "replicated":
        assert got["orin"].shape == {"batch": 2, "tp": 2}
    assert describe_meshes(got).count("device(s)") == len(got)


def test_carve_on_one_device_keeps_tp1():
    """Without a group the tiny orin's tp=4 shrinks to the one device."""
    groups = carve_tier_meshes(torch_config.tiny_batched_cluster(),
                               device="cpu")
    assert {g.tp for g in groups.values()} == {1}


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_follows_param_specs(quantize, tp):
    jcfg = dataclasses.replace(jax_config.MODEL_PRESETS["orin_test"],
                               dtype="float32")
    tcfg = dataclasses.replace(torch_config.MODEL_PRESETS["orin_test"],
                               dtype="float32")
    tree = _tree(tcfg, seed=3)
    jtree = {"embed": jnp.asarray(tree["embed"]),
             "final_ln": jnp.asarray(tree["final_ln"]),
             "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()}}
    if quantize == "int8":
        jtree = quantize_params(jtree)
        specs = quantized_param_specs(jcfg)
    else:
        specs = param_specs(jcfg)
    np_tree = jax.tree.map(np.asarray, jtree)
    model = shard_params(params_from_jax(tcfg, np_tree),
                         tp_mesh(CPU8, tp))
    assert model.tp == tp and model.heads == (8 // tp, 4 // tp)

    def expect(arr, spec, s):
        """Shard s of a JAX leaf under its spec, the layer axis kept."""
        axes = [i for i, ax in enumerate(spec) if ax == "tp"]
        if not axes:
            return arr
        return np.split(arr, tp, axis=axes[0])[s]

    def port_leaf(w):
        if quant.is_quantized(w):
            return {"q": w.q.numpy(), "s": w.s.float().numpy()}
        return w.detach().float().numpy()

    for s, shard in enumerate(model.shards):
        for key, axis in LAYER_SPLIT.items():
            spec = specs["layers"][key]
            for layer in range(tcfg.num_layers):
                got = port_leaf(getattr(shard.layers[layer], key))
                src = np_tree["layers"][key]
                if isinstance(spec, dict):
                    for part in ("q", "s"):
                        want = expect(src[part], spec[part], s)[layer]
                        np.testing.assert_array_equal(
                            got[part], np.asarray(want, np.float32)
                            if part == "s" else want)
                else:
                    np.testing.assert_array_equal(
                        got, expect(src, spec, s)[layer])
        emb = port_leaf(shard.embed)
        if isinstance(emb, dict):
            np.testing.assert_array_equal(emb["q"], np_tree["embed"]["q"])
        else:
            np.testing.assert_array_equal(emb, np_tree["embed"])
        # Replicated leaves: one tensor shared by every shard on one device.
        assert shard.embed is model.shards[0].embed


def test_indivisible_heads_and_moe_refused():
    """Indivisible heads are refused; MoE at tp=2 is split (no longer
    refused) and only an ep that does not divide the experts is."""
    with pytest.raises(ValueError):
        check_tp(torch_config.MODEL_PRESETS["nano_test"], 4)  # 2 kv heads
    moe = torch_config.MODEL_PRESETS["moe_test"]                # 4 experts
    check_tp(moe, 2)
    check_tp(moe, 2, ep=2)
    with pytest.raises(ValueError, match="ep=3"):
        check_tp(moe, 1, ep=3)


# -- collectives -------------------------------------------------------------

def test_allgather_health_roundtrip_and_row_mismatch():
    rows = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    group = tp_mesh(CPU8, 8, axis_name="ici")
    np.testing.assert_allclose(TC.allgather_health(group, rows), rows)
    jmesh = jax_tp_mesh(jax.devices(), 8, axis_name="ici")
    np.testing.assert_allclose(TC.allgather_health(group, rows),
                               JC.allgather_health(jmesh, rows))
    with pytest.raises(ValueError, match="expected 4 rows"):
        TC.allgather_health(tp_mesh(CPU8, 4, axis_name="ici"),
                            np.zeros((3, 4), np.float32))


def test_psum_scalar_and_perf_window_match_jax():
    group = tp_mesh(CPU8, 8, axis_name="ici")
    vals = np.arange(8, dtype=np.float32)
    assert TC.psum_scalar(group, vals) == JC.psum_scalar(
        jax_tp_mesh(jax.devices(), 8, axis_name="ici"), vals) == 28.0
    samples = [(100.0, 10, True), (200.0, 0, False)]
    np.testing.assert_allclose(TC.summarize_perf_window(samples),
                               JC.summarize_perf_window(samples))
    assert TC.HEALTH_FIELDS == JC.HEALTH_FIELDS


def test_allreduce_sum_in_shard_order():
    """Shard order, in float32, one rounding to the partials' dtype."""
    parts = [torch.full((3,), 0.1 * (i + 1)) for i in range(4)]
    out = TC.allreduce_sum(parts, [torch.device("cpu")] * 4)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert torch.equal(out[0], want)
    bf = [p.to(torch.bfloat16) for p in parts]
    got = TC.allreduce_sum(bf, [torch.device("cpu")] * 2)[0]
    f32 = ((bf[0].float() + bf[1].float()) + bf[2].float()) + bf[3].float()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))


# -- config ------------------------------------------------------------------

@pytest.mark.parametrize("field,value,preset,ok", [
    ("tp", 4, "orin_8b", True), ("tp", 2, "nano_test", True),
    ("ep", 2, "moe_8x1b", False), ("ep", 2, "orin_8b", False),
    ("tp", 2, "moe_test", False), ("tp", 4, "moe_8x1b", False)])
def test_check_ported_tp_dense_only(field, value, preset, ok):
    """Every degree is accepted.  ``ok`` is JAX's ragged-tick gate on the
    group the carve deploys (a tp-only mesh over a dense model); the
    port's gate holds on all of them: its MoE and ep tiers keep the
    ragged tick (no GSPMD rule stands in its way)."""
    from distributed_llm_tpu.parallel.tp_attention import (
        _tp_ragged_ok as jax_gate)
    from distributed_llm_tpu_torch.parallel.tp_attention import _tp_ragged_ok

    tier = torch_config.TierConfig(name="t", model_preset=preset,
                                   **{field: value})
    tier.check_ported()
    jtier = jax_config.TierConfig(name="t", model_preset=preset,
                                  **{field: value})
    group = carve_tier_meshes(torch_config.ClusterConfig(
        nano=tier, orin=dataclasses.replace(tier, name="o")),
        devices=CPU8)["t"]
    mesh = jax_carve(jax_config.ClusterConfig(
        nano=jtier, orin=dataclasses.replace(jtier, name="o")),
        devices=jax.devices())["t"]
    assert group.shape == dict(mesh.shape)
    assert jax_gate(mesh, jtier.model()) is ok
    assert _tp_ragged_ok(group, tier.model())