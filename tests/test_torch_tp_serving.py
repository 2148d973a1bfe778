"""Tensor parallelism through the port's serving layer, on the CPU.

- ``Router``/``build_tiers`` over ``devices=["cpu"] * 8``: each tier on
  its carved group (the tiny orin at tp=4 on slots 1-4), the orin tier
  serving the same reply as on one device; a replicated tier's replicas
  each on a tp=2 row of its ('batch', 'tp') group;
- the health exchange: ``Router(config={"health_mesh": group})`` hands
  the group to the monitor, whose ``exchange_health`` all-gathers every
  tier's perf row and load row, equal to the JAX monitor's on a JAX mesh
  of the same width with the same samples;
- the memory budget per shard: ``flagship_cluster(5)`` budgeted over the
  carve of 8 slots equals JAX's ``cluster_hbm_budget`` on 8 devices key
  for key, and a tier whose budget refuses it at tp=1 starts at tp=2
  under the same per-device budget.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.routing.strategies import PerfStrategy as JaxPerf
from distributed_llm_tpu.serving.health import HealthMonitor as JaxMonitor
from distributed_llm_tpu.utils.hbm_budget import (
    cluster_hbm_budget as jax_cluster_budget)
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.config import BENCHMARK_CFG
from distributed_llm_tpu_torch.engine.manager import (EngineManager,
                                                      TierOverCapacityError)
from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
from distributed_llm_tpu_torch.routing.strategies import PerfStrategy
from distributed_llm_tpu_torch.serving.health import HealthMonitor
from distributed_llm_tpu_torch.serving.router import Router
from distributed_llm_tpu_torch.serving.tiers import build_tiers
from distributed_llm_tpu_torch.utils.hbm_budget import (cluster_hbm_budget,
                                                        tier_hbm_budget)

CPU8 = ["cpu"] * 8
JAX_KEYS = ("tier", "model", "chips", "quantize", "params_gb_per_chip",
            "kv_gb_per_chip", "total_gb_per_chip", "hbm_per_chip_gb",
            "fits", "headroom_gb")
PROMPT = "compare rivers and lakes in a few words"


def _reply(tiers):
    try:
        return tiers["orin"].process(PROMPT)["response"]
    finally:
        for t in tiers.values():
            t.server_manager.stop_server()


def test_build_tiers_carves_groups_and_orin_serves_at_tp4():
    cluster = torch_config.tiny_batched_cluster()
    tiers = build_tiers(cluster, devices=CPU8, warmup_on_start=False)
    orin = tiers["orin"].server_manager
    assert tiers["nano"].server_manager.group.tp == 1
    assert orin.group.tp == 4 and list(orin.group.slots) == [1, 2, 3, 4]
    engine = orin.engine()
    assert engine.tp == 4 and engine.ragged
    assert orin.health()["devices"] == ["cpu"] * 4
    sharded = _reply(tiers)
    one = _reply(build_tiers(cluster, device="cpu", warmup_on_start=False))
    assert sharded == one


def test_replicated_tier_gets_one_tp_row_per_replica():
    base = torch_config.tiny_batched_cluster()
    cluster = dataclasses.replace(base, orin=dataclasses.replace(
        base.orin, tp=2, replicas=2))
    tiers = build_tiers(cluster, devices=CPU8, warmup_on_start=False)
    try:
        mgrs = [r.mgr for r in tiers["orin"]._members]
        assert [m.group.tp for m in mgrs] == [2, 2]
        assert mgrs[0].engine().tp == 2
    finally:
        for t in tiers.values():
            t.server_manager.stop_server()


def _perf(cls, cfg):
    perf = cls(dict(cfg))
    for i in range(3):
        perf.samples["nano"].append((100.0 + i, 10 + i, i != 1))
    perf.samples["orin"].append((400.0, 40, True))
    return perf


def test_health_exchange_over_a_group_matches_jax():
    cfg = dict(BENCHMARK_CFG, perf_queue_aware=True)
    load = {"queue_depth": 2, "active_slots": 1, "max_slots": 4}
    tiers = {name: SimpleNamespace(load_snapshot=lambda: load)
             for name in ("nano", "orin")}
    port = SimpleNamespace(tiers=tiers, query_router=SimpleNamespace(
        router=_perf(PerfStrategy, cfg)))
    jx = SimpleNamespace(tiers=tiers, query_router=SimpleNamespace(
        router=_perf(JaxPerf, cfg)))
    got = HealthMonitor(port, mesh=tp_mesh(CPU8, 4)).exchange_health()
    want = JaxMonitor(jx, mesh=jax.sharding.Mesh(
        np.array(jax.devices()[:4]), ("tp",))).exchange_health()
    assert set(got) == set(want) == {"nano", "orin"}
    for name in got:
        assert got[name].shape == (4, 4)
        np.testing.assert_allclose(got[name], want[name])
    # Every row is this process's own: nothing folds, the remote load is 0.
    assert len(port.query_router.router.samples["nano"]) == 3
    assert port.query_router.router._remote_load["nano"] == (0.0, 0.0)


def test_router_health_mesh_runs_the_exchange():
    group = tp_mesh(CPU8, 2)
    router = Router(strategy="perf", benchmark_mode=True,
                    cluster=torch_config.tiny_batched_cluster(),
                    device="cpu", sample_ms=0,
                    config=dict(BENCHMARK_CFG, enable_health_monitor=True,
                                health_interval_s=60.0, health_mesh=group))
    try:
        monitor = router.health_monitor
        assert monitor.mesh is group
        out = monitor.exchange_health()
        assert set(out) == {"nano", "orin"}
        assert all(rows.shape == (2, 4) for rows in out.values())
    finally:
        router.drain(timeout_s=5)


def test_flagship_budget_per_shard_matches_jax():
    got = cluster_hbm_budget(torch_config.flagship_cluster(5), devices=CPU8,
                             hbm_per_chip_gb=80.0)
    want = jax_cluster_budget(jax_config.flagship_cluster(5),
                              devices=jax.devices()[:8],
                              hbm_per_chip_gb=80.0)
    assert got["orin"]["chips"] == 4
    for name in ("nano", "orin"):
        assert {k: got[name][k] for k in JAX_KEYS} == want[name]


def test_budget_refuses_tp1_and_fits_tp2():
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               tp=2)
    one = tier_hbm_budget(tier, mesh=tp_mesh(["cpu"], 1))
    two = tier_hbm_budget(tier, mesh=tp_mesh(CPU8, 2))
    assert (two["params_bytes"] + two["kv_bytes"]
            < one["params_bytes"] + one["kv_bytes"])
    budget = 0.75 + (one["params_bytes"] + one["kv_bytes"]
                     + two["params_bytes"] + two["kv_bytes"]) / 2e9
    tier = dataclasses.replace(tier, hbm_gb_per_chip=budget)
    with pytest.raises(TierOverCapacityError, match="hbm_gb_per_chip"):
        EngineManager(tier, device="cpu", warmup_on_start=False).start_server()
    mgr = EngineManager(tier, group=tp_mesh(CPU8, 2), warmup_on_start=False)
    mgr.start_server()
    try:
        assert mgr.engine().tp == 2
    finally:
        mgr.stop_server()


def test_multichip_section_skips_on_one_device_and_compacts_as_jax():
    """One slot: skipped, as JAX's leg on one chip; a result's compact
    entry is the root bench's."""
    import bench as jax_bench
    from distributed_llm_tpu_torch.bench import headline
    assert headline.multichip_phase(devices=["cpu"]) == {
        "skipped": "single_device"}
    result = {"metric": headline.METRIC, "value": 1.0, "multichip": {
        "tp_ratio": 0.9, "tp1": {"tok_per_s": 10.0},
        "tp2": {"tok_per_s": 9.0, "ragged": True, "decode_programs": 1},
        "capacity": {"tp1_refused": True, "tp2_served": True,
                     "hbm_gb_per_chip": 0.8},
        "spec_tok_ratio": 1.5, "outputs_identical": True}}
    assert headline.compact(result) == jax_bench.compact(result)
