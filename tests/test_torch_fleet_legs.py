"""The bench's fleet legs (bench/fleet.py) on the CPU, against the root
``bench.py``'s.

``_mttr_s`` equals JAX's on the same request timelines.  The chaos leg
runs on both packages' tiny batched clusters under JAX's schedule (one
strategy): the same keys, and the port's availability at or above JAX's.
The pressure, replica and perf-steering legs and the rescue sub-check
run small on the port alone: JAX's keys, their verdicts (the replay is
identical, the drain finishes its stragglers, one decode program per
replica and identical outputs across counts and policies, exploration
pays, the rescued stream equals the uninterrupted run and the demoted
prefix promotes warm after the restart).
"""

from __future__ import annotations

import pytest

import bench as jax_bench
from distributed_llm_tpu_torch.bench import fleet
from distributed_llm_tpu_torch.config import tiny_batched_cluster

TIMELINES = [
    [],
    [(0.0, True), (1.0, True)],
    [(0.0, True), (0.5, False), (0.7, False), (1.2, True), (2.0, False)],
    [(3.0, False), (1.0, True), (2.0, False), (4.0, True), (5.0, False),
     (6.5, False)],
]


@pytest.mark.parametrize("timeline", TIMELINES)
def test_mttr_matches_jax(timeline):
    assert fleet._mttr_s(timeline) == jax_bench._mttr_s(timeline)


STRATEGY_KEYS = {"requests", "availability", "mttr_s",
                 "p50_ttft_ms_under_faults", "errors", "hung_clients",
                 "breaker_opened", "degraded_served"}


def test_chaos_leg_matches_jax():
    got = fleet.chaos_phase(device="cpu", strategies=("heuristic",))
    want = jax_bench.chaos_phase(strategies=("heuristic",))
    assert set(got) - {"device"} == set(want)
    assert set(got["heuristic"]) == set(want["heuristic"]) == STRATEGY_KEYS
    st = got["heuristic"]
    assert st["requests"] > 0 and st["hung_clients"] == 0
    assert st["errors"] == 0
    assert st["availability"] >= want["heuristic"]["availability"]


def test_pressure_leg():
    out = fleet.pressure_phase(device="cpu", n_clients=2)
    assert out["replay_identity"] == {"preemptions": 1, "identical": True,
                                      "pool_freed": True}
    load = out["load"]
    assert set(load) == {"requests", "availability", "errors",
                         "hung_clients", "preemptions",
                         "kv_admission_rejected"}
    assert load["requests"] > 0 and load["hung_clients"] == 0
    assert load["availability"] == 1.0
    assert out["drain"] == {"in_flight": 2, "finished_ok": 2,
                            "mid_stream_kills": 0, "aborted": 0,
                            "post_drain_rejected": True}


def test_replica_leg():
    out = fleet.replica_phase(device="cpu", n_clients=2, n_requests=4,
                              k_sessions=2)
    assert "error" not in out, out.get("error")
    assert out["single_device"] is True and out["outputs_identical"]
    assert out["decode_programs_per_replica"] == {
        "r0": {"compiled": 1, "gauge": 1.0},
        "r1": {"compiled": 1, "gauge": 1.0}}
    assert {"r1", "r2", "closed_loop_speedup", "closed_loop_speedup_all",
            "speedup_ok", "sessions_r1", "sessions_affinity",
            "sessions_random", "affinity_hit_retention",
            "random_hit_retention", "dilution_resident_ratio",
            "attention_ragged"} <= set(out)
    assert out["affinity_hit_retention"] == 1.0
    assert out["sessions_r1"]["errors"] == 0


def test_perf_steering_leg():
    out = fleet.perf_steering_phase(device="cpu")
    verdict = out["verdict"]
    assert verdict["exploration_pays"] is True
    assert verdict["control_warmed_accuracy"] == 0.0
    assert set(out["explore"]) == {"cold", "warmed"}


def test_rescue_subcheck():
    cl = tiny_batched_cluster()
    out = fleet._chaos2_rescue_subcheck(cl, cl.nano, device="cpu")
    assert "error" not in out, out
    assert out["outcome"] == "sibling" and out["rescued"] == 1
    assert out["identical"] and out["spill_reattached"]
    assert out["spill_survived"] and out["warm_hit"]
    assert out["warm_identical"]
