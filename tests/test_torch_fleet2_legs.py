"""The bench's ``noisy`` and ``chaos2`` legs (``bench/elastic.py``) on the
CPU, against the root ``bench.py``'s ``noisy_neighbor_phase`` (:1047)
and ``chaos2_phase`` (:3052).

Each leg runs once, shortened (a 1 s load window; an 8 s ramp), and is
held to JAX's section keys, its hard invariants (quotas-off identity;
availability >= 0.99 with no cross-tier failover, rescued streams equal
to the uninterrupted greedy run, a warm promotion after the kill) and to
``compact`` equal to root ``bench.py``'s.  ``compact`` is also held on a
synthetic result carrying all three new sections.  The ``elastic`` leg
runs in tests/test_torch_autoscaler.py.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)
from distributed_llm_tpu_torch.bench import elastic, headline  # noqa: E402

# bench.py:1085-1240.
NOISY_KEYS = {"load_s", "flood_quota", "outputs_identical", "solo", "off",
              "on", "quiet_p95_ratio", "flood_shed_precision"}
NOISY_MODE_KEYS = {"quiet_served", "flood_served", "quiet_p95_ms",
                   "flood_p95_ms", "tenant_rejected", "other_errors"}
# bench.py:3110-3264 (the sub-check's keys: fleet's port of :2951).
CHAOS2_KEYS = {"period_s", "arrivals", "scheduled_s", "hung_clients",
               "requests", "availability", "mttr_s",
               "p50_ttft_ms_under_kills", "kills", "rescue_mttr_ms",
               "failovers", "rescues", "spill_reattached_total",
               "monitor_restarts", "kill_errors", "subcheck",
               "outputs_identical", "warm_hit"}


def _compact_is_jaxs(section, out):
    want = jax_bench.compact({section: out})
    got = headline.compact({section: out})
    assert got.get(section) == want.get(section)
    assert got.get(section), section


def test_noisy_leg_keys_identity_and_compact():
    out = elastic.noisy_phase(load_s=1.0, device="cpu")
    assert "error" not in out, out.get("error")
    assert set(out) == NOISY_KEYS
    assert out["flood_quota"] == "max_inflight=1 max_queued=0 weight=0.25"
    for mode in ("solo", "off", "on"):
        assert set(out[mode]) - {"quiet_p95_ratio"} == NOISY_MODE_KEYS
        assert out[mode]["other_errors"] == {"quiet": 0, "flood": 0}
    assert out["outputs_identical"] is True
    assert out["solo"]["flood_served"] == 0
    # Quotas on: every tenant refusal lands on the flooder.
    assert out["on"]["tenant_rejected"]["quiet"] == 0
    assert out["on"]["tenant_rejected"]["flood"] > 0
    assert out["flood_shed_precision"] == 1.0
    assert out["off"]["tenant_rejected"] == {"quiet": 0, "flood": 0}
    _compact_is_jaxs("noisy", out)


def test_chaos2_leg_bars_and_compact():
    out = elastic.chaos2_phase(period_s=8.0, device="cpu")
    assert "error" not in out, out.get("error")
    assert set(out) - CHAOS2_KEYS == {"single_device"}
    assert out["availability"] >= 0.99 and out["failovers"] == 0
    assert out["hung_clients"] == 0 and out["kill_errors"] == []
    assert len(out["kills"]) == 2
    assert all(k["mttr_ms"] is not None for k in out["kills"])
    # The kills land at the ramp's busy fractions: the captured work was
    # rescued, and the counters (the router's registry) saw it.
    assert out["rescues"]["failed"] == 0
    assert out["rescues"]["sibling"] + out["rescues"]["requeue"] > 0
    assert sum(out["monitor_restarts"].values()) >= 2
    sub = out["subcheck"]
    assert sub["identical"] and sub["warm_hit"] and sub["spill_survived"]
    assert sub["outcome"] == "sibling" and sub["rescued"] == 1
    assert out["outputs_identical"] and out["warm_hit"]
    _compact_is_jaxs("chaos2", out)


def test_chaos2_leg_fails_on_a_failed_rescue(monkeypatch):
    """A rescue planted to count as failed must fail the leg on JAX's bar
    (the requests themselves still resume: availability and failover
    stay clean, so only the rescue counter can raise the error)."""
    from distributed_llm_tpu_torch.serving.replicas import \
        ReplicatedTierClient
    note = ReplicatedTierClient._note_rescue
    monkeypatch.setattr(ReplicatedTierClient, "_note_rescue",
                        lambda self, captured, outcome, by: note(
                            self, captured, "failed", by))
    monkeypatch.setattr(elastic, "_chaos2_rescue_subcheck",
                        lambda *a, **k: {"identical": True,
                                         "warm_hit": True})
    out = elastic.chaos2_phase(period_s=8.0, device="cpu")
    assert out["availability"] >= 0.99 and out["failovers"] == 0
    assert out["rescues"]["failed"] > 0
    assert out["rescues"]["sibling"] + out["rescues"]["requeue"] == 0
    assert out["error"] == (f"{out['rescues']['failed']} captured "
                            f"requests failed instead of resuming")


@pytest.mark.parametrize("variant", ["full", "errors", "skipped"])
def test_compact_of_the_new_sections_is_jaxs(variant):
    result = {
        "noisy": {"quiet_p95_ratio": 1.21, "flood_shed_precision": 0.97,
                  "off": {"quiet_p95_ratio": 5.9, "quiet_p95_ms": 2768.1},
                  "on": {"quiet_p95_ms": 668.6, "flood_served": 10},
                  "outputs_identical": True},
        "elastic": {"goodput_per_replica_s": 3.36, "gprs_vs_max": 1.32,
                    "goodput_vs_max": 1.0, "goodput_ok": True,
                    "gprs_ok": True, "scale_events": 1, "flap_count": 0,
                    "static_min": {"goodput_per_replica_s": 4.96},
                    "static_max": {"goodput_per_replica_s": 2.55},
                    "handoff": {"handed_off": 4},
                    "outputs_identical": True},
        "chaos2": {"availability": 1.0, "rescue_mttr_ms": 1241.8,
                   "failovers": 0, "rescues": {"sibling": 2, "requeue": 1,
                                               "failed": 0},
                   "outputs_identical": True, "warm_hit": True},
    }
    if variant == "errors":
        for sec in result.values():
            sec["error"] = "x" * 120
        result["chaos2"].pop("rescues")
    elif variant == "skipped":
        result = {k: {"skipped": "budget"} for k in result}
    assert headline.compact(result) == jax_bench.compact(result)
