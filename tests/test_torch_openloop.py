"""The port's open-loop leg (``bench/openloop.py``) against the JAX
package's (``distributed_llm_tpu/bench/openloop.py``).

- The constants are JAX's, and ``_find_knee`` equals JAX's on synthetic
  sweeps (a hypothesis test: attainments above, at and below the 0.9
  rule, missing ones, ties).
- One short rate point through the port's ``/chat`` edge (the tiny
  batched cluster on the CPU, Poisson arrivals on threads through the
  app's test client): JAX's ``_run_rate_point`` and the port's, each run
  against the port's app, give the same keys; every arrival is answered
  and none hangs.  No assertion is made on wall time.
- The whole leg at a small budget gives JAX's artifact keys and its
  ``compact`` entry equals ``bench.compact``'s.
"""

from __future__ import annotations

import os
import sys

import pytest
from hypothesis import given, settings, strategies as st

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)
from distributed_llm_tpu.bench import openloop as jax_ol  # noqa: E402
from distributed_llm_tpu_torch.bench import headline  # noqa: E402
from distributed_llm_tpu_torch.bench import openloop as ol  # noqa: E402

CONSTANTS = ("SWEEP_START_MULTIPLIER", "MAX_SWEEP_POINTS",
             "MAX_RATE_REQ_PER_S", "MAX_ARRIVALS_PER_POINT",
             "KNEE_ATTAINMENT", "OVERLOAD_FACTOR", "MIN_POINT_S",
             "MAX_POINT_S", "SESSION_POOL", "JOIN_GRACE_S")
# distributed_llm_tpu/bench/openloop.py:192-207 (+ :191 when a previous
# point's stragglers were still running).
POINT_KEYS = {"offered_req_per_s", "arrivals", "completed", "http_errors",
              "hung_clients", "availability", "goodput_req_per_s",
              "slo_attainment", "p50_ms", "p95_ms", "wall_s"}
# :262-268, :291, :301, :342-346, :364 (or :372 when skipped).
PHASE_KEYS = {"config", "slo", "session_pool", "knee_rule",
              "base_seq_req_per_s", "point_s", "per_strategy",
              "slo_attainment", "knee_req_per_s", "goodput_at_knee",
              "overload"}


def test_constants_are_jaxs():
    for name in CONSTANTS:
        assert getattr(ol, name) == getattr(jax_ol, name), name


_point = st.fixed_dictionaries({
    "offered_req_per_s": st.floats(0.1, 800.0, allow_nan=False),
    "goodput_req_per_s": st.one_of(st.none(), st.floats(0.0, 800.0,
                                                         allow_nan=False)),
    "slo_attainment": st.one_of(st.none(), st.sampled_from(
        [0.0, 0.5, 0.89, 0.9, 0.95, 1.0]), st.floats(0.0, 1.0)),
})


@settings(max_examples=200, deadline=None)
@given(st.lists(_point, max_size=9))
def test_find_knee_matches_jax(sweep):
    assert ol._find_knee(sweep) == jax_ol._find_knee(sweep)


@pytest.fixture(scope="module")
def served():
    """The tiny batched cluster behind the port's app on the CPU."""
    from distributed_llm_tpu_torch.config import tiny_batched_cluster
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.app import create_app
    from distributed_llm_tpu_torch.serving.router import Router
    from distributed_llm_tpu_torch.bench.query_sets import query_sets

    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=tiny_batched_cluster(), device="cpu",
                    observability=Observability(slow_ms=None))
    for tier in router.tiers.values():
        tier.server_manager.start_server()
    try:
        yield (create_app(router=router).test_client(), router,
               query_sets["general_knowledge"])
    finally:
        router.drain(timeout_s=10.0)


def test_rate_point_through_the_app(served):
    client, router, queries = served
    points = {}
    for name, mod in (("torch", ol), ("jax", jax_ol)):
        carry = []
        points[name] = mod._run_rate_point(
            client, router, queries, "heuristic", 4.0, 1.0,
            label=f"test-{name}", carry=carry)
        assert carry == []
    assert set(points["torch"]) == set(points["jax"]) == POINT_KEYS
    p = points["torch"]
    assert p["arrivals"] > 0 and p["completed"] == p["arrivals"]
    assert p["hung_clients"] == 0 and p["availability"] == 1.0
    assert p["http_errors"] == 0
    assert p["slo_attainment"] is not None


def test_openloop_phase_keys_and_compact(monkeypatch):
    """The whole leg, cut to two sweep points a strategy at half-second
    points (the constants are the sweep's depth, not its rule).  The
    calibration still runs, but the sweep starts from a pinned base rate:
    calibrated on a busy host, the first rates offer no arrival in a
    half-second window, and a sweep with no arrival has no knee and no
    overload epilogue.  Pinned, every point's arrivals are a function of
    its label and rate alone (the schedule's seed)."""
    monkeypatch.setattr(ol, "MAX_SWEEP_POINTS", 2)
    monkeypatch.setattr(ol, "MIN_POINT_S", 0.5)
    calibrate = ol._sequential_rate
    monkeypatch.setattr(ol, "_sequential_rate",
                        lambda *a, **k: (calibrate(*a, **k), 8.0)[1])
    out = ol.openloop_phase(strategies=("heuristic",), point_s=0.5,
                            device="cpu")
    assert set(out) == PHASE_KEYS
    sweep = out["per_strategy"]["heuristic"]["sweep"]
    assert 1 <= len(sweep) <= 2
    assert all(set(p) - {"prior_stragglers"} == POINT_KEYS for p in sweep)
    assert out["knee_req_per_s"] > 0
    ov = out["overload"]
    assert ov["offered_over_knee"] == ol.OVERLOAD_FACTOR
    assert {"incidents", "incidents_recorded",
            "incidents_with_timeline"} <= set(ov)
    assert ov["availability"] == 1.0 and ov["hung_clients"] == 0
    want = jax_bench.compact({"openloop": out})
    assert headline.compact({"openloop": out})["openloop"] == want["openloop"]
