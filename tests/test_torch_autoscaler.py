"""The SLO autoscaler and elastic replica membership in the port, against
the JAX package.

- ``ReplicaAutoscaler`` (serving/autoscaler.py): one scripted sequence of
  signals (queue depth, active slots, sheds, goodput, refused
  actuations) on an injected clock, ``tick()`` driven directly with no
  thread and no sleep: the port's decisions, ``scale_to`` calls, ledger,
  counters, metric events and snapshot equal the JAX controller's.
- ``ReplicatedTierClient.scale_to`` (serving/replicas.py) on the tiny
  tiers on the CPU: the same membership trajectory as JAX's client for
  one scale sequence (replica names, parked flags); rids only increase;
  the warm standby pool is built at construction, warmed by
  ``start_server``, published by a scale-up and refilled by a scale-down;
  an injected standby-publish failure falls through to a fresh replica;
  a scaled-up replica serves with one ragged decode program.
- The Router arms one controller per armed tier (``autoscale=False``
  disarms all, JAX's ``DLLM_AUTOSCALE=0``) and stops them in ``drain``
  before the tiers; ``/stats`` carries the ``autoscaler`` block.
- The bench's ``elastic`` leg at a short ramp: JAX's keys, the flap
  bound, the handoff sub-check's identical answers and one decode
  program per replica, and ``compact`` equal to root ``bench.py``'s.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)
from distributed_llm_tpu import config as jax_config  # noqa: E402
from distributed_llm_tpu.serving import autoscaler as JA  # noqa: E402
from distributed_llm_tpu.serving import replicas as JR  # noqa: E402
from distributed_llm_tpu_torch import config as torch_config  # noqa: E402
from distributed_llm_tpu_torch.bench import elastic, headline  # noqa: E402
from distributed_llm_tpu_torch.serving import autoscaler as TA  # noqa: E402
from distributed_llm_tpu_torch.serving import replicas as TR  # noqa: E402
from distributed_llm_tpu_torch.serving.tiers import build_tiers  # noqa: E402
from distributed_llm_tpu_torch.utils.faults import FaultInjector  # noqa: E402


# -- the controller --------------------------------------------------------------

class _Admission:
    def __init__(self):
        self.rejected = 0

    def snapshot(self):
        return {"rejected": self.rejected}


class _Client:
    """The surface the controller reads (replica_count, load_snapshot,
    clients[].admission) and actuates (scale_to)."""

    def __init__(self, n=1):
        self.n = n
        self.admission = _Admission()
        self.queue_depth = 0
        self.active_slots = 0
        self.refuse = False
        self.calls = []

    @property
    def clients(self):
        return [self]

    def replica_count(self):
        return self.n

    def load_snapshot(self):
        return {"queue_depth": self.queue_depth,
                "active_slots": self.active_slots, "max_slots": 2}

    def scale_to(self, target, reason="manual", timeout_s=None):
        self.calls.append((target, reason))
        if self.refuse:
            return {"target": target, "added": [], "removed": [],
                    "errors": ["refused"], "replicas": self.n}
        added = [f"r{k}" for k in range(self.n, target)]
        removed = [{"replica": "r?"}] * max(0, self.n - target)
        self.n = target
        return {"target": target, "added": added, "removed": removed,
                "errors": [], "replicas": self.n}


class _SLO:
    def __init__(self):
        self.value = None

    def goodput(self, strategy=None, tier=None):
        return self.value


class _Metrics:
    """Records the controller's metric calls."""

    def __init__(self):
        self.events = []
        outer = self

        class _Fam:
            def __init__(self, name):
                self.name = name

            def labels(self, *lv):
                fam = self

                class _Child:
                    def inc(self, v=1):
                        outer.events.append((fam.name, lv, "inc", v))

                    def set(self, v):
                        outer.events.append((fam.name, lv, "set", v))
                return _Child()

        self.autoscale_events = _Fam("events")
        self.replica_count_g = _Fam("count")


def _cfg(**kw):
    base = dict(autoscale=True, autoscale_min_replicas=1,
                autoscale_max_replicas=3, autoscale_interval_s=0.1,
                autoscale_goodput_floor=0.5, autoscale_queue_high=2.0,
                autoscale_breach_window_s=1.0, autoscale_idle_window_s=2.0,
                autoscale_up_cooldown_s=2.0, autoscale_down_cooldown_s=4.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


# (t, queue_depth, active_slots, shed increment, goodput, refuse)
SIGNALS = [
    (0.0, 10, 2, 0, None, False), (0.5, 10, 2, 0, None, False),
    (1.0, 10, 2, 0, None, False),            # breach window met: up to 2
    (1.5, 10, 2, 0, None, False), (2.5, 10, 2, 0, None, False),
    (3.2, 10, 2, 0, None, False),            # up cooldown over: up to 3
    (3.5, 10, 2, 0, None, False),            # at max: no up
    (4.0, 0, 0, 0, 0.55, False),             # near the floor: not idle
    (4.5, 0, 0, 0, 0.9, False), (6.0, 0, 0, 0, 0.9, False),
    (7.0, 0, 0, 0, 0.9, False),              # idle, inside down cooldown
    (7.5, 0, 0, 0, 0.9, False),              # down to 2
    (8.0, 0, 0, 3, 0.9, False), (8.5, 0, 0, 2, 0.9, False),
    (9.0, 0, 0, 1, 0.9, False),              # shed window met, cooldown
    (9.6, 0, 0, 1, 0.9, False),              # up to 3 (shed)
    (10.0, 0, 0, 0, None, False), (12.0, 0, 0, 0, None, False),
    (13.6, 0, 0, 0, None, True),             # down refused
    (14.0, 0, 0, 0, None, True),             # retried, refused again
    (14.5, 0, 0, 0, None, False),            # down to 2
    (15.0, 0, 1, 0, 0.2, False), (16.0, 0, 1, 0, 0.2, False),
    (16.6, 0, 1, 0, 0.2, False),             # up to 3 (goodput_floor)
    (17.0, 0, 0, 0, None, False), (19.0, 0, 0, 0, None, False),
    (21.0, 0, 0, 0, None, False),            # down to 2
    (23.0, 0, 0, 0, None, False), (25.1, 0, 0, 0, None, False),
    (27.0, 0, 0, 0, None, False), (30.0, 0, 0, 0, None, False),
]


def _drive(module):
    clock = [0.0]
    client, slo, metrics = _Client(), _SLO(), _Metrics()
    scaler = module.ReplicaAutoscaler("nano", _cfg(), client, slo,
                                      metrics=metrics,
                                      clock=lambda: clock[0])
    decisions = []
    for t, q, act, shed, gp, refuse in SIGNALS:
        clock[0] = t
        client.queue_depth, client.active_slots = q, act
        client.admission.rejected += shed
        slo.value, client.refuse = gp, refuse
        decisions.append((scaler.tick(), client.n,
                          scaler._breach_since, scaler._idle_since))
    snap = scaler.snapshot()
    for e in snap["ledger"]:
        e.pop("ts")
    return decisions, client.calls, metrics.events, snap


def test_controller_decisions_and_ledger_match_jax():
    want = _drive(JA)
    got = _drive(TA)
    assert got == want
    decisions, calls, _events, snap = got
    dirs = [d for d, *_ in decisions if d]
    assert dirs == ["up", "up", "down", "up", "down", "up", "down",
                    "down"], decisions
    assert calls == [(2, "queue_growth"), (3, "queue_growth"), (2, "idle"),
                     (3, "shed"), (2, "idle"), (2, "idle"), (2, "idle"),
                     (3, "goodput_floor"), (2, "idle"), (1, "idle")]
    assert [e["ok"] for e in snap["ledger"]].count(False) == 2
    assert snap["events_total"] == {"up": 4, "down": 4}
    assert snap["replicas"] == 1 and not snap["breaching"]


def test_constants_and_ledger_bound_match_jax():
    assert TA.IDLE_GOODPUT_MARGIN == JA.IDLE_GOODPUT_MARGIN
    assert TA.LEDGER_CAP == JA.LEDGER_CAP
    client = _Client(n=2)
    clock = [0.0]
    scaler = TA.ReplicaAutoscaler("nano", _cfg(autoscale_max_replicas=2,
                                               autoscale_up_cooldown_s=0.0),
                                  client, _SLO(), clock=lambda: clock[0])
    client.refuse = True
    client.queue_depth = 50
    for k in range(3 * TA.LEDGER_CAP):
        clock[0] = float(k)
        client.n = 1
        scaler.tick()
    assert len(scaler.snapshot()["ledger"]) == TA.LEDGER_CAP


def test_controller_thread_starts_and_stops():
    client = _Client()
    scaler = TA.ReplicaAutoscaler("nano", _cfg(autoscale_interval_s=0.05),
                                  client, _SLO())
    scaler.start()
    scaler.start()                       # idempotent
    assert scaler._thread.is_alive()
    scaler.stop()
    assert not scaler._thread.is_alive()


# -- membership ---------------------------------------------------------------

def _cluster(pkg, **tier_kw):
    cl = pkg.tiny_batched_cluster(nano_slots=2)
    return dataclasses.replace(cl, nano=dataclasses.replace(
        cl.nano, max_new_tokens=8, **tier_kw))


def _trajectory(client, steps):
    out = []
    for n in steps:
        s = client.scale_to(n, reason="test")
        out.append((list(s["added"]),
                    [(r["replica"], r["parked"]) for r in s["removed"]],
                    s["replicas"], list(s["errors"])))
    return out


@pytest.mark.parametrize("warm_pool", [False, True])
def test_scale_to_membership_matches_jax(warm_pool):
    """One scale sequence gives JAX's names, parked flags and sizes; rids
    only increase (a retired name never comes back on the cold path)."""
    kw = dict(autoscale=True, autoscale_min_replicas=1,
              autoscale_max_replicas=3, autoscale_warm_pool=warm_pool)
    steps = [2, 1, 2, 3, 1, 3]
    cj, ct = _cluster(jax_config, **kw), _cluster(torch_config, **kw)
    jc = JR.ReplicatedTierClient(cj.nano, cj, warmup_on_start=False)
    tc = TR.ReplicatedTierClient(ct.nano, ct, device="cpu",
                                 warmup_on_start=False)
    try:
        assert ([r.name for r in tc._standby]
                == [r.name for r in jc._standby])
        jc.server_manager.start_server()
        tc.server_manager.start_server()
        want, got = _trajectory(jc, steps), _trajectory(tc, steps)
        assert got == want
        assert ([r.name for r in tc._members]
                == [r.name for r in jc._members])
        seen = [n for added, *_ in got for n in added]
        if not warm_pool:
            assert len(seen) == len(set(seen))      # never reused
            assert seen == sorted(seen, key=lambda n: int(n[1:]))
        out = tc.process("q rivers?")
        assert "response" in out
    finally:
        jc.server_manager.stop_server()
        tc.server_manager.stop_server()


def test_warm_pool_publishes_and_parks_the_same_engine():
    ct = _cluster(torch_config, autoscale=True, autoscale_min_replicas=1,
                  autoscale_max_replicas=2)
    client = TR.ReplicatedTierClient(ct.nano, ct, device="cpu",
                                     warmup_on_start=False)
    try:
        assert client.replica_count() == 1
        assert [r.name for r in client._standby] == ["r1"]
        client.server_manager.start_server()
        assert client._standby[0].mgr.is_server_running()
        engine = client._standby[0].mgr._engine
        assert client.scale_to(2)["added"] == ["r1"]
        assert client._members[1].mgr._engine is engine
        down = client.scale_to(1)
        assert down["removed"][0]["parked"]
        assert [r.name for r in client._standby] == ["r1"]
        assert client.scale_to(2)["added"] == ["r1"]
        assert client._members[1].mgr._engine is engine
        client.scale_to(1)                 # parked again
    finally:
        client.server_manager.stop_server()
    # stop_server reaches the parked standby too.
    assert not client._standby[0].mgr.is_server_running()


def test_standby_publish_fault_falls_through_to_a_fresh_replica():
    """The injected publish failure (utils/faults.py) loses the parked
    standby: its server is stopped, the error recorded, and a fresh
    replica goes live instead."""
    ct = _cluster(torch_config, autoscale=True, autoscale_min_replicas=1,
                  autoscale_max_replicas=2)
    fi = FaultInjector()
    client = TR.ReplicatedTierClient(ct.nano, ct, device="cpu",
                                     warmup_on_start=False,
                                     fault_injector=fi)
    try:
        client.server_manager.start_server()
        lost = client._standby[0]
        fi.fail_standby_publish("nano")
        up = client.scale_to(2)
        assert up["added"] == ["r2"]
        assert any("r1" in e and "standby publish" in e
                   for e in up["errors"])
        assert not lost.mgr.is_server_running()
        assert lost not in client._members and lost not in client._standby
        assert "response" in client.process("q rivers?")
    finally:
        client.server_manager.stop_server()


def test_busy_scale_is_refused_and_drain_failure_still_retires(monkeypatch):
    ct = _cluster(torch_config, autoscale=True, autoscale_min_replicas=1,
                  autoscale_max_replicas=2, autoscale_warm_pool=False)
    client = TR.ReplicatedTierClient(ct.nano, ct, device="cpu",
                                     warmup_on_start=False)
    try:
        client.server_manager.start_server()
        client._scaling = True
        busy = client.scale_to(2)
        assert busy["errors"] == ["busy: scale in progress"]
        client._scaling = False
        client.scale_to(2)
        victim = client._members[1]

        def drain(*a, **k):
            raise RuntimeError("drain boom")

        monkeypatch.setattr(victim.mgr, "drain", drain)
        down = client.scale_to(1)
        assert [i["replica"] for i in down["removed"]] == [victim.name]
        assert not victim.mgr.is_server_running()
    finally:
        client.server_manager.stop_server()


def test_scaled_up_replica_serves_on_one_decode_program():
    ct = _cluster(torch_config)
    client = TR.ReplicatedTierClient(ct.nano, ct, device="cpu",
                                     warmup_on_start=False)
    try:
        client.server_manager.start_server()
        client.process("q rivers?")
        client.scale_to(2)
        for _ in range(4):
            client.process("q rivers?")
        programs = elastic._decode_programs(client)
        assert set(programs) == {"r0", "r1"}
        assert all(p["compiled"] == 1 and p["gauge"] == 1.0
                   for p in programs.values()), programs
    finally:
        client.server_manager.stop_server()


def test_autoscale_armed_tier_builds_the_replica_layer_at_min():
    plain = build_tiers(torch_config.tiny_batched_cluster(), device="cpu",
                        warmup_on_start=False)
    assert not hasattr(plain["nano"], "scale_to")
    ct = _cluster(torch_config, autoscale=True, autoscale_min_replicas=2,
                  autoscale_max_replicas=3)
    tiers = build_tiers(ct, device="cpu", warmup_on_start=False)
    assert tiers["nano"].replica_count() == 2
    assert [r.name for r in tiers["nano"]._standby] == ["r2"]


@pytest.mark.parametrize("armed", [True, False])
def test_router_arms_and_drain_stops_the_controller(armed):
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.app import create_app
    from distributed_llm_tpu_torch.serving.router import Router
    ct = _cluster(torch_config, autoscale=True, autoscale_min_replicas=1,
                  autoscale_max_replicas=2, autoscale_interval_s=0.1)
    router = Router(strategy="heuristic", benchmark_mode=True, cluster=ct,
                    device="cpu", observability=Observability(slow_ms=None),
                    sample_ms=0, autoscale=armed)
    scaler = router.autoscalers.get("nano")
    try:
        stats = create_app(router=router).test_client().get(
            "/stats").get_json()
        if not armed:
            assert router.autoscalers == {}
            assert stats["autoscaler"] is None
            return
        assert set(router.autoscalers) == {"nano"}
        assert scaler._thread.is_alive()
        snap = stats["autoscaler"]["nano"]
        assert {"enabled", "replicas", "min_replicas", "max_replicas",
                "breaching", "idle", "last_signals", "events_total",
                "ledger"} <= set(snap)
    finally:
        router.drain(timeout_s=5.0)
    assert not scaler._thread.is_alive()


# -- the bench's elastic leg ------------------------------------------------------

# bench.py:2686-2930 (the leg), :2623-2672 (its handoff sub-check).
ELASTIC_KEYS = {"period_s", "slots_per_replica", "capacity_req_per_s",
                "schedule", "static_min", "static_max", "auto",
                "goodput_per_replica_s", "scale_events", "flap_count",
                "goodput_vs_max", "gprs_vs_max", "goodput_ok", "gprs_ok",
                "handoff", "outputs_identical"}
MODE_KEYS = {"replicas_static", "arrivals", "hung_clients", "wall_s",
             "goodput_total", "observed_total", "replica_s",
             "goodput_per_replica_s"}
AUTO_KEYS = MODE_KEYS | {"scale_events", "max_replicas", "events",
                         "flap_count"}
HANDOFF_KEYS = {"scale_up_errors", "decode_programs_per_replica", "victim",
                "demoted_entries", "handed_off", "identical"}


def test_elastic_leg_keys_invariants_and_compact():
    out = elastic.elastic_phase(period_s=6.0, device="cpu")
    assert "error" not in out, out.get("error")
    assert set(out) - ELASTIC_KEYS == {"single_device"}
    assert set(out["static_min"]) == set(out["static_max"]) == MODE_KEYS
    assert set(out["auto"]) == AUTO_KEYS
    assert set(out["handoff"]) == HANDOFF_KEYS
    assert out["flap_count"] == 0 and out["scale_events"] <= 4
    assert out["outputs_identical"] and out["handoff"]["identical"]
    assert all(p["compiled"] == 1 for p in
               out["handoff"]["decode_programs_per_replica"].values())
    assert out["handoff"]["handed_off"] == out["handoff"]["demoted_entries"]
    for mode in ("static_min", "static_max", "auto"):
        assert out[mode]["hung_clients"] == 0
    assert out["static_max"]["replica_s"] == pytest.approx(
        2 * out["static_max"]["wall_s"], abs=0.02)
    want = jax_bench.compact({"elastic": out})
    assert headline.compact({"elastic": out})["elastic"] == want["elastic"]
