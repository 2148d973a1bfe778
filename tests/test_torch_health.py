"""The port's HealthMonitor (serving/health.py) against the JAX
package's, on the CPU.

Both monitors probe the same duck-typed tiers through the same scripted
histories (running, failing, stopped, draining, wedged, a restart that
hangs, a replicated tier whose replica wedges) and must report the same
probe states, failure streaks, restart and abandoned-restart counts, and
call the same restarts; ``_merge_gathered`` folds the same numpy rows
into each package's PerfStrategy with the same result.  Then the port's
Router: ``enable_health_monitor`` starts a monitor that restarts a
wedged engine (bounded waits on events and deadlines), ``drain`` stops
it first, and a ``health_mesh`` reaches the monitor's exchange.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from distributed_llm_tpu.routing.strategies import PerfStrategy as JaxPerf
from distributed_llm_tpu.serving.health import HealthMonitor as JaxMonitor
from distributed_llm_tpu_torch.config import BENCHMARK_CFG, tiny_batched_cluster
from distributed_llm_tpu_torch.parallel.mesh import tp_mesh
from distributed_llm_tpu_torch.routing.strategies import PerfStrategy
from distributed_llm_tpu_torch.serving.health import HealthMonitor
from distributed_llm_tpu_torch.serving.router import Router
from distributed_llm_tpu_torch.utils.faults import crash_replica_engine

MONITORS = (JaxMonitor, HealthMonitor)


class _Manager:
    """A scripted EngineManager: ``states`` is consumed one probe at a
    time (running, failed, stopped, draining, wedged); restarts are
    logged."""

    def __init__(self, states, name, log, hang=None):
        self.states = list(states)
        self.name = name
        self.log = log
        self.hang = hang
        self._engine = None
        self.state = None

    def _next(self):
        self.state = self.states.pop(0) if self.states else self.state
        return self.state

    def is_server_running(self):
        return self._next() not in ("stopped",)

    def health(self):
        st = self.state
        return {"ok": st == "running", "tier": self.name,
                "draining": st == "draining",
                **({"wedged": True} if st == "wedged" else {})}

    def stop_server(self):
        self.log.append(("stop", self.name))

    def start_server(self, beat=None):
        self.log.append(("start", self.name))
        if self.hang is not None:
            self.hang.wait(30)

    @property
    def draining(self):
        return self.state == "draining"


def _run(mon_cls, histories, probes, **kw):
    log = []
    tiers = {name: SimpleNamespace(server_manager=_Manager(h, name, log))
             for name, h in histories.items()}
    breaker_calls = []
    breaker = SimpleNamespace(
        note_probe=lambda n, ok: breaker_calls.append(("probe", n, ok)),
        reset=lambda n: breaker_calls.append(("reset", n)))
    router = SimpleNamespace(tiers=tiers, breaker=breaker,
                             query_router=SimpleNamespace(router=None))
    mon = mon_cls(router, **kw)
    snaps = []
    for _ in range(probes):
        snap = mon.probe_once()
        snaps.append({n: {k: e.get(k) for k in (
            "state", "consecutive_failures", "restarts",
            "restarts_abandoned", "ok")} for n, e in snap.items()})
    return snaps, log, breaker_calls, mon.snapshot()


def test_probe_states_and_restarts_match_jax():
    histories = {
        # Seen running, then 3 failed probes: restarted at the third.
        "nano": ["running", "failed", "failed", "failed", "running",
                 "running"],
        # Never seen running: a failure is not counted; stopped is
        # stopped; draining is deliberate.
        "orin": ["failed", "stopped", "draining", "stopped", "running",
                 "running"],
        # Wedged on first sight: restarted at once.
        "mini": ["wedged", "running", "running", "running", "running",
                 "running"],
    }
    want = _run(JaxMonitor, histories, 6, max_consecutive_failures=3)
    got = _run(HealthMonitor, histories, 6, max_consecutive_failures=3)
    assert got == want
    snaps, log, _, final = got
    assert final["nano"]["restarts"] == 1 and final["mini"]["restarts"] == 1
    assert final["orin"]["restarts"] == 0
    assert [e for e in log if e[0] == "start"] == [("start", "mini"),
                                                   ("start", "nano")]


def test_abandoned_restart_is_counted_like_jax():
    outs = []
    for cls in MONITORS:
        hang = threading.Event()
        log = []
        mgr = _Manager(["running", "failed"], "nano", log, hang=hang)
        router = SimpleNamespace(tiers={"nano": SimpleNamespace(
            server_manager=mgr)}, query_router=SimpleNamespace(router=None))
        mon = cls(router, max_consecutive_failures=1,
                  restart_timeout_s=0.1)
        mon.probe_once()
        snap = mon.probe_once()                  # the restart hangs
        outs.append((snap["nano"]["restarts_abandoned"],
                     mon.snapshot()["nano"]["restarts"]))
        hang.set()
        mon._restarting["nano"].join(timeout=10)
    assert outs[0] == outs[1] == (1, 0)


class _Replicated:
    """A replicated tier client with scripted replica managers and a
    ``restart_replica`` that logs (and refuses while ``busy``)."""

    def __init__(self, histories, log):
        self.mgrs = [_Manager(h, f"nano/r{i}", log)
                     for i, h in enumerate(histories)]
        self.log = log
        self.busy = False
        self.server_manager = SimpleNamespace(
            replica_items=lambda: list(enumerate(self.mgrs)))

    def member_manager(self, rid):
        return self.mgrs[rid]

    def restart_replica(self, rid, reason="wedged"):
        self.log.append(("restart_replica", rid, reason))
        if self.busy:
            return {"restarted": False, "errors": ["busy: scale in progress"]}
        return {"restarted": True, "errors": []}

    def reset_replica(self, rid):
        self.log.append(("reset_replica", rid))


def test_only_the_wedged_replica_restarts_like_jax():
    outs = []
    for cls in MONITORS:
        log = []
        tier = _Replicated([["running", "wedged", "wedged", "running"],
                            ["running"] * 4], log)
        router = SimpleNamespace(tiers={"nano": tier}, breaker=None,
                                 query_router=SimpleNamespace(router=None))
        mon = cls(router, max_consecutive_failures=3)
        snaps = []
        for i in range(4):
            tier.busy = (i == 1)                 # the first restart refused
            snap = mon.probe_once()
            snaps.append((snap["nano"]["state"],
                          snap["nano"]["healthy_replicas"],
                          snap["nano"]["degraded"],
                          {k: v["consecutive_failures"]
                           for k, v in snap["nano"]["replicas"].items()}))
        outs.append((snaps, log, mon.snapshot()["nano/r0"]["restarts"]))
    assert outs[0] == outs[1]
    snaps, log, restarts = outs[1]
    assert restarts == 1
    assert [e for e in log if e[0] != "reset_replica"] == [
        ("restart_replica", 0, "health probe"),
        ("restart_replica", 0, "health probe")]
    assert ("reset_replica", 0) in log
    assert snaps[1][2] is True                   # one of two replicas down


def test_merge_gathered_matches_jax():
    rows = np.array([[500.0, 50.0, 4.0, 8.0],
                     [30000.0, 300.0, 6.0, 30.0],
                     [10.0, 1.0, 1.0, 0.0],
                     [90.0, 9.0, 3.0, 3.0]], np.float32)
    mask = [False, True, True, True]
    samples = []
    for cls, perf_cls in ((JaxMonitor, JaxPerf), (HealthMonitor,
                                                  PerfStrategy)):
        perf = perf_cls(dict(BENCHMARK_CFG))
        cls._merge_gathered(perf, "nano", rows, mask)
        samples.append(list(perf.samples["nano"]))
    assert samples[0] == samples[1]
    assert len(samples[1]) == 5 + 3


def test_exchange_is_none_without_a_mesh_and_a_mesh_is_refused():
    """No group: no exchange, as in JAX.  A group: every tier's perf row
    all-gathered over it (one row per slot, all this process's own, so
    nothing is folded into the strategy)."""
    router = SimpleNamespace(tiers={}, query_router=SimpleNamespace(
        router=PerfStrategy(dict(BENCHMARK_CFG))))
    assert HealthMonitor(router).exchange_health() is None
    assert JaxMonitor(router).exchange_health() is None
    router.query_router.router.samples["nano"].append((100.0, 10, True))
    out = HealthMonitor(router, mesh=tp_mesh(["cpu"] * 2, 2)
                        ).exchange_health()
    assert set(out) == {"nano", "orin"}
    np.testing.assert_allclose(out["nano"], [[100.0, 10.0, 1.0, 1.0]] * 2)
    assert list(router.query_router.router.samples["nano"]) == [
        (100.0, 10, True)]


def _router(**config):
    cl = tiny_batched_cluster()
    cl = dataclasses.replace(cl, nano=dataclasses.replace(
        cl.nano, watchdog_stall_s=0.3, max_new_tokens=64))
    return Router(strategy="heuristic", benchmark_mode=True, cluster=cl,
                  device="cpu", sample_ms=0,
                  config=dict(BENCHMARK_CFG, **config))


def test_router_health_monitor_restarts_a_wedged_engine():
    router = _router(enable_health_monitor=True, health_interval_s=0.05)
    try:
        mon = router.health_monitor
        assert isinstance(mon, HealthMonitor) and mon._thread is not None
        mgr = router.tiers["nano"].server_manager
        # Warmed up on start, so the rebuilt engine's loop runs (a
        # never-driven batching engine's lazy loop reads dead to the
        # probe, in JAX as here).
        mgr.start_server()
        eng = mgr._engine
        req = eng.submit("user: tell me about rivers and lakes please")
        deadline = time.monotonic() + 30
        while not eng._slots[0] and time.monotonic() < deadline:
            time.sleep(0.001)
        assert crash_replica_engine(eng)
        # The watchdog reads the dead loop wedged; the monitor restarts.
        assert req.done.wait(timeout=60)
        deadline = time.monotonic() + 60
        while mgr._engine in (None, eng) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr._engine is not None and mgr._engine is not eng
        assert req.error is not None             # a flat tier: no rescue
        assert "engine stopped" in str(req.error)
        deadline = time.monotonic() + 30
        while (mon.snapshot().get("nano", {}).get("restarts", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        mon.stop()
        assert mon.snapshot()["nano"]["restarts"] == 1
    finally:
        router.drain(timeout_s=5)
    assert router.health_monitor._thread is None


def test_router_without_the_monitor_and_with_a_mesh():
    router = _router()
    assert router.health_monitor is None
    router.drain(timeout_s=5)
    group = tp_mesh(["cpu"] * 2, 2)
    router = _router(enable_health_monitor=True, health_mesh=group)
    try:
        assert router.health_monitor.mesh is group
    finally:
        router.drain(timeout_s=5)
