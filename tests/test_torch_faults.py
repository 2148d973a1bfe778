"""The port's fault model (utils/faults.py) and circuit breaker
(serving/breaker.py) against the JAX package's, on the CPU.

The same scripts run through both packages and must leave the same
observable state: the injector's one-shot queues, sticky outages,
latency, stream kills and standby-publish failures, and ``restore``;
``BrokenStream`` and ``maybe_break_stream``; ``BlockStarver`` over each
package's block allocator; ``FaultSchedule``'s applied labels and its
``stop`` (every touched tier restored, every block released, every paused
copier resumed); ``crash_replica_engine`` on a port engine.  The
breakers, on one fake clock, go through the same call sequences
(failures, canaries, ``note_probe``, ``reset``, ``ensure``, ``forget``,
``all_open``) and must report the same states and snapshots.  Waits are
bounded by events, never by sleeps.
"""

from __future__ import annotations

import threading
import time

import pytest

from distributed_llm_tpu.engine.paged_kv import BlockAllocator as JaxAllocator
from distributed_llm_tpu.serving import breaker as JB
from distributed_llm_tpu.utils import faults as JF
from distributed_llm_tpu_torch.engine.paged_kv import BlockAllocator
from distributed_llm_tpu_torch.serving import breaker as TB
from distributed_llm_tpu_torch.utils import faults as TF

PACKAGES = [pytest.param(JF, id="jax"), pytest.param(TF, id="port")]


def _script(mod):
    """One injector script; returns what each hook observed."""
    fi = mod.FaultInjector()
    seen = []
    fi.fail_next("nano", "boom")
    fi.timeout_next("nano")
    fi.fail_transient("orin")
    seen.append(fi.intercept("nano"))
    seen.append(fi.intercept("nano"))
    seen.append(fi.intercept("nano"))            # one-shots exhausted
    seen.append(fi.intercept("orin"))
    fi.set_down("orin", "orin offline")
    seen.append(fi.intercept("orin"))
    seen.append(fi.intercept("orin"))            # sticky
    fi.fail_next("orin")
    fi.fail_stream_after("orin", 2, "dies")
    fi.fail_standby_publish("orin")
    fi.restore("orin")                           # clears everything
    seen.append(fi.intercept("orin"))
    seen.append(fi.stream_kill("orin"))
    seen.append(fi.standby_publish_fail("orin"))
    fi.fail_stream_after("nano", -3)
    fi.fail_standby_publish("nano", "gone")
    seen.append(fi.stream_kill("nano"))
    seen.append(fi.stream_kill("nano"))          # one-shot
    seen.append(fi.standby_publish_fail("nano"))
    seen.append(fi.standby_publish_fail("nano"))
    return seen


def test_injector_one_shot_and_restore_match_jax():
    assert _script(TF) == _script(JF)
    assert _script(TF)[0] == {"error": "boom"}


def test_latency_is_applied_by_intercept():
    fi = TF.FaultInjector()
    fi.add_latency("nano", 0.05)
    t0 = time.monotonic()
    assert fi.intercept("nano") is None
    assert time.monotonic() - t0 >= 0.05
    fi.add_latency("nano", 0.0)
    t0 = time.monotonic()
    fi.intercept("nano")
    assert time.monotonic() - t0 < 0.05


class _Handle:
    def __init__(self, deltas, result="done"):
        self.deltas = deltas
        self.result = result
        self.closed = False

    def __iter__(self):
        return iter(self.deltas)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("n", [0, 2, 5])
def test_broken_stream_matches_jax(n):
    outs = []
    for mod in (JF, TF):
        fi = mod.FaultInjector()
        fi.fail_stream_after("nano", n, "dead")
        handle = _Handle(["a", "b", "c"])
        wrapped = mod.maybe_break_stream(fi, "nano", handle)
        got = []
        err = None
        try:
            for d in wrapped:
                got.append(d)
        except RuntimeError as exc:
            err = str(exc)
        outs.append((got, err, handle.closed, wrapped.result,
                     mod.maybe_break_stream(fi, "nano", handle) is handle,
                     mod.maybe_break_stream(None, "nano", handle) is handle))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mod,alloc", [(JF, JaxAllocator),
                                       (TF, BlockAllocator)],
                         ids=["jax", "port"])
def test_block_starver(mod, alloc):
    pool = alloc(9)
    kept = pool.alloc(2)
    st = mod.BlockStarver(pool)
    free0 = pool.available
    assert st.starve(3) == 3 and st.held == 3
    assert st.starve(100) == free0 - 3           # only what is free
    assert pool.available == 0 and st.starve(1) == 0
    assert st.release() == free0 and pool.available == free0
    pool.free(kept)


def _schedule_run(mod):
    """Drive one schedule to its end; returns (labels applied, what the
    injector reads before stop, after stop, blocks, copier state)."""
    class Spill:
        def __init__(self):
            self.paused = False

        def pause(self):
            self.paused = True

        def resume(self):
            self.paused = False

    fi = mod.FaultInjector()
    pool = (JaxAllocator if mod is JF else BlockAllocator)(9)
    free0 = pool.available
    spill = Spill()
    killed = threading.Event()

    class Engine:
        _thread = object()
        _stop = killed
        _wake = threading.Event()

    sched = (mod.FaultSchedule(fi)
             .outage("nano", 0.0, 0.5)
             .latency_spike("orin", 0.0, 0.5, seconds=0.0)
             .starve_blocks(pool, 0.0, 0.5, 4, tier="nano")
             .kill_stream("orin", 0.0, 1)
             .kill_replica(lambda: Engine(), 0.0, tier="nano")
             .wedge_spill_copier(lambda: spill, 0.0, 0.5, tier="nano")
             .fail_standby_publish("nano", 0.0))
    assert sched.duration_s() == 0.5
    sched.start()
    assert killed.wait(5.0)
    deadline = time.monotonic() + 5.0
    while len(sched.applied) < 6 and time.monotonic() < deadline:
        time.sleep(0.001)
    during = (fi.intercept("nano"), pool.available, spill.paused)
    sched.stop()                     # before the 0.5 s ends: restores all
    after = (fi.intercept("nano"), fi.stream_kill("orin"),
             fi.standby_publish_fail("nano"), pool.available == free0,
             spill.paused)
    labels = sorted(label for _, label in sched.applied)
    return labels, during, after


def test_fault_schedule_applies_and_stop_restores_like_jax():
    want = _schedule_run(JF)
    got = _schedule_run(TF)
    assert got == want
    labels, during, after = got
    assert "down:nano" in labels and during[0] is not None
    assert during[2] is True and during[1] == 9 - 1 - 4
    assert after == (None, None, None, True, False)


def test_flaps_build_the_jax_timeline():
    def events(mod):
        s = mod.FaultSchedule(mod.FaultInjector()).flaps(
            "nano", n=3, period_s=1.0, down_s=0.45, start_s=0.2)
        return [(t, label) for t, label, _ in s._events], s.duration_s()
    assert events(TF) == events(JF)


def test_crash_replica_engine_kills_a_port_loop():
    from distributed_llm_tpu_torch.config import tiny_batched_cluster
    from distributed_llm_tpu_torch.engine.batching import (
        ContinuousBatchingEngine)
    eng = ContinuousBatchingEngine(tiny_batched_cluster().nano,
                                   device="cpu")
    try:
        assert TF.crash_replica_engine(eng) is False     # no loop yet
        eng.start()
        thread = eng._thread
        assert TF.crash_replica_engine(eng) is True
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert eng._thread is thread       # no cleanup: the loop is dead
    finally:
        eng.stop()


# -- the breaker ---------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_script(mod):
    clock = _Clock()
    cb = mod.CircuitBreaker(["nano", "orin"], failure_threshold=2,
                            cooldown_s=10.0, clock=clock)
    trail = []

    def note(label):
        trail.append((label, cb.state("nano"), cb.state("orin"),
                      cb.all_open(), cb.snapshot()))

    cb.record("nano", False)
    cb.record("nano", False)
    note("nano open")
    cb.note_probe("nano", True)            # inside the cooldown: no change
    note("early probe")
    cb.record("orin", False)
    cb.record("orin", False)
    note("both open")
    clock.t = 11.0
    note("cooldowns over")
    cb.note_probe("nano", False)           # unhealthy: state kept
    note("bad probe")
    cb.note_probe("nano", True)            # healthy past cooldown
    note("half open")
    trail.append(("canary", cb.allow("nano"), cb.allow("nano")))
    cb.record("nano", False)
    note("canary failed")
    cb.reset("nano")
    note("reset")
    cb.ensure("r2")
    cb.ensure("nano")                       # never resets an existing key
    cb.record("r2", False)
    cb.record("r2", False)
    note("r2 open")
    trail.append(("r2", cb.state("r2"), cb.allow("r2"),
                  dict(cb.opened_total)))
    cb.forget("r2")
    trail.append(("forgot", cb.state("r2"), cb.allow("r2"),
                  dict(cb.opened_total)))
    cb.release_probe("orin")
    cb.reset("unknown")
    cb.note_probe("unknown", True)
    note("end")
    off = mod.CircuitBreaker(["nano"], failure_threshold=0)
    trail.append(("disabled", off.all_open(), off.allow("nano")))
    return trail


def test_breaker_states_match_jax():
    got, want = _breaker_script(TB), _breaker_script(JB)
    assert got == want
    assert any(step[0] == "half open" and step[1] == "half_open"
               for step in got)
