"""The port's scenario traffic (``bench/scenarios.py``) against the JAX
package's (``distributed_llm_tpu/bench/scenarios.py``).

- Every generator (diurnal ramp, flash crowd, session mix, long-context
  wave) gives JAX's segments, and ``schedule`` gives JAX's arrivals
  (times, kinds, sessions, indices) exactly, for one (segments, label,
  seed) and across seeds and labels: the schedule is seeded with
  ``zlib.crc32(label) ^ seed``, never ``hash()``.
- ``run_schedule`` replays on an injected clock (no wall-clock wait): the
  absolute-target sleeps, the catch-up burst after a stall, time scaling
  and deadline truncation give JAX's fire times and result.
"""

from __future__ import annotations

import threading

import pytest

from distributed_llm_tpu.bench import scenarios as JS
from distributed_llm_tpu_torch.bench import scenarios as TS

CONSTANTS = ("SESSION_POOL", "JOIN_GRACE_S", "MAX_ARRIVALS", "KIND_CHAT",
             "KIND_ONESHOT", "KIND_LONG")


def test_constants_are_jaxs():
    for name in CONSTANTS:
        assert getattr(TS, name) == getattr(JS, name), name


def _segs(mod, shape):
    kind, args = shape
    if kind == "diurnal":
        return mod.diurnal_ramp(*args)
    if kind == "flash":
        return mod.flash_crowd(*args)
    if kind == "mix":
        return mod.session_mix(*args)
    if kind == "wave":
        return mod.long_context_wave(*args)
    return [mod.Segment(*a) for a in args]


SHAPES = [
    ("diurnal", (1.0, 8.0, 30.0, 6)),
    ("diurnal", (0.376, 8.637, 20.0, 6)),
    ("diurnal", (2.0, 10.0, 24.0, 8)),
    ("flash", (2.0, 40.0, 20.0, 8.0, 4.0)),
    ("mix", (5.0, 10.0, 0.5)),
    ("mix", (5.0, 10.0, 1.0)),
    ("wave", (4.0, 4.0, 30.0, 10.0, 3.0)),
    ("raw", ((5.0, 0.0), (5.0, 2.0), (100.0, 50.0))),
]


def _plain(arrivals):
    return [(a.t_s, a.kind, a.session, a.index) for a in arrivals]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("label,seed", [("elastic-diurnal", 18),
                                        ("chaos2-diurnal", 20),
                                        ("ab", 0), ("ba", 0), ("pin", 7)])
def test_schedule_is_jaxs(shape, label, seed):
    sj, st = _segs(JS, shape), _segs(TS, shape)
    assert [(s.duration_s, s.rate_req_per_s, s.mix, s.one_shot_fraction)
            for s in st] == [(s.duration_s, s.rate_req_per_s, s.mix,
                              s.one_shot_fraction) for s in sj]
    assert TS.total_duration_s(st) == JS.total_duration_s(sj)
    assert TS.peak_rate(st) == JS.peak_rate(sj)
    for cap in (TS.MAX_ARRIVALS, 25):
        got = _plain(TS.schedule(st, label=label, seed=seed,
                                 max_arrivals=cap))
        assert got == _plain(JS.schedule(sj, label=label, seed=seed,
                                         max_arrivals=cap))
        assert len(got) <= cap


def test_seed_and_label_move_the_schedule():
    segs = [TS.Segment(10.0, 5.0)]
    base = _plain(TS.schedule(segs, label="x", seed=1))
    assert base and _plain(TS.schedule(segs, label="x", seed=2)) != base
    assert _plain(TS.schedule(segs, label="y", seed=1)) != base


class FakeTime:
    """perf_counter/monotonic/sleep on one injected clock: a sleep moves
    it, nothing waits."""

    def __init__(self):
        self.t = 1000.0
        self._lock = threading.Lock()

    def perf_counter(self):
        return self.t

    monotonic = perf_counter

    def sleep(self, s):
        with self._lock:
            self.t += max(0.0, s)


def _replay(mod, monkeypatch, arrivals, stall_after=None, **kw):
    fake = FakeTime()
    monkeypatch.setattr(mod, "time", fake)
    fired = []
    beats = [0]

    def beat():
        beats[0] += 1
        if stall_after is not None and beats[0] == stall_after:
            fake.sleep(0.30)         # the spawn loop falls behind

    t0 = fake.t
    if "deadline_in" in kw:
        kw["deadline"] = fake.t + kw.pop("deadline_in")
    res = mod.run_schedule(lambda a: fired.append((a.index,
                                                   round(fake.t - t0, 6))),
                           arrivals, beat=beat, join_grace_s=5.0, **kw)
    res.pop("wall_s", None)
    return sorted(fired), res


def _arrivals(mod, times):
    return [mod.Arrival(t_s=t, kind=mod.KIND_CHAT, session="s0", index=i)
            for i, t in enumerate(times)]


@pytest.mark.parametrize("times,stall,kw", [
    ((0.0, 0.10, 0.20), 1, {}),                 # catch-up burst
    ((0.0, 0.25), None, {}),                    # sleeps to the target
    ((0.0, 1.0), None, {"time_scale": 0.1}),    # compressed
    ((0.0, 30.0), None, {"deadline_in": 0.2}),  # truncated
])
def test_run_schedule_matches_jax(monkeypatch, times, stall, kw):
    got = _replay(TS, monkeypatch, _arrivals(TS, times), stall, **dict(kw))
    want = _replay(JS, monkeypatch, _arrivals(JS, times), stall, **dict(kw))
    assert got == want
    fired, res = got
    if stall == 1:
        # Both late arrivals fire at once when the loop wakes, none early.
        assert fired[1][1] == fired[2][1] >= 0.10
    if "deadline_in" in kw:
        assert res["truncated"] is True and res["arrivals"] == 1
    else:
        assert res["arrivals"] == len(times) and res["hung_clients"] == 0
