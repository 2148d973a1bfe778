"""The port's tick-phase profiler against the JAX package's, and its use
by the port's batched engine.

The profiler module: the same stamps give records of the same shape
(span names in order, self-time within duration, lifetime totals past the
ring's bound), the null profiler behaves as the JAX one, and
``chrome_trace`` of the same synthetic snapshot is identical.

The engine (tiny batched tiers on the CPU, no card): four traced requests
on one engine stamp the JAX engine's phases (the same phase names as the
JAX engine serving the same requests), the stamped self-time covers at
least 95% of the tick wall and the requests' attributed device time adds
up to the decode phases' within 5% (as the JAX package's own tests pin
them); compile events land on the timeline; warmup records nothing; a
speculative round stamps one ``verify`` phase; ``profile=False`` charges
nothing; the engine's metrics reach the process-global registry; a
sequential tier has no profiler, so ``profiler_trace`` is empty for it.
No test here bounds a wall-clock time.
"""

from __future__ import annotations

import dataclasses
import json
import time

import pytest

from distributed_llm_tpu.config import tiny_batched_cluster as jax_tiny
from distributed_llm_tpu.obs import profiler as JP
from distributed_llm_tpu.obs.spans import RequestTrace as JaxTrace
from distributed_llm_tpu.obs.spans import use_trace as jax_use_trace
from distributed_llm_tpu_torch.config import tiny_batched_cluster, tiny_cluster
from distributed_llm_tpu_torch.engine.batching import ContinuousBatchingEngine
from distributed_llm_tpu_torch.obs import get_observability
from distributed_llm_tpu_torch.obs import profiler as P
from distributed_llm_tpu_torch.obs.spans import RequestTrace, use_trace

PROMPTS = [f"profiled question {i}" for i in range(4)]


# -- the profiler module -----------------------------------------------------

def _stamp(prof):
    with prof.phase("admit"):
        time.sleep(0.002)
        with prof.phase("prefill"):
            time.sleep(0.003)
    with prof.phase("decode"):
        pass
    prof.event("compile", stage="decode", key="16")
    prof.commit(slots=2)
    prof.commit(0)                           # nothing stamped: no record
    for _ in range(40):
        with prof.phase("decode"):
            pass
        with prof.phase("emit"):
            pass
        prof.commit(1)
    return prof


def _shape(prof):
    recs = prof.records()
    for rec in recs:
        for _name, rel, dur, self_ms in rec["spans"]:
            assert rel >= 0 and 0 <= self_ms <= dur + 1e-9
        assert sum(s[3] for s in rec["spans"]) <= rec["dur_ms"] * 1.001
    st = prof.phase_stats()
    return {
        "records": [(r["seq"], r["slots"], [s[0] for s in r["spans"]])
                    for r in recs],
        "events": [(e[0], e[2]) for e in prof.events()],
        "ticks": st["ticks"], "phases": sorted(st["phases"]),
        "n": {k: v["n"] for k, v in st["phases"].items()},
        "totals": {k: v["n"] for k, v in st["totals"].items()},
        "summary": sorted(prof.summary()),
        "snapshot": sorted(prof.snapshot()),
    }


def test_records_match_jax():
    jp, pp = _stamp(JP.TickProfiler("t", capacity=16)), _stamp(
        P.TickProfiler("t", capacity=16))
    assert _shape(pp) == _shape(jp)
    assert len(pp.records()) == 16                   # the ring's bound
    assert pp.phase_stats()["totals"]["decode"]["n"] == 41
    assert P.PHASES == JP.PHASES
    assert (P.DEFAULT_CAPACITY, P.EVENT_CAPACITY) == (
        JP.DEFAULT_CAPACITY, JP.EVENT_CAPACITY)


def test_parent_self_time_excludes_its_child():
    prof = P.TickProfiler("t")
    with prof.phase("admit"):
        time.sleep(0.002)
        with prof.phase("prefill"):
            time.sleep(0.003)
    prof.commit(1)
    spans = {s[0]: s for s in prof.records()[0]["spans"]}
    assert spans["admit"][3] < spans["prefill"][2] < spans["admit"][2]
    assert spans["prefill"][2] == pytest.approx(spans["prefill"][3])


def test_null_profiler_matches_jax():
    prof = P.make_profiler("nano", enabled=False)
    assert prof is P.NULL_PROFILER and prof.enabled is False
    assert prof.phase("decode") is prof.phase("emit")
    with prof.phase("decode"):
        prof.event("compile", stage="decode")
    prof.commit(4)
    for name in ("records", "events", "snapshot", "phase_stats", "summary"):
        assert getattr(prof, name)() == getattr(JP.NULL_PROFILER, name)()
    live = P.make_profiler("nano", capacity=64)
    assert live.enabled and live.capacity == 64 and live.tier == "nano"


def _snapshot(t0: float):
    return {
        "records": [
            {"seq": 1, "t0": t0, "dur_ms": 12.5, "slots": 3,
             "spans": [("admit", 0.0, 4.0, 1.5), ("prefill", 0.5, 2.5, 2.5),
                       ("decode", 4.25, 8.0, 8.0)]},
            {"seq": 2, "t0": t0 + 0.02, "dur_ms": 9.0, "slots": 3,
             "spans": [("table_upload", 0.0, 0.125, 0.125),
                       ("decode", 0.25, 8.5, 8.5), ("emit", 8.75, 0.2, 0.2)]},
        ],
        "events": [("compile", t0 - 0.5, {"stage": "decode", "key": "4"}),
                   ("host_sync", t0 + 0.001, None)],
    }


def test_chrome_trace_matches_jax():
    by_tier = {"orin": _snapshot(1000.0), "nano": _snapshot(1000.004)}
    got = P.chrome_trace(by_tier)
    assert got == JP.chrome_trace(by_tier)
    assert json.loads(json.dumps(got)) == got
    assert P.chrome_trace({}) == JP.chrome_trace({}) == {
        "traceEvents": [], "displayTimeUnit": "ms"}


# -- the engine ----------------------------------------------------------------

def _serve(engine, trace_cls, bind):
    traces, reqs = [], []
    for prompt in PROMPTS:
        tr = trace_cls(strategy="t")
        traces.append(tr)
        with bind(tr):
            reqs.append(engine.submit(prompt, max_new_tokens=8))
    for r in reqs:
        r.done.wait(timeout=120)
        assert r.error is None, r.error
    return traces


@pytest.fixture(scope="module")
def profiled():
    """One port engine and one JAX engine that served the same traced
    requests: yields (port engine, its traces, the JAX engine's phase
    names)."""
    from distributed_llm_tpu.engine.batching import (
        ContinuousBatchingEngine as JaxEngine)
    jeng = JaxEngine(jax_tiny().nano, seed=3)
    eng = ContinuousBatchingEngine(tiny_batched_cluster().nano, seed=3,
                                   device="cpu")
    try:
        _serve(jeng, JaxTrace, jax_use_trace)
        jax_phases = set(jeng.profiler.phase_stats()["phases"])
        traces = _serve(eng, RequestTrace, use_trace)
        yield eng, traces, jax_phases
    finally:
        jeng.stop()
        eng.stop()


def test_engine_stamps_the_jax_phases(profiled):
    eng, _, jax_phases = profiled
    st = eng.profiler.phase_stats()
    assert set(st["phases"]) == jax_phases
    assert set(st["phases"]) <= set(P.PHASES)
    assert st["ticks"] >= 1


def test_engine_phase_breakdown_covers_tick_wall(profiled):
    eng, _, _ = profiled
    st = eng.profiler.phase_stats()
    assert st["coverage"] >= 0.95, st
    assert any(name == "compile" for name, _t, _a in eng.profiler.events())
    assert any(name == "host_sync" for name, _t, _a in eng.profiler.events())


def test_attribution_conservation_and_kv_ticks(profiled):
    eng, traces, _ = profiled
    attributed = sum(tr.device_time_ms for tr in traces)
    decode_total = eng.profiler.total_ms("decode")
    assert decode_total > 0
    assert attributed == pytest.approx(decode_total, rel=0.05)
    assert all(tr.device_time_ms > 0 and tr.kv_block_ticks > 0
               for tr in traces)
    d = traces[0].to_dict()
    assert d["device_time_ms"] > 0 and d["kv_block_ticks"] > 0
    names = [c["name"] for c in d["spans"]["children"]]
    assert names == ["prefill", "detokenize"]
    assert traces[0].attrs["queue_wait_ms"] >= 0
    assert "prefill_wait_ms" in traces[0].attrs
    assert len(traces[0].token_times) == 8


def test_chrome_trace_of_the_engine(profiled):
    eng, _, _ = profiled
    doc = json.loads(json.dumps(P.chrome_trace(
        {"nano": eng.profiler.snapshot()})))
    events = doc["traceEvents"]
    ticks = [e for e in events if e["ph"] == "X" and e["name"] == "tick"]
    assert ticks
    assert [t["ts"] for t in ticks] == sorted(t["ts"] for t in ticks)
    for ph in (e for e in events if e["ph"] == "X" and e["name"] != "tick"):
        assert any(t["ts"] - 1 <= ph["ts"]
                   and ph["ts"] + ph["dur"] <= t["ts"] + t["dur"] + 1
                   for t in ticks), ph


def test_engine_metrics_reach_the_global_registry():
    m = get_observability().m
    tier = dataclasses.replace(tiny_batched_cluster().nano, name="metrics_t",
                               attention_ragged=False)
    eng = ContinuousBatchingEngine(tier, seed=1, device="cpu")
    try:
        eng.generate("count my ticks", max_new_tokens=6)
        eng.generate("count my ticks", max_new_tokens=6)   # a prefix hit
        ticks = m.decode_tick_ms.labels("metrics_t")
        assert ticks.count == eng.ticks_total > 0
        assert m.decode_ticks.labels("metrics_t", "paged_decode",
                                     "xla").value == eng.ticks_total
        assert m.compiled_programs.labels("metrics_t", "decode").value == len(
            eng.tick_stats()["compiled"]["decode"])
        hits = {k: m.prefix_hits.labels("metrics_t", k).value
                for k in ("miss", "shared", "exclusive")}
        assert hits["miss"] == 1 and hits["shared"] + hits["exclusive"] == 1
    finally:
        eng.stop()


def test_warmup_is_not_recorded():
    eng = ContinuousBatchingEngine(
        dataclasses.replace(tiny_batched_cluster().nano,
                            attention_ragged=False), seed=2, device="cpu")
    try:
        eng.warmup()
        assert eng.profiler.records() == []
        assert [e[2]["stage"] for e in eng.profiler.events()
                if e[0] == "compile"] == ["decode", "decode"]
        tr = RequestTrace()
        with use_trace(tr):
            eng.generate("after warmup", max_new_tokens=4)
        assert eng.profiler.phase_stats()["ticks"] >= 1
        assert tr.device_time_ms == pytest.approx(
            eng.profiler.total_ms("decode"), rel=0.05)
    finally:
        eng.stop()


def test_speculative_round_stamps_one_verify_phase():
    base = tiny_batched_cluster().nano
    tier = dataclasses.replace(base, draft_preset=base.model_preset,
                               spec_decode=True)
    eng = ContinuousBatchingEngine(tier, seed=4, device="cpu")
    try:
        assert eng.spec
        tr = RequestTrace()
        with use_trace(tr):
            eng.generate("speculate for me", max_new_tokens=8)
        phases = set(eng.profiler.phase_stats()["phases"])
        assert "verify" in phases and "draft" not in phases
        assert tr.device_time_ms == pytest.approx(
            eng.profiler.total_ms("verify")
            + eng.profiler.total_ms("decode"), rel=0.05)
    finally:
        eng.stop()


def test_engine_off_path_charges_nothing():
    eng = ContinuousBatchingEngine(tiny_batched_cluster().nano, seed=5,
                                   device="cpu", profile=False)
    try:
        assert eng.profiler is P.NULL_PROFILER
        tr = RequestTrace(strategy="t")
        with use_trace(tr):
            req = eng.submit("hello off path", max_new_tokens=4)
        req.done.wait(timeout=120)
        assert req.error is None
        assert eng.profiler.records() == []
        assert tr.device_time_ms == 0.0 and tr.kv_block_ticks == 0.0
        assert "device_time_ms" not in tr.to_dict()
        assert eng.tick_stats()["ticks"] >= 1
    finally:
        eng.stop()


def test_profiler_capacity_is_an_argument():
    eng = ContinuousBatchingEngine(tiny_batched_cluster().nano, seed=6,
                                   device="cpu", profile_ticks=20)
    try:
        assert eng.profiler.capacity == 20
    finally:
        eng.stop()


def test_sequential_tier_has_no_profiler():
    from distributed_llm_tpu_torch.serving.router import Router
    router = Router(strategy="token", benchmark_mode=True,
                    cluster=tiny_cluster(), device="cpu", sample_ms=0)
    try:
        for tier in router.tiers.values():
            tier.server_manager.warmup_on_start = False
        router.route_query([{"role": "user", "content": "hello"}])
        assert router.tiers["nano"].server_manager.engine() is not None
        assert router.profiler_trace() == {"traceEvents": [],
                                           "displayTimeUnit": "ms"}
        assert "profile" not in router.tiers["nano"].server_manager.health()
        assert router.cost_snapshot() == []
    finally:
        router.drain(timeout_s=5)
