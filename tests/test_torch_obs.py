"""The port's obs layer against the JAX package's.

The pure modules first: the same sequence of calls on the JAX object and
on the port's must give the same Prometheus text and Markdown document
(``metrics``: the port's help of ``dllm_tenant_device_time_ms_total``
drops the JAX text's history reference, and its document names its own
module: both differences are derived from the registries, not written
here), the same histogram quantiles and nearest ranks, the same span
trees apart from timestamps and durations (``spans``), the same flight
recorder classifications and rings (``recorder``), the same goodput,
violations and incidents for the same injected request times (``slo``)
and the same gauges from the same sampler callback (``sampler``).  The
tick profiler's own tests are in ``test_torch_profiler.py``.

Then the served path: the same scripted chat through the JAX ``Router``
and the port's, each with its own ``Observability(slow_ms=0.0)`` (every
request recorded), on ``tiny_cluster()`` and ``tiny_batched_cluster()``
with the JAX tiers' weights carried over by ``params_from_jax`` (the
pattern of ``test_torch_router.py``): the span-name sequences in the
recorders' trees, the metric families and their label sets, the request,
cache-hit, failover and retry counters and the histograms' counts must
agree.  The state samplers are off on both sides there (their gauges are
timing-bound); a single sample of each is compared by label set.  Both
routers bill the default tenant (the tenant families' label sets
agree).
Last, the port's ``/metrics``, ``/debug/trace`` and ``/stats?debug=1``
through its test client, and the bounded cost ledger and session label.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu import obs as JO
from distributed_llm_tpu.obs import metrics as JM
from distributed_llm_tpu.obs import recorder as JR
from distributed_llm_tpu.obs import sampler as JSA
from distributed_llm_tpu.obs import slo as JSLO
from distributed_llm_tpu.obs import spans as JS
from distributed_llm_tpu.serving.router import Router as JaxRouter
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch import obs as PO
from distributed_llm_tpu_torch.engine import manager as TM
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.obs import metrics as PM
from distributed_llm_tpu_torch.obs import recorder as PR
from distributed_llm_tpu_torch.obs import sampler as PSA
from distributed_llm_tpu_torch.obs import slo as PSLO
from distributed_llm_tpu_torch.obs import spans as PS
from distributed_llm_tpu_torch.serving.app import BASE_CONFIG, create_app
from distributed_llm_tpu_torch.serving.router import Router as TorchRouter


# -- metrics -----------------------------------------------------------------

def _help_fixes():
    """(JAX help, port help) for every family whose help differs."""
    jax_help = {row[2]: row[4] for row in JM.METRIC_REGISTRY}
    port_help = {row[2]: row[4] for row in PM.METRIC_REGISTRY}
    assert set(jax_help) == set(port_help)
    return [(jax_help[n], port_help[n]) for n in sorted(jax_help)
            if jax_help[n] != port_help[n]]


def _port_text(jax_text: str) -> str:
    for old, new in _help_fixes():
        jax_text = jax_text.replace(old, new)
    return jax_text


def test_registry_rows_match_jax():
    assert len(PM.METRIC_REGISTRY) == len(JM.METRIC_REGISTRY)
    for jrow, prow in zip(JM.METRIC_REGISTRY, PM.METRIC_REGISTRY):
        assert jrow[:4] == prow[:4]
    assert PM.BOUNDED_LABELS == JM.BOUNDED_LABELS
    assert PM.DEFAULT_BUCKETS_MS == JM.DEFAULT_BUCKETS_MS
    # One help text differs: the JAX text's reference to its own history.
    assert [p for _, p in _help_fixes()] == [
        dict((r[2], r[4]) for r in PM.METRIC_REGISTRY)[
            "dllm_tenant_device_time_ms_total"]]


def _drive_metrics(mod):
    reg = mod.MetricsRegistry()
    m = mod.ServingMetrics(reg)
    m.requests.labels("hybrid", "nano", "ok").inc()
    m.requests.labels("hybrid", "orin", "error").inc(2)
    m.requests.labels("perf", "none", "degraded").inc()
    m.degraded.inc()
    m.breaker_state.labels("nano").set(mod.breaker_state_value("open"))
    m.breaker_state.labels("orin").set(mod.breaker_state_value("closed"))
    m.breaker_transitions.labels("nano", "half_open").inc()
    for v in (0.3, 1.0, 4.9, 12.5, 180.0, 999.9, 2500.0, 125000.0):
        m.ttft_ms.labels("hybrid").observe(v)
        m.request_ms.labels("perf").observe(v * 1.5)
    m.tbt_ms.labels("token").observe(7.25)
    m.slo_goodput.labels("hybrid", "nano").set(0.8125)
    m.device_time.labels("nano", "hybrid", "s\"1\\x\n").inc(3.5)
    m.cache_hits.labels("response").inc()
    m.tick_phase_p50_g.labels("nano", "decode").set(12.25)
    reg.counter("extra_total", "an extra family", ("a",)).labels("z").inc()
    reg.gauge("extra_gauge", "no labels").set(-1.5)
    return reg, m


def test_render_matches_jax():
    jreg, jm = _drive_metrics(JM)
    preg, pm = _drive_metrics(PM)
    assert preg.render() == _port_text(jreg.render())
    # Re-registration with another shape raises in both.
    for reg in (jreg, preg):
        with pytest.raises(ValueError):
            reg.gauge("dllm_requests_total", "", ("strategy",))
        with pytest.raises(ValueError):
            reg.get("dllm_requests_total").labels("only-one")


def test_render_markdown_matches_jax():
    """The families' table and the label bounds, row for row; the header
    names each package's own module."""
    def body(text):
        return text[text.index("## Metric families"):]

    assert body(PM.render_markdown()) == _port_text(
        body(JM.render_markdown()))
    assert "distributed_llm_tpu_torch/obs/metrics.py" in PM.render_markdown()


@pytest.mark.parametrize("values", [
    [], [5.0], [0.1, 0.2, 0.3], list(np.linspace(0.0, 130000.0, 97)),
    [1.0] * 10 + [50.0] * 5 + [3000.0], list(np.random.default_rng(
        7).lognormal(3.0, 2.0, 500))], ids=lambda v: f"n{len(v)}")
def test_histogram_quantiles_and_nearest_rank_match_jax(values):
    jh, ph = JM.Histogram(), PM.Histogram()
    for v in values:
        jh.observe(float(v))
        ph.observe(float(v))
    assert ph.counts == jh.counts and ph.sum == jh.sum
    for q in (0.0, 0.05, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ph.quantile(q) == jh.quantile(q)
        assert (PM.nearest_rank(values, q) == JM.nearest_rank(values, q))


def test_bounded_labels_and_breaker_values_match_jax():
    jb, pb = JM.BoundedLabels(cap=3), PM.BoundedLabels(cap=3)
    raw = [None, "", "a", "b", "a", "c" * 100, "d", "e", "b"]
    assert [pb.label(r) for r in raw] == [jb.label(r) for r in raw]
    for state in ("closed", "half_open", "open", "weird"):
        assert (PM.breaker_state_value(state)
                == JM.breaker_state_value(state))


# -- spans -------------------------------------------------------------------

def _strip(node):
    """A serialized span tree without its timestamps and durations."""
    if isinstance(node, dict):
        return {k: _strip(v) for k, v in node.items()
                if k not in ("start_ms", "duration_ms", "start_unix",
                             "request_id", "ttft_ms", "tbt_ms", "ts",
                             "seq", "end_unix", "duration_s")}
    if isinstance(node, list):
        return [_strip(v) for v in node]
    return node


def _drive_spans(mod):
    trace = mod.RequestTrace(strategy="hybrid", stream=True)
    with mod.use_trace(trace):
        assert mod.current_trace() is trace
        with mod.span(mod.current_trace(), "route") as sp:
            sp.annotate(device="nano", confidence=0.5)
        with trace.span("dispatch", tier="nano") as disp:
            with disp.span("inner", k=1):
                pass
            disp.event("mark", x=2)
        try:
            with trace.span("prefill", bucket=16):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        mod.event(trace, "failover", failed="nano", to="orin")
        mod.annotate(trace, cache_hit="routing", session="s1")
        for _ in range(3):
            mod.add_token(trace)
        mod.charge(trace, 4.5, 2.0)
        mod.charge(trace, 1.5, 0.5)
    assert mod.current_trace() is None
    # The None-tolerant helpers.
    with mod.span(None, "x") as null:
        null.annotate(a=1)
        null.event("y")
        with null.span("z"):
            pass
    mod.event(None, "e")
    mod.annotate(None, a=1)
    mod.add_token(None)
    mod.charge(None, 1.0)
    trace.finish(ok=False)
    trace.finish(ok=True)                     # the first close wins
    return trace


def test_span_trees_match_jax():
    jt, pt = _drive_spans(JS), _drive_spans(PS)
    assert _strip(pt.to_dict()) == _strip(jt.to_dict())
    assert pt.to_dict()["device_time_ms"] == 6.0
    assert pt.to_dict()["kv_block_ticks"] == 2.5
    assert pt.attrs["ok"] is False and len(pt.token_times) == 3
    assert pt.tbt_ms() is not None and pt.ttft_ms() is not None


@pytest.mark.parametrize("annot", [
    {}, {"ttft_ms": 12.0}, {"ttft_ms": 10.0, "total_ms": 40.0,
                           "gen_tokens": 7},
    {"ttft_ms": 10.0, "total_ms": 40.0, "gen_tokens": 1}])
def test_ttft_tbt_derivation_matches_jax(annot):
    """The same annotations and the same token timeline give the same
    TTFT, mean TBT and per-request p95 TBT."""
    out = []
    for mod in (JS, PS):
        trace = mod.RequestTrace()
        trace.annotate(**annot)
        trace.root.t0 = 100.0
        trace.token_times.extend([100.01, 100.03, 100.04, 100.09])
        out.append((trace.ttft_ms(), trace.tbt_ms(), trace.tbt_p95_ms()))
    assert out[0] == out[1]


# -- recorder ----------------------------------------------------------------

def _drive_recorder(mod, spans_mod):
    rec = mod.FlightRecorder(capacity=3, slow_ms=50.0)
    grid = [rec.classify(ok, deg, dur) for ok in (True, False)
            for deg in (True, False) for dur in (None, 10.0, 50.0, 80.0)]
    off = mod.FlightRecorder(slow_ms=None)
    grid += [off.classify(True, False, 1e9), off.classify(False, False, 1.0)]
    for i in range(5):
        trace = spans_mod.RequestTrace(strategy=f"s{i}")
        trace.finish(ok=i % 2 == 0)
        rec.record("error" if i % 2 else "slow", trace, {"i": i})
    inc = rec.record_incident("overload", {"tier": "nano", "open": True})
    rec.update_incident(inc, open=False, goodput_at_close=0.9)
    return grid, rec


def test_flight_recorder_matches_jax():
    jgrid, jrec = _drive_recorder(JR, JS)
    pgrid, prec = _drive_recorder(PR, PS)
    assert pgrid == jgrid
    assert len(prec) == len(jrec) == 3
    assert prec.recorded_total == jrec.recorded_total == 6
    assert _strip(prec.snapshot()) == _strip(jrec.snapshot())
    assert PR.DEFAULT_CAPACITY == JR.DEFAULT_CAPACITY
    assert PR.INCIDENT_CAPACITY == JR.INCIDENT_CAPACITY


def test_observability_bundle_takes_arguments():
    """The port's knobs are arguments: ``slow_ms`` and the ring size."""
    obs = PO.Observability(slow_ms=5.0, flight_capacity=2)
    assert obs.recorder.slow_ms == 5.0 and obs.recorder.capacity == 2
    assert obs.m.registry is obs.metrics
    assert obs.trace(strategy="x").attrs == {"strategy": "x"}
    default = PO.Observability()
    jdefault = JO.Observability()
    assert default.recorder.slow_ms == jdefault.recorder.slow_ms
    assert default.recorder.capacity == jdefault.recorder.capacity
    assert PO.get_observability() is PO.get_observability(slow_ms=1.0)


# -- slo ---------------------------------------------------------------------

SLO_FEED = (
    # (strategy, tier, ok, ttft, tbt_p95, cache_hit)
    [("hybrid", "nano", True, 100.0, 10.0, False)] * 12
    + [("hybrid", "nano", True, 3000.0, 10.0, False)] * 20
    + [("perf", "orin", True, 10.0, 900.0, False)] * 3
    + [("perf", "orin", False, None, None, False)] * 2
    + [("token", None, True, None, None, True)] * 2
    + [("hybrid", "nano", True, 50.0, 5.0, False)] * 40
)


def _drive_slo(mod, metrics_mod, recorder_mod):
    reg = metrics_mod.MetricsRegistry()
    m = metrics_mod.ServingMetrics(reg)
    rec = recorder_mod.FlightRecorder()
    mon = mod.SLOMonitor({"nano": (2000.0, 200.0), "orin": (None, 200.0)},
                         metrics=m, recorder=rec,
                         timeline=lambda: [{"tiers": {"nano": {
                             "queue_depth": 3}}}])
    verdicts = [mon.record_request(s, t, ok=ok, ttft_ms=tt, tbt_p95_ms=tb,
                                   cache_hit=ch)
                for s, t, ok, tt, tb, ch in SLO_FEED]
    reads = [mon.goodput(), mon.goodput(tier="nano"),
             mon.goodput("perf", "orin"), mon.goodput("x", "y")]
    return verdicts, reads, mon.snapshot(), reg.render(), rec


def test_slo_monitor_matches_jax():
    jv, jreads, jsnap, jtext, jrec = _drive_slo(JSLO, JM, JR)
    pv, preads, psnap, ptext, prec = _drive_slo(PSLO, PM, PR)
    assert pv == jv and preads == jreads
    assert psnap["violations"] == jsnap["violations"] == {
        "error": 2, "ttft": 20, "tbt": 3}
    assert psnap["incidents_total"] == jsnap["incidents_total"] == 1
    assert _strip(psnap) == _strip(jsnap)
    assert ptext == _port_text(jtext)
    assert _strip(prec.snapshot()) == _strip(jrec.snapshot())


# -- sampler -----------------------------------------------------------------

def _collect():
    return {"nano": {"queue_depth": 2, "active_slots": 3, "max_slots": 4,
                     "kv_free_blocks": 17, "draining": False,
                     "decode_tick_p50_ms": 4.5, "profile_coverage": 0.98,
                     "spec_accept_ratio": None,
                     "tick_phases": {"decode": 4.0, "emit": 0.25,
                                     "admit": None}},
            "orin": {"queue_depth": 0, "draining": True}}


def test_sampler_exports_the_same_gauges_as_jax():
    out = []
    for mod, metrics_mod in ((JSA, JM), (PSA, PM)):
        reg = metrics_mod.MetricsRegistry()
        s = mod.SystemStateSampler(_collect,
                                   metrics=metrics_mod.ServingMetrics(reg),
                                   period_s=0.02, capacity=8)
        for _ in range(10):
            s.sample_once()
        assert len(s) == 8 and s.samples_total == 10
        assert [x["tiers"] for x in s.tail(2)] == [_collect()] * 2
        out.append(reg.render())
    assert out[1] == _port_text(out[0])
    assert PSA.DEFAULT_PERIOD_S == JSA.DEFAULT_PERIOD_S
    assert PSA.DEFAULT_CAPACITY == JSA.DEFAULT_CAPACITY


def test_sampler_thread_starts_and_stops():
    s = PSA.SystemStateSampler(_collect, period_s=0.02)
    s.start()
    assert s.running
    s.stop()
    assert not s.running


def test_obs_modules_read_no_environment():
    import ast
    import pathlib

    import distributed_llm_tpu_torch
    root = pathlib.Path(distributed_llm_tpu_torch.__file__).parent
    for path in sorted((root / "obs").glob("*.py")) + [
            root / "utils" / "hbm_budget.py"]:
        tree = ast.parse(path.read_text())
        names = {n.attr if isinstance(n, ast.Attribute) else n.id
                 for n in ast.walk(tree)
                 if isinstance(n, (ast.Attribute, ast.Name))}
        assert not names & {"environ", "getenv"}, path


# -- the served path against the JAX Router ----------------------------------

F32 = {"nano": "nano_test_r32", "orin": "orin_test_r32"}
BASE = {"nano": "nano_test", "orin": "orin_test"}
CHAT = ["hello there", "what is 2+2",
        "Implement a dynamic-programming solution to the knapsack problem "
        "and analyze its complexity",
        "hello there",
        "compare rivers and lakes, what are the trade-offs?"]

# Families the sampler writes (off on both sides here) and the tenant
# families (both routers bill the default tenant).
SAMPLED = {row[2] for row in PM.METRIC_REGISTRY if row[0].endswith("_g")}
TENANT = {row[2] for row in PM.METRIC_REGISTRY
          if row[2].startswith("dllm_tenant_")}


# SLO targets every generating request misses on TTFT, on both sides:
# the verdicts (and the ``dllm_slo_violations_total`` family they feed)
# then follow from the requests served, not from how fast a loaded host
# served them (at the 2000 / 200 ms defaults a slow worker's port tier
# could miss its TBT target where the JAX tier met it).
STRICT_SLO = dict(slo_ttft_ms=0.0, slo_tbt_ms=None)


def _cluster(pkg, batched: bool, tiers=None, **over):
    base = pkg.tiny_batched_cluster() if batched else pkg.tiny_cluster()
    tiers = tiers or {}
    return dataclasses.replace(
        base,
        nano=dataclasses.replace(base.nano, model_preset=F32["nano"],
                                 **tiers),
        orin=dataclasses.replace(base.orin, model_preset=F32["orin"], tp=1,
                                 **tiers),
        **over)


@pytest.fixture(scope="module")
def make_routers():
    """(jax_router, port_router, jax_obs, port_obs) over the same cluster
    and weights, each with its own registry recording every request."""
    built = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLLM_OBS_SAMPLE_MS", "0")
        for pkg in (jax_config, torch_config):
            for tier, name in F32.items():
                mp.setitem(pkg.MODEL_PRESETS, name, dataclasses.replace(
                    pkg.MODEL_PRESETS[BASE[tier]], name=name,
                    dtype="float32"))
        trees = {}
        real = {"ContinuousBatchingEngine": TM.ContinuousBatchingEngine,
                "InferenceEngine": TM.InferenceEngine}

        def with_weights(cls):
            def build(tier, seed=0, device=None):
                if tier.model_preset not in trees:   # not a JAX pair's tier
                    return cls(tier, seed=seed, device=device)
                return cls(tier, seed=seed, device=device,
                           params=params_from_jax(tier.model(),
                                                  trees[tier.model_preset]))
            return build

        for name, cls in real.items():
            mp.setattr(TM, name, with_weights(cls))

        def build(batched: bool, benchmark_mode: bool, strategy="hybrid",
                  tiers=None, **over):
            kw = dict(strategy=strategy, benchmark_mode=benchmark_mode,
                      config=(None if benchmark_mode else dict(
                          jax_config.PRODUCTION_CFG, **BASE_CONFIG)))
            jobs, pobs = JO.Observability(slow_ms=0.0), PO.Observability(
                slow_ms=0.0)
            jr = JaxRouter(cluster=_cluster(jax_config, batched, tiers,
                                            **over),
                           observability=jobs, **kw)
            tr = TorchRouter(cluster=_cluster(torch_config, batched, tiers,
                                              **over),
                             device="cpu", observability=pobs, sample_ms=0,
                             **kw)
            built.append((jr, tr))
            for name in ("nano", "orin"):
                for r in (jr, tr):
                    r.tiers[name].server_manager.warmup_on_start = False
                engine = jr.tiers[name].server_manager.engine()
                trees[F32[name]] = jax.tree.map(np.asarray, engine.params)
                tr.tiers[name].server_manager.engine()   # both started
            return jr, tr, jobs, pobs

        yield build
        for jr, tr in built:
            tr.drain(timeout_s=5)
            jr.drain(timeout_s=5)


def _families(obs, skip=()):
    """{family: {label tuples}} of the families with children."""
    out = {}
    for name, fam in obs.metrics._families.items():
        kids = fam.children()
        if name in skip or not kids or (not fam.label_names and (
                fam.kind != "histogram" and fam.value == 0)):
            continue
        out[name] = set(kids)
    return out


def _value(obs, name):
    fam = obs.metrics.get(name)
    out = {}
    for key, child in fam.children().items():
        out[key] = child.count if fam.kind == "histogram" else child.value
    return out


def _span_names(obs):
    """The recorder's trees as name sequences, oldest request first."""
    def names(node):
        return [node["name"]] + [n for c in node.get("children", ())
                                 for n in names(c)]
    return [names(e["trace"]["spans"]) for e in
            reversed(obs.recorder.snapshot()) if "trace" in e]


def _chat(router, stream: bool):
    history = []
    for i, message in enumerate(CHAT):
        history = history + [{"role": "user", "content": message}]
        if stream and i % 2:
            routed = router.route_query_stream(history,
                                               session_id=f"s{i % 2}")
            reply = "".join(routed)
        else:
            reply = router.route_query(history, session_id=f"s{i % 2}")[0][
                "response"]
        history = history + [{"role": "assistant", "content": reply}]


@pytest.mark.parametrize("batched", [False, True],
                         ids=["sequential", "batched"])
@pytest.mark.parametrize("benchmark_mode", [True, False],
                         ids=["benchmark", "production"])
def test_served_observability_matches_jax(make_routers, batched,
                                          benchmark_mode):
    jr, tr, jobs, pobs = make_routers(batched, benchmark_mode,
                                      tiers=STRICT_SLO)
    for r in (jr, tr):
        _chat(r, stream=True)
        r.query_router.change_strategy("token")
        r.route_query([{"role": "user", "content": "a short one"}],
                      session_id="s9")
    assert _span_names(pobs) == _span_names(jobs)
    assert _families(pobs, SAMPLED) == _families(jobs, SAMPLED)
    for name in ("dllm_requests_total", "dllm_cache_hits_total",
                 "dllm_failovers_total", "dllm_retries_total",
                 "dllm_flight_records_total", "dllm_ttft_ms", "dllm_tbt_ms",
                 "dllm_request_ms", "dllm_queue_wait_ms"):
        assert _value(pobs, name) == _value(jobs, name), name
    # The batched engines bill device time per (tier, strategy, session).
    billed = _value(pobs, "dllm_device_time_ms_total")
    assert bool(billed) == batched
    assert set(billed) == set(_value(jobs, "dllm_device_time_ms_total"))
    assert all(v > 0 for v in billed.values())
    assert {r["session"] for r in tr.cost_snapshot()} == (
        {"s0", "s1", "s9"} if batched else set())
    assert tr.slo.snapshot()["observed_total"] == jr.slo.snapshot()[
        "observed_total"] == len(CHAT) + 1
    violations = _value(pobs, "dllm_slo_violations_total")
    assert violations and violations == _value(jobs,
                                               "dllm_slo_violations_total")
    # Both routers bill the default tenant (no tenant_id was given).
    billed = _families(pobs).get("dllm_tenant_device_time_ms_total", set())
    assert bool(billed) == batched
    assert all(key[-1] == "default" for key in billed)
    assert _families(pobs).keys() & TENANT


def test_one_sample_matches_jax_by_label_set(make_routers):
    jr, tr, jobs, pobs = make_routers(True, True)
    for r in (jr, tr):
        r.route_query([{"role": "user", "content": "hello"}])
    js = JSA.SystemStateSampler(jr._sampler_collect, metrics=jobs.m)
    ps = PSA.SystemStateSampler(tr._sampler_collect, metrics=pobs.m)
    jsample, psample = js.sample_once(), ps.sample_once()
    assert set(psample["tiers"]) == set(jsample["tiers"]) == {"nano", "orin"}
    for tier in ("nano", "orin"):
        assert set(psample["tiers"][tier]) <= set(jsample["tiers"][tier])
    sampled = SAMPLED - {"dllm_tick_phase_p50_ms"}
    got = {k: v for k, v in _families(pobs).items() if k in sampled}
    want = {k: v for k, v in _families(jobs).items() if k in sampled}
    assert got.keys() <= want.keys()
    assert {k: want[k] for k in got} == got
    assert tr.timeline_snapshot() == []          # no sampler: sample_ms=0


def test_failover_and_retry_counters_match_jax(make_routers):
    jr, tr, jobs, pobs = make_routers(False, True, strategy="token",
                                      breaker_failures=2,
                                      breaker_cooldown_s=600.0,
                                      retry_attempts=1,
                                      retry_backoff_s=0.0)
    calls = []
    for r in (jr, tr):
        n = {"n": 0}

        def process(history, n=n):
            n["n"] += 1
            return {"error": "Request failed: connection reset (stub)"}

        r.tiers["nano"].process = process
        calls.append(n)
    q = [{"role": "user", "content": "hello"}]
    for _ in range(3):
        for r in (jr, tr):
            r.route_query(q)
    assert calls[0] == calls[1]
    for name in ("dllm_failovers_total", "dllm_retries_total",
                 "dllm_breaker_transitions_total", "dllm_breaker_state",
                 "dllm_requests_total"):
        assert _value(pobs, name) == _value(jobs, name), name
    assert _span_names(pobs) == _span_names(jobs)


# -- the port's app ----------------------------------------------------------

@pytest.fixture(scope="module")
def served_app():
    obs = PO.Observability(slow_ms=0.0)
    router = TorchRouter(strategy="heuristic", benchmark_mode=True,
                         cluster=torch_config.tiny_batched_cluster(),
                         device="cpu", observability=obs)
    for tier in router.tiers.values():
        tier.server_manager.warmup_on_start = False
    client = create_app(router=router).test_client()
    for i in range(3):
        resp = client.post("/chat", json={"message": f"hi question {i}",
                                          "strategy": "heuristic",
                                          "session_id": f"sess{i % 2}"})
        assert resp.status_code == 200
    stream = client.post("/chat/stream", json={
        "message": "tell me about lakes", "strategy": "heuristic",
        "session_id": "sess1"})
    assert "done" in stream.text
    yield client, router, obs
    router.drain(timeout_s=5)


def test_metrics_endpoint(served_app):
    client, _router, _obs = served_app
    resp = client.get("/metrics")
    assert resp.status_code == 200
    text = resp.text
    assert "# TYPE dllm_requests_total counter" in text
    assert 'dllm_requests_total{strategy="heuristic",tier="nano",' \
           'outcome="ok"}' in text
    assert "dllm_ttft_ms_count" in text
    assert 'session="sess0"' in text and 'session="sess1"' in text
    for line in text.splitlines():
        assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2


def test_debug_trace_endpoint(served_app):
    client, _router, _obs = served_app
    doc = json.loads(client.get("/debug/trace").text)
    events = doc["traceEvents"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names == {"tier:nano"}        # orin served nothing here
    assert any(e["name"] == "decode" and e["ph"] == "X" for e in events)
    assert any(e["name"] == "compile" and e["ph"] == "i" for e in events)


def test_stats_debug_carries_obs_keys(served_app):
    client, router, obs = served_app
    stats = client.get("/stats?debug=1&timeline=1").get_json()
    assert {"slo", "cost", "flight_recorder", "flight_recorded_total",
            "timeline", "timeline_meta", "devices"} <= set(stats)
    assert stats["slo"]["observed_total"] == 4
    assert stats["flight_recorded_total"] == 4      # slow_ms=0: every one
    rows = stats["cost"]
    costs = [r["device_time_ms"] for r in rows]
    assert costs == sorted(costs, reverse=True) and costs[0] > 0
    assert {r["session"] for r in rows} == {"sess0", "sess1"}
    entry = stats["flight_recorder"][0]
    assert entry["trace"]["device_time_ms"] > 0
    assert stats["timeline"] and "nano" in stats["timeline"][-1]["tiers"]
    assert stats["tiers"]["nano"]["profile"]["enabled"] is True
    plain = client.get("/stats").get_json()
    assert "flight_recorder" not in plain and "timeline" not in plain


def test_cost_ledger_is_bounded():
    r = TorchRouter.__new__(TorchRouter)        # ledger methods only
    r._cost_lock = threading.Lock()
    r._cost_ledger = {}
    r._cost_ledger_cap = 8
    for i in range(50):
        r._note_cost("nano", "perf", f"s{i}", "default", 1.0, 2.0)
    assert len(r._cost_ledger) == 8
    rows = r.cost_snapshot()
    assert {row["session"] for row in rows} == {f"s{i}"
                                                for i in range(42, 50)}
    r._note_cost("nano", "perf", "s45", "default", 5.0, 0.0)
    assert r.cost_snapshot()[0] == {
        "tier": "nano", "strategy": "perf", "session": "s45",
        "tenant": "default", "device_time_ms": 6.0, "kv_block_ticks": 2.0,
        "requests": 2}


def test_session_metric_label_is_bounded():
    """session_id is client-controlled: past 256 distinct sessions the
    router's labels aggregate under '~overflow', and ids truncate."""
    r = TorchRouter(strategy="token", benchmark_mode=True,
                    cluster=torch_config.tiny_batched_cluster(),
                    device="cpu", sample_ms=0)
    labels = r._session_labels
    assert labels.label(None) == labels.label("") == "-"
    assert labels.label("x" * 500) == "x" * 64
    got = {labels.label(f"s{i}") for i in range(300)}
    assert len(got) == 256 and "~overflow" in got
    assert labels.label("s2") == "s2"


def test_manager_counts_wedges_and_drained_requests():
    """The managers' counters go to the process-global registry: one
    wedge per rising edge of the decode watchdog (not per probe), and the
    requests a drain completed."""
    from distributed_llm_tpu_torch.engine.manager import EngineManager

    class Stalled:
        stall = 10.0
        pending = [2, 1, 0, 0]

        def progress_stall_s(self):
            return self.stall

        def pending_work(self):
            return self.pending.pop(0) if len(self.pending) > 1 else 0

    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               name="wedge_t", watchdog_stall_s=1.0)
    mgr = EngineManager(tier, device="cpu")
    mgr._engine = engine = Stalled()
    m = PO.get_observability().m
    wedged = m.watchdog_wedged.labels("wedge_t")
    for _ in range(3):
        assert mgr.health()["wedged"] is True
    assert wedged.value == 1
    engine.stall = 0.0
    assert "wedged" not in mgr.health()
    engine.stall = 10.0
    mgr.health()
    assert wedged.value == 2
    summary = mgr.drain(timeout_s=5)
    assert summary["drained"] == 2
    assert m.drained_requests.labels("wedge_t").value == 2
