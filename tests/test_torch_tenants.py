"""Tenant quotas in the port against the JAX package.

- ``TenantQuotas`` (serving/tenants.py): one scripted sequence of
  admissions, releases, debits and clock steps gives the same verdicts,
  reasons, retry hints, bucket levels and snapshots in both packages;
  ``default_quota``'s arguments are JAX's ``DLLM_TENANT_*`` variables.
- The engine's scheduling (engine/batching.py): the deficit-weighted
  round-robin admission order for one arrival interleaving, quotas-off
  FIFO, the tenant γ cap, the over-budget eviction first pass and the
  most-over-budget preemption victim, each the JAX engine's.
- Greedy tokens on a float32 ``nano_test`` (the same seeded weights in
  both packages): quotas off, non-binding quotas on and the JAX engine
  give the same token ids, exactly.
- The serving edge: the tier client's tenant refusal has JAX's text and
  retry hint; ``tenant_id`` validation, billing, the over-quota incident,
  the ``/stats`` tenant rows and the tenant metric families on the
  port's served router.
"""

from __future__ import annotations

import dataclasses
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import batching as JB
from distributed_llm_tpu.serving import tenants as JT
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching as TB
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.serving import tenants as TT

PRESET = "nano_test_f32_tenants"
PROBES = ("tell me about rivers and lakes and streams and oceans please",
          "what is the tallest mountain on the continent of asia today")


@pytest.fixture(autouse=True)
def _no_tenant_env(monkeypatch):
    """JAX's default quota reads the environment; the port's takes
    arguments.  The parity cases run with the variables unset."""
    for var in ("DLLM_TENANT_MAX_INFLIGHT", "DLLM_TENANT_MAX_QUEUED",
                "DLLM_TENANT_DEVICE_MS_PER_S", "DLLM_TENANT_KV_BLOCKS",
                "DLLM_TENANT_GAMMA_MAX"):
        monkeypatch.delenv(var, raising=False)


def _tiers(quotas_j, quotas_t, **kw):
    base = dict(decode_batch=2, max_new_tokens=8)
    base.update(kw)
    return (dataclasses.replace(jax_config.tiny_cluster().nano,
                                tenant_quotas=quotas_j, **base),
            dataclasses.replace(torch_config.tiny_cluster().nano,
                                tenant_quotas=quotas_t, **base))


def _both(**quota_kw):
    """{tenant: TenantQuota} in each package, from plain field dicts."""
    return ({t: jax_config.TenantQuota(**f) for t, f in quota_kw.items()},
            {t: torch_config.TenantQuota(**f) for t, f in quota_kw.items()})


# -- the registry --------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_tenant_quota_fields_are_jaxs():
    jf = {f.name: f.default for f in dataclasses.fields(jax_config.TenantQuota)}
    tf = {f.name: f.default
          for f in dataclasses.fields(torch_config.TenantQuota)}
    assert jf == tf


# One script: (op, tenant, arg).  "tick" advances the shared clock.
SCRIPT = [
    ("admit", "a", None), ("admit", "a", None), ("admit", "a", None),
    ("release", "a", None), ("admit", "a", None), ("admit", "b", None),
    ("admit", "r", None), ("debit", "r", 500.0), ("release", "r", None),
    ("admit", "r", None), ("retry", "r", None), ("tick", None, 1.5),
    ("retry", "r", None), ("admit", "r", None), ("tick", None, 2.0),
    ("admit", "r", None), ("debit", "r", 50.0), ("release", "r", None),
    ("admit", "k", 4.0), ("admit", "k", 4.5), ("admit", "k", None),
    ("debit", "b", 1e9), ("admit", "b", None), ("retry", "b", None),
    ("retry", "a", None), ("release", "k", None), ("release", "k", None),
    ("tick", None, 30.0), ("admit", "r", None), ("retry", "r", None),
    ("debit", "burst", 10.0), ("admit", "burst", None),
    ("debit", "burst", 400.0), ("admit", "burst", None),
    ("retry", "burst", None),
]


def test_registry_decisions_and_buckets_match_jax():
    qj, qt = _both(a={"max_inflight": 1, "max_queued": 1},
                   r={"device_ms_per_s": 100.0},
                   k={"kv_blocks": 4},
                   burst={"device_ms_per_s": 20.0, "device_ms_burst": 300.0})
    tj, tt = _tiers(qj, qt)
    cj, ct = Clock(), Clock()
    reg_j, reg_t = JT.TenantQuotas(tj, now=cj), TT.TenantQuotas(tt, now=ct)
    for op, tenant, arg in SCRIPT:
        if op == "tick":
            cj.t += arg
            ct.t += arg
            continue
        if op == "admit":
            got = (reg_j.try_admit(tenant, kv_bill=arg),
                   reg_t.try_admit(tenant, kv_bill=arg))
        elif op == "release":
            got = (reg_j.release(tenant), reg_t.release(tenant))
        elif op == "debit":
            got = (reg_j.debit(tenant, arg), reg_t.debit(tenant, arg))
        else:
            got = (reg_j.retry_after_s(tenant), reg_t.retry_after_s(tenant))
        assert got[0] == got[1], (op, tenant, arg, got)
        assert reg_j.snapshot() == reg_t.snapshot(), (op, tenant, arg)
    for t in ("a", "b", "r", "k", "burst", "nobody"):
        assert reg_j.weight(t) == reg_t.weight(t)
        assert reg_j.gamma_cap(t) == reg_t.gamma_cap(t)
        assert reg_j.kv_budget(t) == reg_t.kv_budget(t)
    assert reg_t.snapshot()["rejected"] > 0


@pytest.mark.parametrize("env", [
    {},
    {"DLLM_TENANT_MAX_INFLIGHT": "2", "DLLM_TENANT_DEVICE_MS_PER_S": "50.5"},
    {"DLLM_TENANT_MAX_QUEUED": "3", "DLLM_TENANT_KV_BLOCKS": "7",
     "DLLM_TENANT_GAMMA_MAX": "1"},
    {"DLLM_TENANT_MAX_INFLIGHT": "0"},
])
def test_default_quota_arguments_are_jaxs_env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    names = {"DLLM_TENANT_MAX_INFLIGHT": ("max_inflight", int),
             "DLLM_TENANT_MAX_QUEUED": ("max_queued", int),
             "DLLM_TENANT_DEVICE_MS_PER_S": ("device_ms_per_s", float),
             "DLLM_TENANT_KV_BLOCKS": ("kv_blocks", int),
             "DLLM_TENANT_GAMMA_MAX": ("spec_gamma_max", int)}
    kwargs = {names[k][0]: names[k][1](v) for k, v in env.items()}
    assert (dataclasses.asdict(TT.default_quota(**kwargs))
            == dataclasses.asdict(JT.default_quota()))
    assert TT.DEFAULT_TENANT == JT.DEFAULT_TENANT


# -- the engine's scheduling -----------------------------------------------------

def _bare(cls, quotas, default_q, spec_gamma_max=4):
    """An engine object with only the scheduler's queue state (never
    built, never started): the admission order is a host algorithm."""
    import queue
    from collections import deque
    eng = object.__new__(cls)
    eng._head = deque()
    eng._queue = queue.Queue()
    eng._tenant_quotas = None if quotas is None else dict(quotas)
    eng._tenant_default_q = None if quotas is None else default_q
    eng._tenant_lanes = {}
    eng._tenant_deficits = {}
    eng.spec_gamma_max = spec_gamma_max
    return eng


def _order(eng, tenants):
    for i, t in enumerate(tenants):
        eng._queue.put(SimpleNamespace(tenant=t, i=i))
    out = []
    while True:
        req = eng._next_request()
        if req is None:
            return out
        out.append((req.tenant, req.i))


@pytest.mark.parametrize("weights,arrivals", [
    ({"a": 2.0, "b": 1.0}, ["a"] * 4 + ["b"] * 2),
    ({"a": 1.0, "b": 1.0}, ["b", "a", "b", "a", "a", "b"]),
    ({"flood": 0.25}, ["flood"] * 6 + [None, "quiet", None, "quiet"]),
    ({"x": 3.0, "y": 0.5, "z": 1.0},
     ["z", "y", "x", "x", "y", "z", "x", "y", "x", "z", "z", "y"]),
    ({"tiny": 1e-9}, ["tiny", "other", "tiny"]),
])
def test_dwrr_admission_order_matches_jax(weights, arrivals):
    qj, qt = _both(**{t: {"weight": w} for t, w in weights.items()})
    ej = _bare(JB.ContinuousBatchingEngine, qj, JT.default_quota())
    et = _bare(TB.ContinuousBatchingEngine, qt, TT.default_quota())
    want = _order(ej, arrivals)
    assert _order(et, arrivals) == want
    assert len(want) == len(arrivals)
    # Replayed, the same arrivals give the same order.
    assert _order(et, arrivals) == _order(ej, arrivals)


def test_quotas_off_queue_is_fifo_like_jax():
    arrivals = ["b", "a", "b", None, "a"]
    ej = _bare(JB.ContinuousBatchingEngine, None, None)
    et = _bare(TB.ContinuousBatchingEngine, None, None)
    assert _order(et, arrivals) == _order(ej, arrivals) == [
        (t, i) for i, t in enumerate(arrivals)]
    assert et._tenant_lanes == {}


def test_gamma_cap_matches_jax():
    qj, qt = _both(capped={"spec_gamma_max": 2},
                   banned={"spec_gamma_max": 0},
                   over={"spec_gamma_max": 9})
    ej = _bare(JB.ContinuousBatchingEngine, qj, JT.default_quota())
    et = _bare(TB.ContinuousBatchingEngine, qt, TT.default_quota())
    off_j = _bare(JB.ContinuousBatchingEngine, None, None)
    off_t = _bare(TB.ContinuousBatchingEngine, None, None)
    for t in ("capped", "banned", "over", "elsewhere", None):
        req = SimpleNamespace(tenant=t)
        assert et._tenant_gamma_cap(req) == ej._tenant_gamma_cap(req), t
        assert off_t._tenant_gamma_cap(req) is None
        assert off_j._tenant_gamma_cap(req) is None
    for cap in (None, 0, 1, 2, 4):
        for ewma in (0.0, 0.05, 0.3, 0.55, 0.7, 1.0):
            assert (et._adapt_gamma(ewma, cap=cap)
                    == ej._adapt_gamma(ewma, cap=cap)), (cap, ewma)


# -- engines on the same float32 weights -----------------------------------------

def _weights(cfg, seed=0, scale=0.2):
    rng = np.random.default_rng(seed)
    h, f, n_l, d = cfg.hidden_size, cfg.ffn_size, cfg.num_layers, cfg.head_dim

    def n(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"embed": n(cfg.vocab_size, h),
            "final_ln": np.ones(h, np.float32),
            "layers": {"ln1": np.ones((n_l, h), np.float32),
                       "ln2": np.ones((n_l, h), np.float32),
                       "wq": n(n_l, h, cfg.num_heads * d),
                       "wk": n(n_l, h, cfg.num_kv_heads * d),
                       "wv": n(n_l, h, cfg.num_kv_heads * d),
                       "wo": n(n_l, cfg.num_heads * d, h),
                       "w_gate": n(n_l, h, f), "w_up": n(n_l, h, f),
                       "w_down": n(n_l, f, h)}}


@pytest.fixture(scope="module")
def f32():
    """A float32 nano_test in both preset tables and its weights:
    (jax params, port tree)."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jax_config, torch_config):
            mp.setitem(pkg.MODEL_PRESETS, PRESET, dataclasses.replace(
                pkg.MODEL_PRESETS["nano_test"], name=PRESET,
                dtype="float32"))
        tree = _weights(torch_config.MODEL_PRESETS[PRESET])
        jparams = {"embed": jnp.asarray(tree["embed"]),
                   "final_ln": jnp.asarray(tree["final_ln"]),
                   "layers": {k: jnp.asarray(v)
                              for k, v in tree["layers"].items()}}
        yield jparams, tree


def _engines(f32, quotas, **kw):
    qj, qt = (None, None) if quotas is None else _both(**quotas)
    tj, tt = _tiers(qj, qt, model_preset=PRESET, **kw)
    return (JB.ContinuousBatchingEngine(tj, params=f32[0]),
            TB.ContinuousBatchingEngine(
                tt, device="cpu",
                params=params_from_jax(torch_config.MODEL_PRESETS[PRESET],
                                       f32[1])))


def test_quotas_off_and_on_tokens_equal_and_jaxs(f32):
    """Non-binding quotas change no token, and both equal JAX's."""
    ids = {}
    for mode, quotas in (("off", None),
                         ("on", {"t0": {"max_inflight": 8, "kv_blocks": 1024,
                                        "weight": 2.0}})):
        ej, et = _engines(f32, quotas, max_new_tokens=24)
        try:
            ids[mode] = [tuple(et.generate(p, tenant="t0").token_ids)
                         for p in PROBES]
            if mode == "off":
                ids["jax"] = [tuple(ej.generate(p, tenant="t0").token_ids)
                              for p in PROBES]
        finally:
            ej.stop()
            et.stop()
    assert ids["off"] == ids["on"] == ids["jax"]
    assert all(len(t) > 1 for t in ids["off"])


def test_overquota_eviction_matches_jax(f32):
    """Under pool pressure the over-budget tenant's parked prefix goes
    first in both engines, whatever the LRU order; the bills match."""
    ej, et = _engines(f32, {"hog": {"kv_blocks": 1}, "ok": {"kv_blocks": 64}},
                      max_new_tokens=4, kv_pool_blocks=8)
    try:
        got = {}
        for name, eng in (("jax", ej), ("port", et)):
            eng.generate(PROBES[0], tenant="hog")
            eng.generate(PROBES[1], tenant="ok")
            before = [e.cache.get("tenant")
                      for e in eng.prefix_cache.entries_snapshot()]
            bills = (eng.tenant_kv_blocks("hog"), eng.tenant_kv_blocks("ok"),
                     eng.tenant_kv_blocks("nobody"))
            over = eng._overquota_parked_tenants()
            grab = eng.allocator.alloc(eng.allocator.available)
            blocks = eng._alloc_evicting(1)
            after = [e.cache.get("tenant")
                     for e in eng.prefix_cache.entries_snapshot()]
            eng.allocator.free(grab + blocks)
            got[name] = (before, bills, over, after, len(blocks))
        assert got["port"] == got["jax"]
        before, bills, over, after, _n = got["port"]
        assert before == ["hog", "ok"] and over == {"hog"}
        assert after == ["ok"] and bills[0] > 1
    finally:
        ej.stop()
        et.stop()


def _victims(eng, module, tenants_seq, quotas_kv):
    """Three decoding slots that cannot grow on a dry pool: each pass of
    ``_ensure_growth`` preempts one victim; the stubbed preemption frees
    its blocks and records it."""
    bs = eng.paged.block_size
    slots = []
    for ix, (tenant, seq) in enumerate(tenants_seq):
        req = module._Request(history="x", max_new_tokens=None,
                              temperature=None, tenant=tenant)
        req.admit_seq = seq
        blocks = eng.allocator.alloc(2)
        slots.append(module._Slot(request=req, blocks=blocks,
                                  prompt_len=2 * bs - 1, budget=64,
                                  temperature=0.0, ttft_ms=0.0,
                                  tokens=[1], max_blocks=8))
    rest = eng.allocator.alloc(eng.allocator.available)
    eng._slots = slots
    for ix in range(len(slots)):
        eng._pos[ix] = 2 * bs - 1
    order = []

    def preempt(ix):
        order.append(ix)
        eng.allocator.free(eng._slots[ix].blocks)
        eng._slots[ix] = None

    eng._preempt = preempt
    eng._set_table_row = lambda ix, row: None
    eng._table_row = lambda blocks: blocks
    eng._ensure_growth(list(range(len(slots))))
    live = [s for s in eng._slots if s is not None]
    for s in live:
        eng.allocator.free(s.blocks)
    eng.allocator.free(rest)
    eng._slots = [None] * len(eng._slots)
    return order


@pytest.mark.parametrize("tenants_seq", [
    (("quiet", 0), ("hog", 1), ("quiet", 2)),
    (("hog", 0), ("quiet", 1), ("mid", 2)),
    (("quiet", 0), ("mid", 1), ("hog", 2)),
])
def test_preemption_victims_match_jax(f32, tenants_seq):
    """The most over-budget tenant's slot is preempted first (bill over
    budget, then youngest), in the JAX engine's order."""
    quotas = {"hog": {"kv_blocks": 1}, "mid": {"kv_blocks": 3},
              "quiet": {}}
    ej, et = _engines(f32, quotas, decode_batch=3, max_new_tokens=4,
                      kv_pool_blocks=12, enable_prefix_cache=False)
    try:
        want = _victims(ej, JB, tenants_seq, quotas)
        got = _victims(et, TB, tenants_seq, quotas)
        assert got == want and want
        hog = [i for i, (t, _s) in enumerate(tenants_seq) if t == "hog"]
        assert want[0] == hog[0]
    finally:
        ej.stop()
        et.stop()


# -- the serving edge ---------------------------------------------------------

def test_tier_client_refusal_matches_jax():
    """A tenant over its seats is refused before the tier's controller,
    with JAX's text and a retry hint from the tenant's own budget."""
    from distributed_llm_tpu.engine.manager import EngineManager as JM
    from distributed_llm_tpu.obs import Observability as JObs
    from distributed_llm_tpu.obs.spans import use_trace as j_use
    from distributed_llm_tpu.serving.tiers import TierClient as JC
    from distributed_llm_tpu_torch.engine.manager import EngineManager as TM
    from distributed_llm_tpu_torch.obs import Observability as TObs
    from distributed_llm_tpu_torch.obs.spans import use_trace as t_use
    from distributed_llm_tpu_torch.serving.tiers import TierClient as TC

    qj, qt = _both(blocked={"max_inflight": 0},
                   paid={"device_ms_per_s": 10.0})
    tj, tt = _tiers(qj, qt)
    cj = JC(tj, JM(tj, warmup_on_start=False))
    ct = TC(tt, TM(tt, device="cpu", warmup_on_start=False))
    cj.tenants.debit("paid", 100.0)
    ct.tenants.debit("paid", 100.0)
    out = {}
    for name, client, obs, use in (("jax", cj, JObs(), j_use),
                                   ("port", ct, TObs(), t_use)):
        rows = []
        for tenant in ("blocked", "paid"):
            trace = obs.trace(strategy="heuristic")
            trace.annotate(tenant=tenant)
            with use(trace):
                rows.append(client.process("hello"))
                rows.append(client.process_stream("hello"))
        out[name] = rows
        assert client.admission.snapshot()["admitted"] == 0
    assert out["port"][0]["error"] == out["jax"][0]["error"]
    for got, want in zip(out["port"], out["jax"]):
        assert set(got) == set(want) == {"error", "retry_after_s"}
        assert got["error"] == want["error"]
        assert got["retry_after_s"] == pytest.approx(want["retry_after_s"],
                                                     abs=0.2)
    assert "tenant 'blocked'" in out["port"][0]["error"]
    assert TC(dataclasses.replace(tt, tenant_quotas=None),
              TM(tt, device="cpu", warmup_on_start=False)).tenants is None


@pytest.fixture(scope="module")
def quota_app():
    """The port's app over the tiny batched cluster whose tiers give the
    tenant ``blocked`` no seat and everyone else the default quota."""
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.app import create_app
    from distributed_llm_tpu_torch.serving.router import Router
    quotas = {"blocked": torch_config.TenantQuota(max_inflight=0)}
    base = torch_config.tiny_batched_cluster()
    cluster = dataclasses.replace(
        base, nano=dataclasses.replace(base.nano, tenant_quotas=quotas),
        orin=dataclasses.replace(base.orin, tenant_quotas=quotas))
    obs = Observability(slow_ms=0.0)
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=cluster, device="cpu", observability=obs,
                    sample_ms=0)
    yield create_app(router=router).test_client(), router, obs
    router.drain(timeout_s=10.0)


@pytest.mark.parametrize("bad,why", [
    (123, "'tenant_id' must be a non-empty string"),
    ("", "'tenant_id' must be a non-empty string"),
    ("x" * 65, "'tenant_id' exceeds 64 characters"),
    ("evil\x00tenant", "'tenant_id' must not contain control characters"),
    ("two\nlines", "'tenant_id' must not contain control characters"),
])
def test_tenant_id_validation(quota_app, bad, why):
    client, _router, _obs = quota_app
    for route in ("/chat", "/chat/stream"):
        resp = client.post(route, json={"message": "hi", "tenant_id": bad})
        assert resp.status_code == 400
        assert resp.get_json() == {"error": f"Request failed: {why}"}


def test_refusal_counts_and_opens_an_incident(quota_app):
    client, router, obs = quota_app
    doc, _, _dev = router.route_query(
        [{"role": "user", "content": "hello there"}], tenant_id="blocked")
    assert doc["ok"] is False
    raw = doc["raw"]
    assert "tenant 'blocked'" in raw["error"] and raw["retry_after_s"] > 0
    fam = obs.metrics.get("dllm_tenant_rejected_total")
    assert sum(c.value for (_tier, t), c in fam.children().items()
               if t == "blocked") >= 2      # failover cannot launder it
    incidents = [e for e in obs.recorder.snapshot()
                 if e.get("reason") == "tenant_overquota"]
    assert incidents and incidents[0]["incident"]["tenant"] == "blocked"
    assert incidents[0]["incident"]["open"] is True


def test_stats_rows_billing_and_metrics(quota_app):
    client, router, obs = quota_app
    resp = client.post("/chat", json={"message": "a question for costs",
                                      "tenant_id": "payer",
                                      "session_id": "sess-cost"})
    assert resp.status_code == 200
    resp = client.post("/chat", json={"message": "no tenant given"})
    assert resp.status_code == 200
    stats = client.get("/stats").get_json()
    assert stats["autoscaler"] is None
    for tier in ("nano", "orin"):
        snap = stats["tiers"][tier]["tenants"]
        assert "blocked" in snap["tenants"]
    assert sum(stats["tiers"][t]["tenants"]["admitted"]
               for t in ("nano", "orin")) >= 2
    rows = stats["cost"]
    assert rows and all("tenant" in r for r in rows)
    assert {"payer", "default"} <= {r["tenant"] for r in rows}
    fam = obs.metrics.get("dllm_tenant_device_time_ms_total")
    assert any(t == "payer" and c.value > 0
               for (_tier, t), c in fam.children().items())
    # The tenant's goodput window and its gauge (whether the request met
    # its SLO depends on the host's load; the two must agree).
    window = router.slo.snapshot()["tenants"]["payer"]
    assert obs.metrics.get("dllm_tenant_goodput").labels(
        "payer").value == window
    # The in-flight gauge lives in the process-global registry (the tier
    # clients' counters do, as in JAX), back at 0 once released.
    from distributed_llm_tpu_torch.obs import get_observability
    fam = get_observability().metrics.get("dllm_tenant_inflight")
    rows = {k: c.value for k, c in fam.children().items() if k[1] == "payer"}
    assert rows and set(rows.values()) == {0.0}


def test_incident_closes_on_the_next_completed_request():
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.router import Router
    r = object.__new__(Router)
    r._cost_lock = threading.Lock()
    r._tenant_incidents = {}
    r._tenant_incident_cap = 4
    r.obs = Observability(slow_ms=0.0)
    for _ in range(2):
        r._tenant_incident_edge("t1", rejected=True, which="nano",
                                reason="tenant 't1' queue full")
    r._tenant_incident_edge("t1", rejected=False)
    (entry,) = [e for e in r.obs.recorder.snapshot()
                if e.get("reason") == "tenant_overquota"]
    assert entry["incident"]["open"] is False
    assert entry["incident"]["rejections_while_open"] == 2
    for i in range(10):
        r._tenant_incident_edge(f"flood{i}", rejected=True, which="nano",
                                reason=f"tenant 'flood{i}' queue full")
    assert len(r._tenant_incidents) <= 4
