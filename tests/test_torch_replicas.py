"""The port's replicated tiers (serving/replicas.py) against the JAX
package's, on the CPU.

- construction: ``build_tiers`` gives ``replicas > 1`` a
  ``ReplicatedTierClient`` and ``replicas = 1`` the plain ``TierClient``
  in both packages; ``replicas < 1`` raises ``ValueError``;
  ``_split_devices`` carves the same groups;
- dispatch: both clients, fed the same predicted waits and affinity
  scores (the dispatch math is host arithmetic), pick the same replica
  the same way through a scripted sequence (least-loaded, round-robin
  ties, affinity, the minimum match, the override, affinity off, a
  replica breaker opened, every breaker open); the port's ``policy``
  argument does what JAX's ``DLLM_REPLICA_POLICY`` does;
- the aggregate manager: health, drain over stub replicas, as JAX's;
- live tiny engines: the affinity scores of both packages' clients over
  the same parked prefixes (float32 presets on the same weights), the
  Router's sampler entries (``nano/rN``, ``replica_count``,
  ``replica_healthy``), the replica metric families, ``/stats``'
  ``replica_engines`` and one trace thread per replica, and the drain.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.serving import replicas as JR
from distributed_llm_tpu.serving import tiers as JT
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import manager as TM
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.obs import Observability
from distributed_llm_tpu_torch.serving import replicas as TR
from distributed_llm_tpu_torch.serving import tiers as TT
from distributed_llm_tpu_torch.serving.app import create_app
from distributed_llm_tpu_torch.serving.router import Router

PRESET = "nano_test_f32r"


def _cluster(pkg, replicas=2, slots=2, **tier_kw):
    cl = pkg.tiny_batched_cluster(nano_slots=slots)
    nano = dataclasses.replace(cl.nano, replicas=replicas, max_new_tokens=8,
                               **tier_kw)
    orin = dataclasses.replace(cl.orin, tp=1)
    return dataclasses.replace(cl, nano=nano, orin=orin)


def _clients(**tier_kw):
    """(jax client, port client) over the same tiny tier, not started."""
    jcl = _cluster(jax_config, **tier_kw)
    tcl = _cluster(torch_config, **tier_kw)
    return (JR.ReplicatedTierClient(jcl.nano, jcl, warmup_on_start=False),
            TR.ReplicatedTierClient(tcl.nano, tcl, device="cpu",
                                    warmup_on_start=False))


# -- construction ---------------------------------------------------------------

def test_build_tiers_replicas_match_jax():
    for replicas in (1, 2, 3):
        jt = JT.build_tiers(_cluster(jax_config, replicas=replicas),
                            warmup_on_start=False)
        tt = TT.build_tiers(_cluster(torch_config, replicas=replicas),
                            device="cpu", warmup_on_start=False)
        for name in ("nano", "orin"):
            assert type(tt[name]).__name__ == type(jt[name]).__name__
        if replicas > 1:
            assert isinstance(tt["nano"], TR.ReplicatedTierClient)
            assert tt["nano"].replica_count() == replicas
            assert ([c.name for c in tt["nano"].clients]
                    == [c.name for c in jt["nano"].clients])
            assert ([m.tier.name for m in tt["nano"].server_manager.managers]
                    == [m.tier.name
                        for m in jt["nano"].server_manager.managers])
            assert (tt["nano"].breaker.snapshot()
                    == jt["nano"].breaker.snapshot())
        else:
            assert isinstance(tt["nano"], TT.TierClient)


def test_replicas_must_be_positive():
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               replicas=0)
    with pytest.raises(ValueError):
        tier.check_ported()
    with pytest.raises(ValueError):
        TR.ReplicatedTierClient(tier, torch_config.tiny_batched_cluster(),
                                device="cpu")
    with pytest.raises(ValueError):
        JR.ReplicatedTierClient(
            dataclasses.replace(jax_config.tiny_batched_cluster().nano,
                                replicas=0),
            jax_config.tiny_batched_cluster())
    with pytest.raises(NotImplementedError):
        dataclasses.replace(tier, replicas=2, tp=2).check_ported()


@pytest.mark.parametrize("n_dev,n,tp", [(1, 2, 1), (1, 3, 1), (2, 2, 1),
                                        (4, 3, 1), (4, 2, 2), (3, 2, 2)])
def test_split_devices_matches_jax(n_dev, n, tp):
    devs = list(range(n_dev))
    assert TR._split_devices(devs, n, tp) == JR._split_devices(devs, n, tp)


# -- dispatch ---------------------------------------------------------------------

# (predicted waits, affinity scores, breaker failures to feed first)
DISPATCH = [
    ([(3.0, 2), (0.0, 0)], [0, 0], {}),          # least-loaded
    ([(0.0, 0), (0.0, 0)], [0, 0], {}),          # round-robin ties
    ([(0.0, 0), (0.0, 0)], [0, 0], {}),
    ([(0.0, 0), (0.0, 0)], [0, 0], {}),
    ([(0.1, 1), (0.0, 0)], [40, 0], {}),         # affinity binds
    ([(0.1, 1), (0.0, 0)], [8, 0], {}),          # below the minimum
    ([(5.0, 2), (0.0, 0)], [100, 0], {}),        # overridden: too hot
    ([(0.0, 0), (0.5, 1)], [0, 0], {0: 5}),      # r0's breaker opens
    ([(0.0, 0), (0.0, 0)], [0, 0], {1: 5}),      # both open
]


def _dispatch(client, script):
    picks = []
    for waits, scores, feed in script:
        client._predicted_waits = lambda w=waits: list(w)
        client._affinity_scores = lambda h, s=scores: list(s)
        for i, n in feed.items():
            for _ in range(n):
                client._feed_breaker(i, {"error": "Request failed: boom"})
        picks.append(client._pick_replica("q"))
    return picks, client.breaker.snapshot()


def test_dispatch_choices_match_jax():
    jc, tc = _clients()
    want, got = _dispatch(jc, DISPATCH), _dispatch(tc, DISPATCH)
    assert got == want
    hows = [how for _, how in got[0]]
    assert hows[:2] == ["least_loaded", "least_loaded"]
    assert {"affinity", "affinity_overridden",
            "breaker_fallback"} <= set(hows)


def test_affinity_off_never_probes_and_admission_is_breaker_neutral():
    jc, tc = _clients(replica_affinity=False)
    for client in (jc, tc):
        client._predicted_waits = lambda: [(0.0, 0), (0.0, 0)]

        def boom(h):
            raise AssertionError("affinity probed with the policy off")
        client._affinity_scores = boom
        assert client._pick_replica("q")[1] == "least_loaded"
        for _ in range(8):
            client._feed_breaker(0, {"error": "Request failed: nano "
                                     "admission rejected: queue full"})
        assert client.breaker.state("r0") == "closed"


def test_policy_argument_is_jaxs_env_override(monkeypatch):
    jc, tc = _clients()
    tc.policy = "random"
    monkeypatch.setenv("DLLM_REPLICA_POLICY", "random")
    for client in (jc, tc):
        client._predicted_waits = lambda: [(0.0, 0), (0.0, 0)]
    assert ([tc._pick_replica("q") for _ in range(6)]
            == [jc._pick_replica("q") for _ in range(6)])
    tc.policy = "load"
    monkeypatch.setenv("DLLM_REPLICA_POLICY", "load")
    assert tc._pick_replica("q")[1] == jc._pick_replica("q")[1]
    with pytest.raises(ValueError):
        TR.ReplicatedTierClient(tc.tier, _cluster(torch_config),
                                device="cpu", policy="garbage")


# -- the aggregate manager ------------------------------------------------------------

class _Stub:
    def __init__(self, name, wedged=False):
        self.name = name
        self.wedged = wedged
        self._engine = object()
        self.draining = False
        self.stopped = 0

    def is_server_running(self):
        return self._engine is not None

    def health(self):
        entry = {"ok": not self.wedged, "draining": self.draining,
                 "tier": self.name, "uptime_s": 1.0, "queue_depth": 1,
                 "active_slots": 1, "max_slots": 2}
        if self.wedged:
            entry.update(wedged=True, error="decode watchdog")
        return entry

    def stop_server(self):
        self.stopped += 1
        self._engine = None

    def drain(self, timeout_s=None):
        self.draining = True
        self.stop_server()
        return {"draining_started": True, "in_flight_at_start": 1,
                "drained": 1, "aborted": 0, "waited_s": 0.0}


@pytest.mark.parametrize("wedged", [(False, True), (True, True)])
def test_aggregate_health_and_drain_match_jax(wedged):
    outs = []
    for mod, pkg in ((JR, jax_config), (TR, torch_config)):
        mgr = mod.ReplicaSetManager(
            pkg.tiny_batched_cluster().nano,
            [_Stub(f"nano/r{i}", w) for i, w in enumerate(wedged)])
        h = mgr.health()
        keys = ("ok", "draining", "replica_count", "healthy_replicas",
                "degraded", "queue_depth", "active_slots", "max_slots",
                "slot_occupancy", "wedged", "error")
        d = mgr.drain(timeout_s=1.0)
        outs.append(({k: h.get(k) for k in keys},
                     {k: d[k] for k in ("in_flight_at_start", "drained",
                                        "aborted")},
                     sorted(d["replicas"]), mgr.draining,
                     [m.stopped for m in mgr.managers]))
    assert outs[0] == outs[1]


# -- live tiny engines -------------------------------------------------------------

@pytest.fixture(scope="module")
def f32():
    """A float32 nano_test in both packages' preset tables and weights at
    0.2 scale; the port's engine build loads them."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jax_config, torch_config):
            mp.setitem(pkg.MODEL_PRESETS, PRESET, dataclasses.replace(
                pkg.MODEL_PRESETS["nano_test"], name=PRESET,
                dtype="float32"))
        cfg = torch_config.MODEL_PRESETS[PRESET]
        rng = np.random.default_rng(3)
        h, f, l, d = (cfg.hidden_size, cfg.ffn_size, cfg.num_layers,
                      cfg.head_dim)

        def n(*shape):
            return (rng.standard_normal(shape) * 0.2).astype(np.float32)

        tree = {"embed": n(cfg.vocab_size, h),
                "final_ln": np.ones(h, np.float32),
                "layers": {"ln1": np.ones((l, h), np.float32),
                           "ln2": np.ones((l, h), np.float32),
                           "wq": n(l, h, cfg.num_heads * d),
                           "wk": n(l, h, cfg.num_kv_heads * d),
                           "wv": n(l, h, cfg.num_kv_heads * d),
                           "wo": n(l, cfg.num_heads * d, h),
                           "w_gate": n(l, h, f), "w_up": n(l, h, f),
                           "w_down": n(l, f, h)}}
        jparams = {"embed": jnp.asarray(tree["embed"]),
                   "final_ln": jnp.asarray(tree["final_ln"]),
                   "layers": {k: jnp.asarray(v)
                              for k, v in tree["layers"].items()}}
        real = TM.ContinuousBatchingEngine

        def build(tier, seed=0, device=None):
            if tier.model_preset != PRESET:
                return real(tier, seed=seed, device=device)
            return real(tier, seed=seed, device=device,
                        params=params_from_jax(cfg, tree))
        mp.setattr(TM, "ContinuousBatchingEngine", build)
        yield jparams


def test_affinity_scores_match_jax_on_live_engines(f32):
    """Both clients' replicas park the same prompts (r0 one session, r1
    another); the same follow-ups score the same per replica and
    dispatch to the same replica."""
    from distributed_llm_tpu.engine import batching as JB

    jc, tc = _clients(model_preset=PRESET, prefill_buckets=(16, 32, 64))
    real_jax = JB.ContinuousBatchingEngine
    try:
        for r in jc._members:
            r.mgr._engine = real_jax(r.mgr.tier, params=f32)
        tc.server_manager.start_server()
        sessions = ["user: tell me about rivers lakes and mountains now",
                    "user: what do you know about deserts and oceans"]
        for client in (jc, tc):
            for rec, prompt in zip(client._members, sessions):
                rec.mgr._engine.generate(prompt)
        probes = [s + " and more please" for s in sessions] + [
            "user: unrelated question about stars"]
        for p in probes:
            assert tc._affinity_scores(p) == jc._affinity_scores(p), p
        for p in probes:
            jc._predicted_waits = tc._predicted_waits = (
                lambda: [(0.0, 0), (0.0, 0)])
            assert tc._pick_replica(p) == jc._pick_replica(p), p
    finally:
        for r in jc._members:
            if r.mgr._engine is not None:
                r.mgr._engine.stop()
                r.mgr._engine = None
        tc.server_manager.stop_server()


def test_router_serves_a_replicated_tier_with_its_obs(f32):
    cl = _cluster(torch_config, model_preset=PRESET)
    obs = Observability(slow_ms=None)
    router = Router(strategy="heuristic", benchmark_mode=True, cluster=cl,
                    device="cpu", observability=obs, sample_ms=0)
    app = create_app(router=router, device="cpu")
    try:
        client = router.tiers["nano"]
        assert isinstance(client, TR.ReplicatedTierClient)
        assert client.obs is obs
        for r in client._members:
            r.mgr.warmup_on_start = False
        client.server_manager.start_server()
        for i in range(4):
            resp = client.process(f"user: question number {i} about rivers")
            assert "response" in resp, resp
        stream = client.process_stream("user: stream about lakes")
        assert "".join(stream)
        st = router._sampler_collect()
        assert {"nano/r0", "nano/r1"} <= set(st)
        assert st["nano"]["replica_count"] == 2
        assert st["nano"]["replica_healthy"] == 2
        assert st["nano/r0"]["breaker"] == "closed"
        routed = sum(obs.m.replica_routed.labels("nano", how).value
                     for how in ("least_loaded", "affinity"))
        assert routed == 5
        trace = router.profiler_trace()
        names = {e["args"]["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        assert {"tier:nano/r0", "tier:nano/r1"} <= names
        body = app.test_client().get("/stats").get_json()
        nano = body["tiers"]["nano"]
        assert set(nano["replica_engines"]) == {"r0", "r1"}
        assert nano["replica_count"] == 2 and nano["healthy_replicas"] == 2
        assert "replicas" in nano["kv"]
        h = client.server_manager.health()
        assert h["ok"] and not h["degraded"]
        assert client.load_snapshot()["max_slots"] == 4
    finally:
        out = router.drain(timeout_s=5)
    assert set(out["nano"]["replicas"]) == {"r0", "r1"}
    assert not router.tiers["nano"].server_manager.is_server_running()
