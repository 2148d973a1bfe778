"""The port's two-tier Router and /chat app against the JAX package's.

Both routers serve the tiny clusters (sequential ``tiny_cluster()`` and
batched ``tiny_batched_cluster()``, orin at ``tp=1`` on the JAX side so
no sharded summation order enters) with float32 copies of the tiny
presets.  The JAX tiers keep their own seeded weights; the port's engine
build is monkeypatched to load the same weights through
``params_from_jax``.  Over a scripted chat (benchmark and production
mode, response-cache hits, a history past the context budget that the
``truncate_left`` policy trims) the device, routing method, confidence
(within 1e-5), reply text, token count and response-dict keys must be
identical.  Then the failure paths on both routers (a stub tier
answering the error shape fails over once; the breaker opens after
``breaker_failures`` and vetoes the tier), and the port's ``/chat``,
``/chat/stream``, ``/health``, ``/history`` and drain's 503 through its
test client.  Every router is drained at teardown (engine threads
stopped).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import types

import jax
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.serving import tiers as jax_tiers
from distributed_llm_tpu.serving.router import Router as JaxRouter
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import manager as TM
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.serving.app import BASE_CONFIG, create_app
from distributed_llm_tpu_torch.serving import tiers as torch_tiers
from distributed_llm_tpu_torch.serving.router import Router as TorchRouter

F32 = {"nano": "nano_test_r32", "orin": "orin_test_r32"}
BASE = {"nano": "nano_test", "orin": "orin_test"}
ATOL = 1e-5

CHAT = ["hello there", "what is 2+2",
        "Implement a dynamic-programming solution to the knapsack problem "
        "and analyze its complexity",
        "hello there",                                  # a response-cache hit
        "compare rivers and lakes, what are the trade-offs?",
        "tell me about the tallest mountains"]


def _cluster(pkg, batched: bool, **cluster_over):
    base = pkg.tiny_batched_cluster() if batched else pkg.tiny_cluster()
    return dataclasses.replace(
        base,
        nano=dataclasses.replace(base.nano, model_preset=F32["nano"]),
        orin=dataclasses.replace(base.orin, model_preset=F32["orin"], tp=1),
        **cluster_over)


@pytest.fixture(scope="module")
def make_routers():
    """(jax_router, port_router) over the same cluster and weights."""
    built = []
    with pytest.MonkeyPatch.context() as mp:
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
                return cls(tier, seed=seed, device=device,
                           params=params_from_jax(tier.model(),
                                                  trees[tier.model_preset]))
            return build

        for name, cls in real.items():
            mp.setattr(TM, name, with_weights(cls))

        def build(batched: bool, benchmark_mode: bool, strategy="hybrid",
                  **cluster_over):
            kw = dict(strategy=strategy, benchmark_mode=benchmark_mode,
                      config=(None if benchmark_mode else dict(
                          jax_config.PRODUCTION_CFG, **BASE_CONFIG)))
            jr = JaxRouter(cluster=_cluster(jax_config, batched,
                                            **cluster_over), **kw)
            tr = TorchRouter(cluster=_cluster(torch_config, batched,
                                              **cluster_over),
                             device="cpu", **kw)
            built.append((jr, tr))
            for name in ("nano", "orin"):
                for r in (jr, tr):
                    r.tiers[name].server_manager.warmup_on_start = False
                engine = jr.tiers[name].server_manager.engine()
                trees[F32[name]] = jax.tree.map(np.asarray, engine.params)
            return jr, tr

        yield build
        for jr, tr in built:
            tr.drain(timeout_s=5)
            jr.drain(timeout_s=5)
            for tier in tr.tiers.values():
                assert not tier.server_manager.is_server_running()


def _same(got, want, label):
    (gresp, gtok, gdev), (wresp, wtok, wdev) = got, want
    assert gdev == wdev, label
    assert set(gresp) == set(wresp), label
    for key in ("routing_method", "response", "cache_hit", "ok"):
        assert gresp.get(key) == wresp.get(key), (label, key)
    assert abs(gresp["routing_confidence"]
               - wresp["routing_confidence"]) <= ATOL, label
    assert gtok == wtok, label
    for key in ("overflow_truncated", "overflow_dropped_messages"):
        assert gresp.get(key) == wresp.get(key), (label, key)


def _long_history():
    filler = ("rivers lakes mountains oceans deltas weather systems " * 12)
    history = []
    for i in range(4):
        history += [{"role": "user", "content": f"turn {i}: {filler}"},
                    {"role": "assistant", "content": f"noted {i}"}]
    return history + [{"role": "user", "content": "and the deepest lake?"}]


@pytest.mark.parametrize("batched", [False, True],
                         ids=["sequential", "batched"])
@pytest.mark.parametrize("benchmark_mode", [True, False],
                         ids=["benchmark", "production"])
def test_scripted_chat_matches_jax(make_routers, batched, benchmark_mode):
    jr, tr = make_routers(batched, benchmark_mode)
    history = []
    for i, message in enumerate(CHAT):
        history = history + [{"role": "user", "content": message}]
        got, want = tr.route_query(history), jr.route_query(history)
        _same(got, want, (i, message))
        history = history + [{"role": "assistant",
                              "content": got[0]["response"]}]
        if i == 3 and not benchmark_mode:
            assert got[0]["cache_hit"] is True    # repeated query
    got = tr.route_query(_long_history())
    _same(got, jr.route_query(_long_history()), "overflow")
    assert got[0].get("overflow_truncated") is True
    # Strategy switches keep routing identical.
    for strategy in ("token", "semantic", "heuristic", "perf"):
        for r in (jr, tr):
            r.query_router.change_strategy(strategy)
        q = [{"role": "user", "content": f"{strategy}: what is a river?"}]
        _same(tr.route_query(q), jr.route_query(q), strategy)


def _stub_errors(router, tier: str):
    calls = {"n": 0}

    def process(history):
        calls["n"] += 1
        return {"error": f"Request failed: {tier} stub outage"}

    router.tiers[tier].process = process
    return calls


def test_failover_and_breaker_match_jax(make_routers):
    jr, tr = make_routers(False, True, strategy="token",
                          breaker_failures=2, breaker_cooldown_s=600.0)
    stubs = [_stub_errors(r, "nano") for r in (jr, tr)]
    q = [{"role": "user", "content": "hello"}]          # token -> nano
    for attempt in range(3):
        got, want = tr.route_query(q), jr.route_query(q)
        _same(got, want, attempt)
        assert got[2] == "orin" and got[0]["ok"] is True
        assert got[0]["routing_method"] == ("token+breaker" if attempt == 2
                                            else "token")
    # One try per request until the circuit opened after two failures;
    # the third request was vetoed before dispatch.
    assert [s["n"] for s in stubs] == [2, 2]
    for r in (jr, tr):
        assert r.breaker.state("nano") == "open"
        assert r.breaker.state("orin") == "closed"


class _StubEngine:
    """A sequential engine whose generate() blocks until released."""

    concurrent_safe = False

    def __init__(self):
        self.release = threading.Event()

    def generate(self, history):
        self.release.wait(timeout=30)
        return types.SimpleNamespace(
            text="a reply\nuser: a turn the model ran on into",
            ttft_ms=1.5, total_ms=2.25, gen_tokens=3)


class _StubManager:
    def __init__(self, engine):
        self._engine = engine
        self.admission = None

    def is_server_running(self):
        return True

    def engine(self):
        return self._engine


def _tier_client_script(pkg, tiers_mod):
    """Admission (queue full, drain) and the timeout path (the worker
    abandoned, the next call failing fast while it runs, then a served
    reply clipped to its turn) of one package's tier client."""
    tier = dataclasses.replace(pkg.tiny_cluster().nano, request_timeout_s=0.3,
                               admission_max_queue=0)
    out = []
    adm = tiers_mod.AdmissionController(tier, slots=1)
    out += [adm.try_admit(), adm.try_admit(), adm.snapshot()]
    adm.release(0.5)
    adm.start_drain(retry_after_s=7.0)
    out += [adm.try_admit(), adm.retry_after_s()]
    adm.end_drain()
    engine = _StubEngine()
    client = tiers_mod.TierClient(tier, _StubManager(engine))
    out.append(client.process("first"))            # times out, abandoned
    out.append(client.process("second"))           # fails fast
    engine.release.set()
    for _ in range(200):                           # the worker finishes
        if client.admission.snapshot()["inflight"] == 0:
            break
        threading.Event().wait(0.05)
    out.append(client.admission.snapshot()["inflight"])
    # A served reply, under a budget no loaded test box can miss.
    served = tiers_mod.TierClient(
        dataclasses.replace(tier, request_timeout_s=60.0),
        _StubManager(engine))
    out += [served.process("third"), served.load_snapshot(),
            served._kv_admission_args("third")]
    return out


def test_tier_client_matches_jax():
    assert (_tier_client_script(torch_config, torch_tiers)
            == _tier_client_script(jax_config, jax_tiers))


def test_chat_app_contract(make_routers):
    jr, tr = make_routers(True, False)
    q = [{"role": "user", "content": "hello"}]
    # Full residency: the KV admission probe finds nothing to gate.
    assert (tr.tiers["nano"]._kv_admission_args(q) == (None, None)
            == jr.tiers["nano"]._kv_admission_args(q))
    client = create_app(router=tr).test_client()
    body = {"message": "hello there", "strategy": "token-counting",
            "session_id": "s1"}
    resp = client.post("/chat", json=body)
    assert resp.status_code == 200
    out = resp.get_json()
    assert set(out) == {"reply", "device", "reasoning", "method",
                        "confidence", "cache_hit", "tokens"}
    assert tr.query_router.strategy == "token"
    again = client.post("/chat", json=body).get_json()
    assert again["cache_hit"] is True and again["reply"] == out["reply"]
    stream = client.post("/chat/stream", json={
        "message": "tell me about lakes", "strategy": "heuristic",
        "session_id": "s1"})
    events = [json.loads(line[6:]) for line in stream.text.split("\n")
              if line.startswith("data: ")]
    assert events[0]["meta"] is True and events[0]["device"] in ("nano",
                                                                 "orin")
    assert events[-1]["done"] is True and events[-1]["tokens"] > 0
    assert "".join(e.get("delta", "") for e in events).strip()
    history = client.get("/history?session_id=s1").get_json()
    assert [m["role"] for m in history] == ["user", "assistant"] * 3
    assert client.post("/chat", json={"message": 7}).status_code == 400
    assert client.post("/chat", json={"message": "x", "strategy": "oracle"}
                       ).status_code == 500
    health = client.get("/health")
    assert health.status_code == 200
    # Two requests reached a tier (the repeat was a response-cache hit).
    admitted = sum(t["admission"]["admitted"]
                   for t in health.get_json()["tiers"].values())
    assert admitted == 2
    assert client.delete("/history?session_id=s1").get_json() == {
        "cleared": "s1"}
    assert client.get("/history?session_id=s1").get_json() == []
    tr.drain(timeout_s=5)
    drained = client.post("/chat", json={"message": "late"})
    assert drained.status_code == 503
    assert "retry_after_s" in drained.get_json()
    assert client.get("/health").status_code == 503
