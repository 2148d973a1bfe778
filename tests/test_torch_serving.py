"""The port's per-tier ``/query`` server on the CPU (stdlib test client):
the JSON contract and error codes of the JAX package's tpu_api.py."""

from __future__ import annotations

import dataclasses
import json
import threading

import pytest

from distributed_llm_tpu_torch.config import tiny_batched_cluster, tiny_cluster
from distributed_llm_tpu_torch.serving.gpu_api import create_tier_app
from distributed_llm_tpu_torch.serving.turns import ClippedStream, clip_turn


@pytest.fixture(scope="module")
def client():
    app = create_tier_app("nano", cluster=tiny_batched_cluster(),
                          device="cpu")
    yield app.test_client()
    app.extensions["dllm_manager"].stop_server()


def test_home_and_health(client):
    assert client.get("/").status_code == 200
    r = client.get("/health")
    assert r.status_code == 200 and r.get_json() == {"ok": True}


def test_query_string_and_history(client):
    r = client.post("/query", json={"query": "hello there", "num_predict": 6})
    assert r.status_code == 200
    assert isinstance(r.get_json()["response"], str)
    history = [{"role": "user", "content": "hello there"},
               {"role": "assistant", "content": "hi"},
               {"role": "user", "content": "how are rivers formed?"}]
    r = client.post("/query", json={"query": history, "num_predict": 5,
                                    "stats": True})
    body = r.get_json()
    assert r.status_code == 200 and set(body) == {"response", "stats"}
    assert 0 < body["stats"]["prompt_tokens"]
    assert body["stats"]["gen_tokens"] <= 5


def test_query_stream_sse(client):
    r = client.post("/query/stream", json={"query": "tell me a story",
                                           "num_predict": 6})
    assert r.status_code == 200
    events = [json.loads(line[len("data: "):])
              for line in r.text.split("\n") if line.startswith("data: ")]
    assert events and events[-1]["done"] is True
    assert all("delta" in e for e in events[:-1])
    assert events[-1]["tokens"] <= 6


@pytest.mark.parametrize("body,message", [
    ({}, "No query provided"),
    ({"query": ""}, "No query provided"),
    ({"query": 42}, "Invalid query format"),
    ({"query": [{"role": "user", "content": 3}]}, "role/content"),
    ({"query": ["not a dict"]}, "Invalid history entry"),
    ({"query": "hi", "num_predict": "many"}, "numeric"),
])
def test_query_bad_input_is_400(client, body, message):
    r = client.post("/query", json=body)
    assert r.status_code == 400 and message in r.get_json()["error"]


def test_stream_bad_input_is_400(client):
    assert client.post("/query/stream", json={}).status_code == 400
    r = client.post("/query/stream", json={"query": [1]})
    assert r.status_code == 400


def test_manager_health_and_drain():
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    manager = EngineManager(tiny_batched_cluster().nano, device="cpu",
                            warmup_on_start=False)
    assert manager.health()["ok"] is False and not manager.is_server_running()
    manager.engine().generate("hello", max_new_tokens=2)
    health = manager.health()
    assert health["ok"] and health["max_slots"] == 4
    assert health["decode_stall_s"] == 0.0
    summary = manager.drain(timeout_s=5.0)
    assert summary["aborted"] == 0 and manager.draining
    assert not manager.is_server_running()


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch
    from distributed_llm_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_unknown_tier_raises():
    with pytest.raises(ValueError):
        create_tier_app("galaxy", cluster=tiny_batched_cluster(), device="cpu")


def test_orin_tier_serves_query():
    """The orin tier of the tiny cluster (orin_test, 2 slots) behind its
    own /query server; the default cluster's orin is orin_8b on port
    5000, one card."""
    from distributed_llm_tpu_torch.config import ClusterConfig
    from distributed_llm_tpu_torch.serving.gpu_api import TIER_PORTS
    assert TIER_PORTS["orin"] == 5000
    orin = ClusterConfig().orin
    assert (orin.model_preset, orin.decode_batch, orin.tp) == ("orin_8b", 4, 1)
    app = create_tier_app("orin", cluster=tiny_batched_cluster(), device="cpu")
    try:
        client = app.test_client()
        r = client.post("/query", json={"query": "why is the sky blue?",
                                        "num_predict": 5, "stats": True})
        body = r.get_json()
        assert r.status_code == 200 and isinstance(body["response"], str)
        assert 0 < body["stats"]["gen_tokens"] <= 5
        engine = app.extensions["dllm_manager"].engine()
        assert engine.cfg.name == "orin_test" and engine.paged.max_slots == 2
    finally:
        app.extensions["dllm_manager"].stop_server()


def test_clip_turn_and_clipped_stream():
    assert clip_turn("assistant: the answer\nuser: next") == "the answer"
    deltas = ["The ans", "wer is 4", "2.\nus", "er: more"]
    assert "".join(ClippedStream(iter(deltas))) == "The answer is 42."


# -- the sequential engines (decode_batch=1 tiers of tiny_cluster()) ----------

def _events(r):
    return [json.loads(line[len("data: "):])
            for line in r.text.split("\n") if line.startswith("data: ")]


@pytest.fixture(scope="module")
def seq_client():
    app = create_tier_app("nano", cluster=tiny_cluster(), device="cpu")
    yield app.test_client()
    app.extensions["dllm_manager"].stop_server()


def test_sequential_tier_serves_query_and_stream(seq_client):
    from distributed_llm_tpu_torch.engine.inference import InferenceEngine
    r = seq_client.post("/query", json={"query": "hello there", "stats": True})
    body = r.get_json()
    assert r.status_code == 200 and isinstance(body["response"], str)
    assert 0 < body["stats"]["gen_tokens"] <= 8
    manager = seq_client.app.extensions["dllm_manager"]
    assert type(manager.engine()) is InferenceEngine
    r = seq_client.post("/query/stream", json={"query": "tell me a story",
                                               "num_predict": 6})
    events = _events(r)
    assert r.status_code == 200 and events[-1]["done"] is True
    assert 0 < events[-1]["tokens"] <= 6


def test_sequential_tier_serializes_concurrent_queries(seq_client):
    """Three concurrent /query calls queue on the app's engine lock: all
    200, and never two inside the engine at once."""
    engine = seq_client.app.extensions["dllm_manager"].engine()
    inside, peak, statuses = [0], [0], []
    real = engine.generate

    def counted(*args, **kwargs):
        inside[0] += 1
        peak[0] = max(peak[0], inside[0])
        try:
            return real(*args, **kwargs)
        finally:
            inside[0] -= 1

    engine.generate = counted
    try:
        threads = [threading.Thread(target=lambda i=i: statuses.append(
            seq_client.post("/query", json={"query": f"request {i} about "
                                                     "rivers"}).status_code))
            for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        del engine.generate
    assert statuses == [200, 200, 200] and peak[0] == 1


def test_speculative_tier_refuses_sampling_like_jax():
    """A speculative tier is greedy-only: a sampled /query/stream answers
    501 and a sampled /query 500, as the JAX tpu_api does; greedy serves."""
    from distributed_llm_tpu_torch.config import ClusterConfig
    from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
    tiny = tiny_cluster()
    cluster = ClusterConfig(nano=tiny.nano, orin=dataclasses.replace(
        tiny.orin, draft_preset="nano_test"))
    app = create_tier_app("orin", cluster=cluster, device="cpu")
    try:
        client = app.test_client()
        r = client.post("/query/stream", json={"query": "hi",
                                               "temperature": 0.8})
        assert r.status_code == 501 and "greedy" in r.get_json()["error"]
        r = client.post("/query", json={"query": "hi", "temperature": 0.8})
        assert r.status_code == 500 and "greedy" in r.get_json()["error"]
        r = client.post("/query/stream", json={"query": "hi", "num_predict": 4})
        assert r.status_code == 200 and _events(r)[-1]["done"] is True
        engine = app.extensions["dllm_manager"].engine()
        assert type(engine) is SpeculativeEngine
    finally:
        app.extensions["dllm_manager"].stop_server()


def test_sequential_manager_health_and_drain():
    from distributed_llm_tpu_torch.engine.manager import EngineManager
    manager = EngineManager(tiny_cluster().nano, device="cpu",
                            warmup_on_start=True)
    manager.start_server()
    health = manager.health()
    assert health["ok"] and "decode_stall_s" not in health
    app = create_tier_app("nano", manager=manager)
    r = app.test_client().get("/health")
    assert r.status_code == 200 and r.get_json() == {"ok": True}
    summary = manager.drain(timeout_s=5.0)
    assert summary["aborted"] == 0 and summary["in_flight_at_start"] == 0
    assert manager.draining and not manager.is_server_running()
