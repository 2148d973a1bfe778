"""The ``/query`` server's admission gate against the JAX package's.

The port's ``create_tier_app`` builds its manager through ``build_tiers``
(as ``distributed_llm_tpu/serving/tpu_api.py`` does), so
``manager.admission`` is set, and both routes gate on it.  On
``tiny_batched_cluster()`` nano (4 slots) with ``admission_max_queue=0``,
five concurrent ``/query`` requests on each package's app (the engine
held while four are in flight): the fifth is answered 503 with the JAX
package's text, the four answer 200, and every slot is released.  A
slot is released after an engine error, after a refused sampled stream
(501), and after a stream dropped before its first byte.  The
sequential tier (one slot) gates the same way, and a manager passed in
without a controller is not gated.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time

import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.serving import tpu_api
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.manager import EngineManager
from distributed_llm_tpu_torch.serving import gpu_api

SLOTS = 4


def _cluster(cfgmod, batched: bool = True):
    """The package's tiny cluster with nano's waiting line at 0."""
    cluster = (cfgmod.tiny_batched_cluster(nano_slots=SLOTS) if batched
               else cfgmod.tiny_cluster())
    return dataclasses.replace(cluster, nano=dataclasses.replace(
        cluster.nano, admission_max_queue=0))


def _apps(batched: bool = True):
    """{"jax": app, "torch": app} of nano over ``_cluster``."""
    return {"jax": tpu_api.create_tier_app("nano",
                                           cluster=_cluster(jax_config,
                                                            batched)),
            "torch": gpu_api.create_tier_app(
                "nano", cluster=_cluster(torch_config, batched),
                device="cpu")}


@pytest.fixture(scope="module")
def apps():
    apps = _apps()
    yield apps
    for app in apps.values():
        app.extensions["dllm_manager"].stop_server()


def _admission(app):
    return app.extensions["dllm_manager"].admission


def _wait_inflight(app, n: int, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while _admission(app).snapshot()["inflight"] != n:
        assert time.monotonic() < deadline, _admission(app).snapshot()
        time.sleep(0.01)


def _held(app, gate: threading.Event):
    """Hold every request that reaches the engine until ``gate`` is set:
    the JAX route calls ``generate``, the port's batched route
    ``submit`` and its sequential route ``generate`` on a worker."""
    engine = app.extensions["dllm_manager"].engine()
    name = "submit" if hasattr(engine, "submit") else "generate"
    real = getattr(engine, name)

    def held(*args, **kw):
        gate.wait(timeout=120)
        return real(*args, **kw)

    setattr(engine, name, held)
    return lambda: delattr(engine, name)


def _fifth_refused(app, slots: int) -> list:
    """``slots`` concurrent /query requests held in the engine, then one
    more: returns every (status, body), the last one the refused."""
    gate = threading.Event()
    restore = _held(app, gate)
    results = [None] * slots

    def worker(i):
        r = app.test_client().post("/query", json={
            "query": f"request {i} about rivers", "num_predict": 3})
        results[i] = (r.status_code, r.get_json())

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(slots)]
    try:
        for t in threads:
            t.start()
        _wait_inflight(app, slots)
        r = app.test_client().post("/query", json={"query": "one too many"})
        refused = (r.status_code, r.get_json())
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=120)
        restore()
    return results + [refused]


def test_fifth_concurrent_query_is_refused_as_jax_does(apps):
    got = {name: _fifth_refused(app, SLOTS) for name, app in apps.items()}
    for name, results in got.items():
        *served, refused = results
        assert [status for status, _ in served] == [200] * SLOTS, name
        assert refused == (503, {"error": "Request failed: nano admission "
                                          "rejected: queue full (0 "
                                          "waiting, cap 0)"}), name
        snap = _admission(apps[name]).snapshot()
        assert snap["inflight"] == 0 and snap["rejected"] >= 1, name
        assert snap["ewma_service_ms"] is not None, name
    assert got["torch"][-1] == got["jax"][-1]


def test_slot_released_after_an_engine_error(apps):
    for name, app in apps.items():
        engine = app.extensions["dllm_manager"].engine()
        attr = "submit" if name == "torch" else "generate"

        def boom(*args, **kw):
            raise RuntimeError("device fault")

        setattr(engine, attr, boom)
        try:
            r = app.test_client().post("/query", json={"query": "hi"})
        finally:
            delattr(engine, attr)
        assert r.status_code == 500, name
        assert r.get_json() == {"error": "Inference failed: device fault"}
        assert _admission(app).snapshot()["inflight"] == 0, name


def test_stream_slot_released_when_dropped_before_its_first_byte(apps):
    for name, app in apps.items():
        admitted = _admission(app).snapshot()["admitted"]
        r = app.test_client().post("/query/stream",
                                   json={"query": "stream about lakes",
                                         "num_predict": 3})
        assert r.status_code == 200, name
        assert _admission(app).snapshot()["inflight"] == 1, name
        del r                       # never read: the generator never ran
        gc.collect()
        snap = _admission(app).snapshot()
        assert snap["inflight"] == 0 and snap["admitted"] == admitted + 1


def test_stream_slot_released_after_it_is_read(apps):
    for name, app in apps.items():
        r = app.test_client().post("/query/stream",
                                   json={"query": "stream about hills",
                                         "num_predict": 3})
        assert r.status_code == 200 and '"done": true' in r.text, name
        assert _admission(app).snapshot()["inflight"] == 0, name


def test_stream_refused_when_the_line_is_full(apps):
    """All slots taken by held /query requests: a stream is refused with
    the same 503 and text."""
    for name, app in apps.items():
        gate = threading.Event()
        restore = _held(app, gate)
        threads = [threading.Thread(target=lambda: app.test_client().post(
            "/query", json={"query": "held", "num_predict": 2}))
            for _ in range(SLOTS)]
        try:
            for t in threads:
                t.start()
            _wait_inflight(app, SLOTS)
            r = app.test_client().post("/query/stream",
                                       json={"query": "one too many"})
        finally:
            gate.set()
            for t in threads:
                t.join(timeout=120)
            restore()
        assert r.status_code == 503, name
        assert r.get_json()["error"].startswith(
            "Request failed: nano admission rejected: queue full"), name
        assert _admission(app).snapshot()["inflight"] == 0, name


def test_sequential_tier_gates_its_one_slot():
    apps = _apps(batched=False)
    try:
        got = {name: _fifth_refused(app, 1) for name, app in apps.items()}
        assert got["torch"] == [(200, got["torch"][0][1]), got["jax"][1]]
        assert got["jax"][0][0] == 200
        assert got["jax"][1] == (503, {
            "error": "Request failed: nano admission rejected: queue full "
                     "(0 waiting, cap 0)"})
        for app in apps.values():
            assert _admission(app).snapshot()["inflight"] == 0
    finally:
        for app in apps.values():
            app.extensions["dllm_manager"].stop_server()


def test_refused_sampled_stream_releases_its_slot():
    tier = dataclasses.replace(torch_config.tiny_cluster().orin,
                               draft_preset="nano_test",
                               admission_max_queue=0)
    cluster = dataclasses.replace(torch_config.tiny_cluster(), orin=tier)
    app = gpu_api.create_tier_app("orin", cluster=cluster, device="cpu")
    try:
        r = app.test_client().post("/query/stream", json={
            "query": "hi", "temperature": 0.7})
        assert r.status_code == 501
        assert _admission(app).snapshot()["inflight"] == 0
        assert app.test_client().post("/query", json={
            "query": "hi", "num_predict": 2}).status_code == 200
    finally:
        app.extensions["dllm_manager"].stop_server()


def test_manager_without_a_controller_is_not_gated():
    manager = EngineManager(_cluster(torch_config).nano, device="cpu",
                            warmup_on_start=False)
    app = gpu_api.create_tier_app("nano", manager=manager)
    try:
        assert manager.admission is None
        assert app.test_client().post("/query", json={
            "query": "hi", "num_predict": 2}).status_code == 200
    finally:
        manager.stop_server()
