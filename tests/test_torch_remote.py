"""Remote tiers (``serving/remote.py``) against the JAX package.

- The ``/query`` wire contract both ways, over real localhost sockets
  (wsgiref, one thread each): the port's ``RemoteTierClient`` against the
  JAX package's ``create_tier_app``, and JAX's client against the port's
  ``gpu_api``; for each server, the two clients' replies, stream texts,
  ``stats`` extension and error shapes are identical.
- ``RemoteServerManager``: readiness on a live server, an unreachable
  host, the constants; the HealthMonitor classifies a remote that was
  seen running and then answers not-ok as failed (``remote_lifecycle``).
- ``build_tiers``' endpoint branch and the Router over a remote nano and
  a local orin: ``/chat`` served across the hop, failover to orin when
  the remote is gone.
- Revival: one spawned CPU child (the port's ``gpu_api --device cpu``) is
  killed and the HealthMonitor respawns it through ``spawn_cmd``.  This
  is the file's one process.
"""

from __future__ import annotations

import dataclasses
import socket
import sys
import threading
import time
import types
from pathlib import Path
from wsgiref.simple_server import WSGIRequestHandler, make_server

import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.manager import EngineManager as JM
from distributed_llm_tpu.serving import remote as JRem
from distributed_llm_tpu.serving.tpu_api import create_tier_app as jax_app
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.manager import EngineManager as TM
from distributed_llm_tpu_torch.serving import remote as TRem
from distributed_llm_tpu_torch.serving.gpu_api import \
    create_tier_app as port_app

HISTORY = [{"role": "user", "content": "hello over the hop"}]
ROOT = str(Path(__file__).resolve().parents[1])


class _Quiet(WSGIRequestHandler):
    def log_message(self, *args):
        pass


def _serve(app):
    httpd = make_server("127.0.0.1", 0, app, handler_class=_Quiet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _tier(pkg, **kw):
    base = dict(name="nano", model_preset="nano_test", max_new_tokens=8,
                prefill_buckets=(16, 32, 64), kv_block_size=16)
    base.update(kw)
    return pkg.TierConfig(**base)


@pytest.fixture(scope="module")
def servers():
    """A JAX tier server and a port tier server on localhost ports."""
    jm = JM(_tier(jax_config), warmup_on_start=False)
    tm = TM(_tier(torch_config), device="cpu", warmup_on_start=False)
    j_httpd, j_url = _serve(jax_app("nano", manager=jm))
    t_httpd, t_url = _serve(port_app("nano", manager=tm))
    try:
        yield {"jax": j_url, "port": t_url}
    finally:
        j_httpd.shutdown()
        t_httpd.shutdown()
        jm.stop_server()
        tm.stop_server()


def test_constants_are_jaxs():
    for name in ("HEALTH_POLL_ATTEMPTS", "HEALTH_POLL_INTERVAL_S",
                 "SPAWN_READY_ATTEMPTS", "SPAWN_GRACE_S", "CONNECT_TIMEOUT_S",
                 "READ_TIMEOUT_S", "CONNECT_RETRY_ATTEMPTS",
                 "CONNECT_RETRY_BACKOFF_S"):
        assert getattr(TRem, name) == getattr(JRem, name), name
    assert TRem.RemoteServerManager.remote_lifecycle is True


def _exchange(client):
    out = client.process(HISTORY)
    res = client.last_result
    stream = client.process_stream(HISTORY)
    text = "".join(stream) if not isinstance(stream, dict) else stream
    sres = getattr(stream, "result", None)
    return (out, (res.gen_tokens, res.prompt_tokens, res.text), text,
            (sres.gen_tokens, sres.text) if sres is not None else None)


@pytest.mark.parametrize("server", ["jax", "port"])
def test_wire_contract_both_ways(servers, server):
    url = servers[server]
    got = _exchange(TRem.RemoteTierClient("nano", url))
    want = _exchange(JRem.RemoteTierClient("nano", url))
    assert got == want
    out, (gen, prompt, text), stream_text, sres = got
    assert set(out) == {"response"} and out["response"] == text
    assert gen >= 1 and prompt >= 1
    assert stream_text and sres[0] >= 1


def test_error_shapes_match_jax():
    url = "http://127.0.0.1:1"                 # nothing listens
    t = TRem.RemoteTierClient("nano", url)
    j = JRem.RemoteTierClient("nano", url)
    for call in ("process", "process_stream"):
        got, want = getattr(t, call)(HISTORY), getattr(j, call)(HISTORY)
        assert got == want and set(got) == {"error"}
        assert got["error"].startswith("Request failed:")
    assert t.server_manager.is_server_running() is False
    t.server_manager.stop_server()             # a no-op without a child


def test_manager_readiness_and_intercept(servers):
    from distributed_llm_tpu.utils.faults import FaultInjector as JFI
    from distributed_llm_tpu_torch.utils.faults import FaultInjector as TFI
    mgr = TRem.RemoteServerManager(servers["port"])
    assert mgr.is_server_running()
    mgr.start_server()                         # healthy: returns at once
    assert mgr.health()["ok"] is True
    out = {}
    for name, mod, fi in (("port", TRem, TFI()), ("jax", JRem, JFI())):
        client = mod.RemoteTierClient("nano", servers["port"],
                                      fault_injector=fi)
        fi.fail_next("nano", "scripted")
        fi.fail_next("nano", "scripted again")
        out[name] = (client.process(HISTORY), client.process_stream(HISTORY))
    assert out["port"] == out["jax"]
    assert "scripted" in out["port"][0]["error"]


def test_monitor_fails_a_remote_that_answers_not_ok():
    from distributed_llm_tpu_torch.serving.health import HealthMonitor

    class Remote:
        remote_lifecycle = True
        ok = True

        def is_server_running(self):
            return self.ok

        def health(self):
            return {"ok": self.ok}

    class Local(Remote):
        remote_lifecycle = False

    remote, local = Remote(), Local()
    router = types.SimpleNamespace(tiers={
        "nano": types.SimpleNamespace(server_manager=remote),
        "orin": types.SimpleNamespace(server_manager=local)})
    mon = HealthMonitor(router, interval_s=0.1, auto_restart=False)
    snap = mon.probe_once()
    assert snap["nano"]["state"] == snap["orin"]["state"] == "running"
    remote.ok = local.ok = False
    snap = mon.probe_once()
    assert snap["nano"]["state"] == "failed"
    assert snap["orin"]["state"] == "stopped"


def test_router_over_a_remote_nano(servers):
    from distributed_llm_tpu_torch.obs import Observability
    from distributed_llm_tpu_torch.serving.app import create_app
    from distributed_llm_tpu_torch.serving.remote import RemoteTierClient
    from distributed_llm_tpu_torch.serving.router import Router
    from distributed_llm_tpu_torch.serving.tiers import build_tiers

    base = torch_config.tiny_batched_cluster()
    cluster = dataclasses.replace(base, nano=dataclasses.replace(
        base.nano, endpoint=servers["port"]))
    tiers = build_tiers(cluster, device="cpu", warmup_on_start=False)
    assert isinstance(tiers["nano"], RemoteTierClient)
    assert tiers["nano"].server_manager.spawn_cmd is None
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=cluster, device="cpu", sample_ms=0,
                    observability=Observability(slow_ms=None))
    http = create_app(router=router).test_client()
    try:
        resp = http.post("/chat", json={"message": "hi there"}).get_json()
        assert resp["device"] == "nano" and resp["reply"]
        assert router.tiers["nano"].last_result.gen_tokens >= 1
        stats = http.get("/stats").get_json()
        assert stats["tiers"]["nano"]["ok"] is True
        # The remote gone: the request fails over to the local orin.
        router.tiers["nano"].base_url = "http://127.0.0.1:1"
        router.tiers["nano"].server_manager.base_url = "http://127.0.0.1:1"
        resp = http.post("/chat", json={"message": "hi again"}).get_json()
        assert resp["device"] == "orin" and resp["reply"]
    finally:
        summary = router.drain(timeout_s=5.0)
    assert summary["nano"] == {"draining_started": False, "stopped": True}


def test_remote_revival_dead_to_serving():
    """A spawn_cmd-equipped manager starts the port's tier server, the
    process is killed, the monitor counts the dead /health as failures
    and its restart respawns it: dead -> restarted -> serving."""
    from distributed_llm_tpu_torch.serving.health import HealthMonitor

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spawn_cmd = ("env", f"PYTHONPATH={ROOT}", sys.executable, "-m",
                 "distributed_llm_tpu_torch.serving.gpu_api", "--tier",
                 "nano", "--port", str(port), "--device", "cpu",
                 "--host", "127.0.0.1")
    client = TRem.RemoteTierClient("nano", f"http://127.0.0.1:{port}",
                                   spawn_cmd=spawn_cmd)
    mgr = client.server_manager
    try:
        assert not mgr.is_server_running()
        mgr.start_server()                     # spawns, polls readiness
        assert mgr.is_server_running()
        assert "response" in client.process(HISTORY)
        mon = HealthMonitor(types.SimpleNamespace(tiers={"nano": client}),
                            interval_s=0.1, max_consecutive_failures=2,
                            auto_restart=True)
        assert mon.probe_once()["nano"]["state"] == "running"
        first = mgr._proc
        first.terminate()                      # the remote host crashes
        first.wait(timeout=10)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            snap = mon.probe_once()["nano"]
            if snap["state"] == "running" and snap.get("restarts", 0) >= 1:
                break
            time.sleep(0.2)
        assert mon.snapshot()["nano"]["restarts"] >= 1
        assert mgr._proc is not first and mgr.is_server_running()
        assert "response" in client.process(HISTORY)
    finally:
        mgr.stop_server()
    assert mgr._proc is None
