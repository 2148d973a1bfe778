"""Crash rescue in the port (serving/replicas.py ``restart_replica``,
engine/batching.py ``capture_requests``/``adopt_requests``,
``detach_spill``/``adopt_spill``) against the JAX package, on the CPU.

The port's replicas serve a float32 nano_test on weights both packages
share; the JAX engine's uninterrupted greedy run of the same prompt is
the reference.  A replica's loop is killed mid-decode with
``crash_replica_engine`` and the replica restarted:

- with a sibling, the captured request resumes there and the WHOLE
  emitted stream (tokens before the kill and after the adoption) equals
  JAX's tokens: no sentinel, no error, no re-emitted token;
- with one replica it is re-queued on the rebuilt engine, same bar;
- ``replica_rescue=False`` fails it with the engine-stopped error shape,
  as JAX's ``fail_captured`` does, and ``fail_captured`` itself gives
  JAX's shape;
- the host spill store survives the restart (the same object on the new
  engine, a warm promotion with JAX's tokens), or stops with the engine
  when ``spill_survive_restart=False``; a store the rebuilt engine
  refuses is handed to a sibling (``export_resident``/``admit_resident``);
- the HealthMonitor routes a wedged replica's restart through
  ``restart_replica``, on a real client.

Waits are bounded (token queues with timeouts, ``done`` events).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine import batching as JB
from distributed_llm_tpu.serving import replicas as JR
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import manager as TM
from distributed_llm_tpu_torch.engine.batching import EngineStoppedError
from distributed_llm_tpu_torch.engine.paged_kv import TRASH_BLOCK
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.serving import replicas as TR
from distributed_llm_tpu_torch.serving.health import HealthMonitor
from distributed_llm_tpu_torch.utils.faults import crash_replica_engine

PRESET = "nano_test_f32c"
PROMPT = "user: tell me about rivers lakes mountains oceans and deltas"
WARM = "session warm tell me about rivers in one sentence"
SPILL = dict(prefill_chunk_tokens=16, prefix_cache_entries=4,
             host_kv_bytes=64 * 1024 * 1024)


@pytest.fixture(scope="module")
def jax_params():
    """A float32 nano_test in both preset tables with weights at 0.2
    scale (greedy text that depends on its context); the port's engine
    build serves them.  Yields the JAX params."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (jax_config, torch_config):
            mp.setitem(pkg.MODEL_PRESETS, PRESET, dataclasses.replace(
                pkg.MODEL_PRESETS["nano_test"], name=PRESET,
                dtype="float32"))
        cfg = torch_config.MODEL_PRESETS[PRESET]
        rng = np.random.default_rng(11)
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
        real = TM.ContinuousBatchingEngine

        def build(tier, seed=0, device=None):
            return real(tier, seed=seed, device=device,
                        params=params_from_jax(cfg, tree))
        mp.setattr(TM, "ContinuousBatchingEngine", build)
        yield {"embed": jnp.asarray(tree["embed"]),
               "final_ln": jnp.asarray(tree["final_ln"]),
               "layers": {k: jnp.asarray(v)
                          for k, v in tree["layers"].items()}}


def _cluster(pkg, replicas=2, **kw):
    cl = pkg.tiny_batched_cluster(nano_slots=2)
    nano = dataclasses.replace(cl.nano, model_preset=PRESET,
                               replicas=replicas, max_new_tokens=32, **kw)
    return dataclasses.replace(cl, nano=nano)


def _client(replicas=2, warmup_on_start=False, **kw):
    cl = _cluster(torch_config, replicas=replicas, **kw)
    return TR.ReplicatedTierClient(cl.nano, cl, device="cpu",
                                   warmup_on_start=warmup_on_start)


def _jax_tokens(params, prompt, **kw):
    """JAX's uninterrupted greedy tokens for ``prompt``."""
    eng = JB.ContinuousBatchingEngine(
        dataclasses.replace(_cluster(jax_config, replicas=1, **kw).nano,
                            name="ref"), params=params)
    try:
        return list(eng.generate(prompt, temperature=0.0).token_ids)
    finally:
        eng.stop()


def _engine(client, rid):
    return next(r for r in client._members if r.rid == rid).mgr._engine


def _crash_mid_decode(client, rid, prompt=PROMPT):
    eng = _engine(client, rid)
    q = queue.Queue()
    req = eng.submit(prompt, temperature=0.0, token_queue=q)
    got = [q.get(timeout=30.0)]
    assert got[0] is not None
    assert crash_replica_engine(eng)
    return eng, req, got


def _rest(q, timeout=30.0):
    toks = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is None:
            return toks
        toks.append(tok)


def test_rescue_to_sibling_gives_jax_tokens(jax_params):
    want = _jax_tokens(jax_params, PROMPT)
    client = _client()
    try:
        client.server_manager.start_server()
        eng, req, got = _crash_mid_decode(client, 0)
        assert not req.done.is_set()
        summary = client.restart_replica(0, reason="test")
        assert summary == {"replica": "r0", "reason": "test",
                           "restarted": True, "rescued": 1,
                           "outcome": "sibling", "spill_reattached": False,
                           "errors": []}
        assert req.done.wait(60.0) and req.error is None
        assert got + _rest(req.token_queue) == want
        assert list(req.result.token_ids) == want
        assert _engine(client, 0) is not eng
        # The capture freed the slot's blocks and pointed its row at the
        # trash block.
        assert all(s is None for s in eng._slots)
        assert (eng._tables == TRASH_BLOCK).all()
        assert eng.allocator.ref_stats()["allocated_blocks"] == 0
        assert client.healthy_replicas() == 2
    finally:
        client.server_manager.stop_server()


def test_single_replica_requeues_on_the_rebuilt_engine(jax_params):
    want = _jax_tokens(jax_params, PROMPT)
    client = _client(replicas=1)
    try:
        client.server_manager.start_server()
        eng, req, got = _crash_mid_decode(client, 0)
        summary = client.restart_replica(0)
        assert (summary["outcome"], summary["rescued"]) == ("requeue", 1)
        assert req.done.wait(60.0) and req.error is None
        assert got + _rest(req.token_queue) == want
        assert _engine(client, 0) is not eng
    finally:
        client.server_manager.stop_server()


def _shape(reqs):
    return [(type(r.error).__name__, dict(r.error.shape), r.done.is_set())
            for r in reqs]


def test_rescue_disabled_fails_with_jaxs_shape(jax_params):
    client = _client(replicas=1, replica_rescue=False)
    try:
        client.server_manager.start_server()
        _, req, _ = _crash_mid_decode(client, 0)
        summary = client.restart_replica(0)
        assert summary["restarted"] and summary["rescued"] == 0
        assert summary["outcome"] is None
        assert req.done.wait(60.0)
        assert isinstance(req.error, EngineStoppedError)
        assert "engine stopped mid-flight" in req.error.shape["error"]
    finally:
        client.server_manager.stop_server()
    mk = [SimpleNamespace(error=None, token_queue=queue.Queue(),
                          done=threading.Event())
          for _ in range(4)]
    assert TR.fail_captured(mk[:2], "nano") == JR.fail_captured(mk[2:],
                                                                "nano")
    port, jax = _shape(mk[:2]), _shape(mk[2:])
    assert [(s, d) for _, s, d in port] == [(s, d) for _, s, d in jax]
    assert all(r.token_queue.get_nowait() is None for r in mk)


def test_spill_store_survives_and_promotes_warm(jax_params):
    want = _jax_tokens(jax_params, WARM, **SPILL)
    client = _client(replicas=1, **SPILL)
    try:
        client.server_manager.start_server()
        eng = _engine(client, 0)
        spill = eng.kv_spill
        first = eng.generate(WARM, temperature=0.0)
        assert list(first.token_ids) == want
        assert eng.prefix_cache.pop_oldest() is not None
        assert spill.flush(10.0)
        base = spill.stats()
        assert base["resident_entries"] == 1
        assert crash_replica_engine(eng)
        summary = client.restart_replica(0)
        assert summary["restarted"] and summary["spill_reattached"]
        new = _engine(client, 0)
        assert new is not eng and new.kv_spill is spill
        second = new.generate(WARM, temperature=0.0)
        assert list(second.token_ids) == want
        assert spill.stats()["promotions_total"] > base["promotions_total"]
    finally:
        client.server_manager.stop_server()


def test_spill_survival_off_stops_the_store(jax_params):
    client = _client(replicas=1, spill_survive_restart=False, **SPILL)
    try:
        client.server_manager.start_server()
        old = _engine(client, 0).kv_spill
        summary = client.restart_replica(0)
        assert summary["restarted"] and not summary["spill_reattached"]
        fresh = _engine(client, 0).kv_spill
        assert fresh is not None and fresh is not old
        assert old._stopping.is_set()
    finally:
        client.server_manager.stop_server()


def test_refused_store_is_handed_to_a_sibling(jax_params, monkeypatch):
    client = _client(**SPILL)
    try:
        client.server_manager.start_server()
        eng = _engine(client, 0)
        eng.generate(WARM, temperature=0.0)
        assert eng.prefix_cache.pop_oldest() is not None
        spill = eng.kv_spill
        assert spill.flush(10.0)
        exported = spill.export_resident()
        assert len(exported) == 1
        target = _engine(client, 1).kv_spill
        # The rebuilt engine refuses the store (another geometry).
        monkeypatch.setattr(type(eng), "adopt_spill",
                            lambda self, s: False)
        summary = client.restart_replica(0)
        assert summary["spill_handed_off"] == 1
        assert not summary["spill_reattached"]
        assert spill._stopping.is_set()
        assert target.stats()["resident_entries"] == 1
        assert target.peek(_engine(client, 1).affinity_token_ids(
            WARM + " and more")) > 0
    finally:
        client.server_manager.stop_server()


def test_health_monitor_restarts_a_crashed_replica(jax_params):
    """Real engines, real watchdog: the crashed r0 reads wedged past
    ``watchdog_stall_s``; the monitor restarts it through
    ``restart_replica`` and the request finishes with JAX's tokens.  The
    replicas warm up on start, so each rebuilt engine's loop runs (a
    never-driven batching engine's lazy loop reads dead to the probe, in
    JAX as here)."""
    want = _jax_tokens(jax_params, PROMPT)
    client = _client(watchdog_stall_s=1.0, warmup_on_start=True)
    router = SimpleNamespace(tiers={"nano": client}, breaker=None,
                             query_router=SimpleNamespace(router=None))
    mon = HealthMonitor(router, interval_s=0.05)
    try:
        client.server_manager.start_server()
        eng, req, got = _crash_mid_decode(client, 0)
        mon.start()
        assert req.done.wait(60.0) and req.error is None
        assert got + _rest(req.token_queue) == want
        deadline = time.monotonic() + 60
        while (mon.snapshot().get("nano/r0", {}).get("restarts", 0) < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        mon.stop()
        assert mon.snapshot()["nano/r0"]["restarts"] == 1
        assert mon.snapshot().get("nano/r1", {}).get("restarts") == 0
        assert _engine(client, 0) is not eng
        assert _engine(client, 1) is not None
    finally:
        mon.stop()
        client.server_manager.stop_server()


def test_restart_is_refused_while_another_runs(jax_params):
    client = _client()
    client._scaling = True
    summary = client.restart_replica(0)
    assert summary["errors"] == ["busy: scale in progress"]
    assert not summary["restarted"]
    client._scaling = False
    assert client.restart_replica(7)["errors"] == ["r7: not a member"]
