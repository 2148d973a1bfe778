"""The port's phase timer, telemetry and engine work accounting against
the JAX package's.

- ``PhaseTimer``: the same phases and work, timed on one fake clock,
  give the same ``summary()`` and ``work_summary()`` (keys, counts,
  rounding); ``engine_stats`` assembles the same keys.
- ``TierTelemetry``: ``energy_for_window`` (rel 1e-12) and ``save_log``
  (byte for byte) on the same injected samples; the sampler reads zeros
  on the CPU and the card's power draw in mW (``nvidia-smi``, faked
  here) on a card.
- Engine work: the same seeded prompts under greedy decoding through the
  JAX engine and the port's (float32 copies of the tiny presets, the same
  weights), on ``tiny_batched_cluster()`` (batched: cold, prefix hit,
  chunked prefill) and ``tiny_cluster()`` (sequential: cold, chunk
  stride, prefix hit; speculative with ``draft_test``): the phase names
  must match and ``work_summary()``'s ``flops``, ``hbm_bytes`` and
  ``tokens`` agree within rel 1e-9 (the formulas are the same; only the
  float sums' order may differ).  On the CPU the plain attention reads
  the whole allocated span, as JAX's XLA path does.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import datetime

import jax.numpy as jnp
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.batching import (
    ContinuousBatchingEngine as JaxBatched)
from distributed_llm_tpu.engine.inference import InferenceEngine as JaxSeq
from distributed_llm_tpu.engine.speculative import SpeculativeEngine as JaxSpec
from distributed_llm_tpu.utils import telemetry as jax_tel
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchBatched)
from distributed_llm_tpu_torch.engine.inference import (
    InferenceEngine as TorchSeq)
from distributed_llm_tpu_torch.engine.speculative import (
    SpeculativeEngine as TorchSpec)
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.utils import telemetry as torch_tel
from test_torch_engine import _tree

F32 = {name: f"{name}_f32" for name in ("nano_test", "draft_test")}
REL = 1e-9
COLD = "rivers carry water down from the mountains to the sea"
TURN1 = [{"role": "user", "content": "tell me about the tallest mountains"}]
LONG = ("a long question about rivers lakes mountains oceans deltas "
        "and the weather systems that move between them " * 3)


class FakeClock:
    """perf_counter for both timers: 1.25 ms more at every read."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _drive_timer(timer):
    for name, n in (("tokenize", 2), ("prefill", 3), ("decode", 5)):
        for _ in range(n):
            with timer.phase(name):
                pass
    timer.add_work("prefill", flops=1.5e9, hbm_bytes=3.25e7, tokens=64)
    timer.add_work("decode", flops=7.123456e8, hbm_bytes=1.0e8, tokens=4)
    timer.add_work("decode", flops=1.0, hbm_bytes=2.0, tokens=4)
    return timer.summary(), timer.work_summary()


def test_phase_timer_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    want = _drive_timer(jax_tel.PhaseTimer())
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    got = _drive_timer(torch_tel.PhaseTimer())
    assert got == want
    assert set(got[0]) == {"tokenize", "prefill", "decode"}


class _Stub:
    """An engine surface: phases, a prefix cache, kv stats, acceptance."""

    def __init__(self, timer):
        self.phases = timer
        self.acceptance_rate = 0.123456

        class Cache:
            def stats(self):
                return {"hits": 2, "misses": 1}
        self.prefix_cache = Cache()

    def kv_stats(self):
        return {"free_blocks": 7}


def test_engine_stats_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    jt = jax_tel.PhaseTimer()
    _drive_timer(jt)
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    tt = torch_tel.PhaseTimer()
    _drive_timer(tt)
    assert torch_tel.engine_stats(_Stub(tt)) == jax_tel.engine_stats(_Stub(jt))
    assert torch_tel.engine_stats(None) == jax_tel.engine_stats(None) == {}


def _samples():
    t0 = 1_700_000_000.0
    return [(t0 + 1.0 * i + 0.01 * (i % 3), 1e9 + 3.7e7 * i - 2e6 * i * i)
            for i in range(12)]


@pytest.mark.parametrize("window", [(0.5, 7.25), (-3.0, 2.0), (3.1, 3.4),
                                    (10.5, 20.0), (4.0, 4.0)])
def test_energy_for_window_matches_jax(window):
    t0 = _samples()[0][0]
    start, end = (datetime.fromtimestamp(t0 + w) for w in window)
    jt = jax_tel.TierTelemetry(["nano", "orin"])
    tt = torch_tel.TierTelemetry(["nano", "orin"], device="cpu")
    jt.samples["nano"] = tt.samples["nano"] = _samples()
    want = jt.energy_for_window("nano", start, end)
    got = tt.energy_for_window("nano", start, end)
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)
    assert tt.energy_for_window("orin", start, end) == 0.0


def test_save_log_matches_jax(tmp_path):
    jt = jax_tel.TierTelemetry(["nano"])
    tt = torch_tel.TierTelemetry(["nano"], device="cpu")
    jt.samples["nano"] = tt.samples["nano"] = _samples()
    jt.save_log("nano", str(tmp_path / "jax.log"))
    tt.save_log("nano", str(tmp_path / "port.log"))
    assert (tmp_path / "port.log").read_bytes() == \
        (tmp_path / "jax.log").read_bytes()


def test_sampler_reads_zeros_on_the_cpu():
    tt = torch_tel.TierTelemetry(["nano", "orin"], device="cpu")
    tt._sample_once()
    assert [v for _, v in tt.samples["nano"]] == [0.0]
    assert [v for _, v in tt.samples["orin"]] == [0.0]
    snap = torch_tel.device_memory_snapshot("cpu")
    assert [s["bytes_in_use"] for s in snap] == [0]


def test_sampler_reads_the_card_power_draw_in_mw(monkeypatch):
    """On a card each sample is ``nvidia-smi``'s power draw of that card
    (W) in mW, the same for both tiers; mW x s integrates to mJ."""
    import subprocess
    import types

    import torch

    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout="312.45\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid="abc-123"))
    tt = torch_tel.TierTelemetry(["nano", "orin"], device="cuda:0")
    tt._sample_once()
    assert [v for _, v in tt.samples["nano"]] == [312450.0]
    assert tt.samples["orin"] == tt.samples["nano"]
    assert seen[0][-1] == "--id=GPU-abc-123"
    assert "--query-gpu=power.draw" in seen[0]


# -- engine work against the JAX engines --------------------------------------

@pytest.fixture(scope="module")
def weights():
    """preset -> (JAX params, numpy tree) of float32 copies registered in
    both packages for the module."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for i, (base, name) in enumerate(F32.items()):
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32"))
            tree = _tree(torch_config.MODEL_PRESETS[name], seed=i)
            out[name] = ({"embed": jnp.asarray(tree["embed"]),
                          "final_ln": jnp.asarray(tree["final_ln"]),
                          "layers": {k: jnp.asarray(v)
                                     for k, v in tree["layers"].items()}},
                         tree)
        yield out


def _assert_same_work(jax_engine, port_engine):
    want = jax_engine.phases.work_summary()
    got = port_engine.phases.work_summary()
    assert set(got) == set(want)
    assert set(port_engine.phases.summary()) == set(
        jax_engine.phases.summary())
    for phase, w in want.items():
        for key in ("flops", "hbm_bytes", "tokens"):
            assert got[phase][key] == pytest.approx(w[key], rel=REL), (
                phase, key)
    return got


def _tier(cluster: str, **kw):
    jt = getattr(getattr(jax_config, cluster)(), "nano")
    tt = getattr(getattr(torch_config, cluster)(), "nano")
    kw = {"model_preset": F32["nano_test"], "tp": 1, **kw}
    return dataclasses.replace(jt, **kw), dataclasses.replace(tt, **kw)


def _same_tokens(jax_engine, port_engine, history):
    want = jax_engine.generate(history)
    assert port_engine.generate(history).token_ids == want.token_ids
    return want.text


def _conversation(jax_engine, port_engine):
    """A cold turn, then its follow-up over the parked prefix."""
    reply = _same_tokens(jax_engine, port_engine, TURN1)
    _same_tokens(jax_engine, port_engine, TURN1 + [
        {"role": "assistant", "content": reply},
        {"role": "user", "content": "and the deepest lakes?"}])


def test_batched_engine_work_matches_jax(weights):
    jtier, ttier = _tier("tiny_batched_cluster", prefill_chunk_tokens=16,
                         prefill_buckets=(16, 32, 64, 128))
    jparams, tree = weights[ttier.model_preset]
    jax_engine = JaxBatched(jtier, params=jparams)
    port_engine = TorchBatched(ttier, device="cpu", params=params_from_jax(
        ttier.model(), tree))
    try:
        _conversation(jax_engine, port_engine)
        _same_tokens(jax_engine, port_engine, LONG)
        assert port_engine.prefix_cache.stats()["hits"] == 1
        got = _assert_same_work(jax_engine, port_engine)
        assert set(got) == {"prefill", "decode"}
        # One "decode" phase per scheduler tick.
        assert (port_engine.phases.summary()["decode"]["count"]
                == port_engine.tick_stats()["ticks"])
    finally:
        jax_engine.stop()
        port_engine.stop()


def test_sequential_engine_work_matches_jax(weights):
    jtier, ttier = _tier("tiny_cluster")
    jparams, tree = weights[ttier.model_preset]
    jax_engine = JaxSeq(jtier, params=jparams)
    port_engine = TorchSeq(ttier, device="cpu", params=params_from_jax(
        ttier.model(), tree))
    _conversation(jax_engine, port_engine)
    _same_tokens(jax_engine, port_engine, "user: " + LONG)
    assert port_engine.prefix_cache.stats()["hits"] == 1
    got = _assert_same_work(jax_engine, port_engine)
    assert set(got) == {"prefill", "decode"}
    assert set(port_engine.phases.summary()) == {"tokenize", "prefill",
                                                 "decode", "detokenize"}
    port_engine.warmup()                 # the phases restart, as JAX's
    assert port_engine.phases.summary() == {}


def test_speculative_engine_work_matches_jax(weights):
    jtier, ttier = _tier("tiny_cluster")
    jdraft, tdraft = _tier("tiny_cluster", model_preset=F32["draft_test"])
    (jparams, tree), (jdparams, dtree) = (weights[ttier.model_preset],
                                          weights[tdraft.model_preset])
    jax_engine = JaxSpec(jtier, jdraft, gamma=3, target_params=jparams,
                         draft_params=jdparams)
    port_engine = TorchSpec(ttier, tdraft, gamma=3, device="cpu",
                            target_params=params_from_jax(ttier.model(), tree),
                            draft_params=params_from_jax(tdraft.model(),
                                                         dtree))
    for history in (COLD, "explain how a compiler turns source into code"):
        _same_tokens(jax_engine, port_engine, history)
    got = _assert_same_work(jax_engine, port_engine)
    assert set(got) == {"prefill", "decode"}
