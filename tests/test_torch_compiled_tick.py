"""The batched engine's tick programs against the JAX engine's compiled
ticks.

The port's ``ContinuousBatchingEngine`` runs each tick's device work as a
``TickProgram`` on static inputs: on the card a CUDA graph captured once
and replayed, on the CPU the same body run directly.  Here, on the CPU
(``device="cpu"``), with the float32 presets and seeded numpy weights of
``test_torch_spec.py``:

- after ``warmup()`` on both engines and the same traffic, greedy tokens
  are identical to the JAX engine's on the ragged tick, the dense tick
  (bf16 and int8 pools) and the speculative round (self-draft);
- the per-stage program keys equal the JAX engine's ``_compiled`` sets:
  the port's ``"decode"`` keys are the table widths wb of JAX's
  ``(wb, tp)`` (the ragged tick's one program is MB; the dense rungs,
  warmup's second rung included), and its ``"spec"`` keys the γ buckets
  of JAX's ``"draft"`` and ``"verify"`` pairs (the port's round is one
  program where JAX compiles two);
- the device table is one tensor for the engine's life, written in place
  across admissions, releases and a copy-on-write prefix hit, and every
  dense rung reads a view of it;
- replay launch accounting, with a fake graph: a capture adds no launch,
  every replay adds what the capture counted, and the body runs once.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine import batching
from distributed_llm_tpu_torch.engine.batching import (
    ContinuousBatchingEngine as TorchEngine, TickProgram)
from distributed_llm_tpu_torch.engine.paged_kv import copy_block
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import _build, launches, quant
from distributed_llm_tpu_torch.ops import ragged_attention as TR
from test_torch_dense_tick import PROMPTS as CLIMBING
from test_torch_spec import (PRESET, PROMPTS, build_pair, drive,  # noqa: F401
                             presets, weights)   # fixtures, used by name


def _serve(engine, prompts):
    reqs = [engine.submit(p) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    return [r.result.token_ids for r in reqs]


def _jax_keys(engine, stage):
    """The first element of each of the JAX engine's tick keys of ``stage``
    (the table width of ``(wb, tp)``, the γ bucket of ``(gb, span, tp)``;
    the ``"draft"`` stage's prefill, writer and chunk keys, which name
    their kind first, are not ticks)."""
    return {key[0] for key in engine._compiled.get(stage, ())
            if isinstance(key[0], int)}


def _tick_programs(engine):
    """The engine's tick programs (its admission stages' left out)."""
    return {key for key in engine._programs if key[0] in ("decode", "spec")}


def _port_keys(engine, stage):
    assert engine.tick_stats()["compiled"].get(stage, []) == sorted(
        engine._compiled.get(stage, ()))
    return set(engine._compiled.get(stage, ()))


@pytest.fixture
def pair(presets, weights):
    built = []

    def build(**overrides):
        built.append(build_pair(presets, weights, overrides.pop("draft", None),
                                **overrides))
        return built[-1]

    yield build
    for jax_engine, port in built:
        jax_engine.stop()
        port.stop()
        assert port.allocator.ref_stats()["allocated_blocks"] == 0


def test_ragged_tick_is_one_program_with_jax_tokens(pair):
    jax_engine, port = pair()
    assert port.ragged and jax_engine.ragged
    for engine in (jax_engine, port):
        engine.warmup()
    assert _serve(port, PROMPTS) == _serve(jax_engine, PROMPTS)
    mb = port.paged.blocks_per_slot
    assert _port_keys(port, "decode") == _jax_keys(jax_engine, "decode") \
        == {mb}
    assert _tick_programs(port) == {("decode", mb)}


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_dense_tick_programs_per_rung_match_jax(pair, kv_quantize):
    jax_engine, port = pair(attention_ragged=False, kv_quantize=kv_quantize)
    for engine in (jax_engine, port):
        engine.warmup()
    warm = _port_keys(port, "decode")
    bs = port.paged.block_size
    # The warm request's rung and warmup's explicit second rung.
    assert warm == _jax_keys(jax_engine, "decode") == {
        b // bs for b in port._buckets[:2]}
    for prompt in CLIMBING[:2]:
        assert port.generate(prompt).token_ids == \
            jax_engine.generate(prompt).token_ids
    assert _serve(port, CLIMBING) == _serve(jax_engine, CLIMBING)
    keys = _port_keys(port, "decode")
    assert keys == _jax_keys(jax_engine, "decode")
    assert len(keys) >= 3 and warm < keys       # deeper rungs on first use
    assert _tick_programs(port) == {("decode", wb) for wb in keys}


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_spec_round_programs_per_gamma_bucket_match_jax(pair, kv_quantize):
    jax_engine, port = pair(draft=PRESET, kv_quantize=kv_quantize)
    assert port.spec and jax_engine.spec
    for engine in (jax_engine, port):
        engine.warmup()
    assert _port_keys(port, "spec") == _jax_keys(jax_engine, "verify") \
        == _jax_keys(jax_engine, "draft") == set(port._gamma_buckets)
    assert drive(port) == drive(jax_engine)
    assert _port_keys(port, "spec") == set(port._gamma_buckets)
    assert _port_keys(port, "decode") == _jax_keys(jax_engine, "decode")
    js, ts = jax_engine.spec_stats(), port.spec_stats()
    assert ts["drafted_total"] > 0
    assert (ts["drafted_total"], ts["accepted_total"]) == \
        (js["drafted_total"], js["accepted_total"])


def test_device_table_is_written_in_place(presets, weights, monkeypatch):
    """Admissions, releases and a shared prefix hit (whose boundary block
    is copied on write) change table rows; the device table stays the
    one tensor the programs read, holds the host table after every tick,
    and each dense rung is a view of it."""
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               model_preset=PRESET, attention_ragged=False,
                               share_prefix_kv=True)
    port = TorchEngine(tier, device="cpu", params=params_from_jax(
        presets[PRESET][1], weights[PRESET]))
    ptr = port._tables_dev.data_ptr()
    seen = []
    real_tick = port._decode_tick

    def tick(wb=None):
        out = real_tick(wb)
        seen.append(bool(torch.equal(port._tables_dev,
                                     torch.from_numpy(port._tables))))
        return out

    port._decode_tick = tick
    copies = []
    monkeypatch.setattr(batching, "copy_block", lambda *a: (
        copies.append(a[1:]), copy_block(*a))[1])
    try:
        _serve(port, PROMPTS)
        turn1 = [{"role": "user",
                  "content": "tell me about the tallest mountains"}]
        first = port.generate(turn1)
        hits = port.prefix_cache.stats()["hits_shared"]
        port.generate(turn1 + [{"role": "assistant", "content": first.text},
                               {"role": "user",
                                "content": "and the deepest lakes?"}])
        assert port.prefix_cache.stats()["hits_shared"] == hits + 1
        assert copies
    finally:
        port.stop()
    assert seen and all(seen)
    assert port._tables_dev.data_ptr() == ptr
    assert port._tables_dev_w and all(
        view.data_ptr() == ptr and view.stride() == port._tables_dev.stride()
        for view in port._tables_dev_w.values())


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_count_the_launches_their_capture_counted():
    calls = {"n": 0}
    out = torch.arange(3)

    def body():
        # What a captured body's wrappers count: two launches of one
        # kernel, one of another.
        calls["n"] += 1
        TR.ragged_paged_decode_attention.launches += 2
        TF.paged_decode_attention_q8.launches += 1
        return out

    before = launches.counts()
    graph = _FakeGraph()
    prog = TickProgram(body, graph, lambda g: contextlib.nullcontext())
    assert calls["n"] == 1 and prog.out is out
    assert prog.launch_deltas == {"ragged_decode": 2, "paged_decode_q8": 1}
    assert launches.counts() == before          # a capture launches nothing
    for _ in range(3):
        assert prog.run() is out
    assert graph.replays == 3 and calls["n"] == 1
    after = launches.counts()
    assert after["ragged_decode"] == before["ragged_decode"] + 6
    assert after["paged_decode_q8"] == before["paged_decode_q8"] + 3
    assert {k: v for k, v in after.items()
            if k not in prog.launch_deltas} == {
        k: v for k, v in before.items() if k not in prog.launch_deltas}
    launches.add(prog.launch_deltas, -3)
    assert launches.counts() == before


def test_cpu_programs_run_their_body_every_tick():
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        return torch.zeros(1)

    prog = TickProgram(body)
    assert prog.graph is None
    for _ in range(3):
        prog.run()
    assert calls["n"] == 3


def test_wrappers_are_every_kernel_and_count_launches():
    wrappers = launches.wrappers()
    # The twelve attention kernels and W1, the int8-weight product: every
    # kernel the build knows.
    assert len(wrappers) == 13 and set(wrappers) == set(_build.SIGNATURES)
    assert wrappers["w8_matmul"] is quant.w8_matmul
    assert all(isinstance(fn.launches, int) for fn in wrappers.values())
    assert wrappers["paged_decode"] is TF.paged_decode_attention
    assert launches.counts() == {name: fn.launches
                                 for name, fn in wrappers.items()}
