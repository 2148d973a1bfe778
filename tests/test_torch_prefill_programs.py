"""The batched engine's admission programs against the JAX engine's
compiled prefill stages.

Every device stage of an admission is a ``TickProgram`` on static inputs
(a CUDA graph replayed on the card, the same body run directly on the
CPU), keyed as the JAX engine keys its compiled programs: ``"prefill"``
per bucket, ``"chunk_prefill"`` per (width, window), ``"writer"`` per
block count plus ``"cow_copy"`` and ``"cow_copy_draft"``, and the
draft's ``("prefill", bucket)``, ``("writer", nb)`` and
``("chunk", width, window)``.  Here, on the CPU (``device="cpu"``), with
the float32 presets and seeded numpy weights of ``test_torch_spec.py``:

- after ``warmup()`` and the same traffic on both engines (cold prompts
  in three buckets, a cold prompt longer than a chunk, a prefix hit whose
  matched length ends mid-block, so its boundary block is copied on
  write), the port's program keys of those stages equal the JAX engine's
  ``_compiled`` (its ``"draft"`` stage less the speculative rounds'
  ``(gb, span, tp)`` keys, which the port keys under ``"spec"``), and
  the greedy tokens are identical, on the ragged tick, the dense tick
  (bf16 and int8 pools) and with a self-draft speculating;
- a program built while one request's inputs were staged and run after
  another's gives the second request's first token and pool rows, equal
  at float32 to a fresh engine's (the guard against a per-request value
  frozen into a program);
- with a fake graph, a capture counts no launch and every replay adds
  the causal prefill (K2) and paged chunk (K3) launches its capture
  counted, and the int8 suffix chunk's calls likewise.
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
from distributed_llm_tpu_torch.engine.inference import prepare_prompt
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import launches
from test_torch_compiled_tick import _FakeGraph, pair  # noqa: F401
from test_torch_spec import (LONG, PRESET, presets,  # noqa: F401
                             weights)   # fixtures, used by name

# Prompts up to a 64-token bucket prefill at once (buckets 16, 32, 64);
# LONG (125 tokens) prefills in two 64-token chunks.
KW = dict(prefill_chunk_tokens=64, prefill_buckets=(16, 32, 64, 128))
COLD = ["rivers 0", "tell me about the tallest hills and the deepest "
        "lakes of the world today",
        "long question: " + "rivers lakes mountains oceans " * 8]
STAGES = ("prefill", "chunk_prefill", "writer", "draft")
CASES = {"ragged": {}, "dense_bf16": dict(attention_ragged=False),
         "dense_int8": dict(attention_ragged=False, kv_quantize="int8"),
         "spec_self_draft": dict(draft=PRESET)}


def traffic(engine):
    """Cold prompts in three buckets beside a chunked one, then a
    multi-turn follow-up hitting the first turn's parked prefix."""
    reqs = [engine.submit(p) for p in COLD + [LONG]]
    for r in reqs:
        assert r.done.wait(timeout=120)
        if r.error is not None:
            raise r.error
    out = [r.result.token_ids for r in reqs]
    turn1 = [{"role": "user", "content": "tell me about the tallest hills"}]
    first = engine.generate(turn1)
    hits = engine.prefix_cache.stats()["hits_shared"]
    second = engine.generate(turn1 + [
        {"role": "assistant", "content": first.text},
        {"role": "user", "content": "and the lakes?"}])
    assert engine.prefix_cache.stats()["hits_shared"] == hits + 1
    return out + [first.token_ids, second.token_ids]


def _jax_keys(engine, stage):
    """The JAX engine's keys of ``stage``; of ``"draft"`` the admission
    stages' only (their keys name their kind first)."""
    keys = engine._compiled.get(stage, set())
    if stage == "draft":
        keys = {k for k in keys if isinstance(k[0], str)}
    return keys


@pytest.mark.parametrize("case", sorted(CASES))
def test_admission_program_keys_and_tokens_match_jax(pair, case,
                                                     monkeypatch):
    jax_engine, port = pair(**KW, **CASES[case])
    assert port.spec == jax_engine.spec == (case == "spec_self_draft")
    buckets = {prepare_prompt(port.tokenizer, p, KW["prefill_buckets"],
                              port.cfg.max_seq_len,
                              port.tier.max_new_tokens)[1] for p in COLD}
    assert buckets == {16, 32, 64}
    for engine in (jax_engine, port):
        engine.warmup()
    warm = {stage: set(port._compiled.get(stage, ())) for stage in STAGES}
    copies = []
    real_copy = batching.copy_block
    monkeypatch.setattr(batching, "copy_block", lambda pool, src, dst: (
        copies.append((int(src), int(dst))), real_copy(pool, src, dst))[1])
    assert traffic(port) == traffic(jax_engine)
    # The follow-up's matched prefix ends mid-block: its boundary block
    # was copied on write (in both pools when speculating).
    assert copies and all(src != dst for src, dst in copies)
    for stage in STAGES:
        got = port.tick_stats()["compiled"].get(stage, [])
        assert got == sorted(port._compiled.get(stage, ()),
                             key=lambda k: (type(k).__name__, k))
        assert set(got) == _jax_keys(jax_engine, stage), stage
    compiled = port._compiled
    assert set(compiled["prefill"]) == {16, 32, 64}
    assert {k[0] for k in compiled["chunk_prefill"]} == {16, 32, 64}
    assert {"cow_copy"} <= compiled["writer"]
    if port.spec:
        assert {"cow_copy_draft", ("prefill", 16), ("chunk", 64, 256)} <= (
            compiled["writer"] | compiled["draft"])
    else:
        assert "draft" not in compiled
    # JAX's warm set: no chunk or copy-on-write program was built by the
    # traffic, only the prefill buckets the warm request did not take.
    for stage in ("chunk_prefill", "writer", "draft"):
        new = set(compiled.get(stage, ())) - warm[stage]
        assert all(isinstance(k, int) or k[0] in ("prefill", "writer")
                   for k in new), (stage, new)


def _engine(presets, weights, **overrides):
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               model_preset=PRESET, **dict(KW, **overrides))
    return TorchEngine(tier, device="cpu", params=params_from_jax(
        presets[PRESET][1], weights[PRESET]))


def _rows(engine, blocks):
    """Both pools' rows of ``blocks`` (K, V and any scales)."""
    ix = torch.tensor(blocks)
    pools = [engine.pool] + ([engine.pool_d] if engine.spec else [])
    return [p[name][:, :, ix].clone() for p in pools for name in sorted(p)]


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_program_built_for_one_request_serves_another(presets, weights,
                                                      kv_quantize):
    """Each admission program is built with request A's inputs staged and
    run again with request B's (another length, bucket rows, blocks,
    chunk start and copy-on-write pair); B's first tokens and the rows it
    wrote equal a fresh engine's, which builds every program for B."""
    kw = dict(draft_preset=PRESET, spec_decode=True, kv_quantize=kv_quantize)
    used, fresh = (_engine(presets, weights, **kw) for _ in range(2))
    assert used.spec and fresh.spec
    a_ids = used.tokenizer.encode(COLD[2])[:40]
    b_ids = used.tokenizer.encode(LONG)[:57]
    blocks_a, blocks_b = [1, 2, 3, 4], [9, 7, 12, 5, 6]
    firsts = {}
    for engine in (used, fresh):
        out = []
        for ids, blocks in ((a_ids, blocks_a), (b_ids, blocks_b)):
            if engine is fresh and ids is a_ids:
                continue
            # A cold prefill of the 64 bucket and its writers.
            out.append(engine._prefill_first(ids, 64, 0.0, blocks))
            # A suffix chunk over the same blocks at a mid-block start,
            # and a copy-on-write of one of them.
            start = 19 if ids is a_ids else 37
            out.append(engine._chunk_first(ids[start:], 32, start, len(ids),
                                           blocks, 256, 0.0, draft=True))
            engine._cow_copy(blocks[1], blocks[-1])
        firsts[engine is used] = out
        assert set(engine._programs) >= {
            ("prefill", 64), ("writer", 4), ("chunk_prefill", (32, 256)),
            ("writer", "cow_copy"), ("writer", "cow_copy_draft"),
            ("draft", ("prefill", 64)), ("draft", ("writer", 4)),
            ("draft", ("chunk", 32, 256))}
    assert firsts[True][2:] == firsts[False]
    for got, want in zip(_rows(used, blocks_b), _rows(fresh, blocks_b)):
        assert torch.equal(got, want)
    for engine in (used, fresh):
        engine.stop()


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_replays_count_prefill_and_chunk_launches(presets, weights,
                                                  monkeypatch, kv_quantize):
    """The CPU attention paths stand in for the kernels (each call counts
    one K2 or K3 launch, as the wrappers count on the card); the
    programs are built with a fake graph."""
    causal, paged_chunk = TA.causal, TA.paged_chunk

    def k2(q, k, v):
        TF.flash_causal_attention.launches += 1
        return causal(q, k, v)

    def k3(q, k_pool, v_pool, table, start, q_pos, window, *scales):
        if not scales:                   # an int8 pool has no kernel
            TF.paged_chunk_attention.launches += 1
        return paged_chunk(q, k_pool, v_pool, table, start, q_pos, window,
                           *scales)

    monkeypatch.setattr(TA, "causal", k2)
    monkeypatch.setattr(TA, "paged_chunk", k3)
    engine = _engine(presets, weights, kv_quantize=kv_quantize)
    graphs = []

    def fake_capture(body):
        graphs.append(_FakeGraph())
        return TickProgram(body, graphs[-1],
                           lambda g: contextlib.nullcontext())

    engine._make_program = fake_capture
    layers = engine.cfg.num_layers
    ids = engine.tokenizer.encode(COLD[1])
    before, calls = launches.counts(), launches.call_counts()
    engine._prefill_first(ids, 32, 0.0, [1, 2])
    engine._chunk_first(ids[5:], 16, 5, len(ids), [1, 2], 256, 0.0)
    prefill, writer, chunk = (engine._programs[k] for k in (
        ("prefill", 32), ("writer", 2), ("chunk_prefill", (16, 256))))
    # On the CPU each kernel's plain version runs beside its stand-in;
    # an int8 pool's chunk has no kernel, only its plain path.
    assert (prefill.launch_deltas, prefill.call_deltas) == (
        {"flash_causal": layers}, {"causal_attention": layers})
    assert (writer.launch_deltas, writer.call_deltas) == ({}, {})
    chunk_calls = ("_dequant_chunk_paged" if kv_quantize == "int8"
                   else "_gather_chunk_paged")
    assert chunk.call_deltas == {chunk_calls: layers}
    assert chunk.launch_deltas == (
        {} if kv_quantize == "int8" else {"paged_chunk": layers})
    launched = {**prefill.launch_deltas, **chunk.launch_deltas}
    called = {"causal_attention": layers, chunk_calls: layers}

    def counted_runs(runs):
        """A capture counts nothing: the counts are ``runs`` replays'."""
        assert [g.replays for g in graphs] == [runs] * 3
        assert launches.since(before) == {
            name: runs * n for name, n in launched.items()}
        assert launches.since(calls, launches.call_counts()) == {
            name: runs * n for name, n in called.items()}

    counted_runs(1)
    for _ in range(3):
        engine._prefill_first(ids, 32, 0.0, [1, 2])
        engine._chunk_first(ids[5:], 16, 5, len(ids), [1, 2], 256, 0.0)
    counted_runs(4)
    engine.stop()
