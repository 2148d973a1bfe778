"""The sequential engines' programs against the JAX engines' compiled
functions.

Every device stage of the port's ``InferenceEngine`` and
``SpeculativeEngine`` is a program (``engine/programs.py``: on the card a
CUDA graph replayed on static inputs, on the CPU the same body run
directly), keyed as the JAX engines key their jitted functions, each
with the cache rung it runs on (the shape a JAX key leaves to its
trace).  Here, on the CPU (``device="cpu"``), with float32 copies of the
tiny presets at ``max_seq_len=1024`` (so the cache ladder has two rungs,
256 and 1024, and a conversation can grow from one to the other) and
the seeded numpy weights of ``test_torch_sequential.py``:

- after ``warmup()`` and the same traffic on both packages (cold prompts
  in three buckets, a prompt past the largest bucket, a follow-up that
  hits the parked prefix and grows its rung, and a stream), the port's
  program keys equal the JAX engine's ``_prefill_fns``, ``_grow_fns``
  and ``_decode_fns`` keys, and each suffix key's rungs are as many as
  the shapes JAX traced it at; the greedy tokens are identical, with
  bf16 KV, int8 KV and int8 weights, and on the speculative engine
  (``_prefill_fns``, and the round programs' rungs against the shapes
  JAX traced ``_spec_step`` at);
- the programs' greedy tokens equal an eager decode from the model
  functions themselves (a cold prompt: prefill, seed the cache, one
  ``decode_step`` a token);
- a program built while one request's inputs were staged, run after
  another's, gives the second request's tokens and cache rows, equal at
  float32 to a fresh engine's (the guard against a per-request value
  frozen into a program);
- with a fake graph, a capture counts no launch and every replay adds the
  causal prefill (K2), contiguous decode (K9, K10 int8) and contiguous
  chunk (K11, K12 int8) launches its capture counted;
- a runtime temperature reaches the programs without a new program, and
  the first token's draws follow the softmax.

On the CPU a program runs its body, so the replayed-against-eager
equality on the same live cache is chip_smoke's (phases 7-9b).
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.engine.inference import InferenceEngine as JaxEngine
from distributed_llm_tpu.engine.speculative import SpeculativeEngine as JaxSpec
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.engine.inference import (
    SEGMENT, InferenceEngine, prepare_prompt, to_device)
from distributed_llm_tpu_torch.engine.programs import TickProgram
from distributed_llm_tpu_torch.engine.speculative import SpeculativeEngine
from distributed_llm_tpu_torch.models import transformer
from distributed_llm_tpu_torch.models.convert import params_from_jax
from distributed_llm_tpu_torch.ops import attention as TA
from distributed_llm_tpu_torch.ops import flash_attention as TF
from distributed_llm_tpu_torch.ops import launches
from test_torch_compiled_tick import _FakeGraph
from test_torch_engine import _tree
from test_torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


MAX_SEQ = 1024
F32 = {name: f"{name}_f32_1k" for name in ("nano_test", "orin_test",
                                           "draft_test")}

# Buckets 16, 32 and 64; LONG (67 tokens) prefills in two 64-token
# chunks; TURN1 (238 tokens) parks on the 256 rung, and a follow-up of it
# needs the 1024 rung: the parked cache grows.
COLD = ["rivers 0",
        "tell me about the tallest hills and the deepest lakes of the "
        "world today",
        "long question: " + "rivers lakes mountains oceans " * 6]
LONG = "user: " + " ".join(f"word{i}" for i in range(25))
TURN1 = "user: " + " ".join(f"alpha{i}" for i in range(41))


@pytest.fixture(scope="module")
def weights():
    """preset -> (JAX params, numpy tree) of float32 copies at
    ``max_seq_len=1024`` registered in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for i, (base, name) in enumerate(F32.items()):
            for cfgmod in (jax_config, torch_config):
                mp.setitem(cfgmod.MODEL_PRESETS, name, dataclasses.replace(
                    cfgmod.MODEL_PRESETS[base], name=name, dtype="float32",
                    max_seq_len=MAX_SEQ))
            tree = _tree(torch_config.MODEL_PRESETS[name], seed=i)
            out[name] = (jax.tree_util.tree_map(jnp.asarray, tree), tree)
        yield out


def _tiers(tier="nano", **overrides):
    """(JAX tier, port tier) of ``tiny_cluster()`` on the float32 preset."""
    jt = getattr(jax_config.tiny_cluster(), tier)
    tt = getattr(torch_config.tiny_cluster(), tier)
    kw = dict(model_preset=F32[jt.model_preset], tp=1, **overrides)
    return dataclasses.replace(jt, **kw), dataclasses.replace(tt, **kw)


def _port(weights, tier="nano", **overrides) -> InferenceEngine:
    ttier = _tiers(tier, **overrides)[1]
    return InferenceEngine(ttier, device="cpu", params=params_from_jax(
        ttier.model(), weights[ttier.model_preset][1]))


def _pair(weights, tier="nano", **overrides):
    jtier = _tiers(tier, **overrides)[0]
    return (JaxEngine(jtier, params=weights[jtier.model_preset][0]),
            _port(weights, tier, **overrides))


def _spec_pair(weights, gamma: int = 3):
    """(JAX, port) SpeculativeEngine: orin's preset verifying the draft
    preset's drafts, both packages on the same weights."""
    jt, tt = _tiers("orin", max_new_tokens=12)
    jd, td = (dataclasses.replace(t, model_preset=F32["draft_test"])
              for t in (jt, tt))
    (jp_t, tree_t), (jp_d, tree_d) = (weights[t.model_preset]
                                      for t in (tt, td))
    return (JaxSpec(jt, jd, gamma=gamma, target_params=jp_t,
                    draft_params=jp_d),
            SpeculativeEngine(tt, td, gamma=gamma, device="cpu",
                              target_params=params_from_jax(tt.model(),
                                                            tree_t),
                              draft_params=params_from_jax(td.model(),
                                                           tree_d)))


def traffic(engine, hits: bool = True) -> list:
    """Cold prompts in three buckets, a prompt past the largest bucket,
    with ``hits`` a follow-up of a parked 238-token turn (a prefix hit
    growing its rung), and a stream: every request's tokens."""
    out = [engine.generate(p).token_ids for p in COLD + [LONG]]
    if hits:
        first = engine.generate(TURN1)
        follow = engine.generate(TURN1 + "\nassistant: " + (first.text or "x")
                                 + "\nuser: and what more of the lakes?")
        out += [first.token_ids, follow.token_ids]
    handle = engine.generate_stream(COLD[1] + " again")
    text = "".join(handle)
    assert text == handle.result.text
    return out + [handle.result.token_ids]


def _families(engine) -> dict:
    """The port's program keys as the JAX engine's three tables hold
    them: the prefill and suffix programs, the cache copies, the decode
    segments (by rung)."""
    fam = {"prefill": set(), "grow": set(), "decode": set()}
    for key in engine.program_shapes():
        if isinstance(key, int):
            fam["decode"].add(key)
        elif key[0] in ("init", "grow"):
            fam["grow"].add(key)
        else:
            fam["prefill"].add(key)
    return fam


PLAIN_CASES = {"bf16": {}, "kv_int8": dict(kv_quantize="int8"),
               "w_int8": dict(quantize="int8")}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_program_keys_and_tokens_match_jax(weights, case):
    jax_engine, port = _pair(weights, enable_prefix_cache=True,
                             **PLAIN_CASES[case])
    assert port._cache_lens == jax_engine._cache_lens == [256, MAX_SEQ]
    buckets = {prepare_prompt(port.tokenizer, p, port._buckets,
                              port._max_seq, 8)[1] for p in COLD}
    assert buckets == {16, 32, 64}
    for engine in (jax_engine, port):
        engine.warmup()
    warm = set(port._programs)
    assert warm == set(port.warm_set())
    assert traffic(port) == traffic(jax_engine)
    assert [e.prefix_cache.stats()["hits"] for e in (jax_engine, port)] \
        == [1, 1]
    fam = _families(port)
    assert fam == {"prefill": set(jax_engine._prefill_fns),
                   "grow": set(jax_engine._grow_fns),
                   "decode": set(jax_engine._decode_fns)}
    # The follow-up grew its parked cache from rung 256 to 1024.
    assert ("grow", 256, MAX_SEQ) in fam["grow"]
    # A suffix key names the rungs JAX traced it at.
    shapes = port.program_shapes()
    for key, fn in jax_engine._prefill_fns.items():
        if key[0] == "suffix":
            assert len(shapes[key]) == fn._cache_size(), key
    # Only what JAX leaves out of its warm set was built by the traffic:
    # the grow copy, the long prompt's chunk start and windows on its
    # rung (JAX warms them at a max-length prompt's rung only).
    late = set(port._programs) - warm
    assert {key for key, _ in late} <= {("grow", 256, MAX_SEQ),
                                        ("init", 256), ("suffix", 64, 64),
                                        ("suffix", 64, 256)}, late


def test_speculative_program_keys_and_tokens_match_jax(weights):
    jax_engine, port = _spec_pair(weights)
    assert port._cache_lens == [256, MAX_SEQ]
    for engine in (jax_engine, port):
        engine.warmup()
    assert set(port._programs) == set(port.warm_set())
    assert traffic(port, hits=False) == traffic(jax_engine, hits=False)
    assert port.accept_history == jax_engine.accept_history
    shapes = port.program_shapes()
    assert {k for k in shapes if k[0] != "round"} == set(
        jax_engine._prefill_fns)
    rounds = {c for k in shapes if k[0] == "round" for c in shapes[k]}
    loops = {k[1] for k in jax_engine._prefill_fns if k[0] == "loop"}
    assert rounds == loops
    assert len(rounds) == jax_engine._spec_fn._cache_size()


def _eager_greedy(engine: InferenceEngine, prompt: str) -> list:
    """A cold prompt decoded greedily from the model functions, no
    program: prefill the bucket, seed a cache of the engine's rung, then
    one ``decode_step`` per token until EOS/PAD or the budget."""
    tier, tok = engine.tier, engine.tokenizer
    ids, bucket = prepare_prompt(tok, prompt, engine._buckets,
                                 engine._max_seq, tier.max_new_tokens)
    n = len(ids)
    cache_len = engine._pick_cache_len(max(n + tier.max_new_tokens, bucket))
    tokens = torch.full((1, bucket), tok.pad_id, dtype=torch.long)
    tokens[0, :n] = torch.tensor(ids)
    hidden, (k_all, v_all) = transformer.prefill(
        engine.cfg, engine.model, tokens, torch.arange(bucket)[None])
    cache = transformer.seed_kv_cache(engine.cfg, k_all, v_all, cache_len,
                                      tier.kv_quantize)
    out = [int(transformer.logits_from_hidden(
        engine.model, hidden[:, n - 1]).argmax(-1))]
    budget = min(tier.max_new_tokens, cache_len - n)
    while len(out) < budget and out[-1] not in (tok.eos_id, tok.pad_id):
        logits = transformer.decode_step(
            engine.cfg, engine.model, to_device([out[-1]], "cpu", torch.long),
            to_device([n + len(out) - 1], "cpu"), cache)
        out.append(int(logits.argmax(-1)))
    return [t for t in out if t not in (tok.eos_id, tok.pad_id)]


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_programs_give_the_eager_decode(weights, case):
    port = _port(weights, **PLAIN_CASES[case])
    for prompt in COLD:
        got = port.generate(prompt).token_ids
        assert got == _eager_greedy(port, prompt)
        assert len(set(got)) > 3            # not a degenerate repeat


def _rows(cache, upto: int) -> list:
    return [cache[name][:, :, :upto].clone() for name in sorted(cache)]


class _ReplayGraph(_FakeGraph):
    """Stands in for a captured CUDA graph: each replay re-runs the
    captured body on the static buffers it was captured against.  A
    replay calls no wrapper, so what the body's run counts is taken back
    (``TickProgram.run`` adds what the capture counted)."""

    def __init__(self, body):
        super().__init__()
        self.body = body

    def replay(self):
        super().replay()
        before = (launches.counts(), launches.call_counts(),
                  launches.route_counts())
        self.body()
        launches.add(launches.since(before[0]), -1)
        launches.add_calls(launches.since(before[1], launches.call_counts()),
                           -1)
        launches.add_routes(
            launches.since(before[2], launches.route_counts()), -1)


@contextlib.contextmanager
def _without_effect(engine):
    """A capture records its body and runs nothing: every engine tensor
    (static inputs and outputs, working caches) and generator the body
    changes while it is recorded is put back."""
    tensors = [x for x in vars(engine).values() if isinstance(x, torch.Tensor)]
    tensors += engine._dev.values()
    for caches in engine._caches.values():
        for cache in (caches if isinstance(caches, tuple) else (caches,)):
            tensors += cache.values()
    saved = [(x, x.clone()) for x in tensors]
    gens = [(g, g.get_state()) for g in engine._generators]
    try:
        yield
    finally:
        for x, copy in saved:
            x.copy_(copy)
        for g, state in gens:
            g.set_state(state)


def _captured_as_on_the_card(engine) -> dict:
    """Every program the engine builds from now on made as
    ``capture_program`` makes it on the card: one warm run of the body
    from whatever is staged, a capture without effect, and replays that
    re-run the captured body (``_ReplayGraph``)."""
    graphs = {}

    def capture(body):
        body()
        graph = _ReplayGraph(body)
        prog = TickProgram(body, graph, lambda g: _without_effect(engine))
        graphs[id(prog)] = graph
        return prog

    engine._make_program = capture
    return graphs


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_program_built_for_one_request_serves_another(weights, kv_quantize):
    """Every program (a cold prefill and decode of the 32 bucket, a
    chunked prefill's init and windows, all on rung 256) built with
    request A's inputs staged (other lengths, a sampled temperature), then
    run for request B: B's tokens and the cache rows it wrote equal a
    fresh engine's, which builds every program for B."""
    used, fresh = (_port(weights, kv_quantize=kv_quantize,
                         enable_prefix_cache=False) for _ in range(2))
    graphs = _captured_as_on_the_card(used)
    a_cold = COLD[1]                         # 25 tokens: the 32 bucket
    b_cold = ("tell me about the widest rivers and the coldest seas of the "
              "far north")                   # 23 tokens
    a_long, b_long = LONG, LONG + " and more words"
    for prompt in (a_cold, a_long):
        used.generate(prompt, temperature=0.9)
    built = set(used._programs)
    for b in (b_cold, b_long):
        want, got = fresh.generate(b), used.generate(b)
        assert got.token_ids == want.token_ids and got.gen_tokens > 2
        assert set(used._programs) == built
        upto = got.prompt_tokens + got.gen_tokens - 1
        for x, y in zip(_rows(used._cache(256), upto),
                        _rows(fresh._cache(256), upto)):
            assert torch.equal(x, y)
    assert sum(g.replays for g in graphs.values()) > len(graphs)


def test_speculative_round_built_for_one_request_serves_another(weights):
    used, fresh = (_spec_pair(weights)[1] for _ in range(2))
    graphs = _captured_as_on_the_card(used)
    used.generate(COLD[2])
    for _ in used.generate_stream(COLD[2]):
        pass
    built = set(used._programs)
    b = COLD[2] + " and the seas"            # the 64 bucket, as COLD[2]
    want = fresh.generate(b)
    got = used.generate(b)
    assert got.token_ids == want.token_ids
    stream = used.generate_stream(b)
    assert "".join(stream) == want.text
    assert set(used._programs) == built
    upto = got.prompt_tokens + got.gen_tokens - 1
    for a, w in zip(used._cache(256), fresh._cache(256)):
        for x, y in zip(_rows(a, upto), _rows(w, upto)):
            assert torch.equal(x, y)
    assert sum(g.replays for g in graphs.values()) > len(graphs)


def _conversation(engine) -> list:
    """A cold turn, then two follow-ups of it (on the plain engine, prefix
    hits that grow the parked cache), as the bench's ``spec_multiturn``
    leg drives them: every request's tokens, the stream's included."""
    first = engine.generate(TURN1)
    hist = TURN1 + "\nassistant: " + (first.text or "x") + "\nuser: lakes?"
    out = [first.token_ids]
    for extra in ("", " and fjords?"):
        out.append(engine.generate(hist + extra).token_ids)
    stream = engine.generate_stream(hist + " and seas?")
    "".join(stream)
    return out + [stream.result.token_ids]


@pytest.mark.parametrize("case", sorted(PLAIN_CASES) + ["speculative"])
def test_first_use_captures_keep_the_request(weights, case):
    """No ``warmup()``: every program is captured at its first use, in the
    middle of a request, as the ``/query`` app's and the bench's engines
    capture theirs.  The capture's warm run must not disturb the request
    it serves: its greedy tokens, the follow-ups' and a stream's equal a
    fresh eager engine's."""
    if case == "speculative":
        used, fresh = (_spec_pair(weights)[1] for _ in range(2))
    else:
        used, fresh = (_port(weights, enable_prefix_cache=True,
                             **PLAIN_CASES[case]) for _ in range(2))
    graphs = _captured_as_on_the_card(used)
    want = _conversation(fresh)
    assert _conversation(used) == want
    assert all(len(t) > 3 for t in want)
    assert set(used._programs) == set(fresh._programs)
    if case != "speculative":
        assert used.prefix_cache.stats()["hits"] == 3
        assert ("grow", 256, MAX_SEQ) in used.program_shapes()
    assert all(g.replays for g in graphs.values())


def _counting(monkeypatch):
    """The CPU attention dispatchers made to count one launch of the
    kernel the card would run (K2, K9/K10, K11/K12) per call."""
    causal, decode, chunk = TA.causal, TA.decode, TA.chunk

    def k2(q, k, v):
        TF.flash_causal_attention.launches += 1
        return causal(q, k, v)

    def k9(q, k, v, pos, *scales):
        (TF.flash_decode_attention_q8 if scales
         else TF.flash_decode_attention).launches += 1
        return decode(q, k, v, pos, *scales)

    def k11(q, k, v, q_pos, *scales):
        (TF.flash_chunk_attention_q8 if scales
         else TF.flash_chunk_attention).launches += 1
        return chunk(q, k, v, q_pos, *scales)

    monkeypatch.setattr(TA, "causal", k2)
    monkeypatch.setattr(TA, "decode", k9)
    monkeypatch.setattr(TA, "chunk", k11)


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_replays_count_prefill_decode_and_chunk_launches(weights, monkeypatch,
                                                         kv_quantize):
    _counting(monkeypatch)
    engine = _port(weights, kv_quantize=kv_quantize,
                   enable_prefix_cache=False)
    graphs = _captured_as_on_the_card(engine)
    layers = engine.cfg.num_layers
    q8 = "_q8" if kv_quantize == "int8" else ""
    before = launches.counts()
    for _ in range(2):
        engine.generate(COLD[0])
        engine.generate(LONG)
    progs = engine._programs
    assert {key: prog.launch_deltas for (key, _), prog in progs.items()} == {
        (16, 256): {"flash_causal": layers},
        256: {f"flash_decode{q8}": SEGMENT * layers},
        ("init", 256): {},
        ("suffix", 64, 64): {f"flash_chunk{q8}": layers},
        ("suffix", 64, 256): {f"flash_chunk{q8}": layers}}
    replays = {key: graphs[id(prog)].replays for (key, _), prog in
               progs.items()}
    # Two cold prefills, two long prompts of two chunks, and decode
    # segments replayed as the budget asks.  Each program's warm run
    # before its capture launched once; the capture counts nothing.
    assert replays[(16, 256)] == replays[("init", 256)] == 2
    assert replays[("suffix", 64, 64)] == replays[("suffix", 64, 256)] == 2
    assert replays[256] >= 4
    want = {}
    for (key, _), prog in progs.items():
        for name, n in prog.launch_deltas.items():
            want[name] = want.get(name, 0) + (replays[key] + 1) * n
    assert launches.since(before) == want


def test_speculative_replays_count_their_launches(weights, monkeypatch):
    _counting(monkeypatch)
    engine = _spec_pair(weights)[1]
    graphs = _captured_as_on_the_card(engine)
    lt, ld = engine.cfg_t.num_layers, engine.cfg_d.num_layers
    g = engine.gamma
    before = launches.counts()
    engine.generate(COLD[0])
    for _ in engine.generate_stream(COLD[0]):
        pass
    progs = {key: prog for (key, _), prog in engine._programs.items()}
    prefill = next(k for k in progs if isinstance(k[0], int))
    assert progs[prefill].launch_deltas == {"flash_causal": lt + ld}
    per_round = {"flash_decode": (g + 1) * ld, "flash_chunk": lt}
    rung = prefill[1]
    assert progs[("round", rung)].launch_deltas == per_round
    from distributed_llm_tpu_torch.engine.speculative import LOOP_ROUNDS
    assert progs[("loop", rung)].launch_deltas == {
        k: LOOP_ROUNDS * n for k, n in per_round.items()}
    want = {}
    for key, prog in progs.items():
        for name, n in prog.launch_deltas.items():
            want[name] = (want.get(name, 0)
                          + (graphs[id(prog)].replays + 1) * n)
    assert launches.since(before) == want
    assert graphs[id(progs[prefill])].replays == 2


def test_runtime_temperature_reaches_the_programs(weights):
    engine = _port(weights)
    engine.warmup()
    keys = set(engine._programs)
    greedy = engine.generate(COLD[1]).token_ids
    hot = [engine.generate(COLD[1], temperature=5.0).token_ids
           for _ in range(2)]
    assert set(engine._programs) == keys
    assert float(engine._dev["temp"][0]) == 5.0
    assert hot[0] != hot[1] and greedy not in hot
    assert engine.generate(COLD[1]).token_ids == greedy


def test_sampled_first_token_follows_the_softmax(weights):
    """The cold prefill program's draw at temperature 1, repeated, against
    the softmax of the prompt's last logits."""
    engine = _port(weights)
    ids, bucket = prepare_prompt(engine.tokenizer, COLD[0], engine._buckets,
                                 engine._max_seq, 8)
    tokens = torch.full((1, bucket), engine.tokenizer.pad_id,
                        dtype=torch.long)
    tokens[0, :len(ids)] = torch.tensor(ids)
    hidden, _ = transformer.prefill(engine.cfg, engine.model, tokens,
                                    torch.arange(bucket)[None])
    probs = torch.softmax(transformer.logits_from_hidden(
        engine.model, hidden[0, len(ids) - 1]), -1).numpy()
    n = 400
    draws = np.array([int(engine._prefill(ids, bucket, 256, 1.0)[0])
                      for _ in range(n)])
    assert len(engine._programs) == 1
    for tok in np.argsort(probs)[-5:]:
        p = probs[tok]
        freq = float(np.mean(draws == tok))
        assert abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1.0 / n, tok
