"""The port's routing layer against the JAX package's, on the CPU.

- Embedders on a fixed query list, within 1e-5 abs: ``HashedNgramEmbedder``
  (the hashed features bit-identical, the projection a float32 matmul),
  ``TrainedEncoder`` (both heads; the port's copy of the weights file) and
  the hybrid space ``get_embedder("hybrid-lexsem-v1")``.
- ``QueryCache``: the same scripted inserts, lookups (exact and semantic),
  TTL expiry and evictions give the same predictions and stats.
- Every strategy's ``RoutingDecision`` (device, method, confidence within
  1e-5) over the same queries and contexts.  A semantic decision whose
  centroid margin or similarity floor lies within 1e-5 of its threshold
  is a tie: the two packages may fall on either side, so it is recorded
  (and bounded) instead of compared.
- ``QueryRouter`` in production mode over the reference demo flow
  (warm-up, repeated queries, a paraphrase hit), ``change_strategy`` and
  the unknown-strategy error.
"""

from __future__ import annotations

import numpy as np
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.routing import cache as JC
from distributed_llm_tpu.routing import embedder as JE
from distributed_llm_tpu.routing import encoder as JEnc
from distributed_llm_tpu.routing import engine as JR
from distributed_llm_tpu.routing import strategies as JS
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.routing import cache as TC
from distributed_llm_tpu_torch.routing import embedder as TE
from distributed_llm_tpu_torch.routing import encoder as TEnc
from distributed_llm_tpu_torch.routing import engine as TR
from distributed_llm_tpu_torch.routing import strategies as TS

ATOL = 1e-5
TIE = 1e-5

QUERIES = [
    "hello", "hi there, how are you?", "what is 2+2", "what's the capital "
    "of France?", "Give me a short definition of photosynthesis",
    "tell me a joke", "thanks!", "benefits of drinking water daily",
    "Implement a dynamic-programming solution to the knapsack problem and "
    "analyze its complexity",
    "Compare the trade-offs of microservices versus a monolith for a "
    "startup", "prove that the square root of 2 is irrational",
    "Write a comprehensive research proposal with methodology and "
    "evaluation criteria",
    "def f(x): return x == 1; class A: pass", "why is the sky blue? what "
    "makes sunsets red? and why are clouds white?",
    "I have had chronic migraines and fatigue for weeks, what treatment "
    "plan should I discuss with my physician?",
    "summarize everything we discussed so far", "", "ok",
    "explain quantum computing in simple terms",
    "design a scalable distributed system for real-time chat with "
    "websockets and a load balancer",
]
CONTEXTS = [None, "user: hi\nassistant: hello! how can I help?",
            "user: " + "tell me about rivers and lakes " * 120]


def test_hashed_embedder_matches_jax():
    port = TE.HashedNgramEmbedder(device="cpu").encode(QUERIES)
    want = JE.HashedNgramEmbedder().encode(QUERIES)
    # The features JAX's embedder serves come from its C++ featurizer,
    # which sums each bump in float64 and rounds on store; the port's
    # Python twin does the same (JAX's own Python twin sums in float32
    # under numpy 2, and may land one ulp away).
    from distributed_llm_tpu import native as JN
    for q in QUERIES[:5]:
        np.testing.assert_array_equal(
            TE._features(q.lower()),
            JN.featurize_batch([q.lower()], TE.FEATURE_DIM)[0])
    assert port.shape == (len(QUERIES), TE.EMBED_DIM)
    np.testing.assert_allclose(port, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("head", ["meaning", "class"])
def test_trained_encoder_matches_jax(head):
    port = TEnc.TrainedEncoder(device="cpu").encode(QUERIES, head=head)
    want = JEnc.TrainedEncoder().encode(QUERIES, head=head)
    assert port.shape == (len(QUERIES), TEnc.ENCODER_DIM)
    np.testing.assert_allclose(port, np.asarray(want), atol=ATOL, rtol=0)


def test_hybrid_embedder_matches_jax():
    port = TE.get_embedder("hybrid-lexsem-v1", "cpu")
    want = JE.get_embedder("hybrid-lexsem-v1")
    assert isinstance(port, TE.HybridEmbedder)
    assert isinstance(want, JE.HybridEmbedder)
    np.testing.assert_allclose(port.encode(QUERIES),
                               np.asarray(want.encode(QUERIES)),
                               atol=ATOL, rtol=0)


def test_query_cache_behaves_alike(monkeypatch):
    """The same script on both caches under one fake clock: inserts,
    exact and semantic hits, a miss under another context key, history
    voting, capacity eviction and TTL expiry."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(JC, "_utcnow", lambda: clock["t"])
    monkeypatch.setattr(TC, "_utcnow", lambda: clock["t"])
    emb = TE.HashedNgramEmbedder(device="cpu")
    vec = {q: v for q, v in zip(QUERIES, emb.encode(QUERIES))}

    def script(mod):
        cache = mod.QueryCache(max_size=4, ttl_seconds=60,
                               similarity_threshold=0.40)
        out = []

        def look(q, ctx="c", e=None):
            hit = cache.lookup(q, ctx, vec.get(e or q))
            out.append(None if hit is None else
                       (hit.entry.query, hit.predicted_device,
                        round(hit.predicted_confidence, 6),
                        hit.use_hybrid_fallback))

        cache.insert("hello", "c", "nano", 0.9, "heuristic", vec["hello"])
        cache.insert("what is 2+2", "c", "nano", 0.8, "token",
                     vec["what is 2+2"])
        cache.insert("what is 2+2", "c", "orin", 0.95, "hybrid",
                     vec["what is 2+2"])
        look("hello")
        look("HELLO ")                         # exact after normalization
        look("what is 2+2")                    # mixed history vote
        look("hello", ctx="other")             # other context: miss
        look("hi there, how are you?")         # semantic scan
        for q in QUERIES[8:12]:                # over capacity: evictions
            clock["t"] += 1.0
            cache.insert(q, "c", "orin", 0.92, "heuristic", vec[q])
        look("hello")
        clock["t"] += 120.0                    # every entry past its TTL
        look(QUERIES[11])
        stats = cache.stats()
        out.append({k: stats[k] for k in ("size", "valid", "hits",
                                          "attempts", "evictions",
                                          "hybrid_fallbacks")})
        return out

    assert script(TC) == script(JC)


def _sims(strategy, query):
    emb = strategy.embedder.encode([query])[0]
    return (JE.cosine(emb, strategy.nano_centroid),
            JE.cosine(emb, strategy.orin_centroid))


def _is_tie(jax_semantic, query) -> bool:
    """A query whose semantic margin or similarity floor is within TIE of
    its threshold (on the JAX side's numbers)."""
    sn, so = _sims(jax_semantic, query)
    floor = jax_semantic.min_similarity
    return (abs(abs(so - sn) - jax_semantic.margin_threshold) < TIE
            or abs(max(sn, so) - floor) < TIE or abs(so - sn) < TIE)


@pytest.mark.parametrize("mode", ["benchmark", "production"])
def test_every_strategy_decides_like_jax(mode):
    cfg_j = (jax_config.BENCHMARK_CFG if mode == "benchmark"
             else jax_config.PRODUCTION_CFG)
    cfg_t = (torch_config.BENCHMARK_CFG if mode == "benchmark"
             else torch_config.PRODUCTION_CFG)
    assert cfg_t == cfg_j
    jax_sem = JS.SemanticStrategy(dict(cfg_j))
    ties = []
    for name in ("token", "semantic", "heuristic", "hybrid", "perf"):
        jcls, tcls = JS.AVAILABLE_STRATEGIES[name], TS.AVAILABLE_STRATEGIES[name]
        if name in ("semantic", "hybrid"):
            js, ts = jcls(dict(cfg_j)), tcls(dict(cfg_t), device="cpu")
        else:
            js, ts = jcls(dict(cfg_j)), tcls(dict(cfg_t))
        for i, q in enumerate(QUERIES):
            ctx = CONTEXTS[i % len(CONTEXTS)]
            if name == "perf" and i % 3 == 0:
                for s in (js, ts):            # the same feedback on both
                    s.update("nano", 40.0 + i, 8, ok=i % 6 != 0)
                    s.update("orin", 90.0 + i, 12)
            a, b = ts.route(q, ctx), js.route(q, ctx)
            if name in ("semantic", "hybrid") and _is_tie(jax_sem, q):
                ties.append((name, q))
                continue
            assert (a.device, a.method) == (b.device, b.method), (name, q)
            assert abs(a.confidence - b.confidence) <= ATOL, (name, q)
            assert a.transient == b.transient
    # Ties are recorded, and rare on this list.
    assert len(ties) <= 2, ties


def test_query_router_demo_flow_matches_jax():
    """The reference demo: warm-up, the same queries twice under one
    context key (the second pass hits the routing cache), and a paraphrase
    hit under the production config."""
    jr = JR.QueryRouter("hybrid", dict(jax_config.PRODUCTION_CFG))
    tr = TR.QueryRouter("hybrid", dict(torch_config.PRODUCTION_CFG),
                        device="cpu")
    pairs = [("hello", "demo", "nano"),
             ("Implement a distributed cache with consistent hashing",
              "demo", "orin")]
    jr.warm_up_cache(pairs)
    tr.warm_up_cache(pairs)
    flow = ["hello", "what is 2+2",
            "Implement a dynamic-programming solution to the knapsack "
            "problem and analyze its complexity"] * 2
    flow += ["What is the capital city of France?",
             "what's the capital of france"]          # a paraphrase pair
    for q in flow:
        a = tr.route_query(q, context=None, context_key="demo")
        b = jr.route_query(q, context=None, context_key="demo")
        assert (a.device, a.method, a.cache_hit) == (
            b.device, b.method, b.cache_hit), q
        assert abs(a.confidence - b.confidence) <= ATOL, q
    assert [q["query"] for q in tr.get_cache_stats()["top_queries"]] == \
        [q["query"] for q in jr.get_cache_stats()["top_queries"]]
    stats_t, stats_j = tr.get_cache_stats(), jr.get_cache_stats()
    for key in ("size", "hits", "attempts", "hybrid_fallbacks"):
        assert stats_t[key] == stats_j[key], key
    assert stats_t["hits"] >= 3              # the second pass hit


def test_change_strategy_and_unknown_strategy_match_jax():
    tr = TR.QueryRouter("token", dict(torch_config.BENCHMARK_CFG),
                        device="cpu")
    jr = JR.QueryRouter("token", dict(jax_config.BENCHMARK_CFG))
    for r in (tr, jr):
        r.change_strategy("heuristic")
        assert r.strategy == "heuristic"
        with pytest.raises(ValueError, match="Unknown strategy"):
            r.change_strategy("oracle")
        assert r.strategy == "heuristic"     # the old strategy stays live
    with pytest.raises(ValueError) as t_err:
        TR.QueryRouter("oracle", device="cpu")
    with pytest.raises(ValueError) as j_err:
        JR.QueryRouter("oracle")
    assert str(t_err.value) == str(j_err.value)
    assert set(TS.AVAILABLE_STRATEGIES) == set(JS.AVAILABLE_STRATEGIES)
