"""The port's bench (``bench/headline.py``), tester and query sets against
the JAX package's, and the phases on ``/stats``.

- ``query_sets`` equals the JAX package's, record for record.
- ``_iqr``, ``_aggregate_strategy`` and ``compact`` equal the root
  ``bench.py``'s on the same synthetic records (exactly: the same
  arithmetic and rounding); the bookkeeping (``Progress``,
  ``section_errors``) behaves as JAX's.
- A headline run on the CPU over ``tiny_batched_cluster()`` (one repeat,
  2 clients, the first 4 queries, one trend repeat) through ``main``:
  all five strategies with the headline's keys, the later sections (the
  features legs included, the flagship skipped on the CPU), exit 0 and a
  compact last line; a section that holds an error exits 1.
- The ``speculative`` and ``quant`` legs (``features_phase``) give the
  JAX package's keys on the tiny tiers, and ``flagship_phase`` with the
  tiny tiers passed in (orin with int8 weights) gives the keys the JAX
  ``flagship_phase`` gives over the same tiers (nano_1b and orin_8b are
  too large for a CPU test).
- ``/stats`` shows the phases after a ``/chat``: tokenize, prefill and
  decode on the sequential tiers (``tiny_cluster()``), prefill and decode
  with their work on the batched ones (the JAX batched engine times no
  tokenize phase either).
- The tester: ``SUMMARY_HEADERS`` and ``PER_QUERY_HEADERS`` are JAX's,
  its sweep grid is JAX's, and a one-config run on the CPU writes one
  summary row and one row per query with a TTFT.
"""

from __future__ import annotations

import csv
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)
from distributed_llm_tpu.bench import query_sets as jax_sets  # noqa: E402
from distributed_llm_tpu.bench import tester as jax_tester  # noqa: E402
from distributed_llm_tpu_torch import config as torch_config  # noqa: E402
from distributed_llm_tpu_torch.bench import headline  # noqa: E402
from distributed_llm_tpu_torch.bench import query_sets  # noqa: E402
from distributed_llm_tpu_torch.bench import tester  # noqa: E402


def test_query_sets_are_the_jax_packages():
    assert query_sets.query_sets == jax_sets.query_sets
    assert len(query_sets.query_sets["general_knowledge"]) == 12


def _record(i: int, cold: bool = False, errors: int = 0) -> dict:
    return {
        "sequential_req_per_s": 1.0 + 0.37 * i,
        "concurrent_req_per_s": 2.5 + 0.91 * i * i,
        "concurrent_p50_ttft_ms": None if i == 1 else 40.0 + 3.3 * i,
        "concurrent_errors": errors,
        "routing_accuracy": (7 + i % 3) / 12,
        "orin_queries": 3 + i % 2,
        "cold_start_accuracy": (6 + i) / 12 if cold else None,
        "explore": bool(i % 2) if cold else False,
    }


@pytest.mark.parametrize("n,cold,errors", [(1, False, 0), (3, False, 0),
                                           (2, True, 0), (4, True, 2)])
def test_aggregate_strategy_matches_bench_py(n, cold, errors):
    records = [_record(i, cold, errors if i == 0 else 0) for i in range(n)]
    ttfts = [10.5 + 1.25 * i for i in range(3 * n)]
    assert (headline._aggregate_strategy(records, ttfts)
            == jax_bench._aggregate_strategy(records, ttfts))
    assert (headline._aggregate_strategy(records, [])
            == jax_bench._aggregate_strategy(records, []))


@pytest.mark.parametrize("values", [[1.0, 2.0], [3.1, 0.4, 9.9, 2.2],
                                    [5.0, 5.0, 5.0]])
def test_iqr_matches_bench_py(values):
    assert headline._iqr(values) == jax_bench._iqr(values)


def _synthetic_result() -> dict:
    """A full result holding only the sections the port produces."""
    per = {s: jax_bench._aggregate_strategy([_record(i) for i in range(2)],
                                            [12.0, 14.0])
           for s in headline.STRATEGIES}
    return {
        "metric": headline.METRIC, "value": 3.21, "unit": "req/s",
        "vs_baseline": 293.8, "p50_ttft_ms": 12.5, "p50_latency_ms": 80.1,
        "routing_accuracy": 0.9, "decode_tok_per_s": 410.2,
        "backend": "cuda", "queries": 60, "mfu_prefill": None,
        "hbm_util_decode": None, "cluster": {"nano": "nano_1b",
                                             "orin": "orin_8b"},
        "sequential_req_per_s": 1.2, "concurrent_speedup": 2.6,
        "concurrent_p50_ttft_ms": 30.0, "sequential_p50_ttft_ms": 12.5,
        "concurrent_errors": 0, "trend_req_per_s": 40.5,
        "trend": {"trend_req_per_s": 40.5, "trend_iqr": 1.5, "repeats": 5},
        "req_per_s_stats": {"n": 1, "median": 3.21, "iqr": 0.0,
                            "values": [3.21]},
        "budget": {"budget_s": 1200.0, "repeats": 1, "scaled": "trimmed"},
        "per_strategy": per,
        "utilization": {"prefill": {"mfu": 0.31, "hbm_util": 0.02},
                        "decode": {"mfu": 0.01, "hbm_util": 0.41}},
        "continuous_batching": {"batching_speedup": 3.7,
                                "kv_int8": {"speedup_vs_bf16_kv": 1.05}},
        "long_context": {"prefix_reuse_speedup": 9.5},
        "orin_prefix": {"prefix_hits": 3, "followup_ttft_speedup": 4.2},
        "spill": {"warm_hit_rate": 1.0, "hit_rate_monotone": True,
                  "tbt_ratio": 0.98, "outputs_identical": True,
                  "off": {"warm_hit_rate": 0.3125,
                          "revisit_ttft_p50_ms": 21.0},
                  "small": {"warm_hit_rate": 0.5},
                  "large": {"warm_hit_rate": 1.0, "promotions": 11,
                            "demotions_total": 30,
                            "revisit_ttft_p50_ms": 9.5},
                  "race": {"observed": True, "races": 1,
                           "identical": True}},
        "speculative": {"gamma": 4, "speedup": 1.4},
        "quant": {"nano": {"speedup": 1.6}, "orin": {"speedup": 1.8}},
        "flagship": {"nano_1b": {"decode_tok_per_s": 88.0},
                     "orin_8b_int8": {"decode_tok_per_s": 30.1}},
        "spec_multiturn": {"plain_followup_ttft_ms": 11.0,
                           "spec_followup_ttft_ms": 35.2,
                           "spec_followup_ttft_cost": 3.2},
        "tiers": {"nano": {"phases": {}}},
    }


def test_compact_matches_bench_py():
    result = _synthetic_result()
    got = headline.compact(result)
    assert got == jax_bench.compact(result)
    assert got["mfu_prefill"] == 0.31 and got["hbm_util_decode"] == 0.41
    assert set(got["per_strategy"]) == set(headline.STRATEGIES)
    assert got["spill"]["warm_hit_rate"] == 1.0 and got["spill"]["ident"]
    partial = {"metric": headline.METRIC, "value": 0.0}
    assert headline.compact(partial) == jax_bench.compact(partial)


def test_progress_and_section_errors(tmp_path):
    path = tmp_path / "partial.json"
    p = headline.Progress(str(path))
    p.section("trend", {"error": "boom"})
    p.section("long_context", {"cold_ttft_ms": 1.0})
    assert json.loads(path.read_text())["trend"] == {"error": "boom"}
    p.finalize({"value": 1.0})
    assert json.loads(path.read_text()) == {"value": 1.0, "final": True}
    assert headline.section_errors({"a": {"b": {"error": "x"}}, "c": 1}) \
        == ["a.b"]
    assert headline.section_errors(_synthetic_result()) == []


HEADLINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "req_per_s_stats",
    "sequential_req_per_s", "concurrent_speedup", "concurrent_p50_ttft_ms",
    "sequential_p50_ttft_ms", "concurrent_errors", "p50_ttft_ms",
    "p50_latency_ms", "routing_accuracy", "decode_tok_per_s", "queries",
    "mfu_prefill", "hbm_util_decode", "utilization", "per_strategy",
    "tiers", "backend", "card", "cluster", "budget", "trend",
    "trend_req_per_s", "continuous_batching", "long_context", "orin_prefix",
    "spill", "speculative", "quant", "flagship"}
STRATEGY_KEYS = {"req_per_s", "sequential_req_per_s", "p50_ttft_ms",
                 "concurrent_p50_ttft_ms", "routing_accuracy",
                 "orin_queries", "repeats"}


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One small headline run on the CPU through ``main``: its result,
    exit code and stdout lines."""
    out_dir = tmp_path_factory.mktemp("bench")
    captured = {}
    real_run = headline.run

    def small_run(*args, **kw):
        captured["result"] = real_run(*args, n_queries=4, trend_repeats=1,
                                      **kw)
        return captured["result"]

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(out_dir)
        mp.setattr(headline, "run", small_run)
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = headline.main(["--device", "cpu", "--repeats", "1",
                                "--clients", "2"])
    return captured["result"], rc, buf.getvalue().strip().splitlines()


def test_headline_runs_on_the_cpu(cpu_run):
    result, rc, lines = cpu_run
    assert rc == 0
    assert HEADLINE_KEYS <= set(result)
    assert result["backend"] == "cpu" and result["card"] == "cpu"
    assert result["cluster"] == {"nano": "nano_test", "orin": "orin_test"}
    assert set(result["per_strategy"]) == set(headline.STRATEGIES)
    for entry in result["per_strategy"].values():
        assert STRATEGY_KEYS <= set(entry)
        assert entry["req_per_s"] > 0 and entry["p50_ttft_ms"] > 0
    assert "cold_start_accuracy" in result["per_strategy"]["perf"]
    assert result["concurrent_errors"] == 0
    assert result["value"] > 0 and result["queries"] == 4 * 5
    # No peaks on the CPU: achieved rates, no MFU or utilization.
    assert set(result["utilization"]) == {"prefill", "decode"}
    assert "mfu" not in result["utilization"]["decode"]
    for name, entry in result["tiers"].items():
        assert {"prefill", "decode"} <= set(entry["work"]), name
        assert (entry["phases"]["decode"]["count"]
                == entry["tick"]["ticks"]), name
    assert result["trend"]["device"] == "cpu"
    assert result["trend"]["repeats"] == 1
    assert result["continuous_batching"]["kv_int8"]["concurrent_req_per_s"] > 0
    assert set(result["quant"]) == {"nano", "orin"}
    assert all(q["int8_decode_tok_per_s"] > 0 for q in result["quant"].values())
    assert result["speculative"]["spec_decode_tok_per_s"] > 0
    assert "skipped" in result["flagship"]
    spill = result["spill"]
    assert spill["outputs_identical"] and spill["hit_rate_monotone"]
    assert spill["race"]["observed"] and spill["race"]["identical"]
    assert spill["large"]["promotions"] > 0 == spill["off"]["promotions"]
    assert headline.section_errors(result) == []
    assert json.loads(lines[-1]) == headline.compact(result)


def test_headline_exits_1_when_a_section_fails(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    result = dict(_synthetic_result(), trend={"error": "RuntimeError: x"})
    monkeypatch.setattr(headline, "run", lambda *a, **k: result)
    assert headline.main(["--device", "cpu"]) == 1


def test_headline_refuses_a_missing_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.run(None)


def test_stats_shows_the_phases_after_a_chat():
    from distributed_llm_tpu_torch.serving.app import create_app
    for cluster, want in ((torch_config.tiny_cluster(),
                           {"tokenize", "prefill", "decode"}),
                          (torch_config.tiny_batched_cluster(),
                           {"prefill", "decode"})):
        app = create_app(cluster=cluster, device="cpu")
        router = app.extensions["dllm_state"]["router"]
        try:
            client = app.test_client()
            resp = client.post("/chat", json={
                "message": "hello", "strategy": "heuristic",
                "session_id": "s-stats"})
            assert resp.status_code == 200
            tiers = client.get("/stats").get_json()["tiers"]
            used = [t for t in tiers.values() if t.get("phases")]
            assert used, tiers
            assert want <= set(used[0]["phases"])
            assert {"prefill", "decode"} <= set(used[0]["work"])
            assert "kv" in used[0] or "prefix_cache" in used[0]
        finally:
            router.drain(timeout_s=10)


def test_tester_headers_and_grid_are_the_jax_packages():
    assert tester.SUMMARY_HEADERS == jax_tester.SUMMARY_HEADERS
    assert tester.PER_QUERY_HEADERS == jax_tester.PER_QUERY_HEADERS
    argv = ["--query-set", "general_knowledge", "--thresholds", "100", "1000",
            "--strategies", "token", "heuristic", "--cache-modes", "off", "on"]
    got, want = tester.parse_args(argv), jax_tester.parse_args(argv)

    def grid(mod, args):
        fixed = (args.fixed_threshold if args.fixed_threshold is not None
                 else args.thresholds[-1])
        cfg = mod.RunConfig("general_knowledge", args.thresholds,
                            args.strategies, args.cache_modes, fixed,
                            "s.csv", "q.csv")
        return list(mod._experiment_grid(cfg))

    assert grid(tester, got) == grid(jax_tester, want)
    assert (tester.normalize_query_set(query_sets.query_sets["long_context"])
            == [tester.QueryItem(q.text, q.expected_device) for q in
                jax_tester.normalize_query_set(
                    jax_sets.query_sets["long_context"])])


def test_tester_writes_one_config_on_the_cpu(tmp_path):
    summary, per_query = tmp_path / "s.csv", tmp_path / "q.csv"
    tester.main(["--query-set", "general_knowledge", "--strategies",
                 "heuristic", "--cache-modes", "off", "--device", "cpu",
                 "--output-csv", str(summary),
                 "--output-per-query-csv", str(per_query)])
    with open(summary, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == jax_tester.SUMMARY_HEADERS and len(rows) == 2
    row = dict(zip(rows[0], rows[1]))
    assert row["strategy"] == "heuristic" and float(row["req_per_s"]) > 0
    with open(per_query, newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == jax_tester.PER_QUERY_HEADERS
    assert len(rows) == 12
    assert all(float(r["ttft_ms"]) > 0 for r in rows)


def test_headline_and_tester_share_the_bench_cluster():
    from distributed_llm_tpu_torch.serving.router import default_cluster
    assert default_cluster("cpu") == torch_config.tiny_batched_cluster()
    bc = torch_config.bench_cluster()
    assert (bc.nano.model_preset, bc.nano.decode_batch,
            bc.nano.max_new_tokens) == ("nano_1b", 8, 64)
    assert (bc.orin.model_preset, bc.orin.decode_batch,
            bc.orin.max_new_tokens) == ("orin_8b", 4, 128)
    assert all(t.attention_ragged and t.tp == 1 and t.quantize == "int8"
               for t in bc.tiers())
    for tier in bc.tiers():
        tier.check_ported()


def _keys(node):
    """The nested key structure of a result (values dropped)."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


def test_features_keys_match_jax():
    import dataclasses

    from distributed_llm_tpu import config as jax_config
    jc = jax_config.tiny_batched_cluster()
    jc = dataclasses.replace(jc, orin=dataclasses.replace(jc.orin, tp=1))
    want = jax_bench.features_phase(jc, n_prompts=1, max_new=2)
    got = headline.features_phase(torch_config.tiny_batched_cluster(), "cpu",
                                  n_prompts=1, max_new=2)
    assert _keys(got) == _keys(want)
    assert headline.section_errors(got) == []
    for leg in got["quant"].values():
        assert leg["bf16_decode_tok_per_s"] > 0
        assert leg["int8_decode_tok_per_s"] > 0


def test_flagship_keys_match_jax(monkeypatch):
    """The flagship section over the tiny tiers (orin with int8 weights)
    in both packages: the same labels and keys, every tier fitting its
    budget and decoding, nano's long-context leg with its follow-ups."""
    import dataclasses

    from distributed_llm_tpu import config as jax_config
    jc = jax_config.tiny_batched_cluster()
    jc = dataclasses.replace(jc, orin=dataclasses.replace(
        jc.orin, tp=1, quantize="int8"))
    monkeypatch.setattr(jax_config, "flagship_cluster",
                        lambda n_devices=None: jc)
    want = jax_bench.flagship_phase(max_new=2, n_prompts=1)
    tc = torch_config.tiny_batched_cluster()
    tc = dataclasses.replace(tc, orin=dataclasses.replace(tc.orin,
                                                          quantize="int8"))
    got = headline.flagship_phase(cluster=tc, device="cpu", max_new=2,
                                  n_prompts=1)
    assert _keys(got) == _keys(want)
    assert set(got) == {"nano_test", "orin_test_int8"}
    assert headline.section_errors(got) == []
    for entry in got.values():
        assert entry["fits"] and entry["decode_tok_per_s"] > 0
    assert len(got["nano_test"]["long_context"]["followup_ttft_ms"]) == 2
    assert headline.parse_args(["--flagship"]).flagship
    assert not headline.parse_args([]).flagship


def test_host_kv_bytes_flag_gives_the_sweep_tiers_a_spill_tier(monkeypatch):
    """``--host-kv-bytes`` (the JAX bench's ``DLLM_HOST_KV_BYTES``) sets
    both sweep tiers' ``host_kv_bytes``; absent, the cluster's own."""
    assert headline.parse_args([]).host_kv_bytes is None
    assert headline.parse_args(["--host-kv-bytes", "4096"]).host_kv_bytes \
        == 4096
    from distributed_llm_tpu_torch.serving import router as router_mod

    seen = {}

    class Stop(Exception):
        pass

    def fake_router(*args, cluster=None, **kw):
        seen["cluster"] = cluster
        raise Stop

    monkeypatch.setattr(router_mod, "Router", fake_router)
    for budget in (None, 4096):
        with pytest.raises(Stop):
            headline.run("cpu", host_kv_bytes=budget,
                         progress=headline.Progress(os.devnull))
        assert {seen["cluster"].nano.host_kv_bytes,
                seen["cluster"].orin.host_kv_bytes} == {budget}


def test_flagship_cluster_is_the_jax_packages_on_one_card():
    import dataclasses

    from distributed_llm_tpu import config as jax_config
    got = torch_config.flagship_cluster(1)
    want = jax_config.flagship_cluster(1)
    for name in ("nano", "orin"):
        t, j = getattr(got, name), getattr(want, name)
        for field in dataclasses.fields(t):
            assert getattr(t, field.name) == getattr(j, field.name), (
                name, field.name)
    assert torch_config.flagship_cluster(1, kv_int8=True).orin.kv_quantize \
        == "int8"
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        torch_config.flagship_cluster(5)


def test_spec_multiturn_keys_match_jax():
    """The bench's ``spec_multiturn`` leg on the tiny sequential cluster:
    the port's section carries the JAX leg's keys (root ``bench.py``),
    each a positive TTFT or cost, and ``compact`` reports the cost."""
    from distributed_llm_tpu.config import tiny_cluster as jax_tiny

    want = jax_bench.spec_multiturn_phase(jax_tiny(), max_new=4)
    got = headline.spec_multiturn_phase(torch_config.tiny_cluster(),
                                        device="cpu", max_new=4)
    assert "error" not in want and "error" not in got, (want, got)
    assert set(got) == set(want) == {"plain_followup_ttft_ms",
                                     "spec_followup_ttft_ms",
                                     "spec_followup_ttft_cost"}
    assert all(v > 0 for v in got.values())
    assert headline.compact({"spec_multiturn": got})["verdicts"][
        "spec_followup_ttft_cost"] == got["spec_followup_ttft_cost"]
