"""The v1 tester (``bench/legacy_tester.py``) and the analysis report
(``bench/analysis.py``) against the JAX package's.

- The v1 sweep writes the notebook's ``final_results.csv`` schema: the
  header is ``HEADERS`` and one row per threshold, each tier's latency,
  energy, average power and tokens.
- On stub telemetry (a constant 50 W draw) the port's sweep and the JAX
  package's give the same tiers and the same tokens per threshold on the
  trained tiny tiers at float32 presets, and the same average power.
- ``markdown_report`` equals the JAX package's (pandas) on the canonical
  tester's CSVs, on a CSV with missing cells, text in a numeric column
  and ties, and on a summary alone; both refuse the v1 CSV (it has the
  notebook's headers, not the v2 schema).  ``main`` writes the report;
  ``--plots-dir`` writes the plots, or raises an ``ImportError`` naming
  matplotlib where it is missing.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import sys

import pandas as pd
import pytest

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.bench import analysis as jax_analysis
from distributed_llm_tpu.bench import legacy_tester as jax_legacy
from distributed_llm_tpu.bench import tester as jax_tester
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.bench import analysis, legacy_tester, tester
from distributed_llm_tpu_torch.bench.query_sets import query_sets

QUERIES = query_sets["general_knowledge"][:3]
THRESHOLDS = [30, 1000]          # 30: the history outgrows it, so orin serves
WATTS = 50.0

EDGE_SUMMARY = """\
query_set,strategy,cache_mode,token_threshold,routing_accuracy,nano_total_latency_ms,nano_total_energy_mJ,nano_total_tokens,orin_total_latency_ms,orin_total_energy_mJ,orin_total_tokens,overall_total_tokens,req_per_s,p50_ttft_ms,p50_latency_ms,decode_tok_per_s
gk,token,off,1000,0.75,1200,3400.5,30,800,100,0,30,1.5,12.3,40,
gk,token,off,100,,1300,0,0,900,10.25,12,12,2,,41.5,100
gk,heuristic,on,1000,1.0,0,0,0,900,10.25,12,12,abc,3,41.5,100
ph,perf,off,1000,0.5,10,1,1,1,1,1,2,0.1,1,1,1
"""
EDGE_PER_QUERY = """\
strategy,device_used,latency_ms,query_text
token,nano,100,hello
token,orin,300,"a, quoted"
heuristic,nano,300,
perf,,50,x
token,nano,,y
token,orin,7,z
"""


class StubTelemetry:
    """A constant draw: every window integrates WATTS x its length."""

    def start(self):
        pass

    def stop(self):
        pass

    def energy_for_window(self, tier, start, end):
        return WATTS * 1000.0 * (end - start).total_seconds()


@pytest.fixture
def float32_presets(monkeypatch):
    for table in (jax_config.MODEL_PRESETS, torch_config.MODEL_PRESETS):
        for name in ("nano_test", "orin_test"):
            monkeypatch.setitem(table, name, dataclasses.replace(
                table[name], dtype="float32"))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_v1_csv_schema_and_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(legacy_tester, "_build_telemetry",
                        lambda device=None: StubTelemetry())
    out = tmp_path / "final_results.csv"
    results = legacy_tester.ChatbotTester(
        QUERIES, THRESHOLDS, strategy="token", device="cpu").run(
        "general_knowledge", str(out))
    rows = _rows(out)
    assert rows[0] == legacy_tester.HEADERS
    assert [int(r[1]) for r in rows[1:]] == THRESHOLDS
    for row in rows[1:]:
        rec = dict(zip(rows[0], row))
        assert rec["Query Set"] == "general_knowledge"
        served = 0
        for tier in ("Nano", "Orin"):
            lat = int(rec[f"{tier} Latency (ms)"])
            tokens = int(rec[f"{tier} Tokens Generated"])
            served += tokens
            if lat:
                assert float(rec[f"{tier} Avg Power (W)"]) == \
                    pytest.approx(WATTS, abs=1.0)
        assert served == sum(results[int(rec["Context Threshold"])][d][3]
                             for d in ("nano", "orin")) > 0
    # A second run appends rows under the one header.
    legacy_tester.ChatbotTester(QUERIES[:1], [100], strategy="token",
                                device="cpu").run("again", str(out))
    rows = _rows(out)
    assert rows.count(legacy_tester.HEADERS) == 1 and rows[-1][0] == "again"


def test_v1_sweep_equals_jax_on_stub_telemetry(tmp_path, monkeypatch,
                                               float32_presets):
    monkeypatch.setattr(legacy_tester, "_build_telemetry",
                        lambda device=None: StubTelemetry())
    monkeypatch.setattr(jax_tester, "_build_telemetry",
                        lambda cluster=None: StubTelemetry())
    ours = legacy_tester.ChatbotTester(
        QUERIES, THRESHOLDS, strategy="token", device="cpu").run(
        "general_knowledge", str(tmp_path / "torch.csv"))
    theirs = jax_legacy.ChatbotTester(QUERIES, THRESHOLDS,
                                      strategy="token").run(
        "general_knowledge", str(tmp_path / "jax.csv"))
    assert sorted(ours) == sorted(theirs) == THRESHOLDS
    for t in THRESHOLDS:
        for dev in ("nano", "orin"):
            # latency, energy, avg power, tokens
            assert ours[t][dev][3] == theirs[t][dev][3], (t, dev)
            assert (ours[t][dev][0] > 0) == (theirs[t][dev][0] > 0)
            if ours[t][dev][0]:
                assert ours[t][dev][2] == pytest.approx(theirs[t][dev][2],
                                                        abs=2.0)
    # The threshold moves the token strategy's split.
    assert ours[30]["orin"][3] > 0 and ours[1000]["nano"][3] > 0
    assert _rows(tmp_path / "torch.csv")[0] == _rows(tmp_path / "jax.csv")[0]


@pytest.fixture(scope="module")
def canonical_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("canonical")
    summary, per_query = str(d / "summary.csv"), str(d / "per_query.csv")
    tester.run_experiment(
        tester.normalize_query_set(QUERIES), tester.RunConfig(
            query_set_name="general_knowledge", thresholds=[100, 1000],
            strategies=["token", "heuristic"], cache_modes=["off"],
            fixed_threshold_for_non_token=1000, output_csv=summary,
            output_per_query_csv=per_query, router_kwargs={"device": "cpu"},
            telemetry=False))
    return summary, per_query


@pytest.mark.parametrize("which", ["canonical", "edge_cases",
                                   "summary_only"])
def test_report_equals_jax(which, canonical_csvs, tmp_path):
    if which == "canonical":
        summary, per_query = canonical_csvs
    else:
        summary, per_query = str(tmp_path / "s.csv"), str(tmp_path / "p.csv")
        (tmp_path / "s.csv").write_text(EDGE_SUMMARY)
        (tmp_path / "p.csv").write_text(EDGE_PER_QUERY)
        if which == "summary_only":
            per_query = None
    want = jax_analysis.markdown_report(
        pd.read_csv(summary), pd.read_csv(per_query) if per_query else None)
    got = analysis.markdown_report(
        analysis.Table.read_csv(summary),
        analysis.Table.read_csv(per_query) if per_query else None)
    assert got == want
    assert "## general_knowledge" in got or which != "canonical"


def test_report_refuses_the_v1_csv_like_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(legacy_tester, "_build_telemetry",
                        lambda device=None: StubTelemetry())
    out = str(tmp_path / "final_results.csv")
    legacy_tester.ChatbotTester(QUERIES[:1], [100], strategy="token",
                                device="cpu").run("general_knowledge", out)
    with pytest.raises(KeyError):
        jax_analysis.markdown_report(pd.read_csv(out))
    with pytest.raises(KeyError):
        analysis.markdown_report(analysis.Table.read_csv(out))


def test_main_writes_the_report_and_plots(canonical_csvs, tmp_path,
                                          monkeypatch):
    summary, per_query = canonical_csvs
    md = tmp_path / "report.md"
    analysis.main(["--summary-csv", summary, "--per-query-csv", per_query,
                   "--output-md", str(md), "--plots-dir",
                   str(tmp_path / "plots")])
    assert md.read_text() == jax_analysis.markdown_report(
        pd.read_csv(summary), pd.read_csv(per_query))
    plots = sorted(os.listdir(tmp_path / "plots"))
    assert "threshold_latency_s.png" in plots and "req_per_s.png" in plots
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        analysis.main(["--summary-csv", summary, "--output-md",
                       str(tmp_path / "r2.md"), "--plots-dir",
                       str(tmp_path / "plots2")])
