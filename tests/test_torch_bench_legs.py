"""The bench's engine legs (``bench/legs.py``) against the root
``bench.py``'s, each at its smallest size on the CPU.

Each leg's keys are held against the JAX leg's, written out below with
the ``bench.py`` lines that set them (a JAX run of these legs compiles
every engine program twice, too slow for a unit test), its hard
invariants must hold (one ragged decode program, the speculative program
count within the γ-bucket family, byte-identical greedy outputs across
the two modes, shared peak under 0.6 x the exclusive one at K = 4), and
its ``compact`` entry equals ``bench.compact``'s on the same result.
The skew leg reports the port's launch and plain-call counts in place of
JAX's ``dispatch`` provenance.  The flip judge (``tie_check``) is held on
a divergence made on purpose.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402  (the JAX package's root bench.py)
from distributed_llm_tpu_torch import config as torch_config  # noqa: E402
from distributed_llm_tpu_torch.bench import headline, legs  # noqa: E402

# bench.py:1280-1283 (+ :1354, :1361), per mode :1321-1332.
SKEW_KEYS = {"decode_batch", "requests", "steps_per_tick", "dispatch",
             "dense", "ragged", "tick_p50_ratio_ragged_over_dense",
             "outputs_identical"}
SKEW_MODE_KEYS = {"req_per_s", "decode_tick_p50_ms", "decode_tick_p95_ms",
                  "ticks", "errors", "compiled_decode_programs",
                  "compiled_programs_gauge", "attention_impl",
                  "attention_ragged"}
# bench.py:1405-1409 (+ :1477, :1484, :1488), per mode :1446-1462.
SPEC_KEYS = {"decode_batch", "requests", "gamma_max", "draft_preset",
             "steps_per_tick", "off", "on", "tok_ratio", "wall_tok_ratio",
             "outputs_identical"}
SPEC_MODE_KEYS = {"tok_per_s", "wall_tok_per_s", "req_per_s", "ttft_p50_ms",
                  "gen_tokens", "decode_s", "ticks", "errors",
                  "accept_ratio", "drafted_total", "accepted_total",
                  "per_slot_accept", "verify_programs", "gamma_buckets"}
# bench.py:1575-1581 (+ :1750), per mode :1728-1739.
MIXED_KEYS = {"model_preset", "decode_batch", "short_max_new",
              "arrival_max_new", "chunk_tokens", "chunk_budget", "repeats",
              "monolithic", "chunked", "outputs_identical"}
MIXED_MODE_KEYS = {"repeats", "calm_tbt_p95_ms", "short_tbt_p95_ms",
                   "tbt95_ratio", "tbt95_ratios", "stall_max_ms",
                   "stall_calm_ms", "long_ttft_ms", "long_tbt_p95_ms",
                   "errors"}
# bench.py:1796, :1808 (+ :1865, :1868, :1872), per mode :1841-1858.
SHARED_KEYS = {"k_sessions", "decode_batch", "prefix_tokens", "on", "off",
               "peak_ratio", "ttft_p50_ratio", "outputs_identical"}
SHARED_MODE_KEYS = {"peak_resident_blocks", "peak_shared_blocks",
                    "peak_dedup_ratio", "warm_ttft_p50_ms", "ttft_max_ms",
                    "req_per_s", "errors", "hits_shared", "hits_exclusive",
                    "tokens_saved_shared", "tokens_saved_exclusive"}


def _compact_matches(section: str, out: dict, keys) -> None:
    """The port's compact line carries what ``bench.compact`` makes of the
    same section."""
    want = jax_bench.compact({section: out})
    got = headline.compact({section: out})
    for key in keys:
        assert got.get(key) == want.get(key), key
    assert any(key in got for key in keys)


def test_skew_leg():
    out = legs.skew_phase("cpu", n_requests=4)
    assert set(out) == SKEW_KEYS - {"dispatch"} | {"launches"}
    for mode in ("dense", "ragged"):
        assert set(out[mode]) == SKEW_MODE_KEYS, mode
        assert out[mode]["errors"] == 0
        assert out[mode]["attention_impl"] == "xla"
    assert out["ragged"]["compiled_decode_programs"] == 1
    assert out["ragged"]["compiled_programs_gauge"] == 1.0
    assert out["dense"]["compiled_decode_programs"] > 1
    assert out["outputs_identical"] is True and "error" not in out
    # The launch counts that stand for JAX's dispatch provenance: on the
    # CPU no kernel launches, and each tick's plain version runs.
    calls = out["launches"]
    assert calls["dense"]["kernels"] == calls["ragged"]["kernels"] == {}
    assert calls["dense"]["plain_calls"]["_gather_decode_windowed"] > 0
    assert "_gather_decode_windowed" not in calls["ragged"]["plain_calls"]
    assert calls["ragged"]["plain_calls"]["_gather_decode_paged"] > 0
    _compact_matches("skew", out, ("skew_tick_ratio", "skew_tick_p50_ms"))


def test_spec_leg():
    out = legs.spec_phase("cpu", n_requests=2)
    assert set(out) == SPEC_KEYS
    for mode in ("off", "on"):
        assert set(out[mode]) == SPEC_MODE_KEYS, mode
    on = out["on"]
    assert out["draft_preset"] == "draft_test" and on["drafted_total"] > 0
    assert 0 < on["verify_programs"] <= len(on["gamma_buckets"])
    assert out["off"]["verify_programs"] == 0
    assert out["outputs_identical"] is True and "error" not in out
    _compact_matches("spec_phase", out, ("spec",))


@pytest.fixture
def narrow_mini(monkeypatch):
    """The mixed leg's tier with ``mini_bench`` narrowed to the tiny
    width: the 1792 bucket, one decode step a tick, 2 slots."""
    name = "mini_bench_narrow"
    monkeypatch.setitem(torch_config.MODEL_PRESETS, name, dataclasses.replace(
        torch_config.MODEL_PRESETS["mini_bench"], name=name, hidden_size=64,
        num_layers=2, num_heads=4, num_kv_heads=2, ffn_size=128))
    return dataclasses.replace(
        torch_config.tiny_batched_cluster().nano, model_preset=name,
        decode_batch=2, decode_steps_per_tick=1, max_new_tokens=64,
        prefill_buckets=(16, 64, 1792), enable_prefix_cache=False)


def test_mixed_leg(narrow_mini):
    out = legs.mixed_phase("cpu", repeats=1, tier=narrow_mini)
    assert set(out) == MIXED_KEYS
    for mode in ("monolithic", "chunked"):
        assert set(out[mode]) == MIXED_MODE_KEYS, mode
        assert out[mode]["errors"] == 0 and "error" not in out[mode]
        assert out[mode]["stall_max_ms"] > 0
    assert out["outputs_identical"] is True
    _compact_matches("mixed", out, ("mixed",))


def test_shared_leg():
    out = legs.shared_prefix_phase(4, device="cpu")
    assert set(out) == SHARED_KEYS
    for mode in ("on", "off"):
        assert set(out[mode]) == SHARED_MODE_KEYS, mode
    assert out["k_sessions"] == 4
    assert out["peak_ratio"] < 0.6
    assert out["on"]["hits_shared"] == 4
    assert out["on"]["tokens_saved_shared"] > 0
    assert out["off"]["tokens_saved_shared"] == 0
    assert out["outputs_identical"] is True and "error" not in out
    _compact_matches("shared", out, ("shared",))


@pytest.mark.parametrize("near", [True, False])
def test_tie_check_judges_a_flip(near):
    """Where two modes' tokens differ, ``tie_check`` judges each differing
    request on a fresh engine of the reference mode: a near-tie keeps the
    leg from failing, anything else fails it; ``outputs_identical`` stays
    False either way."""
    tier = dataclasses.replace(torch_config.tiny_batched_cluster().nano,
                               max_new_tokens=4)
    prompts = ["alpha", "bravo"]
    seen = []

    def tie_check(engine, ids, want, got):
        seen.append((engine.tier.name, tuple(ids), want, got))
        return {"near_tie": near, "top2_gap": 0.01}

    out: dict = {}
    ok = legs._judge(out, 2, ("a", "b"),
                     {"a": [(1, 2), (3, 4)], "b": [(1, 2), (3, 5)]},
                     prompts, tier, tie_check, 7, "cpu")
    assert ok is near and out["outputs_identical"] is False
    assert [f["request"] for f in out["flips"]] == [1]
    assert len(seen) == 1 and seen[0][2:] == ([3, 4], [3, 5])
    assert len(seen[0][1]) > 0
    # With no judge every divergence counts, as in JAX.
    bare: dict = {}
    assert legs._judge(bare, 2, ("a", "b"),
                       {"a": [(1,), (2,)], "b": [(1,), (3,)]}, prompts,
                       tier, None, 7, "cpu") is False
    assert "flips" not in bare
