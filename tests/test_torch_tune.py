"""The port's measured-defaults tool (``bench/tune.py``) against the JAX
package's.

The twins of ``tests/test_tune.py``: ``derive`` follows measurement (a
feature must win by 1.05), guards an aborted headline, a foreign spec
artifact and an unmeasured kv-int8 pairing, and equals the JAX
package's table on the same inputs; ``load_tuning`` ignores a table of
another backend.  The overlay in ``config.bench_cluster`` applies a table
only when its backend is ``"cuda"``; the repo commits no table, so
``bench_cluster()`` is the hand-set cluster.  ``main`` reads a bench
output's JSON line, prints the table and writes it only with
``--write``, refusing to let a CPU run replace a card table.
"""

from __future__ import annotations

import json
import os

import pytest

from distributed_llm_tpu.bench import tune as jax_tune
from distributed_llm_tpu_torch import config as C
from distributed_llm_tpu_torch.bench import tune

HEADLINE = {
    "backend": "cuda",
    "quant": {"nano": {"speedup": 1.6, "kv_int8_speedup": 0.9},
              "orin": {"speedup": 1.7, "kv_int8_speedup": 1.2}},
}
SPEC = {"backend": "cuda", "speculative": {"speedup": 1.4}}


def test_derive_follows_measurement():
    t = tune.derive(HEADLINE, SPEC)
    assert t["backend"] == "cuda"
    assert t["tiers"]["nano"]["quantize"] == "int8"
    assert t["tiers"]["nano"]["kv_quantize"] == "none"     # 0.9x lost
    assert t["tiers"]["orin"]["kv_quantize"] == "int8"
    # Spec WINS (1.4x) but the capability gate holds the default off.
    assert t["tiers"]["orin"]["speculative"] is (
        tune.SPEC_ENGINE_HAS_PREFIX_REUSE)
    assert t["tiers"]["orin"]["evidence"]["spec_speedup"] == 1.4
    if not tune.SPEC_ENGINE_HAS_PREFIX_REUSE:
        assert "prefix reuse" in t["spec_note"]
    # Ties/below-threshold keep the simpler configuration.
    t2 = tune.derive({"backend": "cuda",
                      "quant": {"orin": {"speedup": 1.01}}},
                     {"backend": "cuda", "speculative": {"speedup": 0.9}})
    assert t2["tiers"]["orin"]["quantize"] == "none"
    assert t2["tiers"]["orin"]["speculative"] is False
    assert "spec_note" not in t2                  # a loss needs no gate


def test_derive_guards():
    with pytest.raises(ValueError, match="aborted"):
        tune.derive({"backend": "cuda", "aborted": "wedged"})
    t = tune.derive(HEADLINE, {"backend": "cpu",
                               "speculative": {"speedup": 2.0}})
    assert "speculative" not in t["tiers"]["orin"]
    assert "ignored" in t["spec_note"]
    t = tune.derive({"backend": "cuda",
                     "quant": {"orin": {"speedup": 0.9,
                                        "kv_int8_speedup": 1.3}}})
    assert t["tiers"]["orin"] == {
        "quantize": "none", "kv_quantize": "none",
        "evidence": {"speedup": 0.9, "kv_int8_speedup": 1.3}}


@pytest.mark.parametrize("headline,spec", [
    (HEADLINE, SPEC), (HEADLINE, None),
    ({"backend": "cuda", "quant": {"nano": {"speedup": 1.007,
                                            "kv_int8_speedup": 0.78}}},
     {"backend": "cuda", "speculative": {"speedup": 0.8}}),
    (HEADLINE, {"backend": "cpu", "speculative": {"speedup": 2.0}}),
    (HEADLINE, {"aborted": True})])
def test_derive_equals_jax(headline, spec):
    ours, theirs = tune.derive(headline, spec), jax_tune.derive(headline, spec)
    # The gate's note names how to serve a draft: an env flag in JAX, a
    # tier's draft_preset here.
    assert ("spec_note" in ours) == ("spec_note" in theirs)
    ours.pop("spec_note", None)
    theirs.pop("spec_note", None)
    assert ours == theirs


def test_load_tuning_backend_guard(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"backend": "cuda",
                                "tiers": {"orin": {"quantize": "none"}}}))
    monkeypatch.setattr(tune, "TUNING_PATH", str(path))
    assert tune.load_tuning() == tune.load_tuning("cuda") == \
        {"orin": {"quantize": "none"}}
    assert tune.load_tuning("cpu") == {}          # other backend: ignored
    monkeypatch.setattr(tune, "TUNING_PATH", str(tmp_path / "missing.json"))
    assert tune.load_tuning() == {}


def test_bench_cluster_applies_only_a_card_table(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({
        "backend": "cuda",
        "tiers": {"orin": {"quantize": "none", "kv_quantize": "int8",
                           "speculative": True},
                  "nano": {"quantize": "none"}}}))
    monkeypatch.setattr(tune, "TUNING_PATH", str(path))
    cl = C.bench_cluster()
    assert cl.orin.quantize == "none"
    assert cl.orin.kv_quantize == "int8"
    assert cl.orin.draft_preset == cl.nano.model_preset == "nano_1b"
    assert cl.nano.quantize == "none"
    # A table from the CPU (or any other backend) never steers the card.
    for backend in ("cpu", "tpu"):
        path.write_text(json.dumps({"backend": backend,
                                    "tiers": {"orin": {"quantize": "none"}}}))
        assert C.bench_cluster().orin.quantize == "int8"


def test_no_table_is_committed_and_bench_cluster_is_hand_set():
    assert not os.path.exists(tune.TUNING_PATH)
    assert C.bench_cluster() == C.ClusterConfig(
        nano=C.TierConfig(name="nano", model_preset="nano_1b",
                          max_new_tokens=64, quantize="int8",
                          decode_batch=8),
        orin=C.TierConfig(name="orin", model_preset="orin_8b",
                          max_new_tokens=128, quantize="int8",
                          decode_batch=4))


def test_main_prints_and_writes_only_when_asked(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(tune, "TUNING_PATH", str(tmp_path / "tuning.json"))
    headline = tmp_path / "bench_partial.json"
    headline.write_text("progress line\n" + json.dumps(HEADLINE) + "\n")
    tune.main(["--headline", str(headline)])
    assert json.loads(capsys.readouterr().out) == tune.derive(HEADLINE)
    assert not os.path.exists(tune.TUNING_PATH)
    tune.main(["--headline", str(headline), "--write"])
    assert json.load(open(tune.TUNING_PATH))["backend"] == "cuda"
    cpu = tmp_path / "cpu.json"
    cpu.write_text(json.dumps(dict(HEADLINE, backend="cpu")))
    with pytest.raises(SystemExit):
        tune.main(["--headline", str(cpu), "--write"])
    assert json.load(open(tune.TUNING_PATH))["backend"] == "cuda"
