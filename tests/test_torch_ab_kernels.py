"""The port's kernel A/B harness (``bench/ab_kernels.py`` micro) on the
CPU, where both legs are the plain versions.

- Its kinds are the JAX package's twelve ``DISPATCH_KINDS`` plus ``w8``
  (W1), each mapped to a kernel wrapper the launch counts know.
- One run over the tiny nano tier gives a case per (kind, length, batch)
  of the grid (the paged and ragged kinds at batches above 1, the chunk
  kinds at batch 1, prefill where the length is a multiple of 128), each
  with its keys, finite times and a zero error (both legs plain), and no
  error or mismatch; ``kinds``, ``lengths``, ``batches`` and ``fast``
  shape the grid, and an unknown kind raises.
- ``main micro --device cpu`` prints the run's summary line.
"""

from __future__ import annotations

import json
import math

import pytest

from distributed_llm_tpu.ops.attention import DISPATCH_KINDS
from distributed_llm_tpu_torch.bench import ab_kernels
from distributed_llm_tpu_torch.ops import launches

KEYS = {"kind", "kernel", "length", "kernel_ms", "plain_ms", "speedup",
        "rel_err"}


def test_kinds_are_jaxs_and_w1():
    assert ab_kernels.ALL_KINDS == set(DISPATCH_KINDS) | {"w8"}
    assert set(ab_kernels.KERNEL_OF.values()) == set(launches.wrappers())


@pytest.fixture(scope="module")
def run():
    lines = []
    res = ab_kernels.micro_ab("nano", repeat=2, lengths=(128, 256),
                              batches=(1, 4), device="cpu",
                              log=lines.append)
    return res, lines


def test_rows_and_keys(run):
    res, lines = run
    assert res["backend"] == "cpu" and res["model"] == "nano_test"
    assert res["repeat"] == 2 and res["card"] is None
    cases = res["cases"]
    assert [json.loads(ln) for ln in lines] == cases
    grid = {}
    for c in cases:
        assert KEYS <= set(c), c
        assert c["kernel"] == ab_kernels.KERNEL_OF[c["kind"]]
        assert math.isfinite(c["kernel_ms"]) and math.isfinite(c["plain_ms"])
        assert c["rel_err"] == 0.0
        assert not ({"kernel_error", "plain_error", "numerics_mismatch"}
                    & set(c))
        grid.setdefault(c["kind"], []).append((c["length"], c.get("batch")))
    paged = ("paged_decode", "paged_decode_q8", "ragged_decode",
             "ragged_decode_q8", "ragged_verify", "ragged_verify_q8")
    for kind in paged:
        assert grid[kind] == [(128, 4), (256, 4)], kind
    for kind in ("decode", "decode_q8"):
        assert grid[kind] == [(s, b) for s in (128, 256) for b in (1, 4)]
    for kind in ("prefill", "chunk", "chunk_q8", "paged_chunk"):
        assert grid[kind] == [(128, None), (256, None)], kind
    assert [b for _, b in grid["w8"]] == [1, 4]
    assert set(grid) == ab_kernels.ALL_KINDS


def test_grid_options():
    res = ab_kernels.micro_ab("nano", repeat=1, fast=True, kinds=["decode"],
                              device="cpu", log=lambda line: None)
    assert {c["kind"] for c in res["cases"]} == {"decode"}
    assert sorted({c["batch"] for c in res["cases"]}) == [1, 8]
    assert sorted({c["length"] for c in res["cases"]}) == [256]
    with pytest.raises(ValueError, match="unknown kinds"):
        ab_kernels.micro_ab("nano", kinds=["nope"], device="cpu")


def test_main_micro_prints_a_summary(capsys):
    ab_kernels.main(["micro", "--device", "cpu", "--kinds", "w8,prefill",
                     "--repeat", "10"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["backend"] == "cpu" and last["cases"] == 4
