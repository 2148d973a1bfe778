"""The port's roofline accounting against the JAX package's.

- ``active_matmul_params``, ``weight_bytes``, ``kv_bytes_per_pos``,
  ``prefill_work``, ``decode_work`` and ``utilization`` equal the JAX
  functions (rel 1e-12) for every model preset and both KV dtypes;
  ``weight_bytes`` refuses int8 weights (not ported).
- ``chip_peaks``: None on the CPU, as JAX's; the H100's published peaks
  by the card's name; None for a card the table lacks (no environment
  override).
- ``ops.attention.decode_kv_span``: on the CPU the allocated span, as
  the JAX package's XLA route; on a CUDA device each row's frontier,
  ceil((pos + 1) / bs) pool blocks or 64-position tiles of a contiguous
  cache, computed by hand here.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from distributed_llm_tpu import config as jax_config
from distributed_llm_tpu.ops import attention as jax_attention
from distributed_llm_tpu.utils import roofline as jax_roofline
from distributed_llm_tpu_torch import config as torch_config
from distributed_llm_tpu_torch.ops import attention as torch_attention
from distributed_llm_tpu_torch.utils import roofline as torch_roofline

REL = 1e-12
PRESETS = sorted(torch_config.MODEL_PRESETS)
KV = ("none", "int8")


def test_presets_are_the_jax_packages():
    for name in PRESETS:
        jcfg = jax_config.MODEL_PRESETS[name]
        tcfg = torch_config.MODEL_PRESETS[name]
        for field in ("hidden_size", "ffn_size", "num_layers", "num_heads",
                      "num_kv_heads", "vocab_size", "num_experts"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)


def _cfgs(name):
    return jax_config.MODEL_PRESETS[name], torch_config.MODEL_PRESETS[name]


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=REL, abs=0.0), key


@pytest.mark.parametrize("name", PRESETS)
def test_params_and_bytes_match_jax(name):
    jcfg, tcfg = _cfgs(name)
    assert (torch_roofline.active_matmul_params(tcfg)
            == jax_roofline.active_matmul_params(jcfg))
    assert (torch_roofline.weight_bytes(tcfg)
            == jax_roofline.weight_bytes(jcfg, "none"))
    for kvq in KV:
        assert (torch_roofline.kv_bytes_per_pos(tcfg, kvq)
                == jax_roofline.kv_bytes_per_pos(jcfg, kvq))


def test_weight_bytes_refuses_int8_weights():
    with pytest.raises(NotImplementedError):
        torch_roofline.weight_bytes(torch_config.MODEL_PRESETS["nano_1b"],
                                    "int8")


@pytest.mark.parametrize("name", PRESETS)
def test_prefill_work_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    for end, start, wbytes in ((64, 0, None), (2048, 0, None),
                               (1024, 768, 12345), (256, 256, None),
                               (8192, 7936, 3 * 10**9)):
        _same(torch_roofline.prefill_work(tcfg, end, start, wbytes=wbytes),
              jax_roofline.prefill_work(jcfg, end, start, wbytes=wbytes))


@pytest.mark.parametrize("name,kvq", itertools.product(PRESETS, KV))
def test_decode_work_matches_jax(name, kvq):
    jcfg, tcfg = _cfgs(name)
    for steps, ctx, batch, kv_ctx, kv_batch in (
            (1, 256, 1, None, None), (4, 8192, 8, 1234.5, None),
            (5, 1024, 20, 700.0, 4), (3, 256, 1, 9999.0, 1),
            (0, 256, 4, None, None)):
        for wbytes in (None, 777):
            _same(torch_roofline.decode_work(
                      tcfg, steps, ctx, batch=batch, wbytes=wbytes,
                      kv_quantize=kvq, kv_ctx=kv_ctx, kv_batch=kv_batch),
                  jax_roofline.decode_work(
                      jcfg, steps, ctx, batch=batch, wbytes=wbytes,
                      kv_quantize=kvq, kv_ctx=kv_ctx, kv_batch=kv_batch))


def test_utilization_matches_jax():
    peaks = {"peak_flops": 989e12, "peak_hbm_bytes_per_s": 3.35e12}
    for work, seconds in (({"flops": 1.2e15, "hbm_bytes": 4.1e12}, 2.5),
                          ({"flops": 0.0, "hbm_bytes": 0.0}, 0.0),
                          ({"hbm_bytes": 7.0e9}, 0.003)):
        for pk in (peaks, None):
            assert (torch_roofline.utilization(work, seconds, pk)
                    == jax_roofline.utilization(work, seconds, pk))


def test_chip_peaks_by_card_name(monkeypatch):
    assert torch_roofline.chip_peaks("cpu") is None
    assert jax_roofline.chip_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert torch_roofline.chip_peaks("cuda") == {
        "peak_flops": 989e12, "peak_hbm_bytes_per_s": 3.35e12,
        "chip": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    assert torch_roofline.chip_peaks(torch.device("cuda", 0)) is None


POSITIONS = ([0], [15, 16, 17], [0, 63, 64, 200, 255], [3000, 8190],
             range(100, 108))


def test_decode_kv_span_on_the_cpu_is_jax_xla_route():
    for length, positions in zip((256, 256, 256, 8192, 1024), POSITIONS):
        for kind in ("ragged_decode", "ragged_verify", "decode"):
            want = jax_attention.decode_kv_span(kind, length, positions,
                                                impl="xla", block=16)
            got = torch_attention.decode_kv_span(length, positions, "cpu",
                                                 block=16)
            assert got == want == float(length)


@pytest.mark.parametrize("block,expect", [
    (16, [16.0, 80 / 3, (16 + 64 + 80 + 208 + 256) / 5, 5600.0, 112.0]),
    (64, [64.0, 64.0, (64 + 64 + 128 + 256 + 256) / 5, 5600.0, 128.0]),
    (None, [64.0, 64.0, (64 + 64 + 128 + 256 + 256) / 5, 5600.0, 128.0])])
def test_decode_kv_span_on_the_card_is_each_frontier(block, expect):
    """ceil((pos + 1) / tile) tiles a row, averaged and clamped to the
    allocated span: a pool's blocks (``block``) or the contiguous
    kernels' 64-position tiles (None)."""
    lengths = (256, 256, 256, 8192, 1024)
    got = [torch_attention.decode_kv_span(length, positions, "cuda",
                                          block=block)
           for length, positions in zip(lengths, POSITIONS)]
    assert got == pytest.approx(expect, rel=0, abs=1e-9)
