"""Roofline accounting: model FLOPs and device-memory traffic per serving
phase.

Counterpart of ``distributed_llm_tpu/utils/roofline.py``, with the same
arithmetic.  Every engine phase accounts the work the hardware did
(matmul FLOPs and device-memory bytes, from the model config and the
*computed* shapes: padded buckets, the attention span the active kernel
reads, not the logical token counts), so the bench reports MFU and
memory-bandwidth utilization against the card's peaks: prefill is
compute-bound (judge by MFU), decode is bandwidth-bound (judge by
``hbm_util``).

Conventions:
- a matmul of a token through P params is 2·P FLOPs;
- attention scores and values for one query over a span of s keys is
  4·h·s FLOPs per layer (2 for QKᵀ, 2 for A·V, h = hidden width already
  aggregated over heads);
- the span is what the active kernel computes: the plain versions on the
  CPU read the whole allocated span, the card's decode kernels stop at
  each row's frontier (``ops.attention.decode_kv_span``);
- decode traffic per step = one full weight-set read (shared by the whole
  batch) + each sequence's K/V span read.

The peaks come from a table of cards keyed by
``torch.cuda.get_device_name``, not from the environment.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# Published dense peaks by card name: bf16 tensor-core FLOP/s and device
# memory bytes/s (NVIDIA's data sheet, SXM part, at its 700 W limit).
CARD_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 989e12,
                              "peak_hbm_bytes_per_s": 3.35e12},
}


def chip_peaks(device) -> Optional[Dict[str, Any]]:
    """Peak FLOP/s and device-memory B/s of ``device``'s card with its
    name under ``chip``, or None where utilization has no denominator
    here: the CPU, and any card missing from ``CARD_PEAKS`` (the caller
    records the card's name beside its absolute rates)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    peaks = CARD_PEAKS.get(name)
    if peaks is None:
        return None
    return {**peaks, "chip": name}


def active_matmul_params(cfg) -> int:
    """Matmul params touched per token: attention + active FFN experts
    (top-2 routing for MoE) + the tied LM head.  Embedding lookup is a
    gather, not a matmul."""
    h, f, l = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    kv = cfg.num_kv_heads * cfg.head_dim
    attn = h * h + 2 * h * kv + h * h
    ffn = 3 * h * f
    if cfg.num_experts > 1:
        ffn *= 2                       # top-2 of E experts per token
    return l * (attn + ffn) + cfg.vocab_size * h


def weight_bytes(cfg, quantize: str = "none") -> int:
    """Resident weight bytes streamed by one decode step: the body at 2
    bytes a parameter, 1 with int8 weights.  For MoE this is the FULL
    expert set, as a dense dispatch reads every expert's weights.  The
    embedding/head and the norms count at 2 bytes even under int8 (the
    JAX package's count, kept for parity: its ``quantize_params``, like
    the port's, quantizes the embedding too)."""
    h, f, l = cfg.hidden_size, cfg.ffn_size, cfg.num_layers
    kv = cfg.num_kv_heads * cfg.head_dim
    attn = h * h + 2 * h * kv + h * h
    ffn = 3 * h * f * max(1, cfg.num_experts)
    per_param = 1 if quantize == "int8" else 2
    body = l * (attn + ffn) * per_param
    return body + (cfg.vocab_size * h + (2 * l + 1) * h) * 2


def kv_bytes_per_pos(cfg, kv_quantize: str = "none") -> int:
    """K+V bytes per cached position: bf16, or int8 + float32 per-row
    scales (engine/paged_kv.py)."""
    rows = 2 * cfg.num_layers * cfg.num_kv_heads
    if kv_quantize == "int8":
        return rows * (cfg.head_dim + 4)
    return rows * cfg.head_dim * 2


def prefill_work(cfg, end: int, start: int = 0,
                 wbytes: Optional[int] = None) -> Dict[str, float]:
    """Work for prefilling positions [start, end) of one sequence (end is
    the PADDED/computed span: bucket or chunk stride, not the logical
    prompt length).  Causal attention: position p attends to p+1 keys."""
    pm = active_matmul_params(cfg)
    n = max(0, end - start)
    h, l = cfg.hidden_size, cfg.num_layers
    flops = 2.0 * pm * n + 2.0 * h * l * float(end**2 - start**2)
    if wbytes is None:
        wbytes = weight_bytes(cfg)
    # One weight-set read per chunk (prefill is compute-bound; the weight
    # term anchors the roofline position), plus the KV written for the
    # new span.
    hbm = float(wbytes) + kv_bytes_per_pos(cfg) * n
    return {"flops": flops, "hbm_bytes": hbm, "tokens": n}


def decode_work(cfg, steps: int, ctx: int, batch: int = 1,
                wbytes: Optional[int] = None,
                kv_quantize: str = "none",
                kv_ctx: Optional[float] = None,
                kv_batch: Optional[int] = None) -> Dict[str, float]:
    """Work for ``steps`` sequential decode steps of a ``batch`` of
    sequences whose attention spans ``ctx`` cached positions each (the
    allocated span).

    ``kv_ctx`` overrides the span per sequence where the active kernel
    stops at the causal frontier (``ops.attention.decode_kv_span``), so
    ``hbm_util`` counts the tiles the kernel moved.  ``kv_batch``
    overrides how many DISTINCT cache streams one step reads: a verify of
    γ+1 queries reads its slot's cache once, not γ+1 times."""
    pm = active_matmul_params(cfg)
    h, l = cfg.hidden_size, cfg.num_layers
    span = float(ctx) if kv_ctx is None else min(float(kv_ctx), float(ctx))
    kvb = batch if kv_batch is None else kv_batch
    flops = float(steps) * batch * (2.0 * pm + 4.0 * h * l * span)
    if wbytes is None:
        wbytes = weight_bytes(cfg)
    hbm = float(steps) * (wbytes + kvb
                          * kv_bytes_per_pos(cfg, kv_quantize) * span)
    return {"flops": flops, "hbm_bytes": hbm, "tokens": steps * batch}


def utilization(work: Dict[str, Any], seconds: float,
                peaks: Optional[Dict[str, float]]) -> Dict[str, Any]:
    """Achieved rates, and MFU and device-memory utilization against
    ``peaks``, for accumulated work over measured seconds."""
    out: Dict[str, Any] = {
        "tflops_per_s": round(work.get("flops", 0.0) / max(seconds, 1e-9)
                              / 1e12, 4),
        "hbm_gb_per_s": round(work.get("hbm_bytes", 0.0) / max(seconds, 1e-9)
                              / 1e9, 3),
    }
    if peaks:
        out["mfu"] = round(work.get("flops", 0.0)
                           / max(seconds, 1e-9) / peaks["peak_flops"], 4)
        out["hbm_util"] = round(work.get("hbm_bytes", 0.0)
                                / max(seconds, 1e-9)
                                / peaks["peak_hbm_bytes_per_s"], 4)
    return out
