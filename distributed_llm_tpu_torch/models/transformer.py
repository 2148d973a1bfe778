"""LLaMA-style decoder-only transformer in PyTorch.

Counterpart of ``distributed_llm_tpu/models/transformer.py``: RMSNorm,
rotary embeddings, grouped-query attention, SwiGLU MLP, tied LM head.
Weights live in ``nn.Module``s (``Transformer`` holding one
``DecoderLayer`` per layer) in the JAX package's ``x @ w`` layout
([in, out]), so ``models/convert.params_from_jax`` copies the JAX
pytree's stacked ``[L, ...]`` leaves over unchanged.  With int8 weights
(``ops.quant.maybe_quantize``) each projection and the embedding table
is an ``ops.quant.QTensor`` in place of its parameter; every product
goes through ``quant.matmul``, ``embed_rows`` or ``tied_head``, which
take either.  The forward functions stay plain functions of (cfg, model,
tensors), like the JAX package's, and round to the parameter dtype at
the same points.

The sequential engines keep a contiguous KV cache, ``{"k", "v":
[L, B, S, N_kv, D]}`` plus float32 row scales ``{"ks", "vs":
[L, B, S, N_kv]}`` when it is int8 (``init_kv_cache``).  ``decode_step``
and ``chunk_prefill`` write it IN PLACE and return only their output:
the JAX package donates the cache buffer to the same effect, so no
other holder sees the write.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import attention, quant

KVCache = Dict[str, torch.Tensor]   # {"k","v": [L, B, S, N_kv, D]}
                                    # (+ "ks","vs": [L, B, S, N_kv])


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights: norms [H], projections [in, out]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, f, d = cfg.hidden_size, cfg.ffn_size, cfg.head_dim
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = _param((h,), dtype, device)
        self.wq = _param((h, nq * d), dtype, device)
        self.wk = _param((h, nkv * d), dtype, device)
        self.wv = _param((h, nkv * d), dtype, device)
        self.wo = _param((nq * d, h), dtype, device)
        self.ln2 = _param((h,), dtype, device)
        self.w_gate = _param((h, f), dtype, device)
        self.w_up = _param((h, f), dtype, device)
        self.w_down = _param((f, h), dtype, device)


class Transformer(nn.Module):
    """Embedding table [V, H] (also the tied LM head), layers, final norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg)
        device = torch.device(device or "cpu")
        self.embed = _param((cfg.vocab_size, cfg.hidden_size), dtype, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = _param((cfg.hidden_size,), dtype, device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """Deterministic random init from a ``torch.Generator``: normal * 0.02
    for every matrix, ones for the norms (the JAX package's scheme; the
    two packages draw different numbers from the same seed)."""
    device = torch.device(device or "cpu")
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("ln1", "ln2", "final_ln")):
                p.fill_(1.0)
            else:
                draw = torch.randn(p.shape, generator=gen, device=device,
                                   dtype=torch.float32)
                p.copy_(draw * 0.02)
    return model


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, THEN scale by w."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> (sin, cos) each [..., head_dim/2], float32."""
    half = head_dim // 2
    exponents = -torch.arange(0, half, dtype=torch.float32,
                              device=positions.device) / half
    freqs = torch.pow(float(theta), exponents)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in float32. x [..., N, D]; sin/cos [..., D/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    sin, cos = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    return quant.matmul(torch.nn.functional.silu(quant.matmul(x, gate))
                        * quant.matmul(x, up), down)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Process a full (right-padded) prompt.

    tokens/positions [B, S] -> (final-normed hidden [B, S, H],
    (k_all, v_all) each [L, B, S, N_kv, D]), the per-layer K/V to page
    into the pool."""
    b, s = tokens.shape
    d = cfg.head_dim
    x = quant.embed_rows(model.embed, tokens)
    sin, cos = rope_sincos(positions, d, cfg.rope_theta)
    ks, vs = [], []
    for lp in model.layers:
        h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, s, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, s, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, s, cfg.num_kv_heads, d)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        out = attention.causal(q, k, v).reshape(b, s, cfg.num_heads * d)
        x = x + quant.matmul(out, lp.wo)
        x = x + _swiglu(rms_norm(x, lp.ln2, cfg.norm_eps),
                        lp.w_gate, lp.w_up, lp.w_down)
        ks.append(k)
        vs.append(v)
    hidden = rms_norm(x, model.final_ln, cfg.norm_eps)
    return hidden, (torch.stack(ks), torch.stack(vs))


def logits_from_hidden(model: Transformer, hidden: torch.Tensor) -> torch.Tensor:
    """Tied LM head: [..., H] -> [..., V] in float32."""
    return quant.tied_head(model.embed, hidden)


def layer_scales(cache: KVCache, i: int):
    """(k_scale, v_scale) of layer ``i`` of an int8 cache or pool, else
    ()."""
    if "ks" in cache:
        return cache["ks"][i], cache["vs"][i]
    return ()


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  kv_quantize: str = "none", device=None) -> KVCache:
    """Zeroed contiguous cache [L, B, S, N_kv, D]; ``kv_quantize="int8"``
    stores K/V as int8 with float32 row scales initialised to ones."""
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    if kv_quantize == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.ones(shape[:-1], dtype=torch.float32, device=device),
                "vs": torch.ones(shape[:-1], dtype=torch.float32, device=device)}
    if kv_quantize != "none":
        raise ValueError(f"kv_quantize={kv_quantize!r}: expected 'none' or "
                         "'int8'")
    dtype = torch_dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def seed_kv_cache(cfg: ModelConfig, k_all: torch.Tensor, v_all: torch.Tensor,
                  cache_len: int, kv_quantize: str = "none") -> KVCache:
    """A cache of ``cache_len`` positions holding a prefill's K/V
    ([L, B, S, N_kv, D]) at positions [0, S), quantized for int8."""
    cache = init_kv_cache(cfg, k_all.shape[1], cache_len, kv_quantize,
                          k_all.device)
    quant.put_kv_rows(cache, None, (slice(None), slice(None),
                                    slice(0, k_all.shape[2])), k_all, v_all)
    return cache


def reset_kv_cache(cache: KVCache, start: int = 0) -> None:
    """Positions ``start`` and later of a cache set in place to what
    ``init_kv_cache`` holds (zeros; int8 scale planes ones)."""
    for name, x in cache.items():
        x[:, :, start:].fill_(1.0 if name in ("ks", "vs") else 0)


def seed_kv_cache_into(cache: KVCache, k_all: torch.Tensor,
                       v_all: torch.Tensor) -> None:
    """``seed_kv_cache`` in place: a prefill's K/V ([L, B, S, N_kv, D])
    written at positions [0, S) of an existing cache and every later
    position reset, so the cache equals ``seed_kv_cache``'s."""
    s = k_all.shape[2]
    quant.put_kv_rows(cache, None, (slice(None), slice(None), slice(0, s)),
                      k_all, v_all)
    reset_kv_cache(cache, s)


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, token: torch.Tensor,
                pos: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """One decode step for every sequence: token [B], pos [B] int32 (its
    position), the cache written in place at ``pos`` (clamped into the
    cache, as the JAX package's dynamic update) BEFORE attending.
    Returns logits [B, V] float32."""
    b = token.shape[0]
    d = cfg.head_dim
    x = quant.embed_rows(model.embed, token)                       # [B, H]
    sin, cos = rope_sincos(pos, d, cfg.rope_theta)
    rows = (torch.arange(b, device=token.device),
            pos.long().clamp(0, cache["k"].shape[2] - 1))
    for i, lp in enumerate(model.layers):
        h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, cfg.num_kv_heads, d)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        quant.put_kv_rows(cache, i, rows, k, v)
        out = attention.decode(q, cache["k"][i], cache["v"][i], pos,
                               *layer_scales(cache, i))
        x = x + quant.matmul(out.reshape(b, cfg.num_heads * d), lp.wo)
        x = x + _swiglu(rms_norm(x, lp.ln2, cfg.norm_eps),
                        lp.w_gate, lp.w_up, lp.w_down)
    hidden = rms_norm(x, model.final_ln, cfg.norm_eps)
    return logits_from_hidden(model, hidden)


def chunk_rows(start: torch.Tensor, s_c: int, cache: KVCache):
    """Index of a chunk's rows [start, start + S_c) in every sequence's
    cache row, the start clamped so the chunk fits (the JAX package's
    dynamic update clamps the same way)."""
    b = start.shape[0]
    first = start.long().clamp(0, cache["k"].shape[2] - s_c)
    return (torch.arange(b, device=start.device)[:, None],
            first[:, None] + torch.arange(s_c, device=start.device)[None])


@torch.no_grad()
def chunk_prefill(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
                  start: torch.Tensor, true_len: torch.Tensor, cache: KVCache,
                  window: int = 0) -> torch.Tensor:
    """Prefill a chunk of a prompt against the cache (prefix reuse and
    chunked long prefill).  tokens [B, S_c] right-padded, start [B] int32
    the chunk's first position, true_len [B] int32 the valid length
    (start + real chunk tokens); the chunk's K/V are written in place at
    [start, start + S_c) before attending.  Queries past the true length
    clamp their frontier to its last position (their rows are never
    read).  ``window`` (0 = the whole cache) bounds the attended cache
    prefix, read in place.  Returns the final-normed hidden
    [B, S_c, H]."""
    b, s_c = tokens.shape
    d = cfg.head_dim
    x = quant.embed_rows(model.embed, tokens)                     # [B, S_c, H]
    positions = start[:, None] + torch.arange(s_c, device=tokens.device)[None]
    q_pos = torch.minimum(positions, torch.clamp(true_len, min=1)[:, None] - 1
                          ).to(torch.int32)
    sin, cos = rope_sincos(positions, d, cfg.rope_theta)
    rows = chunk_rows(start, s_c, cache)
    w = window or cache["k"].shape[2]
    for i, lp in enumerate(model.layers):
        h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
        q = quant.matmul(h_in, lp.wq).reshape(b, s_c, cfg.num_heads, d)
        k = quant.matmul(h_in, lp.wk).reshape(b, s_c, cfg.num_kv_heads, d)
        v = quant.matmul(h_in, lp.wv).reshape(b, s_c, cfg.num_kv_heads, d)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        quant.put_kv_rows(cache, i, rows, k, v)
        scales = [sc[:, :w] for sc in layer_scales(cache, i)]
        attn = attention.chunk(q, cache["k"][i][:, :w], cache["v"][i][:, :w],
                               q_pos, *scales)
        x = x + quant.matmul(attn.reshape(b, s_c, cfg.num_heads * d), lp.wo)
        x = x + _swiglu(rms_norm(x, lp.ln2, cfg.norm_eps),
                        lp.w_gate, lp.w_up, lp.w_down)
    return rms_norm(x, model.final_ln, cfg.norm_eps)
