"""LLaMA-style decoder-only transformer in PyTorch.

Counterpart of ``distributed_llm_tpu/models/transformer.py``: RMSNorm,
rotary embeddings, grouped-query attention, SwiGLU MLP, tied LM head.
Weights live in ``nn.Module``s (``Transformer`` holding one
``DecoderLayer`` per layer) in the JAX package's ``x @ w`` layout
([in, out]), so ``models/convert.params_from_jax`` copies the JAX
pytree's stacked ``[L, ...]`` leaves over unchanged.  The forward
functions stay plain functions of (cfg, model, tensors), like the JAX
package's, and round to the parameter dtype at the same points.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import attention, quant

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
