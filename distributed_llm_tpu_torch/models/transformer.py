"""LLaMA-style decoder-only transformer in PyTorch.

Counterpart of ``distributed_llm_tpu/models/transformer.py``: RMSNorm,
rotary embeddings, grouped-query attention, SwiGLU MLP, tied LM head.
Weights live in ``nn.Module``s (``Transformer`` holding one
``DecoderLayer`` per layer) in the JAX package's ``x @ w`` layout
([in, out]), so ``models/convert.params_from_jax`` copies the JAX
pytree's stacked ``[L, ...]`` leaves over unchanged.  With int8 weights
(``ops.quant.maybe_quantize``) each projection and the embedding table
is an ``ops.quant.QTensor`` in place of its parameter; every product
goes through ``quant.matmul``, ``matmul_many`` (a layer's q/k/v and
gate/up: one W1 launch each on the card), ``embed_rows`` or
``tied_head``, which take either.  The forward functions stay plain functions of (cfg, model,
tensors), like the JAX package's, and round to the parameter dtype at
the same points.  Each layer's FFN is its own ``ffn`` (SwiGLU here; a
``models/moe.MoELayer`` routes to its experts), so they serve either
family; ``forward`` is ``prefill``'s body under autograd, which the
trainer runs (with per-layer remat) and which returns the MoE aux loss.

The sequential engines keep a contiguous KV cache, ``{"k", "v":
[L, B, S, N_kv, D]}`` plus float32 row scales ``{"ks", "vs":
[L, B, S, N_kv]}`` when it is int8 (``init_kv_cache``).  ``decode_step``
and ``chunk_prefill`` write it IN PLACE and return only their output:
the JAX package donates the cache buffer to the same effect, so no
other holder sees the write.

Every serving step runs its layers through ``run_layers``: the step
gives its attention as a hook ``attn(lp, h_in, i, shard)`` (project,
rotate, write the layer's K/V, attend) and ``run_layers`` adds the
norms, ``wo``, the FFN and the residual.  A ``parallel/sharding.
ShardedModel`` runs the same hook once per head shard, on the shard's
own weights, cache or pool (``Shard``) and device
(``parallel/tp_attention.tp_layers``); its K/V is then one tensor, or
cache, per shard (``kv_shards``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops import attention, quant
from ..parallel.sharding import is_sharded
from ..parallel.tp_attention import tp_layers

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

    def ffn(self, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer's FFN on the normed residual: (out, aux), aux None
        (a MoE layer, ``models/moe.MoELayer``, returns its load-balance
        loss there)."""
        return _swiglu(x, self.w_gate, self.w_up, self.w_down), None


class Transformer(nn.Module):
    """Embedding table [V, H] (also the tied LM head), layers, final norm.
    A MoE config (``num_experts > 1``) gets ``models/moe.MoELayer``s."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg)
        device = torch.device(device or "cpu")
        layer = DecoderLayer
        if cfg.num_experts > 1:
            from .moe import MoELayer as layer
        self.embed = _param((cfg.vocab_size, cfg.hidden_size), dtype, device)
        self.layers = nn.ModuleList(layer(cfg, dtype, device)
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
    g, u = quant.matmul_many(x, (gate, up))
    return quant.matmul(torch.nn.functional.silu(g) * u, down)


@dataclasses.dataclass
class Shard:
    """What a step's attention hook sees of its shard: its index, its q
    and kv head counts, its cache or pool (None for a prefill) and the
    step's inputs on its device."""
    index: int
    nq: int
    nkv: int
    kv: Any
    ins: Dict[str, Any]


def kv_shards(kv: Any) -> List[Any]:
    """A sharded model's per-shard list of caches, pools or K/V tensors
    as it is; anything else as the one shard it is."""
    return kv if isinstance(kv, list) else [kv]


def run_layers(cfg: ModelConfig, model, x: torch.Tensor, attn: Callable,
               kv: Any = None, ins: Optional[Dict[str, Any]] = None
               ) -> torch.Tensor:
    """The residual stream ``x`` through every layer: the pre-norm,
    ``attn(lp, h_in, i, shard)`` (the attention's output [..., N_q * D])
    times ``wo``, then the pre-norm FFN, each added to the residual.
    ``kv`` and ``ins`` reach the hook through its ``Shard``.  A sharded
    model runs per shard (``parallel/tp_attention.tp_layers``)."""
    if is_sharded(model):
        return tp_layers(cfg, model, x, attn, kv, ins)
    shard = Shard(0, cfg.num_heads, cfg.num_kv_heads, kv, ins or {})
    for i, lp in enumerate(model.layers):
        h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
        x = x + quant.matmul(attn(lp, h_in, i, shard), lp.wo)
        x = x + lp.ffn(cfg, rms_norm(x, lp.ln2, cfg.norm_eps))[0]
    return x


def _prefill_layer(cfg: ModelConfig, lp: nn.Module, x: torch.Tensor,
                   sin: torch.Tensor, cos: torch.Tensor):
    """One layer of the full-prompt forward: -> (x, k, v, aux)."""
    b, s = x.shape[:2]
    d = cfg.head_dim
    h_in = rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
    q = q.reshape(b, s, cfg.num_heads, d)
    k = k.reshape(b, s, cfg.num_kv_heads, d)
    v = v.reshape(b, s, cfg.num_kv_heads, d)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = attention.causal(q, k, v).reshape(b, s, cfg.num_heads * d)
    x = x + quant.matmul(out, lp.wo)
    ffn_out, aux = lp.ffn(cfg, rms_norm(x, lp.ln2, cfg.norm_eps))
    return x + ffn_out, k, v, aux


def forward(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
            positions: torch.Tensor, remat: bool = False
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                       torch.Tensor]:
    """The full-prompt forward, under autograd when it is on: -> (hidden,
    (k_all, v_all), aux), aux the layers' summed MoE load-balance loss
    (float32 0 for a dense model).  ``remat`` recomputes each layer in
    the backward pass (``torch.utils.checkpoint``, the JAX trainer's
    ``jax.checkpoint``), and then returns no K/V (``(None, None)``)."""
    x = quant.embed_rows(model.embed, tokens)
    sin, cos = rope_sincos(positions, cfg.head_dim, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp in model.layers:
        if remat:
            x, _, _, layer_aux = checkpoint(
                _prefill_layer, cfg, lp, x, sin, cos, use_reentrant=False)
        else:
            x, k, v, layer_aux = _prefill_layer(cfg, lp, x, sin, cos)
            ks.append(k)
            vs.append(v)
        if layer_aux is not None:
            aux = aux + layer_aux
    hidden = rms_norm(x, model.final_ln, cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if ks else (None, None)
    return hidden, kv, aux


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
            positions: torch.Tensor, attn: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Process a full (right-padded) prompt.

    tokens/positions [B, S] -> (final-normed hidden [B, S, H],
    (k_all, v_all) each [L, B, S, N_kv, D]), the per-layer K/V to page
    into the pool.  A sharded model's K/V are per-shard lists, and
    ``attn(q, k, v, shard)`` replaces its causal attention (K2) on head
    shard ``shard`` (q [B, S, N_q', D], k/v [B, S, N_kv', D] ->
    [B, S, N_q', D]): the hook sequence-parallel prefill puts ring
    attention in through (JAX's ``attn``)."""
    if not is_sharded(model):
        hidden, kv, _ = forward(cfg, model, tokens, positions)
        return hidden, kv
    b, s = tokens.shape
    d = cfg.head_dim
    x = quant.embed_rows(model.embed, tokens)
    sin, cos = rope_sincos(positions, d, cfg.rope_theta)
    ks: List[List[torch.Tensor]] = [[] for _ in range(model.tp)]
    vs: List[List[torch.Tensor]] = [[] for _ in range(model.tp)]
    attend = attn or (lambda q, k, v, shard: attention.causal(q, k, v))

    def hook(lp, h_in, i, sh):
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, s, sh.nq, d)
        k = k.reshape(b, s, sh.nkv, d)
        v = v.reshape(b, s, sh.nkv, d)
        q = apply_rope(q, sh.ins["sin"], sh.ins["cos"])
        k = apply_rope(k, sh.ins["sin"], sh.ins["cos"])
        ks[sh.index].append(k)
        vs[sh.index].append(v)
        return attend(q, k, v, sh.index).reshape(b, s, sh.nq * d)

    x = run_layers(cfg, model, x, hook, ins={"sin": sin, "cos": cos})
    hidden = rms_norm(x, model.final_ln, cfg.norm_eps)
    return hidden, ([torch.stack(k) for k in ks], [torch.stack(v) for v in vs])


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
                  kv_quantize: str = "none", device=None,
                  kv_heads: Optional[int] = None) -> KVCache:
    """Zeroed contiguous cache [L, B, S, N_kv, D]; ``kv_quantize="int8"``
    stores K/V as int8 with float32 row scales initialised to ones.
    ``kv_heads`` (default N_kv): a head shard's count."""
    shape = (cfg.num_layers, batch, max_seq, kv_heads or cfg.num_kv_heads,
             cfg.head_dim)
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
    """Positions ``start`` and later of a cache (every shard's) set in
    place to what ``init_kv_cache`` holds (zeros; int8 scale planes
    ones)."""
    for c in kv_shards(cache):
        for name, x in c.items():
            x[:, :, start:].fill_(1.0 if name in ("ks", "vs") else 0)


def seed_kv_cache_into(cache: KVCache, k_all: torch.Tensor,
                       v_all: torch.Tensor) -> None:
    """``seed_kv_cache`` in place: a prefill's K/V ([L, B, S, N_kv, D])
    written at positions [0, S) of an existing cache and every later
    position reset, so the cache equals ``seed_kv_cache``'s.  A sharded
    cache takes its prefill's per-shard K/V lists; a shard's cache split
    in sequence pieces (an sp group's) takes each piece's positions."""
    for c, k, v in zip(kv_shards(cache), kv_shards(k_all), kv_shards(v_all)):
        pieces = c if isinstance(c, list) else [c]
        s, start = k.shape[2], 0
        for piece in pieces:
            n = min(max(s - start, 0), piece["k"].shape[2])
            if n:
                quant.put_kv_rows(
                    piece, None, (slice(None), slice(None), slice(0, n)),
                    *(x[:, :, start:start + n].to(piece["k"].device,
                                                   non_blocking=True)
                      for x in (k, v)))
            reset_kv_cache(piece, n)
            start += piece["k"].shape[2]


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: Transformer, token: torch.Tensor,
                pos: torch.Tensor, cache: KVCache,
                attn: Optional[Callable] = None) -> torch.Tensor:
    """One decode step for every sequence: token [B], pos [B] int32 (its
    position), the cache written in place at ``pos`` (clamped into the
    cache, as the JAX package's dynamic update) BEFORE attending.
    Returns logits [B, V] float32.  ``attn(q, k, v, kv, i, pos)``
    replaces the write and the attention (K9/K10) of layer ``i`` on a
    head shard's cache ``kv``: the sequence-parallel hook
    (``parallel/sp_attention.sp_decode_attn``), over a cache split in
    pieces."""
    b = token.shape[0]
    d = cfg.head_dim
    x = quant.embed_rows(model.embed, token)                       # [B, H]
    sin, cos = rope_sincos(pos, d, cfg.rope_theta)
    ins = {"sin": sin, "cos": cos, "pos": pos}
    if attn is None:
        ins["b"] = torch.arange(b, device=token.device)
        ins["row"] = pos.long().clamp(0, kv_shards(cache)[0]["k"].shape[2]
                                      - 1)

    def hook(lp, h_in, i, sh):
        c, ins = sh.kv, sh.ins
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, sh.nq, d)
        k = k.reshape(b, sh.nkv, d)
        v = v.reshape(b, sh.nkv, d)
        q = apply_rope(q, ins["sin"], ins["cos"])
        k = apply_rope(k, ins["sin"], ins["cos"])
        if attn is not None:
            return attn(q, k, v, c, i, ins["pos"]).reshape(b, sh.nq * d)
        quant.put_kv_rows(c, i, (ins["b"], ins["row"]), k, v)
        out = attention.decode(q, c["k"][i], c["v"][i], ins["pos"],
                               *layer_scales(c, i))
        return out.reshape(b, sh.nq * d)

    x = run_layers(cfg, model, x, hook, cache, ins)
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
    first = kv_shards(cache)[0]
    rows = chunk_rows(start, s_c, first)
    w = window or first["k"].shape[2]

    def attn(lp, h_in, i, sh):
        c, ins = sh.kv, sh.ins
        q, k, v = quant.matmul_many(h_in, (lp.wq, lp.wk, lp.wv))
        q = q.reshape(b, s_c, sh.nq, d)
        k = k.reshape(b, s_c, sh.nkv, d)
        v = v.reshape(b, s_c, sh.nkv, d)
        q = apply_rope(q, ins["sin"], ins["cos"])
        k = apply_rope(k, ins["sin"], ins["cos"])
        quant.put_kv_rows(c, i, (ins["b"], ins["row"]), k, v)
        scales = [sc[:, :w] for sc in layer_scales(c, i)]
        out = attention.chunk(q, c["k"][i][:, :w], c["v"][i][:, :w],
                              ins["q_pos"], *scales)
        return out.reshape(b, s_c, sh.nq * d)

    x = run_layers(cfg, model, x, attn, cache, {
        "sin": sin, "cos": cos, "b": rows[0], "row": rows[1],
        "q_pos": q_pos})
    return rms_norm(x, model.final_ln, cfg.norm_eps)
