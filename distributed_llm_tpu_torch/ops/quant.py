"""Weight-only int8 quantization for serving, and the int8 KV rows.

Counterpart of ``distributed_llm_tpu/ops/quant.py`` (without sharded
placement: tensor parallelism is not ported).  A quantized weight is a
``QTensor``:
an ``nn.Module`` holding an int8 buffer ``q`` and a scale ``s`` in the
model dtype, ``w ~= q * s`` broadcast over the contraction axis.  A
projection [in, out] carries ``s [1, out]`` (the JAX package stacks
``[L, 1, out]``; the port keeps one per layer), the embedding table
[V, H] per-row ``s [V, 1]``, a MoE layer's stacked experts [E, in, out]
per-(expert, channel) ``s [E, 1, out]`` (the router stays unquantized).
Quantizing (``quantize_params``, through
``maybe_quantize``) swaps a model's parameters for QTensors in place, one
at a time, so on the card the bf16 and the int8 copy of a weight are
resident together for one weight only; ``.to(device)`` carries ``q`` and
``s``.  The numerics are the JAX package's: ``quantize_tensor`` gives
bit-identical ``q`` and ``s``.

``matmul`` routes a product with a quantized weight by a shape rule:

- a CPU tensor takes the plain version, ``(x @ q.to(x.dtype)) * s``, the
  JAX package's XLA path;
- a CUDA tensor of at most ``W8_MAX_ROWS`` rows (every decode-shaped
  product: a batched tick's slots, a verify round's B (gamma + 1) rows, the
  draft's steps, the sequential engines' one row) launches W1, the
  hand-written kernel ``csrc/w8_matmul.cu`` (``w8_matmul``), which reads
  each int8 weight once: the port's counterpart of XLA fusing the cast
  into the dot;
- a CUDA tensor of more rows (prefill and chunks, compute-bound) casts
  the weight and calls ``torch.matmul``, as the JAX package leaves such
  products to XLA outside any kernel.

``expert_einsum`` (the MoE expert products) takes the same rule per
expert on a CUDA tensor: each expert's product is a ``matmul`` of its
rows against its [in, out] slice, W1 up to 64 rows, cast + matmul
above; a CPU tensor takes the JAX package's einsum against the cast
stack.  The embedding lookup and the tied head stay plain.  The module
also keeps the KV-row quantizer (``quantize_kv_rows``, ``dequantize_kv_rows``) and the
in-place KV row write both caches share (``put_kv_rows``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
from torch import nn

from . import _build

# The decode-shaped products W1 takes: at most 64 rows (the kernel's
# 8-row tiles, eight of them).  A shape rule, like the bf16 chunk kernel's
# two routes, not a switch.
W8_MAX_ROWS = 64
# W1's tiles: 128 output columns a block, 64 k-rows a stage; the grid is
# sized to at least W8_TARGET_BLOCKS blocks (two per SM of the H100's 132).
W8_BN = 128
W8_BK = 64
W8_TARGET_BLOCKS = 2 * 132


class QTensor(nn.Module):
    """An int8 weight: ``q`` int8 and its scale ``s`` (model dtype), both
    buffers, so ``.to(device)`` moves them."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


def is_quantized(w: Any) -> bool:
    return isinstance(w, QTensor)


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 over the trailing D axis: returns (int8
    values, float32 scales with the D axis dropped).  ``scale`` is
    amax / 127 where amax > 0, else 1; values round half to even and clip
    to +-127 (bit-identical to the JAX package's)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """``int8 * scale`` in float32, cast to ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def put_kv_rows(cache, layer, index, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """Write K/V rows in place at ``cache[name][layer][index]`` (every
    layer when ``layer`` is None), quantizing them first when the cache
    (a paged pool or a contiguous cache) is int8, i.e. holds the
    ``"ks"``/``"vs"`` scale planes."""
    def at(name):
        return cache[name] if layer is None else cache[name][layer]

    if "ks" in cache:
        k, k_sc = quantize_kv_rows(k)
        v, v_sc = quantize_kv_rows(v)
        at("ks")[index] = k_sc
        at("vs")[index] = v_sc
    at("k")[index] = k
    at("v")[index] = v


@torch.no_grad()
def quantize_tensor(w: torch.Tensor, contract_axis: int = -2) -> QTensor:
    """Per-output-channel symmetric int8: the scale is amax / 127 over the
    contraction axis (-2: the 'in' dim of an [in, out] weight; -1 for the
    embedding's per-row scales).  The scale is rounded to the weight's
    dtype FIRST and the weight quantized against the rounded value, as
    the JAX package does (round half to even, clip to +-127)."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    scale = (torch.clamp(amax, min=1e-8) / 127.0).to(w.dtype)
    q = torch.round(wf / scale.float()).clamp(-127, 127).to(torch.int8)
    return QTensor(q, scale)


def dequantize(w: Any) -> torch.Tensor:
    if not is_quantized(w):
        return w
    return w.q.to(w.s.dtype) * w.s


def _matmul_plain(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """W1's plain version, the JAX package's arithmetic: the product in
    ``x.dtype`` against the cast weight, then the scale ``s [1, N]``."""
    return (x @ q.to(x.dtype)) * s.squeeze(-2)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight stored [in, out]; a
    quantized weight is routed by ``w8_route``."""
    if not is_quantized(w):
        return x @ w
    if w8_route(x) == "w1":
        return w8_matmul(x, w.q, w.s)
    return _matmul_plain(x, w.q, w.s)


def expert_einsum(subscripts: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """Einsum against stacked MoE expert weights [E, in, out], plain or
    int8 (``models/moe.py``): ``"ech,ehf->ecf"``/``"ecf,efh->ech"``
    (capacity dispatch, expert-major) and ``"bh,ehf->bef"``/
    ``"bef,efh->beh"`` (decode's all-expert pass).  An int8 stack's
    per-(expert, channel) scale ``s [E, 1, out]`` folds into the output,
    as the JAX package's does; on a CUDA tensor each expert's product
    routes as ``matmul``'s (``w8_route``)."""
    if not is_quantized(w):
        return torch.einsum(subscripts, x, w)
    lhs, out_axes = subscripts.split("->")
    x_axes = lhs.split(",")[0]
    if x.is_cuda:
        def rows(e: int) -> torch.Tensor:
            return x.select(x_axes.index("e"), e) if "e" in x_axes else x
        ys = [w8_matmul(rows(e), w.q[e], w.s[e])
              if w8_route(rows(e)) == "w1"
              else _matmul_plain(rows(e), w.q[e], w.s[e])
              for e in range(w.q.shape[0])]
        return torch.stack(ys, dim=out_axes.index("e"))
    y = torch.einsum(subscripts, x, w.q.to(x.dtype))
    if out_axes[0] == "e":
        return y * w.s                       # [E, C, out] x [E, 1, out]
    return y * w.s.squeeze(-2)               # [B, E, out] x [E, out]


def w8_route(x: torch.Tensor) -> str:
    """Which path a product of ``x`` with a quantized weight takes:
    ``"plain"`` on the CPU, ``"w1"`` (the kernel) for a CUDA tensor of at
    most W8_MAX_ROWS rows, ``"wide"`` (cast + ``torch.matmul``) above."""
    if not x.is_cuda:
        return "plain"
    return "w1" if x.numel() // x.shape[-1] <= W8_MAX_ROWS else "wide"


def w8_split_plan(k: int, n: int) -> Tuple[int, int]:
    """(k-tiles per split, splits) of W1 for a [k, n] weight: as many
    splits of the ceil(k / W8_BK) k-tiles as bring the grid's
    ceil(n / W8_BN) column tiles to W8_TARGET_BLOCKS blocks.  Shapes in,
    ints out, nothing read from the device."""
    k_tiles = -(-k // W8_BK)
    want = min(k_tiles, -(-W8_TARGET_BLOCKS // -(-n // W8_BN)))
    tiles = -(-k_tiles // want)
    return tiles, -(-k_tiles // tiles)


def _check_w8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """Raise ``ValueError`` on any input W1 does not take (one combined
    test on the hot path; ``_explain_w8`` names the rule that failed)."""
    k, n = x.shape[1], q.shape[-1]
    if not (q.dim() == 2 and q.shape[0] == k and q.dtype == torch.int8
            and x.dtype == torch.bfloat16 and s.dtype == torch.bfloat16
            and s.numel() == n and 1 <= x.shape[0] <= W8_MAX_ROWS
            and k % 16 == 0 and n % 16 == 0 and x.stride(1) == 1
            and x.stride(0) >= k and x.stride(0) % 8 == 0
            and q.is_contiguous() and s.is_contiguous()
            and q.device == x.device and s.device == x.device
            and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0):
        _explain_w8(x, q, s)


def _explain_w8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"w8_matmul: {msg}")

    m, k = x.shape
    require(q.dim() == 2 and q.shape[0] == k, f"q {tuple(q.shape)} against "
            f"x {tuple(x.shape)}")
    n = q.shape[1]
    for name, t in (("q", q), ("s", s)):
        require(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(x.dtype == s.dtype == torch.bfloat16, "x and s must be bf16")
    require(q.dtype == torch.int8, "q must be int8")
    require(s.numel() == n, f"s holds {s.numel()} scales for {n} columns")
    require(1 <= m <= W8_MAX_ROWS, f"{m} rows (1 to {W8_MAX_ROWS})")
    require(k % 16 == 0 and n % 16 == 0, f"K={k} and N={n} must be "
            "multiples of 16")
    require(x.stride(1) == 1 and x.stride(0) >= k and x.stride(0) % 8 == 0,
            f"x strides {x.stride()} (rows dense, row stride a multiple of 8)")
    require(x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0,
            "x and q must be 16-byte aligned")


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """W1: ``x [..., K] @ (q [K, N] int8 * s [1, N])`` -> [..., N] in
    ``x.dtype``, rounded as ``_matmul_plain`` rounds (the float32 sum to
    bf16, then times the scale).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/w8_matmul.cu`` (split pass and merge
    pass, planned by ``w8_split_plan``) or raises."""
    if not x.is_cuda:
        return _matmul_plain(x, q, s)
    k = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, k)
    _check_w8(x2, q, s)
    m, n = x2.shape[0], q.shape[1]
    tiles, splits = w8_split_plan(k, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    err = _build.entry("w8_matmul")(
        x2.data_ptr(), x2.stride(0), q.data_ptr(), s.data_ptr(), y.data_ptr(),
        part.data_ptr(), m, k, n, tiles, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "w8_matmul")
    w8_matmul.launches += 1
    return y if x.dim() == 2 else y.reshape(*x.shape[:-1], n)


def w8_split_mirror(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                    ) -> torch.Tensor:
    """W1's algorithm in plain float32 PyTorch (tests only): the weight's
    columns in W8_BN tiles, its k-rows in W8_BK tiles zero-padded past K,
    one float32 partial per (split, row, column) over the split's k-tiles
    (``w8_split_plan``), the partials summed in split order, rounded to
    x's dtype, times the scale, rounded again.  x [M, K]."""
    m, k = x.shape
    n = q.shape[1]
    tiles, splits = w8_split_plan(k, n)
    span = tiles * W8_BK
    pad = splits * span - k
    xf = torch.nn.functional.pad(x.float(), (0, pad))
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, pad))
    part = torch.stack([xf[:, i * span:(i + 1) * span]
                        @ qf[i * span:(i + 1) * span] for i in range(splits)])
    total = part[0]
    for i in range(1, splits):
        total = total + part[i]
    return (total.to(x.dtype).float() * s.float().reshape(-1)).to(x.dtype)


def embed_rows(embed: Any, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table row lookup for a plain or quantized table [V, H];
    a quantized table carries per-row scales ``s [V, 1]``."""
    if not is_quantized(embed):
        return embed[tokens]
    return embed.q[tokens].to(embed.s.dtype) * embed.s[tokens]


def tied_head(embed: Any, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden @ embed.T`` (tied LM head), returned in float32; with row
    scales the scale folds into the logits: (hidden @ q.T) * s.T."""
    if not is_quantized(embed):
        return (hidden @ embed.T).float()
    logits = (hidden @ embed.q.T.to(hidden.dtype)).float()
    return logits * embed.s[:, 0].float()


# Weights quantized in a layer; the norms stay full precision.
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def swap_in(module: nn.Module, name: str, qt: QTensor) -> None:
    """Put ``qt`` under ``module.name`` in place of its parameter (a module
    cannot be assigned to a registered parameter's name, so the parameter
    goes first and is freed with its last reference)."""
    delattr(module, name)
    setattr(module, name, qt)


@torch.no_grad()
def quantize_params(model: nn.Module) -> nn.Module:
    """Quantize a ``Transformer`` for serving, in place: every projection
    of every layer (a MoE layer's stacked experts with per-(expert,
    channel) scales) and the (tied) embedding table, whose scales are
    per row; the norms and a MoE router pass through.  One weight at a
    time, each bf16 weight freed once its QTensor replaces it.
    Idempotent.  Returns ``model``."""
    if not is_quantized(model.embed):
        swap_in(model, "embed", quantize_tensor(model.embed, contract_axis=-1))
    for layer in model.layers:
        for key in _QUANT_LAYER_KEYS:
            if not is_quantized(getattr(layer, key)):
                swap_in(layer, key, quantize_tensor(getattr(layer, key)))
    return model


def maybe_quantize(model: nn.Module, tier, cfg=None) -> nn.Module:
    """Apply a tier's ``quantize`` mode: the one entry point every engine
    uses.  "none" returns ``model`` as it is, "int8" quantizes it in place
    (``quantize_params``); any other mode raises ``ValueError``.  ``cfg``
    is the JAX signature's (its sharded placement is not ported)."""
    mode = getattr(tier, "quantize", "none")
    if mode == "none":
        return model
    if mode != "int8":
        raise ValueError(f"unknown quantize mode {mode!r} "
                         "(expected 'none' or 'int8')")
    return quantize_params(model)


w8_matmul.launches = 0
