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

``matmul`` routes a product with a quantized weight by where ``x`` lies:

- a CPU tensor takes the plain version, ``(x @ q.to(x.dtype)) * s``, the
  JAX package's XLA path;
- a CUDA tensor launches W1, the hand-written kernel
  ``csrc/w8_matmul.cu`` (``w8_matmul``), which reads each int8 weight
  once: the port's counterpart of XLA fusing the cast into the dot.  Its
  two regimes are a shape rule (``w8_route``), like the bf16 chunk
  kernel's two routes: decode rows (at most ``W8_DECODE_ROWS``: a batched
  tick's slots, a verify round's B (gamma + 1) rows, the draft's steps,
  the sequential engines' one row) and wide rows (prefill and chunks).

``matmul_many`` computes several products of one ``x`` (a layer's
q/k/v or gate/up projections): on a CUDA tensor with quantized weights,
one W1 launch for all of them, each output bit for bit the lone
product's.  ``expert_einsum`` (the MoE expert products) runs one
``w8_matmul`` per expert on a CUDA tensor; a CPU tensor takes the JAX
package's einsum against the cast stack.  The embedding lookup and the
tied head stay plain.  The module
also keeps the KV-row quantizer (``quantize_kv_rows``, ``dequantize_kv_rows``) and the
in-place KV row write both caches share (``put_kv_rows``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from . import _build

# W1's regimes, a shape rule: at most W8_DECODE_ROWS rows take the decode
# tiles (one consumer warpgroup, x rows padded to 8, 16, 32 or 64), more
# rows the wide tiles (64 or 128 rows x 256 columns, two warpgroups:
# ``w8_tile``, ``w8_plan``).
W8_DECODE_ROWS = 64
# 64 k-rows a k-tile; 128 weight columns a consumer warpgroup.
W8_BK = 64
W8_SUB = 128
# A weight's k-tiles are cut into at most this many chunks (a tile's
# fix-up reads one partial a chunk).
W8_MAX_CHUNKS = 16
# The H100's SMs: the plan's default (the wrapper reads the card's own).
W8_SMS = 132
# The most weights one launch takes (q/k/v).
W8_MAX_WEIGHTS = 3


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
    ``x.dtype`` against the cast weight, then the scale ``s [1, N]``.  On a
    CUDA tensor this is the cast route, which no product of the port
    takes: such a call counts (``.calls``) so a main path can show none
    ran."""
    if x.is_cuda:
        _matmul_plain.calls += 1
    return (x @ q.to(x.dtype)) * s.squeeze(-2)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or quantized weight stored [in, out]; a
    quantized weight goes to ``w8_matmul`` (the plain version on the
    CPU)."""
    if not is_quantized(w):
        return x @ w
    return w8_matmul(x, w.q, w.s)


def matmul_many(x: torch.Tensor, weights: Sequence[Any]
                ) -> List[torch.Tensor]:
    """``[matmul(x, w) for w in weights]``; on a CUDA tensor whose weights
    are all quantized, one W1 launch (``w8_matmul_many``) for all of them
    (at most W8_MAX_WEIGHTS, one contraction width), each output bit for
    bit the lone product's."""
    if not (x.is_cuda and all(is_quantized(w) for w in weights)):
        return [matmul(x, w) for w in weights]
    return w8_matmul_many(x, [(w.q, w.s) for w in weights])


def expert_einsum(subscripts: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """Einsum against stacked MoE expert weights [E, in, out], plain or
    int8 (``models/moe.py``): ``"ech,ehf->ecf"``/``"ecf,efh->ech"``
    (capacity dispatch, expert-major) and ``"bh,ehf->bef"``/
    ``"bef,efh->beh"`` (decode's all-expert pass).  An int8 stack's
    per-(expert, channel) scale ``s [E, 1, out]`` folds into the output,
    as the JAX package's does; on a CUDA tensor each expert's product is
    one ``w8_matmul``."""
    if not is_quantized(w):
        return torch.einsum(subscripts, x, w)
    lhs, out_axes = subscripts.split("->")
    x_axes = lhs.split(",")[0]
    if x.is_cuda:
        def rows(e: int) -> torch.Tensor:
            return x.select(x_axes.index("e"), e) if "e" in x_axes else x
        ys = [w8_matmul(rows(e), w.q[e], w.s[e])
              for e in range(w.q.shape[0])]
        return torch.stack(ys, dim=out_axes.index("e"))
    y = torch.einsum(subscripts, x, w.q.to(x.dtype))
    if out_axes[0] == "e":
        return y * w.s                       # [E, C, out] x [E, 1, out]
    return y * w.s.squeeze(-2)               # [B, E, out] x [E, out]


def w8_route(x: torch.Tensor) -> str:
    """Which path a product of ``x`` with a quantized weight takes:
    ``"plain"`` on the CPU; on the card W1's ``"decode"`` regime for at
    most W8_DECODE_ROWS rows and its ``"wide"`` regime above."""
    if not x.is_cuda:
        return "plain"
    return ("decode" if x.numel() // x.shape[-1] <= W8_DECODE_ROWS
            else "wide")


def w8_tile(m: int) -> Tuple[int, int]:
    """W1's reference tile for an ``m``-row product, (rows, columns), by
    which a weight's chunks are planned: decode rows pad to 8, 16, 32 or
    64 under one consumer warpgroup's 128 columns; wide rows take 64 x 256
    (two warpgroups).  A wide launch of at least a wave of these tiles runs
    128-row tiles instead (``w8_plan``): the rows a tile holds do not
    change a product's sums, its chunks do."""
    if m > W8_DECODE_ROWS:
        return 64, 2 * W8_SUB
    return next(b for b in (8, 16, 32, 64) if m <= b), W8_SUB


def w8_chunks(m: int, k: int, n: int, sms: int = W8_SMS) -> Tuple[int, int]:
    """(k-tiles a chunk, chunks a tile) of one [k, n] weight at ``m`` rows:
    shapes in, ints out, nothing read from the device.  One wave: a weight
    of fewer tiles than the card has SMs cuts each tile's k-tiles into as
    many chunks as keep its items within the SMs (sms // tiles), at most
    W8_MAX_CHUNKS at decode rows and 4 of at least 8 k-tiles at wide rows
    (a wide chunk's partial, [64 or 128, 256] float32, costs the fix-up
    more than a k-tile of its own); equal chunks, the last one shorter
    where they do not divide.  A function of this weight alone, so a
    grouped launch sums each product in the same order as a lone one."""
    bm, bn = w8_tile(m)
    kt = -(-k // W8_BK)
    tiles = -(-m // bm) * -(-n // bn)
    if m > W8_DECODE_ROWS:
        cap = min(4, kt // 8)
    else:
        cap = min(W8_MAX_CHUNKS, kt)
    want = max(1, min(cap, sms // tiles))
    chunk = -(-kt // want)
    return chunk, -(-kt // chunk)


@dataclasses.dataclass(frozen=True)
class W8Plan:
    """One W1 launch: the tile, each weight's chunks, tiles and items, the
    grid, and the partials' float32 slots (zero when no weight splits)."""
    bm: int
    bn: int
    kt: int
    chunks: Tuple[Tuple[int, int], ...]     # (k-tiles a chunk, chunks a tile)
    tiles: Tuple[int, ...]
    items: Tuple[int, ...]
    grid: int

    @property
    def total_items(self) -> int:
        return sum(self.items)

    @property
    def part_floats(self) -> int:
        split = any(nch > 1 for _, nch in self.chunks)
        return self.total_items * self.bm * self.bn if split else 0


def w8_plan(m: int, shapes: Sequence[Tuple[int, int]],
            sms: int = W8_SMS) -> W8Plan:
    """The plan of one launch over weights of ``shapes`` [(k, n), ...]
    (one k) at ``m`` rows: the tile (``w8_tile``'s; at wide rows 128 x
    256 where the launch has at least ``sms`` reference tiles), each
    weight's ``w8_chunks``, its tiles (row tiles x column tiles) and items
    (tiles x chunks), and a persistent grid of min(items, sms) blocks.
    Memoized: a served model asks for a few dozen plans."""
    return _w8_plan(m, tuple(tuple(s) for s in shapes), sms)


@functools.lru_cache(maxsize=1024)
def _w8_plan(m: int, shapes: Tuple[Tuple[int, int], ...],
             sms: int) -> W8Plan:
    bm, bn = w8_tile(m)
    if m > W8_DECODE_ROWS and sum(
            -(-m // bm) * -(-n // bn) for _, n in shapes) >= sms:
        # A wave of reference tiles: 128-row tiles widen and reload each
        # weight tile half as often.
        bm = 128
    k = shapes[0][0]
    chunks = tuple(w8_chunks(m, k, n, sms) for _, n in shapes)
    tiles = tuple(-(-m // bm) * -(-n // bn) for _, n in shapes)
    items = tuple(t * nch for t, (_, nch) in zip(tiles, chunks))
    return W8Plan(bm, bn, -(-k // W8_BK), chunks, tiles, items,
                  min(sum(items), sms))


def _check_w8(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor,
                                                        torch.Tensor]]
              ) -> None:
    """Raise ``ValueError`` on any input W1 does not take (one combined
    test on the hot path, each attribute read once; ``_explain_w8`` names
    the rule that failed)."""
    m, k = x.shape
    xs0, xs1 = x.stride()
    dev = x.device
    ok = (1 <= len(weights) <= W8_MAX_WEIGHTS and m >= 1 and k % 16 == 0
          and xs1 == 1 and xs0 >= k and xs0 % 8 == 0
          and x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0)
    for q, s in weights:
        shape = q.shape
        ok = ok and (len(shape) == 2 and shape[0] == k and shape[1] % 16 == 0
                     and q.dtype == torch.int8 and s.dtype == torch.bfloat16
                     and s.numel() == shape[1] and q.is_contiguous()
                     and s.is_contiguous() and q.device == dev
                     and s.device == dev and q.data_ptr() % 16 == 0)
    if not ok:
        _explain_w8(x, weights)


def _explain_w8(x: torch.Tensor, weights) -> None:
    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"w8_matmul: {msg}")

    m, k = x.shape
    require(1 <= len(weights) <= W8_MAX_WEIGHTS,
            f"{len(weights)} weights (1 to {W8_MAX_WEIGHTS} a launch)")
    require(x.dtype == torch.bfloat16, "x must be bf16")
    require(m >= 1, "x has no rows")
    require(k % 16 == 0, f"K={k} must be a multiple of 16")
    require(x.stride(1) == 1 and x.stride(0) >= k and x.stride(0) % 8 == 0,
            f"x strides {x.stride()} (rows dense, row stride a multiple of 8)")
    require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned")
    for q, s in weights:
        require(q.dim() == 2 and q.shape[0] == k, f"q {tuple(q.shape)} "
                f"against x {tuple(x.shape)}")
        n = q.shape[1]
        for name, t in (("q", q), ("s", s)):
            require(t.device == x.device,
                    f"{name} on {t.device}, x on {x.device}")
            require(t.is_contiguous(), f"{name} must be contiguous")
        require(s.dtype == torch.bfloat16, "s must be bf16")
        require(q.dtype == torch.int8, "q must be int8")
        require(s.numel() == n, f"s holds {s.numel()} scales for {n} columns")
        require(n % 16 == 0, f"N={n} must be a multiple of 16")
        require(q.data_ptr() % 16 == 0, "q must be 16-byte aligned")


_SMS: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def w8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """W1: ``x [..., K] @ (q [K, N] int8 * s [1, N])`` -> [..., N] in
    ``x.dtype``, rounded as ``_matmul_plain`` rounds (the float32 sum to
    bf16, then times the scale).  A CPU tensor takes the plain version; a
    CUDA tensor launches ``csrc/w8_matmul.cu`` or raises."""
    if not x.is_cuda:
        return _matmul_plain(x, q, s)
    return w8_matmul_many(x, ((q, s),))[0]


def w8_matmul_many(x: torch.Tensor,
                   weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> List[torch.Tensor]:
    """W1 over up to W8_MAX_WEIGHTS int8 weights ``(q [K, N_i], s)`` that
    share ``x [..., K]``: one launch on a CUDA tensor (planned by
    ``w8_plan``), each output equal bit for bit to its lone product; the
    plain version, weight by weight, on a CPU tensor."""
    if not x.is_cuda:
        return [_matmul_plain(x, q, s) for q, s in weights]
    k = x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, k)
    _check_w8(x2, weights)
    m = x2.shape[0]
    dev = x.device
    plan = w8_plan(m, [(k, q.shape[1]) for q, _ in weights], _sm_count(dev))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ys = [torch.empty((m, q.shape[1]), dtype=x.dtype, device=dev)
          for q, _ in weights]
    # A split launch's scratch, its own: the partials, then a counter a
    # tile (the entry zeroes them on the stream before the kernel).
    tiles = sum(plan.tiles)
    part = (torch.empty(plan.part_floats + tiles, dtype=torch.float32,
                        device=dev) if plan.part_floats else None)
    args = []
    for i in range(W8_MAX_WEIGHTS):
        if i < len(weights):
            q, s = weights[i]
            args += [q.data_ptr(), s.data_ptr(), ys[i].data_ptr(),
                     q.shape[1], plan.chunks[i][0]]
        else:
            args += [None, None, None, 0, 0]
    err = _build.entry("w8_matmul")(
        x2.data_ptr(), x2.stride(0), m, k, plan.bm, len(weights), *args,
        None if part is None else part.data_ptr(), plan.part_floats,
        None if part is None else part.data_ptr() + 4 * plan.part_floats,
        tiles, plan.grid, stream)
    _build.check(err, "w8_matmul")
    w8_matmul.launches += 1
    w8_matmul.route_launches[w8_route(x2)] += 1
    if x.dim() == 2:
        return ys
    return [y.reshape(*x.shape[:-1], y.shape[-1]) for y in ys]


def w8_split_mirror(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    sms: int = W8_SMS) -> torch.Tensor:
    """W1's arithmetic in plain float32 PyTorch (tests only): the plan's
    tiles (x rows padded with zeros to the tile's rows, the weight's
    columns to its columns, k-rows to whole 64-row k-tiles), each chunk's
    float32 partial from zero, a split tile's partials summed in chunk
    order, then the rounding to x's dtype, the scale and the rounding
    again.  Within a chunk the float32 product keeps its own order (the
    kernel's tensor cores another; up to 32 decode rows it also sums the
    even and odd 16-row k-steps apart).  x [M, K]."""
    m, k = x.shape
    n = q.shape[1]
    plan = w8_plan(m, [(k, n)], sms)
    chunk, nch = plan.chunks[0]
    rows = -(-m // plan.bm) * plan.bm
    cols = -(-n // plan.bn) * plan.bn
    depth = plan.kt * W8_BK
    xf = torch.nn.functional.pad(x.float(), (0, depth - k, 0, rows - m))
    qf = torch.nn.functional.pad(q.float(), (0, cols - n, 0, depth - k))
    span = chunk * W8_BK
    total = None
    for c in range(nch):
        part = xf[:, c * span:(c + 1) * span] @ qf[c * span:(c + 1) * span]
        total = part if total is None else total + part
    out = total[:m, :n]
    return (out.to(x.dtype).float() * s.float().reshape(-1)).to(x.dtype)


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
_matmul_plain.calls = 0
w8_matmul.route_launches = {"decode": 0, "wide": 0}
