"""Mixture-of-Experts transformer, on one device or split over a group.

Counterpart of ``distributed_llm_tpu/models/moe.py``.  The layer
structure is the dense transformer's (``models/transformer.py``); only
the FFN is replaced by top-2 routed experts.  A ``MoELayer`` holds the
router ``w_router [H, E]`` and the stacked experts ``w_gate``/``w_up``
``[E, H, F]`` and ``w_down [E, F, H]`` (the JAX pytree's per-layer
slices), and its ``ffn`` picks the JAX package's rule by the input's
shape:

- a full sequence or chunk ``[B, S, H]`` (prefill, chunks, the batched
  verify) takes capacity dispatch (``moe_ffn_train``): the ``B * S``
  tokens flattened row-major, padding rows and idle slots included, each
  expert holding at most ``max(1, int(cf * 2 * T / E))`` of them in token
  order; a token over its expert's capacity contributes zero there.  It
  returns the Switch load-balance loss beside its output;
- decode rows ``[B, H]`` run every expert and combine by gate weight
  (``moe_ffn_decode``).

Because the choice lives in the layer, the dense forward functions
(``transformer.forward``/``prefill``/``chunk_prefill``/``decode_step``
and the paged pool's steps) serve either family; ``prefill`` here also
returns the summed aux loss, as the JAX function does.  The expert
products are plain PyTorch (``ops.quant.expert_einsum``), as they are
XLA einsums in the JAX package.

Split over a device group (``parallel/sharding.shard_params``) a tensor
shard's layer holds ``slices``: one ``ExpertSlice`` per ``ep`` slot,
E / ep whole experts with the shard's F / tp columns, on the slot's
device.  The top-2 gates, the capacity positions (a cumsum over all E
experts) and the aux loss are computed once, on the replicated router's
output, before the split, so the same tokens drop as in the JAX
package's GSPMD einsums; each slice then computes its experts'
contribution on its device (under ``launches.on_shard`` of its slot),
its gate-weighted combine as a float32 partial, and the contributions
are summed in float32 in slot order and rounded once (``collectives.
allreduce_sum``).  Unsplit, the combine is the JAX package's einsum in
the model's dtype, which accumulates in float32 and rounds once too.  A
row has at most two nonzero terms (top-2 gates in the model's dtype,
each product exact in float32), so at tp = 1 the split's sum is the
unsplit one.  The tensor shards' sums are summed again by
``parallel/tp_attention.tp_layers``, as a row-parallel ``w_down``'s
partials are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops import quant
from . import transformer
from .transformer import Transformer, _param


@dataclasses.dataclass
class ExpertSlice:
    """One group slot's experts: experts ``first`` to ``first + E / ep``
    with a tensor shard's F / tp columns, on ``device`` (slot ``slot``)."""
    first: int
    slot: int
    device: torch.device
    w_gate: Any                 # [E / ep, H, F / tp]
    w_up: Any                   # [E / ep, H, F / tp]
    w_down: Any                 # [E / ep, F / tp, H]


class MoELayer(nn.Module):
    """One MoE layer's weights: the dense layer's attention and norms,
    the router [H, E] and E stacked SwiGLU experts (split over a group:
    ``slices`` in their place)."""

    slices: Optional[List[ExpertSlice]] = None

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, f, d = cfg.hidden_size, cfg.ffn_size, cfg.head_dim
        e = cfg.num_experts
        nq, nkv = cfg.num_heads, cfg.num_kv_heads
        self.ln1 = _param((h,), dtype, device)
        self.wq = _param((h, nq * d), dtype, device)
        self.wk = _param((h, nkv * d), dtype, device)
        self.wv = _param((h, nkv * d), dtype, device)
        self.wo = _param((nq * d, h), dtype, device)
        self.ln2 = _param((h,), dtype, device)
        self.w_router = _param((h, e), dtype, device)
        self.w_gate = _param((e, h, f), dtype, device)
        self.w_up = _param((e, h, f), dtype, device)
        self.w_down = _param((e, f, h), dtype, device)

    def ffn(self, cfg: ModelConfig, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Routed experts on the normed residual: decode rows [B, H] ->
        (``moe_ffn_decode``, None); a sequence [B, S, H] -> capacity
        dispatch's (out, aux)."""
        if x.dim() == 2:
            return moe_ffn_decode(cfg, self, x), None
        return moe_ffn_train(cfg, self, x)


def _over_slices(lp: MoELayer, part, x: torch.Tensor,
                 *routes: torch.Tensor) -> torch.Tensor:
    """``part(w, x, acc, *routes)``, the gate-weighted combine in dtype
    ``acc``, on the whole layer (in ``x``'s dtype), or on each expert
    slice of ``lp`` as a float32 partial, ``x`` moved onto the slice's
    device and each route ([T, E, ...]) narrowed to the slice's experts
    there; the partials summed in float32, in slot order, onto ``x``'s
    device, and rounded once to its dtype."""
    if lp.slices is None:
        return part(lp, x, x.dtype, *routes)
    from ..ops import launches
    from ..parallel.collectives import allreduce_sum, rotate
    parts = []
    for sl in lp.slices:
        n = (sl.w_gate.q if quant.is_quantized(sl.w_gate)
             else sl.w_gate).shape[0]
        with launches.on_shard(sl.slot):
            parts.append(part(sl, rotate(x, sl.device), torch.float32, *(
                rotate(r.narrow(1, sl.first, n), sl.device)
                for r in routes)))
    return allreduce_sum(parts, [x.device])[0].to(x.dtype)


def _top2_gates(router_logits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, E] logits -> (combine weights [T, E], at most two nonzero,
    renormalised; probs [T, E] float32).  Softmax in float32, the first
    maximum's expert, then the first maximum of the rest."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    e = probs.shape[-1]
    mask1 = F.one_hot(probs.argmax(dim=-1), e).to(probs.dtype)
    masked = probs * (1.0 - mask1)
    mask2 = F.one_hot(masked.argmax(dim=-1), e).to(probs.dtype)
    gates = probs * (mask1 + mask2)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, probs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Expert buffer rows for ``tokens`` dispatched tokens (top-2)."""
    return max(1, int(cfg.moe_capacity_factor * 2 * tokens
                      / cfg.num_experts))


def moe_ffn_train(cfg: ModelConfig, lp: MoELayer, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch MoE FFN: x [B, S, H] -> (out [B, S, H], aux loss
    float32 scalar).  Tokens past their expert's capacity are dropped
    (contribute zero), the static-shape trade-off."""
    b, s, h = x.shape
    t = b * s
    e = cfg.num_experts
    xt = x.reshape(t, h)
    gates, probs = _top2_gates(quant.matmul(xt, lp.w_router))      # [T, E]
    cap = capacity(cfg, t)
    # Each token's slot in its expert's buffer, in token order.
    sel = (gates > 0).to(torch.int32)
    pos = torch.cumsum(sel, dim=0) * sel - 1
    keep = (pos >= 0) & (pos < cap)
    pos = torch.clamp(pos, 0, cap - 1)
    # dispatch [T, E, C]: one-hot of each kept token's buffer slot.
    dispatch = (keep[..., None]
                & F.one_hot(pos.long(), cap).bool()).to(x.dtype)
    combine = dispatch * gates.to(x.dtype)[..., None]

    def part(w, xt, acc, dispatch, combine):
        expert_in = torch.einsum("tec,th->ech", dispatch, xt)      # [E, C, H]
        gate_h = quant.expert_einsum("ech,ehf->ecf", expert_in, w.w_gate)
        up_h = quant.expert_einsum("ech,ehf->ecf", expert_in, w.w_up)
        act = F.silu(gate_h) * up_h
        expert_out = quant.expert_einsum("ecf,efh->ech", act, w.w_down)
        return torch.einsum("tec,ech->th", combine.to(acc),
                            expert_out.to(acc))

    out = _over_slices(lp, part, xt, dispatch, combine)
    # Switch load balance: E * sum_e fraction_of_tokens_e * mean_prob_e.
    frac = (gates > 0).float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return out.reshape(b, s, h), aux


def moe_ffn_decode(cfg: ModelConfig, lp: MoELayer,
                   x: torch.Tensor) -> torch.Tensor:
    """Decode-step MoE FFN, x [B, H]: every expert runs on the few rows
    and the top-2 gates combine them, no dispatch."""
    gates, _ = _top2_gates(quant.matmul(x, lp.w_router))           # [B, E]
    gates = gates.to(x.dtype)

    def part(w, x, acc, gates):
        gate_h = quant.expert_einsum("bh,ehf->bef", x, w.w_gate)
        up_h = quant.expert_einsum("bh,ehf->bef", x, w.w_up)
        act = F.silu(gate_h) * up_h
        outs = quant.expert_einsum("bef,efh->beh", act, w.w_down)  # [B, E, H]
        return torch.einsum("be,beh->bh", gates.to(acc), outs.to(acc))

    return _over_slices(lp, part, x, gates)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
            positions: torch.Tensor):
    """``transformer.prefill`` plus the summed load-balance loss:
    -> (hidden, (k_all, v_all), aux)."""
    return transformer.forward(cfg, model, tokens, positions)


# The dense init (normal * 0.02 for the router and every expert, ones for
# the norms), and the dense contracts of a chunk (capacity from the
# chunk's own tokens, so which tokens drop can differ from a whole-prompt
# prefill, as in the JAX package) and a decode step: the layer picks its
# FFN.
init_params = transformer.init_params
chunk_prefill = transformer.chunk_prefill
decode_step = transformer.decode_step
