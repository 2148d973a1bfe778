"""Sequence-parallel decode attention over a cache split on 'sp'.

Counterpart of ``distributed_llm_tpu/parallel/sp_attention.py``.  Ring
attention (``ring_attention.py``) spreads the prefill's O(S^2) over the
'sp' slots; the sequential engine's bf16 cache then keeps its sequence
split too (``parallel/sharding.kv_cache_shards(sequence=True)``: piece
``r`` holds positions [r * S / sp, (r + 1) * S / sp) on slot ``(r,
t)``), and each decode step is a two-phase reduction:

1. per piece: masked attention partials over its positions, the running
   max ``m``, normalizer ``l`` and unnormalized values ``o`` in float32
   (``_partials``);
2. across pieces: one max and two sums merge them exactly
   (``collectives.merge_partials``), then normalize.

Each slot holds and reads S / sp cached positions per step.  With tp > 1
each tensor shard runs the same over its own heads' pieces.  JAX
computes this in XLA with no Pallas kernel, so it is plain PyTorch
here.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..config import ModelConfig
from ..ops.attention import NEG_INF, _expand_kv
from .collectives import merge_partials, rotate
from .mesh import DeviceGroup


def _partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos: torch.Tensor, offset: int):
    """Masked attention partials of q [B, N_q, D] against a cache piece
    k/v [B, S_l, N_kv, D] whose positions start at ``offset``: (m [B, N],
    l [B, N], o [B, N, D] unnormalized), all float32."""
    groups = q.shape[1] // k.shape[2]
    k = _expand_kv(k, groups)
    v = _expand_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnd,bknd->bnk", q, k).float() * scale
    s_local = k.shape[1]
    valid = ((offset + torch.arange(s_local, device=q.device))[None, :]
             <= pos[:, None])                                   # [B, S_l]
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    m = logits.max(dim=-1).values                               # [B, N]
    e = torch.exp(logits - m[..., None])
    # An all-masked piece has m == NEG_INF and e == 1 rows: zero them so
    # the piece adds nothing (its merge weight is 0, but l and o must not
    # carry garbage).
    e = torch.where(valid[:, None, :], e, 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bnk,bknd->bnd", e.to(v.dtype), v).float()
    return m, l, o


def sp_decode(q: torch.Tensor, ks: List[torch.Tensor],
              vs: List[torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
    """One head shard's decode attention over its cache pieces (each
    [B, S / sp, N_kv, D] on its slot's device, in order): the partials
    on each piece's device, merged onto q's.  -> [B, N_q, D] in q's
    dtype."""
    parts = [_partials(rotate(q, k.device), k, v, rotate(pos, k.device),
                       r * k.shape[1])
             for r, (k, v) in enumerate(zip(ks, vs))]
    ms, ls, os = zip(*parts)
    return merge_partials(ms, ls, os, q.device).to(q.dtype)


def sp_flash_decode(group: DeviceGroup, sp_axis: str = "sp",
                    head_axis: Optional[str] = None) -> Callable:
    """(q [B, N_q, D], k/v [B, S, N_kv, D] whole, pos [B]) -> [B, N_q,
    D]: k/v split into the group's ``sp_axis`` pieces (and, with
    ``head_axis``, q and k/v into its head shards), per-piece partials
    and the exact merge."""
    sp = group.shape[sp_axis]
    tp = group.shape[head_axis] if head_axis else 1

    def run(q, k, v, pos):
        s_local = k.shape[1] // sp
        nq, nkv = q.shape[1] // tp, k.shape[2] // tp
        outs = []
        for t in range(tp):
            devs = group.column(t)
            kh, vh = k.narrow(2, t * nkv, nkv), v.narrow(2, t * nkv, nkv)
            outs.append(sp_decode(
                q.narrow(1, t * nq, nq),
                [rotate(kh.narrow(1, r * s_local, s_local), devs[r])
                 for r in range(sp)],
                [rotate(vh.narrow(1, r * s_local, s_local), devs[r])
                 for r in range(sp)], pos))
        return torch.cat(outs, dim=1) if tp > 1 else outs[0]

    return run


def write_rows(pieces: List[dict], i: int, pos: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """Write each sequence's new K/V row (k/v [B, N_kv, D]) at its
    position ``pos`` [B] into layer ``i`` of the piece holding it, in
    place.  Every piece takes a masked write (its own row where the
    position is its, the row it already holds elsewhere), so no host
    reads the position: capture-safe."""
    b = torch.arange(pos.shape[0], device=pos.device)
    for r, c in enumerate(pieces):
        dev = c["k"].device
        s_local = c["k"].shape[2]
        local = rotate(pos, dev).long() - r * s_local
        mine = ((local >= 0) & (local < s_local))[:, None, None]
        rows = (rotate(b, dev), local.clamp(0, s_local - 1))
        for name, new in (("k", k), ("v", v)):
            cache = c[name][i]
            cache[rows] = torch.where(mine, rotate(new, dev), cache[rows])


def sp_decode_attn(group: Optional[DeviceGroup], cfg: ModelConfig,
                   cache_len: int) -> Optional[Callable]:
    """The decode hook of a sequence-parallel tier (``transformer.
    decode_step``'s ``attn``: write the row into the shard's pieces,
    attend over them), or None to keep the tp path (a whole cache per
    head shard, K9): dense models, a length ``sp`` divides, head counts
    ``tp`` divides (JAX's gate; the engine asks only for a bf16
    cache)."""
    if group is None or cfg.num_experts > 1:
        return None
    sp, tp = group.sp, group.tp
    if sp <= 1 or cache_len % sp:
        return None
    if tp > 1 and (cfg.num_kv_heads % tp or cfg.num_heads % tp):
        return None

    def attn(q, k, v, pieces, i, pos):
        write_rows(pieces, i, pos, k, v)
        return sp_decode(q, [c["k"][i] for c in pieces],
                         [c["v"][i] for c in pieces], pos)

    return attn
