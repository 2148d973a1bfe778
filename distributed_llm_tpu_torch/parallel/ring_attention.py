"""Ring attention: exact causal attention over a sequence split on 'sp'.

Counterpart of ``distributed_llm_tpu/parallel/ring_attention.py``.  A
long prompt's q/k/v are split along the sequence into one block per
slot of the group's 'sp' axis; every slot keeps its query block while
the K/V blocks travel round the ring (``collectives.rotate``, JAX's
``ppermute``), and each slot folds every block into a flash-style
streaming softmax (running max, normalizer, accumulator), so the S x S
score matrix never exists whole.  After ``i`` rotations slot ``my``
holds block ``src = (my - i) mod n``, JAX's order; the causal mask is
set per block pair with the finite ``NEG_INF`` sentinel and re-applied
after the shift, so a fully masked block adds exactly zero; the last
block is folded in after the loop (no wasted last rotation).  Which
blocks a causal mask covers wholly is known on the host (``src`` and
``my`` are the loop's own numbers): a block after the query block
(``src > my``) would add exactly zero and is skipped, and one before it
(``src < my``) needs no mask; only the diagonal block is masked.  The
result is bit for bit JAX's fold, with about half the blocks.

JAX computes this in XLA with no Pallas kernel, so it is plain PyTorch
here, in float32 as JAX's is.  One process drives every slot: the ring's
steps run slot after slot, each block on its slot's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops.attention import NEG_INF, _expand_kv
from .collectives import rotate
from .mesh import DeviceGroup


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: DeviceGroup, axis_name: str = "sp",
                   causal: bool = True,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """q [B, S, N_q, D], k/v [B, S, N_kv, D] -> [B, S, N_q, D] on q's
    device, S split over the group's ``axis_name`` slots.  ``head_axis``
    names a second axis splitting the heads (an ('sp', 'tp') group): each
    tensor shard's ring keeps only its own heads.  Omitted, the heads
    stay whole and the ring runs over the first column."""
    tp = group.shape[head_axis] if head_axis else 1
    nq, nkv = q.shape[2] // tp, k.shape[2] // tp
    outs = [ring(q.narrow(2, t * nq, nq), k.narrow(2, t * nkv, nkv),
                 v.narrow(2, t * nkv, nkv), group.column(t), causal)
            for t in range(tp)]
    return torch.cat(outs, dim=2) if tp > 1 else outs[0]


def ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         devices: Sequence[torch.device], causal: bool = True
         ) -> torch.Tensor:
    """The ring over ``devices`` (one block of S / n positions each) of
    one head shard: q [B, S, N_q, D], k/v [B, S, N_kv, D] -> [B, S, N_q,
    D] in q's dtype on q's device."""
    n = len(devices)
    s_local = q.shape[1] // n
    if s_local * n != q.shape[1]:
        raise ValueError(f"ring: {n} slots do not divide the sequence "
                         f"{q.shape[1]}")

    def block(x: torch.Tensor, r: int) -> torch.Tensor:
        return rotate(x.narrow(1, r * s_local, s_local), devices[r])

    qs = [block(q, r) for r in range(n)]
    ks = [block(k, r) for r in range(n)]
    vs = [block(v, r) for r in range(n)]
    outs = _ring_block(qs, ks, vs, devices, causal=causal)
    return torch.cat([rotate(o, q.device) for o in outs], dim=1)


def _ring_block(qs: List[torch.Tensor], ks: List[torch.Tensor],
                vs: List[torch.Tensor], devices: Sequence[torch.device],
                causal: bool) -> List[torch.Tensor]:
    """Every slot's body, step by step: slot ``my`` streams every K/V
    block past its query block ``qs[my]``.  Returns each slot's output
    block on its device."""
    n = len(devices)
    b, s_local, n_q, d = qs[0].shape
    groups = n_q // ks[0].shape[2]
    scale = d ** -0.5
    local_pos = torch.arange(s_local, device=qs[0].device)
    state = []
    for my in range(n):
        dev = devices[my]
        state.append([
            torch.full((b, n_q, s_local), NEG_INF, dtype=torch.float32,
                       device=dev),                         # running max
            torch.zeros((b, n_q, s_local), dtype=torch.float32, device=dev),
            torch.zeros((b, s_local, n_q, d), dtype=torch.float32,
                        device=dev)])

    def accumulate(i: int, my: int, k_blk: torch.Tensor,
                   v_blk: torch.Tensor) -> None:
        """Fold the block slot ``my`` holds after ``i`` rotations."""
        m, l, acc = state[my]
        src = (my - i) % n
        if causal and src > my:
            return                          # wholly masked: adds zero
        diagonal = causal and src == my
        qf = qs[my].float()
        kf = _expand_kv(k_blk, groups).float()
        logits = torch.einsum("bqnd,bknd->bnqk", qf, kf) * scale
        if diagonal:
            pos = rotate(local_pos, qf.device)
            mask = (my * s_local + pos)[:, None] >= (src * s_local + pos)[None]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        blk_max = logits.max(dim=-1).values                  # [b, n, sq]
        new_m = torch.maximum(m, blk_max)
        # Re-mask after the shift so a masked entry adds zero (the finite
        # NEG_INF keeps exp() defined).
        p_ij = torch.exp(logits - new_m[..., None])
        if diagonal:
            p_ij = torch.where(mask[None, None], p_ij, 0.0)
        correction = torch.exp(m - new_m)
        l = l * correction + p_ij.sum(dim=-1)
        acc = (acc * correction.transpose(1, 2)[..., None]
               + torch.einsum("bnqk,bknd->bqnd", p_ij,
                              _expand_kv(v_blk, groups).float()))
        state[my] = [new_m, l, acc]

    for i in range(n - 1):
        for my in range(n):
            accumulate(i, my, ks[my], vs[my])
        # Each slot hands its block to the next (JAX's perm j -> j + 1).
        ks = [rotate(ks[(my - 1) % n], devices[my]) for my in range(n)]
        vs = [rotate(vs[(my - 1) % n], devices[my]) for my in range(n)]
    for my in range(n):
        accumulate(n - 1, my, ks[my], vs[my])
    outs = []
    for my in range(n):
        _, l, acc = state[my]
        denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        outs.append((acc / denom).to(qs[my].dtype))
    return outs
