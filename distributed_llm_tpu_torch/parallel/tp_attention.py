"""Tensor-parallel layers: each shard runs its own heads' attention.

Counterpart of ``distributed_llm_tpu/parallel/tp_attention.py``.  JAX
wraps each attention kernel in ``shard_map`` over the kv-head axis: each
chip's slice of q and of the pool is a complete smaller attention
problem (N_q and N_kv shard by the same factor, so GQA groups stay
whole), the per-shard kernel runs with no collective, and the combine
is a head concat, never a softmax merge.  The port does the same with
no wrapper: a model step's attention is a hook ``attn(lp, h_in, i,
shard)`` (``models/transformer.Shard``) that projects q/k/v with the
shard's weight pieces, writes the shard's own pool or cache and calls
``ops.attention`` on the shard's heads, and that call IS the kernel
launch (every CUDA tensor takes its kernel: K2 prefill, K9/K10
contiguous decode, K7/K8 paged decode, K1/K5 ragged decode, K4/K6
verify, K3/K11/K12 chunks).  ``tp_layers`` drives a step's layers over
the shards: per layer, each shard's attention output times its ``wo``
rows is a partial, the partials are summed (``allreduce_sum``), then
the same for the FFN, so the concat of heads happens inside the
row-parallel product exactly as in JAX's Megatron layout.

The gate of the batched engine's ragged tick is ``_tp_ragged_ok``: a
group without sp whose q and kv head counts both divide by tp.  JAX's
gate also requires tp > 1, no ep and a dense model, because there a
pallas_call inside a GSPMD program has no sharding rule, so a MoE or ep
mesh keeps the dense windowed tick; the port runs every shard's kernel
itself, so its MoE tiers at ep or tp > 1 keep the ragged tick they run
unsharded (the tokens are the same: both ticks attend exactly).  JAX's
``_tp_policy`` adds a dispatch-table verdict per hook, which has no
counterpart here (each CUDA tensor takes its kernel, no env knobs), so
the gate is the whole policy: every step of a sharded model runs per
shard.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..config import ModelConfig
from .collectives import allreduce_sum
from .mesh import DeviceGroup


def _tp_ragged_ok(group: Optional[DeviceGroup], cfg: ModelConfig) -> bool:
    """The gate of the sharded ragged tick: a group without sp whose q
    and kv head counts both divide by its tp."""
    if group is None or group.sp > 1:
        return False
    tp = group.tp
    return not (cfg.num_kv_heads % tp or cfg.num_heads % tp)


def _to(x: Any, device: torch.device) -> Any:
    if isinstance(x, torch.Tensor) and x.device != device:
        return x.to(device, non_blocking=True)
    return x


def _once(fn: Callable, xs: List[torch.Tensor], ws: List[Any]) -> List:
    """``fn(x, w)`` per shard, computed once per distinct (x, w) pair:
    shards on one device share their replicated inputs, and each
    replicated op runs once there."""
    memo: Dict[tuple, Any] = {}
    out = []
    for x, w in zip(xs, ws):
        key = (id(x), id(w))
        if key not in memo:
            memo[key] = fn(x, w)
        out.append(memo[key])
    return out


def tp_layers(cfg: ModelConfig, model, x: torch.Tensor, attn: Callable,
              kv: Any = None, ins: Optional[Dict[str, Any]] = None
              ) -> torch.Tensor:
    """Every layer of ``model`` (a ``ShardedModel``) on the residual
    stream ``x`` (on the lead device): per shard the norm, ``attn`` on
    the shard's heads and its ``wo`` rows, summed over shards into the
    residual, then the norm and the shard's FFN columns and ``w_down``
    rows, summed likewise.  ``kv`` is the per-shard pool or cache list
    and ``ins`` the step's other inputs, each moved onto every shard's
    device (the same tensors where it is the lead's).  Returns the
    residual on the lead device."""
    from ..models.transformer import Shard, kv_shards, rms_norm
    from ..ops import launches, quant
    devs = list(model.group.devices[:model.tp])
    kvs = kv_shards(kv) if kv is not None else [None] * model.tp
    nq, nkv = model.heads
    views = [Shard(s, nq, nkv, kvs[s],
                   {k: _to(v, d) for k, v in (ins or {}).items()})
             for s, d in enumerate(devs)]
    xs = [_to(x, d) for d in devs]
    eps = cfg.norm_eps

    def attn_part(lp, h, i, view):
        with launches.on_shard(view.index):
            return quant.matmul(attn(lp, h, i, view), lp.wo)

    def ffn_part(lp, h, view):
        with launches.on_shard(view.index):
            return lp.ffn(cfg, h)[0]

    for i in range(cfg.num_layers):
        lps = [shard.layers[i] for shard in model.shards]
        hs = _once(lambda a, w: rms_norm(a, w, eps), xs, [lp.ln1 for lp in lps])
        parts = [attn_part(lp, h, i, view)
                 for lp, h, view in zip(lps, hs, views)]
        xs = _once(torch.add, xs, allreduce_sum(parts, devs))
        hs = _once(lambda a, w: rms_norm(a, w, eps), xs, [lp.ln2 for lp in lps])
        parts = [ffn_part(lp, h, view) for lp, h, view in zip(lps, hs, views)]
        xs = _once(torch.add, xs, allreduce_sum(parts, devs))
    return xs[0]
