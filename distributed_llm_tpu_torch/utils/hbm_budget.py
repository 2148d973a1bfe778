"""Serving memory budget: does a tier's model + KV fit its device?

Counterpart of ``distributed_llm_tpu/utils/hbm_budget.py``.  The JAX
package budgets a tier with ``jax.eval_shape`` over its real code paths;
the port builds the same objects its engines build on the ``meta``
device (``models.transformer.Transformer``, a MoE model's E experts a
layer included, quantized by
``ops.quant.maybe_quantize`` when the tier serves int8 weights, the
paged pool's ``init_pool``, the contiguous cache's ``init_kv_cache``),
so their
shapes and dtypes are the engine's own and nothing is allocated: an 8B
budget runs on the CPU.  A parallel tier is budgeted per slot, as JAX
budgets per chip over ``chips = tp x max(sp, ep)``: the split weights
(``parallel/sharding.LAYER_SPLIT``; an int8 weight's scale splits with
its columns and stays whole beside a row split; a MoE stack's experts
divided by ``ep`` and its F columns by ``tp``, ``EXPERT_SPLIT``), the
KV divided by ``tp`` and, for the sequential engine's bf16 cache of a
dense sp tier, by ``sp`` (whose prefix cache is off), the replicated
leaves (embedding, norms, router) counted whole on every slot.  Same
keys, units (GB = 1e9 bytes), rounding and 0.75 GB headroom as the JAX
budget.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable

import torch

# The JAX package's default (its bench chip); a deployment passes its own.
DEFAULT_HBM_PER_CHIP_GB = 16.0

# Headroom for activations, graph memory pools and allocator slack.
HEADROOM_GB = 0.75


def tensor_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of ``tensors`` (shape times element size; meta tensors
    count what they would hold)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def model_bytes(model: torch.nn.Module) -> int:
    """Bytes of a model's weights: its parameters and its buffers (the
    int8 ``q`` and the scales of a quantized model)."""
    return tensor_bytes(itertools.chain(model.parameters(), model.buffers()))


def shard_bytes(model: torch.nn.Module, tp: int, ep: int = 1) -> int:
    """Bytes one slot of a ``tp`` x ``ep`` split of a model holds
    (``parallel/sharding.shard_params``'s pieces, counted from shapes)."""
    from ..ops import quant
    from ..parallel.sharding import EXPERT_SPLIT, LAYER_SPLIT, MOE_LAYER_KEYS
    if tp == 1 and ep == 1:
        return model_bytes(model)

    def leaf(w, axis, q_parts: int = tp, s_parts: int = 1) -> int:
        if quant.is_quantized(w):
            q = tensor_bytes([w.q])
            s = tensor_bytes([w.s])
            if axis is None:
                return q + s
            return q // q_parts + (s // q_parts if axis == w.q.dim() - 1
                                   else s // s_parts)
        b = tensor_bytes([w])
        return b if axis is None else b // q_parts

    total = leaf(model.embed, None) + leaf(model.final_ln, None)
    for layer in model.layers:
        if model.cfg.num_experts == 1:
            total += sum(leaf(getattr(layer, k), a)
                         for k, a in LAYER_SPLIT.items())
            continue
        total += sum(leaf(getattr(layer, k), LAYER_SPLIT[k])
                     for k in MOE_LAYER_KEYS)
        total += leaf(layer.w_router, None)
        # Experts over ep and F over tp; an int8 stack's scale splits
        # with the experts, and with F where F is its output axis.
        total += sum(leaf(getattr(layer, k), f, tp * ep, ep)
                     for k, f in EXPERT_SPLIT.items())
    return total


def tier_hbm_budget(tier, hbm_per_chip_gb: float = DEFAULT_HBM_PER_CHIP_GB,
                    mesh=None, devices=None) -> Dict[str, Any]:
    """Budget ``tier`` against each device of its group: ``mesh`` (the
    tier's deployed ``parallel/mesh.DeviceGroup``) gives its tp, sp and
    ep, else the tier's own ``tp`` and ``sp`` and the ``ep`` the carve
    would fit on ``devices`` (default: every card, or one CPU on a
    machine without one), as JAX's budget reads them.

    Returns {tier, model, chips, quantize, params_gb_per_chip,
    kv_gb_per_chip, total_gb_per_chip, hbm_per_chip_gb, fits,
    headroom_gb} (the JAX budget's keys), and the unrounded
    ``params_bytes`` and ``kv_bytes`` beside them: the weights as the
    engine builds them (int8 ``q`` plus scales under ``quantize="int8"``),
    and the KV the tier's engine would allocate — the batched engine's paged pool, or the
    sequential engine's contiguous cache plus one parked cache per prefix
    cache entry."""
    from ..engine.paged_kv import PagedConfig, init_pool
    from ..models import transformer
    from ..ops import quant
    from ..parallel.mesh import _fit_ep
    from ..parallel.sharding import check_tp

    tier.check_ported()
    cfg = tier.model()
    if mesh is not None:
        tp, sp, ep = mesh.tp, mesh.sp, mesh.ep
    else:
        tp, sp = max(1, tier.tp), max(1, tier.sp)
        # The degree the carve would deploy: ep divides the expert count
        # and fits the devices.
        n = (len(devices) if devices is not None
             else max(1, torch.cuda.device_count()))
        ep = _fit_ep(tier, n, tp)
    chips = tp * max(sp, ep)
    check_tp(cfg, tp, ep)
    meta = torch.device("meta")
    params_bytes = shard_bytes(quant.maybe_quantize(
        transformer.Transformer(cfg, device=meta), tier, cfg), tp, ep)
    if tier.decode_batch > 1:
        pcfg = PagedConfig(block_size=tier.kv_block_size,
                           max_slots=tier.decode_batch,
                           max_seq_len=cfg.max_seq_len)
        kv_bytes = tensor_bytes(init_pool(cfg, pcfg, tier.kv_quantize,
                                          device=meta).values()) // tp
        parked = 0         # parked prefixes hold blocks inside the pool
    else:
        # The sequential engine keeps a MoE model's cache bf16.
        kvq = tier.kv_quantize if cfg.num_experts == 1 else "none"
        cache = transformer.init_kv_cache(cfg, 1, cfg.max_seq_len, kvq,
                                          device=meta)
        # The cache's sequence splits over sp for a dense bf16 cache,
        # whose engine then parks no prefixes.
        sp_div = sp if sp > 1 and cfg.num_experts == 1 and kvq == "none" \
            else 1
        kv_bytes = tensor_bytes(cache.values()) // tp // sp_div
        parked = (kv_bytes * tier.prefix_cache_entries
                  if tier.enable_prefix_cache and sp_div == 1 else 0)
    params_gb, kv_gb = params_bytes / 1e9, (kv_bytes + parked) / 1e9
    total = params_gb + kv_gb
    return {
        "tier": tier.name,
        "model": cfg.name,
        "chips": chips,
        "quantize": tier.quantize,
        "params_gb_per_chip": round(params_gb, 3),
        "kv_gb_per_chip": round(kv_gb, 3),
        "total_gb_per_chip": round(total, 3),
        "hbm_per_chip_gb": hbm_per_chip_gb,
        "fits": total <= hbm_per_chip_gb - HEADROOM_GB,
        "headroom_gb": round(hbm_per_chip_gb - total, 3),
        "params_bytes": params_bytes,
        "kv_bytes": kv_bytes + parked,
    }


def cluster_hbm_budget(cluster, devices=None,
                       hbm_per_chip_gb: float = DEFAULT_HBM_PER_CHIP_GB,
                       device=None) -> Dict[str, Dict[str, Any]]:
    """Budget every local tier of ``cluster`` against the group
    ``parallel/mesh.carve_tier_meshes`` hands it from ``devices`` (a later
    tier may get a smaller tp than it asks for); remote tiers
    (``endpoint``) are skipped, their devices being elsewhere.  With no
    ``devices`` and no ``device``, the process's devices: every card, or
    the CPU on a machine without one (a budget allocates nothing)."""
    from ..parallel.mesh import carve_tier_meshes
    if devices is None and device is None and not torch.cuda.is_available():
        device = "cpu"
    meshes = carve_tier_meshes(cluster, devices=devices, device=device)
    return {tier.name: tier_hbm_budget(tier, hbm_per_chip_gb=hbm_per_chip_gb,
                                       mesh=meshes[tier.name])
            for tier in cluster.tiers() if not tier.endpoint}
