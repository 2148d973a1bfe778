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
budget runs on the CPU.  One device per tier (``tp=1``); the sharded
budgets wait for tensor parallelism (``TierConfig.check_ported`` refuses
``tp > 1``).  Same keys, units (GB = 1e9 bytes), rounding and 0.75 GB
headroom as the JAX budget.
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


def tier_hbm_budget(tier, hbm_per_chip_gb: float = DEFAULT_HBM_PER_CHIP_GB
                    ) -> Dict[str, Any]:
    """Budget ``tier`` against one device of ``hbm_per_chip_gb``.

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

    tier.check_ported()
    cfg = tier.model()
    meta = torch.device("meta")
    params_bytes = model_bytes(quant.maybe_quantize(
        transformer.Transformer(cfg, device=meta), tier, cfg))
    if tier.decode_batch > 1:
        pcfg = PagedConfig(block_size=tier.kv_block_size,
                           max_slots=tier.decode_batch,
                           max_seq_len=cfg.max_seq_len)
        kv_bytes = tensor_bytes(init_pool(cfg, pcfg, tier.kv_quantize,
                                          device=meta).values())
        parked = 0         # parked prefixes hold blocks inside the pool
    else:
        # The sequential engine keeps a MoE model's cache bf16.
        kvq = tier.kv_quantize if cfg.num_experts == 1 else "none"
        cache = transformer.init_kv_cache(cfg, 1, cfg.max_seq_len, kvq,
                                          device=meta)
        kv_bytes = tensor_bytes(cache.values())
        parked = (kv_bytes * tier.prefix_cache_entries
                  if tier.enable_prefix_cache else 0)
    params_gb, kv_gb = params_bytes / 1e9, (kv_bytes + parked) / 1e9
    total = params_gb + kv_gb
    return {
        "tier": tier.name,
        "model": cfg.name,
        "chips": 1,
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


def cluster_hbm_budget(cluster,
                       hbm_per_chip_gb: float = DEFAULT_HBM_PER_CHIP_GB
                       ) -> Dict[str, Dict[str, Any]]:
    """Budget every tier of ``cluster``, each against its own device (the
    port serves each tier on one card; remote tiers are not ported)."""
    return {tier.name: tier_hbm_budget(tier, hbm_per_chip_gb=hbm_per_chip_gb)
            for tier in cluster.tiers()}
