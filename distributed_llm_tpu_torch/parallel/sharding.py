"""Tensor-parallel split of the weights and of the KV.

Counterpart of ``distributed_llm_tpu/parallel/sharding.py``'s Megatron
rules.  JAX writes them as ``PartitionSpec``s and lets GSPMD place the
pieces and insert the all-reduces; the port cuts the pieces itself:
``shard_params`` turns one ``Transformer`` (random, converted from a JAX
tree by ``models/convert.params_from_jax``, or loaded from a checkpoint,
plain or int8) into one module per shard on its slot's device:

- ``wq``/``wk``/``wv``/``w_gate``/``w_up`` split by columns (whole
  heads; the FFN's columns), column parallel;
- ``wo``/``w_down`` split by rows, row parallel: each shard's product is
  a partial sum that ``collectives.allreduce_sum`` adds up;
- ``embed`` (also the tied head), the norms and ``final_ln`` replicated:
  shards on one device share the one tensor.

An int8 weight (``ops.quant.QTensor``) is quantized whole first, as JAX
quantizes before it places (``quantized_param_specs``): its scale
shards with the output columns of a column-parallel product and stays
whole beside a row-parallel one.  The KV pool ``[L, N_kv, NB, bs, D]``
and the contiguous cache ``[L, B, S, N_kv, D]`` split on their kv-head
axis (``kv_pool_specs``, ``kv_cache_specs``): one pool or cache per
shard, with its int8 scale planes split the same way.  MoE at tp > 1
waits for expert parallelism (ROADMAP A10b).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import quant
from .mesh import DeviceGroup

# Axis each leaf splits on in the port's per-layer [in, out] layout, the
# JAX ``param_specs`` with the stacked layer axis dropped: 1 = columns
# (column parallel), 0 = rows (row parallel), None = replicated.
LAYER_SPLIT: Dict[str, Optional[int]] = {
    "ln1": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0, "ln2": None,
    "w_gate": 1, "w_up": 1, "w_down": 0,
}


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """``ValueError`` unless ``tp`` divides the q and kv head counts and
    the FFN width (JAX's ``param_shardings`` check); MoE at tp > 1 is
    ``NotImplementedError``."""
    if tp > 1 and cfg.num_experts > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE at tp={tp} needs expert parallelism, not "
            "ported to the PyTorch/CUDA package yet (ROADMAP.md A10b)")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.ffn_size % tp:
        raise ValueError(
            f"tp={tp} must divide heads ({cfg.num_heads}/"
            f"{cfg.num_kv_heads}) and ffn_size {cfg.ffn_size} for "
            f"{cfg.name}")


class ShardedModel:
    """A model split over a device group: ``shards[s]`` is shard ``s``'s
    module (a ``Transformer`` holding its pieces) on
    ``group.devices[s]``.  Each shard owns ``heads = (N_q / tp,
    N_kv / tp)`` of the attention heads and ``ffn_size / tp`` FFN
    columns.  ``embed`` and ``final_ln`` are the first shard's
    (replicated), so the model's embedding and tied head run once."""

    def __init__(self, cfg: ModelConfig, shards: List[nn.Module],
                 group: DeviceGroup):
        self.cfg = cfg
        self.shards = list(shards)
        self.group = group
        self.tp = len(self.shards)
        self.heads = (cfg.num_heads // self.tp, cfg.num_kv_heads // self.tp)

    @property
    def embed(self):
        return self.shards[0].embed

    @property
    def final_ln(self):
        return self.shards[0].final_ln


def is_sharded(model: Any) -> bool:
    return isinstance(model, ShardedModel)


def _empty(cls) -> nn.Module:
    """An instance of module class ``cls`` with nothing registered: its
    leaves are set one by one."""
    module = cls.__new__(cls)
    nn.Module.__init__(module)
    return module


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that owns its storage."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _replicate(w: Any, device: torch.device) -> Any:
    """A replicated leaf on ``device``: the leaf itself where it already
    lies there (shards on one device share it), else a copy."""
    if quant.is_quantized(w):
        if w.q.device == device:
            return w
        return quant.QTensor(w.q.to(device), w.s.to(device))
    if w.device == device:
        return w
    return nn.Parameter(w.detach().to(device), requires_grad=False)


def _split(w: Any, axis: int, s: int, tp: int, device: torch.device) -> Any:
    """Shard ``s`` of ``tp`` of leaf ``w`` along ``axis``, on ``device``.
    An int8 leaf's scale ``[1, N]`` splits with the columns and stays
    whole beside a row split."""
    def piece(t: torch.Tensor, ax: int) -> torch.Tensor:
        n = t.shape[ax] // tp
        return _copy_to(t.narrow(ax, s * n, n), device)

    if quant.is_quantized(w):
        scale = piece(w.s, 1) if axis == 1 else _copy_to(w.s, device)
        return quant.QTensor(piece(w.q, axis), scale)
    return nn.Parameter(piece(w.detach(), axis), requires_grad=False)


@torch.no_grad()
def shard_params(model: nn.Module, group: DeviceGroup) -> ShardedModel:
    """One ``Transformer`` (plain or int8, on any device) -> its
    ``ShardedModel`` over ``group``'s ``tp`` axis, each shard's pieces
    copied onto its slot's device (``LAYER_SPLIT``)."""
    from ..models.transformer import Transformer
    cfg = model.cfg
    tp = group.tp
    check_tp(cfg, tp)
    shards = []
    for s, dev in enumerate(group.devices[:tp]):
        shard = _empty(Transformer)
        shard.cfg = cfg
        shard.embed = _replicate(model.embed, dev)
        layers = []
        for lp in model.layers:
            layer = _empty(type(lp))
            for key, axis in LAYER_SPLIT.items():
                w = getattr(lp, key)
                setattr(layer, key, _replicate(w, dev) if axis is None
                        else _split(w, axis, s, tp, dev))
            layers.append(layer)
        shard.layers = nn.ModuleList(layers)
        shard.final_ln = _replicate(model.final_ln, dev)
        shards.append(shard)
    return ShardedModel(cfg, shards, group)


def kv_pool_shards(cfg: ModelConfig, pcfg, kv_quantize: str,
                   group: DeviceGroup) -> List[Dict[str, torch.Tensor]]:
    """The paged pool split on its kv-head axis: one ``[L, N_kv / tp,
    NB, bs, D]`` pool per shard (int8: scale planes ``[L, N_kv / tp,
    NB, bs]``), each on its slot's device (``kv_pool_specs``)."""
    from ..engine.paged_kv import init_pool
    tp = group.tp
    return [init_pool(cfg, pcfg, kv_quantize, device=dev,
                      kv_heads=cfg.num_kv_heads // tp)
            for dev in group.devices[:tp]]


def kv_cache_shards(cfg: ModelConfig, batch: int, max_seq: int,
                    kv_quantize: str, group: DeviceGroup
                    ) -> List[Dict[str, torch.Tensor]]:
    """The contiguous cache split on its kv-head axis: one ``[L, B, S,
    N_kv / tp, D]`` cache per shard (``kv_cache_specs``)."""
    from ..models.transformer import init_kv_cache
    tp = group.tp
    return [init_kv_cache(cfg, batch, max_seq, kv_quantize, dev,
                          kv_heads=cfg.num_kv_heads // tp)
            for dev in group.devices[:tp]]
