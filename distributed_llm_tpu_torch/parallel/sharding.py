"""Tensor- and expert-parallel split of the weights, and the KV's split.

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
  shards on one device share the one tensor;
- a MoE layer's stacked experts ``[E, H, F]`` / ``[E, F, H]`` split E
  over ``ep`` and F over ``tp`` (``EXPERT_SPLIT``, JAX's ``param_specs``
  ``P(None, 'ep', None, 'tp')`` / ``P(None, 'ep', 'tp', None)``): tensor
  shard ``t`` holds one ``models/moe.ExpertSlice`` per ``ep`` slot, on
  that slot's device; the router stays replicated.

An int8 weight (``ops.quant.QTensor``) is quantized whole first, as JAX
quantizes before it places (``quantized_param_specs``): its scale
shards with the output columns of a column-parallel product and stays
whole beside a row-parallel one.  The KV pool ``[L, N_kv, NB, bs, D]``
and the contiguous cache ``[L, B, S, N_kv, D]`` split on their kv-head
axis (``kv_pool_specs``, ``kv_cache_specs``): one pool or cache per
shard, with its int8 scale planes split the same way.  On an ``sp``
group the contiguous cache splits its sequence too (``kv_cache_specs``'
``sp_axis``): tensor shard ``t``'s cache is then a list of ``sp``
pieces ``[L, B, S / sp, N_kv / tp, D]``, piece ``r`` on slot ``(r, t)``.

The attention and the dense FFN run on the tensor shards, the slots of
the group's first row; an ``sp`` row's slots hold its cache pieces and
its ring blocks, an ``ep`` row's slots their experts.  A piece on the
device its leaf lies on is a view of the leaf, no copy, where it is the
whole leaf (tp = 1), or where it is a contiguous run (a row split, a
block of experts) and every slot that takes a piece of the leaf lies on
that device too (the group repeats one card: the views together are the
one copy).  Elsewhere it is a copy, so that the lead's piece does not
keep the whole leaf alive beside the other cards' pieces.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

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

# A MoE layer's leaves: the attention's as ``LAYER_SPLIT``, the router
# replicated, and the stacked experts' F axis in each [E, in, out] stack
# (split over tp; E splits over ep).
MOE_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
EXPERT_SPLIT: Dict[str, int] = {"w_gate": 2, "w_up": 2, "w_down": 1}


def check_tp(cfg: ModelConfig, tp: int, ep: int = 1) -> None:
    """``ValueError`` unless ``tp`` divides the q and kv head counts and
    the FFN width (JAX's ``param_shardings`` check), and ``ep`` the
    expert count."""
    if ep > 1 and cfg.num_experts % ep:
        raise ValueError(f"ep={ep} must divide the {cfg.num_experts} "
                         f"experts of {cfg.name}")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.ffn_size % tp:
        raise ValueError(
            f"tp={tp} must divide heads ({cfg.num_heads}/"
            f"{cfg.num_kv_heads}) and ffn_size {cfg.ffn_size} for "
            f"{cfg.name}")


class ShardedModel:
    """A model split over a device group: ``shards[s]`` is tensor shard
    ``s``'s module (a ``Transformer`` holding its pieces) on
    ``group.devices[s]``.  Each shard owns ``heads = (N_q / tp,
    N_kv / tp)`` of the attention heads and ``ffn_size / tp`` FFN
    columns (a MoE shard: its expert slices).  ``embed`` and
    ``final_ln`` are the first shard's (replicated), so the model's
    embedding and tied head run once.  A group of tp = 1 (sp or ep > 1)
    has one shard."""

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


def _home(w: Any) -> torch.device:
    """The device leaf ``w`` (plain or int8) lies on."""
    return w.q.device if quant.is_quantized(w) else w.device


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


Cut = Tuple[int, int, int]      # (axis, index, parts)


def _piece(t: torch.Tensor, cuts: List[Cut], device: torch.device,
           share: bool) -> torch.Tensor:
    """The block of ``t`` that ``cuts`` pick (part ``index`` of ``parts``
    along each ``axis``), on ``device``: a view where ``t`` lies there,
    the block is contiguous, and it is the whole of ``t`` or ``share``
    holds (every slot taking a block of ``t`` lies on its device); else
    a copy that owns its storage."""
    part = t
    for ax, s, parts in cuts:
        n = t.shape[ax] // parts
        part = part.narrow(ax, s * n, n)
    if (t.device == device and part.is_contiguous()
            and (share or part.numel() == t.numel())):
        return part
    return _copy_to(part, device)


def _split(w: Any, cuts: List[Cut], device: torch.device, share: bool,
           scale_cuts: Optional[List[Cut]] = None) -> Any:
    """The block ``cuts`` pick of leaf ``w``, on ``device`` (``_piece``).
    An int8 leaf's scale (``[1, N]``, an expert stack's ``[E, 1, N]``)
    takes ``scale_cuts`` (default: the cuts on the columns, so it stays
    whole beside a row split)."""
    if quant.is_quantized(w):
        if scale_cuts is None:
            scale_cuts = [c for c in cuts if c[0] == w.q.dim() - 1]
        return quant.QTensor(_piece(w.q, cuts, device, share),
                             _piece(w.s, scale_cuts, device, share))
    return nn.Parameter(_piece(w.detach(), cuts, device, share),
                        requires_grad=False)


def _shared(w: Any, devices) -> bool:
    """Whether every one of ``devices`` is the one leaf ``w`` lies on."""
    return all(d == _home(w) for d in devices)


def _expert_slice(lp: nn.Module, e: int, ep: int, t: int, tp: int,
                  group: DeviceGroup, experts: int):
    """Slot ``(e, t)``'s experts: the ``e``-th block of E / ep experts,
    the ``t``-th block of F / tp columns of each (``EXPERT_SPLIT``; an
    int8 stack's scale ``[E, 1, out]`` splits with the experts, and with
    the F columns of ``w_gate``/``w_up``)."""
    from ..models.moe import ExpertSlice
    slot = e * tp + t
    device = group.devices[slot]
    ws = {}
    for key, f_axis in EXPERT_SPLIT.items():
        w = getattr(lp, key)
        cuts = [(0, e, ep), (f_axis, t, tp)]
        ws[key] = _split(w, cuts, device,
                         _shared(w, group.devices[:ep * tp]),
                         scale_cuts=[c for c in cuts if c[0] != 1])
    return ExpertSlice(first=e * (experts // ep), slot=slot, device=device,
                       **ws)


@torch.no_grad()
def shard_params(model: nn.Module, group: DeviceGroup) -> ShardedModel:
    """One ``Transformer`` (plain or int8, on any device) -> its
    ``ShardedModel`` over ``group``: tensor shard ``t`` on slot ``t``
    (``LAYER_SPLIT``), a MoE layer's experts split over the group's
    ``ep`` slots and ``tp`` columns (``EXPERT_SPLIT``)."""
    from ..models.transformer import Transformer
    cfg = model.cfg
    tp, ep = group.tp, group.ep
    check_tp(cfg, tp, ep)
    moe = cfg.num_experts > 1
    shards = []
    for s, dev in enumerate(group.devices[:tp]):
        shard = _empty(Transformer)
        shard.cfg = cfg
        shard.embed = _replicate(model.embed, dev)
        layers = []
        for lp in model.layers:
            layer = _empty(type(lp))
            for key, axis in LAYER_SPLIT.items():
                if moe and key not in MOE_LAYER_KEYS:
                    continue
                w = getattr(lp, key)
                setattr(layer, key, _replicate(w, dev) if axis is None
                        else _split(w, [(axis, s, tp)], dev,
                                    _shared(w, group.devices[:tp])))
            if moe:
                layer.w_router = _replicate(lp.w_router, dev)
                layer.slices = [_expert_slice(lp, e, ep, s, tp, group,
                                              cfg.num_experts)
                                for e in range(ep)]
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
                    kv_quantize: str, group: DeviceGroup,
                    sequence: bool = False
                    ) -> List[Union[Dict[str, torch.Tensor], List]]:
    """The contiguous cache split on its kv-head axis: one ``[L, B, S,
    N_kv / tp, D]`` cache per tensor shard (``kv_cache_specs``).  With
    ``sequence`` (an sp group, a bf16 cache whose length ``sp``
    divides) each shard's cache is a list of ``sp`` pieces of S / sp
    positions, piece ``r`` on slot ``(r, t)`` (``sp_axis``)."""
    from ..models.transformer import init_kv_cache
    tp, sp = group.tp, group.sp
    heads = cfg.num_kv_heads // tp
    if not sequence:
        return [init_kv_cache(cfg, batch, max_seq, kv_quantize, dev,
                              kv_heads=heads)
                for dev in group.devices[:tp]]
    if max_seq % sp:
        raise ValueError(f"sp={sp} does not divide the cache length "
                         f"{max_seq}")
    return [[init_kv_cache(cfg, batch, max_seq // sp, kv_quantize, dev,
                           kv_heads=heads) for dev in group.column(t)]
            for t in range(tp)]
