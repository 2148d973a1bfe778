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

Training places the weights by JAX's ``train_param_specs``, FSDP x TP
(x EP): a weight's Megatron dimension over ``tp``, its other matmul
dimension over ``dp`` (ZeRO-3), an expert stack's E over ``ep``,
``embed``'s rows over ``dp``, the norms whole.  ``train_specs`` applies
JAX's fallback (an axis the group lacks, one already used in the spec,
or one that does not divide the dimension leaves it whole), and
``place_for_training`` cuts each leaf into its pieces: one trainable
``nn.Parameter`` per block of the spec's axes, on the first slot with
those coordinates (the others on that axis use it; JAX keeps a copy on
each).  Every element of every leaf belongs to exactly one piece, so
each slot's AdamW state is that of its own pieces.  ``TrainPlacement.
use`` gathers the pieces a slot computes with (its own block on every
axis but ``dp``, whole over ``dp``) through ``collectives.all_gather``,
and ``whole_state``/``load_whole`` move whole leaves in and out, so a
checkpoint does not depend on the group.  On one slot the pieces are
the model's own parameters.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import quant
from .collectives import all_gather
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


# -- training placement -----------------------------------------------------------

Spec = Tuple[Optional[str], ...]

# JAX's ``train_param_specs`` on the port's per-layer leaves (the stacked
# layer axis dropped): the axis each dimension splits over.
TRAIN_LAYER_SPECS: Dict[str, Spec] = {
    "ln1": (None,), "wq": ("dp", "tp"), "wk": ("dp", "tp"),
    "wv": ("dp", "tp"), "wo": ("tp", "dp"), "ln2": (None,),
    "w_gate": ("dp", "tp"), "w_up": ("dp", "tp"), "w_down": ("tp", "dp"),
}
TRAIN_MOE_SPECS: Dict[str, Spec] = {
    "w_router": ("dp", None), "w_gate": ("ep", "dp", "tp"),
    "w_up": ("ep", "dp", "tp"), "w_down": ("ep", "tp", "dp"),
}


def train_param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every leaf's spec by its ``state_dict`` name, before the fallback."""
    layer = dict(TRAIN_LAYER_SPECS)
    if cfg.num_experts > 1:
        layer.update(TRAIN_MOE_SPECS)
    specs: Dict[str, Spec] = {"embed": ("dp", None)}
    for i in range(cfg.num_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    specs["final_ln"] = (None,)
    return specs


def _fallback(spec: Spec, shape, group: DeviceGroup) -> Spec:
    """JAX's ``_shardings_with_fallback`` for one leaf."""
    fixed, used = [], set()
    for ax, n in zip(spec, shape):
        if ax is None or ax in used or ax not in group.shape or (
                n % group.shape[ax]):
            fixed.append(None)
        else:
            fixed.append(ax)
            used.add(ax)
    return tuple(fixed)


def train_specs(model: nn.Module, group: DeviceGroup) -> Dict[str, Spec]:
    """Every leaf's spec on ``group`` after the fallback, in the model's
    ``state_dict`` order."""
    specs = train_param_specs(model.cfg)
    return {name: _fallback(specs[name], t.shape, group)
            for name, t in model.state_dict().items()}


Key = Tuple[int, ...]


@dataclasses.dataclass
class TrainLeaf:
    """A leaf of a placed model: its spec on the group and its pieces,
    keyed by their coordinates on the spec's axes (in spec order)."""
    spec: Spec
    pieces: Dict[Key, nn.Parameter]

    @property
    def axes(self) -> List[Tuple[int, str]]:
        return [(dim, ax) for dim, ax in enumerate(self.spec) if ax]


class TrainPlacement:
    """A model's leaves cut into pieces over a training group
    (``place_for_training``).  ``model`` is the placed ``Transformer``
    itself on one slot (its parameters are the pieces), else None."""

    def __init__(self, cfg: ModelConfig, group: DeviceGroup,
                 leaves: Dict[str, TrainLeaf],
                 model: Optional[nn.Module] = None):
        self.cfg = cfg
        self.group = group
        self.leaves = leaves
        self.model = model

    def parameters(self) -> List[nn.Parameter]:
        """Every piece once, leaf after leaf."""
        return [p for leaf in self.leaves.values()
                for p in leaf.pieces.values()]

    def home(self, name: str, key: Key) -> int:
        """The slot piece ``key`` of leaf ``name`` lives on."""
        leaf = self.leaves[name]
        return self.group.index(**{ax: c for (_, ax), c in
                                   zip(leaf.axes, key)})

    def use(self, name: str, coords: Dict[str, int],
            devices: Sequence[torch.device]) -> List[torch.Tensor]:
        """What a slot at ``coords`` computes with of leaf ``name``: its
        own block on every spec axis but ``dp``, whole over ``dp``, one
        differentiable tensor on each of ``devices``
        (``collectives.all_gather``)."""
        leaf = self.leaves[name]
        dp_dim = next((d for d, ax in leaf.axes if ax == "dp"), 0)
        pieces = [p for key, p in sorted(leaf.pieces.items())
                  if all(ax == "dp" or c == coords.get(ax, 0)
                         for (_, ax), c in zip(leaf.axes, key))]
        return all_gather(pieces, dp_dim, devices)

    def whole(self, name: str, blocks: Dict[Key, torch.Tensor],
              device="cpu") -> torch.Tensor:
        """Leaf ``name`` whole on ``device`` from one block per piece
        (the pieces themselves, or their AdamW moments)."""
        axes = self.leaves[name].axes
        grid = {k: v.detach().to(device) for k, v in blocks.items()}
        # Concatenate the last spec axis first: its blocks share the key's
        # prefix and sort by their own coordinate.
        for i, (dim, _) in reversed(list(enumerate(axes))):
            merged: Dict[Key, List[torch.Tensor]] = {}
            for key in sorted(grid):
                merged.setdefault(key[:i], []).append(grid[key])
            grid = {k: torch.cat(v, dim) for k, v in merged.items()}
        # ``cat`` copies; a leaf split on no axis is its one block itself.
        return grid[()] if axes else grid[()].clone()

    def split(self, name: str, whole: torch.Tensor) -> Dict[Key, torch.Tensor]:
        """Leaf ``name``'s whole tensor cut into its pieces' blocks (views),
        by their keys."""
        axes, sizes = self.leaves[name].axes, self.group.shape
        out = {}
        for key in itertools.product(*(range(sizes[ax]) for _, ax in axes)):
            block = whole
            for (dim, ax), c in zip(axes, key):
                n = whole.shape[dim] // sizes[ax]
                block = block.narrow(dim, c * n, n)
            out[key] = block
        return out

    def whole_state(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The model's ``state_dict``, every leaf whole, on ``device``."""
        return {name: self.whole(name, leaf.pieces, device)
                for name, leaf in self.leaves.items()}

    @torch.no_grad()
    def load_whole(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy whole leaves (a ``state_dict``) into the pieces."""
        for name, leaf in self.leaves.items():
            for key, block in self.split(name, state[name]).items():
                leaf.pieces[key].copy_(block)


@torch.no_grad()
def place_for_training(model: nn.Module, group: DeviceGroup
                       ) -> TrainPlacement:
    """``model`` (a plain ``Transformer``) cut into trainable pieces over
    ``group`` by ``train_specs``: each piece a copy of its block on its
    home slot's device.  A group of one slot takes the model itself, its
    parameters made trainable, as the pieces."""
    specs = train_specs(model, group)
    if group.size == 1:
        model = model.to(group.lead)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        leaves = {name: TrainLeaf(spec, {}) for name, spec in specs.items()}
        for name, leaf in leaves.items():
            leaf.pieces[(0,) * len(leaf.axes)] = params[name]
        return TrainPlacement(model.cfg, group, leaves, model)
    state = model.state_dict()
    placement = TrainPlacement(model.cfg, group, {
        name: TrainLeaf(spec, {}) for name, spec in specs.items()})
    for name, leaf in placement.leaves.items():
        for key, block in placement.split(name, state[name]).items():
            dev = group.devices[placement.home(name, key)]
            leaf.pieces[key] = nn.Parameter(_copy_to(block, dev))
    return placement


@torch.no_grad()
def gather_model(placement: TrainPlacement, device=None) -> nn.Module:
    """The placed model whole again, a ``Transformer`` on ``device``
    (default: the group's lead) holding copies of the leaves, for saving,
    evaluation and serving."""
    from ..models.transformer import Transformer
    model = Transformer(placement.cfg, device="meta")
    model.load_state_dict(placement.whole_state(
        device or placement.group.lead), assign=True)
    model.requires_grad_(False)
    return model
