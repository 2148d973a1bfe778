"""Language-model training on one device or over a training group.

Counterpart of ``distributed_llm_tpu/training/trainer.py``.  A training
step is the JAX step:

- ``lm_loss``: next-token cross-entropy in float32 over the masked
  targets, plus ``moe_aux_weight`` x the MoE load-balance loss, through
  ``transformer.forward`` (the serving prefill's layer body under
  autograd; each layer recomputed in the backward pass with ``remat``,
  the JAX trainer's ``jax.checkpoint``).  On the card its attention is
  K2 (``ops.flash_attention.FlashCausal``), whose backward is autograd
  of the plain causal attention, as JAX's ``custom_vjp`` is.
- the optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
  adamw(warmup_cosine_decay_schedule(0, lr, warmup, horizon, 0.1 lr),
  weight_decay))``: the gradients' global norm in float32, every leaf
  scaled by ``max_norm / norm`` when the norm is at least ``max_norm``
  (optax's rule; no ``+1e-6`` as ``clip_grad_norm_`` adds), then
  ``torch.optim.AdamW`` with optax's defaults (betas 0.9/0.999, eps 1e-8
  outside the square root, decoupled decay scaled by the rate) at the
  schedule's rate for the updates made so far (the first update's rate
  is 0.0, as optax's count starts at 0).  Its moments live in the
  parameters' dtype, as optax's do.
- ``train_step`` returns the loss and the pre-clip ``grad_norm``.

Over a training group (``parallel/mesh.training_mesh``'s ('dp', 'sp',
'tp'), ``moe_training_mesh``'s ('dp', 'ep'), or any subset) the weights
are placed FSDP x TP (x EP) (``parallel/sharding.place_for_training``)
and ``group_lm_loss`` runs the step, one process driving every slot, as
one JAX process drives its mesh:

- the batch's rows split over 'dp' and its positions over 'sp', each
  block of rows and positions with its tensor shards on the slots
  (d, r, t); the next-token targets are shifted before the split and
  each block's RoPE positions are its global ones;
- each layer gathers the pieces a slot computes with (``all_gather``,
  whose backward is JAX's reduce-scatter), runs its heads and FFN
  columns on the slot, and sums the row-parallel partials
  (``allreduce_sum``), the prefill layer's arithmetic on the slot's
  heads; attention is K2 on each slot under 'dp'/'tp', the ring
  (``parallel/ring_attention``, plain float32 as JAX's XLA is) along
  'sp';
- a MoE layer's gates, capacity and positions are computed once over the
  whole batch's tokens (JAX's ``moe_ffn_train`` over T = B x S), each
  'ep' slot runs its experts on them, and the float32 partials are
  summed once (``models/moe.py``);
- the loss is the global masked mean: every block's ``sum(nll * mask)``
  summed, over every block's ``sum(mask)`` clamped at 1;
- with ``remat`` each layer, over every slot, is recomputed in the
  backward pass; autograd runs through every copy between slots, so no
  backward is written by hand, as ``jax.grad`` runs through GSPMD.

AdamW is elementwise, so one optimizer over the pieces is whole-leaf
AdamW; each piece's moments live on its slot (ZeRO-3), and the global
norm counts each piece once.  The serving engines keep their
``no_grad`` forward; the trainer owns its own model, whose parameters
require gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.transformer import Transformer
from ..ops import attention, launches, quant
from ..parallel.collectives import allreduce_sum, rotate
from ..parallel.mesh import DeviceGroup
from ..parallel.ring_attention import ring
from ..parallel.sharding import (TrainPlacement, gather_model,
                                 place_for_training)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    seq_len: int = 128
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    max_grad_norm: float = 1.0
    remat: bool = True
    seed: int = 0
    # Cosine-decay horizon in optimizer steps; None = max(warmup*10, 1000).
    # A resumed run past it would train at the floor forever: see
    # Trainer.extend_schedule.
    decay_steps: Optional[int] = None


def schedule_horizon(tc: TrainConfig) -> int:
    return tc.decay_steps or max(tc.warmup_steps * 10, 1000)


def lr_at(tc: TrainConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, horizon,
    end_value=0.1 lr)`` at ``count`` updates made: linear from 0 over
    the warmup, then a cosine to the 10% floor over the rest of the
    horizon, the floor after it."""
    peak, warmup = tc.learning_rate, tc.warmup_steps
    if count < warmup:
        return peak * count / warmup
    decay = schedule_horizon(tc) - warmup
    t = min(count - warmup, decay)
    alpha = 0.1
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                   + alpha)


def make_optimizer(tc: TrainConfig, params) -> torch.optim.AdamW:
    """AdamW with optax's defaults over ``params``; the rate is set before
    every step from ``lr_at``."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tc.weight_decay)


def lm_loss(cfg: ModelConfig, model: Transformer, tokens: torch.Tensor,
            loss_mask: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy: tokens [B, S] int, loss_mask [B, S] (1.0
    where the TARGET position counts), accumulated in float32; a MoE
    model adds ``cfg.moe_aux_weight`` x its load-balance loss."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    hidden, _, aux = transformer.forward(cfg, model, tokens, positions,
                                         remat=remat)
    logits = transformer.logits_from_hidden(model, hidden[:, :-1])
    targets = tokens[:, 1:].long()
    mask = loss_mask[:, 1:].float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + cfg.moe_aux_weight * aux


def global_norm(grads, device=None) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every element's square
    summed, in float32 (on ``device``, default the first gradient's)."""
    device = device or grads[0].device
    return torch.sqrt(sum(rotate(torch.sum(g.float() ** 2), device)
                          for g in grads))


def clip_and_step(tc: TrainConfig, optimizer: torch.optim.Optimizer,
                  params, count: int, device) -> torch.Tensor:
    """The update after the backward pass: the gradients' global norm,
    optax's clip, then AdamW at ``lr_at(tc, count)``.  Returns the norm
    before the clip."""
    grads = [p.grad for p in params]
    with torch.no_grad():
        gnorm = global_norm(grads, device)
        # optax.clip_by_global_norm: leaves untouched below the bound,
        # else each one (t / norm) * max_norm.
        if not bool(gnorm < tc.max_grad_norm):
            for g in grads:
                g.copy_(g / rotate(gnorm, g.device).to(g.dtype)
                        * tc.max_grad_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr_at(tc, count)
    optimizer.step()
    return gnorm


def _shifted_targets(tokens: torch.Tensor, loss_mask: torch.Tensor):
    """Each position's next token and its mask: ``tokens[:, 1:]`` and
    ``loss_mask[:, 1:]`` with a last position that counts nothing, so a
    split of the sequence keeps the targets across its borders."""
    targets = torch.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    mask = torch.zeros(tokens.shape, dtype=torch.float32,
                       device=tokens.device)
    mask[:, :-1] = loss_mask[:, 1:]
    return targets, mask


ATTN_KEYS = ("ln1", "wq", "wk", "wv", "wo")
FFN_KEYS = ("w_gate", "w_up", "w_down")


def group_lm_loss(cfg: ModelConfig, placement: TrainPlacement,
                  tokens: torch.Tensor, loss_mask: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    """``lm_loss`` over a placed model's group (module docstring): tokens
    and loss_mask [B, S] on the group's lead, B divided by 'dp' and S by
    'sp'."""
    g = placement.group
    dp, sp, tp = g.dp, g.sp, g.tp
    n_b, n_s = tokens.shape
    if n_b % dp or n_s % sp:
        raise ValueError(f"batch {n_b} x seq {n_s} does not split over "
                         f"dp={dp} x sp={sp}")
    b, s = n_b // dp, n_s // sp
    moe = cfg.num_experts > 1
    nq, nkv, hd = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim
    eps = cfg.norm_eps
    blocks = [(d, r) for d in range(dp) for r in range(sp)]
    slot = {(d, r, t): g.index(dp=d, sp=r, tp=t)
            for d, r in blocks for t in range(tp)}
    dev = {k: g.devices[v] for k, v in slot.items()}
    lead = {blk: dev[blk + (0,)] for blk in blocks}

    def cut(x, d, r):
        return rotate(x[d * b:(d + 1) * b, r * s:(r + 1) * s], lead[d, r])

    rope = {}
    for d, r in blocks:
        pos = torch.arange(r * s, (r + 1) * s, device=lead[d, r])[None]
        sin, cos = transformer.rope_sincos(pos, hd, cfg.rope_theta)
        for t in range(tp):
            rope[d, r, t] = (rotate(sin, dev[d, r, t]),
                             rotate(cos, dev[d, r, t]))
    embeds = dict(zip(blocks, placement.use(
        "embed", {}, [lead[blk] for blk in blocks])))
    xs = [quant.embed_rows(embeds[d, r], cut(tokens, d, r))
          for d, r in blocks]

    def use(name, coords, keys):
        """Leaf ``name`` at ``coords`` onto the slot of each (d, r, t)
        in ``keys``, by key."""
        return dict(zip(keys, placement.use(name, coords,
                                            [dev[k] for k in keys])))

    def layer(i, *xs):
        pre = f"layers.{i}."
        xs = dict(zip(blocks, xs))
        w = {}
        for t in range(tp):
            keys = [blk + (t,) for blk in blocks]
            for key in ATTN_KEYS + (() if moe else ("ln2",) + FFN_KEYS):
                for k, x in use(pre + key, {"tp": t}, keys).items():
                    w[k, key] = x
        qkv, attn = {}, {}
        for k in slot:
            h = transformer.rms_norm(rotate(xs[k[:2]], dev[k]),
                                     w[k, "ln1"], eps)
            sin, cos = rope[k]
            qkv[k] = [transformer.apply_rope(
                (h @ w[k, "wq"]).reshape(b, s, nq, hd), sin, cos),
                transformer.apply_rope(
                (h @ w[k, "wk"]).reshape(b, s, nkv, hd), sin, cos),
                (h @ w[k, "wv"]).reshape(b, s, nkv, hd)]
        if sp == 1:
            for k in slot:
                with launches.on_shard(slot[k]):
                    attn[k] = attention.causal(*qkv[k])
        else:
            for d in range(dp):
                for t in range(tp):
                    row = [(d, r, t) for r in range(sp)]
                    here = dev[row[0]]
                    whole = [torch.cat([rotate(qkv[k][j], here)
                                        for k in row], dim=1)
                             for j in range(3)]
                    out = ring(*whole, [dev[k] for k in row])
                    for r, k in enumerate(row):
                        attn[k] = rotate(out[:, r * s:(r + 1) * s], dev[k])
        new = {}
        for d, r in blocks:
            parts = [attn[d, r, t].reshape(b, s, nq * hd) @ w[(d, r, t), "wo"]
                     for t in range(tp)]
            new[d, r] = xs[d, r] + allreduce_sum(parts, [lead[d, r]])[0]
        if moe:
            return _moe_ffn(cfg, placement, pre, new, blocks, lead, b, s)
        aux = torch.zeros((), dtype=torch.float32, device=g.lead)
        out = []
        for d, r in blocks:
            parts = []
            for t in range(tp):
                k = (d, r, t)
                with launches.on_shard(slot[k]):
                    h = transformer.rms_norm(rotate(new[d, r], dev[k]),
                                             w[k, "ln2"], eps)
                    parts.append(transformer._swiglu(
                        h, *(w[k, key] for key in FFN_KEYS)))
            out.append(new[d, r] + allreduce_sum(parts, [lead[d, r]])[0])
        return (*out, aux)

    aux = torch.zeros((), dtype=torch.float32, device=g.lead)
    for i in range(cfg.num_layers):
        if remat:
            *xs, layer_aux = checkpoint(layer, i, *xs, use_reentrant=False)
        else:
            *xs, layer_aux = layer(i, *xs)
        aux = aux + layer_aux
    finals = dict(zip(blocks, placement.use(
        "final_ln", {}, [lead[blk] for blk in blocks])))
    targets, mask = _shifted_targets(tokens, loss_mask)
    nll_sum = mask_sum = torch.zeros((), dtype=torch.float32, device=g.lead)
    for (d, r), x in zip(blocks, xs):
        hidden = transformer.rms_norm(x, finals[d, r], eps)
        logp = F.log_softmax(quant.tied_head(embeds[d, r], hidden), dim=-1)
        nll = -logp.gather(-1, cut(targets, d, r)[..., None])[..., 0]
        m = cut(mask, d, r)
        nll_sum = nll_sum + rotate(torch.sum(nll * m), g.lead)
        mask_sum = mask_sum + rotate(torch.sum(m), g.lead)
    ce = nll_sum / torch.clamp(mask_sum, min=1.0)
    return ce + cfg.moe_aux_weight * aux


def _moe_ffn(cfg: ModelConfig, placement: TrainPlacement, pre: str,
             xs: Dict, blocks, lead: Dict, b: int, s: int):
    """A MoE layer's FFN over the group: the whole batch's residual on
    the group's lead in token order (rows, then positions), the gates,
    capacity and positions once over it (``moe_ffn_train``), each (ep,
    tp) slot's experts as one ``ExpertSlice`` of gathered pieces; the
    output cut back into the blocks.  -> (*new residual blocks, aux)."""
    from types import SimpleNamespace

    from ..models.moe import ExpertSlice, moe_ffn_train
    g = placement.group
    here = g.lead
    dp, sp = g.dp, g.sp
    x = torch.cat([torch.cat([rotate(xs[d, r], here) for r in range(sp)],
                             dim=1) for d in range(dp)], dim=0)
    ln2, router = (placement.use(pre + key, {}, [here])[0]
                   for key in ("ln2", "w_router"))
    n_e = cfg.num_experts // g.ep
    slices = []
    for e in range(g.ep):
        for t in range(g.tp):
            k = g.index(ep=e, tp=t)
            ws = {key: placement.use(pre + key, {"ep": e, "tp": t},
                                     [g.devices[k]])[0] for key in FFN_KEYS}
            slices.append(ExpertSlice(first=e * n_e, slot=k,
                                      device=g.devices[k], **ws))
    lp = SimpleNamespace(w_router=router, slices=slices)
    if len(slices) == 1:
        lp = SimpleNamespace(w_router=router, slices=None, **{
            key: getattr(slices[0], key) for key in FFN_KEYS})
    out, aux = moe_ffn_train(cfg, lp, transformer.rms_norm(x, ln2,
                                                            cfg.norm_eps))
    new = [xs[d, r] + rotate(out[d * b:(d + 1) * b, r * s:(r + 1) * s],
                             lead[d, r]) for d, r in blocks]
    return (*new, aux)


class Trainer:
    """Owns the model, its AdamW state and the step counter: on one
    device (default: the card) or over ``mesh``, a training
    ``DeviceGroup`` (JAX's ``Trainer(cfg, tc, mesh, params)``).
    ``params`` (a whole ``Transformer``) replaces the family's seeded
    init; on one device it is moved there and trained in place, over a
    group it is cut into pieces."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 mesh: Optional[DeviceGroup] = None,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None):
        from .. import models
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh or DeviceGroup((resolve_device(device),), ("dp",))
        self.device = self.mesh.lead
        if params is None:
            params = models.init_params(cfg, seed=tc.seed, device=self.device)
        self.placement = place_for_training(params, self.mesh)
        self.optimizer = make_optimizer(tc, self.placement.parameters())
        self.step_count = 0

    @property
    def model(self) -> Transformer:
        """The model: on one device the trained module itself, over a
        group a whole copy gathered from the pieces."""
        if self.placement.model is not None:
            return self.placement.model
        return gather_model(self.placement)

    def train_step(self, tokens: np.ndarray,
                   loss_mask: Optional[np.ndarray] = None
                   ) -> Dict[str, float]:
        """One step on a [B, S] token batch: -> {"loss", "grad_norm"} (the
        norm before clipping)."""
        if loss_mask is None:
            loss_mask = np.ones_like(tokens, np.float32)
        tokens_t = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                   device=self.device)
        mask_t = torch.as_tensor(np.asarray(loss_mask), dtype=torch.float32,
                                 device=self.device)
        params = self.placement.parameters()
        self.optimizer.zero_grad(set_to_none=True)
        if self.placement.model is not None:
            loss = lm_loss(self.cfg, self.placement.model, tokens_t, mask_t,
                           remat=self.tc.remat)
        else:
            loss = group_lm_loss(self.cfg, self.placement, tokens_t, mask_t,
                                 remat=self.tc.remat)
        loss.backward()
        gnorm = clip_and_step(self.tc, self.optimizer, params,
                              self.step_count, self.device)
        self.step_count += 1
        return {"loss": float(loss.detach()), "grad_norm": float(gnorm)}

    def extend_schedule(self, total_steps: int) -> bool:
        """Grow the cosine horizon to at least ``total_steps`` updates,
        keeping the restored Adam moments and step count (only the
        count -> rate mapping changes).  Called after a resume so the
        restored count lands mid-cosine, not past the horizon at the
        floor.  Returns True if the schedule changed."""
        if total_steps <= schedule_horizon(self.tc):
            return False
        self.tc = dataclasses.replace(self.tc, decay_steps=total_steps)
        return True

    # -- checkpoint / resume (utils/checkpoint.py) ---------------------------

    def save(self, path: str) -> Optional[str]:
        """Checkpoint the weights, the optimizer state and the step count
        under ``<path>/v<step>``, every leaf whole.  Returns the root, or
        None when this exact step is already the published ``latest``
        (the save is skipped; advance a step to publish a different
        state)."""
        from ..utils.checkpoint import save_train_state
        return save_train_state(path, self)

    def load(self, path: str) -> None:
        """Resume from ``<path>/latest`` in place, whatever group saved
        it (the whole leaves are cut into this trainer's pieces)."""
        from ..utils.checkpoint import load_train_state
        load_train_state(path, self)
