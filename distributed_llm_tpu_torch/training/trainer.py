"""Language-model training on one device.

Counterpart of ``distributed_llm_tpu/training/trainer.py`` at one device
(the JAX trainer's dp/sp/tp mesh waits for the multi-GPU slice).  A
training step is the JAX step:

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

The serving engines keep their ``no_grad`` forward; the trainer owns its
own model, whose parameters require gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import transformer
from ..models.transformer import Transformer


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


def global_norm(grads) -> torch.Tensor:
    """optax's ``global_norm``: the square root of every element's square
    summed, in float32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


class Trainer:
    """Owns the model (``model``), its AdamW state and the step counter on
    one device (default: the card).  ``params`` replaces the family's
    seeded init (it is moved to the device and trained in place)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None):
        from .. import models
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        if params is None:
            params = models.init_params(cfg, seed=tc.seed, device=self.device)
        self.model = params.to(self.device)
        self.model.requires_grad_(True)
        self.optimizer = make_optimizer(tc, list(self.model.parameters()))
        self.step_count = 0

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
        params = list(self.model.parameters())
        self.optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(self.cfg, self.model, tokens_t, mask_t,
                       remat=self.tc.remat)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad for p in params]
            gnorm = global_norm(grads)
            # optax.clip_by_global_norm: leaves untouched below the bound,
            # else each one (t / norm) * max_norm.
            if not bool(gnorm < self.tc.max_grad_norm):
                for g in grads:
                    g.copy_(g / gnorm.to(g.dtype) * self.tc.max_grad_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr_at(self.tc, self.step_count)
        self.optimizer.step()
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
        under ``<path>/v<step>``.  Returns the root, or None when this
        exact step is already the published ``latest`` (the save is
        skipped; advance a step to publish a different state)."""
        from ..utils.checkpoint import save_train_state
        return save_train_state(path, self)

    def load(self, path: str) -> None:
        """Resume from ``<path>/latest`` in place."""
        from ..utils.checkpoint import load_train_state
        load_train_state(path, self)
