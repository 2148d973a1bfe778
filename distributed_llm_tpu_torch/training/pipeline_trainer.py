"""Pipeline-parallel trainer for the transformer.

Counterpart of ``distributed_llm_tpu/training/pipeline_trainer.py``.
The layer stack splits into ``pp`` contiguous stages on the slots of a
('pp',) group (``parallel/pipeline.py``); the embedding, the final norm
and the tied head stay whole on the group's lead, where the microbatches
start and the outputs gather.  A step runs the microbatched forward,
the backward through every copy between stages (autograd), and the
trainer's optax update (``trainer.clip_and_step``).

One stated difference: JAX's stage body calls ``attention.causal(...,
impl="xla")``; the port's stage is its own layer body
(``transformer._prefill_layer``), so on the card each stage's attention
is K2 (``FlashCausal``), as every CUDA causal attention in the port is.
On the CPU it is the plain causal attention, as JAX's XLA path is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models import transformer
from ..models.transformer import Transformer
from ..ops import quant
from ..parallel.mesh import DeviceGroup
from ..parallel.pipeline import pipeline_apply, split_stages
from .trainer import TrainConfig, clip_and_step, make_optimizer


def _stage_fn(cfg: ModelConfig):
    """One pipeline stage: its layers in order (the layer body of the
    serving prefill, its K/V dropped)."""
    def run(layers, x, extras):
        sin, cos = extras
        for lp in layers:
            x = transformer._prefill_layer(cfg, lp, x, sin, cos)[0]
        return x
    return run


def pipeline_lm_loss(cfg: ModelConfig, params: Dict[str, Any],
                     tokens: torch.Tensor, loss_mask: torch.Tensor,
                     mesh: DeviceGroup, num_microbatches: int
                     ) -> torch.Tensor:
    """Next-token cross-entropy with the layer stack run as a GPipe
    pipeline: ``params`` is {"embed", "layers" (the stages, each a list
    of layers on its slot), "final_ln"}; tokens and loss_mask [B, S] on
    the mesh's lead."""
    b, s = tokens.shape
    mb = b // num_microbatches
    positions = torch.arange(s, device=tokens.device)[None].expand(mb, s)
    sin, cos = transformer.rope_sincos(positions, cfg.head_dim,
                                       cfg.rope_theta)
    x = params["embed"][tokens]                            # [B, S, H]
    mbs = x.reshape(num_microbatches, mb, s, cfg.hidden_size)
    out = pipeline_apply(mesh, _stage_fn(cfg), params["layers"], mbs,
                         extras=(sin, cos))
    hidden = transformer.rms_norm(out.reshape(b, s, cfg.hidden_size),
                                  params["final_ln"], cfg.norm_eps)
    logits = quant.tied_head(params["embed"], hidden[:, :-1])
    targets = tokens[:, 1:].long()
    mask = loss_mask[:, 1:].float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class PipelineTrainer:
    """Owns the stage-split model on a ('pp',) group, its AdamW state and
    the step counter.  ``params`` (a whole ``Transformer``) replaces the
    seeded init; its layers move to their stages' slots."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, mesh: DeviceGroup,
                 num_microbatches: Optional[int] = None,
                 params: Optional[Transformer] = None):
        if "pp" not in mesh.axis_names:
            raise ValueError("PipelineTrainer needs a mesh with a 'pp' axis")
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.stages = mesh.shape["pp"]
        self.num_microbatches = num_microbatches or max(2, self.stages)
        if tc.batch_size % self.num_microbatches:
            raise ValueError(
                f"batch_size={tc.batch_size} not divisible by "
                f"microbatches={self.num_microbatches}")
        from .. import models
        lead = mesh.lead
        if params is None:
            params = models.init_params(cfg, seed=tc.seed, device=lead)
        model = params.to(lead)
        model.requires_grad_(True)
        staged = split_stages(list(model.layers), self.stages)
        for s, stage in enumerate(staged):
            for lp in stage:
                lp.to(mesh.devices[mesh.index(pp=s)])
        self._model = model
        self.params = {"embed": model.embed, "layers": staged,
                       "final_ln": model.final_ln}
        self.optimizer = make_optimizer(tc, list(model.parameters()))
        self.step_count = 0

    def train_step(self, tokens: np.ndarray,
                   loss_mask: Optional[np.ndarray] = None
                   ) -> Dict[str, float]:
        """One step on a [B, S] token batch: -> {"loss", "grad_norm"} (the
        norm before clipping)."""
        if loss_mask is None:
            loss_mask = np.ones_like(tokens, np.float32)
        lead = self.mesh.lead
        tokens_t = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                   device=lead)
        mask_t = torch.as_tensor(np.asarray(loss_mask), dtype=torch.float32,
                                 device=lead)
        params = list(self._model.parameters())
        self.optimizer.zero_grad(set_to_none=True)
        loss = pipeline_lm_loss(self.cfg, self.params, tokens_t, mask_t,
                                self.mesh, self.num_microbatches)
        loss.backward()
        gnorm = clip_and_step(self.tc, self.optimizer, params,
                              self.step_count, lead)
        self.step_count += 1
        return {"loss": float(loss.detach()), "grad_norm": float(gnorm)}

    def export_params(self) -> Transformer:
        """The model whole, a standard ``Transformer`` on the lead (a
        copy, its layers in order), for serving and checkpoint interop."""
        model = Transformer(self.cfg, device="meta")
        model.load_state_dict({
            k: v.detach().to(self.mesh.lead, copy=True)
            for k, v in self._model.state_dict().items()}, assign=True)
        model.requires_grad_(False)
        return model
