"""Model families of the port: the dense LLaMA-style transformer
(``transformer.py``) and MoE (``moe.py``).

``model_module(cfg)`` dispatches on ``num_experts`` so the engines, the
trainer and the checkpoints serve either family through one surface, as
the JAX package's ``models/__init__.py`` does: both modules expose
``init_params``, ``prefill`` (MoE's returns the aux loss too; use
``serving_prefill``), ``chunk_prefill`` and ``decode_step``.
"""

from __future__ import annotations

from ..config import ModelConfig
from . import moe, transformer  # noqa: F401


def model_module(cfg: ModelConfig):
    return moe if cfg.num_experts > 1 else transformer


def serving_prefill(cfg: ModelConfig, model, tokens, positions, attn=None):
    """(hidden, (k_all, v_all)) for either family (the MoE aux dropped).
    ``attn`` (dense only, as in JAX): the attention override of
    ``transformer.prefill``, which serves a MoE model too (its layers
    pick their FFN)."""
    return transformer.prefill(cfg, model, tokens, positions,
                               attn=attn if cfg.num_experts == 1 else None)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    return model_module(cfg).init_params(cfg, seed=seed, device=device)
