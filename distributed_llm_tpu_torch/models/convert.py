"""Carry a JAX parameter pytree over to the port's ``Transformer``.

The JAX package stores weights as a pytree of stacked ``[L, ...]``
leaves (``embed [V, H]``, ``layers/wq [L, H, Nq*D]`` ... used as
``x @ w``, ``final_ln [H]``).  The port keeps the same layout per
layer, so conversion is a copy of leaf ``[l]`` into layer ``l``.  The
tree is passed as numpy arrays (the caller converts; the port never
imports JAX), which is how tests hand both packages the same weights.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from .transformer import Transformer

_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up",
               "w_down")


def _copy(dst: torch.nn.Parameter, src: Any, name: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape} != expected "
                         f"{tuple(dst.shape)}")
    # numpy has no bfloat16: go through float32, which holds bf16 exactly.
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr, np.float32)))


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any],
                    device=None) -> Transformer:
    """numpy pytree {"embed", "layers": {...[L, ...]}, "final_ln"} ->
    ``Transformer`` in ``cfg.dtype`` on ``device`` (default CPU)."""
    model = Transformer(cfg, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_ln, tree["final_ln"], "final_ln")
    layers = tree["layers"]
    for key in _LAYER_KEYS:
        stacked = np.asarray(layers[key])
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layers/{key}: {stacked.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for i, layer in enumerate(model.layers):
            _copy(getattr(layer, key), stacked[i], f"layers/{key}[{i}]")
    return model
