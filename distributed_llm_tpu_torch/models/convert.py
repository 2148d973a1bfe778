"""Carry a JAX parameter pytree over to the port's ``Transformer``.

The JAX package stores weights as a pytree of stacked ``[L, ...]``
leaves (``embed [V, H]``, ``layers/wq [L, H, Nq*D]`` ... used as
``x @ w``, ``final_ln [H]``).  The port keeps the same layout per
layer, so conversion is a copy of leaf ``[l]`` into layer ``l``.  The
tree is passed as numpy arrays (the caller converts; the port never
imports JAX), which is how tests hand both packages the same weights.
A quantized tree (the JAX ``quant.quantize_params``'s) passes too: each
``{"q", "s"}`` leaf (int8 values, scales in the model dtype or in float32
holding them) becomes an ``ops.quant.QTensor`` of the same values.  A
MoE tree (``num_experts > 1``) carries ``layers/w_router [L, H, E]`` and
the stacked experts ``[L, E, in, out]`` (int8 ones with scales
``[L, E, 1, out]``) into each ``models/moe.MoELayer``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import quant
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


def _put(module: torch.nn.Module, key: str, src: Any, name: str,
         index=None) -> None:
    """Copy leaf ``src`` (its row ``index`` when stacked) into
    ``module.key``: a plain array into the parameter, a ``{"q", "s"}``
    leaf into a QTensor swapped in for it."""
    dst = getattr(module, key)
    if not (isinstance(src, Mapping) and "q" in src and "s" in src):
        _copy(dst, src if index is None else src[index], name)
        return
    q, s = (np.asarray(src[k]) for k in ("q", "s"))
    if index is not None:
        q, s = q[index], s[index]
    if tuple(q.shape) != tuple(dst.shape) or q.dtype != np.int8:
        raise ValueError(f"{name}: q {q.dtype}{q.shape} != expected int8"
                         f"{tuple(dst.shape)}")
    quant.swap_in(module, key, quant.QTensor(
        torch.from_numpy(np.array(q)).to(dst.device),
        torch.from_numpy(np.array(s, np.float32)).to(dst.device, dst.dtype)))


def _layers_of(leaf: Any) -> int:
    if isinstance(leaf, Mapping):
        leaf = leaf["q"]
    return np.asarray(leaf).shape[0]


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any],
                    device=None) -> Transformer:
    """numpy pytree {"embed", "layers": {...[L, ...]}, "final_ln"}, plain
    or quantized -> ``Transformer`` in ``cfg.dtype`` on ``device``
    (default CPU)."""
    model = Transformer(cfg, device=device)
    _put(model, "embed", tree["embed"], "embed")
    _copy(model.final_ln, tree["final_ln"], "final_ln")
    layers = tree["layers"]
    keys = _LAYER_KEYS + (("w_router",) if cfg.num_experts > 1 else ())
    for key in keys:
        if _layers_of(layers[key]) != cfg.num_layers:
            raise ValueError(f"layers/{key}: {_layers_of(layers[key])} "
                             f"layers, config has {cfg.num_layers}")
        for i, layer in enumerate(model.layers):
            _put(layer, key, layers[key], f"layers/{key}[{i}]", i)
    return model
