"""Pipeline parallelism: GPipe microbatching over a group's 'pp' axis.

Counterpart of ``distributed_llm_tpu/parallel/pipeline.py``.  The layer
stack splits into S contiguous stages (``split_stages``), stage ``s``'s
parameters on slot ``s`` of a ('pp',) group, and ``pipeline_apply`` runs
the GPipe schedule: at tick ``m + s`` stage ``s`` runs microbatch ``m``
on its slot and hands its output to slot ``s + 1`` (JAX's
``ppermute``); the last stage's outputs gather onto the group's lead
(JAX's final ``psum`` broadcast).

JAX runs every stage at every one of the M + S - 1 ticks, clamping the
microbatch index in the fill and drain and masking those results with
``where``, so they add nothing.  One process drives every slot here, so
it does not run those bubble ticks at all; the outputs and gradients are
the same.  Backward is autograd through the copies between slots, as
``jax.grad`` runs through ``shard_map`` and ``ppermute``: no backward
schedule is written by hand.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..ops import launches
from .collectives import rotate
from .mesh import DeviceGroup


def split_stages(layers: Any, num_stages: int) -> Any:
    """Per-layer parameters -> S stages of L / S layers each: a stacked
    tensor [L, ...] -> [S, L / S, ...], a sequence (the port's per-layer
    modules) -> a list of S lists."""
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"num_layers={n} not divisible by pp={num_stages}")
    per = n // num_stages
    if isinstance(layers, torch.Tensor):
        return layers.reshape(num_stages, per, *layers.shape[1:])
    return [list(layers[s * per:(s + 1) * per]) for s in range(num_stages)]


def merge_stages(stages: Any) -> Any:
    """Inverse of ``split_stages``: [S, L / S, ...] -> [L, ...], a list of
    stages -> one list of layers."""
    if isinstance(stages, torch.Tensor):
        return stages.reshape(stages.shape[0] * stages.shape[1],
                              *stages.shape[2:])
    return [layer for stage in stages for layer in stage]


def pipeline_apply(group: DeviceGroup, stage_fn: Callable[..., torch.Tensor],
                   stage_params: Sequence[Any], microbatches: torch.Tensor,
                   extras: Optional[Sequence[torch.Tensor]] = None,
                   axis_name: str = "pp") -> torch.Tensor:
    """``stage_fn(params, x, extras)`` (one stage's layers) as an S-stage
    GPipe pipeline over ``group``'s ``axis_name`` slots.  ``stage_params
    [s]`` is stage ``s``'s, on its slot; ``microbatches`` [M, mb, ...];
    ``extras`` tensors every stage call takes (e.g. RoPE sin/cos), copied
    to each slot.  Each stage's launches tally under its slot
    (``launches.on_shard``).  Returns the [M, mb, ...] outputs on the
    group's lead."""
    n = group.shape[axis_name]
    num_micro = microbatches.shape[0]
    slots = [group.index(**{axis_name: s}) for s in range(n)]
    devices = [group.devices[k] for k in slots]
    extras_on = [tuple(rotate(e, d) for e in (extras or ()))
                 for d in devices]
    inbox: Dict[int, torch.Tensor] = {}
    outs: List[Optional[torch.Tensor]] = [None] * num_micro
    for tick in range(num_micro + n - 1):
        for s in range(n):
            m = tick - s
            if not 0 <= m < num_micro:
                continue                    # a bubble: nothing to run
            x = (rotate(microbatches[m], devices[0]) if s == 0
                 else inbox.pop(m))
            with launches.on_shard(slots[s]):
                y = stage_fn(stage_params[s], x, extras_on[s])
            if s + 1 < n:
                inbox[m] = rotate(y, devices[s + 1])
            else:
                outs[m] = rotate(y, group.lead)
    return torch.stack(outs)
