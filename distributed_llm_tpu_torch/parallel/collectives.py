"""The collectives of a device group.

Counterpart of ``distributed_llm_tpu/parallel/collectives.py``.  One
process drives every slot of a group (``parallel/mesh.DeviceGroup``),
so a collective here is the controller moving data between its own
slots:

- ``allgather_health``: every slot contributes its perf-window summary
  row and every slot receives all of them (the router's health monitor
  folds the rows of other hosts into its perf strategy);
- ``psum_scalar``: one value per slot summed (liveness, quorum);
- ``summarize_perf_window``: a perf strategy's sample window as one row;
- ``allreduce_sum``: the model's one reduction, the sum of the
  row-parallel partials of ``wo`` and ``w_down`` in fixed shard order,
  in float32 and rounded once to the partials' dtype (as one product's
  float32 accumulator is rounded at tp=1), delivered onto each shard's
  device.  On a group whose slots share one device it is a chain of
  adds on that device and every shard reads the same tensor; across distinct CUDA devices each partial is a peer copy
  to the first shard's device, the sum is made there and copied back to
  each device;
- ``merge_partials``: the exact log-sum-exp merge of sequence-parallel
  attention partials (JAX's one ``pmax`` and two ``psum`` over 'sp',
  ``sp_attention.py``), in float32;
- ``rotate``: the ring's step, a block handed to the next slot's
  device (JAX's ``ppermute``): on a shared device the same tensor,
  across devices a peer copy issued on the current stream, so it is
  recorded in a CUDA graph like any other copy;
- ``all_gather``: a training leaf's ``dp`` pieces (FSDP, ZeRO-3)
  concatenated onto each slot that computes with them, under autograd.
  Its backward is JAX's reduce-scatter: each piece's gradient is the
  sum over every slot that used it, in float32 in slot order, rounded
  once to the piece's dtype, on the piece's device.  Each using slot
  gets a tensor of its own (a view of one copy where slots share a
  device), so their gradients meet only in that sum.  ``allreduce_sum``
  is autograd-safe as it stands: the row-parallel partials' gradient is
  the sum's, cast to each partial's dtype.

The distinct-device paths (peer copies in ``allreduce_sum``, ``rotate``
and ``merge_partials``) have not run on cards: the machine the port is
checked on has one.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .mesh import DeviceGroup

# Health record layout, one row per participant.
HEALTH_FIELDS = ("total_latency_ms", "total_tokens", "ok_count", "n_samples")


def _rows_axis(group: DeviceGroup):
    axis = group.axis_names[0]
    return axis, group.shape[axis]


def allgather_health(group: DeviceGroup,
                     per_device_stats: np.ndarray) -> np.ndarray:
    """All-gather per-participant health rows over the group's first
    axis: ``per_device_stats`` [n, k], row i slot i's summary -> [n, k]
    float32, the same on every participant.  Each row goes to its slot's
    device and back, as JAX's shard_map gathers each chip's row."""
    axis, n = _rows_axis(group)
    stats = np.asarray(per_device_stats, np.float32)
    if stats.shape[0] != n:
        raise ValueError(f"expected {n} rows for mesh axis '{axis}', "
                         f"got {stats.shape[0]}")
    per = group.size // n
    rows = [torch.from_numpy(stats[i].copy()).to(group.devices[i * per])
            for i in range(n)]
    return np.stack([r.cpu().numpy() for r in rows])


def psum_scalar(group: DeviceGroup, values: np.ndarray) -> float:
    """Sum one scalar per slot across the group's first axis."""
    _, n = _rows_axis(group)
    vals = np.asarray(values, np.float32).reshape(-1)
    per = group.size // n
    lead = group.devices[0]
    total = torch.zeros((), dtype=torch.float32, device=lead)
    for i in range(n):
        total = total + torch.tensor(vals[i]).to(group.devices[i * per]).to(
            lead)
    return float(total)


def summarize_perf_window(samples) -> np.ndarray:
    """PerfStrategy sample window -> one health row (HEALTH_FIELDS)."""
    lat = sum(s[0] for s in samples)
    tok = sum(s[1] for s in samples)
    ok = sum(1 for s in samples if s[2])
    return np.array([lat, tok, ok, len(samples)], np.float32)


def allreduce_sum(parts: Sequence[torch.Tensor],
                  devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one per shard, each on its shard's device)
    in shard order, in float32, rounded once to their dtype, onto every
    shard's device: a list, one tensor per shard.  Shards on one device
    share the one sum."""
    total = parts[0].float()
    for p in parts[1:]:
        total = total + (p if p.device == total.device
                         else p.to(total.device, non_blocking=True)).float()
    total = total.to(parts[0].dtype)
    return [total if d == total.device else total.to(d, non_blocking=True)
            for d in devices]


class _AllGather(torch.autograd.Function):
    """``all_gather``'s Function: forward the concatenation of the pieces
    along ``dim`` onto each of ``devices``; backward the float32 sum of
    the outputs' gradients, split into the pieces' blocks."""

    @staticmethod
    def forward(ctx, dim, devices, *pieces):
        ctx.dim = dim
        ctx.homes = [(p.device, p.dtype, p.shape[dim]) for p in pieces]
        whole = {}
        for d in devices:
            if d not in whole:
                whole[d] = torch.cat([rotate(p, d) for p in pieces], dim)
        # One view each, so autograd hands every use's gradient to
        # backward apart instead of summing them in the leaf's dtype.
        return tuple(whole[d].view_as(whole[d]) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.float()
                total = g if total is None else total + rotate(g,
                                                               total.device)
        if total is None:
            return (None, None) + (None,) * len(ctx.homes)
        blocks = total.split([n for _, _, n in ctx.homes], ctx.dim)
        return (None, None) + tuple(
            rotate(b.to(dtype), dev) for b, (dev, dtype, _) in
            zip(blocks, ctx.homes))


def all_gather(pieces: Sequence[torch.Tensor], dim: int,
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The concatenation of ``pieces`` (each on its slot's device) along
    ``dim``, one tensor on each of ``devices``, differentiable: the
    pieces' gradients are the float32 sum over ``devices`` of the
    outputs', rounded once."""
    return list(_AllGather.apply(dim, tuple(devices), *pieces))


def merge_partials(ms: Sequence[torch.Tensor], ls: Sequence[torch.Tensor],
                   os: Sequence[torch.Tensor], device: torch.device
                   ) -> torch.Tensor:
    """The exact merge of per-shard attention partials, each on its
    shard's device: running max ``m`` [..., N], normalizer ``l`` [..., N]
    and unnormalized values ``o`` [..., N, D], all float32.  One max and
    two sums in shard order onto ``device``; returns ``o / l`` (``l``
    clamped at 1e-30) in float32."""
    ms = [rotate(m, device) for m in ms]
    m = ms[0]
    for m_i in ms[1:]:
        m = torch.maximum(m, m_i)
    l = o = None
    for m_i, l_i, o_i in zip(ms, ls, os):
        c = torch.exp(m_i - m)
        lc = rotate(l_i, device) * c
        oc = rotate(o_i, device) * c[..., None]
        l = lc if l is None else l + lc
        o = oc if o is None else o + oc
    return o / torch.clamp(l, min=1e-30)[..., None]


def rotate(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there, else a peer copy
    on the current stream (capture-safe: no host sync)."""
    return t if t.device == device else t.to(device, non_blocking=True)
