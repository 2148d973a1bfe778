"""A tier's device group and the carve that hands one to every tier.

Counterpart of ``distributed_llm_tpu/parallel/mesh.py``.  JAX runs a
tier on a ``Mesh`` of chips from one controlling process; the port's
counterpart is a ``DeviceGroup``: an ordered list of ``torch.device``
slots, its axis names and its shape.  One process drives every slot:
the engines run each shard's work on its slot's device in turn, and the
group's collectives (``parallel/collectives.py``) move what crosses
slots.  A list that repeats one device is a group whose shards share
that device, the port's counterpart of JAX's host-platform device count
(the CPU tests pass ``["cpu"] * 8``; on a one-card machine the card
repeated stands in for a group of cards).

A serving group is 1-D ``("tp",)``, or 2-D: ``("batch", "tp")`` for a
replicated tier's rows, ``("sp", "tp")`` for sequence parallelism (ring
prefill, the sequence-sharded cache) and ``("ep", "tp")`` for expert
parallelism; slot ``r * tp + t`` is row ``r``'s tensor shard ``t``.  A
training group is ``("dp", "sp", "tp")`` (``training_mesh``), ``("dp",
"ep")`` (``moe_training_mesh``), ``("dp",)`` (``pretrain``) or ``("pp",)``
(``training/pipeline_trainer.py``); ``index`` finds the slot at given
coordinates on the named axes, row-major.

``carve_tier_meshes`` follows JAX's rules: tiers claim disjoint slices
in declaration order, a tier's ``tp`` shrinks to the largest divisor of
its head counts that fits what is left, its ``ep`` to the largest
divisor of the expert count that fits beside it, its ``sp`` to the
largest power of two that fits (ignored, with JAX's warning, on a MoE,
batched or speculating tier), and with nothing left a tier shares the
front of the list.  A remote (``endpoint``) tier claims nothing.  The
training meshes factor a device list as JAX's ``training_mesh`` and
``moe_training_mesh`` do.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..config import ClusterConfig, TierConfig
from ..device import DeviceLike, resolve_device

DevicesLike = Sequence[Union[str, torch.device]]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """An ordered device list shaped by named axes (row-major): the
    slots of a tier's mesh.  ``devices[i]`` is slot ``i``; two slots may
    name the same device only when the caller's list repeated it."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("tp",)
    dims: Tuple[int, ...] = ()
    # Positions of the slots in the list a carve cut them from (what
    # JAX's device ids tell apart when the devices repeat); () elsewhere.
    slots: Tuple[int, ...] = ()

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        dims = self.dims or (len(devs),)
        if not devs:
            raise ValueError("a device group needs at least one device")
        n = 1
        for d in dims:
            n *= d
        if len(dims) != len(self.axis_names) or n != len(devs):
            raise ValueError(f"axes {self.axis_names} with dims {dims} do "
                             f"not shape {len(devs)} devices")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "dims", tuple(dims))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def sp(self) -> int:
        return self.shape.get("sp", 1)

    @property
    def ep(self) -> int:
        return self.shape.get("ep", 1)

    @property
    def dp(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def pp(self) -> int:
        return self.shape.get("pp", 1)

    def index(self, **coords: int) -> int:
        """The slot at ``coords`` on the named axes (row-major; an axis
        left out, or one the group lacks, at 0)."""
        slot = 0
        for name, n in zip(self.axis_names, self.dims):
            slot = slot * n + coords.get(name, 0)
        return slot

    @property
    def parallel(self) -> bool:
        """Whether an engine shards over this group (tp, sp or ep > 1)."""
        return max(self.tp, self.sp, self.ep) > 1

    def column(self, t: int) -> Tuple[torch.device, ...]:
        """The devices of tensor shard ``t`` along the group's first
        axis (the sp ring or the ep slots of shard ``t``)."""
        return self.devices[t::self.tp]

    @property
    def lead(self) -> torch.device:
        """The first slot's device: where a sharded engine keeps what is
        replicated once (tables, sampling, a replicated draft)."""
        return self.devices[0]

    @property
    def shared(self) -> bool:
        """Whether every slot is the same device."""
        return len(set(self.devices)) == 1


def as_devices(devices: Optional[DevicesLike] = None,
               device: DeviceLike = None) -> Tuple[torch.device, ...]:
    """A device list: ``devices`` resolved, else every card on the
    machine, else (``device`` given, e.g. ``"cpu"``) that one device."""
    if devices is not None:
        return tuple(resolve_device(d) for d in devices)
    dev = resolve_device(device)
    if dev.type == "cuda" and device is None:
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def tp_mesh(devices: DevicesLike, tp: int, axis_name: str = "tp"
            ) -> DeviceGroup:
    """A 1-D tensor-parallel group over the first ``tp`` devices."""
    devices = list(devices)
    if len(devices) < tp:
        raise ValueError(f"tp_mesh: need {tp} devices, have {len(devices)}")
    return DeviceGroup(tuple(devices[:tp]), (axis_name,), (tp,))


def replica_mesh(devices: DevicesLike, replicas: int, tp: int = 1
                 ) -> DeviceGroup:
    """A 2-D ('batch', 'tp') group over the first replicas x tp devices:
    each row is one engine replica's own slice."""
    devices = list(devices)[:replicas * tp]
    return DeviceGroup(tuple(devices), ("batch", "tp"), (replicas, tp))


def sp_tp_mesh(devices: DevicesLike, sp: int, tp: int) -> DeviceGroup:
    """A 2-D ('sp', 'tp') group over the first sp x tp devices: ring
    prefill over 'sp' x tensor-parallel weights over 'tp'."""
    devices = list(devices)
    if len(devices) < sp * tp:
        raise ValueError(f"sp_tp_mesh: need {sp * tp} devices for "
                         f"sp={sp} x tp={tp}, have {len(devices)}")
    return DeviceGroup(tuple(devices[:sp * tp]), ("sp", "tp"), (sp, tp))


def ep_tp_mesh(devices: DevicesLike, ep: int, tp: int = 1) -> DeviceGroup:
    """A 2-D ('ep', 'tp') group over the first ep x tp devices: whole
    experts over 'ep', attention heads, KV and expert columns over
    'tp'."""
    devices = list(devices)
    if len(devices) < ep * tp:
        raise ValueError(f"ep_tp_mesh: need {ep * tp} devices for "
                         f"ep={ep} x tp={tp}, have {len(devices)}")
    return DeviceGroup(tuple(devices[:ep * tp]), ("ep", "tp"), (ep, tp))


def _tier_group(devices: list, tp: int, ep: int, sp: int,
                rep: int = 1) -> DeviceGroup:
    """The group JAX's carve builds from the front of ``devices``."""
    if ep > 1:
        return ep_tp_mesh(devices, ep, tp)
    if sp > 1:
        return sp_tp_mesh(devices, sp, tp)
    if rep > 1:
        return replica_mesh(devices, rep, tp)
    return tp_mesh(devices, tp)


def carve_tier_meshes(cluster: ClusterConfig,
                      devices: Optional[DevicesLike] = None,
                      device: DeviceLike = None) -> Dict[str, DeviceGroup]:
    """Assign disjoint device slices to tiers, in declaration order
    (JAX's carve): each tier claims ``tp`` slots (``replicas x tp`` for a
    replicated tier), its ``tp`` shrunk to fit what is left; with nothing
    left it shares from the front of the list.  ``devices`` defaults to
    every card (``as_devices``); ``device="cpu"`` carves one CPU."""
    devices = list(as_devices(devices, device))
    meshes: Dict[str, DeviceGroup] = {}
    cursor = 0
    for tier in cluster.tiers():
        if tier.endpoint:
            continue        # a cross-host tier: its devices are elsewhere
        remaining = len(devices) - cursor
        tp = _fit_tp(tier, max(remaining, 0))
        if tp == 0:
            # Nothing left: share devices from the front.
            tp = max(_fit_tp(tier, len(devices)), 1)
            ep = _fit_ep(tier, len(devices), tp)
            sp = _fit_sp(tier, len(devices), tp)
            group = _tier_group(devices, tp, ep, sp)
            meshes[tier.name] = dataclasses.replace(
                group, slots=tuple(range(group.size)))
            continue
        ep = _fit_ep(tier, remaining, tp)
        sp = _fit_sp(tier, remaining, tp) if ep == 1 else 1
        rep = (_fit_replicas(tier, remaining, tp)
               if ep == 1 and sp == 1 else 1)
        group = _tier_group(devices[cursor:], tp, ep, sp, rep)
        meshes[tier.name] = dataclasses.replace(
            group, slots=tuple(range(cursor, cursor + group.size)))
        cursor += tp * max(sp, ep, rep)
    return meshes


def _fit_replicas(tier: TierConfig, available: int, tp: int) -> int:
    """Device rows a replicated tier can claim: up to ``tier.replicas``
    (an autoscaled tier: its maximum) disjoint ``tp``-sized slices,
    shrinking to what is left; replicas beyond them share devices."""
    want = tier.replicas
    if tier.autoscale:
        want = max(want, int(tier.autoscale_max_replicas))
    if want <= 1:
        return 1
    return max(1, min(want, available // max(1, tp)))


def _fit_ep(tier: TierConfig, available: int, tp: int) -> int:
    """Largest expert-parallel degree <= requested that divides the
    model's expert count and fits the devices beside tp; 1 for a dense
    tier (nothing to shard on 'ep')."""
    experts = tier.model().num_experts
    if tier.ep <= 1 or experts <= 1:
        return 1
    ep = min(tier.ep, max(available // tp, 1), experts)
    while ep > 1 and experts % ep:
        ep -= 1
    return max(ep, 1)


def _fit_sp(tier: TierConfig, available: int, tp: int) -> int:
    """Largest power-of-two sequence-parallel degree <= requested that
    fits the devices beside tp (a power of two divides the power-of-two
    prefill buckets).  1, reserving no extra devices, for a tier whose
    engine cannot use it: only the dense sequential engine runs ring
    prefill (JAX's warning)."""
    if tier.sp > 1 and (tier.model().num_experts > 1
                        or tier.decode_batch > 1 or tier.draft_preset):
        logger.warning(
            "tier %s: sp=%d ignored — sequence-parallel prefill needs the "
            "dense sequential engine (MoE=%s decode_batch=%d draft=%s); "
            "not reserving extra chips",
            tier.name, tier.sp, tier.model().num_experts > 1,
            tier.decode_batch, tier.draft_preset)
        return 1
    sp = 1
    while sp * 2 <= tier.sp and sp * 2 * tp <= available:
        sp *= 2
    return sp


def requested_tp(tier: TierConfig) -> int:
    """The tier's requested tensor-parallel degree: ``tier.tp`` (JAX's
    ``DLLM_TP`` override is the field itself here: the port has no env
    knobs).  ``_fit_tp`` clamps it afterwards."""
    return max(1, int(tier.tp))


def _fit_tp(tier: TierConfig, available: int) -> int:
    """Largest feasible tensor-parallel degree <= requested, dividing the
    model's q and kv head counts (whole GQA groups per shard)."""
    if available <= 0:
        return 0
    cfg = tier.model()
    tp = min(requested_tp(tier), available)
    while tp > 1 and (cfg.num_kv_heads % tp or cfg.num_heads % tp):
        tp -= 1
    return max(tp, 1)


def _largest_divisor(m: int, dividing: int) -> int:
    """The largest factor of ``m`` that also divides ``dividing``."""
    return max(f for f in range(1, m + 1) if m % f == 0 and dividing % f == 0)


def training_mesh(devices: Optional[DevicesLike] = None, *,
                  num_kv_heads: int, seq_len: int) -> DeviceGroup:
    """Every device as a ('dp', 'sp', 'tp') training group (JAX's rule):
    ``tp`` the largest divisor of n that divides the kv heads, ``sp`` the
    largest divisor of the rest that divides ``seq_len`` (but a rest
    above 2 taken whole by sp gives half of it back to dp), ``dp`` what
    is left.  ``devices`` defaults to every card (``as_devices``)."""
    devices = as_devices(devices)
    n = len(devices)
    tp = _largest_divisor(n, num_kv_heads)
    rest = n // tp
    sp = _largest_divisor(rest, seq_len)
    if sp == rest and rest > 2 and rest % 2 == 0:
        sp = _largest_divisor(rest // 2, seq_len)
    return DeviceGroup(devices, ("dp", "sp", "tp"), (rest // sp, sp, tp))


def moe_training_mesh(devices: Optional[DevicesLike] = None, *,
                      num_experts: int) -> DeviceGroup:
    """Every device as a ('dp', 'ep') group for MoE training (JAX's rule):
    ``ep`` the largest divisor of n that divides the expert count, ``dp``
    the rest."""
    devices = as_devices(devices)
    ep = _largest_divisor(len(devices), num_experts)
    return DeviceGroup(devices, ("dp", "ep"), (len(devices) // ep, ep))


def describe_meshes(meshes: Dict[str, DeviceGroup]) -> str:
    parts = []
    for name, group in meshes.items():
        ids = [str(d) for d in group.devices]
        parts.append(f"{name}: {len(ids)} device(s) {ids}")
    return "; ".join(parts)
