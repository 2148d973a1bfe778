"""Engine lifecycle manager: build, warm, probe, drain and stop a tier.

Counterpart of ``distributed_llm_tpu/engine/manager.py``'s
``EngineManager`` with the same surface (``start_server``, ``engine()``,
``stop_server``, ``drain``, ``health``, ``is_server_running``) and the
same engine selection, on one device:

- ``decode_batch > 1``: the continuous-batching engine, with batched
  speculation armed for a greedy tier that configures a draft;
- ``decode_batch <= 1`` with a ``draft_preset`` on a greedy tier: the
  sequential ``SpeculativeEngine`` (a draft on a sampling tier is
  ignored, with a warning);
- anything else: the sequential ``InferenceEngine``.

The sequential engines have no scheduler: the probes read its load and
watchdog surface only where the engine has one.  A tier client
(serving/tiers.py) registers its ``AdmissionController`` as
``admission``: drain then rejects new requests and waits out the
admitted ones, and ``health()`` reports the queue depth.  A tier with
``hbm_gb_per_chip`` is budgeted before its engine is built
(utils/hbm_budget.py) and refused with ``TierOverCapacityError`` when it
does not fit.  The process-global metrics count the requests a drain
completed and each rising edge of the decode watchdog; ``health()``
carries the batched engine's profiler summary.  A ``group`` (the tier's
device group from ``parallel/mesh.carve_tier_meshes``) reaches the
batched and the sequential engine, which run tensor-, sequence- or
expert-parallel over it when it holds more than one slot; the sequential ``SpeculativeEngine``
takes no group (JAX's takes no mesh) and runs on the group's first
device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Optional, Union

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from ..obs import get_observability
from ..parallel.mesh import DeviceGroup, tp_mesh
from .batching import ContinuousBatchingEngine
from .inference import InferenceEngine
from .speculative import SpeculativeEngine

logger = logging.getLogger(__name__)

Engine = Union[ContinuousBatchingEngine, InferenceEngine, SpeculativeEngine]


class TierOverCapacityError(RuntimeError):
    """A tier with ``hbm_gb_per_chip`` set does not fit its device:
    weights + KV exceed the budget (utils/hbm_budget.tier_hbm_budget).
    Raised by ``start_server`` before any weights materialize."""


class EngineManager:
    def __init__(self, tier: TierConfig, seed: int = 0,
                 warmup_on_start: bool = True, device: DeviceLike = None,
                 group: Optional[DeviceGroup] = None):
        tier.check_ported()
        self.tier = tier
        self.seed = seed
        self.warmup_on_start = warmup_on_start
        self.group = group
        self.device = (group.lead if group is not None
                       else resolve_device(device))
        self._engine: Optional[Engine] = None
        self._lock = threading.RLock()
        self._started_at: Optional[float] = None
        # True from drain() until the next start_server: intentional
        # shedding, which probes must not read as failure.
        self._draining = False
        # The tier client's AdmissionController, when one serves this tier.
        self.admission = None
        # Watchdog edge detector: health() counts wedge transitions, not
        # every probe of a wedged engine (own lock: concurrent probes).
        self._wedged_seen = False
        self._wedged_lock = threading.Lock()

    def start_server(self) -> None:
        """Idempotent: build the engine (kernels compile here on the card)
        and warm it.  The lifecycle lock is held through the build; the
        probe surface (health, is_server_running, the engine() fast path)
        never takes it."""
        with self._lock:
            if self._engine is not None:
                return
            self._draining = False
            if self.admission is not None:
                self.admission.end_drain()   # a restart re-opens the tier
            t0 = time.perf_counter()
            if self.tier.hbm_gb_per_chip is not None:
                self._check_budget()
            engine = self._build(self.tier)
            if self.warmup_on_start:
                # dllm-lint: disable=lock-blocking-call -- lifecycle lock intentionally held through warmup (the captures); all liveness readers (is_server_running, health) are lock-free
                engine.warmup()
            self._started_at = time.time()
            self._engine = engine
            logger.info("tier %s up in %.1fs (model=%s, device=%s)",
                        self.tier.name, time.perf_counter() - t0,
                        self.tier.model_preset, self.device)

    def _check_budget(self) -> None:
        """Refuse the tier before building it when weights + KV do not
        fit ``hbm_gb_per_chip`` (less the activation headroom)."""
        from ..utils.hbm_budget import tier_hbm_budget
        budget = tier_hbm_budget(self.tier,
                                 hbm_per_chip_gb=self.tier.hbm_gb_per_chip,
                                 mesh=self.group or tp_mesh([self.device], 1))
        if not budget["fits"]:
            raise TierOverCapacityError(
                f"tier {self.tier.name}: {budget['total_gb_per_chip']} "
                f"GB/chip (params {budget['params_gb_per_chip']} + KV "
                f"{budget['kv_gb_per_chip']}) plus the 0.75 GB activation "
                f"headroom exceeds the hbm_gb_per_chip="
                f"{self.tier.hbm_gb_per_chip} budget on "
                f"{budget['chips']} chip(s)")
        logger.info("tier %s: fits %s GB/chip budget (%s GB/chip, "
                    "headroom %s GB)", self.tier.name,
                    self.tier.hbm_gb_per_chip, budget["total_gb_per_chip"],
                    budget["headroom_gb"])

    def _build(self, tier: TierConfig) -> Engine:
        """The JAX manager's engine selection (see the module note)."""
        draft = tier.draft_preset
        if draft and tier.temperature > 0:
            logger.warning("tier %s: draft_preset=%s ignored (speculative "
                           "decoding is greedy-only; temperature=%s)",
                           tier.name, draft, tier.temperature)
            draft = None
        if tier.decode_batch > 1:
            if draft and tier.spec_decode is None:
                # AUTO (the tri-state default): a configured draft arms
                # batched speculation on the engine's view of the tier;
                # an explicit spec_decode=False is the operator's switch
                # and passes through.
                tier = dataclasses.replace(tier, spec_decode=True)
            return ContinuousBatchingEngine(tier, seed=self.seed,
                                            device=self.device,
                                            **self._group_kw())
        if draft:
            logger.info("tier %s: decode_batch=1, sequential "
                        "SpeculativeEngine (gamma=%d)", tier.name,
                        tier.speculative_gamma)
            # The draft is a fresh model with no checkpoint of its own.
            draft_tier = dataclasses.replace(
                tier, name=f"{tier.name}-draft", model_preset=draft,
                draft_preset=None, checkpoint_path=None)
            return SpeculativeEngine(tier, draft_tier,
                                     gamma=tier.speculative_gamma,
                                     seed=self.seed, device=self.device)
        return InferenceEngine(tier, seed=self.seed, device=self.device,
                               **self._group_kw())

    def _group_kw(self) -> Dict[str, Any]:
        """The engine's ``group`` argument where it shards (tp, sp or
        ep > 1); a one-slot group is its device."""
        if self.group is not None and self.group.parallel:
            return {"group": self.group}
        return {}

    def stop_server(self) -> None:
        """Stop and drop the engine; its weights and caches are freed."""
        with self._lock:
            stop = getattr(self._engine, "stop", None)
            if callable(stop):
                stop()                  # the batched engine: join its loop
            self._engine = None
            self._started_at = None

    def drain(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful shutdown: report ``draining`` (the admission gate
        rejects new requests with ``retry_after_s``), give in-flight
        requests up to ``timeout_s`` (default ``tier.drain_timeout_s``) to
        finish, then stop the engine (stragglers fail with the
        engine-stopped shape).  Never call it under the lifecycle lock: it
        blocks, then takes that lock."""
        timeout_s = (self.tier.drain_timeout_s if timeout_s is None
                     else timeout_s)
        self._draining = True
        if self.admission is not None:
            self.admission.start_drain(retry_after_s=timeout_s)
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(timeout_s))

        def in_flight() -> int:
            n = (self.admission.snapshot()["inflight"]
                 if self.admission is not None else 0)
            pending = getattr(self._engine, "pending_work", None)
            return max(n, pending() if callable(pending) else 0)

        started = in_flight()
        while time.monotonic() < deadline and in_flight() > 0:
            time.sleep(0.02)
        leftover = in_flight()
        self.stop_server()
        drained = max(0, started - leftover)
        if drained:
            get_observability().m.drained_requests.labels(
                self.tier.name).inc(drained)
        if leftover:
            logger.warning("tier %s drain deadline (%.1fs) passed with %d "
                           "request(s) in flight; stopped", self.tier.name,
                           timeout_s, leftover)
        return {"draining_started": True, "in_flight_at_start": started,
                "drained": drained, "aborted": leftover,
                "waited_s": round(time.monotonic() - t0, 3)}

    @property
    def draining(self) -> bool:
        return self._draining

    def is_server_running(self) -> bool:
        """Lock-free: one attribute read."""
        return self._engine is not None

    def engine(self) -> Engine:
        """Lazy-start accessor: lock-free when the engine is up; a cold
        start holds the lifecycle lock across check, start and read."""
        engine = self._engine
        if engine is not None:
            return engine
        with self._lock:
            if self._engine is None:
                # dllm-lint: disable=lock-blocking-call -- cold-start serialization is exactly what the lifecycle lock is for; probes read lock-free, and a dispatcher must wait for the engine it asked for
                self.start_server()
            return self._engine

    def health(self) -> Dict[str, Any]:
        """Liveness and load snapshot (lock-free).  A scheduler with
        pending work and no progress past ``tier.watchdog_stall_s`` reads
        as wedged."""
        engine = self._engine
        started_at = self._started_at
        running = engine is not None
        entry: Dict[str, Any] = {
            "ok": running,
            "draining": self._draining,
            "tier": self.tier.name,
            "model": self.tier.model_preset,
            "device": str(self.device),
            "devices": ([str(d) for d in self.group.devices]
                        if self.group is not None else None),
            "uptime_s": ((time.time() - started_at)
                         if running and started_at is not None else 0.0),
        }
        slots = getattr(engine, "slot_stats", None)
        if callable(slots):
            entry.update(slots())
        stall = getattr(engine, "progress_stall_s", None)
        if callable(stall):
            stall_s = stall()
            entry["decode_stall_s"] = round(stall_s, 3)
            deadline = self.tier.watchdog_stall_s
            if deadline is not None and stall_s > deadline:
                entry["ok"] = False
                entry["wedged"] = True
                entry["error"] = (f"decode watchdog: no step progress for "
                                  f"{stall_s:.1f}s (deadline "
                                  f"{deadline:.0f}s)")
                with self._wedged_lock:
                    rising = not self._wedged_seen
                    self._wedged_seen = True
                if rising:
                    get_observability().m.watchdog_wedged.labels(
                        self.tier.name).inc()
            else:
                with self._wedged_lock:
                    self._wedged_seen = False
        # The profiler sideband: whether /debug/trace has anything to say.
        prof = getattr(engine, "profiler", None)
        if prof is not None and prof.enabled:
            entry["profile"] = prof.summary()
        if self.admission is not None:
            adm = self.admission.snapshot()
            entry["admission"] = adm
            # Requests waiting beyond the engine's slots; an engine with no
            # slot_stats gets its occupancy from admission in-flight.
            entry.setdefault("queue_depth", adm["queue_depth"])
            if "max_slots" not in entry:
                slots_n = adm["slots"]
                active = min(adm["inflight"], slots_n)
                entry["active_slots"] = active
                entry["max_slots"] = slots_n
                entry["slot_occupancy"] = round(active / slots_n, 3)
        entry.setdefault("queue_depth", 0)
        return entry
