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
watchdog surface only where the engine has one.  The JAX package's
device-mesh plumbing and HBM budget are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Optional, Union

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from .batching import ContinuousBatchingEngine
from .inference import InferenceEngine
from .speculative import SpeculativeEngine

logger = logging.getLogger(__name__)

Engine = Union[ContinuousBatchingEngine, InferenceEngine, SpeculativeEngine]


class EngineManager:
    def __init__(self, tier: TierConfig, seed: int = 0,
                 warmup_on_start: bool = True, device: DeviceLike = None):
        tier.check_ported()
        self.tier = tier
        self.seed = seed
        self.warmup_on_start = warmup_on_start
        self.device = resolve_device(device)
        self._engine: Optional[Engine] = None
        self._lock = threading.RLock()
        self._started_at: Optional[float] = None
        # True from drain() until the next start_server: intentional
        # shedding, which probes must not read as failure.
        self._draining = False

    def start_server(self) -> None:
        """Idempotent: build the engine (kernels compile here on the card)
        and warm it.  The lifecycle lock is held through the build; the
        probe surface (health, is_server_running, the engine() fast path)
        never takes it."""
        with self._lock:
            if self._engine is not None:
                return
            self._draining = False
            t0 = time.perf_counter()
            engine = self._build(self.tier)
            if self.warmup_on_start:
                engine.warmup()
            self._started_at = time.time()
            self._engine = engine
            logger.info("tier %s up in %.1fs (model=%s, device=%s)",
                        self.tier.name, time.perf_counter() - t0,
                        self.tier.model_preset, self.device)

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
                                            device=self.device)
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
        return InferenceEngine(tier, seed=self.seed, device=self.device)

    def stop_server(self) -> None:
        """Stop and drop the engine; its weights and caches are freed."""
        with self._lock:
            stop = getattr(self._engine, "stop", None)
            if callable(stop):
                stop()                  # the batched engine: join its loop
            self._engine = None
            self._started_at = None

    def drain(self, timeout_s: float = 30.0) -> Dict[str, Any]:
        """Graceful shutdown: report ``draining``, give in-flight requests
        up to ``timeout_s`` to finish, then stop the engine (stragglers
        fail with the engine-stopped shape).  Never call it under the
        lifecycle lock: it blocks, then takes that lock."""
        self._draining = True
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(timeout_s))

        def in_flight() -> int:
            pending = getattr(self._engine, "pending_work", None)
            return pending() if callable(pending) else 0

        started = in_flight()
        while time.monotonic() < deadline and in_flight() > 0:
            time.sleep(0.02)
        leftover = in_flight()
        self.stop_server()
        if leftover:
            logger.warning("tier %s drain deadline (%.1fs) passed with %d "
                           "request(s) in flight; stopped", self.tier.name,
                           timeout_s, leftover)
        return {"draining_started": True, "in_flight_at_start": started,
                "drained": max(0, started - leftover), "aborted": leftover,
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
            "uptime_s": ((time.time() - started_at)
                         if running and started_at is not None else 0.0),
        }
        if engine is None:
            entry["queue_depth"] = 0
            return entry
        slots = getattr(engine, "slot_stats", None)
        if callable(slots):
            entry.update(slots())
        stall = getattr(engine, "progress_stall_s", None)
        if not callable(stall):
            return entry
        stall_s = stall()
        entry["decode_stall_s"] = round(stall_s, 3)
        deadline = self.tier.watchdog_stall_s
        if deadline is not None and stall_s > deadline:
            entry["ok"] = False
            entry["wedged"] = True
            entry["error"] = (f"decode watchdog: no step progress for "
                              f"{stall_s:.1f}s (deadline {deadline:.0f}s)")
        return entry
