"""Tier clients: the device-client layer over the in-process engines.

Counterpart of ``distributed_llm_tpu/serving/tiers.py``.  A
``TierClient`` has the reference client's surface (``.process(history)``
returning ``{"response": text}`` or an error dict, ``.process_stream``,
``.server_manager``) over an ``EngineManager`` on the tier's device:

- ``AdmissionController`` bounds each tier: ``decode_batch`` slots plus a
  waiting line of ``admission_max_queue``, a predictive fail-fast when the
  EWMA service time says the queue would outlast ``request_timeout_s``, a
  KV-pressure gate, and rejection while the tier drains;
- ``process`` runs the engine call in a worker thread under
  ``request_timeout_s``; past it the reference error shape is returned and
  the worker is abandoned (its admission slot held until it finishes); a
  sequential engine is serialized by the client's engine lock;
- ``process_stream`` primes the first delta (prefill has run) before it
  returns, so setup-time failover catches real engine failures;
- ``load_snapshot`` feeds queue-aware perf routing;
- a ``FaultInjector`` (utils/faults.py) intercepts a request after
  admission and before the engine, on both paths, and a stream it
  scripts a kill for dies mid-stream (``maybe_break_stream``);
- a quotas-on tier (``tenant_quotas``) admits each request against its
  tenant's budgets (serving/tenants.py) before the tier's controller, so a
  shed tenant never takes tier admission state; the refusal carries the
  tenant's own ``retry_after_s``;
- ``build_tiers`` gives a tier with ``replicas > 1`` or ``autoscale`` a
  ``ReplicatedTierClient`` (serving/replicas.py), and a tier with an
  ``endpoint`` a ``RemoteTierClient`` (serving/remote.py), each with the
  same surface.

The request's span tree (obs/spans.py) gets the JAX client's spans:
``admission``, ``engine_start`` on a lazy start, ``engine_lock_wait``
for a sequential stream, and the ``timeout_abandoned`` event; a worker
thread re-binds the trace (``use_trace``) so the engine attaches its
own spans to the same tree.

Not ported (ROADMAP.md): device meshes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

from ..config import ClusterConfig, TierConfig
from ..device import DeviceLike
from ..engine.inference import GenerationResult
from ..engine.manager import EngineManager
from ..obs import spans as obs_spans
from ..obs.spans import current_trace, use_trace
from ..utils.faults import FaultInjector, maybe_break_stream
from .errors import error_dict
from .tenants import DEFAULT_TENANT, TenantQuotas
from .turns import ClippedStream, clip_turn

logger = logging.getLogger(__name__)

History = Union[str, List[Dict[str, Any]]]

# Characters a fully clipped stream may drain inside the eager first-delta
# prime before ClippedStream releases the primer with an empty delta
# (about 74 BPE tokens at 3.5 characters a token).
PRIME_DRAIN_CHARS = 256


class AdmissionController:
    """Bounded per-tier admission with predictive fail-fast.

    The concurrency story for a batched tier is no longer a lock queue:
    requests admit freely up to the engine's ``decode_batch`` slots, and
    beyond that a bounded waiting line.  A request is REJECTED (reference
    error shape, so Router failover and the perf fail penalty fire) when
    either

    - the waiting line is full (``tier.admission_max_queue`` requests
      already waiting beyond the slots), or
    - the EWMA of recent service times predicts this request would wait
      past ``tier.request_timeout_s`` anyway — failing in microseconds
      what would otherwise fail by timeout after blocking a thread for
      the full cap, or
    - (``tier.kv_admission``, batched tiers) the request's PROJECTED KV
      block demand — prompt bucket + decode budget — exceeds the paged
      pool's free blocks plus the blocks reclaimable by evicting parked
      prefixes: a fixed HBM block pool admits by blocks, not slots, and
      a request that must starve should fail over now (reference error
      shape + ``retry_after_s``) instead of queuing forever, or
    - the tier is DRAINING (graceful shutdown, EngineManager.drain):
      rejection with ``retry_after_s`` so clients retry elsewhere/later.

    Composes with the abandoned-worker accounting: an abandoned
    timed-out call keeps its admission slot until the worker really
    finishes (the engine genuinely is busy with it), so a wedged tier's
    predicted wait grows and new traffic sheds to the healthy tier.
    """

    def __init__(self, tier: TierConfig, slots: Optional[int] = None):
        self.tier = tier
        # ``slots`` = the engine's REAL concurrency when the caller
        # knows it differs from decode_batch (the speculative fallback
        # serves sequentially) — admission believing in concurrency the
        # engine doesn't have would admit N× what can be served.
        self.slots = max(1, slots if slots is not None
                         else tier.decode_batch)
        self.max_queue = tier.admission_max_queue
        self.timeout_s = tier.request_timeout_s
        self._lock = threading.Lock()
        self._inflight = 0
        self._ewma_s: Optional[float] = None
        self._alpha = 0.25                    # EWMA smoothing
        self.admitted = 0
        self.rejected = 0
        self.kv_rejected = 0
        # Graceful drain (EngineManager.drain): while set, every request
        # is rejected with the drain reason; retry_after_s carries the
        # drain deadline as the client's retry hint.
        self._draining = False
        self._drain_retry_after: Optional[float] = None

    def try_admit(self, kv_demand: Optional[int] = None,
                  kv_supply: Optional[int] = None) -> Optional[str]:
        """None = admitted (caller MUST release exactly once); else the
        human-readable rejection reason.  ``kv_demand``/``kv_supply``
        (projected blocks needed vs free + reclaimable, from the tier's
        paged engine) arm the KV-pressure gate; either None skips it."""
        with self._lock:
            if self._draining:
                self.rejected += 1
                return "draining (graceful shutdown in progress)"
            waiting = max(0, self._inflight - self.slots)
            # The line this request would JOIN: cap 0 means "slots only,
            # nobody waits", not "reject even with free slots".
            waiting_after = max(0, self._inflight + 1 - self.slots)
            enabled = self.max_queue is not None   # None = control off
            if enabled and waiting_after > self.max_queue:
                self.rejected += 1
                return (f"queue full ({waiting} waiting, "
                        f"cap {self.max_queue})")
            if enabled and self.timeout_s is not None and self._ewma_s:
                # Queue wait only (queue_depth × EWMA / slots): a slow
                # request with a free slot is the per-request timeout's
                # job; admission rejects what would spend its whole
                # budget WAITING.
                predicted = (waiting / self.slots) * self._ewma_s
                if predicted > self.timeout_s:
                    self.rejected += 1
                    return (f"predicted queue wait {predicted:.1f}s "
                            f"exceeds the {self.timeout_s:.0f}s request "
                            f"timeout (queue_depth={waiting}, "
                            f"ewma_service={self._ewma_s:.2f}s)")
            if (kv_demand is not None and kv_supply is not None
                    and self._inflight < self.slots
                    and kv_demand > kv_supply):
                # A slot is FREE but the block pool cannot serve the
                # request (starvation / constrained pool) — the anomaly
                # this gate exists for: the request would sit in the
                # engine queue invisible to the wait predictor.  Shed
                # now, while the Router can still fail over.  At full
                # slot occupancy the gate stands down: blocks free when
                # slots finish, and the bounded queue + EWMA predictor
                # already model that wait in time units (shedding there
                # would reject saturated-load requests that queue fine).
                self.rejected += 1
                self.kv_rejected += 1
                return (f"projected KV demand {kv_demand} blocks exceeds "
                        f"{kv_supply} free+reclaimable (pool pressure)")
            self._inflight += 1
            self.admitted += 1
            return None

    # -- drain (EngineManager.drain) ---------------------------------------

    def start_drain(self, retry_after_s: Optional[float] = None) -> None:
        with self._lock:
            self._draining = True
            self._drain_retry_after = retry_after_s

    def end_drain(self) -> None:
        with self._lock:
            self._draining = False
            self._drain_retry_after = None

    @property
    def draining(self) -> bool:
        return self._draining

    def retry_after_s(self) -> float:
        """Client retry hint for a rejection: the drain deadline while
        draining, else the EWMA service time (one slot finishing frees
        capacity/blocks), else a 1 s floor."""
        with self._lock:
            if self._draining and self._drain_retry_after:
                return round(float(self._drain_retry_after), 2)
            if self._ewma_s:
                return max(0.1, round(self._ewma_s, 2))
        return 1.0

    def release(self, service_s: Optional[float] = None) -> None:
        """End of an admitted request.  ``service_s`` (wall time the
        engine was actually occupied — including timed-out calls, which
        are exactly the slow evidence the EWMA exists to capture) feeds
        the service-time estimate; pass None for requests that never
        reached the engine (setup failures)."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if service_s is not None and service_s >= 0:
                self._ewma_s = (service_s if self._ewma_s is None
                                else (1 - self._alpha) * self._ewma_s
                                + self._alpha * service_s)

    # -- observability -----------------------------------------------------

    def queue_depth(self) -> int:
        with self._lock:
            return max(0, self._inflight - self.slots)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            waiting = max(0, self._inflight - self.slots)
            return {
                "inflight": self._inflight,
                "queue_depth": waiting,
                "slots": self.slots,
                "max_queue": self.max_queue,
                "ewma_service_ms": (round(self._ewma_s * 1000.0, 2)
                                    if self._ewma_s is not None else None),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "kv_rejected": self.kv_rejected,
                "draining": self._draining,
            }


class TierClient:
    def __init__(self, tier: TierConfig, manager: EngineManager,
                 fault_injector: Optional[FaultInjector] = None):
        self.tier = tier
        self.name = tier.name
        self.server_manager = manager          # the reference client's name
        self.faults = fault_injector
        self.last_result: Optional[GenerationResult] = None
        # Bounded admission is the concurrency story; registered on the
        # manager so health() reports the queue and drain gates on it.
        self.admission = AdmissionController(tier,
                                             slots=max(1, tier.decode_batch))
        manager.admission = self.admission
        # The per-tenant quota layer, built only when the tier opts in.
        self.tenants: Optional[TenantQuotas] = (
            TenantQuotas(tier) if tier.tenant_quotas is not None else None)
        # Serializes the sequential engines (they assume one caller) once
        # a request timeout can abandon a still-running worker; the
        # batched engine opts out through ``concurrent_safe``.
        self._engine_lock = threading.Lock()
        # Abandoned timed-out workers still running: while one is, new sync
        # requests on a serialized engine fail fast instead of queueing
        # behind it.
        self._abandoned_lock = threading.Lock()
        self._abandoned = 0

    def process(self, history: History) -> Dict[str, Any]:
        """Run inference; error dicts mirror the reference client shapes.

        Admission runs first.  The engine call then runs in a worker
        thread capped by ``tier.request_timeout_s`` (the reference
        client's HTTP read timeout): past it the reference error shape is
        returned so Router failover and the perf failure penalty fire, and
        the abandoned worker finishes in the background (its completion
        never overwrites ``last_result``).  The fault intercept runs after
        admission, so a rejected request consumes no one-shot fault.  The
        tenant's quota gate runs before the tier's."""
        trace = current_trace()
        tenant = self._tenant_of(trace)
        tenant_err = self._tenant_try_admit(trace, tenant)
        if tenant_err is not None:
            logger.warning("tier %s tenant quota rejected a request: %s",
                           self.name, tenant_err)
            return self._admission_error(tenant_err, tenant=tenant)

        def release_tenant():
            if self.tenants is not None:
                self.tenants.release(tenant)

        admit_err = self._admit(trace, history)
        if admit_err is not None:
            release_tenant()
            logger.warning("tier %s admission rejected a request: %s",
                           self.name, admit_err)
            return self._admission_error(admit_err)
        if self.faults is not None:
            fault = self.faults.intercept(self.name)
            if fault is not None:
                self.admission.release()     # never reached the engine
                release_tenant()
                return fault

        timeout = self.tier.request_timeout_s
        if timeout is None:
            t0 = time.perf_counter()
            try:
                resp, result = self._process_body(history)
            finally:
                self.admission.release(time.perf_counter() - t0)
                release_tenant()
            if result is not None:
                with self._abandoned_lock:
                    self.last_result = result
            return resp
        with self._abandoned_lock:
            abandoned_outstanding = self._abandoned
        if abandoned_outstanding and not self._engine_concurrent_safe():
            self.admission.release()
            release_tenant()
            logger.warning("tier %s has an abandoned timed-out call "
                           "outstanding: failing fast", self.name)
            return {"error": f"Request failed: {self.name} is busy with "
                             f"an abandoned timed-out request"}
        box: Dict[str, Any] = {}
        done = threading.Event()

        def work():
            resp: Dict[str, Any] = {"error": "Request failed: worker died"}
            result = None
            t0 = time.perf_counter()
            try:
                # Context variables do not cross threads: re-bind the
                # request's trace so the engine's spans join its tree.
                with use_trace(trace):
                    resp, result = self._process_body(history)
            finally:
                # Atomic with the caller's abandon decision: either done is
                # set here first (the caller sees the result) or the caller
                # marked the call abandoned first.
                with self._abandoned_lock:
                    box["out"] = resp
                    done.set()
                    if box.get("abandoned"):
                        self._abandoned -= 1
                    elif result is not None:
                        self.last_result = result
                # The admission and tenant slots are held for the
                # worker's whole life: an abandoned worker still occupies
                # the engine.
                self.admission.release(time.perf_counter() - t0)
                release_tenant()

        threading.Thread(target=work, daemon=True,
                         name=f"{self.name}-request").start()
        if not done.wait(timeout):
            with self._abandoned_lock:
                if not done.is_set():
                    box["abandoned"] = True
                    self._abandoned += 1
            if box.get("abandoned"):
                logger.warning("tier %s request exceeded %.0fs: abandoning "
                               "the device call and reporting failure",
                               self.name, timeout)
                obs_spans.event(trace, "timeout_abandoned", tier=self.name,
                                timeout_s=timeout)
                return {"error": f"Request failed: {self.name} timed out "
                                 f"after {timeout:.0f}s"}
        return box.get("out", {"error": "Request failed: worker died"})

    def _admit(self, trace, history: History) -> Optional[str]:
        """The admission controller's verdict (None = admitted), inside
        the request's ``admission`` span."""
        kv_demand, kv_supply = self._kv_admission_args(history)
        with obs_spans.span(trace, "admission", tier=self.name) as adm_sp:
            admit_err = self.admission.try_admit(kv_demand, kv_supply)
            if admit_err is not None:
                adm_sp.annotate(rejected=admit_err)
        return admit_err

    def _start_engine(self, trace) -> None:
        """Lazy-start the tier's engine inside an ``engine_start`` span."""
        logger.info("No running %s engine found, starting...", self.name)
        with obs_spans.span(trace, "engine_start", tier=self.name):
            self.server_manager.start_server()

    def _kv_admission_args(self, history: History):
        """(projected block demand, available block supply) for the KV
        admission gate, or (None, None) when it does not apply: gate off,
        engine not running, or an engine without a demand estimate (the
        port's full-residency pools have none).  Never starts an
        engine."""
        if not self.tier.kv_admission:
            return None, None
        engine = getattr(self.server_manager, "_engine", None)
        demand_fn = getattr(engine, "projected_demand_blocks", None)
        stats_fn = getattr(engine, "kv_stats", None)
        if not (callable(demand_fn) and callable(stats_fn)):
            return None, None
        try:
            st = stats_fn()
            supply = (int(st["free_blocks"]) + int(st["reclaimable_blocks"])
                      - int(st.get("prefill_pending_blocks", 0)))
            worst = getattr(engine, "max_demand_blocks", None)
            if callable(worst) and supply >= int(worst()):
                return None, None
            return int(demand_fn(history)), supply
        except Exception:
            return None, None               # estimation must never reject

    def _admission_error(self, admit_err: str,
                         tenant: Optional[str] = None) -> Dict[str, Any]:
        """Reference error shape for an admission rejection; drain and
        KV-pressure rejections carry the ``retry_after_s`` hint, and a
        tenant-quota rejection the tenant's own (its bucket's time to
        positive: the tier may be idle while this tenant is shed)."""
        msg = (f"Request failed: {self.name} admission rejected: "
               f"{admit_err}")
        if (tenant is not None and self.tenants is not None
                and "tenant '" in admit_err):
            return error_dict(
                msg, retry_after_s=self.tenants.retry_after_s(tenant))
        if "draining" in admit_err or "KV demand" in admit_err:
            return error_dict(msg,
                              retry_after_s=self.admission.retry_after_s())
        return {"error": msg}

    def _tenant_of(self, trace) -> str:
        """The request's tenant, annotated on the trace by the Router;
        callers without one bill to the shared default tenant."""
        t = trace.attrs.get("tenant") if trace is not None else None
        return t if isinstance(t, str) and t else DEFAULT_TENANT

    def _tenant_try_admit(self, trace, tenant: str) -> Optional[str]:
        """The quota layer's verdict (None: quotas off or in budget).  The
        KV bill is the tenant's live resident bill at 1/refcount from the
        engine, so shared prefixes lower it."""
        if self.tenants is None:
            return None
        kv_bill = None
        if self.tenants.kv_budget(tenant) is not None:
            engine = getattr(self.server_manager, "_engine", None)
            bill_fn = getattr(engine, "tenant_kv_blocks", None)
            if callable(bill_fn):
                kv_bill = bill_fn(tenant)
        with obs_spans.span(trace, "tenant_admission", tier=self.name,
                            tenant=tenant) as t_sp:
            tenant_err = self.tenants.try_admit(tenant, kv_bill)
            if tenant_err is not None:
                t_sp.annotate(rejected=tenant_err)
        return tenant_err

    def _engine_concurrent_safe(self) -> bool:
        """Abandoned workers only serialize engines that assume
        serialized callers."""
        try:
            if self.server_manager.is_server_running():
                return getattr(self.server_manager.engine(),
                               "concurrent_safe", False)
        except Exception:
            pass
        return False

    def _process_body(self, history: History
                      ) -> Tuple[Dict[str, Any], Optional[GenerationResult]]:
        """(response dict, result or None); the caller owns the
        ``last_result`` update."""
        try:
            if not self.server_manager.is_server_running():
                self._start_engine(current_trace())
            engine = self.server_manager.engine()
            if getattr(engine, "concurrent_safe", False):
                result = engine.generate(history)
            else:
                with self._engine_lock:
                    result = engine.generate(history)
        except Exception as exc:   # engine failure -> reference error shape
            shape = getattr(exc, "shape", None)
            if isinstance(shape, dict) and "error" in shape:
                return dict(shape), None     # engine stopped: exact shape
            return {"error": f"Request failed: {exc}"}, None
        if result is None:
            return {"error": f"Request failed: {self.name} engine "
                             f"returned no result"}, None
        # Single turn (the LMs continue the transcript; serving/turns.py);
        # the per-request timing rides in additive keys.
        resp: Dict[str, Any] = {"response": clip_turn(result.text)}
        for key in ("ttft_ms", "total_ms", "gen_tokens"):
            val = getattr(result, key, None)
            if val is not None:
                resp[key] = round(val, 3) if isinstance(val, float) else val
        return resp, result

    def process_stream(self, history: History):
        """Streaming twin of ``process``: a primed stream handle, or the
        reference error shape on any setup failure.  Admission gates
        streams too; the slot is released once, when the stream finishes
        (exhaustion, close or GC), with the engine-true generation time
        fed to the EWMA.  A sequential engine's lock is held for the
        stream's life, its acquire bounded by ``request_timeout_s``."""
        trace = current_trace()
        tenant = self._tenant_of(trace)
        tenant_err = self._tenant_try_admit(trace, tenant)
        if tenant_err is not None:
            logger.warning("tier %s tenant quota rejected a stream: %s",
                           self.name, tenant_err)
            return self._admission_error(tenant_err, tenant=tenant)

        def release_tenant():
            if self.tenants is not None:
                self.tenants.release(tenant)

        admit_err = self._admit(trace, history)
        if admit_err is not None:
            release_tenant()
            logger.warning("tier %s admission rejected a stream: %s",
                           self.name, admit_err)
            return self._admission_error(admit_err)
        t0 = time.perf_counter()
        handle_box: Dict[str, Any] = {}

        def finish_admission():
            result = getattr(handle_box.get("handle"), "result", None)
            engine_ms = getattr(result, "total_ms", 0) if result else 0
            self.admission.release(engine_ms / 1000.0 if engine_ms
                                   else time.perf_counter() - t0)
            release_tenant()

        try:
            if self.faults is not None:
                fault = self.faults.intercept(self.name)
                if fault is not None:
                    self.admission.release()   # never reached the engine
                    release_tenant()
                    return fault
            if not self.server_manager.is_server_running():
                self._start_engine(trace)
            engine = self.server_manager.engine()
            if not hasattr(engine, "generate_stream"):
                self.admission.release()
                release_tenant()
                return {"error": "Request failed: engine does not support "
                                 "token streaming"}
            if getattr(engine, "concurrent_safe", False):
                clipped = ClippedStream(engine.generate_stream(history),
                                        prime_drain_chars=PRIME_DRAIN_CHARS)
                handle_box["handle"] = clipped
                return _PrimedStream(
                    maybe_break_stream(self.faults, self.name, clipped),
                    release=finish_admission)
            timeout = self.tier.request_timeout_s
            # A sequential engine's lock is its queue: this wait is the
            # streaming twin of the batched engine's queue wait.
            with obs_spans.span(trace, "engine_lock_wait", tier=self.name):
                acquired = self._engine_lock.acquire(
                    timeout=timeout if timeout is not None else -1)
            if not acquired:
                self.admission.release()
                release_tenant()
                logger.warning("tier %s stream setup could not take the "
                               "engine lock within %.0fs", self.name, timeout)
                return {"error": f"Request failed: {self.name} engine busy "
                                 f"after {timeout:.0f}s"}

            def release_all():
                self._engine_lock.release()
                finish_admission()

            try:
                clipped = ClippedStream(engine.generate_stream(history),
                                        prime_drain_chars=PRIME_DRAIN_CHARS)
                handle_box["handle"] = clipped
                return _PrimedStream(
                    maybe_break_stream(self.faults, self.name, clipped),
                    release=release_all)
            except BaseException:
                self._engine_lock.release()
                raise
        except Exception as exc:
            self.admission.release()
            release_tenant()
            shape = getattr(exc, "shape", None)
            if isinstance(shape, dict) and "error" in shape:
                return dict(shape)
            return {"error": f"Request failed: {exc}"}

    def load_snapshot(self) -> Dict[str, Any]:
        """Live load for queue-aware perf routing: requests waiting beyond
        the engine's slots, and slot occupancy.  Never starts an engine."""
        adm = self.admission.snapshot()
        out = {"queue_depth": adm["queue_depth"],
               "active_slots": min(adm["inflight"], adm["slots"]),
               "max_slots": adm["slots"]}
        engine = getattr(self.server_manager, "_engine", None)
        slots = getattr(engine, "slot_stats", None)
        if callable(slots):
            try:
                st = slots()
                # The scheduler's queue also counts submitted-not-admitted
                # requests: the sharper view.
                out["queue_depth"] = max(out["queue_depth"],
                                         st["queue_depth"])
                out["active_slots"] = st["active_slots"]
                out["max_slots"] = st["max_slots"]
            except Exception:
                pass
        return out


class _PrimedStream:
    """A stream handle whose first delta has already been pulled (raising
    setup and prefill errors eagerly); iteration replays it, then goes on.
    ``release`` runs exactly once when the stream finishes: exhaustion,
    close of the generator chain (a client disconnect) or GC."""

    def __init__(self, handle, release=None):
        self._release_fn = release
        self._handle = handle
        self._it = iter(handle)
        self._first: Optional[str] = None
        self._exhausted = False
        try:
            self._first = next(self._it)
            if self._first == "":
                # ClippedStream's prime-release sentinel: primed, but no
                # real first delta to replay.
                self._first = None
        except StopIteration:
            self._exhausted = True
        except BaseException:
            # Setup failure: the caller releases; make __del__ a no-op.
            self._release_fn = None
            raise

    def _release_once(self) -> None:
        fn, self._release_fn = self._release_fn, None
        if fn is not None:
            fn()

    def __iter__(self):
        try:
            if self._first is not None:
                yield self._first
            if not self._exhausted:
                yield from self._it
        finally:
            self._release_once()

    def __del__(self):
        self._release_once()

    @property
    def result(self):
        return self._handle.result


def build_tiers(cluster: ClusterConfig, device: DeviceLike = None,
                warmup_on_start: bool = True,
                fault_injector: Optional[FaultInjector] = None
                ) -> Dict[str, TierClient]:
    """One client per tier on ``device`` (a registry, not classes): a
    ``RemoteTierClient`` for a tier with an ``endpoint`` (no local
    engine), a ``ReplicatedTierClient`` for ``replicas > 1`` or an
    autoscale-armed tier (elastic membership needs the replica layer even
    at one replica), else a ``TierClient`` over its own EngineManager.
    ``fault_injector`` reaches every client."""
    tiers: Dict[str, TierClient] = {}
    for tier in cluster.tiers():
        if tier.endpoint:
            from .remote import RemoteTierClient
            tiers[tier.name] = RemoteTierClient(
                tier.name, tier.endpoint, fault_injector=fault_injector,
                spawn_cmd=tier.spawn_cmd)
            continue
        if tier.replicas > 1 or tier.autoscale:
            from .replicas import ReplicatedTierClient
            tiers[tier.name] = ReplicatedTierClient(
                tier, cluster, device=device, fault_injector=fault_injector,
                warmup_on_start=warmup_on_start, seed=cluster.seed)
            continue
        manager = EngineManager(tier, seed=cluster.seed,
                                warmup_on_start=warmup_on_start,
                                device=device)
        tiers[tier.name] = TierClient(tier, manager, fault_injector)
    return tiers
