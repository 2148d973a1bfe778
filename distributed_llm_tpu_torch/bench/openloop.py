"""Open-loop traffic harness: Poisson arrivals against the real HTTP
edge, sweeping arrival rate to the knee of the latency-throughput curve.

Counterpart of ``distributed_llm_tpu/bench/openloop.py``, with its
constants, its keys and its knee rule.  The closed-loop N-client harness
(the headline) cannot see queueing collapse: a closed-loop client submits
its next request only after the previous answer lands, so offered load
self-throttles to whatever the system serves and the queue never grows.
Production arrivals are asynchronous, and the number that matters is
goodput under SLO: the rate of requests that completed ok with TTFT and
token cadence inside target.  This module:

- generates Poisson arrivals (``random.expovariate``) at a configured
  rate, each arrival an independent thread POSTing ``/chat`` through the
  in-process HTTP edge (``serving/app.py`` via ``test_client``, the same
  dispatch path a deployed server runs, minus the socket), with a
  multi-turn session mix drawn from the ``general_knowledge`` set;
- sweeps the arrival rate from a calibrated base service rate, doubling
  until SLO attainment falls below ``KNEE_ATTAINMENT``, and reads goodput
  from the router's own SLO monitor (``obs/slo.py``);
- reports the knee: the highest swept rate whose attainment is still at
  least ``KNEE_ATTAINMENT`` (0.9), with ``goodput_at_knee``;
- runs an overload epilogue at ``OVERLOAD_FACTOR`` x the knee and checks
  graceful degradation: every arrival gets an answer (availability, no
  hung clients) and the collapse shows as flight-recorded overload
  incidents carrying a system-state timeline slice (``obs/sampler.py``).

It serves the tiny batched cluster by default, as the JAX leg does (the
leg measures the serving machinery under load it did not choose, not
model speed); ``cluster`` serves another (chip_smoke passes the bench
cluster).  Budget-aware via ``budget_s``: rate points are dropped from
the top of the sweep, never measured shorter than ``MIN_POINT_S``.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from ..obs.metrics import nearest_rank

# Adaptive rate sweep: start below the calibrated sequential base rate
# and DOUBLE until SLO attainment collapses below KNEE_ATTAINMENT (the
# point past the knee) or a cap is hit.  A fixed multiplier ladder
# cannot work here: the sequential base rate understates the batched
# tiers' capacity by an order of magnitude (closed-loop calibration is
# exactly the blindness this harness exists to fix), so the sweep must
# chase the knee instead of assuming where it is.
SWEEP_START_MULTIPLIER = 0.75   # first point, × the sequential base rate
MAX_SWEEP_POINTS = 9            # ≤ base × 0.75 × 2^8 before giving up
MAX_RATE_REQ_PER_S = 800.0      # past this the spawn loop itself lies
MAX_ARRIVALS_PER_POINT = 600    # bounds threads/memory at high rates
# A point "holds" its offered load when this fraction of completions met
# the SLO; the knee is the highest such point.
KNEE_ATTAINMENT = 0.9
OVERLOAD_FACTOR = 2.5           # epilogue rate = knee × this (≥2× pinned)
MIN_POINT_S = 1.0               # never measure a rate point shorter
MAX_POINT_S = 4.0
SESSION_POOL = 8                # concurrent multi-turn sessions in the mix
JOIN_GRACE_S = 90.0             # drain window before a client counts hung


def _pct(values: List[float], q: float) -> Optional[float]:
    v = nearest_rank(values, q)
    return None if v is None else round(v, 2)


def _run_rate_point(client, router, queries, strategy: str,
                    rate_req_per_s: float, duration_s: float,
                    label: str, beat=lambda: None,
                    deadline: Optional[float] = None,
                    carry: Optional[List[threading.Thread]] = None
                    ) -> Dict[str, Any]:
    """One open-loop measurement window: Poisson arrivals at
    ``rate_req_per_s`` for ``duration_s``, goodput read from the
    router's SLO monitor deltas.  The master loop sleeps out each
    exponential gap and fires an independent daemon thread per arrival —
    an arrival NEVER waits for an earlier request (that would re-create
    the closed loop this harness exists to replace).

    ``deadline`` (``time.monotonic()``) clamps the straggler join grace
    so a wedged point cannot overrun the leg's budget share by the full
    JOIN_GRACE_S: the headline reserves only ~30 s after this leg.
    ``carry`` threads are stragglers a PREVIOUS point left running:
    they are absorbed (briefly joined) before the SLO baseline snapshot,
    because a stale completion landing mid-window would bleed into this
    point's good/observed deltas and skew its attainment; any that
    remain alive are counted in ``prior_stragglers`` so a contaminated
    point is marked, not silently trusted.  Still-alive threads are
    pushed back onto ``carry`` for the next point."""
    # Stable seed: str hash() is PYTHONHASHSEED-randomized per process,
    # which would draw a fresh arrival schedule every run and add
    # schedule-level variance to a leg pinned for cross-round comparison.
    rng = random.Random(zlib.crc32(label.encode())
                        ^ int(rate_req_per_s * 1000))
    lock = threading.Lock()
    latencies: List[float] = []
    completed = [0]
    http_errors = [0]

    def fire(i: int) -> None:
        t0 = time.perf_counter()
        try:
            resp = client.post("/chat", json={
                "message": queries[i % len(queries)]["query"],
                "strategy": strategy,
                "session_id": f"ol-{label}-{i % SESSION_POOL}",
            })
            status = resp.status_code
        except Exception:
            status = None
        dt = (time.perf_counter() - t0) * 1000.0
        with lock:
            if status is not None:
                completed[0] += 1
                latencies.append(dt)
                if status != 200:
                    http_errors[0] += 1

    # Bound the thread/memory cost of a very fast point: shrink the
    # window rather than the rate (the offered rate IS the experiment).
    duration_s = max(0.5, min(duration_s,
                              MAX_ARRIVALS_PER_POINT / rate_req_per_s))
    prior_stragglers = 0
    if carry:
        absorb_by = time.monotonic() + 5.0
        if deadline is not None:
            absorb_by = min(absorb_by, deadline)
        for t in carry:
            t.join(timeout=max(0.0, absorb_by - time.monotonic()))
            beat()
        prior_stragglers = sum(1 for t in carry if t.is_alive())
        carry[:] = [t for t in carry if t.is_alive()]
    slo = router.slo
    g0, o0 = slo.good_total, slo.observed_total
    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    # The window's end has a name of its own: the JAX leg reuses
    # ``deadline`` here, so its drain grace below is always the 5 s floor.
    window_end = t_start + duration_s
    # ABSOLUTE arrival schedule: each exponential gap advances a target
    # timestamp and the loop sleeps only the remaining distance to it —
    # per-iteration sleep/spawn overhead turns into a brief catch-up
    # burst (arrivals that "fell behind" fire back-to-back) instead of
    # silently deflating the offered rate at high λ, which would report
    # a spawn-loop ceiling as the system's knee.
    t_next = t_start
    i = 0
    while True:
        t_next += rng.expovariate(rate_req_per_s)
        if t_next >= window_end:
            break
        lag = t_next - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        t = threading.Thread(target=fire, args=(i,), daemon=True,
                             name=f"openloop-{label}-{i}")
        threads.append(t)
        t.start()
        i += 1
        beat()
    arrivals = len(threads)
    # Clamp the drain grace by the leg's budget deadline (floor 5 s so
    # hung-client detection still gets a real chance): without the
    # clamp, one wedged point spends up to JOIN_GRACE_S past its budget
    # share and eats the reserve the headline keeps for the phases after.
    grace = JOIN_GRACE_S
    if deadline is not None:
        grace = max(5.0, min(grace, deadline - time.monotonic()))
    join_deadline = time.monotonic() + grace
    for t in threads:
        t.join(timeout=max(0.0, join_deadline - time.monotonic()))
        beat()
    alive = [t for t in threads if t.is_alive()]
    hung = len(alive)
    if carry is not None:
        carry.extend(alive)
    wall_s = time.perf_counter() - t_start
    good = slo.good_total - g0
    observed = slo.observed_total - o0
    out: Dict[str, Any] = {}
    if prior_stragglers:
        # Stragglers from the previous point may have completed inside
        # this window and fed the SLO deltas — the attainment below is
        # contaminated and a knee read from it must be interpretable.
        out["prior_stragglers"] = prior_stragglers
    return {
        **out,
        "offered_req_per_s": round(arrivals / max(duration_s, 1e-9), 3),
        "arrivals": arrivals,
        "completed": completed[0],
        "http_errors": http_errors[0],
        "hung_clients": hung,
        "availability": (round(completed[0] / arrivals, 4)
                         if arrivals else None),
        "goodput_req_per_s": round(good / max(wall_s, 1e-9), 3),
        "slo_attainment": (round(good / observed, 4) if observed
                           else None),
        "p50_ms": _pct(latencies, 0.50),
        "p95_ms": _pct(latencies, 0.95),
        "wall_s": round(wall_s, 2),
    }


def _find_knee(sweep: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Knee = the highest swept offered rate whose SLO attainment is
    still ≥ KNEE_ATTAINMENT; ``goodput_at_knee`` is the goodput measured
    THERE.  When no point attains (the system is past its knee even at
    the lowest rate — or the SLO is simply too tight for the hardware),
    the max-goodput point is reported with a flag instead of silence."""
    holding = [p for p in sweep
               if (p.get("slo_attainment") or 0.0) >= KNEE_ATTAINMENT]
    if holding:
        knee = max(holding, key=lambda p: p["offered_req_per_s"])
        below = False
    elif sweep:
        knee = max(sweep, key=lambda p: p.get("goodput_req_per_s") or 0.0)
        below = True
    else:
        return {"knee_req_per_s": None, "goodput_at_knee": None,
                "slo_attainment_at_knee": None}
    out = {
        "knee_req_per_s": knee["offered_req_per_s"],
        "goodput_at_knee": knee["goodput_req_per_s"],
        "slo_attainment_at_knee": knee["slo_attainment"],
    }
    if below:
        out["slo_attainment_below_target_at_all_rates"] = True
    return out


def _sequential_rate(client, queries, strategy: str, beat,
                     n_cal: int = 3) -> float:
    """The base service rate the sweep starts from: ``n_cal`` sequential
    edge round trips on warm engines, in requests a second."""
    t0 = time.perf_counter()
    for i in range(n_cal):
        client.post("/chat", json={"message": queries[i]["query"],
                                   "strategy": strategy,
                                   "session_id": "ol-warm"})
        beat()
    return 1.0 / max((time.perf_counter() - t0) / n_cal, 1e-3)


def openloop_phase(strategies=("heuristic", "perf"),
                   budget_s: Optional[float] = None,
                   point_s: Optional[float] = None,
                   beat=lambda: None, device=None,
                   cluster=None) -> Dict[str, Any]:
    """The bench leg: per-strategy open-loop rate sweep, knee and goodput
    at the knee, then the overload epilogue on the first strategy, over
    ``cluster`` (default: the tiny batched cluster, seeded random
    weights) on ``device`` (default: the card).  Returns the artifact dict
    under the bench's ``openloop`` key; ``knee_req_per_s``,
    ``goodput_at_knee`` and per-strategy ``slo_attainment`` are the
    acceptance columns."""
    import sys

    from ..config import tiny_batched_cluster
    from ..obs import Observability
    from ..serving.app import create_app
    from ..serving.router import Router
    from .query_sets import query_sets

    print("[bench] open-loop SLO goodput leg", file=sys.stderr, flush=True)
    queries = query_sets["general_knowledge"]
    obs = Observability(slow_ms=None)
    cluster = cluster or tiny_batched_cluster()
    router = Router(strategy=strategies[0], benchmark_mode=True,
                    cluster=cluster, device=device, observability=obs)
    app = create_app(router=router)
    client = app.test_client()
    targets = router.slo.targets
    n, o = cluster.nano, cluster.orin
    out: Dict[str, Any] = {
        "config": f"{n.model_preset}(nano={n.decode_batch}), "
                  f"{o.model_preset}(orin={o.decode_batch}) on "
                  f"{router.device.type}, open-loop Poisson via the "
                  "in-process HTTP edge",
        "slo": {t: {"ttft_ms": tt, "tbt_ms": tb}
                for t, (tt, tb) in sorted(targets.items())},
        "session_pool": SESSION_POOL,
        "knee_rule": f"highest rate with attainment >= {KNEE_ATTAINMENT}",
    }
    deadline = (time.monotonic() + budget_s) if budget_s else None
    try:
        for tier in router.tiers.values():
            tier.server_manager.start_server()
            beat()
        # Calibrate the base service rate on warm engines: 3 sequential
        # edge round trips (the first also pays any remaining prefill
        # compile, so warm one untimed first).
        client.post("/chat", json={"message": queries[0]["query"],
                                   "strategy": strategies[0],
                                   "session_id": "ol-warm"})
        beat()
        base_rate = _sequential_rate(client, queries, strategies[0], beat)
        out["base_seq_req_per_s"] = round(base_rate, 3)

        # Point duration: fit strategies × (sweep + epilogue) into the
        # budget share, clamped to [MIN_POINT_S, MAX_POINT_S].  The
        # adaptive sweep usually stops well short of MAX_SWEEP_POINTS.
        n_points = len(strategies) * MAX_SWEEP_POINTS + 1
        if point_s is None:
            share = (budget_s if budget_s else 60.0)
            point_s = max(MIN_POINT_S,
                          min(MAX_POINT_S, 0.6 * share / n_points))
        out["point_s"] = round(point_s, 2)

        per_strategy: Dict[str, Any] = {}
        attainment: Dict[str, Any] = {}
        # One straggler carry for the WHOLE phase: threads a point left
        # running are absorbed before the next point's SLO baseline —
        # across strategies and into the epilogue too.
        carry: List[threading.Thread] = []
        for strategy in strategies:
            sweep: List[Dict[str, Any]] = []
            rate = max(0.2, base_rate * SWEEP_START_MULTIPLIER)
            crossed = False
            for _n in range(MAX_SWEEP_POINTS):
                if deadline is not None and (time.monotonic() + point_s
                                             > deadline):
                    sweep.append({"skipped": "budget exhausted before "
                                             f"the {rate:.0f}/s point"})
                    break
                point = _run_rate_point(
                    client, router, queries, strategy, rate, point_s,
                    label=f"{strategy}-{_n}", beat=beat,
                    deadline=deadline, carry=carry)
                sweep.append(point)
                beat()
                att = point.get("slo_attainment")
                if att is not None and att < KNEE_ATTAINMENT:
                    crossed = True       # past the knee — sweep done
                    break
                if rate >= MAX_RATE_REQ_PER_S:
                    break
                rate = min(MAX_RATE_REQ_PER_S, rate * 2.0)
            measured = [p for p in sweep if "offered_req_per_s" in p]
            knee = _find_knee(measured)
            if not crossed and measured:
                # Every swept rate held its SLO: the reported knee is a
                # LOWER BOUND on the real one, and the artifact must say
                # so rather than let a cross-round comparison read a
                # spawn-loop ceiling as a regression.
                knee["knee_is_lower_bound"] = True
            per_strategy[strategy] = {"sweep": sweep, **knee}
            attainment[strategy] = knee.get("slo_attainment_at_knee")
        out["per_strategy"] = per_strategy
        out["slo_attainment"] = attainment
        first = per_strategy.get(strategies[0], {})
        out["knee_req_per_s"] = first.get("knee_req_per_s")
        out["goodput_at_knee"] = first.get("goodput_at_knee")

        # -- overload epilogue: ≥2× the knee, graceful degradation -------
        knee_rate = out["knee_req_per_s"]
        if knee_rate and (deadline is None
                          or time.monotonic() + point_s <= deadline):
            incidents_before = router.slo.incidents_total
            point = _run_rate_point(
                client, router, queries, strategies[0],
                knee_rate * OVERLOAD_FACTOR, point_s,
                label="overload", beat=beat,
                deadline=deadline, carry=carry)
            incidents = router.slo.incidents_total - incidents_before
            recorded = [e for e in obs.recorder.snapshot()
                        if e.get("reason") == "overload"]
            with_timeline = sum(
                1 for e in recorded
                if (e.get("incident") or {}).get("timeline"))
            out["overload"] = {
                "offered_over_knee": OVERLOAD_FACTOR,
                **point,
                "incidents": incidents,
                "incidents_recorded": len(recorded),
                "incidents_with_timeline": with_timeline,
            }
        elif knee_rate:
            out["overload"] = {"skipped": "budget exhausted"}
    finally:
        try:
            router.drain(timeout_s=10.0)
        except Exception:
            for tier in router.tiers.values():
                tier.server_manager.stop_server()
    return out
