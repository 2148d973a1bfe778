"""The bench's fleet legs: ``chaos``, ``pressure``, ``replica`` and
``perf_steering``.

Counterparts of the root ``bench.py``'s ``chaos_phase`` (:753, with
``_mttr_s`` :734), ``pressure_phase`` (:874), ``replica_phase`` (:2274)
and ``perf_steering_phase`` (:3619), with their keys and verdicts, and of
``_chaos2_rescue_subcheck`` (:2951), which ``bench/elastic.py``'s
``chaos2_phase`` runs:

- ``chaos_phase``: closed-loop clients under a scripted nano flap schedule
  (utils/faults.py), once per routing strategy: availability, MTTR, p50
  TTFT under faults, the breaker's openings, degraded answers;
- ``pressure_phase``: closed-loop clients while the nano pool is starved
  of free blocks; a replay-identity check on a 5-block pool; a graceful
  drain epilogue;
- ``replica_phase``: one engine against two replicas of one tier (scaling,
  affinity against random dispatch, one ragged decode program per
  replica, outputs identical across counts and policies);
- ``perf_steering_phase``: a nano tier slowed by injected latency, perf
  routing with and without exploration.
- ``_chaos2_rescue_subcheck``: crash one of two replicas mid-decode and
  restart it: the rescued stream must equal an uninterrupted greedy run,
  and a prefix demoted to the host tier before the kill must promote warm
  on the rebuilt engine.

Each leg serves JAX's pinned tiny configuration by default; ``cluster``
(chaos) or ``tier`` (replica, the rescue sub-check) serves another, as
chip_smoke does at full width.  Each takes ``device`` as the port's other
legs do (``device="cpu"`` runs it standalone here).

On one card every replica shares the device, where JAX's leg gives each
its own host device.  ``single_device`` is then always true, and
``closed_loop_speedup`` measures how far one replica's host work overlaps
the other's device work: it is no scaling factor.  ``speedup_ok`` is
reported, not enforced, as in JAX.  Greedy outputs compared across modes
may flip at a near-tie in bf16 on the card: with ``tie_check`` (chip_smoke
passes its ``near_tie``) each flip is judged and listed under ``flips``,
and ``outputs_identical`` stays JAX's verdict.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import statistics
import sys
import threading
import time
from typing import Callable, Optional

from .headline import HISTORY_LIMIT
from .legs import _flips, _pct


def _mttr_s(timeline) -> Optional[float]:
    """Mean time to recovery over a request timeline [(t, available)]:
    the mean wall duration of contiguous UNAVAILABLE windows, from the
    first unanswered response to the next answered one (an unrecovered
    tail window counts up to the last sample).  None when no window
    opened."""
    spans, start = [], None
    timeline = sorted(timeline)
    for t, available in timeline:
        if not available and start is None:
            start = t
        elif available and start is not None:
            spans.append(t - start)
            start = None
    if start is not None and timeline:
        spans.append(timeline[-1][0] - start)
    return round(statistics.mean(spans), 3) if spans else None


def _answered(resp: dict) -> bool:
    """A request counts as answered when it returned ok or the documented
    degraded shape (breaker fail-fast with a retry hint, a degraded cache
    hit)."""
    return bool(resp.get("ok")) or bool(resp.get("degraded"))


def _closed_loop(router, n_clients: int, until: float, prompt, records,
                 errors, name: str) -> int:
    """``n_clients`` closed-loop clients sending ``prompt(i, turn)`` until
    ``until``; each answer appends (t, answered, ttft_ms) to ``records``.
    Returns the clients still alive after a 120 s join (hung)."""
    def client(i):
        turn = 0
        try:
            while time.monotonic() < until:
                resp, _, _dev = router.route_query(
                    [{"role": "user", "content": prompt(i, turn)}])
                raw = resp.get("raw")
                ttft = raw.get("ttft_ms") if isinstance(raw, dict) else None
                records.append((time.monotonic(), _answered(resp), ttft))
                turn += 1
        except Exception as exc:          # never lose the leg
            errors.append(repr(exc)[:80])

    # Daemons: a wedged client past the join deadline must not block the
    # interpreter's exit.
    threads = [threading.Thread(target=client, args=(i,),
                                name=f"{name}-{i}", daemon=True)
               for i in range(n_clients)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 120
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    return sum(1 for t in threads if t.is_alive())


def chaos_phase(device=None, strategies=("heuristic", "hybrid", "perf"),
                n_clients: int = 4, beat=lambda: None, cluster=None) -> dict:
    """The chaos-soak leg: concurrent closed-loop load under a scripted
    nano flap schedule (3 flaps, 1.0 s period, 0.45 s down; a 50 ms orin
    latency spike), once per routing strategy: **availability** (answered
    ok or degraded), **MTTR** (mean unavailable window; None = none
    opened), **p50 TTFT under faults**, errors, hung clients, breaker
    openings and degraded answers.  A fast breaker (threshold 2, cooldown
    0.4 s) lets the schedule exercise open, shed, half-open and close
    within seconds.  ``cluster``: default JAX's pinned tiny batched
    tiers (the leg measures the fault machinery, not model speed)."""
    from ..config import tiny_batched_cluster
    from ..serving.router import Router
    from ..utils.faults import FaultInjector

    print("[bench] chaos-soak leg", file=sys.stderr, flush=True)
    fi = FaultInjector()
    router = Router(strategy=strategies[0], benchmark_mode=True,
                    cluster=chaos_cluster(cluster or tiny_batched_cluster()),
                    fault_injector=fi, device=device)
    try:
        for tier in router.tiers.values():
            tier.server_manager.start_server()
            beat()
        return chaos_on(router, fi, strategies, n_clients, beat)
    finally:
        for tier in router.tiers.values():
            tier.server_manager.stop_server()


def chaos_cluster(cluster):
    """``cluster`` with the chaos leg's fast breaker: open after 2
    failures, half-open after 0.4 s."""
    return dataclasses.replace(cluster, breaker_failures=2,
                               breaker_cooldown_s=0.4)


def chaos_on(router, fi, strategies=("heuristic", "hybrid", "perf"),
             n_clients: int = 4, beat=lambda: None) -> dict:
    """The chaos leg's measurement on a started ``router`` (of a
    ``chaos_cluster``) whose tiers carry the injector ``fi``: two untimed
    warmup requests, then per strategy the flap schedule under
    ``n_clients`` closed-loop clients."""
    from ..utils.faults import FaultSchedule

    out: dict = {"schedule": "nano flaps 3x(1.0s period, 0.45s down) "
                             "+ orin latency spike 50ms",
                 "clients": n_clients, "device": str(router.device)}
    sched = None
    try:
        # Untimed warmup through the whole pipeline.
        for i in range(2):
            router.route_query(
                [{"role": "user",
                  "content": f"chaos client {i} turn 0: tell me about "
                             f"rivers and topic 0"}])
            beat()
        for strategy in strategies:
            # A fresh strategy object and closed breakers: each strategy
            # starts from the same slate.
            router.query_router.change_strategy(strategy)
            for name in router.tiers:
                router.breaker.reset(name)
            opened_before = dict(router.breaker.opened_total)
            degraded_before = router.degraded_served
            records: list = []       # (t, available, ttft_ms)
            errors: list = []
            sched = (FaultSchedule(fi)
                     .flaps("nano", n=3, period_s=1.0, down_s=0.45,
                            start_s=0.2)
                     .latency_spike("orin", 1.2, 1.8, seconds=0.05))
            until = time.monotonic() + sched.duration_s() + 0.4
            sched.start()
            hung = _closed_loop(
                router, n_clients, until,
                lambda i, turn: (f"chaos client {i} turn {turn}: tell me "
                                 f"about rivers and topic {turn % 5}"),
                records, errors, f"chaos-{strategy}")
            sched.stop()
            beat()
            n = len(records)
            ttfts = [x for _, _, x in records if x]
            out[strategy] = {
                "requests": n,
                "availability": round(sum(1 for _, a, _ in records if a)
                                      / n, 4) if n else 0.0,
                "mttr_s": _mttr_s([(t, a) for t, a, _ in records]),
                "p50_ttft_ms_under_faults": (
                    round(statistics.median(ttfts), 2) if ttfts else None),
                "errors": len(errors),
                "hung_clients": hung,
                "breaker_opened": (router.breaker.opened_total["nano"]
                                   - opened_before.get("nano", 0)),
                "degraded_served": router.degraded_served - degraded_before,
            }
    finally:
        if sched is not None:
            sched.stop()
    return out


def pressure_phase(device=None, n_clients: int = 4,
                   beat=lambda: None) -> dict:
    """The resource-pressure leg on the pinned tiny batched tiers: the
    closed-loop load while a scripted block-starvation schedule keeps
    confiscating the nano tier's free KV blocks (KV-aware admission sheds,
    the Router's failover answers on orin, slots that cannot grow are
    preempted).  Reports **availability**, **preemptions**, **KV admission
    rejects**, a **replay-identity** check (a preempted greedy request's
    text against its unpreempted run on a 2-slot, 5-block engine) and a
    **graceful-drain epilogue** (in-flight requests finish, none killed
    mid-stream, then admission refuses)."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine
    from ..serving.router import Router
    from ..utils.faults import FaultInjector, FaultSchedule

    print("[bench] resource-pressure leg", file=sys.stderr, flush=True)
    out: dict = {"clients": n_clients,
                 "schedule": "nano pool starved every 0.15s for 1.5s "
                             "(re-confiscating freed blocks)"}

    # -- replay identity (deterministic preemption on a tiny pool) --------
    tier = dataclasses.replace(tiny_batched_cluster().nano, decode_batch=2,
                               max_new_tokens=24)
    probe_a = "tell me about rivers and lakes and streams and oceans please"
    probe_b = "what is the tallest mountain on the continent of asia today"
    solo = ContinuousBatchingEngine(tier, seed=1, device=device)
    try:
        base_a = solo.generate(probe_a).text
        base_b = solo.generate(probe_b).text
    finally:
        solo.stop()
    beat()
    tight = ContinuousBatchingEngine(
        dataclasses.replace(tier, kv_pool_blocks=5,
                            enable_prefix_cache=False), seed=1,
        device=device)
    res: dict = {}
    try:
        threads = [threading.Thread(
            target=lambda k, q: res.__setitem__(k, tight.generate(q)),
            args=(k, q), daemon=True)
            for k, q in (("a", probe_a), ("b", probe_b))]
        threads[0].start()
        time.sleep(0.02)
        threads[1].start()
        for t in threads:
            t.join(timeout=120)
        identical = (res.get("a") is not None and res.get("b") is not None
                     and res["a"].text == base_a
                     and res["b"].text == base_b)
        out["replay_identity"] = {
            "preemptions": tight.preempted_total,
            "identical": bool(identical),
            "pool_freed": tight.allocator.available
            == tight.paged.num_blocks - 1,
        }
    finally:
        tight.stop()
    beat()

    # -- closed-loop load under starvation --------------------------------
    fi = FaultInjector()
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=tiny_batched_cluster(), fault_injector=fi,
                    device=device)
    sched = None
    try:
        for tc in router.tiers.values():
            tc.server_manager.start_server()
            beat()
        router.route_query([{"role": "user",
                             "content": "pressure warmup turn about "
                                        "rivers and mountains please"}])
        beat()
        nano_engine = router.nano.server_manager.engine()
        preempt_before = nano_engine.preempted_total
        kv_rej_before = router.nano.admission.kv_rejected
        sched = FaultSchedule(fi)
        # Re-starve every 150 ms: blocks freed by finishing slots or
        # prefix-cache evictions are confiscated again, so growth keeps
        # failing while the window is open and preemption must fire.
        for i in range(10):
            sched.starve_blocks(nano_engine.allocator,
                                0.3 + 0.15 * i, 0.3 + 0.15 * (i + 1) - 0.01,
                                10_000, tier="nano")
        until = time.monotonic() + sched.duration_s() + 0.4
        records: list = []
        errors: list = []
        sched.start()
        hung = _closed_loop(
            router, n_clients, until,
            lambda i, turn: (f"pressure client {i} turn {turn}: tell me "
                             f"about rivers and lakes and topic {turn % 5} "
                             f"please"),
            records, errors, "pressure")
        sched.stop()
        beat()
        n = len(records)
        out["load"] = {
            "requests": n,
            "availability": round(sum(1 for _, a, _ in records if a)
                                  / n, 4) if n else 0.0,
            "errors": len(errors),
            "hung_clients": hung,
            "preemptions": nano_engine.preempted_total - preempt_before,
            "kv_admission_rejected":
                router.nano.admission.kv_rejected - kv_rej_before,
        }

        # -- graceful-drain epilogue (SIGTERM semantics) ------------------
        drain_res: dict = {}

        def late(i):
            drain_res[i] = router.route_query(
                [{"role": "user",
                  "content": f"drain straggler {i}: one more question "
                             f"about rivers please"}])[0]

        stragglers = [threading.Thread(target=late, args=(i,), daemon=True)
                      for i in range(2)]
        for t in stragglers:
            t.start()
        time.sleep(0.05)                     # in flight when drain starts
        summary = router.drain(timeout_s=20.0)
        for t in stragglers:
            t.join(timeout=30)
        post = router.route_query([{"role": "user",
                                    "content": "after the drain"}])[0]
        out["drain"] = {
            "in_flight": len(stragglers),
            "finished_ok": sum(1 for r in drain_res.values()
                               if r.get("ok")),
            "mid_stream_kills": len(stragglers) - len(drain_res),
            "aborted": sum(int(s.get("aborted") or 0)
                           for s in summary.values()
                           if isinstance(s, dict)),
            "post_drain_rejected": not post.get("ok"),
        }
        beat()
    finally:
        if sched is not None:
            sched.stop()
        for tc in router.tiers.values():
            tc.server_manager.stop_server()
    return out


class _TokenLog:
    """The greedy token ids each replica engine produced, by prompt: the
    leg's requests go through the tier clients, whose answers carry text
    only, and a near-tie judgement needs the ids."""

    def __init__(self):
        self.ids: dict = {}
        self._lock = threading.Lock()

    def watch(self, engine) -> None:
        real = engine.generate

        def generate(history, *args, **kwargs):
            res = real(history, *args, **kwargs)
            if isinstance(history, str) and res is not None:
                with self._lock:
                    self.ids[history] = tuple(res.token_ids)
            return res
        engine.generate = generate


def replica_phase(device=None, n_clients: int = 12, n_requests: int = 48,
                  k_sessions: int = 8, beat=lambda: None, tier=None,
                  tie_check: Optional[Callable] = None) -> dict:
    """The replicated-tier leg: one tier served as ONE engine and as TWO
    replicas, at one seed.

    Part A, **scaling**: N closed-loop clients drain a shared prompt queue
    through the tier client, the two clients alternating rep by rep;
    ``closed_loop_speedup`` is the median paired ratio replicas=2 over
    replicas=1 (``speedup_ok``: at least 1.5, reported, not enforced).

    Part B, **affinity against dilution**: K sessions over one system
    prompt on the replicated tier under prefix-affinity dispatch and under
    forced RANDOM dispatch, against the one-engine reference: the prefix
    hits kept (``affinity_hit_retention``, ``random_hit_retention``) and
    the parked copies random dispatch duplicates
    (``dilution_resident_ratio``).

    HARD invariants (``error``): outputs identical across replica counts
    and policies, and one ragged decode program PER REPLICA (the engine's
    program set and the ``dllm_compiled_programs{tier="nano/rN"}`` gauge
    agreeing).  ``tier``: default JAX's pinned tiny nano (2 slots, 8
    decode steps a tick, buckets up to 128)."""
    from ..config import tiny_batched_cluster
    from ..engine.manager import EngineManager
    from ..obs import get_observability
    from ..serving.replicas import ReplicatedTierClient
    from ..serving.tiers import TierClient

    print("[bench] replicated-tier leg", file=sys.stderr, flush=True)
    base_cl = tiny_batched_cluster(nano_slots=2)
    base = tier or dataclasses.replace(base_cl.nano,
                                       decode_steps_per_tick=8,
                                       prefill_buckets=(16, 32, 64, 128))
    out: dict = {"n_clients": n_clients, "requests": n_requests,
                 "k_sessions": k_sessions,
                 "slots_per_replica": base.decode_batch,
                 # One device: the replicas share it (see the module note).
                 "single_device": True}
    tokens = _TokenLog()

    def build(r, prefix_cache=True):
        # The scaling clients run cache-off (a second pass over the same
        # prompts would measure the cache); the session clients keep it,
        # with room for every session's parked prefix.
        t = dataclasses.replace(base, replicas=r,
                                enable_prefix_cache=prefix_cache,
                                prefix_cache_entries=k_sessions + 2)
        if r == 1:
            client = TierClient(t, EngineManager(t, seed=base_cl.seed,
                                                 device=device))
        else:
            client = ReplicatedTierClient(
                t, dataclasses.replace(base_cl, nano=t), device=device,
                seed=base_cl.seed)
        client.server_manager.start_server()
        for eng in engines(client):
            tokens.watch(eng)
        beat()
        return client

    def engines(client):
        mgr = client.server_manager
        return ([e for _, e in mgr.live_engines()]
                if hasattr(mgr, "live_engines") else [mgr.engine()])

    def closed_loop(client, prompts):
        q: "queue_mod.Queue" = queue_mod.Queue()
        for i, p in enumerate(prompts):
            q.put((i, p))
        results: list = [None] * len(prompts)

        def worker():
            while True:
                try:
                    i, p = q.get_nowait()
                except queue_mod.Empty:
                    return
                results[i] = client.process(p)

        t0 = time.perf_counter()
        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_clients)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        wall = time.perf_counter() - t0
        beat()
        return results, wall

    prompts = [f"q{i} rivers?" for i in range(n_requests)]
    prefix = ("system: you are a concise geography assistant for rivers "
              "lakes mountains oceans deltas streams glaciers valleys. "
              "answer with one short sentence. " * 2)
    session_prompts = [prefix + f" user: question {i}?"
                       for i in range(k_sessions)]
    # Same-bucket filler sharing no prefix: warms each replica's long
    # prompt programs, so the random policy's dilution measures cold
    # prefill, not a first capture.
    warm_filler = ("system: unrelated warm filler about astronomy stars "
                   "planets comets orbits telescopes eclipses novas. "
                   "answer with one short sentence. " * 2)

    def run_sessions(client):
        """Park the shared prefix, then the K sessions one by one (a
        concurrent burst would measure queueing, not cache warmth)."""
        engs = engines(client)
        for eng in engs:
            eng.generate(warm_filler)
            beat()
        client.process(prefix)              # park the shared prefix
        before = [e.prefix_cache.stats() for e in engs]
        results = [client.process(p) for p in session_prompts]
        beat()
        after = [e.prefix_cache.stats() for e in engs]
        hits = sum((a["hits_shared"] + a["hits_exclusive"])
                   - (b["hits_shared"] + b["hits_exclusive"])
                   for a, b in zip(after, before))
        ttfts = sorted(r.get("ttft_ms") for r in results
                       if isinstance(r, dict) and r.get("ttft_ms"))
        resident = sum(int(st["total_blocks"]) - int(st["free_blocks"])
                       for st in (e.kv_stats() for e in engs))
        return {
            "prefix_hits": hits,
            "hit_rate": round(hits / max(1, k_sessions), 3),
            "warm_ttft_p50_ms": _pct(ttfts, 0.50),
            "ttft_max_ms": round(ttfts[-1], 2) if ttfts else None,
            "resident_blocks_after": resident,
            "errors": sum(1 for r in results
                          if not (isinstance(r, dict) and "response" in r)),
            "outputs": [r.get("response") if isinstance(r, dict) else None
                        for r in results],
        }

    texts: dict = {}
    ids: dict = {}
    repeats = 3
    # ---- Part A, interleaved: the paired ratios cancel drift.
    client1 = build(1, prefix_cache=False)
    client2 = build(2, prefix_cache=False)
    try:
        for warm_client in (client1, client2):
            closed_loop(warm_client, prompts)
        rates: dict = {"r1": [], "r2": []}
        errors: dict = {"r1": 0, "r2": 0}
        ratios: list = []
        for rep in range(repeats):
            per_rep: dict = {}
            for key, client in (("r1", client1), ("r2", client2)):
                tokens.ids.clear()
                res, wall = closed_loop(client, prompts)
                t_key = f"scale_{key}"
                got = [r.get("response") if isinstance(r, dict) else None
                       for r in res]
                if rep == 0:
                    texts[t_key] = got
                    ids[t_key] = [tokens.ids.get(p) for p in prompts]
                elif texts.get(t_key) != got:
                    texts[t_key] = None     # cross-rep divergence
                rate = round(len(prompts) / max(wall, 1e-9), 3)
                rates[key].append(rate)
                per_rep[key] = rate
                errors[key] += sum(1 for r in res
                                   if not (isinstance(r, dict)
                                           and "response" in r))
            ratios.append(per_rep["r2"] / max(per_rep["r1"], 1e-9))
        for key in ("r1", "r2"):
            out[key] = {"req_per_s": statistics.median(rates[key]),
                        "req_per_s_all": rates[key],
                        "errors": errors[key]}
        out["closed_loop_speedup"] = round(statistics.median(ratios), 3)
        out["closed_loop_speedup_all"] = [round(x, 3) for x in ratios]
    finally:
        client1.server_manager.stop_server()
        client2.server_manager.stop_server()

    # ---- Part B: fresh cache-on clients per policy.
    client1 = build(1)
    try:
        tokens.ids.clear()
        ref = run_sessions(client1)
        ids["sess_r1"] = [tokens.ids.get(p) for p in session_prompts]
        texts["sess_r1"] = ref.pop("outputs")
        out["sessions_r1"] = ref
    finally:
        client1.server_manager.stop_server()

    client2 = build(2)
    try:
        tokens.ids.clear()
        aff = run_sessions(client2)
        ids["sess_affinity"] = [tokens.ids.get(p) for p in session_prompts]
        texts["sess_affinity"] = aff.pop("outputs")
        out["sessions_affinity"] = aff

        # One ragged decode program per replica, and the per-replica gauge
        # agreeing.
        programs: dict = {}
        for key, eng in client2.server_manager.live_engines():
            programs[key] = {
                "compiled": len(eng._compiled.get("decode", ())),
                "gauge": get_observability().m.compiled_programs.labels(
                    eng.tier.name, "decode").value}
        out["decode_programs_per_replica"] = programs
        out["attention_ragged"] = bool(client2.tier.attention_ragged)
        if out["attention_ragged"] and any(
                p["compiled"] != 1 or (p["gauge"] is not None
                                       and p["gauge"] != 1.0)
                for p in programs.values()):
            out["error"] = (f"ragged replicas minted != 1 decode program "
                            f"each: {programs}")

        # replicas=2 under forced RANDOM dispatch, on fresh engines.
        client2.server_manager.stop_server()
        client2.server_manager.start_server()
        for eng in engines(client2):
            tokens.watch(eng)
        client2.policy = "random"
        tokens.ids.clear()
        rnd = run_sessions(client2)
        ids["sess_random"] = [tokens.ids.get(p) for p in session_prompts]
        texts["sess_random"] = rnd.pop("outputs")
        out["sessions_random"] = rnd
    finally:
        client2.server_manager.stop_server()

    if out.get("closed_loop_speedup") is not None:
        out["speedup_ok"] = out["closed_loop_speedup"] >= 1.5
    ref_hits = out.get("sessions_r1", {}).get("prefix_hits")
    aff_hits = out.get("sessions_affinity", {}).get("prefix_hits")
    rnd_hits = out.get("sessions_random", {}).get("prefix_hits")
    if ref_hits:
        if aff_hits is not None:
            out["affinity_hit_retention"] = round(aff_hits / ref_hits, 3)
        if rnd_hits is not None:
            out["random_hit_retention"] = round(rnd_hits / ref_hits, 3)
    aff_s = out.get("sessions_affinity") or {}
    rnd_s = out.get("sessions_random") or {}
    if aff_s.get("resident_blocks_after") \
            and rnd_s.get("resident_blocks_after"):
        out["dilution_resident_ratio"] = round(
            rnd_s["resident_blocks_after"]
            / aff_s["resident_blocks_after"], 3)

    # HARD invariant: replica count and dispatch policy move WHERE a
    # request runs, never WHAT it answers.
    ident_scale = (texts.get("scale_r1") == texts.get("scale_r2")
                   and None not in (texts.get("scale_r1") or [None]))
    ident_sess = (texts.get("sess_r1") == texts.get("sess_affinity")
                  == texts.get("sess_random")
                  and None not in (texts.get("sess_r1") or [None]))
    out["outputs_identical"] = bool(ident_scale and ident_sess)
    if not out["outputs_identical"] and tie_check is not None:
        flips = []
        for ref_key, keys, ps in (("scale_r1", ("scale_r2",), prompts),
                                  ("sess_r1", ("sess_affinity",
                                               "sess_random"),
                                   session_prompts)):
            for key in keys:
                want, got = ids.get(ref_key) or [], ids.get(key) or []
                if len(want) != len(ps) or len(got) != len(ps) \
                        or None in want or None in got:
                    flips.append({"mode": key, "near_tie": False,
                                  "error": "token ids missing"})
                    continue
                for f in _flips(base, ps, want, got, tie_check,
                                base_cl.seed, device):
                    flips.append({"mode": key, **f})
        out["flips"] = flips
    near_ties = bool(out.get("flips")) and all(f.get("near_tie")
                                               for f in out["flips"])
    if not out["outputs_identical"] and not near_ties \
            and "error" not in out:
        out["error"] = ("replicated outputs diverged from the "
                        "single-engine path (scale identical: "
                        f"{ident_scale}, sessions identical: "
                        f"{ident_sess})")
    return out


def _chaos2_rescue_subcheck(base_cl, tier, beat=lambda: None, device=None,
                            tie_check: Optional[Callable] = None) -> dict:
    """The crash-rescue identity check: a 2-replica client crashes r0
    mid-decode with a request in flight; ``restart_replica`` captures it
    and the SIBLING resumes it.  The whole emitted stream must equal an
    uninterrupted greedy run (the stream stalls through the rescue, never
    errors, never re-emits).  A prefix demoted to r0's host tier before
    the kill must survive the restart attached to the NEW engine and
    serve a warm promotion (``warm_hit``), not a cold prefill.  With
    ``tie_check`` a divergence is judged (``flip``) instead of failing
    outright."""
    from ..engine.inference import trim_at_eos
    from ..engine.paged_kv import pool_block_bytes
    from ..serving.replicas import ReplicatedTierClient
    from ..utils.faults import crash_replica_engine

    blk = pool_block_bytes(tier.model(), tier.kv_block_size,
                           tier.kv_quantize)
    s_tier = dataclasses.replace(
        tier, replicas=2, enable_prefix_cache=True,
        prefix_cache_entries=8,
        # JAX's 16 on its 16-token blocks: one block a chunk.
        prefill_chunk_tokens=tier.kv_block_size,
        host_kv_bytes=blk * 64, max_new_tokens=32)
    warm_prompt = "session warm tell me about rivers in one sentence"
    live_prompt = "session live tell me about mountains in one sentence"
    out: dict = {}
    client = ReplicatedTierClient(
        s_tier, dataclasses.replace(base_cl, nano=s_tier), device=device,
        seed=base_cl.seed, warmup_on_start=False)
    try:
        client.server_manager.start_server()
        beat()
        victim = next(r for r in client._members if r.rid == 0)
        sibling = next(r for r in client._members if r.rid == 1)
        eng = victim.mgr._engine
        ref = sibling.mgr._engine.generate(live_prompt, temperature=0.0)
        beat()
        # Park, then demote, the warm prompt's prefix on the victim, so
        # the kill also tests the spill store's survival.
        first = eng.generate(warm_prompt, temperature=0.0)
        while eng.prefix_cache.pop_oldest() is not None:
            pass
        eng.kv_spill.flush(10.0)
        spill = eng.kv_spill
        promos_before = spill.stats()["promotions_total"]
        # Crash once the first token is out (the slot decodes).
        q: "queue_mod.Queue" = queue_mod.Queue()
        req = eng.submit(live_prompt, temperature=0.0, token_queue=q)
        got = [q.get(timeout=60.0)]
        crash_replica_engine(eng)
        t0 = time.monotonic()
        summary = client.restart_replica(0, reason="chaos2 subcheck")
        out["rescue_ms"] = round((time.monotonic() - t0) * 1000.0, 1)
        beat()
        out["outcome"] = summary.get("outcome")
        out["rescued"] = summary.get("rescued")
        out["spill_reattached"] = bool(summary.get("spill_reattached"))
        if not req.done.wait(timeout=120.0):
            out["error"] = "rescued request never completed"
            return out
        if req.error is not None:
            out["error"] = f"rescued request errored: {req.error!r}"[:200]
            return out
        full = list(got)
        while True:
            tok = q.get(timeout=30.0)
            if tok is None:
                break
            full.append(tok)
        # The stream carries the EOS the engine emitted, as its last
        # token; the results' token ids stop before it.
        tk = sibling.mgr._engine.tokenizer
        raw, full = full, trim_at_eos(full, tk.eos_id, tk.pad_id)
        want = list(ref.token_ids)
        out["identical"] = (full == want and len(raw) - len(full) <= 1
                            and list(req.result.token_ids) == want)
        if not out["identical"]:
            res_ids = list(req.result.token_ids)
            out["diverged"] = {
                "at": next((i for i, (a, b) in enumerate(zip(full, want))
                            if a != b), min(len(full), len(want))),
                "stream_len": len(full), "result_len": len(res_ids),
                "want_len": len(want), "stream_is_result": full == res_ids}
            flip = None
            if tie_check is not None and full == res_ids:
                flip = tie_check(sibling.mgr._engine,
                                 sibling.mgr._engine.affinity_token_ids(
                                     live_prompt), want, full)
                out["flip"] = flip
            if not (flip and flip.get("near_tie")):
                out["error"] = ("rescued stream diverged from the "
                                "uninterrupted greedy reference")
                return out
        # Warm promotion on the REBUILT engine through the survived store.
        new_eng = victim.mgr._engine
        out["spill_survived"] = new_eng.kv_spill is spill
        second = new_eng.generate(warm_prompt, temperature=0.0)
        beat()
        out["warm_identical"] = (list(second.token_ids)
                                 == list(first.token_ids))
        out["warm_hit"] = (spill.stats()["promotions_total"]
                           > promos_before)
        if not out["warm_hit"]:
            out["error"] = ("restart cost a cold prefill: no host "
                            "promotion after spill re-attach")
        elif not out["warm_identical"]:
            out["error"] = "warm promotion changed the answer"
    finally:
        client.server_manager.stop_server()
    return out


def perf_steering_phase(device=None, injected_latency_s: float = 0.20,
                        beat=lambda: None) -> dict:
    """Production perf exploration paying under a load asymmetry: the nano
    tier is slowed by ``injected_latency_s`` on every request
    (``FaultInjector.add_latency``), so orin is the better destination for
    every query.  A perf router that never explores (the reference's
    semantics) never samples orin and stays pinned to nano; with
    PRODUCTION_CFG's exploration its staleness probes sample orin and the
    warmed pass routes there.  Cold and warmed orin share and mean latency
    per mode on the trained tiny sequential tiers (routing dynamics, not
    model speed); ``accuracy_better_tier`` is the share routed to orin."""
    from ..config import (BENCHMARK_CFG, PRODUCTION_CFG, tiny_cluster,
                          with_default_checkpoints)
    from ..serving.router import Router
    from ..utils.faults import FaultInjector
    from .query_sets import query_sets

    queries = [q["query"] for q in query_sets["general_knowledge"]]
    out: dict = {"degraded_tier": "nano",
                 "injected_latency_ms": round(injected_latency_s * 1000)}
    faults = FaultInjector()
    faults.add_latency("nano", injected_latency_s)
    router = Router(strategy="perf", benchmark_mode=True,
                    config=dict(BENCHMARK_CFG),
                    cluster=with_default_checkpoints(tiny_cluster()),
                    fault_injector=faults, device=device)
    try:
        # Both engines warm before any timed pass: the control mode never
        # touches orin.
        for tier in router.tiers.values():
            tier.server_manager.start_server()
            beat()
        for mode in ("control", "explore"):
            print(f"[bench] perf steering ({mode})", file=sys.stderr,
                  flush=True)
            router.query_router.config["perf_explore"] = (
                bool(PRODUCTION_CFG.get("perf_explore", True))
                if mode == "explore" else False)
            router.query_router.config["perf_explore_interval"] = 8
            # A fresh PerfStrategy (an empty window) per mode.
            router.query_router.change_strategy("perf")
            passes = {}
            for pname in ("cold", "warmed"):
                lats, orin_n = [], 0
                hist: list = []
                for q in queries:
                    hist.append({"role": "user", "content": q})
                    t0 = time.perf_counter()
                    resp, _, dev = router.route_query(hist[-HISTORY_LIMIT:])
                    lats.append((time.perf_counter() - t0) * 1000.0)
                    beat()
                    hist.append({"role": "assistant",
                                 "content": resp.get("response", "")})
                    if dev == "orin":
                        orin_n += 1
                passes[pname] = {
                    "orin_share": round(orin_n / len(queries), 3),
                    "accuracy_better_tier": round(orin_n / len(queries), 3),
                    "mean_latency_ms": round(statistics.mean(lats), 1),
                }
            out[mode] = passes
    finally:
        for tier in router.tiers.values():
            tier.server_manager.stop_server()
    exp, ctl = out["explore"], out["control"]
    out["verdict"] = {
        "warmed_accuracy": exp["warmed"]["accuracy_better_tier"],
        "cold_start_accuracy": exp["cold"]["accuracy_better_tier"],
        "control_warmed_accuracy": ctl["warmed"]["accuracy_better_tier"],
        "exploration_pays": bool(
            exp["warmed"]["accuracy_better_tier"]
            > exp["cold"]["accuracy_better_tier"]
            and exp["warmed"]["accuracy_better_tier"]
            > ctl["warmed"]["accuracy_better_tier"]
            and exp["warmed"]["mean_latency_ms"]
            < ctl["warmed"]["mean_latency_ms"]),
    }
    return out
