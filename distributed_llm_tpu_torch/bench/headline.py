"""Headline benchmark: req/s and p50 TTFT per routing strategy.

Counterpart of the root ``bench.py`` headline of the JAX package, with
its JSON keys.  It serves the labeled ``general_knowledge`` query set
(multi-turn, like the reference harness
src/tests/routing_chatbot_tester.py) through the full ``Router``
pipeline (routing decision, tier dispatch onto the engines, failover,
perf feedback) under all five strategies:

    python -m distributed_llm_tpu_torch.bench               # on the card
    python -m distributed_llm_tpu_torch.bench --device cpu  # tiny tiers

On the card it serves ``config.bench_cluster()`` (nano_1b and orin_8b),
on the CPU ``tiny_batched_cluster()`` (``serving.router.default_cluster``).
With no card and no ``--device cpu`` it raises: there is no fallback.

The sweep (``run``): calibrate one query's cost on the warm engines and
fit the repeats (and, under a tight budget, the query count) into 45% of
the wall-clock budget; then per repeat, per strategy, a sequential leg
scored for routing accuracy (for ``perf`` after a labeled warm pass under
production exploration semantics), and a concurrent leg of N closed-loop
clients, with the tiers' prefix caches cleared between repeats.  It
yields ``per_strategy``, the headline ``value`` (the concurrent req/s
median, metric ``req_per_s_general_knowledge_concurrent``) against the
reference's 0.0109 req/s (``vs_baseline``), its spread, both legs' p50
TTFT, routing accuracy, ``utilization`` (prefill and decode MFU and
device-memory utilization against the card's peaks, from the engines'
phase timers and roofline work) and ``tiers`` (each engine's stats).
Each strategy also carries the trace-derived columns read from the
sweep router's own metric registry (``_trace_quantiles``:
``trace_p50/p95_ttft_ms``, ``trace_p50/p95_tbt_ms`` and their counts).
Then the later sections: ``trend`` (the pinned tiny cluster, heuristic,
4 clients, median of 5), ``long_context`` and ``orin_prefix`` (prefix
reuse on the orin tier), ``continuous_batching`` (one batched nano engine,
concurrent against sequential, and its int8-KV leg), ``profile`` (the
tick-phase profiler over the tiny batched cluster: its per-phase
self-time table, coverage, attribution conservation, the cost ledger's
head and a Chrome-trace artifact, ``BENCH_profile_trace.json``), ``spill``
(the host KV spill tier on the tiny nano tier with a 20-block pool: 16
sessions populated then revisited with the spill OFF and at a small and
a large host budget; ``warm_hit_rate`` per mode, the co-tenant's
``tbt_ratio``, identity across modes and the promotion-race sub-check), the
features legs ``speculative`` (the orin tier speculating with the nano
model as its draft: acceptance and decode tok/s against plain greedy)
and ``quant`` (each tier's decode tok/s with bf16 weights, int8 weights,
and int8 weights with int8 KV), and ``flagship`` (``flagship_cluster``:
nano_1b and orin_8b with int8 weights on the sequential engine, each
budgeted, with decode tok/s, p50 TTFT, prefill MFU, decode ``hbm_util``
and nano's long-context leg; on the card only, unless ``--flagship``),
then ``spec_multiturn`` (the orin tier's follow-up TTFT on the plain and
the speculative sequential engine, and the speculative one's cost).
A later section
that raises records ``{"error": ...}`` and the headline survives, but
the process exits 1; the sweep itself catches nothing.

The full result goes to stdout as one JSON line (and to
``BENCH_partial.json``, rewritten after every section); the LAST line is
always ``compact(result)``, reprinted after every section, and printed
best-so-far on SIGTERM or when the watchdog sees no progress.

The JAX package's environment knobs are flags here: ``--budget-s``
(1200), ``--repeats`` (3), ``--clients`` (4), ``--watchdog-s`` (900),
``--flagship`` (``DLLM_BENCH_FLAGSHIP``: run the flagship section on the
CPU too, at its full 1B and 8B sizes), ``--host-kv-bytes``
(``DLLM_HOST_KV_BYTES``, for the sweep cluster's tiers).

Not here, each waiting for the feature it measures (ROADMAP.md A1): the
chaos legs (``chaos``, ``chaos2``: fault injection, replicas, rescue),
``pressure`` (its load half runs on the fault injector's block starver),
``noisy`` (tenants),
``skew`` (the dense-tick A/B leg), ``spec_phase`` (the batched
speculative leg), ``mixed`` (chunked-prefill stall
accounting), ``shared`` (sharing counters),
``replica``, ``elastic`` (replicas, the autoscaler), ``multichip``
(tensor parallelism), ``openloop`` (the open-loop driver),
``tier_quality`` (trained checkpoints), ``perf_steering`` (fault
injection) and ``dispatch_provenance`` / ``hw_dispatch`` (the port has no
dispatch table).  Nor the JAX bench's accelerator probe, its fall-back to
the CPU or its kernel dispatch A/B.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# Reference throughput on the same query set: the reference serves
# general_knowledge in 922.2 s (nano) + 176.0 s (orin) at ctx-threshold
# 100, 12 queries / 1098.2 s.
BASELINE_REQ_PER_S = 12 / (922.2 + 176.0)
METRIC = "req_per_s_general_knowledge_concurrent"
STRATEGIES = ("token", "semantic", "heuristic", "hybrid", "perf")
HISTORY_LIMIT = 10


class Budget:
    """Wall-clock budget for the whole run: the sweep scales its repeats
    and query count to fit its 45% share, and each later section is
    skipped with a stamped reason once the budget runs dry."""

    def __init__(self, total_s: float = 1200.0):
        self.total_s = total_s
        self.t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.t0

    def left(self) -> float:
        return self.total_s - self.elapsed()

    def allows(self, est_s: float) -> bool:
        return self.left() > est_s

    def skip_stamp(self) -> str:
        return (f"wall-clock budget exhausted "
                f"({self.left():.0f}s of {self.total_s:.0f}s left)")


class Progress:
    """Progress and partial results: every completed section is written to
    ``partial_path`` at once, and ``beat()`` marks liveness for the
    watchdog (``start_watchdog``)."""

    def __init__(self, partial_path: str = "BENCH_partial.json"):
        self.partial_path = partial_path
        self.data: dict = {}
        self._lock = threading.Lock()
        self._beat = time.monotonic()
        self.done = threading.Event()
        # The last compact line printed, read lock-free by the SIGTERM
        # handler (which may interrupt a thread holding the lock).
        self.last_compact: Optional[str] = None

    def beat(self) -> None:
        self._beat = time.monotonic()

    def idle_s(self) -> float:
        return time.monotonic() - self._beat

    def _write_partial(self, payload: dict) -> None:
        # Atomic write-then-replace; the caller holds the lock.
        tmp = self.partial_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.partial_path)
        except OSError:
            pass

    def section(self, name: str, value) -> None:
        with self._lock:
            self.data[name] = value
            self._write_partial(self.data)
        self.beat()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.data)

    def finalize(self, result: dict) -> None:
        """Rewrite the partial with the completed result and
        ``"final": true``, so a leftover partial of an interrupted run is
        told apart from a finished one."""
        with self._lock:
            self._write_partial(dict(result, final=True))

    def flush_compact(self) -> None:
        """(Re)print the compact line from the sections so far: the last
        stdout line stays a parseable result wherever the run stops."""
        snap = self.snapshot()
        snap.setdefault("metric", METRIC)
        snap.setdefault("value", 0.0)
        snap.setdefault("unit", "req/s")
        snap.setdefault("vs_baseline", 0.0)
        line = json.dumps(compact(snap))
        self.last_compact = line
        print(line, flush=True)


def _iqr(values) -> float:
    """Interquartile range: the spread reported beside medians."""
    q = statistics.quantiles(values, n=4, method="inclusive")
    return q[2] - q[0]


def _aggregate_strategy(records, ttfts) -> dict:
    """Cross-repeat per-strategy aggregates: every number is a median over
    the completed repeats (with IQR for the rate).  ``req_per_s`` is the
    concurrent (N-client closed-loop) rate, the sequential leg's beside
    it."""
    def med(key):
        vals = [r.get(key) for r in records]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    conc = med("concurrent_req_per_s")
    seq = med("sequential_req_per_s")
    out = {
        "req_per_s": round(conc if conc is not None else seq, 4),
        "sequential_req_per_s": (round(seq, 4) if seq is not None
                                 else None),
        "p50_ttft_ms": (round(statistics.median(ttfts), 2)
                        if ttfts else None),
        "concurrent_p50_ttft_ms": med("concurrent_p50_ttft_ms"),
        "routing_accuracy": round(med("routing_accuracy"), 3),
        "orin_queries": round(med("orin_queries")),
        "repeats": len(records),
    }
    if conc is not None and seq:
        out["concurrent_speedup"] = round(conc / seq, 2)
    # Failed requests complete fast: the count travels with the rate.
    errs = sum(r.get("concurrent_errors") or 0 for r in records)
    if errs:
        out["concurrent_errors"] = errs
    conc_vals = [r["concurrent_req_per_s"] for r in records
                 if r.get("concurrent_req_per_s") is not None]
    if len(conc_vals) > 1:
        out["req_per_s_iqr"] = round(_iqr(conc_vals), 4)
    cold = med("cold_start_accuracy")
    if cold is not None:
        out["cold_start_accuracy"] = round(cold, 3)
        out["warmed_accuracy"] = out["routing_accuracy"]
        out["explore"] = records[-1]["explore"]
    return out


def compact(result: dict) -> dict:
    """The last printed line, sized for a tail capture: the headline, the
    per-strategy table, the roofline verdicts and one number per later
    section.  The full detail is on an earlier line and in the partial."""
    keep = ("metric", "value", "unit", "vs_baseline", "p50_ttft_ms",
            "p50_latency_ms", "routing_accuracy", "decode_tok_per_s",
            "backend", "queries", "mfu_prefill", "hbm_util_decode",
            "aborted", "cluster", "sequential_req_per_s",
            "concurrent_speedup", "concurrent_p50_ttft_ms",
            "sequential_p50_ttft_ms", "concurrent_errors", "trend_req_per_s")
    out = {k: result[k] for k in keep if result.get(k) is not None}
    trend = result.get("trend")
    if isinstance(trend, dict) and trend.get("trend_req_per_s") is not None:
        out["trend"] = {"median": trend.get("trend_req_per_s"),
                        "iqr": trend.get("trend_iqr"),
                        "n": trend.get("repeats")}
    stats = result.get("req_per_s_stats")
    if isinstance(stats, dict):
        out["req_per_s_stats"] = {k: stats.get(k)
                                  for k in ("n", "median", "iqr")}
    bud = result.get("budget")
    if isinstance(bud, dict):
        out["budget"] = {"budget_s": bud.get("budget_s"),
                         "repeats": bud.get("repeats"),
                         "scaled": bool(bud.get("scaled"))}
    pf = result.get("profile")
    if isinstance(pf, dict) and not pf.get("skipped"):
        # One number each: the worst tier's phase coverage (>= 0.95), the
        # attribution-conservation ratio (~1.0), the first profiled
        # tier's decode and emit p50s and the trace's event count.
        tiers_pf = pf.get("tiers") or {}
        first = next(iter(tiers_pf.values()), {}) if tiers_pf else {}
        phases = first.get("phases") or {}
        cm = {k: v for k, v in {
            "cov": pf.get("coverage"),
            "attr": pf.get("attribution_ratio"),
            "ticks": first.get("ticks"),
            "decode_p50": (phases.get("decode") or {}).get("p50_ms"),
            "emit_p50": (phases.get("emit") or {}).get("p50_ms"),
            "events": pf.get("trace_events"),
            "err": (pf.get("error") or "")[:80] or None,
        }.items() if v is not None}
        if cm:
            out["profile"] = cm
    sp = result.get("spill")
    if isinstance(sp, dict) and not sp.get("skipped"):
        # One number each: the large-budget warm-hit rate with OFF and
        # small beside it, the monotonicity verdict, the co-tenant TBT
        # ratio, the large budget's promotions and demotions, revisit
        # TTFT p50 ON and OFF, the race sub-check and the identity verdict.
        lg, sm, off = (sp.get("large") or {}, sp.get("small") or {},
                       sp.get("off") or {})
        cm = {k: v for k, v in {
            "warm_hit_rate": sp.get("warm_hit_rate"),
            "hit_off": off.get("warm_hit_rate"),
            "hit_small": sm.get("warm_hit_rate"),
            "monotone": sp.get("hit_rate_monotone"),
            "tbt_ratio": sp.get("tbt_ratio"),
            "promotions": lg.get("promotions"),
            "demotions": lg.get("demotions_total"),
            "ttft50_on": lg.get("revisit_ttft_p50_ms"),
            "ttft50_off": off.get("revisit_ttft_p50_ms"),
            "race_observed": (sp.get("race") or {}).get("observed"),
            "ident": sp.get("outputs_identical"),
            "err": (sp.get("error") or "")[:80] or None,
        }.items() if v is not None}
        if cm:
            out["spill"] = cm
    strategies = result.get("per_strategy")
    if isinstance(strategies, dict):
        # t50/t95: trace-derived p50/p95 TTFT, tbt50: trace-derived p50
        # time between tokens (the registry's histograms).
        out["per_strategy"] = {
            name: {k: v for k, v in {
                "req_per_s": entry.get("req_per_s"),
                "spd": entry.get("concurrent_speedup"),
                "acc": entry.get("routing_accuracy"),
                "t50": entry.get("trace_p50_ttft_ms"),
                "t95": entry.get("trace_p95_ttft_ms"),
                "tbt50": entry.get("trace_p50_tbt_ms"),
            }.items() if v is not None}
            for name, entry in strategies.items()
            if isinstance(entry, dict)}
    util = result.get("utilization") or {}
    for key, ph, field in (("mfu_prefill", "prefill", "mfu"),
                           ("hbm_util_decode", "decode", "hbm_util")):
        if out.get(key) is None:
            val = (util.get(ph) or {}).get(field)
            if val is not None:
                out[key] = val
    bat = result.get("continuous_batching") or {}
    verdicts = {
        "batching_speedup": bat.get("batching_speedup"),
        "kv_int8_speedup": (bat.get("kv_int8") or {}).get(
            "speedup_vs_bf16_kv"),
        "spec_speedup": (result.get("speculative") or {}).get("speedup"),
        "quant_speedup": {t: q.get("speedup")
                          for t, q in (result.get("quant") or {}).items()
                          if isinstance(q, dict) and q.get("speedup")},
        "prefix_reuse_speedup": (result.get("long_context") or {}).get(
            "prefix_reuse_speedup"),
        "orin_prefix_hits": (result.get("orin_prefix") or {}).get(
            "prefix_hits"),
        "orin_followup_ttft_speedup": (result.get("orin_prefix") or {}).get(
            "followup_ttft_speedup"),
        "flagship_decode_tok_per_s": {
            t: f.get("decode_tok_per_s")
            for t, f in (result.get("flagship") or {}).items()
            if isinstance(f, dict) and f.get("decode_tok_per_s")},
        "spec_followup_ttft_cost": (result.get("spec_multiturn") or {}).get(
            "spec_followup_ttft_cost"),
    }
    out["verdicts"] = {k: v for k, v in verdicts.items() if v}
    return out


def section_errors(result: dict) -> List[str]:
    """Where ``result`` holds an ``error`` key, as dotted paths."""
    found: List[str] = []

    def walk(node, path):
        if isinstance(node, dict):
            if "error" in node:
                found.append(path or "<root>")
            for key, val in node.items():
                walk(val, f"{path}.{key}" if path else key)

    walk(result, "")
    return found


def start_watchdog(progress: Progress, timeout_s: float) -> threading.Thread:
    """Print the partial result and its compact line and exit 3 when no
    progress was marked for ``timeout_s``: a hung card still leaves a
    parsed result."""
    def watch():
        while not progress.done.wait(10.0):
            if progress.idle_s() > timeout_s:
                partial = progress.snapshot()
                partial.setdefault("metric", METRIC)
                partial.setdefault("value", 0.0)
                partial.setdefault("unit", "req/s")
                partial.setdefault("vs_baseline", 0.0)
                partial["aborted"] = (f"no device progress for "
                                      f"{progress.idle_s():.0f}s; partial "
                                      "results")
                print(json.dumps(partial), flush=True)
                print(json.dumps(compact(partial)), flush=True)
                os._exit(3)

    t = threading.Thread(target=watch, daemon=True, name="bench-watchdog")
    t.start()
    return t


def _trace_quantiles(obs, strategies) -> dict:
    """Per-strategy TTFT and TBT percentiles from the sweep router's own
    metric registry (the histograms its requests' span trees feed): the
    self-instrumented counterpart of the wall-clock columns, over every
    request the router served under that strategy (calibration, both
    legs, perf's warm pass).  Bucket-interpolated: bucket-width
    precision."""
    out: dict = {}
    for metric, prefix in (("dllm_ttft_ms", "ttft"), ("dllm_tbt_ms", "tbt")):
        fam = obs.metrics.get(metric)
        if fam is None:
            continue
        children = fam.children()
        for strategy in strategies:
            hist = children.get((strategy,))
            if hist is None or not hist.count:
                continue
            entry = out.setdefault(strategy, {})
            entry[f"trace_p50_{prefix}_ms"] = round(hist.quantile(0.5), 2)
            entry[f"trace_p95_{prefix}_ms"] = round(hist.quantile(0.95), 2)
            entry[f"trace_{prefix}_n"] = hist.count
    return out


def profile_phase(device=None, n_requests: int = 12, beat=lambda: None,
                  trace_path: str = "BENCH_profile_trace.json") -> dict:
    """The tick-forensics leg: a session-keyed mix through the full
    Router over the tiny batched cluster with the tick-phase profiler on,
    then where the milliseconds went and who pays: each tier's per-phase
    p50/p95 self-time table, the coverage (stamped self-time over the
    tick wall; below 0.95 the leg sets ``error``), the attribution ratio
    (the requests' billed ``device_time_ms`` over the profilers' decode
    self-time; outside 5% an error), the cost ledger's head, and the
    Chrome-trace artifact at ``trace_path``, checked by a JSON round trip
    with each tier's ticks in order."""
    from ..config import tiny_batched_cluster
    from ..obs import Observability
    from ..serving.router import Router

    print("[bench] tick-forensics profile leg", file=sys.stderr, flush=True)
    obs = Observability(slow_ms=None)
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=tiny_batched_cluster(), device=device,
                    observability=obs)
    out: dict = {}
    try:
        _start_tiers(router, beat)
        queries = ["What is the capital of France",
                   "Explain photosynthesis briefly",
                   "Name a large river in Africa"]
        errors = 0
        t0 = time.perf_counter()
        for i in range(n_requests):
            hist = [{"role": "user",
                     "content": f"{queries[i % len(queries)]} (v{i})"}]
            resp, _, _ = router.route_query(hist, session_id=f"s{i % 3}")
            if not resp.get("ok", True):
                errors += 1
            beat()
        wall = time.perf_counter() - t0
        out["requests"] = n_requests
        out["errors"] = errors
        out["req_per_s"] = round(n_requests / max(wall, 1e-9), 3)

        tiers: dict = {}
        decode_ms = 0.0
        for name, tier in router.tiers.items():
            prof = tier.server_manager.engine().profiler
            st = prof.phase_stats()
            tiers[name] = {"ticks": st["ticks"], "coverage": st["coverage"],
                           "phases": st["phases"]}
            decode_ms += prof.total_ms("decode")
        out["tiers"] = tiers
        coverages = [t["coverage"] for t in tiers.values()
                     if t.get("coverage") is not None]
        out["coverage"] = min(coverages) if coverages else None

        fam = obs.metrics.get("dllm_device_time_ms_total")
        attributed = sum(c.value for c in fam.children().values())
        out["attributed_device_ms"] = round(attributed, 3)
        out["decode_phase_ms"] = round(decode_ms, 3)
        if decode_ms > 0:
            out["attribution_ratio"] = round(attributed / decode_ms, 4)
        out["cost_head"] = router.cost_snapshot()[:4]

        blob = json.dumps(router.profiler_trace())
        events = json.loads(blob).get("traceEvents", [])
        ok_schema = all(
            "name" in e and "ph" in e and "pid" in e and "tid" in e
            and (e["ph"] == "M" or (e.get("ts", -1) >= 0
                                    and e.get("dur", 0) >= 0))
            for e in events)
        by_tid: dict = {}
        for e in events:
            if e.get("ph") == "X" and e.get("name") == "tick":
                by_tid.setdefault(e["tid"], []).append(e)
        monotonic = all(
            all(a["args"]["seq"] < b["args"]["seq"] and a["ts"] <= b["ts"]
                for a, b in zip(ticks, ticks[1:]))
            for ticks in by_tid.values())
        out["trace_events"] = len(events)
        out["trace_schema_ok"] = bool(ok_schema and monotonic)
        try:
            with open(trace_path, "w") as f:
                f.write(blob)
            out["trace_artifact"] = trace_path
        except OSError as exc:
            out["trace_artifact_error"] = str(exc)[:120]

        problems = []
        if out["coverage"] is None or out["coverage"] < 0.95:
            problems.append(f"phase coverage {out['coverage']} < 0.95")
        ratio = out.get("attribution_ratio")
        if ratio is None or abs(ratio - 1.0) > 0.05:
            problems.append(f"attribution ratio {ratio} outside 5%")
        if not out["trace_schema_ok"]:
            problems.append("chrome-trace schema/monotonicity check failed")
        if errors:
            problems.append(f"{errors} request error(s)")
        if problems:
            out["error"] = "; ".join(problems)[:300]
    finally:
        _stop_tiers(router)
    beat()
    return out


def _pct(values, q):
    """Nearest-rank percentile of ``values`` (the obs layer's rule),
    rounded for the artifact; None when empty."""
    from ..obs.metrics import nearest_rank
    v = nearest_rank(values, q)
    return None if v is None else round(v, 3)


def spill_phase(device=None, n_sessions: int = 16,
                beat=lambda: None, base=None, filler: Optional[str] = None,
                entry_blocks: int = 4) -> dict:
    """The hierarchical-KV spill leg: a session population far larger
    than the device pool (``n_sessions`` sessions on a 20-block pool
    sized for about 4), spill OFF and ON at two host budgets, the same
    seed and prompts: the regime where parked prefixes are evicted long
    before they are re-hit.

    Per mode: every session prompts once (populate: pool pressure
    evicts, ON demotes), then every session revisits with an extended
    prompt, newest first (recently active sessions return first: the
    LRU-friendly half of real traffic).  ``warm_hit_rate`` = revisits
    served warm (device prefix hits + host promotions) / N, required
    MONOTONE over OFF <= small <= large; ``tbt_ratio`` = a live
    co-tenant stream's inter-token-gap p95 during the revisits, ON(large)
    / OFF (the decode stream the budget contract protects; the JAX bar is
    1.05, reported here, not gated); outputs must be identical across
    ALL modes (else ``error``).  A deterministic race sub-check (copier
    paused, entry invalidated mid-promotion) must observe the
    promotion-race fallback with cold-prefill identity.

    ``base`` replaces the leg's tier (a constrained pool, chunked prefill,
    no spill budget; chip_smoke passes nano_1b at full width), ``filler``
    the sessions' shared prompt tail, and ``entry_blocks`` the blocks one
    parked session holds (the host budgets' unit).  Each mode also
    reports the revisits' TTFT p50 by how they were served: promoted
    from the host, a device prefix hit, or cold."""
    from ..config import tiny_batched_cluster
    from ..engine.batching import ContinuousBatchingEngine
    from ..engine.paged_kv import pool_block_bytes

    print("[bench] hierarchical-KV spill leg", file=sys.stderr, flush=True)
    if base is None:
        base = dataclasses.replace(
            tiny_batched_cluster().nano, max_new_tokens=6, decode_batch=4,
            prefill_buckets=(16, 32, 64), prefill_chunk_tokens=16,
            prefix_cache_entries=32,    # capacity never the bound here
            kv_pool_blocks=20)          # about 4 sessions of parked prefix
    if filler is None:
        filler = ("tell me about the rivers lakes mountains oceans deltas "
                  "and glaciers of the region in one short sentence")
    # Session names diverge at TOKEN ZERO: a shared opener would give
    # every revisit a trivial cross-session device hit.
    names = ("alpha bravo charlie delta echo foxtrot golf hotel india "
             "juliett kilo lima mike november oscar papa quebec romeo "
             "sierra tango").split()
    prompts = [f"{names[i % len(names)]} {i}: {filler}"
               for i in range(n_sessions)]
    revisits = [p + " and then say more" for p in reversed(prompts)]
    blk = pool_block_bytes(base.model(), base.kv_block_size,
                           base.kv_quantize)
    entry_bytes = blk * entry_blocks    # one parked session's blocks
    budgets = {"off": None,
               "small": entry_bytes * 4,
               "large": entry_bytes * n_sessions * 2}
    out: dict = {"n_sessions": n_sessions,
                 "kv_pool_blocks": base.kv_pool_blocks,
                 "host_entry_bytes": entry_bytes}

    token_ids: dict = {}
    for mode, host_bytes in budgets.items():
        tier = dataclasses.replace(base, host_kv_bytes=host_bytes,
                                   max_new_tokens=48)
        eng = ContinuousBatchingEngine(tier, seed=11, device=device)
        try:
            eng.warmup()
            beat()
            ids_mode = []
            for p in prompts:           # populate: park -> evict/demote
                ids_mode.append(tuple(
                    eng.generate(p, max_new_tokens=6).token_ids))
            beat()
            cst0 = eng.prefix_cache.stats()
            sp0 = (eng.kv_spill.stats() if eng.kv_spill is not None
                   else {})
            gaps: list = []
            co_stop = threading.Event()

            def co_tenant():
                # A prompt shorter than the cache's min_prefix: the
                # co-tenant never parks, so the warm-hit accounting is
                # the N sessions' alone.
                while not co_stop.is_set():
                    last = None
                    for _ in eng.generate_stream("sky", max_new_tokens=48):
                        now = time.perf_counter()
                        if last is not None:
                            gaps.append((now - last) * 1000.0)
                        last = now

            co = threading.Thread(target=co_tenant, daemon=True)
            co.start()
            ttfts = []
            served: dict = {"promoted": [], "device": [], "cold": []}

            def warm_counts():
                cs = eng.prefix_cache.stats()
                return (cs["hits_shared"] + cs["hits_exclusive"],
                        eng.kv_spill.stats()["promotions_total"]
                        if eng.kv_spill is not None else 0)

            for p in revisits:          # revisit: the warm-or-cold test
                hits0, prom0 = warm_counts()
                r = eng.generate(p, max_new_tokens=6)
                hits1, prom1 = warm_counts()
                ids_mode.append(tuple(r.token_ids))
                ttfts.append(r.ttft_ms)
                served["promoted" if prom1 > prom0 else
                       "device" if hits1 > hits0 else "cold"].append(
                           r.ttft_ms)
            co_stop.set()
            co.join(timeout=60)
            beat()
            cst = eng.prefix_cache.stats()
            sp = (eng.kv_spill.stats() if eng.kv_spill is not None
                  else {})
            dev_hits = ((cst["hits_shared"] + cst["hits_exclusive"])
                        - (cst0["hits_shared"] + cst0["hits_exclusive"]))
            promotions = (sp.get("promotions_total", 0)
                          - sp0.get("promotions_total", 0))
            warm = min(n_sessions, dev_hits + promotions)
            token_ids[mode] = ids_mode
            ttfts.sort()
            gaps.sort()
            out[mode] = {
                "warm_hit_rate": round(warm / n_sessions, 4),
                "device_hits": dev_hits,
                "promotions": promotions,
                "demotions_total": sp.get("demotions_total"),
                "promotion_races_total": sp.get("promotion_races_total"),
                "host_blocks_peak": sp.get("blocks"),
                "host_bytes": sp.get("bytes"),
                "revisit_ttft_p50_ms": _pct(ttfts, 0.50),
                **{f"{how}_ttft_p50_ms": _pct(v, 0.50)
                   for how, v in served.items()},
                "served": {how: len(v) for how, v in served.items()},
                "cotenant_tbt_p50_ms": _pct(gaps, 0.50),
                "cotenant_tbt_p95_ms": _pct(gaps, 0.95),
                "decode_tick_p50_ms": eng.tick_stats()["p50_ms"],
            }
        finally:
            eng.stop()
        beat()

    off = out.get("off") or {}
    small = out.get("small") or {}
    large = out.get("large") or {}
    if large.get("warm_hit_rate") is not None:
        out["warm_hit_rate"] = large["warm_hit_rate"]
        out["hit_rate_monotone"] = (
            off.get("warm_hit_rate", 1.0)
            <= small.get("warm_hit_rate", 0.0)
            <= large.get("warm_hit_rate", 0.0))
        out["hit_rate_gain"] = round(
            large["warm_hit_rate"] - off.get("warm_hit_rate", 0.0), 4)
    # At p95: decode emits whole ticks of tokens at once, so the p50 gap
    # is about 0 and only the tick-cadence tail can show a stall.
    if large.get("cotenant_tbt_p95_ms") and off.get("cotenant_tbt_p95_ms"):
        out["tbt_ratio"] = round(large["cotenant_tbt_p95_ms"]
                                 / off["cotenant_tbt_p95_ms"], 3)
    # The spill tier must not move a single token at any budget.
    out["outputs_identical"] = (
        len(token_ids) == 3
        and token_ids["off"] == token_ids["small"] == token_ids["large"])
    if not out["outputs_identical"]:
        out["error"] = ("spill outputs diverged across host budgets: the "
                        "promotion/race identity contract is broken")
    if not out.get("error") and out.get("hit_rate_monotone") is False:
        out["error"] = ("warm_hit_rate is not monotone over host budgets "
                        "(off {} <= small {} <= large {} violated)".format(
                            off.get("warm_hit_rate"),
                            small.get("warm_hit_rate"),
                            large.get("warm_hit_rate")))
    try:
        out["race"] = _spill_race_subcheck(base, entry_bytes, device, beat)
        if not out.get("error") and not out["race"].get("observed"):
            out["error"] = ("promotion-race fallback was never observed in "
                            "the race sub-check")
        if not out.get("error") and out["race"].get("identical") is False:
            out["error"] = ("promotion-race fallback diverged from the cold "
                            "prefill: the identity contract is broken")
    except Exception as exc:
        out["race"] = {"error": str(exc)[:200]}
        out.setdefault("error", f"race sub-check failed: {exc}"[:200])
    return out


def _spill_race_subcheck(base, entry_bytes: int, device=None,
                         beat=lambda: None) -> dict:
    """The spill leg's deterministic promotion-race probe: park a prefix,
    demote it with the copier PAUSED, admit a matching revisit (the
    promotion claims the still-copying entry and waits), invalidate the
    host store, resume: the promotion must fall back to a cold prefill
    with identical output and count exactly one race."""
    from ..engine.batching import ContinuousBatchingEngine

    prompt = ("race probe: tell me about rivers lakes mountains oceans "
              "deltas and glaciers")
    turn2 = prompt + " and then say more"
    cold_eng = ContinuousBatchingEngine(
        dataclasses.replace(base, host_kv_bytes=None), seed=11,
        device=device)
    try:
        cold_eng.generate(prompt)
        cold = cold_eng.generate(turn2).token_ids
    finally:
        cold_eng.stop()
    beat()
    eng = ContinuousBatchingEngine(
        dataclasses.replace(base, host_kv_bytes=entry_bytes * 8), seed=11,
        device=device)
    try:
        eng.generate(prompt)
        eng.kv_spill.pause()
        eng.prefix_cache.pop_oldest()         # demote, held in COPYING
        req = eng.submit(turn2)
        deadline = time.time() + 20
        while (eng.kv_spill.stats()["host_hits"] == 0
               and time.time() < deadline):
            time.sleep(0.001)
        eng.kv_spill.clear()                  # the race: the entry dies
        eng.kv_spill.resume()
        ok = req.done.wait(timeout=60) and req.error is None
        st = eng.kv_spill.stats()
        return {
            "observed": bool(ok and st["promotion_races_total"] >= 1),
            "races": st["promotion_races_total"],
            "identical": bool(ok and req.result.token_ids == cold),
        }
    finally:
        eng.kv_spill.resume()
        eng.stop()


def _clear_prefix_caches(router) -> None:
    """Repeat independence: later repeats replay the same queries, so the
    parked prefixes of an earlier repeat are dropped first."""
    for tier in router.tiers.values():
        engine = getattr(tier.server_manager, "_engine", None)
        cache = getattr(engine, "prefix_cache", None)
        if cache is not None:
            try:
                cache.clear()
            except Exception:
                pass


def _concurrent_leg(router, queries, n_clients: int = 4,
                    beat=lambda: None) -> dict:
    """Closed-loop concurrent clients through the full Router pipeline:
    the query set split over ``n_clients`` threads, each running its share
    as its own multi-turn conversation (the next query only after the
    previous answer).  Per-request TTFT comes from the raw response."""
    shares = [queries[i::n_clients] for i in range(n_clients)]
    shares = [s for s in shares if s]
    ttfts: list = []
    lats: list = []
    errors: list = []
    lock = threading.Lock()

    def client(share):
        hist: list = []
        for item in share:
            hist.append({"role": "user", "content": item["query"]})
            t0 = time.perf_counter()
            try:
                resp, _, _dev = router.route_query(hist[-HISTORY_LIMIT:])
            except Exception as exc:     # never lose the leg
                with lock:
                    errors.append(str(exc)[:80])
                continue
            dt = (time.perf_counter() - t0) * 1000.0
            beat()
            hist.append({"role": "assistant",
                         "content": resp.get("response", "")})
            raw = resp.get("raw")
            ttft = (raw.get("ttft_ms")
                    if isinstance(raw, dict) else None)
            with lock:
                lats.append(dt)
                if not resp.get("ok", True):
                    errors.append(resp.get("response", "")[:80])
                if ttft:
                    ttfts.append(ttft)

    threads = [threading.Thread(target=client, args=(s,),
                                name=f"bench-client-{i}")
               for i, s in enumerate(shares)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    return {
        "req_per_s": len(queries) / max(elapsed, 1e-9),
        "p50_ttft_ms": (round(statistics.median(ttfts), 2)
                        if ttfts else None),
        "p50_latency_ms": (round(statistics.median(lats), 2)
                           if lats else None),
        "clients": len(shares),
        "errors": len(errors),
    }


def _start_tiers(router, beat) -> None:
    for tier in router.tiers.values():
        tier.server_manager.start_server()
        beat()


def _stop_tiers(router) -> None:
    for tier in router.tiers.values():
        tier.server_manager.stop_server()


def trend_phase(device=None, n_clients: int = 4, repeat: int = 5,
                beat=lambda: None) -> dict:
    """The pinned cross-round leg: the tiny batched test tiers at their
    seeded random weights, general_knowledge, heuristic routing, 4
    closed-loop clients, median of ``repeat`` with the IQR beside it.  It
    never changes, so ``trend_req_per_s`` compares across rounds."""
    from ..config import tiny_batched_cluster
    from ..serving.router import Router
    from .query_sets import query_sets

    print("[bench] pinned trend leg", file=sys.stderr, flush=True)
    queries = query_sets["general_knowledge"]
    router = Router(strategy="heuristic", benchmark_mode=True,
                    cluster=tiny_batched_cluster(), device=device)
    rates, ttfts = [], []
    try:
        _start_tiers(router, beat)
        errors = 0
        for _rep in range(max(1, repeat)):
            _clear_prefix_caches(router)
            leg = _concurrent_leg(router, queries, n_clients, beat)
            rates.append(leg["req_per_s"])
            errors += leg["errors"]
            if leg["p50_ttft_ms"] is not None:
                ttfts.append(leg["p50_ttft_ms"])
            beat()
    finally:
        _stop_tiers(router)
    return {
        "trend_req_per_s": round(statistics.median(rates), 4),
        "trend_iqr": (round(_iqr(rates), 4) if len(rates) > 1 else 0.0),
        "p50_ttft_ms": (round(statistics.median(ttfts), 2)
                        if ttfts else None),
        "repeats": len(rates),
        "clients": n_clients,
        "errors": errors,
        "values": [round(v, 4) for v in rates],
        "config": "tiny_batched(nano=4,orin=2) random-init heuristic",
        "device": str(router.tiers["nano"].server_manager.device),
    }


def concurrent_phase(cluster, device=None, n_requests: int = 12,
                     n_sequential: int = 4, slots: int = 4, max_new: int = 32,
                     repeat: int = 3, beat=lambda: None) -> dict:
    """Continuous batching: independent single-turn queries submitted at
    once share one batched engine's ticks.  Reports the concurrent rate
    and its speedup over the same engine serving a sample of the same
    queries one at a time, each the median of ``repeat`` on the warm
    engine (query text varies per repeat, so no repeat rides prefix
    reuse); then the same load on an int8-KV pool."""
    from ..engine.batching import ContinuousBatchingEngine
    from ..utils import roofline

    tier = dataclasses.replace(cluster.nano, decode_batch=slots,
                               max_new_tokens=max_new)
    engine = ContinuousBatchingEngine(tier, seed=1, device=device)
    repeat = max(1, repeat)

    def reqs(rep: int) -> list:
        return [f"user: round {rep} question {i}: summarize fact "
                f"number {i} about geography" for i in range(n_requests)]

    def burst(eng, queries) -> float:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=eng.generate, args=(q,))
                   for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(queries) / (time.perf_counter() - t0)

    try:
        beat()
        engine.warmup()
        beat()
        print("[bench] batching engine warm", file=sys.stderr, flush=True)
        seq_rates, conc_rates = [], []
        for rep in range(repeat):
            queries = reqs(rep)
            t0 = time.perf_counter()
            for q in queries[:n_sequential]:
                engine.generate(q)
            seq_rates.append(n_sequential / (time.perf_counter() - t0))
            beat()
            conc_rates.append(burst(engine, queries))
            beat()
        sequential_rate = statistics.median(seq_rates)
        concurrent_rate = statistics.median(conc_rates)
        # Decode is bandwidth-bound: hbm_util is its number.
        peaks = roofline.chip_peaks(engine.device)
        work = engine.phases.work_summary()
        utilization = {
            ph: roofline.utilization(w, w["seconds"], peaks)
            for ph, w in work.items() if w.get("seconds")}
    finally:
        engine.stop()

    # The int8 KV pool on the same load: half the decode's K/V bytes.
    try:
        q8 = ContinuousBatchingEngine(
            dataclasses.replace(tier, kv_quantize="int8"), seed=1,
            device=device)
        try:
            beat()
            q8.warmup()
            beat()
            for q in reqs(0)[:2]:        # the bf16 engine's warm state
                q8.generate(q)
            kv_rates = []
            for rep in range(repeat):
                kv_rates.append(burst(q8, reqs(rep + repeat)))
                beat()
            kv_int8_rate = statistics.median(kv_rates)
        finally:
            q8.stop()
        kv_quant = {
            "concurrent_req_per_s": round(kv_int8_rate, 3),
            "speedup_vs_bf16_kv": round(kv_int8_rate / concurrent_rate, 2),
            "iqr": round(_iqr(kv_rates), 3) if len(kv_rates) > 1 else 0.0,
        }
    except Exception as exc:
        kv_quant = {"error": str(exc)[:200]}

    return {
        "concurrent_req_per_s": round(concurrent_rate, 3),
        "sequential_req_per_s": round(sequential_rate, 3),
        "batching_speedup": round(concurrent_rate / sequential_rate, 2),
        "repeats": {
            "n": repeat,
            "concurrent_values": [round(v, 3) for v in conc_rates],
            "concurrent_iqr": (round(_iqr(conc_rates), 3)
                               if len(conc_rates) > 1 else 0.0),
            "sequential_values": [round(v, 3) for v in seq_rates],
            "sequential_iqr": (round(_iqr(seq_rates), 3)
                               if len(seq_rates) > 1 else 0.0),
        },
        "slots": slots,
        "requests": n_requests,
        "utilization": utilization,
        "kv_int8": kv_quant,
    }


def features_phase(cluster, device=None, n_prompts: int = 3,
                   max_new: int = 48, beat=lambda: None) -> dict:
    """Measured evidence for speculative decoding and int8 weight-only
    quantization: acceptance and decode tok/s against plain greedy on the
    same weights, and bf16 against int8 decode tok/s per tier, each the
    median over ``n_prompts`` prompts on the sequential engine (prefix
    reuse off, so repeats measure steady decode).  Returns
    ``{"speculative": {...}, "quant": {tier: {...}}}``; a leg that raises
    records ``{"error": ...}`` in its place."""
    from ..engine.inference import InferenceEngine
    from ..engine.speculative import SpeculativeEngine

    prompts = [f"user: tell me fact number {i} about the mesh, the compiler "
               "and the chip" for i in range(n_prompts)]

    def decode_tokps(engine) -> float:
        engine.generate(prompts[0], max_new_tokens=4)       # warm
        beat()
        rates = []
        for p in prompts:
            res = engine.generate(p, max_new_tokens=max_new)
            beat()
            if res.tokens_per_s:
                rates.append(res.tokens_per_s)
        return round(statistics.median(rates), 1) if rates else 0.0

    out: dict = {}
    # Speculative: the big tier verifies the small tier's greedy drafts.
    try:
        print("[bench] speculative phase", file=sys.stderr, flush=True)
        target = dataclasses.replace(cluster.orin, temperature=0.0,
                                     enable_prefix_cache=False,
                                     decode_batch=1, quantize="none")
        draft = dataclasses.replace(cluster.nano, name="draft",
                                    temperature=0.0,
                                    enable_prefix_cache=False,
                                    decode_batch=1, quantize="none")
        plain = InferenceEngine(target, seed=3, device=device)
        plain_tokps = decode_tokps(plain)
        spec = SpeculativeEngine(target, draft, gamma=4, seed=3,
                                 target_params=plain.model, device=device)
        del plain
        spec_tokps = decode_tokps(spec)
        out["speculative"] = {
            "gamma": 4,
            "acceptance_rate": round(spec.acceptance_rate, 3),
            "plain_decode_tok_per_s": plain_tokps,
            "spec_decode_tok_per_s": spec_tokps,
            "speedup": round(spec_tokps / max(plain_tokps, 1e-9), 2),
        }
        del spec
    except Exception as exc:                  # never lose the headline line
        out["speculative"] = {"error": f"{type(exc).__name__}: {exc}"[:200]}

    # int8 weight-only: decode reads every weight once a step, so halving
    # the weight bytes should show in decode tok/s.
    quant: dict = {}
    for tier_name in ("nano", "orin"):
        try:
            print(f"[bench] quant phase ({tier_name})", file=sys.stderr,
                  flush=True)
            base = dataclasses.replace(getattr(cluster, tier_name),
                                       temperature=0.0, decode_batch=1,
                                       enable_prefix_cache=False)
            rates = {}
            for key, kw in (("bf16", dict(quantize="none")),
                            ("int8", dict(quantize="int8")),
                            ("int8_kv", dict(quantize="int8",
                                             kv_quantize="int8"))):
                engine = InferenceEngine(dataclasses.replace(base, **kw),
                                         seed=5, device=device)
                rates[key] = decode_tokps(engine)
                del engine
            quant[tier_name] = {
                "bf16_decode_tok_per_s": rates["bf16"],
                "int8_decode_tok_per_s": rates["int8"],
                "int8_weights_and_kv_decode_tok_per_s": rates["int8_kv"],
                "speedup": round(rates["int8"] / max(rates["bf16"], 1e-9), 2),
                "kv_int8_speedup": round(rates["int8_kv"]
                                         / max(rates["int8"], 1e-9), 2),
            }
        except Exception as exc:
            quant[tier_name] = {"error": f"{type(exc).__name__}: {exc}"[:200]}
    out["quant"] = quant
    return out


def flagship_phase(cluster=None, device=None, max_new: int = 48,
                   n_prompts: int = 3, beat=lambda: None) -> dict:
    """Serve the north star's presets (``config.flagship_cluster()``:
    nano_1b, orin_8b with int8 weights) on the sequential engine with
    seeded random weights: per tier (keyed ``nano_1b``, ``orin_8b_int8``)
    the memory budget, decode tok/s, p50 TTFT of head-varied cold
    prompts, prefill MFU and decode ``hbm_util``; nano also a
    near-``max_seq_len`` prompt's cold TTFT and prefill MFU and two
    prefix-reused follow-ups.  A tier over its budget reports instead of
    building.  ``cluster`` replaces the flagship cluster (the tests pass
    the tiny tiers)."""
    from ..config import flagship_cluster
    from ..device import resolve_device
    from ..engine.inference import InferenceEngine
    from ..utils import roofline
    from ..utils.hbm_budget import tier_hbm_budget
    from ..utils.telemetry import PhaseTimer

    out: dict = {}
    cluster = cluster or flagship_cluster()
    peaks = roofline.chip_peaks(resolve_device(device))
    for tname in ("nano", "orin"):
        # nano keeps its prefix cache (its long-context leg reuses the
        # prefix); orin serves with reuse off.  decode_batch=1: single-
        # stream decode on the sequential engine, which the budget gates.
        tier = dataclasses.replace(getattr(cluster, tname),
                                   max_new_tokens=max_new, decode_batch=1,
                                   enable_prefix_cache=(tname == "nano"))
        label = tier.model_preset + ("_int8" if tier.quantize == "int8"
                                     else "")
        print(f"[bench] flagship {label}", file=sys.stderr, flush=True)
        try:
            budget = tier_hbm_budget(tier)
            entry = {k: budget[k] for k in ("params_gb_per_chip",
                                            "kv_gb_per_chip",
                                            "total_gb_per_chip", "fits")}
            if not budget["fits"]:
                entry["skipped"] = "over HBM budget"
                out[label] = entry
                continue
            # int8 tiers are quantized by the engine, one weight at a time.
            engine = InferenceEngine(tier, seed=9, device=device)
            beat()
            engine.generate("user: warm the flagship up", max_new_tokens=4)
            beat()
            rates, ttfts = [], []
            for i in range(n_prompts):
                # Head-varied so no probe prefix-matches another.
                res = engine.generate(
                    f"{i} flagship probe: explain the chip's memory "
                    "system in a few sentences.", max_new_tokens=max_new)
                ttfts.append(res.ttft_ms)
                beat()
                if res.tokens_per_s:
                    rates.append(res.tokens_per_s)
            work = engine.phases.work_summary()
            util = {ph: roofline.utilization(w, w["seconds"], peaks)
                    for ph, w in work.items() if w.get("seconds")}
            entry.update({
                "decode_tok_per_s": (round(statistics.median(rates), 1)
                                     if rates else None),
                "p50_ttft_ms": round(statistics.median(ttfts), 2),
                "mfu_prefill": (util.get("prefill") or {}).get("mfu"),
                "hbm_util_decode": (util.get("decode") or {}).get("hbm_util"),
            })
            if tname == "nano":
                try:
                    tok = engine.tokenizer
                    max_seq = engine.cfg.max_seq_len
                    margin = max_seq // 8 + max_new
                    filler = ("fact: the quick brown fox jumps over the "
                              "lazy dog. " * (max_seq // 8))
                    ids = tok.encode(filler, add_bos=False)
                    prompt = tok.decode(ids[:max_seq - margin])
                    hist = [{"role": "user", "content": prompt}]
                    engine.phases = PhaseTimer()   # isolate this call
                    cold = engine.generate(hist, max_new_tokens=8)
                    beat()
                    lw = engine.phases.work_summary().get("prefill", {})
                    lutil = (roofline.utilization(lw, lw["seconds"], peaks)
                             if lw.get("seconds") else {})
                    hist += [{"role": "assistant", "content": cold.text},
                             {"role": "user", "content": "and?"}]
                    warm = engine.generate(hist, max_new_tokens=8)
                    hist += [{"role": "assistant", "content": warm.text},
                             {"role": "user", "content": "and more?"}]
                    warm2 = engine.generate(hist, max_new_tokens=8)
                    entry["long_context"] = {
                        "prompt_tokens": cold.prompt_tokens,
                        "cold_ttft_ms": round(cold.ttft_ms, 2),
                        "followup_ttft_ms": [round(warm.ttft_ms, 2),
                                             round(warm2.ttft_ms, 2)],
                        "mfu_prefill": lutil.get("mfu"),
                    }
                except Exception as exc:
                    entry["long_context"] = {
                        "error": f"{type(exc).__name__}: {exc}"[:160]}
            out[label] = entry
            del engine
        except Exception as exc:          # never lose the headline line
            out[label] = {"error": f"{type(exc).__name__}: {exc}"[:200]}
    return out


def spec_multiturn_phase(cluster, device=None, max_new: int = 16,
                         beat=lambda: None) -> dict:
    """What speculative serving costs on multi-turn TTFT: the speculative
    engine re-prefills the whole history every turn, where the plain
    engine's parked prefix makes a follow-up prefill only the new turn.
    The follow-up TTFT of both sequential engines over the same 2-turn
    conversation (orin, seed 5, nano drafting), each the lower of two
    follow-ups (the first may build the suffix program it needs); a cost
    above 1 is what speculation gives up for its decode win.  The JAX
    package's ``spec_multiturn_phase`` (root ``bench.py``), with its
    keys."""
    from ..engine.inference import InferenceEngine
    from ..engine.speculative import SpeculativeEngine

    print("[bench] spec multi-turn cost probe", file=sys.stderr, flush=True)
    turn1 = ("Please give a detailed account of how rivers shape valleys "
             "over geological time, with several concrete mechanisms "
             "discussed one by one so the explanation runs long.")
    turn2 = "and what about glaciers?"

    def followup_ttft(engine) -> float:
        hist = [{"role": "user", "content": turn1}]
        first = engine.generate(hist, max_new_tokens=max_new)
        beat()
        hist += [{"role": "assistant", "content": first.text},
                 {"role": "user", "content": turn2}]
        ttfts = []
        for extra in ("", " and fjords?"):
            res = engine.generate(hist + ([{"role": "user", "content": extra}]
                                          if extra else []),
                                  max_new_tokens=max_new)
            ttfts.append(res.ttft_ms)
            beat()
        return min(ttfts)

    out: dict = {}
    try:
        plain = InferenceEngine(cluster.orin, seed=5, device=device)
        try:
            out["plain_followup_ttft_ms"] = round(followup_ttft(plain), 2)
        finally:
            del plain
        spec = SpeculativeEngine(cluster.orin, cluster.nano, seed=5,
                                 device=device)
        try:
            out["spec_followup_ttft_ms"] = round(followup_ttft(spec), 2)
        finally:
            del spec
        out["spec_followup_ttft_cost"] = round(
            out["spec_followup_ttft_ms"]
            / max(out["plain_followup_ttft_ms"], 1e-6), 2)
    except Exception as exc:              # never lose the headline line
        out["error"] = f"{type(exc).__name__}: {exc}"[:200]
    return out


def _calibrate(router, queries, n_clients: int, repeats: int,
               budget: Budget, progress: Progress):
    """One query's cost on the warm engines -> the repeats (and, under a
    tight budget, the query count) that fit the sweep's 45% share.
    Returns (queries, repeats, note)."""
    sweep_deadline = budget.t0 + 0.45 * budget.total_s
    t_cal = time.perf_counter()
    router.route_query([{"role": "user", "content": queries[0]["query"]}])
    progress.beat()
    per_q_s = max(time.perf_counter() - t_cal, 1e-3)
    _clear_prefix_caches(router)
    # Sequential + concurrent leg ~ (1 + 1/n_clients) per query per
    # strategy; perf adds its warm pass.
    est_repeat_s = (per_q_s * len(queries) * len(STRATEGIES)
                    * (1.0 + 1.0 / n_clients) + per_q_s * len(queries))
    avail = sweep_deadline - time.monotonic()
    asked = repeats
    while repeats > 1 and est_repeat_s * repeats > avail:
        repeats -= 1
    note = None
    if est_repeat_s > avail and len(queries) > 6:
        keep = max(6, int(len(queries) * avail / est_repeat_s))
        queries = queries[:keep]
        note = (f"query set trimmed to {keep} and repeats to {repeats} to "
                f"fit the {budget.total_s:.0f}s budget (per-query "
                f"~{per_q_s:.2f}s)")
    elif repeats < asked:
        note = (f"repeats scaled to {repeats} to fit the "
                f"{budget.total_s:.0f}s budget (per-query ~{per_q_s:.2f}s)")
    return queries, repeats, note


def _set_perf_production(router) -> None:
    """The perf leg runs with production exploration and queue-aware
    scoring (``PRODUCTION_CFG``): without probes both passes would be all
    nano by construction."""
    from ..config import PRODUCTION_CFG
    cfg = router.query_router.config
    cfg["perf_explore"] = bool(PRODUCTION_CFG.get("perf_explore", False))
    cfg["perf_explore_interval"] = int(
        PRODUCTION_CFG.get("perf_explore_interval", 16))
    cfg["perf_queue_aware"] = bool(PRODUCTION_CFG.get("perf_queue_aware",
                                                      True))
    cfg["perf_queue_penalty_ms"] = float(
        PRODUCTION_CFG.get("perf_queue_penalty_ms", 50.0))


def _tier_stats(router, peaks) -> tuple:
    """Per-tier engine stats with per-phase utilization, and the two
    tiers' prefill and decode work summed."""
    from ..utils import roofline
    from ..utils.telemetry import engine_stats
    phases = {}
    agg = {"prefill": {"flops": 0.0, "hbm_bytes": 0.0, "seconds": 0.0},
           "decode": {"flops": 0.0, "hbm_bytes": 0.0, "seconds": 0.0}}
    for name, tier in router.tiers.items():
        engine = getattr(tier.server_manager, "_engine", None)
        entry = engine_stats(engine)
        if not entry:
            continue
        util = {}
        for ph, w in entry.get("work", {}).items():
            if w.get("seconds"):
                util[ph] = roofline.utilization(w, w["seconds"], peaks)
            if ph in agg:
                for k in agg[ph]:
                    agg[ph][k] += w.get(k, 0.0)
        if util:
            entry["utilization"] = util
        if hasattr(engine, "ragged"):
            entry["attention_ragged"] = engine.ragged
        if callable(getattr(engine, "tick_stats", None)):
            entry["tick"] = engine.tick_stats()
        phases[name] = entry
    return phases, agg


def _long_context(router) -> dict:
    """A near-max_seq_len prompt through the orin tier (cold long-prompt
    TTFT), then follow-up turns whose prefill rides the parked prefix.
    The margin keeps the follow-ups under the prompt cap."""
    print("[bench] long-context probe", file=sys.stderr, flush=True)
    eng = router.tiers["orin"].server_manager.engine()
    max_seq = eng.cfg.max_seq_len
    margin = max(96, max_seq // 8) + eng.tier.max_new_tokens
    filler = "fact: the quick brown fox jumps over the lazy dog. " * (
        max_seq // 8)
    ids = eng.tokenizer.encode(filler, add_bos=False)
    prompt = eng.tokenizer.decode(ids[:max_seq - margin])
    long_hist = [{"role": "user", "content": prompt}]
    cold = eng.generate(long_hist, max_new_tokens=8)
    followups = []
    prev = cold
    for q in ("and one more thing?", "and another?", "and one more thing?"):
        long_hist += [{"role": "assistant", "content": prev.text},
                      {"role": "user", "content": q}]
        prev = eng.generate(long_hist, max_new_tokens=8)
        followups.append(round(prev.ttft_ms, 2))
    return {
        "prompt_tokens": cold.prompt_tokens,
        "cold_ttft_ms": round(cold.ttft_ms, 2),
        "followup_ttft_ms": followups,
        "prefix_reuse_speedup": round(
            cold.ttft_ms / max(min(followups), 1e-6), 2),
    }


def _orin_prefix(router, beat) -> dict:
    """A short orin-routed conversation inside the history window through
    the router: follow-up TTFT against a cold replay of the last turn's
    full history with the prefix cache emptied."""
    print("[bench] orin multi-turn prefix pass", file=sys.stderr, flush=True)
    router.query_router.change_strategy("heuristic")
    orin_eng = router.tiers["orin"].server_manager.engine()
    cache = getattr(orin_eng, "prefix_cache", None)
    before = cache.stats() if cache is not None else {"hits": 0}
    convo, turn_ttfts = [], []
    last_hist = last_dev = None
    for q in ("Please implement a function that merges two sorted "
              "lists and explain its complexity.",
              "Now refactor that implementation to be stable and "
              "discuss the trade-offs.",
              "Please analyze the algorithm's worst case in detail.",
              "Finally, implement a regression test function for it."):
        convo.append({"role": "user", "content": q})
        last_hist = list(convo[-HISTORY_LIMIT:])
        _, _, dev = router.route_query(last_hist)
        last_dev = dev
        beat()
        res = router.tiers[dev].last_result
        convo.append({"role": "assistant", "content": res.text if res else ""})
        turn_ttfts.append(round(res.ttft_ms, 2) if res else None)
    after = cache.stats() if cache is not None else {"hits": 0}
    cold_replay = None
    if last_dev == "orin" and turn_ttfts[-1] and cache is not None:
        cache.clear()
        cold_replay = round(orin_eng.generate(last_hist,
                                              max_new_tokens=4).ttft_ms, 2)
    return {
        "turn_ttft_ms": turn_ttfts,
        "prefix_hits": after.get("hits", 0) - before.get("hits", 0),
        "cold_replay_ttft_ms": cold_replay,
        "followup_ttft_speedup": (
            round(cold_replay / max(turn_ttfts[-1], 1e-6), 2)
            if cold_replay and turn_ttfts[-1] else None),
    }


def run(device=None, *, repeats: int = 3, clients: int = 4,
        progress: Optional[Progress] = None,
        budget: Optional[Budget] = None, cluster=None,
        n_queries: Optional[int] = None, trend_repeats: int = 5,
        flagship: bool = False,
        host_kv_bytes: Optional[int] = None) -> dict:
    """The headline sweep and the later sections on ``device`` (default:
    the card; raises with none).  ``cluster`` defaults to
    ``default_cluster(device)``; ``n_queries`` keeps the first queries
    of the set (a smoke run); ``trend_repeats`` is the trend leg's K;
    ``flagship`` runs the flagship section on the CPU too (it always
    runs on the card); ``host_kv_bytes`` gives the sweep cluster's tiers
    a host spill tier of that budget (the JAX bench's
    ``DLLM_HOST_KV_BYTES``; the spill leg sets its own budgets)."""
    import torch

    from ..device import resolve_device
    from ..obs import Observability
    from ..serving.router import Router, default_cluster
    from ..utils import roofline
    from .query_sets import query_sets

    dev = resolve_device(device)
    progress = progress or Progress()
    budget = budget or Budget()
    progress.section("backend", dev.type)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    progress.section("card", card)

    queries = query_sets["general_knowledge"][:n_queries]
    cluster = cluster or default_cluster(dev)
    if host_kv_bytes is not None:
        cluster = dataclasses.replace(cluster, **{
            t: dataclasses.replace(getattr(cluster, t),
                                   host_kv_bytes=host_kv_bytes)
            for t in ("nano", "orin")})
    # The sweep's own registry: the trace-derived columns read it.
    sweep_obs = Observability(slow_ms=None)
    router = Router(strategy=STRATEGIES[0], benchmark_mode=True,
                    cluster=cluster, device=dev, observability=sweep_obs)
    cluster_served = {t: getattr(router.cluster, t).model_preset
                      for t in ("nano", "orin")}
    progress.section("cluster", cluster_served)
    _start_tiers(router, progress.beat)

    repeats = max(1, repeats)
    n_clients = max(2, clients)
    queries, repeats, scale_note = _calibrate(router, queries, n_clients,
                                              repeats, budget, progress)
    progress.section("budget", {
        "budget_s": round(budget.total_s, 1),
        "repeats": repeats, "queries_per_strategy": len(queries),
        "clients": n_clients, "scaled": scale_note})
    sweep_deadline = budget.t0 + 0.45 * budget.total_s

    per_strategy: Dict[str, Any] = {}
    ttfts, latencies = [], []
    n_done = 0
    total_s = 0.0
    correct = 0
    gen_tokens = 0
    rep_req_per_s: list = []
    rep_seq_req_per_s: list = []
    strat_records: dict = {s: [] for s in STRATEGIES}
    strat_ttfts: dict = {s: [] for s in STRATEGIES}
    for rep in range(repeats):
        _clear_prefix_caches(router)
        rep_elapsed = rep_conc_elapsed = 0.0
        rep_queries = 0
        for strategy in STRATEGIES:
            print(f"[bench] repeat {rep + 1}/{repeats} strategy {strategy}",
                  file=sys.stderr, flush=True)
            if strategy == "perf":
                _set_perf_production(router)
            router.query_router.change_strategy(strategy)
            cold_correct = None
            if strategy == "perf":
                # change_strategy starts perf with an empty latency
                # window (every query to nano): one labeled warm pass,
                # its accuracy the cold number, warms it first.
                cold_correct = 0
                warm_hist = []
                for item in queries:
                    warm_hist.append({"role": "user",
                                      "content": item["query"]})
                    resp, _, dev_used = router.route_query(
                        warm_hist[-HISTORY_LIMIT:])
                    progress.beat()
                    warm_hist.append({"role": "assistant",
                                      "content": resp.get("response", "")})
                    if dev_used == item["expected_device"]:
                        cold_correct += 1
            history = []
            s_lat, s_ttft, s_correct, s_orin = [], [], 0, 0
            t_strat = time.perf_counter()
            for item in queries:
                history.append({"role": "user", "content": item["query"]})
                t0 = time.perf_counter()
                response, _tokens, dev_used = router.route_query(
                    history[-HISTORY_LIMIT:])
                progress.beat()
                dt = time.perf_counter() - t0
                history.append({"role": "assistant",
                                "content": response.get("response", "")})
                tier = router.tiers.get(dev_used)
                res = tier.last_result if tier else None
                if res is not None:
                    s_ttft.append(res.ttft_ms)
                    gen_tokens += res.gen_tokens
                s_lat.append(dt * 1000.0)
                if dev_used == item["expected_device"]:
                    s_correct += 1
                if dev_used == "orin":
                    s_orin += 1
            elapsed = time.perf_counter() - t_strat
            rep_elapsed += elapsed
            total_s += elapsed
            n_done += len(queries)
            correct += s_correct
            ttfts.extend(s_ttft)
            latencies.extend(s_lat)
            strat_ttfts[strategy].extend(s_ttft)

            # The concurrent leg: the headline.  The sequential leg above
            # owns routing accuracy.
            conc = _concurrent_leg(router, queries, n_clients,
                                   beat=progress.beat)
            rep_conc_elapsed += len(queries) / max(conc["req_per_s"], 1e-9)
            rep_queries += len(queries)
            strat_records[strategy].append({
                "sequential_req_per_s": len(queries) / elapsed,
                "concurrent_req_per_s": conc["req_per_s"],
                "concurrent_p50_ttft_ms": conc["p50_ttft_ms"],
                "concurrent_errors": conc["errors"],
                "routing_accuracy": s_correct / len(queries),
                "orin_queries": s_orin,
                "cold_start_accuracy": (cold_correct / len(queries)
                                        if cold_correct is not None
                                        else None),
                "explore": bool(getattr(router.query_router.router,
                                        "explore", False)),
            })
            per_strategy[strategy] = _aggregate_strategy(
                strat_records[strategy], strat_ttfts[strategy])
            progress.section("per_strategy", dict(per_strategy))
        rep_seq_req_per_s.append(len(queries) * len(STRATEGIES)
                                 / rep_elapsed)
        rep_req_per_s.append(rep_queries / max(rep_conc_elapsed, 1e-9))
        # A repeat costs what the last one cost: stop before the sweep's
        # share runs out.
        if (rep + 1 < repeats
                and time.monotonic() + rep_elapsed + rep_conc_elapsed
                > sweep_deadline):
            print(f"[bench] stopping after repeat {rep + 1}/{repeats}: "
                  "sweep budget share exhausted", file=sys.stderr,
                  flush=True)
            break

    for strategy, extra in _trace_quantiles(sweep_obs, STRATEGIES).items():
        per_strategy.setdefault(strategy, {}).update(extra)
    progress.section("per_strategy", dict(per_strategy))

    # Phase attribution and roofline work behind the headline, taken
    # before the probes below add their own traffic.
    peaks = roofline.chip_peaks(dev)
    phases, agg = _tier_stats(router, peaks)
    utilization: Dict[str, Any] = {
        ph: roofline.utilization(w, w["seconds"], peaks)
        for ph, w in agg.items() if w["seconds"] > 0}
    if peaks:
        utilization["peaks"] = {
            "chip": peaks["chip"],
            "peak_tflops": round(peaks["peak_flops"] / 1e12, 1),
            "peak_hbm_gbps": round(peaks["peak_hbm_bytes_per_s"] / 1e9, 1)}
    req_per_s = statistics.median(rep_req_per_s)
    seq_req_per_s = statistics.median(rep_seq_req_per_s)
    req_per_s_stats = {
        "n": len(rep_req_per_s),
        "median": round(req_per_s, 4),
        "iqr": (round(_iqr(rep_req_per_s), 4)
                if len(rep_req_per_s) > 1 else 0.0),
        "values": [round(v, 4) for v in rep_req_per_s],
        "sequential_values": [round(v, 4) for v in rep_seq_req_per_s],
    }
    conc_ttfts = [r.get("concurrent_p50_ttft_ms")
                  for recs in strat_records.values() for r in recs
                  if r.get("concurrent_p50_ttft_ms") is not None]
    conc_errors = sum(r.get("concurrent_errors") or 0
                      for recs in strat_records.values() for r in recs)
    headline = {
        "metric": METRIC,
        "value": round(req_per_s, 4),
        "unit": "req/s",
        "vs_baseline": round(req_per_s / BASELINE_REQ_PER_S, 2),
        "req_per_s_stats": req_per_s_stats,
        "sequential_req_per_s": round(seq_req_per_s, 4),
        "concurrent_speedup": round(req_per_s / max(seq_req_per_s, 1e-9), 2),
        "concurrent_p50_ttft_ms": (round(statistics.median(conc_ttfts), 2)
                                   if conc_ttfts else None),
        "sequential_p50_ttft_ms": (round(statistics.median(ttfts), 2)
                                   if ttfts else None),
        "concurrent_errors": conc_errors,
        "p50_ttft_ms": round(statistics.median(ttfts), 2) if ttfts else None,
        "p50_latency_ms": round(statistics.median(latencies), 2),
        "routing_accuracy": round(correct / n_done, 3),
        "decode_tok_per_s": round(gen_tokens / total_s, 1),
        "queries": n_done,
        "mfu_prefill": utilization.get("prefill", {}).get("mfu"),
        "hbm_util_decode": utilization.get("decode", {}).get("hbm_util"),
        "utilization": utilization,
        "per_strategy": per_strategy,
        "tiers": phases,
    }
    for key, val in headline.items():
        progress.section(key, val)
    progress.flush_compact()

    def later(name: str, fn, est_s: float):
        """A later section: skipped past the budget, an error recorded
        (the run then exits non-zero), the compact line reprinted."""
        if budget.allows(est_s):
            try:
                value = fn()
            except Exception as exc:      # never lose the headline line
                value = {"error": f"{type(exc).__name__}: {exc}"[:200]}
        else:
            value = {"skipped": budget.skip_stamp()}
        progress.section(name, value)
        progress.flush_compact()
        return value

    try:
        trend = later("trend", lambda: trend_phase(
            dev, n_clients=4, repeat=trend_repeats, beat=progress.beat), 45)
        if isinstance(trend.get("trend_req_per_s"), float):
            progress.section("trend_req_per_s", trend["trend_req_per_s"])
        long_context = later("long_context", lambda: _long_context(router),
                             60)
        orin_prefix = later("orin_prefix", lambda: _orin_prefix(
            router, progress.beat), 60)
        entry = phases.get("orin")
        orin_eng = getattr(router.tiers["orin"].server_manager, "_engine",
                           None)
        if entry is not None and getattr(orin_eng, "prefix_cache", None):
            entry["prefix_cache"] = orin_eng.prefix_cache.stats()
            progress.section("tiers", phases)
    finally:
        # Free the sweep engines' memory before the load test's pool.
        _stop_tiers(router)
    progress.beat()
    batching = later("continuous_batching", lambda: concurrent_phase(
        router.cluster, dev, beat=progress.beat), 120)
    profile = later("profile", lambda: profile_phase(
        dev, beat=progress.beat), 60)
    spill = later("spill", lambda: spill_phase(dev, beat=progress.beat), 150)
    if budget.allows(150):
        features = features_phase(router.cluster, dev, beat=progress.beat)
    else:
        features = {"speculative": {"skipped": budget.skip_stamp()},
                    "quant": {"skipped": budget.skip_stamp()}}
    progress.section("speculative", features["speculative"])
    progress.section("quant", features["quant"])
    progress.flush_compact()
    if flagship or dev.type != "cpu":
        flagship_out = later("flagship", lambda: flagship_phase(
            device=dev, beat=progress.beat), 240)
    else:
        flagship_out = {"skipped": "cpu backend (pass --flagship)"}
        progress.section("flagship", flagship_out)
    spec_multiturn = later("spec_multiturn", lambda: spec_multiturn_phase(
        router.cluster, dev, beat=progress.beat), 90)

    return {
        **headline,
        "backend": dev.type,
        "card": card,
        "cluster": cluster_served,
        "budget": progress.snapshot().get("budget"),
        "trend": trend,
        "trend_req_per_s": trend.get("trend_req_per_s"),
        "continuous_batching": batching,
        "long_context": long_context,
        "orin_prefix": orin_prefix,
        "profile": profile,
        "spill": spill,
        "speculative": features["speculative"],
        "quant": features["quant"],
        "flagship": flagship_out,
        "spec_multiturn": spec_multiturn,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llm_tpu_torch.bench",
        description="Headline benchmark: req/s and p50 TTFT per routing "
                    "strategy on general_knowledge.")
    p.add_argument("--device", default=None,
                   help="cuda (default: the card; raises with none) or cpu "
                        "(the tiny test tiers)")
    p.add_argument("--budget-s", type=float, default=1200.0,
                   help="wall-clock budget of the whole run (s)")
    p.add_argument("--repeats", type=int, default=3,
                   help="strategy sweep repeats (median and IQR)")
    p.add_argument("--clients", type=int, default=4,
                   help="closed-loop clients of the concurrent leg (>= 2)")
    p.add_argument("--watchdog-s", type=float, default=900.0,
                   help="exit with the partial result after this long with "
                        "no progress")
    p.add_argument("--host-kv-bytes", type=int, default=None,
                   help="host spill budget (bytes) of the sweep cluster's "
                        "tiers (default: the cluster's own, none)")
    p.add_argument("--flagship", action="store_true",
                   help="run the flagship section (nano_1b and orin_8b) on "
                        "the CPU too (always on the card)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    progress = Progress()
    budget = Budget(args.budget_s)

    def _sigterm_flush(signum, frame):
        # The best-so-far compact line, lock-free and by a raw write (the
        # handler may interrupt a buffered stdout write), after a newline
        # so a cut line cannot corrupt it.
        line = progress.last_compact or json.dumps({
            "metric": METRIC, "value": 0.0, "unit": "req/s",
            "vs_baseline": 0.0,
            "aborted": "SIGTERM before the headline landed"})
        try:
            os.write(1, ("\n" + line + "\n").encode("utf-8", "replace"))
        finally:
            os._exit(4)

    prev = signal.signal(signal.SIGTERM, _sigterm_flush)
    try:
        start_watchdog(progress, args.watchdog_s)
        result = run(args.device, repeats=args.repeats, clients=args.clients,
                     progress=progress, budget=budget,
                     flagship=args.flagship,
                     host_kv_bytes=args.host_kv_bytes)
    finally:
        progress.done.set()
        signal.signal(signal.SIGTERM, prev)
    print(json.dumps(result), flush=True)
    progress.finalize(result)
    errors = section_errors(result)
    if errors:
        print(f"[bench] sections with an error: {errors}", file=sys.stderr,
              flush=True)
    print(json.dumps(compact(result)), flush=True)
    return 1 if errors else 0
