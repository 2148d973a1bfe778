"""Benchmark + routing-accuracy tester: the canonical harness.

Counterpart of ``distributed_llm_tpu/bench/tester.py``, the port of the
reference's src/tests/routing_chatbot_tester.py (v2).  The CLI contract,
the sweep semantics and the CSV schemas are the JAX package's, letter for
letter, so experiment scripts run unchanged against the PyTorch/CUDA
backend:

  python -m distributed_llm_tpu_torch.bench.tester \
      --query-set general_knowledge \
      --thresholds 100 1000 4000 --fixed-threshold 1000 \
      --strategies token heuristic semantic hybrid perf \
      --cache-modes off on \
      --output-csv results.csv --output-per-query-csv per_query.csv

It serves ``serving.router.default_cluster``: ``bench_cluster()`` on the
card (the default), the tiny batched tiers with ``--device cpu`` (the
JAX package's ``--platform``); with no card and no ``--device cpu`` it
raises.

Sweep semantics (routing_chatbot_tester.py:352-367):
- the threshold sweep applies ONLY to the token strategy; every other
  strategy runs once at --fixed-threshold (default: the last of
  --thresholds);
- cache off -> benchmark_mode=True (BENCHMARK_CFG), on -> production
  (PRODUCTION_CFG);
- a fresh Router per experiment config, its cache cleared, one warmup
  query ("Reply with exactly: OK"), servers started before and stopped
  after each config, multi-turn conversation history accumulated across
  the query set.

The reference's Jetson power subsystem (SSH'd jtop loggers, mW·s
integration) has no counterpart on the card: --nano-ip/--orin-ip are
accepted and ignored, and the energy columns are filled from the
telemetry sampler's 1 Hz trace of the card's power draw (``nvidia-smi``,
mW·s = mJ as in the reference; both tiers share one card, so each
tier's window integrates the whole card's draw) or zero (on the CPU, or
with --no-telemetry).  The schemas carry the JAX package's additions:
per-query ``ttft_ms`` and ``decode_tok_per_s``; per-summary ``req_per_s``
and the p50s of both.
"""

from __future__ import annotations

import argparse
import csv
import os
import statistics
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple

from ..config import BENCHMARK_CFG, PRODUCTION_CFG
from ..serving.router import Router, default_cluster
from ..utils.telemetry import TierTelemetry
from .query_sets import query_sets

TOKEN_SWEEP_STRATEGIES = {"token"}

SUMMARY_HEADERS = [
    "query_set", "strategy", "cache_mode", "token_threshold",
    "routing_accuracy",
    "nano_total_latency_ms", "nano_total_energy_mJ", "nano_avg_power_mW",
    "nano_total_tokens", "nano_latency_per_token_ms", "nano_energy_per_token_mJ",
    "orin_total_latency_ms", "orin_total_energy_mJ", "orin_avg_power_mW",
    "orin_total_tokens", "orin_latency_per_token_ms", "orin_energy_per_token_mJ",
    "overall_total_latency_ms", "overall_total_energy_mJ", "overall_total_tokens",
    "overall_latency_per_token_ms", "overall_energy_per_token_mJ",
    # TPU-native additions (north-star metrics)
    "req_per_s", "p50_ttft_ms", "p50_latency_ms", "decode_tok_per_s",
]

PER_QUERY_HEADERS = [
    "query_set", "strategy", "cache_mode", "token_threshold",
    "query_index", "query_text", "expected_device",
    "device_used", "cache_hit",
    "routing_method", "routing_confidence", "routing_reasoning",
    "routing_overhead_ms",
    "start_time", "end_time", "latency_ms", "response_tokens",
    "energy_mJ", "latency_per_token_ms", "energy_per_token_mJ",
    # TPU-native additions
    "ttft_ms", "decode_tok_per_s",
]


@dataclass
class QueryItem:
    text: str
    expected_device: Optional[str] = None


@dataclass
class RunConfig:
    query_set_name: str
    thresholds: List[int]
    strategies: List[str]
    cache_modes: List[str]
    fixed_threshold_for_non_token: int
    output_csv: str
    output_per_query_csv: str
    router_kwargs: Dict[str, Any] = field(default_factory=dict)
    telemetry: bool = True


def normalize_query_set(raw_items: Any) -> List[QueryItem]:
    """Accept list[str] or list[dict{query|text, expected_device|label}]
    (routing_chatbot_tester.py:75-112)."""
    if not isinstance(raw_items, list):
        raise ValueError("query_sets[<name>] must be a list")
    out: List[QueryItem] = []
    for x in raw_items:
        if isinstance(x, str):
            if x.strip():
                out.append(QueryItem(text=x.strip()))
        elif isinstance(x, dict):
            q = (x.get("query") or x.get("text") or "").strip()
            if not q:
                continue
            exp = x.get("expected_device") or x.get("label")
            if isinstance(exp, str):
                exp = exp.lower().strip()
                if exp not in ("nano", "orin"):
                    exp = None
            else:
                exp = None
            out.append(QueryItem(text=q, expected_device=exp))
    if not out:
        raise ValueError("Query set is empty after normalization")
    return out


def build_router_config(cache_enabled: bool, token_threshold: int) -> Dict[str, Any]:
    base = PRODUCTION_CFG if cache_enabled else BENCHMARK_CFG
    return {**base, "token_threshold": token_threshold}


def try_clear_cache(router: Router) -> None:
    qr = getattr(router, "query_router", None)
    if qr is not None and hasattr(qr, "clear_cache"):
        try:
            qr.clear_cache()
        except Exception:
            pass


def warmup(router: Router) -> None:
    try:
        router.route_query([{"role": "user", "content": "Reply with exactly: OK"}])
    except Exception:
        pass


def compute_accuracy(rows: List[Dict[str, Any]]) -> Optional[float]:
    labeled = [r for r in rows if r.get("expected_device") in ("nano", "orin")]
    if not labeled:
        return None
    correct = sum(1 for r in labeled
                  if r.get("device_used") == r.get("expected_device"))
    return correct / len(labeled)


def ensure_csv_headers(path: str, headers: List[str]) -> None:
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return
    with open(path, "w", newline="") as f:
        csv.writer(f).writerow(headers)


def append_csv_row(path: str, headers: List[str], row: Dict[str, Any]) -> None:
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow([row.get(h, "") for h in headers])


def _build_telemetry(device=None) -> TierTelemetry:
    """Telemetry of both tiers on ``device``'s card: they share it, so
    each tier's energy columns integrate the whole card's power draw."""
    return TierTelemetry(["nano", "orin"], device=device)


def _experiment_grid(run_cfg: RunConfig):
    """(strategy, cache_mode, threshold) triples, reference sweep semantics."""
    for strategy in run_cfg.strategies:
        for cache_mode in run_cfg.cache_modes:
            thresholds = (run_cfg.thresholds
                          if strategy in TOKEN_SWEEP_STRATEGIES
                          else [run_cfg.fixed_threshold_for_non_token])
            for threshold in thresholds:
                yield strategy, cache_mode, threshold


def run_experiment(query_items: List[QueryItem], run_cfg: RunConfig) -> List[Dict[str, Any]]:
    ensure_csv_headers(run_cfg.output_csv, SUMMARY_HEADERS)
    ensure_csv_headers(run_cfg.output_per_query_csv, PER_QUERY_HEADERS)

    telemetry = (_build_telemetry(run_cfg.router_kwargs.get("device"))
                 if run_cfg.telemetry else None)
    if telemetry:
        telemetry.start()

    all_rows: List[Dict[str, Any]] = []
    experiment_wall: Dict[Tuple[str, str, int], float] = {}

    for strategy, cache_mode, threshold in _experiment_grid(run_cfg):
        cache_enabled = cache_mode.lower() == "on"
        benchmark_mode = not cache_enabled
        config = build_router_config(cache_enabled, threshold)

        try:
            router = Router(strategy=strategy, config=config,
                            threshold_fallback=threshold,
                            benchmark_mode=benchmark_mode,
                            **run_cfg.router_kwargs)
        except Exception as exc:
            print(f"[skip] strategy={strategy} cache={cache_mode} "
                  f"thr={threshold} -> {exc}")
            continue

        print(f"[run] strategy={strategy} cache={cache_mode} "
              f"benchmark_mode={benchmark_mode} threshold={threshold}",
              flush=True)

        for tier in (router.nano, router.orin):
            try:
                tier.server_manager.start_server()
            except Exception:
                pass
        try_clear_cache(router)
        warmup(router)

        conversation_history: List[Dict[str, str]] = []
        per_rows: List[Dict[str, Any]] = []
        t_experiment = time.perf_counter()

        for i, qi in enumerate(query_items):
            conversation_history.append({"role": "user", "content": qi.text})
            base = {
                "query_set": run_cfg.query_set_name,
                "strategy": strategy,
                "cache_mode": cache_mode,
                "token_threshold": threshold,
                "query_index": i,
                "query_text": qi.text,
                "expected_device": qi.expected_device,
            }
            start_time = datetime.now()
            t0 = time.perf_counter()
            try:
                response, response_tokens, device_used = \
                    router.route_query(conversation_history)
            except Exception as exc:
                latency_ms = int((time.perf_counter() - t0) * 1000)
                per_rows.append({**base, "device_used": "error",
                                 "start_time": start_time,
                                 "end_time": datetime.now(),
                                 "latency_ms": latency_ms,
                                 "response_tokens": 0, "energy_mJ": 0.0})
                print(f"[err] strategy={strategy} i={i}: {exc}")
                continue

            end_time = datetime.now()
            latency_ms = int((time.perf_counter() - t0) * 1000)

            if isinstance(response, dict):
                assistant_text = str(response.get("response", ""))
                meta = {k: response.get(k, "") for k in
                        ("cache_hit", "routing_method", "routing_confidence",
                         "routing_reasoning", "routing_overhead_ms")}
            else:
                assistant_text = str(response)
                meta = {}
            conversation_history.append(
                {"role": "assistant", "content": assistant_text})

            # last_result is only fresh when this query actually ran the
            # engine: cache hits and double-tier failures leave it stale.
            tier = router.tiers.get(device_used)
            result = tier.last_result if tier else None
            fresh = (result is not None and not meta.get("cache_hit")
                     and (not isinstance(response, dict)
                          or response.get("ok", True)))
            ttft_ms = round(result.ttft_ms, 2) if fresh else ""
            tok_per_s = round(result.tokens_per_s, 2) if fresh else ""

            per_rows.append({
                **base,
                "device_used": device_used,
                "cache_hit": meta.get("cache_hit", ""),
                "routing_method": meta.get("routing_method", ""),
                "routing_confidence": meta.get("routing_confidence", ""),
                "routing_reasoning": meta.get("routing_reasoning", ""),
                "routing_overhead_ms": meta.get("routing_overhead_ms", ""),
                "start_time": start_time,
                "end_time": end_time,
                "latency_ms": latency_ms,
                "response_tokens": int(response_tokens or 0),
                "ttft_ms": ttft_ms,
                "decode_tok_per_s": tok_per_s,
            })

        experiment_wall[(strategy, cache_mode, threshold)] = (
            time.perf_counter() - t_experiment)
        all_rows.extend(per_rows)

        # Stop tiers between configs to reduce state carryover
        # (routing_chatbot_tester.py:491-498).
        for tier in (router.nano, router.orin):
            try:
                tier.server_manager.stop_server()
            except Exception:
                pass

    if telemetry:
        telemetry.stop()

    # Fill energy + derived per-token metrics, write per-query CSV.
    for row in all_rows:
        dev = row.get("device_used")
        if dev not in ("nano", "orin"):
            row["energy_mJ"] = 0.0
            row["latency_per_token_ms"] = ""
            row["energy_per_token_mJ"] = ""
        else:
            e = (telemetry.energy_for_window(dev, row["start_time"],
                                             row["end_time"])
                 if telemetry else 0.0)
            row["energy_mJ"] = round(e, 3)
            toks = int(row.get("response_tokens") or 0)
            lat = int(row.get("latency_ms") or 0)
            row["latency_per_token_ms"] = (lat / toks) if toks > 0 else ""
            row["energy_per_token_mJ"] = (e / toks) if toks > 0 else ""
        row["start_time"] = row["start_time"].isoformat(sep=" ")
        row["end_time"] = row["end_time"].isoformat(sep=" ")
        append_csv_row(run_cfg.output_per_query_csv, PER_QUERY_HEADERS, row)

    # Per-experiment summary rows.
    grouped: Dict[Tuple[str, str, int], List[Dict[str, Any]]] = {}
    for r in all_rows:
        key = (r["strategy"], r["cache_mode"], int(r["token_threshold"]))
        grouped.setdefault(key, []).append(r)

    for key, rows in grouped.items():
        strategy, cache_mode, threshold = key
        acc = compute_accuracy(rows)

        def agg(dev: str) -> Tuple[int, float, int]:
            sel = [x for x in rows if x.get("device_used") == dev]
            return (sum(int(x.get("latency_ms") or 0) for x in sel),
                    sum(float(x.get("energy_mJ") or 0.0) for x in sel),
                    sum(int(x.get("response_tokens") or 0) for x in sel))

        nano_lat, nano_e, nano_t = agg("nano")
        orin_lat, orin_e, orin_t = agg("orin")
        overall_lat = nano_lat + orin_lat
        overall_e = nano_e + orin_e
        overall_t = nano_t + orin_t

        def per(num, den):
            return round(num / den, 6) if den > 0 else ""

        wall = experiment_wall.get(key, 0.0)
        ttfts = [float(x["ttft_ms"]) for x in rows
                 if x.get("ttft_ms") not in ("", None)]
        lats = [int(x.get("latency_ms") or 0) for x in rows]
        tps = [float(x["decode_tok_per_s"]) for x in rows
               if x.get("decode_tok_per_s") not in ("", None)]

        append_csv_row(run_cfg.output_csv, SUMMARY_HEADERS, {
            "query_set": run_cfg.query_set_name,
            "strategy": strategy,
            "cache_mode": cache_mode,
            "token_threshold": threshold,
            "routing_accuracy": "" if acc is None else round(acc, 4),
            "nano_total_latency_ms": nano_lat,
            "nano_total_energy_mJ": round(nano_e, 3),
            "nano_avg_power_mW": per(nano_e, nano_lat / 1000) or 0.0,
            "nano_total_tokens": nano_t,
            "nano_latency_per_token_ms": per(nano_lat, nano_t),
            "nano_energy_per_token_mJ": per(nano_e, nano_t),
            "orin_total_latency_ms": orin_lat,
            "orin_total_energy_mJ": round(orin_e, 3),
            "orin_avg_power_mW": per(orin_e, orin_lat / 1000) or 0.0,
            "orin_total_tokens": orin_t,
            "orin_latency_per_token_ms": per(orin_lat, orin_t),
            "orin_energy_per_token_mJ": per(orin_e, orin_t),
            "overall_total_latency_ms": overall_lat,
            "overall_total_energy_mJ": round(overall_e, 3),
            "overall_total_tokens": overall_t,
            "overall_latency_per_token_ms": per(overall_lat, overall_t),
            "overall_energy_per_token_mJ": per(overall_e, overall_t),
            "req_per_s": round(len(rows) / wall, 4) if wall > 0 else "",
            "p50_ttft_ms": round(statistics.median(ttfts), 2) if ttfts else "",
            "p50_latency_ms": round(statistics.median(lats), 2) if lats else "",
            "decode_tok_per_s": round(statistics.median(tps), 2) if tps else "",
        })

    print(f"[done] wrote summary -> {run_cfg.output_csv}")
    print(f"[done] wrote per-query -> {run_cfg.output_per_query_csv}")
    return all_rows


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--query-set", required=True,
                   help="Key in query_sets (e.g., general_knowledge)")
    p.add_argument("--thresholds", nargs="+", type=int, default=[4000],
                   help="Thresholds swept ONLY for the token strategy")
    p.add_argument("--fixed-threshold", type=int, default=None,
                   help="Threshold for non-token strategies "
                        "(default: last of --thresholds)")
    p.add_argument("--strategies", nargs="+",
                   default=["token", "heuristic", "semantic", "hybrid"])
    p.add_argument("--cache-modes", nargs="+", default=["off"],
                   choices=["off", "on"])
    p.add_argument("--output-csv", default="benchmark_results.csv")
    p.add_argument("--output-per-query-csv", default="benchmark_per_query.csv")
    p.add_argument("--append", action="store_true",
                   help="Append to existing output CSVs instead of "
                        "starting fresh (multi-invocation sweeps "
                        "accumulating one artifact)")
    p.add_argument("--no-telemetry", action="store_true",
                   help="Disable the card's power sampler")
    p.add_argument("--device", default=None,
                   help="cuda (default: the card; raises with none) or cpu "
                        "(the tiny test tiers)")
    # Accepted-and-ignored: the reference required SSH endpoints for its
    # Jetson power loggers; TPU tiers are in-process.
    for flag, default in (("--nano-ip", None), ("--orin-ip", None),
                          ("--nano-ssh-user", "nano"),
                          ("--orin-ssh-user", "orin")):
        p.add_argument(flag, default=default, help=argparse.SUPPRESS)
    for flag in ("--nano-ssh-port", "--orin-ssh-port"):
        p.add_argument(flag, type=int, default=22, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.query_set not in query_sets:
        raise ValueError(f"Unknown query set: {args.query_set}. "
                         f"Available: {list(query_sets)}")
    query_items = normalize_query_set(query_sets[args.query_set])
    fixed = (args.fixed_threshold if args.fixed_threshold is not None
             else args.thresholds[-1])
    run_cfg = RunConfig(
        query_set_name=args.query_set,
        thresholds=args.thresholds,
        strategies=args.strategies,
        cache_modes=args.cache_modes,
        fixed_threshold_for_non_token=fixed,
        output_csv=args.output_csv,
        output_per_query_csv=args.output_per_query_csv,
        router_kwargs={"cluster": default_cluster(args.device),
                       "device": args.device},
        telemetry=not args.no_telemetry,
    )
    # Fresh files each run to avoid header drift across versions;
    # --append keeps them (ensure_csv_headers only writes headers into
    # empty/new files, so rows accumulate under one header).
    if not args.append:
        for path in (run_cfg.output_csv, run_cfg.output_per_query_csv):
            if os.path.exists(path):
                os.remove(path)
    run_experiment(query_items, run_cfg)


if __name__ == "__main__":
    main()
