"""Legacy threshold-sweep tester (the v1 harness).

Counterpart of ``distributed_llm_tpu/bench/legacy_tester.py``, the port
of the reference's src/tests/chatbot_tester.py: the earlier
single-strategy harness that sweeps the context threshold over a
``Chatbot`` and writes the ``final_results.csv`` schema that
results_analysis.ipynb reads ("Query Set", "Context Threshold", then per
tier Latency / Energy / Avg Power / Tokens Generated), the schema of the
stored baseline numbers (BASELINE.md)::

    python -m distributed_llm_tpu_torch.bench.legacy_tester \\
        --query-set personal_health --thresholds 100 500 1000 \\
        [--device cpu]

Energy, as the JAX package computes it (the reference summed raw 1 Hz
samples, chatbot_tester.py:225): the telemetry trace integrated over each
query's window.  Here the trace is the card's power draw, sampled at 1 Hz
from ``nvidia-smi`` by ``utils/telemetry.TierTelemetry`` (mW x s = mJ;
Avg Power = mJ / ms = W).  Both tiers share one card, so each tier's
energy is the whole card's draw during that tier's windows, the other
tier's and the card's idle draw included.  On the CPU the columns read 0.
"""

from __future__ import annotations

import argparse
import csv
import os
from datetime import datetime
from typing import Dict, List, Optional

from ..device import DeviceLike
from ..serving.cli import Chatbot
from .query_sets import query_sets
from .tester import _build_telemetry, normalize_query_set

HEADERS = [
    "Query Set", "Context Threshold",
    "Nano Latency (ms)", "Nano Energy (mJ)", "Nano Avg Power (W)",
    "Nano Tokens Generated",
    "Orin Latency (ms)", "Orin Energy (mJ)", "Orin Avg Power (W)",
    "Orin Tokens Generated",
]


class ChatbotTester:
    def __init__(self, test_queries, context_thresholds,
                 strategy: str = "perf", device: DeviceLike = None):
        self.test_queries = normalize_query_set(test_queries)
        self.context_thresholds = list(context_thresholds)
        self.strategy = strategy
        self.device = device
        self.telemetry = _build_telemetry(device)

    def run(self, query_set_name: str,
            output_file: str = "final_results.csv") -> Dict[int, Dict]:
        self.telemetry.start()
        query_log = []   # (threshold, device, start, end, tokens)
        try:
            for threshold in self.context_thresholds:
                chatbot = Chatbot(strategy=self.strategy, config={
                    "cache_enabled": False,
                    "enable_response_cache": False,
                    "enable_failover": True,
                    "token_threshold": threshold,
                }, device=self.device)
                chatbot.router.set_threshold(threshold)
                for qi in self.test_queries:
                    start = datetime.now()
                    chatbot.add_message("user", qi.text)
                    response, tokens, device = chatbot.router.route_query(
                        chatbot.history)
                    reply = (response.get("response", "")
                             if isinstance(response, dict) else str(response))
                    chatbot.add_message("assistant", reply)
                    query_log.append((threshold, device, start,
                                      datetime.now(), int(tokens or 0)))
                chatbot.shutdown()
        finally:
            self.telemetry.stop()

        results = self.calculate_energy(query_log)
        self.save_results(results, query_set_name, output_file)
        return results

    def calculate_energy(self, query_log) -> Dict[int, Dict]:
        results: Dict[int, Dict[str, List[float]]] = {}
        for threshold, device, start, end, tokens in query_log:
            if device not in ("nano", "orin"):
                continue
            per = results.setdefault(
                threshold, {"nano": [0, 0.0, 0.0, 0], "orin": [0, 0.0, 0.0, 0]})
            latency = round((end - start).total_seconds() * 1000)
            energy = self.telemetry.energy_for_window(device, start, end)
            per[device][0] += latency
            per[device][1] += energy
            per[device][3] += tokens
        for per in results.values():
            for device in ("nano", "orin"):
                lat, energy = per[device][0], per[device][1]
                per[device][2] = round(energy / lat, 3) if lat > 0 else 0.0
        return results

    def save_results(self, results, query_set_name: str,
                     output_file: str) -> None:
        file_exists = os.path.exists(output_file)
        with open(output_file, "a", newline="") as f:
            writer = csv.writer(f)
            if not file_exists:
                writer.writerow(HEADERS)
            for threshold, per in results.items():
                writer.writerow([
                    query_set_name, threshold,
                    per["nano"][0], round(per["nano"][1], 3),
                    per["nano"][2], per["nano"][3],
                    per["orin"][0], round(per["orin"][1], 3),
                    per["orin"][2], per["orin"][3],
                ])


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--query-set", default="personal_health")
    p.add_argument("--thresholds", nargs="+", type=int,
                   default=[100, 500, 1000, 2000, 4000])
    p.add_argument("--strategy", default="perf")
    p.add_argument("--output-csv", default="final_results.csv")
    p.add_argument("--device", default=None,
                   help="cpu runs the plain PyTorch path (default: the card)")
    args = p.parse_args(argv)
    tester = ChatbotTester(query_sets[args.query_set], args.thresholds,
                           strategy=args.strategy, device=args.device)
    tester.run(args.query_set, args.output_csv)


if __name__ == "__main__":
    main()
