"""Telemetry: the phase timer, the engines' stats snapshot and the tier
memory sampler.

Counterpart of ``distributed_llm_tpu/utils/telemetry.py`` with the same
keys, rounding and log format:

- ``PhaseTimer`` accumulates wall time per named phase
  (tokenize/prefill/decode/detokenize) and the roofline work
  (``utils/roofline.py``) the engines report for each device phase, so
  utilization = work / time falls out of one snapshot.  A device phase
  closes after the host sync its engine already makes there (CUDA work is
  asynchronous), so its wall time covers the device work it launched;
- ``engine_stats`` assembles one engine's entry of GET /stats and of the
  bench's ``tiers`` section;
- ``TierTelemetry`` samples the card's power draw (mW, from
  ``nvidia-smi``) at 1 Hz, writes the reference power logger's
  ``"<ts>: <value>"`` lines and integrates a trace over a query's window
  by the trapezoid rule: mW x s = mJ, the reference's units.  Both tiers
  share one card, so every tier reads the whole card's draw (the JAX
  package, on a TPU that reports no power, samples each tier's carved
  devices' memory in use instead).  On the CPU it reads zeros;
- ``profiler_trace`` captures a ``torch.profiler`` trace around a block
  (the JAX package's ``jax.profiler`` capture): per-kernel device times
  on the card, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import threading
import time
from collections import defaultdict
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Tuple


def device_memory_snapshot(device=None) -> List[Dict[str, Any]]:
    """The memory of ``device``'s card (default: the card, where there is
    one): PyTorch's allocated bytes now and at peak, and the card's total
    memory as the limit.  On the CPU one entry of zeros (the host reports
    no device memory), as the JAX package's CPU devices do."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return [{"device": 0, "platform": "cpu", "bytes_in_use": 0,
                 "peak_bytes_in_use": 0, "bytes_limit": 0}]
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stats = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return [{"device": index, "platform": "gpu",
             "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
             "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
             "bytes_limit": total}]


@contextlib.contextmanager
def profiler_trace(log_dir: str = os.path.join(tempfile.gettempdir(),
                                               "dllm_torch_trace")):
    """Capture a ``torch.profiler`` trace of CPU and, where there is a
    card, CUDA activity around a block; yields the profile (its
    ``key_averages()`` and ``events()`` hold the kernels' device times)
    and writes it as Chrome-trace JSON to ``log_dir/trace.json`` (readable
    in chrome://tracing or ui.perfetto.dev) when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_power_mw(device=None) -> float:
    """The power draw of ``device``'s card in mW, as ``nvidia-smi`` reads
    it (the whole card, whatever runs on it); 0.0 on the CPU.  Raises if
    ``nvidia-smi`` cannot read it."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw",
         "--format=csv,noheader,nounits",
         f"--id={f'GPU-{uuid}' if uuid is not None else index}"],
        capture_output=True, text=True, timeout=10, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1000.0


class PhaseTimer:
    """Accumulates wall-time per named phase across queries, plus the
    roofline work (FLOPs / HBM bytes / tokens, utils/roofline.py) the
    engines report for each device phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.work: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add_work(self, name: str, **amounts: float) -> None:
        """Accumulate work counters (flops, hbm_bytes, tokens) for a phase."""
        acc = self.work[name]
        for key, val in amounts.items():
            acc[key] += float(val)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1000 * self.totals[name]
                                        / max(1, self.counts[name]), 3)}
                for name in list(self.totals)}

    def work_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase accumulated work joined with its measured seconds."""
        return {name: {**{k: round(v, 2) for k, v in list(acc.items())},
                       "seconds": round(self.totals.get(name, 0.0), 4)}
                for name, acc in list(self.work.items()) if acc}


def engine_stats(engine) -> Dict[str, Any]:
    """Per-engine snapshot shared by GET /stats (serving/app.py) and the
    bench's tier section, so the two surfaces cannot drift: phase timings
    and work, the prefix cache, the KV pool, the speculative acceptance.
    Tolerates any engine type (the batched and sequential engines expose
    different subsets) and None."""
    entry: Dict[str, Any] = {}
    if engine is None:
        return entry
    if getattr(engine, "phases", None) is not None:
        entry["phases"] = engine.phases.summary()
        work = engine.phases.work_summary()
        if work:
            entry["work"] = work
    if getattr(engine, "prefix_cache", None) is not None:
        entry["prefix_cache"] = engine.prefix_cache.stats()
    kv_fn = getattr(engine, "kv_stats", None)
    if callable(kv_fn):
        try:
            entry["kv"] = kv_fn()
        except Exception:
            pass
    if hasattr(engine, "acceptance_rate"):
        entry["speculative_acceptance_rate"] = round(
            engine.acceptance_rate, 4)
    return entry


class TierTelemetry:
    """1 Hz sampler of the card's power draw (mW) per tier,
    window-integrable.

    The reference power logger's lifecycle: ``start()``, ``stop()``,
    ``save_log(tier, path)`` (its ``"<ts>: <value>"`` line format) and
    ``energy_for_window`` with the reference harness's trapezoidal
    accumulation.  Every tier reads the whole card: both tiers serve on
    one device, so a tier's window also holds the other tier's draw and
    the card's idle draw.  A sample that cannot be read is skipped."""

    def __init__(self, tiers: Iterable[str], interval_s: float = 1.0,
                 device=None):
        self.tiers = list(tiers)
        self.interval_s = interval_s
        self.device = device
        self.samples: Dict[str, List[Tuple[float, float]]] = {
            t: [] for t in self.tiers}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample_once(self) -> None:
        now = time.time()
        draw = card_power_mw(self.device)
        for tier in self.tiers:
            self.samples[tier].append((now, draw))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._sample_once()
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                         name="tier-telemetry")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=2 * self.interval_s)
        self._thread = None

    def save_log(self, tier: str, path: str) -> None:
        """Write the reference power-log line format: "<unix_ts>: <value>"."""
        with open(path, "w") as f:
            for ts, val in self.samples.get(tier, []):
                f.write(f"{ts:.3f}: {val:.0f}\n")

    def energy_for_window(self, tier: str, start: datetime,
                          end: datetime) -> float:
        """Integrate the piecewise-linear sample trace over [start, end)
        (the reference harness's mW·s accumulation).  Units: <sample
        unit>·s.  The trace is interpolated to the window's edges, so a
        query that ends between two samples still integrates a nonzero
        slice."""
        t0, t1 = start.timestamp(), end.timestamp()
        pts = self.samples.get(tier, [])
        if not pts or t1 <= t0:
            return 0.0

        def value_at(t: float) -> float:
            # Clamp outside the trace; linear interpolation inside.
            if t <= pts[0][0]:
                return pts[0][1]
            if t >= pts[-1][0]:
                return pts[-1][1]
            for (ta, va), (tb, vb) in zip(pts, pts[1:]):
                if ta <= t <= tb:
                    if tb == ta:
                        return va
                    return va + (vb - va) * (t - ta) / (tb - ta)
            return pts[-1][1]

        knots = ([(t0, value_at(t0))]
                 + [(ts, v) for ts, v in pts if t0 < ts < t1]
                 + [(t1, value_at(t1))])
        total = 0.0
        for (ta, va), (tb, vb) in zip(knots, knots[1:]):
            total += 0.5 * (va + vb) * (tb - ta)
        return total
