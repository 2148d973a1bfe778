"""Scenario traffic: shaped, deterministic open-loop schedules.

Counterpart of ``distributed_llm_tpu/bench/scenarios.py``, line for line
in its logic.  ``openloop.py`` sweeps flat Poisson rates to find the
knee; production traffic has shape: diurnal ramps where demand doubles
and halves over a "day", flash crowds, session-heavy stretches and
long-context waves.  This module builds those shapes as piecewise-constant
rate profiles (``Segment``), expands them into ONE absolute seeded arrival
schedule (``schedule``) and replays it against a fire callback
(``run_schedule``).  The elastic leg (bench/elastic.py) and chaos2 ride
the diurnal ramp.

- **Determinism**: the schedule is drawn from
  ``random.Random(zlib.crc32(label) ^ seed)`` (never ``hash()``, which
  PYTHONHASHSEED randomizes per process): the same (segments, label,
  seed) give the same arrival times, kinds and session ids in every
  process, and the same as the JAX package's.
- **Absolute-schedule catch-up**: every arrival has an absolute target
  time; the replay loop sleeps only the remaining distance to it, so
  spawn overhead turns into a short catch-up burst instead of silently
  lowering the offered rate.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

SESSION_POOL = 8          # bounded multi-turn session pool (openloop's)
JOIN_GRACE_S = 90.0       # drain window before a client counts hung
MAX_ARRIVALS = 2000       # bounds threads/memory for a whole scenario

# Workload kinds a Segment's mix can draw: the bench leg maps them to
# prompt classes (chat = short multi-turn, oneshot = fresh session per
# request, long = long-context prompt).  The generator itself is
# agnostic — kinds are labels the fire callback interprets.
KIND_CHAT = "chat"
KIND_ONESHOT = "oneshot"
KIND_LONG = "long"


@dataclass(frozen=True)
class Segment:
    """One piecewise-constant traffic segment: ``duration_s`` of
    Poisson arrivals at ``rate_req_per_s``, each arrival's kind drawn
    from ``mix`` (kind → weight).  ``one_shot_fraction`` of arrivals
    mint a UNIQUE session id (no affinity to exploit); the rest draw
    from the bounded pool (multi-turn — prefix affinity and KV reuse
    exist)."""

    duration_s: float
    rate_req_per_s: float
    mix: Tuple[Tuple[str, float], ...] = ((KIND_CHAT, 1.0),)
    one_shot_fraction: float = 0.0


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: absolute offset from scenario start,
    workload kind, session identity, and its global index."""

    t_s: float
    kind: str
    session: str
    index: int


def total_duration_s(segments: Sequence[Segment]) -> float:
    return sum(s.duration_s for s in segments)


def peak_rate(segments: Sequence[Segment]) -> float:
    return max((s.rate_req_per_s for s in segments), default=0.0)


# -- shape generators ---------------------------------------------------------

def diurnal_ramp(base_rate: float, peak_rate: float, period_s: float,
                 steps: int = 8,
                 mix: Tuple[Tuple[str, float], ...] = ((KIND_CHAT, 1.0),)
                 ) -> List[Segment]:
    """One traffic "day" compressed into ``period_s``: piecewise-linear
    ramp base → peak → base over ``steps`` equal segments (triangular
    profile — monotone rise to the midpoint, monotone fall after).
    The elastic leg's canonical shape: the rise forces scale-up, the
    fall forces idle scale-down, and the symmetry makes
    replica-seconds comparable across policies."""
    steps = max(2, int(steps))
    seg_s = float(period_s) / steps
    # 0 → 1 → 0 triangle over the step index; normalized so the PEAK
    # rate is actually reached (an even step count never samples the
    # apex — its two middle segments both sit at peak instead).
    fracs = [1.0 - abs(2.0 * (i / (steps - 1)) - 1.0)
             for i in range(steps)]
    top = max(fracs)
    return [Segment(seg_s, base_rate + (peak_rate - base_rate) * f / top,
                    mix=mix)
            for f in fracs]


def flash_crowd(base_rate: float, spike_rate: float, total_s: float,
                spike_start_s: float, spike_s: float,
                mix: Tuple[Tuple[str, float], ...] = ((KIND_CHAT, 1.0),)
                ) -> List[Segment]:
    """Steady base load with one hard step to ``spike_rate`` — the
    thundering-herd shape (a link goes viral): no ramp warning, the
    spike IS the first sample.  Tests the breach-window/cooldown
    tradeoff: react inside the spike, don't flap after it."""
    spike_start_s = max(0.0, min(spike_start_s, total_s))
    spike_s = max(0.0, min(spike_s, total_s - spike_start_s))
    out = []
    if spike_start_s > 0:
        out.append(Segment(spike_start_s, base_rate, mix=mix))
    if spike_s > 0:
        out.append(Segment(spike_s, spike_rate, mix=mix))
    rest = total_s - spike_start_s - spike_s
    if rest > 0:
        out.append(Segment(rest, base_rate, mix=mix))
    return out


def session_mix(rate: float, total_s: float,
                one_shot_fraction: float) -> List[Segment]:
    """Session-heavy vs one-shot composition at a flat rate:
    ``one_shot_fraction`` of arrivals mint unique sessions (replica
    affinity has nothing to bind), the rest are multi-turn pool
    sessions (affinity and shared-prefix KV pay).  Sweeping the
    fraction separates capacity wins that come from cache locality
    from ones that come from raw slots."""
    f = max(0.0, min(1.0, float(one_shot_fraction)))
    return [Segment(total_s, rate,
                    mix=((KIND_CHAT, 1.0 - f), (KIND_ONESHOT, f))
                    if 0.0 < f < 1.0
                    else (((KIND_ONESHOT, 1.0),) if f >= 1.0
                          else ((KIND_CHAT, 1.0),)),
                    one_shot_fraction=f)]


def long_context_wave(chat_rate: float, wave_rate: float, total_s: float,
                      wave_every_s: float, wave_s: float) -> List[Segment]:
    """Chat traffic with periodic long-context waves riding on top:
    every ``wave_every_s`` a ``wave_s`` window adds ``wave_rate`` of
    ``long``-kind arrivals (prefill-heavy — the KV-pressure shape that
    exercises the spill tier under elasticity).  Off-wave segments are
    pure chat."""
    wave_every_s = max(wave_s, float(wave_every_s))
    out: List[Segment] = []
    t = 0.0
    while t < total_s:
        calm = min(wave_every_s - wave_s, total_s - t)
        if calm > 0:
            out.append(Segment(calm, chat_rate))
            t += calm
        if t >= total_s:
            break
        burst = min(wave_s, total_s - t)
        total = chat_rate + wave_rate
        out.append(Segment(burst, total,
                           mix=((KIND_CHAT, chat_rate / total),
                                (KIND_LONG, wave_rate / total))))
        t += burst
    return out


# -- schedule materialization -------------------------------------------------

def _draw_kind(rng: random.Random,
               mix: Tuple[Tuple[str, float], ...]) -> str:
    total = sum(w for _, w in mix) or 1.0
    x = rng.random() * total
    acc = 0.0
    for kind, w in mix:
        acc += w
        if x < acc:
            return kind
    return mix[-1][0]


def schedule(segments: Sequence[Segment], label: str = "scenario",
             seed: int = 0,
             max_arrivals: int = MAX_ARRIVALS) -> List[Arrival]:
    """Expand a segment profile into one ABSOLUTE arrival schedule:
    exponential gaps at each segment's rate (a piecewise-constant
    Poisson process — the gap in flight when a boundary passes is
    redrawn at the new rate), each arrival stamped with a kind from
    the segment's mix and a session id.  Deterministic per
    (segments, label, seed) — see the module docstring."""
    rng = random.Random(zlib.crc32(label.encode())
                        ^ (int(seed) & 0xFFFFFFFF))
    out: List[Arrival] = []
    t = 0.0
    t0 = 0.0
    i = 0
    for seg in segments:
        end = t0 + float(seg.duration_s)
        rate = float(seg.rate_req_per_s)
        if rate > 0:
            t = max(t, t0)
            while len(out) < max_arrivals:
                t += rng.expovariate(rate)
                if t >= end:
                    break
                kind = _draw_kind(rng, seg.mix)
                one_shot = (kind == KIND_ONESHOT
                            or rng.random() < seg.one_shot_fraction)
                session = (f"{label}-one-{i}" if one_shot
                           else f"{label}-s{rng.randrange(SESSION_POOL)}")
                out.append(Arrival(t_s=t, kind=kind, session=session,
                                   index=i))
                i += 1
        t0 = end
        if len(out) >= max_arrivals:
            break
    return out


# -- replay -------------------------------------------------------------------

def run_schedule(fire: Callable[[Arrival], None],
                 arrivals: Sequence[Arrival],
                 beat: Callable[[], None] = lambda: None,
                 deadline: Optional[float] = None,
                 time_scale: float = 1.0,
                 join_grace_s: float = JOIN_GRACE_S,
                 label: str = "scenario") -> Dict[str, Any]:
    """Replay an arrival schedule against ``fire`` (one daemon thread
    per arrival — an arrival NEVER waits for an earlier request).
    Openloop's absolute-schedule semantics: each arrival's target
    wall-clock instant is ``start + t_s × time_scale`` and the loop
    sleeps only the remaining distance, so falling behind produces a
    catch-up burst, never a deflated offered rate.  ``deadline``
    (``time.monotonic()``) truncates the replay and clamps the
    straggler join grace (floor 5 s) like the openloop points."""
    threads: List[threading.Thread] = []
    t_start = time.perf_counter()
    truncated = False
    for a in arrivals:
        target = t_start + a.t_s * time_scale
        lag = target - time.perf_counter()
        # Truncate BEFORE sleeping toward an arrival whose target lies
        # past the deadline — sleeping first would blow the budget by
        # up to one full inter-arrival gap.
        if (deadline is not None
                and time.monotonic() + max(lag, 0.0) >= deadline):
            truncated = True
            break
        if lag > 0:
            time.sleep(lag)
        t = threading.Thread(target=fire, args=(a,), daemon=True,
                             name=f"scenario-{label}-{a.index}")
        threads.append(t)
        t.start()
        beat()
    grace = join_grace_s
    if deadline is not None:
        grace = max(5.0, min(grace, deadline - time.monotonic()))
    join_deadline = time.monotonic() + grace
    for t in threads:
        t.join(timeout=max(0.0, join_deadline - time.monotonic()))
        beat()
    hung = sum(1 for t in threads if t.is_alive())
    return {
        "arrivals": len(threads),
        "hung_clients": hung,
        "truncated": truncated,
        "wall_s": round(time.perf_counter() - t_start, 2),
    }
