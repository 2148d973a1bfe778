"""The five routing strategies: token, semantic, heuristic, hybrid, perf.

The port's own copy of ``distributed_llm_tpu/routing/strategies.py``:
the same decision rules, thresholds, confidence formulas, fallback chains
and method names.  The semantic centroids come from the port's own copy
of the labelled examples (``routing/semantic_labels.json``), embedded on
the router's device.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike
from .embedder import cosine, get_embedder
from .token_counter import approx_token_count
from .types import RoutingDecision

logger = logging.getLogger(__name__)


class BaseStrategy:
    def __init__(self, config: Dict[str, Any]):
        self.config = config

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        raise NotImplementedError


# =============================================================================
# Token strategy
# =============================================================================

class TokenStrategy(BaseStrategy):
    """orin iff estimated tokens exceed the threshold; confidence grows with
    distance from the threshold (reference: query_router_engine.py:90-107)."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.threshold = int(config.get("token_threshold", 1000))

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        text = f"{context}\n{query}" if context else query
        tokens = approx_token_count(text)
        device = "orin" if tokens > self.threshold else "nano"
        conf = min(abs(tokens - self.threshold) / max(self.threshold, 1), 1.0)
        return RoutingDecision(
            device=device,
            confidence=float(conf),
            method="token",
            reasoning=f"tokens={tokens} threshold={self.threshold}",
            complexity_score=float(tokens),
        )


# =============================================================================
# Semantic strategy
# =============================================================================

# Used when no label file is available (reference: query_router_engine.py:141-154).
_SEED_SIMPLE = [
    "Hi there",
    "What is 2+2?",
    "Give me a short definition of photosynthesis",
    "What's the capital of France?",
]
_SEED_COMPLEX = [
    "Implement a dynamic-programming solution to the knapsack problem and analyze its complexity",
    "Evaluate the long-term economic trade-offs of carbon pricing policies",
    "Write a comprehensive research proposal with methodology and evaluation criteria",
    "Discuss the impact of quantum algorithms on modern public-key cryptography in detail",
]


def _default_label_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "semantic_labels.json")


class SemanticStrategy(BaseStrategy):
    """Centroid classifier over labeled example embeddings, falling back to
    the token strategy when both similarities are too low ("irrelevant") or
    the margin is too small ("ambiguous")
    (reference: query_router_engine.py:180-213)."""

    def __init__(self, config: Dict[str, Any], embedder=None,
                 device: DeviceLike = None):
        super().__init__(config)
        # Same selection rule as QueryRouter: direct construction with a
        # config must not silently pair hashed embeddings with
        # encoder-calibrated thresholds.
        self.embedder = embedder or get_embedder(config.get("embedding_model"),
                                                 device)
        self.margin_threshold = float(config.get("semantic_margin_threshold", 0.03))
        self.min_similarity = float(config.get("semantic_min_similarity", 0.05))
        # Per-embedder threshold calibration lives WITH the embedder
        # selection: when the config asked for the trained/hybrid space
        # but the hashed fallback is in play, the trained-scale
        # "irrelevant" floor (-0.05) is unreachable on hashed cosines
        # (they are never that negative) — swap in the hashed default.
        from .embedder import HashedNgramEmbedder
        if (isinstance(self.embedder, HashedNgramEmbedder)
                and str(config.get("embedding_model", "")
                        ).startswith(("trained-encoder", "hybrid-lexsem"))
                and self.min_similarity == -0.05):
            self.min_similarity = 0.05
        self._token_fallback = TokenStrategy(config)
        label_path = config.get("semantic_label_path") or _default_label_path()
        self.nano_centroid, self.orin_centroid = self._build_centroids(label_path)

    def _build_centroids(self, label_path: str) -> Tuple[np.ndarray, np.ndarray]:
        nano_texts: List[str] = []
        orin_texts: List[str] = []
        if label_path and os.path.exists(label_path):
            with open(label_path, "r", encoding="utf-8") as f:
                for row in json.load(f):
                    text = (row.get("text") or "").strip()
                    label = (row.get("label") or "").strip().lower()
                    if not text:
                        continue
                    if label == "nano":
                        nano_texts.append(text)
                    elif label == "orin":
                        orin_texts.append(text)
            if len(nano_texts) < 3 or len(orin_texts) < 3:
                raise ValueError(
                    f"semantic labels need >=3 per class, got nano={len(nano_texts)} "
                    f"orin={len(orin_texts)} from {label_path}")
        else:
            nano_texts, orin_texts = _SEED_SIMPLE, _SEED_COMPLEX

        return (
            np.mean(self.embedder.encode(nano_texts), axis=0),
            np.mean(self.embedder.encode(orin_texts), axis=0),
        )

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        emb = self.embedder.encode([query])[0]
        sim_nano = cosine(emb, self.nano_centroid)
        sim_orin = cosine(emb, self.orin_centroid)

        if sim_nano < self.min_similarity and sim_orin < self.min_similarity:
            fb = self._token_fallback.route(query, context)
            return RoutingDecision(
                device=fb.device,
                confidence=fb.confidence * 0.5,
                method="semantic_fallback_irrelevant",
                reasoning=(f"low similarity (n={sim_nano:.2f}, o={sim_orin:.2f}) "
                           f"-> {fb.reasoning}"),
                complexity_score=float(sim_orin),
            )

        margin = abs(sim_orin - sim_nano)
        if margin < self.margin_threshold:
            fb = self._token_fallback.route(query, context)
            return RoutingDecision(
                device=fb.device,
                confidence=float(margin),
                method="semantic_fallback_ambiguous",
                reasoning=(f"ambiguous margin={margin:.3f} "
                           f"(n={sim_nano:.2f}, o={sim_orin:.2f}) -> {fb.reasoning}"),
                complexity_score=float(sim_orin),
            )

        device = "orin" if sim_orin > sim_nano else "nano"
        return RoutingDecision(
            device=device,
            confidence=float(min(1.0, margin / 0.2)),
            method="semantic",
            reasoning=(f"sim_nano={sim_nano:.3f} sim_orin={sim_orin:.3f} "
                       f"margin={margin:.3f}"),
            complexity_score=float(sim_orin),
        )


# =============================================================================
# Heuristic strategy
# =============================================================================

# Own pattern sets covering the reference's category intents
# (query_router_engine.py:231-294): 7 complex buckets → orin, 5 simple → nano.
_COMPLEX_PATTERNS = {
    "code_build_debug": [
        r"\b(implement|refactor|debug|write (a|the|some) (function|program|script|class)|fix (this|my|the) (code|bug))\b",
        r"\b(stack trace|traceback|segfault|exception|compile error|race condition|deadlock)\b",
        r"\b(kubernetes|docker|microservice|load balancer|nginx|grpc|websocket)\b",
        r"\b(system design|architecture|distributed system|scalab|high availability)\b",
    ],
    "math_cs_theory": [
        r"\b(prove|proof|theorem|lemma|induction|derivative|integral|eigen)\b",
        r"\b((time|space) complexity|asymptotic|big[- ]?o|np[- ]hard)\b",
        r"\b(dynamic programming|dijkstra|shortest path|spanning tree|bfs|dfs|backtracking)\b",
    ],
    "reasoning_comparison": [
        r"\b(compare|contrast|trade[- ]?offs?|pros and cons|versus|vs\.?)\b",
        r"\b(evaluate|assess|critique|analyze|analyse)\b",
    ],
    "long_form_generation": [
        r"\b(essay|report|proposal|white ?paper|research paper|literature review|methodology)\b",
        r"\b(comprehensive|in[- ]depth|detailed|step[- ]by[- ]step|walkthrough)\b",
        r"\b(summariz|synthesiz)\w*\b.*\b(everything|all|entire|so far|whole)\b",
        r"\b(transcript|debate|dialogue|as json|markdown table)\b",
    ],
    "data_engineering": [
        r"\b(etl|data pipeline|spark|hadoop|sql|dataframe|schema|dataset)\b",
        r"\b(deduplicate|normalize|transform|parse|ingest)\b.*\b(data|records|rows|file)\b",
    ],
    "medical_analysis": [
        r"\b(symptom|diagnos|treatment|prognosis|chronic|clinical)\b",
        r"\b(migraine|dizziness|fatigue|nausea|inflammation|anxiety|depression|insomnia)\b",
        r"\b(diet|meal|training|exercise|recovery|workout)\b.*\b(plan|regimen|schedule|program)\b",
        r"\b(mental health|psycholog|therap|counsel|physician)\b",
    ],
    "context_heavy": [
        r"\b(using (all|the) (context|history|conversation|above)|based on (our|the|this) (conversation|discussion|context))\b",
        r"\b(continue|expand|elaborate|build on|follow up)\b.*\b(previous|earlier|above|last)\b",
    ],
}

_SIMPLE_PATTERNS = {
    "greeting": [
        r"^\s*(hi|hello|hey|howdy|yo)\b",
        r"\bgood (morning|afternoon|evening|night)\b",
        r"\b(thanks|thank you|cheers)\b",
    ],
    "general_knowledge": [
        r"\b(what is|what are|who is|who was|where is|when did|when was|how many|capital of)\b",
        r"\b(tell me a joke|fun fact|trivia)\b",
        r"\b(how do i|how to|can you tell me)\b",
    ],
    "wellness_tips": [
        r"\b(benefits? of|tips? (for|on)|advice (on|for))\b",
        r"\b(how (often|much)|daily (intake|amount))\b",
        r"\b(healthy|good)\b.*\b(habit|routine|lifestyle)\b",
    ],
    "short_definition": [
        r"\b(define|definition of|meaning of)\b",
        r"\bwhat does\b.*\bmean\b",
    ],
    "tiny_math": [
        r"^\s*\d+\s*[-+*/]\s*\d+\s*\??\s*$",
        r"^\s*what(?:'s| is)\s+\d+\s*[-+*/]\s*\d+\s*\??\s*$",
    ],
}

_CODE_MARKERS = (
    "```", "def ", "class ", "import ", "#include", "Traceback", "Error:",
    "SELECT ", "FROM ", "JOIN ", "WHERE ", ";", "{", "}", "->", "::", "==", "!=",
)


class HeuristicStrategy(BaseStrategy):
    """Ordered rule cascade with pre-compiled regex buckets
    (reference: query_router_engine.py:323-364).  Rule order and confidences:
    complex→orin 0.92; long query→orin 0.80; multi-question→orin 0.80;
    code markers→orin 0.88; heavy context→orin 0.75; simple→nano 0.90;
    short everyday→nano 0.75; else token fallback at half confidence."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.long_chars = int(config.get("heuristic_long_chars", 250))
        self.multi_qmarks = int(config.get("heuristic_multi_qmarks", 3))
        self.code_markers_needed = int(config.get("heuristic_code_markers_needed", 2))
        self.context_chars = int(config.get("heuristic_context_chars", 800))
        self._token_fallback = TokenStrategy(config)
        self._complex = {k: [re.compile(p, re.IGNORECASE) for p in v]
                         for k, v in _COMPLEX_PATTERNS.items()}
        self._simple = {k: [re.compile(p, re.IGNORECASE) for p in v]
                        for k, v in _SIMPLE_PATTERNS.items()}

    @staticmethod
    def _match(text: str, buckets: Dict[str, List[re.Pattern]]) -> Optional[str]:
        for category, patterns in buckets.items():
            if any(p.search(text) for p in patterns):
                return category
        return None

    def _code_signals(self, query: str) -> int:
        return sum(1 for marker in _CODE_MARKERS if marker in query)

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        q = (query or "").strip()
        ql = q.lower()

        category = self._match(ql, self._complex)
        if category:
            return RoutingDecision("orin", 0.92, "heuristic",
                                   f"complex pattern={category}")
        if len(q) >= self.long_chars:
            return RoutingDecision("orin", 0.80, "heuristic",
                                   f"long query chars={len(q)}")
        if q.count("?") >= self.multi_qmarks:
            return RoutingDecision("orin", 0.80, "heuristic",
                                   f"multi-question count={q.count('?')}")
        if self._code_signals(q) >= self.code_markers_needed:
            return RoutingDecision("orin", 0.88, "heuristic",
                                   "code/debug markers detected")
        if context and len(context) >= self.context_chars:
            return RoutingDecision("orin", 0.75, "heuristic",
                                   f"large context chars={len(context)}")

        category = self._match(ql, self._simple)
        if category:
            return RoutingDecision("nano", 0.90, "heuristic",
                                   f"simple pattern={category}")
        if len(ql.split()) <= 15 and len(q) <= 100:
            return RoutingDecision("nano", 0.75, "heuristic", "short everyday query")

        fb = self._token_fallback.route(query, context)
        return RoutingDecision(
            device=fb.device,
            confidence=float(fb.confidence * 0.5),
            method="heuristic_fallback",
            reasoning=f"no heuristic match -> {fb.reasoning}",
            complexity_score=fb.complexity_score,
        )


# =============================================================================
# Hybrid strategy
# =============================================================================

class HybridStrategy(BaseStrategy):
    """Confidence-weighted vote of token + semantic + heuristic
    (reference: query_router_engine.py:382-414).  Final confidence is the
    vote margin over the total weighted mass."""

    def __init__(self, config: Dict[str, Any],
                 embedder=None, device: DeviceLike = None):
        super().__init__(config)
        self.weights = config.get(
            "weights", {"token": 0.35, "semantic": 0.35, "heuristic": 0.30})
        self.members: Dict[str, BaseStrategy] = {
            "token": TokenStrategy(config),
            "heuristic": HeuristicStrategy(config),
        }
        try:
            self.members["semantic"] = SemanticStrategy(config, embedder=embedder,
                                                        device=device)
        except Exception as exc:  # semantic vote dropped, like the reference
            logger.warning("hybrid: semantic member unavailable: %s", exc)

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        scores = {"nano": 0.0, "orin": 0.0}
        parts = []
        for name, member in self.members.items():
            d = member.route(query, context)
            w = float(self.weights.get(name, 0.0))
            scores[d.device if d.device == "orin" else "nano"] += w * d.confidence
            parts.append(f"{name}:{d.device} conf={d.confidence:.2f} w={w:.2f}")

        winner = "orin" if scores["orin"] > scores["nano"] else "nano"
        margin = abs(scores["orin"] - scores["nano"])
        total = scores["orin"] + scores["nano"]
        conf = margin / total if total > 1e-12 else 0.5
        return RoutingDecision(
            device=winner,
            confidence=float(min(max(conf, 0.0), 1.0)),
            method="hybrid",
            reasoning=(f"nano_score={scores['nano']:.3f} "
                       f"orin_score={scores['orin']:.3f} | " + " | ".join(parts)),
        )


# =============================================================================
# Perf strategy
# =============================================================================

class PerfStrategy(BaseStrategy):
    """Routes to the device with the better rolling latency-per-token score,
    penalized by failure rate (reference: query_router_engine.py:421-458).
    Score = total_latency/total_tokens + fail_penalty * fail_rate; lower wins.
    No stats at all → default nano at confidence 0.2.

    Queue-aware extension (production only, ``perf_queue_aware``): the
    Router feeds each tier's live load — admission queue depth and batch
    slot occupancy (serving/tiers.py ``load_snapshot``) — via
    ``update_load`` before every decision, and the score adds
    ``perf_queue_penalty_ms`` per queued request (plus a fractional term
    for slot occupancy).  A saturated tier thus sheds quality-equivalent
    traffic to an idle one BEFORE requests start timing out; the rolling
    latency window alone only learns that after the damage.  Off by
    default so BENCHMARK_CFG keeps the reference's exact scoring.
    """

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.window = int(config.get("perf_window", 30))
        self.fail_penalty = float(config.get("perf_fail_penalty", 3000.0))
        self.samples: Dict[str, deque] = {
            "nano": deque(maxlen=self.window),
            "orin": deque(maxlen=self.window),
        }
        self.queue_aware = bool(config.get("perf_queue_aware", False))
        self.queue_penalty_ms = float(
            config.get("perf_queue_penalty_ms", 50.0))
        # device -> (queue_depth, slot_occupancy in [0,1]), refreshed by
        # the Router before every decision; plain dict swaps are atomic
        # under the GIL, concurrent readers see either snapshot.
        self._load: Dict[str, Tuple[float, float]] = {}
        self._remote_load: Dict[str, Tuple[float, float]] = {}
        # Production-only exploration (PRODUCTION_CFG sets perf_explore;
        # benchmark mode keeps the reference's never-explore scoring).
        self.explore = bool(config.get("perf_explore", False))
        self.explore_interval = int(config.get("perf_explore_interval", 16))
        self._route_count = 0
        self._last_seen: Dict[str, int] = {}
        # Production serving routes on concurrent HTTP threads; the probe's
        # one-per-staleness-window invariant depends on read-modify-write
        # of (_route_count, _last_seen) being atomic.
        self._explore_lock = threading.Lock()
        # Circuit-breaker state fed by the Router (serving/breaker.py):
        # an OPEN tier scores a whole fail_penalty on top — it sheds
        # quality-equivalent traffic the moment the breaker trips, not
        # after the rolling window fills with failures.  Dict swaps are
        # atomic under the GIL (same pattern as _load).
        self._breaker_open: Dict[str, bool] = {}

    def update_breaker(self, device: str, is_open: bool) -> None:
        """Record a tier's breaker state (Router feeds this alongside the
        live load before each decision)."""
        if device in self.samples:
            self._breaker_open[device] = bool(is_open)

    def update(self, device: str, latency_ms: float, tokens: int, ok: bool = True) -> None:
        if device in self.samples:
            self.samples[device].append((float(latency_ms), int(tokens), bool(ok)))
            with self._explore_lock:
                self._last_seen[device] = self._route_count

    def merge_remote(self, device: str,
                     remote: List[Tuple[float, int, bool]]) -> None:
        """Fold in samples gathered from other hosts (the HealthMonitor's
        perf-row merge)."""
        for lat, tok, ok in remote:
            self.update(device, lat, tok, ok)

    def update_load(self, device: str, queue_depth: float = 0.0,
                    active_slots: float = 0.0, max_slots: float = 1.0,
                    remote: bool = False) -> None:
        """Record a tier's live load (queue depth + slot occupancy) for
        the queue-aware score term.  The Router feeds the local part
        before each decision; the health monitor's exchange feeds the
        other hosts' sum with ``remote=True`` on its own cadence.  The
        two parts add in the penalty, so a local refresh never clobbers
        the remote view."""
        if device in self.samples:
            occupancy = float(active_slots) / max(1.0, float(max_slots))
            entry = (max(0.0, float(queue_depth)),
                     min(1.0, max(0.0, occupancy)))
            (self._remote_load if remote else self._load)[device] = entry

    def _queue_penalty(self, device: str) -> float:
        if not self.queue_aware:
            return 0.0
        depth, occupancy = self._load.get(device, (0.0, 0.0))
        r_depth, r_occ = self._remote_load.get(device, (0.0, 0.0))
        return self.queue_penalty_ms * (depth + occupancy + r_depth + r_occ)

    def _score(self, device: str) -> float:
        data = list(self.samples[device])
        if not data:
            return float("inf")
        total_lat = sum(s[0] for s in data)
        total_tok = sum(s[1] for s in data)
        fail_rate = 1.0 - sum(1 for s in data if s[2]) / len(data)
        breaker = self.fail_penalty if self._breaker_open.get(device) else 0.0
        if total_tok == 0:
            return (total_lat / len(data) + self.fail_penalty * fail_rate
                    + self._queue_penalty(device) + breaker)
        return (total_lat / total_tok + self.fail_penalty * fail_rate
                + self._queue_penalty(device) + breaker)

    def _explore_probe(self) -> Optional[RoutingDecision]:
        """Deterministic staleness probe: route to the tier with no fresh
        sample within the last explore_interval routed queries (a
        never-seen tier is infinitely stale) so the rolling scores stay
        live.  Marking ``_last_seen`` at probe time — not at sample
        arrival — bounds probing to one per staleness window even while
        the probe's own sample is still in flight (a 180 s in-flight
        call must not attract every concurrent request)."""
        if not self.explore:
            return None
        with self._explore_lock:
            self._route_count += 1
            floor = -10 ** 9
            staleness = {d: self._route_count - self._last_seen.get(d, floor)
                         for d in self.samples}
            stale = [d for d, age in staleness.items()
                     if age >= self.explore_interval]
            if not stale:
                return None
            device = max(stale, key=staleness.get)
            self._last_seen[device] = self._route_count
        return RoutingDecision(
            device=device,
            confidence=0.30,
            method="perf",
            reasoning=f"exploration probe: no fresh perf sample for "
                      f"{device} in the last {self.explore_interval} "
                      f"queries",
            transient=True,
        )

    def route(self, query: str, context: Optional[str] = None) -> RoutingDecision:
        probe = self._explore_probe()
        if probe is not None:
            return probe
        nano_s, orin_s = self._score("nano"), self._score("orin")
        if nano_s == float("inf") and orin_s == float("inf"):
            if self.queue_aware:
                # No latency history yet, but live load still
                # discriminates: don't stack a saturated tier's queue
                # while an idle one waits.
                pen = {d: self._queue_penalty(d) for d in self.samples}
                if pen["nano"] != pen["orin"]:
                    device = min(pen, key=pen.get)
                    return RoutingDecision(
                        device, 0.3, "perf",
                        f"no perf stats yet -> least-loaded {device} "
                        f"(queue penalties nano={pen['nano']:.0f} "
                        f"orin={pen['orin']:.0f})")
            return RoutingDecision("nano", 0.2, "perf",
                                   "no perf stats yet -> default nano")
        device = "orin" if orin_s < nano_s else "nano"
        return RoutingDecision(
            device=device,
            confidence=0.70,
            method="perf",
            reasoning=f"scores nano={nano_s:.2f} orin={orin_s:.2f} -> {device}",
        )


AVAILABLE_STRATEGIES = {
    "token": TokenStrategy,
    "semantic": SemanticStrategy,
    "heuristic": HeuristicStrategy,
    "hybrid": HybridStrategy,
    "perf": PerfStrategy,
}
