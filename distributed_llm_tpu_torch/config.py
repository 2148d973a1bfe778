"""Typed configuration for the PyTorch/CUDA port.

Counterpart of ``distributed_llm_tpu/config.py``, kept as the port's own
copy (the port never imports the JAX package).  It carries the router's
canonical configs (``BENCHMARK_CFG``, ``PRODUCTION_CFG``,
``resolve_config``), every model preset, the bench's and the flagship
cluster, the tier fields the engines, the tier clients and the router
read (batched and sequential speculation, int8 weights, the int8 KV
cache and pool, the dense windowed tick, admission, the context-overflow
policy, drain), the cluster's breaker
and retry fields, the nano and orin tiers of the default cluster and the
tiny test clusters.  Fields whose feature is not ported yet are still
declared with their JAX defaults, and a tier that asks for a non-default
value of one raises ``NotImplementedError`` (``TierConfig.check_ported``)
instead of being silently served without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# -- router-level canonical configs (the JAX package's, key for key) ---------

# Semantic-cache similarity thresholds, calibrated per embedder: hashed
# n-grams alone, and the hybrid trained-encoder + hashed space.
DEFAULT_CACHE_SIMILARITY = 0.40
HYBRID_CACHE_SIMILARITY = 0.17

# Benchmark mode: routing cache off, so each query is routed afresh.
BENCHMARK_CFG: Dict[str, Any] = {
    "token_threshold": 1000,
    "model": "tpu-native-bpe-4k",
    "embedding_model": "hybrid-lexsem-v1",
    "semantic_label_path": "",       # the port's routing/semantic_labels.json
    "semantic_margin_threshold": 0.03,
    "semantic_min_similarity": -0.05,
    "heuristic_long_chars": 800,
    "heuristic_multi_qmarks": 2,
    "heuristic_code_markers_needed": 2,
    "heuristic_context_chars": 3200,
    "weights": {"token": 0.25, "semantic": 0.45, "heuristic": 0.30},
    "cache_enabled": False,
    "perf_window": 30,
    "perf_fail_penalty": 3000.0,
}

# Production: predictive routing cache and response cache on, prefix
# affinity, perf exploration and queue-aware perf scoring.
PRODUCTION_CFG: Dict[str, Any] = {
    **BENCHMARK_CFG,
    "cache_enabled": True,
    "cache_ttl_seconds": 3600,
    "cache_max_size": 500,
    "cache_similarity_threshold": HYBRID_CACHE_SIMILARITY,
    "use_semantic_cache": True,
    "prediction_confidence_threshold": 0.70,
    "enable_response_cache": True,
    "enable_prefix_affinity": True,
    "prefix_affinity_min_confidence": 0.75,
    "prefix_affinity_min_tokens": 32,
    "perf_explore": True,
    "perf_explore_interval": 16,
    "perf_queue_aware": True,
    "perf_queue_penalty_ms": 50.0,
}


def resolve_config(config: Optional[Dict[str, Any]],
                   benchmark_mode: bool) -> Dict[str, Any]:
    """An explicit config wins; otherwise the canonical dict of the mode."""
    if config is not None:
        return config
    return dict(BENCHMARK_CFG) if benchmark_mode else dict(PRODUCTION_CFG)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LLaMA-style decoder-only transformer hyperparameters."""

    name: str
    # "bpe" = the trained subword vocabulary (engine/bpe.py, vocab 4096);
    # "byte" = the byte-level fallback (vocab 512).
    tokenizer: str = "bpe"
    vocab_size: int = 4096
    hidden_size: int = 2048
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int = 8          # grouped-query attention
    ffn_size: int = 5632
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # >1 = Mixture-of-Experts (not ported yet: check_ported refuses it).
    num_experts: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings counted once, tied head)."""
        h, f, l, v = self.hidden_size, self.ffn_size, self.num_layers, self.vocab_size
        kv = self.num_kv_heads * self.head_dim
        attn = h * h + 2 * h * kv + h * h          # q, k, v, o
        mlp = 3 * h * f                            # gate, up, down
        norms = 2 * h * l + h
        return v * h + l * (attn + mlp) + norms


MODEL_PRESETS: Dict[str, ModelConfig] = {
    "nano_1b": ModelConfig(
        name="nano_1b", hidden_size=2048, num_layers=16, num_heads=32,
        num_kv_heads=8, ffn_size=8192, max_seq_len=8192,
    ),
    "orin_8b": ModelConfig(
        name="orin_8b", hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, ffn_size=14336, max_seq_len=8192,
    ),
    "nano_bench": ModelConfig(
        name="nano_bench", hidden_size=1024, num_layers=8, num_heads=16,
        num_kv_heads=8, ffn_size=4096, max_seq_len=2048,
    ),
    "orin_bench": ModelConfig(
        name="orin_bench", hidden_size=2048, num_layers=16, num_heads=16,
        num_kv_heads=8, ffn_size=8192, max_seq_len=2048,
    ),
    "mini_bench": ModelConfig(
        name="mini_bench", hidden_size=512, num_layers=6, num_heads=8,
        num_kv_heads=4, ffn_size=2048, max_seq_len=2048,
    ),
    "nano_test": ModelConfig(
        name="nano_test", hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, ffn_size=128, max_seq_len=256,
    ),
    "draft_test": ModelConfig(
        name="draft_test", hidden_size=32, num_layers=1, num_heads=4,
        num_kv_heads=2, ffn_size=64, max_seq_len=256,
    ),
    "moe_test": ModelConfig(
        name="moe_test", hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, ffn_size=128, max_seq_len=256, num_experts=4,
    ),
    "moe_8x1b": ModelConfig(
        name="moe_8x1b", hidden_size=2048, num_layers=16, num_heads=32,
        num_kv_heads=8, ffn_size=8192, max_seq_len=8192, num_experts=8,
    ),
    "orin_test": ModelConfig(
        name="orin_test", hidden_size=128, num_layers=2, num_heads=8,
        num_kv_heads=4, ffn_size=256, max_seq_len=256,
    ),
}


# Features whose code is not ported yet, with the value that means "off"
# (the JAX package's default).  A tier asking for anything else raises.
_UNPORTED_DEFAULTS = {
    "tp": 1,
    "replicas": 1,
    "checkpoint_path": None,
    "endpoint": None,
    "spawn_cmd": None,
    "tenant_quotas": None,
    "autoscale": False,
}


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """One serving tier: a model preset and its engine's knobs.

    The fields and defaults are the JAX package's.  Only the ones the
    ported main path reads are here; the unported features keep their
    field so a config written for the JAX package fails loudly in
    ``check_ported`` instead of losing the feature."""

    name: str                       # "nano" | "orin" | ...
    model_preset: str               # key into MODEL_PRESETS
    max_new_tokens: int = 256       # decode cap
    temperature: float = 0.0        # greedy by default
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    # decode_batch > 1 selects the continuous-batching engine; 1 (the
    # dataclass default, the documented opt-out) the sequential
    # InferenceEngine over a contiguous KV cache, or SpeculativeEngine
    # with a draft_preset on a greedy tier.  kv_block_size is the paged
    # pool's block; decode_steps_per_tick decode steps run per scheduler
    # tick between two host syncs.
    decode_batch: int = 1
    kv_block_size: int = 64
    decode_steps_per_tick: int = 4
    # The batched engine's decode tick: True = one ragged decode call over
    # every slot's FULL table row at its true position; False = the dense
    # windowed tick, which slices the tables to the smallest prefill
    # bucket covering every active position plus the tick's steps (the
    # full span past the top bucket) and decodes through the paged decode
    # kernel.  Batched speculation needs the ragged tick.
    attention_ragged: bool = True
    # A cold prompt whose bucket exceeds this many tokens prefills in
    # chunks of this size, interleaved with decode ticks (a multiple of
    # kv_block_size; 0/None disables chunking).
    prefill_chunk_tokens: Optional[int] = 256
    # Prefill tokens spent per tick on the in-flight chunked prefill
    # (None = one chunk).
    prefill_chunk_budget: Optional[int] = None
    # Session KV prefix reuse (engine/prefix_cache.py): park each
    # finished prompt's blocks and prefill only the suffix of a prompt
    # that extends it.  share_prefix_kv maps the parked blocks read-only
    # into the new slot (refcounted, copy-on-write boundary block).
    enable_prefix_cache: bool = True
    prefix_cache_entries: int = 2
    share_prefix_kv: bool = True
    # Speculative decoding: the model preset that drafts (greedy-exact;
    # the tier's own model_preset is the zero-extra-weights self-draft).
    # With decode_batch > 1, each scheduler tick drafts up to γ tokens
    # per slot with the draft (its own paged pool behind the SAME block
    # tables), verifies every slot's γ+1 chunk in one fused ragged verify
    # call and keeps each slot's agreeing prefix.  spec_decode is
    # tri-state: None = armed by EngineManager when draft_preset is set
    # on a greedy tier, True = force on, False = serve plain decode.
    # Slots start at spec_gamma_max and an acceptance EWMA scales each
    # one down (to γ=0, plain decode, for low acceptance).
    # speculative_gamma is the sequential SpeculativeEngine's γ (draft
    # tokens per round; decode_batch=1 tiers).
    draft_preset: Optional[str] = None
    speculative_gamma: int = 4
    spec_decode: Optional[bool] = None
    spec_gamma_max: int = 4
    # KV quantization ("none" | "int8") of the paged pool and of the
    # sequential engine's contiguous cache: symmetric per-row int8 with
    # float32 scales; writes quantize, attention reads dequantize.
    kv_quantize: str = "none"
    # Admission control (serving/tiers.py AdmissionController): requests
    # allowed to WAIT beyond the decode_batch slots; past it, or when the
    # queue times the EWMA service time predicts a wait past
    # request_timeout_s, a request fails fast with the reference error
    # shape.  None disables the control.
    admission_max_queue: Optional[int] = 16
    # KV-pressure-aware admission: reject a request whose projected block
    # demand (prompt bucket + decode budget, the batched engine's
    # ``projected_demand_blocks``) exceeds the pool's free plus
    # reclaimable blocks.  False disables the gate (slot/queue admission
    # still applies); tiers on the sequential engine have no block pool
    # and ignore it.
    kv_admission: bool = True
    # Paged KV pool size override, in blocks (engine/paged_kv.py).  None =
    # full residency (decode_batch x blocks-per-slot: every slot can hold
    # max_seq_len at once, no pressure possible).  Smaller values model
    # the fixed device pool: admission gates on projected demand and the
    # engine preempts and replays when a running slot cannot grow.  Must
    # cover at least the largest prefill bucket plus one decode tick for
    # a single slot (validated at engine build).
    kv_pool_blocks: Optional[int] = None
    # Hierarchical KV spill tier (engine/kv_spill.py; batched engines with
    # chunked prefill only): host-RAM byte budget for DEMOTED prefix-cache
    # entries.  An unpinned sole-owner entry evicted from the device
    # prefix cache is snapshot off the pool (a device gather; the
    # device-to-host copy drains on the spill copier thread, never the
    # tick) instead of being dropped, and a later prompt extending it is
    # PROMOTED back by budgeted host-to-device grants riding the
    # chunked-prefill lane.  Promotions that lose the race (entry
    # invalidated, copier stalled, blocks starved, drain) fall back to a
    # cold prefill with byte-identical greedy output.  0/None disables
    # the tier.
    host_kv_bytes: Optional[int] = None
    # Fraction of the per-tick chunked-prefill token budget
    # (prefill_chunk_budget) a promotion's host-to-device grants may
    # spend per tick, charged at face value (one block = kv_block_size
    # tokens): promotion competes with chunk grants under ONE budget, so
    # active streams' TBT bound is unchanged.  Floored at one block per
    # tick so a promotion always progresses.
    host_kv_promote_share: float = 1.0
    # Spill copier queue depth (pending demote snapshots).  A full queue
    # makes further demotions drop (the blocks were already freed; the
    # prefix just isn't spilled) instead of backing up the scheduler.
    host_kv_copier_depth: int = 8
    # Context overflow at the router: "reject" fails fast, "truncate_left"
    # drops the oldest turns until the prompt fits max_seq_len -
    # max_new_tokens.
    overflow_policy: str = "truncate_left"
    # Graceful drain (EngineManager.drain): in-flight requests get this
    # long to finish before the engine stops.
    drain_timeout_s: float = 30.0
    # Per-request wall-clock cap at the serving edge (504 past it).
    request_timeout_s: Optional[float] = 180.0
    # Decode watchdog: pending work with no scheduler progress for this
    # long reads as a wedged engine in health().  None disables it.
    watchdog_stall_s: Optional[float] = 300.0
    # Per-tier SLO targets (obs/slo.py, fed from the router's exactly-once
    # completion exit): a request is goodput only when it completes ok
    # with TTFT <= slo_ttft_ms and per-request p95 time-between-tokens <=
    # slo_tbt_ms.  None disables that criterion.
    slo_ttft_ms: Optional[float] = 2000.0
    slo_tbt_ms: Optional[float] = 200.0
    # Per-device memory budget in GB (utils/hbm_budget.py): when set,
    # EngineManager.start_server budgets weights + KV before building the
    # engine and refuses a tier that does not fit (TierOverCapacityError).
    # None: no budget.
    hbm_gb_per_chip: Optional[float] = None
    # Weight-only quantization ("none" | "int8"): every projection and the
    # tied embedding as int8 with per-output-channel (embedding: per-row)
    # scales, the norms in the model dtype (ops/quant.py); any other mode
    # raises in ops.quant.maybe_quantize.
    quantize: str = "none"
    # -- not ported yet: non-default values raise in check_ported -------
    tp: int = 1
    replicas: int = 1
    checkpoint_path: Optional[str] = None
    endpoint: Optional[str] = None
    spawn_cmd: Optional[Tuple[str, ...]] = None
    tenant_quotas: Optional[Dict[str, Any]] = None
    autoscale: bool = False

    def model(self) -> ModelConfig:
        return MODEL_PRESETS[self.model_preset]

    def draft_model(self) -> ModelConfig:
        """The speculative draft's architecture (``draft_preset``); raises
        KeyError when none is configured, like ``model()`` on a bad
        preset."""
        return MODEL_PRESETS[self.draft_preset]

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for any unported feature this
        tier turns on (tensor parallelism, replicas, checkpoints, remote
        tiers, tenant quotas, the autoscaler, MoE)."""
        on = [f"{k}={getattr(self, k)!r}"
              for k, off in _UNPORTED_DEFAULTS.items()
              if getattr(self, k) != off]
        if on:
            raise NotImplementedError(
                f"tier {self.name}: {', '.join(on)} is not ported to the "
                "PyTorch/CUDA package yet (see ROADMAP.md)")
        for preset in filter(None, (self.model_preset, self.draft_preset)):
            if MODEL_PRESETS[preset].num_experts > 1:
                raise NotImplementedError(
                    f"tier {self.name}: MoE preset {preset!r} is not ported "
                    "to the PyTorch/CUDA package yet (see ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """The deployment's two tiers, behind the router's ``/chat`` service
    or each behind its own ``/query`` server.

    The JAX default gives orin ``tp=4`` and shrinks a tier to the devices
    at hand; the port has one card, so orin is ``tp=1`` until the
    multi-GPU slice."""

    nano: TierConfig = dataclasses.field(
        default_factory=lambda: TierConfig(name="nano", model_preset="nano_1b",
                                           decode_batch=8))
    orin: TierConfig = dataclasses.field(
        default_factory=lambda: TierConfig(name="orin", model_preset="orin_8b",
                                           tp=1, decode_batch=4))
    seed: int = 0
    # Per-tier circuit breaker (serving/breaker.py): OPEN after this many
    # consecutive error-shaped results, shedding the tier for the
    # cooldown; 0 disables it.
    breaker_failures: int = 5
    breaker_cooldown_s: float = 30.0
    # Bounded same-tier retry of transient error shapes, jittered
    # exponential backoff from retry_backoff_s.
    retry_attempts: int = 1
    retry_backoff_s: float = 0.05

    def tiers(self) -> Tuple[TierConfig, TierConfig]:
        return (self.nano, self.orin)


def bench_cluster() -> ClusterConfig:
    """The cluster the bench serves on the card: the north star's pair,
    nano_1b with 8 slots and a 64-token decode cap, orin_8b with 4 slots
    and a 128-token cap, both ``tp=1`` on the ragged tick with int8
    weights, as the JAX package's ``bench_cluster`` serves them (int8
    weight-only serving mirrors the reference deployment, whose Jetsons
    run GGML-quantized models, and halves decode's weight bytes).

    The JAX package's ``bench_cluster`` serves nano_bench and orin_bench,
    sized for a 16 GB TPU v5e; the port keeps its decode caps, slot counts
    and weight format and serves the models its own main path serves (the
    ``/chat`` service's pair) on the 80 GB card.  Its speculative A/B env
    flag has no counterpart (the port has no env knobs), and the JAX
    package's measured tuning table overlays a cluster only when its
    backend matches the running one; its table is the CPU's, so it never
    applies on a card, and the port has none."""
    return ClusterConfig(
        nano=TierConfig(name="nano", model_preset="nano_1b",
                        max_new_tokens=64, quantize="int8", decode_batch=8),
        orin=TierConfig(name="orin", model_preset="orin_8b",
                        max_new_tokens=128, quantize="int8", decode_batch=4))


def flagship_cluster(n_devices: int = 1, kv_int8: bool = False
                     ) -> ClusterConfig:
    """The north star's presets shaped to one card, as the JAX package's
    ``flagship_cluster`` shapes them to one chip: nano_1b (bf16, 8 slots)
    and orin_8b with int8 weights (``tp=1``), both with the (256, 1024,
    2048) bucket ladder.  ``kv_int8`` gives orin an int8 KV cache (the JAX
    package's ``DLLM_FLAGSHIP_KV_INT8`` A/B flag); bf16 KV by default, as
    there.  Five or more devices give the JAX package orin over a ``tp=4``
    submesh; tensor parallelism is not ported, so they raise."""
    if n_devices >= 5:
        raise NotImplementedError(
            f"flagship_cluster({n_devices}): orin_8b over tp=4 needs tensor "
            "parallelism, not ported to the PyTorch/CUDA package yet (see "
            "ROADMAP.md)")
    buckets = (256, 1024, 2048)
    return ClusterConfig(
        nano=TierConfig(name="nano", model_preset="nano_1b",
                        max_new_tokens=64, decode_batch=8,
                        prefill_buckets=buckets),
        orin=TierConfig(name="orin", model_preset="orin_8b",
                        max_new_tokens=128, quantize="int8",
                        kv_quantize="int8" if kv_int8 else "none",
                        decode_batch=4, prefill_buckets=buckets))


def tiny_batched_cluster(nano_slots: int = 4,
                         orin_slots: int = 2) -> ClusterConfig:
    """The JAX package's tiny test tiers with the continuous-batching
    engine: ``nano_test`` and ``orin_test``, buckets (16, 32, 64),
    16-token blocks and a 24-token decode cap.  The JAX tiny orin asks
    for ``tp=4`` on its 8-device CPU mesh; here it is ``tp=1``."""
    common = dict(max_new_tokens=24, prefill_buckets=(16, 32, 64),
                  kv_block_size=16)
    return ClusterConfig(
        nano=TierConfig(name="nano", model_preset="nano_test",
                        decode_batch=nano_slots, **common),
        orin=TierConfig(name="orin", model_preset="orin_test",
                        decode_batch=orin_slots, **common))


def tiny_cluster() -> ClusterConfig:
    """The JAX package's tiny sequential test tiers (``decode_batch=1``):
    ``nano_test`` and ``orin_test``, buckets (16, 32, 64), 16-token blocks
    and an 8-token decode cap.  The JAX tiny orin asks for ``tp=4`` on
    its 8-device CPU mesh; here it is ``tp=1``."""
    common = dict(max_new_tokens=8, prefill_buckets=(16, 32, 64),
                  kv_block_size=16)
    return ClusterConfig(
        nano=TierConfig(name="nano", model_preset="nano_test", **common),
        orin=TierConfig(name="orin", model_preset="orin_test", **common))
