"""Typed configuration for the PyTorch/CUDA port.

Counterpart of ``distributed_llm_tpu/config.py``, kept as the port's own
copy (the port never imports the JAX package).  It carries every model
preset, the tier fields the engines and the ``/query`` server read
(batched and sequential speculation, the int8 KV cache and pool
included), the nano and orin tiers of the default cluster and the tiny
test clusters.  Fields whose feature is not ported yet are still
declared with their JAX defaults, and a tier that asks for a non-default
value of one raises ``NotImplementedError`` (``TierConfig.check_ported``)
instead of being silently served without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


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
    "quantize": "none",
    "host_kv_bytes": None,
    "kv_pool_blocks": None,
    "checkpoint_path": None,
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
    # Per-request wall-clock cap at the serving edge (504 past it).
    request_timeout_s: Optional[float] = 180.0
    # Decode watchdog: pending work with no scheduler progress for this
    # long reads as a wedged engine in health().  None disables it.
    watchdog_stall_s: Optional[float] = 300.0
    # -- not ported yet: non-default values raise in check_ported -------
    tp: int = 1
    replicas: int = 1
    quantize: str = "none"
    host_kv_bytes: Optional[int] = None
    kv_pool_blocks: Optional[int] = None
    checkpoint_path: Optional[str] = None

    def model(self) -> ModelConfig:
        return MODEL_PRESETS[self.model_preset]

    def draft_model(self) -> ModelConfig:
        """The speculative draft's architecture (``draft_preset``); raises
        KeyError when none is configured, like ``model()`` on a bad
        preset."""
        return MODEL_PRESETS[self.draft_preset]

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for any unported feature this
        tier turns on (tensor parallelism, replicas, int8 weights, host KV
        spill, a constrained pool, checkpoints, MoE)."""
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
    """The deployment's two tiers, each served by its own ``/query``
    server (the two-tier router comes with a later slice).

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

    def tiers(self) -> Tuple[TierConfig, TierConfig]:
        return (self.nano, self.orin)


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
