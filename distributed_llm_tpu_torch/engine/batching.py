"""Continuous batching: many concurrent requests share one decode loop.

Counterpart of the main path of ``distributed_llm_tpu/engine/batching.py``.
A scheduler thread runs in front of the paged KV pool
(engine/paged_kv.py):

- a request **admits** into one of ``decode_batch`` slots when a slot
  and enough KV blocks are free.  A prompt that fits one prefill chunk
  prefills at once (the flash causal kernel, then its K/V is paged into
  the slot's blocks); a LONGER one becomes the tick's single in-flight
  **chunked prefill**, written chunk by chunk straight into its blocks
  (the paged chunk kernel) between decode ticks;
- a prompt that extends a parked one (multi-turn chat) maps the parked
  blocks read-only into its table, copies the mid-block boundary block
  (copy-on-write) and prefills only the suffix;
- every tick runs ``decode_steps_per_tick`` batched decode steps and then
  pulls the tick's [T, B] tokens to the host in ONE sync
  (``_fetch_tick``); blocks grow lazily as sequences grow.  The ragged
  tick (the default) runs the ragged decode kernel over every slot's full
  table row at its true position; a tier with ``attention_ragged=False``
  runs the **dense windowed tick**, which slices the tables to a bucketed
  high-water window (``_suffix_window``) and decodes through the paged
  decode kernel (its int8 twin over an int8 pool);
- with a ``draft_preset`` and ``spec_decode`` armed, a tick is instead
  one **speculative round**: the draft model (its own paged pool behind
  the SAME block tables) drafts up to γ tokens per slot in γ+1 batched
  ragged decode steps, ONE ``verify_step_paged`` call (the ragged verify
  kernel) scores every slot's γ+1 chunk on the target, greedy acceptance
  keeps each slot's agreeing prefix plus the target's own pick, and the
  round's tokens reach the host in one sync.  Each slot's γ adapts to
  its acceptance (an EWMA; γ=0 is plain decode) and blocks grown for
  rejected drafts are rewound.  Greedy output is identical to plain
  decode whatever the draft proposes;
- ``kv_quantize="int8"`` keeps both pools as int8 with per-row scales;
- ``generate()`` blocks on a per-request event while its tokens stream
  out of the shared loop; ``generate_stream()`` yields text deltas.

Every device stage is a **program** (``TickProgram``), as the JAX engine
compiles one, keyed as JAX keys it.  A tick: the ragged tick is one
program, the dense tick one per window rung ``wb`` (JAX's
``("decode", (wb, tp))``), the speculative round one per γ bucket (draft
steps, verify, acceptance and the emitted tokens; JAX's draft and verify
pair).  An admission: the cold prefill per bucket (``"prefill"``: the
forward and the first token), its writer per block count
(``"writer"``: the K/V paged into the slot's blocks), the chunk per
(width, window) (``"chunk_prefill"``: a prefix hit's suffix and each
chunk of a long cold prompt), the copy-on-write copies (``"writer"``'s
``"cow_copy"`` and ``"cow_copy_draft"``) and the draft's prefill,
writer and chunk (``"draft"``).  On the card each is captured once as a
CUDA graph and replayed; on the CPU, which has no graphs, the same body
runs directly, so the CPU tests run exactly the code that is captured.
Nothing runs eagerly on the card: a capture or replay that fails fails
the tick's slots, or the admission, as a failed launch does.  The
programs read static inputs: device buffers allocated once for the
engine's life, filled by ``copy_`` from host arrays (pinned on the card)
before the program runs: a tick's positions, tokens, temperatures, γ caps
and the [B, MB] block table (each dense rung a column view of it; the
table copied only after a row changed, in place); an admission's padded
tokens, start, true length, temperature, table row, block ids and
copy-on-write pair.  Every per-request value a program reads is such a
buffer (the first token's row is gathered on the device from the true
length), never a Python value a capture would freeze.  A writer reads its
prefill program's output in place.  The first token reaches the host in
the admission's one sync.  Each new program is recorded by
``_note_compile(stage, key)`` (a log line and the per-stage key sets in
``tick_stats()["compiled"]``).  ``warmup`` captures what the JAX
engine's compiles: the warm request's programs, the dense tick's second
rung, every γ bucket, the copy-on-write copies and every chunk program a
prefix hit or a long prompt can take; deeper rungs and the other prefill
buckets are captured on first use.  A program always draws its sampling
noise, greedy requests included (``sample_batched`` keeps their argmax),
as JAX's compiled programs do: one program per rung or bucket, not one
per (rung, sampled), and greedy tokens are the same either way.  Kernel
launch counts count replays (``TickProgram``).

Each scheduler pass is also recorded by the engine's tick-phase profiler
(``self.profiler``, obs/profiler.py; ``profile=False`` gives the
zero-cost null profiler), at the JAX engine's phases: ``admit`` (an
admission, with ``prefill`` and ``cow_copy`` nested in it, each holding
its programs' inputs copied in, their captures when new and their
replays),
``table_upload`` (the tick's static inputs copied in), ``decode`` (a
plain tick's program, its capture when it is new, and its pull),
``verify`` (a speculative round: one replayed program where the JAX
engine stamps a ``draft`` and a ``verify`` phase), ``emit`` (the tick's
host work after its pull: its accounting, below, and the token fan-out;
the JAX engine leaves the accounting unstamped) and ``chunk_prefill``.
A capture is the port's compile: it stamps the ``compile`` event and
lands inside the phase that paid for it (the tick's, or the admission's
``prefill``, ``chunk_prefill`` or ``cow_copy``), as a JAX compile does.
Each decode tick's time is split evenly over the slots it served and
charged to
their requests' traces (``spans.charge``), with the KV blocks each holds
(a shared block at 1/refcount).  Warmup's own ticks serve no request and
are not recorded.  The requests' span trees get the JAX engine's spans
and events (prefill, prefill_chunk, detokenize, ...), and the
process-global metrics its tick, program, prefix-hit, prefill-chunk and
speculation families.

Each prefill (cold, prefix hit, chunk) and each scheduler tick is timed
as a "prefill" or "decode" phase of ``self.phases``
(``utils/telemetry.PhaseTimer``) with the roofline work the JAX engine
accounts for it (``utils/roofline.py``; the decode span is the active
kernel's, ``ops.attention.decode_kv_span``).  A phase closes after the
host sync the engine already makes there (the first token's read, the
tick's ``_fetch_tick``), so on the card its wall time covers the device
work it launched; a tick's phase wraps the replay, never a capture (an
admission's holds its programs' captures when they are new, as the JAX
engine's holds their compiles).  A speculative round is one "decode"
phase where the JAX engine times its draft and its verify apart.

A constrained pool (``kv_pool_blocks``) binds: admission allocates
lazily and stays queued when blocks run short (the tier client's KV gate
reads ``projected_demand_blocks`` against ``kv_stats``), and a slot whose
next block (or copy-on-write block before a speculative round) cannot be
allocated after evicting every parked prefix first cancels the in-flight
chunked prefill, then **preempts** the youngest slot (``_preempt``): its
blocks are freed, its generated tokens park on the request, and the
request re-admits at the scheduler head through ``_admit_replay``, which
prefills prompt + generated prefix and resumes decoding from the last
emitted token (nothing is re-sampled or re-emitted; greedy output equals
the unpreempted run).  Only a sole occupant that cannot grow finishes
early with what it has (the JAX engine's rule: preempting itself would
replay into the same wall).  A released or preempted slot's table row
points at the trash block before the next tick's program reads it.

With ``host_kv_bytes`` a host-RAM spill tier (engine/kv_spill.py) sits
under the prefix cache: an evicted sole-owner entry is DEMOTED (a device
gather on the engine's stream, the blocks freed at once, the
device-to-host copy on the spill copier's side stream), and a prompt
extending a demoted prefix PROMOTES it back as an in-flight chunked
prefill whose leading blocks are host-to-device copies granted under the
chunk budget (``_advance_promotion``).  The spill copies run eagerly
(``index_select`` / ``index_copy_`` and the copies between host and
device, under JAX's ``"spill"`` keys in ``_compiled``); they are no
program and never a capture.

A replica restart (serving/replicas.py) rescues the engine's work:
``capture_requests`` joins the loop and takes every queued and in-flight
request (each slot's emitted tokens parked on it, as ``_preempt`` parks
them), ``adopt_requests`` queues them on a sibling or the rebuilt engine,
where ``_admit_replay`` resumes them; ``detach_spill`` and
``adopt_spill`` carry the host spill store across the restart.

Tenant quotas (``TierConfig.tenant_quotas``, serving/tenants.py): each
request carries its tenant; arrivals drain into per-tenant lanes served by
deficit-weighted round-robin on the quotas' weights, a tenant's γ is
capped by its ``spec_gamma_max``, parked prefixes are tagged with their
tenant and billed at 1/refcount (``tenant_kv_blocks``), eviction takes an
over-budget tenant's entries first and growth preempts the most
over-budget tenant's slot first.  With ``tenant_quotas=None`` every path
is the tenant-less one.  ``demote_parked`` is the scale-down sweep of
serving/replicas.py.

With a ``group`` (``parallel/mesh.DeviceGroup``) of ``tp`` > 1 slots the
engine runs tensor-parallel, as the JAX engine does over a tier mesh
(a MoE tier's ``ep`` > 1 slots run its experts, ``models/moe``):
the weights split by Megatron's rules (``parallel/sharding.shard_params``)
and the pool by kv heads, one pool per shard under the one allocator,
block tables and prefix cache.  Every step runs each shard's heads on
its own pool (``parallel/tp_attention.tp_layers``), so the same programs,
keys and ticks serve it: ONE decode program per engine, each stage one
captured program holding every shard's launches (on a group that shares
one card, one CUDA graph).  The tables, sampling and a separate draft
(replicated in JAX: it drafts the whole batch on every chip) live on the
group's first device; a self-draft shares the sharded weights and keeps
a sharded pool of its own.  A gate the group fails (``_tp_ragged_ok``)
keeps the dense windowed tick, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import TierConfig
from ..device import DeviceLike, resolve_device
from .. import models
from ..models import transformer
from ..models.checkpoint import load_params_for_tier
from ..models.transformer import Transformer
from ..obs import get_observability
from ..obs import spans as obs_spans
from ..obs.profiler import DEFAULT_CAPACITY, make_profiler
from ..ops import quant
from ..ops.attention import decode_kv_span
from ..ops.sampling import sample_batched
from ..parallel.mesh import DeviceGroup
from ..parallel.sharding import kv_pool_shards, shard_params
from ..parallel.tp_attention import _tp_ragged_ok
from ..serving.errors import error_dict
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .inference import GenerationResult, prepare_prompt, trim_at_eos
from .kv_spill import COPYING, DEAD, HostKVSpill
from .paged_kv import (BlockAllocator, PagedConfig, TRASH_BLOCK,
                       chunk_prefill_paged, copy_block, decode_step_paged,
                       gather_blocks, init_pool, pool_block_bytes,
                       scatter_blocks, verify_step_paged,
                       write_prefill_blocks)
from .prefix_cache import PrefixCache, select_reuse
from .programs import TickProgram, capture_program
from .tokenizer import StreamDecoder, get_tokenizer

History = Union[str, Sequence[Dict[str, Any]]]

logger = logging.getLogger(__name__)

# Per-slot adaptive γ: EWMA weight of a round's observed acceptance, and
# the floor under which a slot stops speculating (γ=0, sticky for the
# slot's life: it rides the verify's first row only, i.e. plain decode).
SPEC_EWMA_ALPHA = 0.3
SPEC_EWMA_FLOOR = 0.125


class EngineStoppedError(RuntimeError):
    """A request failed by ``stop()`` while queued or in flight; carries
    the reference error-dict shape in ``.shape``."""

    def __init__(self, shape: Dict[str, Any]):
        super().__init__(str(shape.get("error", "engine stopped")))
        self.shape = dict(shape)


def _fetch_tick(x: torch.Tensor) -> np.ndarray:
    """THE tick's one device -> host sync: all of a tick's tokens (the
    plain tick's [T, B], a speculative round's [B, γ+2] tokens and
    accept counts) become observable in one pull."""
    # dllm-lint: disable=transfer-host-sync -- THE one sanctioned sync per tick: the tick boundary, where all of a tick's tokens become observable in one pull (plain [T,B] or speculative (out, n_acc)) — every other hot-path sync must justify itself against this one
    return x.cpu().numpy()


@dataclasses.dataclass
class _Request:
    history: History
    max_new_tokens: Optional[int]
    temperature: Optional[float]
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[GenerationResult] = None
    error: Optional[BaseException] = None
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    # Streaming: every emitted token id is pushed here; None ends it.
    token_queue: Optional["queue.Queue"] = None
    # Set when admission deferred because the single chunked-prefill
    # lane was busy: the scheduler stops re-popping (and re-tokenizing)
    # the head request until the lane frees.
    needs_chunk: bool = False
    # The submitting request's span tree (obs/spans.py), captured at
    # submit (the scheduler thread has no context of its own).
    trace: Optional[Any] = None
    # Preemption: the slot's generated tokens (already emitted) park here
    # and the request re-queues at the scheduler head; re-admission
    # replays prompt + prefix (``_admit_replay``).  The original TTFT
    # survives the round trip.
    replay_tokens: Optional[List[int]] = None
    replay_ttft_ms: Optional[float] = None
    preempt_count: int = 0
    # First-admission order: the victim policy picks the YOUNGEST slot,
    # and a replayed request keeps its age.
    admit_seq: int = -1
    # Billing identity: the tenant whose quota this request draws down
    # (None bills to the default tenant where tenant state exists).
    tenant: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    request: _Request
    blocks: List[int]
    prompt_len: int
    budget: int
    temperature: float
    ttft_ms: float
    tokens: List[int] = dataclasses.field(default_factory=list)
    prompt_ids: tuple = ()
    # Growth cap in pool blocks (prompt bucket + decode budget).
    max_blocks: int = 0
    # Shared-prefix hit: the PrefixEntry this slot pinned.
    pinned_entry: Optional[Any] = None
    # Speculation: whether the admission seeded this slot's draft KV (and
    # the slot is greedy), its adaptive γ (0 = plain decode, sticky), the
    # acceptance EWMA driving γ, and lifetime draft/accept counts.
    spec: bool = False
    gamma: int = 0
    accept_ewma: float = 1.0
    spec_drafted: int = 0
    spec_accepted: int = 0


@dataclasses.dataclass
class _Prefill:
    """The tick's single in-flight chunked prefill: a request whose prompt
    is written into its reserved slot's blocks one chunk per grant,
    interleaved with decode ticks."""

    request: _Request
    slot_ix: int                  # reserved slot (no _Slot until done)
    seq: List[int]                # prompt, or prompt + generated[:-1]
    prompt_len: int
    prompt_ids: tuple
    total: int
    budget: int
    temperature: float
    max_blocks: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    consumed: int = 0
    chunks_done: int = 0
    # A preempted request's generated tokens: the final chunk's sample is
    # discarded and decode resumes from replay[-1].
    replay: Optional[List[int]] = None
    # Host spill promotion: the leading ``promote_nb`` blocks (covering
    # ``promote_tokens`` positions) are host-to-device copies of the
    # claimed entry, granted by ``_advance_promotion``; then ``consumed``
    # jumps to ``promote_tokens`` and the suffix chunk-prefills.  Once
    # every grant is issued the pin moves to ``promote_held`` (with
    # ``promote_event`` recorded after the copies on the card) until the
    # copies are known complete: the pin keeps the host tiles alive.
    promote_entry: Optional[Any] = None
    promote_tokens: int = 0
    promote_nb: int = 0
    promote_done: int = 0
    promote_waits: int = 0
    promote_held: Optional[Any] = None
    promote_event: Optional[Any] = None
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


class ContinuousBatchingEngine:
    """The batched engine behind a tier: ``generate()``/``generate_stream()``
    for concurrent callers, one shared decode loop.  Runs on the card
    unless ``device="cpu"`` is asked for (the plain PyTorch path).
    ``params``/``draft_params`` replace the seeded random target/draft
    weights (whole: a ``group`` shards them).  ``group``: the tier's
    device group (``parallel/mesh.DeviceGroup``); with ``tp`` > 1 slots
    the engine runs tensor-parallel over them, with one slot on that
    slot's device; it replaces ``device``."""

    # Concurrent callers share the scheduler: the tier client does not
    # serialize them.
    concurrent_safe = True

    def __init__(self, tier: TierConfig, seed: int = 0,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None,
                 draft_params: Optional[Transformer] = None,
                 profile: bool = True,
                 profile_ticks: int = DEFAULT_CAPACITY,
                 group: Optional[DeviceGroup] = None):
        tier.check_ported()
        if tier.decode_batch <= 1:
            raise NotImplementedError(
                f"tier {tier.name}: decode_batch={tier.decode_batch} selects "
                "the sequential InferenceEngine (EngineManager builds it); "
                "the batched engine needs decode_batch > 1")
        self.tier = tier
        self.device = (group.lead if group is not None
                       else resolve_device(device))
        self.group = group if group is not None and group.parallel else None
        self.cfg = tier.model()
        bad = [b for b in tier.prefill_buckets if b % tier.kv_block_size]
        if bad:
            raise ValueError(
                f"prefill buckets {bad} not multiples of kv_block_size="
                f"{tier.kv_block_size}: prefilled K/V must page evenly")
        self.tokenizer = get_tokenizer(self.cfg)
        self.paged = PagedConfig(block_size=tier.kv_block_size,
                                 max_slots=tier.decode_batch,
                                 max_seq_len=self.cfg.max_seq_len,
                                 pool_blocks=tier.kv_pool_blocks)
        if tier.kv_pool_blocks is not None:
            # A constrained pool must still fit ONE largest-bucket prefill
            # plus a decode tick, or no request could ever admit.
            min_blocks = (max(bb for bb in tier.prefill_buckets
                              if bb <= self.cfg.max_seq_len)
                          // tier.kv_block_size + 1)
            if tier.kv_pool_blocks < min_blocks:
                raise ValueError(
                    f"kv_pool_blocks={tier.kv_pool_blocks} cannot fit one "
                    f"largest-bucket prefill plus a decode tick (needs "
                    f">= {min_blocks} blocks of {tier.kv_block_size})")
        self.steps_per_tick = max(1, tier.decode_steps_per_tick)
        self.chunk_tokens = int(tier.prefill_chunk_tokens or 0)
        if self.chunk_tokens < 0 or (self.chunk_tokens
                                     and self.chunk_tokens
                                     % tier.kv_block_size):
            raise ValueError(
                f"prefill_chunk_tokens={tier.prefill_chunk_tokens} must be"
                f" a positive multiple of kv_block_size="
                f"{tier.kv_block_size}, or 0/None to disable chunking")
        self.chunk_budget = max(self.chunk_tokens,
                                int(tier.prefill_chunk_budget or 0))

        if self.device.type == "cuda":
            # Every kernel compiles (in parallel) before the first request.
            from ..ops import _build
            _build.build_all()
        if params is None and tier.checkpoint_path:
            # The tier's trained weights win over random init.
            params = load_params_for_tier(tier.checkpoint_path, self.cfg,
                                          device=self.device)
        if params is None:
            params = models.init_params(self.cfg, seed=seed,
                                        device=self.device)
        # int8 weights (tier.quantize), quantized in place one weight at a
        # time on the device.
        self.model = quant.maybe_quantize(params.to(self.device), tier,
                                          self.cfg)
        del params
        if self.group is not None:
            # Quantized whole, then split (JAX's quantized_param_specs).
            self.model = shard_params(self.model, self.group)
            self.pool = kv_pool_shards(self.cfg, self.paged,
                                       tier.kv_quantize, self.group)
        else:
            self.pool = init_pool(self.cfg, self.paged, tier.kv_quantize,
                                  device=self.device)
        self.allocator = BlockAllocator(self.paged.num_blocks)
        self.ragged = self._resolve_ragged()

        # Batched speculative decoding: the draft model rides the SAME
        # block tables as the target, with its own pool of the target's
        # geometry indexed by the same block ids, so slot and block
        # lifecycle (admission, growth, parking, copy-on-write) is kept
        # once.  Draft KV quality only moves the acceptance rate: the
        # verify rule keeps greedy output identical to plain decode.
        self.spec = False
        self.cfg_d = None
        self.model_d: Optional[Transformer] = None
        self.pool_d = None
        self.spec_gamma_max = max(1, int(tier.spec_gamma_max))
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        # Per-slot-index lifetime [drafted, accepted] (bounded by slots).
        self._spec_slot_acc: Dict[int, List[int]] = {}
        if tier.spec_decode and self._resolve_spec():
            self.spec = True
            self.cfg_d = tier.draft_model()
            if draft_params is not None:
                self.model_d = quant.maybe_quantize(
                    draft_params.to(self.device), tier, self.cfg_d)
            elif tier.draft_preset == tier.model_preset:
                # Self-draft: the draft IS the target (shared weights,
                # quantized with it).
                self.model_d = self.model
            else:
                # A separate draft takes the tier's quantize mode too.
                self.model_d = quant.maybe_quantize(models.init_params(
                    self.cfg_d, seed=seed + 1, device=self.device), tier,
                    self.cfg_d)
            if self.model_d is self.model and self.group is not None:
                # A self-draft shares the sharded weights: its pool shards
                # too.
                self.pool_d = kv_pool_shards(self.cfg_d, self.paged,
                                             tier.kv_quantize, self.group)
            else:
                self.pool_d = init_pool(self.cfg_d, self.paged,
                                        tier.kv_quantize, device=self.device)
            self._wbytes_d = roofline.weight_bytes(self.cfg_d, tier.quantize)
        # γ buckets: powers of two up to spec_gamma_max, plus the max.  A
        # round runs at the bucket covering its slots' largest γ; each
        # slot's own γ caps its acceptance inside the round.
        gmax = self.spec_gamma_max
        self._gamma_buckets = tuple(sorted(
            {1 << i for i in range(gmax.bit_length()) if (1 << i) <= gmax}
            | {gmax}))
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed ^ 0xBA7C4)

        # The tick programs' static inputs: host arrays the scheduler edits
        # in place (views of pinned tensors on the card) and their device
        # buffers, both allocated once for the engine's life.
        b, mb = self.paged.max_slots, self.paged.blocks_per_slot
        self._tables_host, self._tables_dev = self._static(
            (b, mb), torch.int32, TRASH_BLOCK)
        self._tables = self._tables_host.numpy()
        self._tables_dirty = False
        # Dense windowed tick: one [B, wb] column view of the device table
        # per window rung.
        self._tables_dev_w: Dict[int, torch.Tensor] = {}
        # Positions, current tokens, temperatures and γ caps: each [B],
        # copied in before every tick.
        self._staged = [self._static((b,), dtype) for dtype in
                        (torch.int32, torch.int64, torch.float32, torch.int64)]
        ((self._pos, self._pos_dev), (self._cur, self._cur_dev),
         (self._temps, self._temps_dev), (self._caps, self._caps_dev)) = (
            (host.numpy(), dev) for host, dev in self._staged)
        # The admission programs' static inputs, likewise: the padded
        # tokens (each program reads a [1, width] view of one [1, W]
        # buffer), the chunk's start, the prompt's true length and the
        # temperature ([1] each), the slot's table row [MB], the block ids
        # a writer pages into (an [nb] view) and the copy-on-write source
        # and destination ([1] views of one [2]).  An admission stage
        # copies in what it reads (``_stage_admission``).
        width = max(min(max(tier.prefill_buckets), self.cfg.max_seq_len),
                    self.chunk_tokens)
        self._adm = {name: self._static(shape, dtype) for name, shape, dtype
                     in (("tokens", (1, width), torch.int64),
                         ("start", (1,), torch.int32),
                         ("true_len", (1,), torch.int32),
                         ("temp", (1,), torch.float32),
                         ("row", (mb,), torch.int32),
                         ("blocks", (-(-width // self.paged.block_size),),
                          torch.int64),
                         ("cow", (2,), torch.int64))}
        self._adm_dev = {name: dev for name, (_, dev) in self._adm.items()}
        # Programs by (stage, key), and the keys _note_compile saw.
        self._programs: Dict[tuple, TickProgram] = {}
        self._compiled: Dict[str, set] = {}
        self._make_program: Callable[[Callable], TickProgram] = TickProgram
        self._adm_copied = None
        if self.device.type == "cuda":
            # The engine's graphs share one memory pool: they never run
            # at once.
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._make_program = self._capture
            # Marks when the last admission copies have read their pinned
            # host arrays (which the next staging then may rewrite).
            self._adm_copied = torch.cuda.Event()
        self._slots: List[Optional[_Slot]] = [None] * b
        self._buckets = sorted(set(
            bb for bb in tier.prefill_buckets if bb <= self.cfg.max_seq_len))
        # Suffix-chunk attention windows: a coarse block-aligned rung set
        # (the JAX engine's, which bounded its compiled programs; here it
        # bounds how far a chunk's attention reads).
        span = mb * self.paged.block_size
        bs = self.paged.block_size
        self._chunk_windows = sorted(
            {min(span, -(-c // bs) * bs) for c in (256, 1024) if c < span}
            | {span})
        # Suffix buckets a prefix hit may prefill; a longer new turn goes
        # through the cold path.
        self._reuse_buckets = self._buckets[:3]
        self._prefill: Optional[_Prefill] = None
        self.prefill_cancelled_total = 0
        self.prefix_cache = (
            PrefixCache(capacity=tier.prefix_cache_entries,
                        on_evict=self._prefix_evicted,
                        block_refcounts=self.allocator.refcounts)
            if tier.enable_prefix_cache and tier.prefix_cache_entries > 0
            else None)
        self.share_prefix = bool(tier.share_prefix_kv
                                 and self.prefix_cache is not None)
        # Host KV spill tier (engine/kv_spill.py): a host-RAM LRU under the
        # prefix cache.  It needs the chunk machinery: promotion grants
        # ride its per-tick budget.
        self.kv_spill: Optional[HostKVSpill] = None
        self._spill_block_bytes = 0
        host_kv_bytes = int(tier.host_kv_bytes or 0)
        if host_kv_bytes > 0 and self.prefix_cache is not None:
            if not self.chunk_tokens:
                logger.warning(
                    "tier %s: host_kv_bytes=%d ignored: the KV spill tier "
                    "needs chunked prefill (prefill_chunk_tokens) to absorb "
                    "promotion grants", tier.name, host_kv_bytes)
            else:
                self._spill_block_bytes = pool_block_bytes(
                    self.cfg, tier.kv_block_size, tier.kv_quantize)
                self.kv_spill = HostKVSpill(
                    budget_bytes=host_kv_bytes,
                    block_bytes=self._spill_block_bytes,
                    copier_depth=tier.host_kv_copier_depth,
                    min_prefix=self.prefix_cache.min_prefix,
                    tier=tier.name)
        # Promotion stall bound, in scheduler passes: a claimed entry whose
        # demote copy never lands (a wedged copier) must not park the
        # prefill lane forever; past it the promotion loses the race and
        # the prefill restarts cold (counted as a race).
        self._promote_wait_cap = 2000
        # First-admission counter (the preemption victim policy's age) and
        # the engine-life preemption count.
        self._admit_seq = 0
        self.preempted_total = 0

        # Recent decode-tick wall times in ms (tick_stats reads it), and
        # every tick the scheduler ran.
        self.tick_ms: "deque[float]" = deque(maxlen=512)
        self.ticks_total = 0
        self._tick_wb = self.paged.blocks_per_slot   # the last tick's width
        # Per-phase wall time and roofline work (GET /stats, the bench's
        # MFU and HBM accounting): "prefill" and "decode", each closed
        # after the host sync the engine makes there (a prefill's first
        # token, a tick's ``_fetch_tick``).  Only the scheduler thread
        # writes.
        self.phases = PhaseTimer()
        self._wbytes = roofline.weight_bytes(self.cfg, tier.quantize)
        # Tick-phase profiler (obs/profiler.py): a ring of profile_ticks
        # tick records, or the null profiler with profile=False.  Only
        # the scheduler thread stamps it, and not while warmup runs.
        self.profiler = make_profiler(tier.name, enabled=profile,
                                      capacity=profile_ticks)
        self._warming = False
        # Per-slot KV-residency weight (sum of 1/refcount over the slot's
        # blocks), dropped whenever the slot's table row changes: the
        # attribution pays one lookup per slot per tick.
        self._kv_weights: Dict[int, float] = {}
        self._tick_ms = 0.0              # the last tick's decode phase
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # Scheduler-head lane: KV-pressure deferrals and cancelled
        # prefills re-admit before newer arrivals.  Scheduler thread only.
        self._head: "deque[_Request]" = deque()
        # Per-tenant scheduling state.  None = quotas off: the queue is
        # FIFO and every path is the tenant-less one.  On, arrivals drain
        # into per-tenant lanes served by deficit-weighted round-robin;
        # the head lane stays first.  Scheduler thread only.
        self._tenant_quotas = (dict(tier.tenant_quotas)
                               if tier.tenant_quotas is not None else None)
        self._tenant_default_q = None
        if self._tenant_quotas is not None:
            from ..serving.tenants import default_quota
            self._tenant_default_q = default_quota()
        self._tenant_lanes: Dict[str, "deque[_Request]"] = {}
        self._tenant_deficits: Dict[str, float] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = threading.Lock()
        # Watchdog heartbeat: monotonic time of the last completed unit of
        # scheduler progress (admission, tick, prefill chunk, idle pass).
        self._progress_t = time.monotonic()

    # -- device work -------------------------------------------------------

    def _static(self, shape: tuple, dtype: torch.dtype, fill: int = 0):
        """A tick input for the engine's life: (host tensor, pinned on the
        card, and its device buffer), both filled with ``fill``."""
        host = torch.full(shape, fill, dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        return host, torch.full(shape, fill, dtype=dtype, device=self.device)

    def _stage_inputs(self) -> None:
        """Copy the tick's host inputs into the programs' device buffers,
        in place (the table only after a row changed).  The copies are
        ordered before the tick's replay on the stream, and the host
        arrays change only after the tick's sync."""
        if self._tables_dirty:
            self._tables_dev.copy_(self._tables_host, non_blocking=True)
            self._tables_dirty = False
        for host, dev in self._staged:
            dev.copy_(host, non_blocking=True)

    def _stage_admission(self, *, tokens: Optional[Sequence[int]] = None,
                         width: int = 0, start: int = 0, true_len: int = 0,
                         temp: float = 0.0,
                         row: Optional[np.ndarray] = None,
                         blocks: Optional[Sequence[int]] = None,
                         cow: Optional[Sequence[int]] = None) -> None:
        """Write an admission stage's inputs into the host arrays and copy
        them into the programs' device buffers, in place: ``tokens``
        right-padded to ``width`` with ``start``, ``true_len`` and
        ``temp`` (a prefill or a chunk), the table ``row`` (a chunk), the
        writer's ``blocks``, the copy-on-write pair ``cow``.  The host
        arrays are rewritten only once the previous stage's copies have
        read them."""
        if self._adm_copied is not None:
            # dllm-lint: disable=transfer-host-sync -- waits for the previous admission stage's input copies to read the pinned host arrays before they are rewritten; every stage but the copy-on-write one ends in its own token sync, so this returns at once or after a few bytes of copies, never a kernel
            self._adm_copied.synchronize()
        host = {name: h.numpy() for name, (h, _) in self._adm.items()}
        staged = []
        if tokens is not None:
            host["tokens"][0, :width] = self.tokenizer.pad_id
            host["tokens"][0, :len(tokens)] = tokens
            host["start"][0], host["true_len"][0] = start, true_len
            host["temp"][0] = temp
            staged += [("tokens", width), ("start", 1), ("true_len", 1),
                       ("temp", 1)]
        if row is not None:
            host["row"][:] = row
            staged.append(("row", len(row)))
        if blocks is not None:
            host["blocks"][:len(blocks)] = blocks
            staged.append(("blocks", len(blocks)))
        if cow is not None:
            host["cow"][:] = cow
            staged.append(("cow", 2))
        for name, n in staged:
            h, dev = self._adm[name]
            dev[..., :n].copy_(h[..., :n], non_blocking=True)
        if self._adm_copied is not None:
            self._adm_copied.record()

    def _prefill_body(self, bucket: int,
                      draft: bool = False) -> Callable[[], tuple]:
        """A cold prefill of one bucket on the static tokens (JAX's
        ``"prefill"`` program, the draft's ``("prefill", bucket)``): ->
        (first [1], k_all, v_all [L, bucket, N_kv, D]), the first token
        sampled from the row of position ``true_len - 1``, gathered on the
        device (noise is drawn for a greedy prompt too: one program per
        bucket); the draft's -> (k_all, v_all), its K/V only."""
        cfg, model = ((self.cfg_d, self.model_d) if draft
                      else (self.cfg, self.model))
        tokens = self._adm_dev["tokens"][:, :bucket]
        true_len, temp = self._adm_dev["true_len"], self._adm_dev["temp"]
        positions = torch.arange(bucket, device=self.device)[None]

        def row0(kv):
            if isinstance(kv, list):            # a sharded model's K/V
                return [x[:, 0] for x in kv]
            return kv[:, 0]

        def body() -> tuple:
            hidden, (k_all, v_all) = models.serving_prefill(cfg, model,
                                                            tokens, positions)
            if draft:
                return row0(k_all), row0(v_all)
            last = hidden.index_select(1, true_len.long() - 1)[:, 0]
            logits = transformer.logits_from_hidden(model, last)
            return (sample_batched(logits, temp, self._gen), row0(k_all),
                    row0(v_all))

        return body

    def _writer_body(self, nb: int, draft: bool = False) -> Callable[[], None]:
        """Page a cold prefill into its blocks (JAX's ``"writer"`` program
        ``nb``, the draft's ``("writer", nb)``): the K/V of the prefill
        program of bucket ``nb * bs``, read in place from its output,
        scattered into the static block ids [nb]."""
        bucket = nb * self.paged.block_size
        src = self._programs[("draft", ("prefill", bucket)) if draft
                             else ("prefill", bucket)]
        pool = self.pool_d if draft else self.pool
        blocks = self._adm_dev["blocks"][:nb]

        def body() -> None:
            k_all, v_all = src.out[-2:]
            write_prefill_blocks(pool, blocks, k_all, v_all)

        return body

    def _chunk_body(self, width: int, window: int,
                    draft: bool = False) -> Callable[[], Any]:
        """A prompt chunk of ``width`` tokens prefilled into the pool (in
        place) through the static table row, its attention over the
        first ``window`` positions (JAX's ``"chunk_prefill"`` program
        ``(width, window)``, the draft's ``("chunk", width, window)``): ->
        first [1], sampled from the row of position ``true_len - 1``
        (clamped into the chunk: meaningful for a final chunk), gathered
        on the device; the draft's writes its K/V only -> None."""
        cfg, model, pool = ((self.cfg_d, self.model_d, self.pool_d) if draft
                            else (self.cfg, self.model, self.pool))
        tokens = self._adm_dev["tokens"][:, :width]
        start, true_len, temp, row = (self._adm_dev[k] for k in (
            "start", "true_len", "temp", "row"))

        def body() -> Any:
            hidden = chunk_prefill_paged(cfg, model, tokens, start, true_len,
                                         pool, row, window)
            if draft:
                return None
            last = torch.clamp(true_len - start - 1, 0, width - 1).long()
            logits = transformer.logits_from_hidden(
                model, hidden.index_select(1, last)[:, 0])
            return sample_batched(logits, temp, self._gen)

        return body

    def _cow_body(self, draft: bool = False) -> Callable[[], None]:
        """The copy-on-write copy of one block (JAX's ``"writer"`` programs
        ``"cow_copy"`` and ``"cow_copy_draft"``), its source and
        destination read from the static pair."""
        pool = self.pool_d if draft else self.pool
        src, dst = self._adm_dev["cow"][:1], self._adm_dev["cow"][1:]

        def body() -> None:
            copy_block(pool, src, dst)

        return body

    def _prefill_programs(self, ids: Sequence[int], bucket: int, temp: float,
                          blocks: List[int]) -> torch.Tensor:
        """A cold prefill of ``ids``: the ``"prefill"`` program of its
        bucket, the ``"writer"`` paging its K/V into ``blocks``, and with a
        draft the draft's prefill and writer (the draft pool seeded from
        the same tokens into the same blocks).  Returns the sampled token
        [1] on the device, unread."""
        nb = bucket // self.paged.block_size
        self._stage_admission(tokens=ids, width=bucket, true_len=len(ids),
                              temp=temp, blocks=blocks[:nb])
        first = self._built("prefill", bucket).run()[0]
        self._built("writer", nb).run()
        if self.spec:
            self._built("draft", ("prefill", bucket)).run()
            self._built("draft", ("writer", nb)).run()
        return first

    def _prefill_first(self, ids: Sequence[int], bucket: int, temp: float,
                       blocks: List[int]) -> int:
        """A cold prompt's admission (``_prefill_programs``); returns the
        first token: the admission's one sync."""
        # dllm-lint: disable=transfer-host-round-trip -- sanctioned: the FIRST token must reach the host NOW (TTFT is the SLO and the value seeds the slot) — one sync per admission, never per tick
        return int(self._prefill_programs(ids, bucket, temp, blocks))

    def _chunk_first(self, tokens: Sequence[int], width: int, start: int,
                     true_len: int, blocks: List[int], window: int,
                     temp: float, draft: bool = False) -> int:
        """One chunk's ``"chunk_prefill"`` program over ``blocks``' table
        row and, with ``draft``, its draft twin (a prefix hit's suffix, so
        the slot can speculate).  Returns the token sampled from position
        ``true_len - 1`` (meaningful for the final chunk): the chunk's one
        sync."""
        self._stage_admission(tokens=tokens, width=width, start=start,
                              true_len=true_len, temp=temp,
                              row=self._table_row(blocks))
        first = self._built("chunk_prefill", (width, window)).run()
        if draft:
            self._built("draft", ("chunk", width, window)).run()
        # dllm-lint: disable=transfer-host-round-trip -- sanctioned: the chunk IS the budgeted stall unit — its device time is exactly the TBT bound this design promises (and the histogram evidences), and the final chunk's sampled token must reach the host regardless; an async chunk would just move the same wait into the next decode tick's sync
        return int(first)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy block ``src`` to ``dst`` in the pool and, with a draft, in
        the draft's pool too (it attends the same tables): the
        ``"cow_copy"`` program and its draft twin."""
        self._stage_admission(cow=(src, dst))
        self._built("writer", "cow_copy").run()
        if self.spec:
            self._built("writer", "cow_copy_draft").run()

    def _tick_rung(self) -> int:
        """The plain tick's table width in blocks.  Ragged: the full row.
        Dense: the window covering every active position plus the tick's
        steps (idle slots sit at position 0)."""
        if self.ragged:
            return self.paged.blocks_per_slot
        w_need = int(self._pos.max()) + self.steps_per_tick
        return self._suffix_window(w_need) // self.paged.block_size

    def _window(self, wb: int) -> torch.Tensor:
        """The device table's first ``wb`` columns (the whole table at
        MB): a column view of it per rung, valid for the engine's life."""
        if wb == self.paged.blocks_per_slot:
            return self._tables_dev
        tables = self._tables_dev_w.get(wb)
        if tables is None:
            tables = self._tables_dev_w[wb] = self._tables_dev[:, :wb]
        return tables

    def _decode_body(self, wb: int) -> Callable[[], torch.Tensor]:
        """The plain tick's program body at table width ``wb``:
        ``decode_steps_per_tick`` batched decode steps on the static
        inputs, each feeding its sampled tokens to the next, -> [T, B]
        tokens.  Positions clamp at max_seq_len - 1 so an overshooting
        slot keeps writing its own last cell."""
        tables = self._window(wb)
        max_pos = self.cfg.max_seq_len - 1

        def body() -> torch.Tensor:
            pos, cur, toks = self._pos_dev, self._cur_dev, []
            for _ in range(self.steps_per_tick):
                logits = decode_step_paged(self.cfg, self.model, cur, pos,
                                           self.pool, tables,
                                           ragged=self.ragged)
                cur = sample_batched(logits, self._temps_dev, self._gen)
                toks.append(cur)
                pos = torch.clamp(pos + 1, max=max_pos)
            return torch.stack(toks)

        return body

    def _spec_body(self, gb: int) -> Callable[[], torch.Tensor]:
        """The speculative round's program body at γ bucket ``gb``, on the
        static inputs (``_caps_dev`` [B] caps each slot's acceptance).
        The draft runs gb + 1 batched ragged decode steps on its pool (the
        last one writes the last draft's K/V, so a fully accepted round
        leaves no hole); ONE verify forward scores every slot's gb + 1
        chunk; acceptance and the emitted tokens are tensor ops on the
        device.  -> [B, gb + 2]: out [B, gb + 1] then n_acc."""
        max_pos = self.cfg.max_seq_len - 1
        tables = self._tables_dev

        def body() -> torch.Tensor:
            pos, cur = self._pos_dev, self._cur_dev
            tok, p, drafts = cur, pos, []
            for _ in range(gb + 1):
                logits = decode_step_paged(self.cfg_d, self.model_d, tok, p,
                                           self.pool_d, tables)
                tok = logits.argmax(dim=-1)
                drafts.append(tok)
                p = torch.clamp(p + 1, max=max_pos)
            drafted = torch.stack(drafts[:gb], dim=1)            # [B, gb]
            logits = verify_step_paged(
                self.cfg, self.model, torch.cat([cur[:, None], drafted], dim=1),
                pos, self.pool, tables)                          # [B, gb+1, V]
            picks = logits.argmax(dim=-1)
            # The first row is temperature-aware: a sampled slot rides γ=0
            # and draws its one token per round as the plain tick would.
            picks[:, 0] = sample_batched(logits[:, 0], self._temps_dev,
                                         self._gen)
            agree = (drafted == picks[:, :gb]).long()
            n_acc = torch.minimum(agree.cumprod(dim=1).sum(dim=1),
                                  self._caps_dev)
            idx = torch.arange(gb + 1, device=pos.device)[None]
            out = torch.where(
                idx < n_acc[:, None],
                torch.nn.functional.pad(drafted, (0, 1)),
                picks.gather(1, torch.minimum(idx, n_acc[:, None])))
            return torch.cat([out, n_acc[:, None]], dim=1)

        return body

    def _note_compile(self, stage: str, key) -> None:
        """Record a NEW program for ``stage``, keyed as the JAX engine keys
        its compiled ones (``"decode"``: the table width wb, the ragged
        tick's being MB; ``"spec"``: the γ bucket; ``"prefill"``: the
        bucket; ``"chunk_prefill"``: (width, window); ``"writer"``: the
        block count, ``"cow_copy"`` and ``"cow_copy_draft"``;
        ``"draft"``: ``("prefill", bucket)``, ``("writer", nb)`` and
        ``("chunk", width, window)``), and log it: warmup's captures must
        be visible, and one mid-serve stalls every active slot.  The
        profiler's timeline gets a ``compile`` event and the
        ``dllm_compiled_programs`` gauge the stage's count.  The spill
        copies' keys are recorded by ``_note_spill``: they are no
        program."""
        seen = self._compiled.setdefault(stage, set())
        seen.add(key)
        self.profiler.event("compile", stage=stage, key=str(key))
        logger.info("tier %s: capturing %s program %r (%d %s programs so "
                    "far)", self.tier.name, stage, key, len(seen), stage)
        get_observability().m.compiled_programs.labels(
            self.tier.name, stage).set(len(seen))

    def _stamp(self, name: str):
        """The profiler's ``name`` phase, on the scheduler thread outside
        warmup; elsewhere (warmup, a caller's direct tick) a null
        context: only served passes are recorded."""
        if self._warming or threading.current_thread() is not self._thread:
            return contextlib.nullcontext()
        return self.profiler.phase(name)

    def _commit(self, slots: int) -> None:
        """Close the pass's profiler record (the stamps' own gate)."""
        if not self._warming:
            self.profiler.commit(slots)

    def _stage(self) -> None:
        """The tick's inputs copied in (the ``table_upload`` phase)."""
        with self._stamp("table_upload"):
            self._stage_inputs()

    def _program(self, stage: str, key: int) -> TickProgram:
        """The tick program for (``stage``, ``key``) with its inputs staged:
        built (captured, on the card) at first use."""
        self._stage()
        return self._built(stage, key)

    def _body(self, stage: str, key) -> Callable[[], Any]:
        """The body of the program (``stage``, ``key``)."""
        if stage == "decode":
            return self._decode_body(key)
        if stage == "spec":
            return self._spec_body(key)
        if stage == "prefill":
            return self._prefill_body(key)
        if stage == "chunk_prefill":
            return self._chunk_body(*key)
        if stage == "writer":
            if key in ("cow_copy", "cow_copy_draft"):
                return self._cow_body(draft=key == "cow_copy_draft")
            return self._writer_body(key)
        kind, *args = key                    # the draft's stages
        return {"prefill": self._prefill_body, "writer": self._writer_body,
                "chunk": self._chunk_body}[kind](*args, draft=True)

    def _built(self, stage: str, key) -> TickProgram:
        """The program for (``stage``, ``key``), built (captured, on the
        card) at first use.  A capture that fails raises: the tick or
        the admission fails with it."""
        prog = self._programs.get((stage, key))
        if prog is None:
            self._note_compile(stage, key)
            prog = self._make_program(self._body(stage, key))
            self._programs[(stage, key)] = prog
        return prog

    def _tick_phase(self):
        """The "decode" phase of a tick: its replay and its pull, on the
        scheduler thread (the serving ticks; warmup's direct ticks are
        not timed)."""
        if threading.current_thread() is self._thread:
            return self.phases.phase("decode")
        return contextlib.nullcontext()

    def _capture(self, body: Callable[[], Any]) -> TickProgram:
        """``body`` as a CUDA graph on the engine's capture stream, after
        one run of it there (each kernel's module loads at its first
        launch, which a capture may not do).  That run writes what the
        first replay rewrites from the same inputs.  The engine's
        generator is registered, so each replay draws new numbers; and the
        capture is thread-local (``_capturing``), since another engine's
        scheduler (and the router) may use the card meanwhile."""
        return capture_program(body, self.device, self._capture_stream,
                               self._graph_pool, (self._gen,))

    @torch.no_grad()
    def _decode_tick(self, wb: Optional[int] = None) -> np.ndarray:
        """One plain tick at table width ``wb`` (by default the one the
        active positions need), then one pull of its [T, B] tokens."""
        wb = self._tick_rung() if wb is None else wb
        self._stage()
        t0 = time.perf_counter()
        with self._stamp("decode"):
            prog = self._built("decode", wb)  # a capture: before the timer
            self._tick_wb = wb
            with self._tick_phase():
                toks = _fetch_tick(prog.run())
        self._tick_ms = (time.perf_counter() - t0) * 1000.0
        return toks

    @torch.no_grad()
    def _spec_tick(self, gb: int, gammas: np.ndarray):
        """One speculative round at γ bucket ``gb``; ``gammas`` [B] caps
        each slot's acceptance (0 for a slot that does not speculate).
        The round ends in one pull.  Returns (out [B, gb + 1], n_acc [B]):
        a slot emits out[:n_acc + 1]."""
        self._caps[:] = gammas
        self._stage()
        t0 = time.perf_counter()
        # One program drafts and verifies: one "verify" phase.
        with self._stamp("verify"):
            prog = self._built("spec", gb)    # a capture: before the timer
            self._tick_wb = self.paged.blocks_per_slot
            with self._tick_phase():
                host = _fetch_tick(prog.run())
        self._tick_ms = (time.perf_counter() - t0) * 1000.0
        return host[:, :-1], host[:, -1]

    # -- tick and speculation policy ---------------------------------------

    def _resolve_ragged(self) -> bool:
        """Whether the decode tick runs the ragged path: the tier's
        ``attention_ragged``, under a group only where the group passes
        the sharded tick's gate (``_tp_ragged_ok``, JAX's mesh rule; its
        env override has no counterpart: no env knobs)."""
        if self.group is not None and not _tp_ragged_ok(self.group,
                                                        self.cfg):
            return False
        return bool(self.tier.attention_ragged)

    @property
    def tp(self) -> int:
        """The engine's tensor-parallel degree (1 unsharded)."""
        return 1 if self.group is None else self.group.tp

    def _suffix_window(self, needed: int) -> int:
        """Smallest prefill bucket covering ``needed`` positions, else the
        table's full span (blocks_per_slot * bs: max_seq_len itself may not
        divide evenly).  Buckets are validated multiples of the block
        size."""
        return next((bb for bb in self._buckets if bb >= needed),
                    self.paged.blocks_per_slot * self.paged.block_size)

    def _resolve_spec(self) -> bool:
        """Whether ``spec_decode`` can arm speculation here; each blocker
        is logged and the engine serves plain decode: no ``draft_preset``,
        the dense windowed tick (the verify is the ragged kernel's γ+1
        face), a sampled tier default (every slot would ride γ=0), a draft
        whose vocabulary differs or whose context is shorter than the
        target's (drafts run at the target's positions)."""
        tier = self.tier
        if not tier.draft_preset:
            logger.warning("tier %s: spec_decode=True ignored: no "
                           "draft_preset configured", tier.name)
            return False
        if not self.ragged:
            logger.warning("tier %s: spec_decode=True ignored: batched "
                           "speculation needs the ragged tick "
                           "(attention_ragged=False)", tier.name)
            return False
        if (tier.temperature or 0) > 0:
            logger.warning("tier %s: spec_decode=True ignored: the tier "
                           "default temperature=%s would degrade every slot "
                           "to γ=0", tier.name, tier.temperature)
            return False
        dcfg = tier.draft_model()
        if dcfg.vocab_size != self.cfg.vocab_size:
            logger.warning("tier %s: spec_decode=True ignored: draft_preset=%s "
                           "vocab %d != target vocab %d", tier.name,
                           tier.draft_preset, dcfg.vocab_size,
                           self.cfg.vocab_size)
            return False
        if dcfg.max_seq_len < self.cfg.max_seq_len:
            logger.warning("tier %s: spec_decode=True ignored: draft_preset=%s "
                           "max_seq_len %d < target %d", tier.name,
                           tier.draft_preset, dcfg.max_seq_len,
                           self.cfg.max_seq_len)
            return False
        return True

    def _gamma_bucket(self, g: int) -> int:
        """Smallest γ bucket covering ``g``."""
        return next(b for b in self._gamma_buckets if b >= g)

    def _adapt_gamma(self, ewma: float, cap: Optional[int] = None) -> int:
        """Acceptance EWMA -> the slot's next γ: proportional, with a
        floor at 0 (plain decode) once acceptance stops paying for the
        drafts.  ``cap`` is the tenant's γ clamp (None = unclamped)."""
        gmax = (self.spec_gamma_max if cap is None
                else min(cap, self.spec_gamma_max))
        if gmax <= 0 or ewma < SPEC_EWMA_FLOOR:
            return 0
        return max(1, min(gmax, int(ewma * gmax + 0.5)))

    def _tenant_gamma_cap(self, req: Optional[_Request]) -> Optional[int]:
        """The tenant's γ clamp, or None (quotas off, or no cap)."""
        if self._tenant_quotas is None or req is None:
            return None
        cap = self._tenant_quota(req.tenant).spec_gamma_max
        if cap is None:
            return None
        return max(0, min(int(cap), self.spec_gamma_max))

    def _note_prefix_hit(self, kind: str) -> None:
        """One admission attempt's prefix-cache outcome (shared |
        exclusive | miss) on ``dllm_prefix_hits_total{tier,kind}``: a
        KV-pressure requeue looks up again on re-admission, as the cache's
        own hit and miss counts do.  A failing metric never fails the
        admission, as in the JAX engine: it is noted once the hit's
        blocks and pin are handed off, and a raise there would leak
        them."""
        try:
            get_observability().m.prefix_hits.labels(
                self.tier.name, kind).inc()
        except Exception:
            logger.debug("prefix hit metric failed", exc_info=True)

    # -- block bookkeeping -------------------------------------------------

    def _prefix_evicted(self, entry) -> None:
        """on_evict sink of the prefix cache: DEMOTE the entry to the host
        spill tier when eligible, else return its blocks (a refcounted
        decref)."""
        blocks = entry.cache.get("blocks") if isinstance(entry.cache, dict) else None
        if blocks and not self._try_demote(entry.ids, blocks):
            self.allocator.free(blocks)

    def _note_spill(self, kind: str, n: int) -> None:
        """Record a spill copy's JAX key (``("gather", nb)``, ``("write",
        k)``) under the ``"spill"`` stage of ``_compiled`` the first time
        it is seen, as the JAX engine notes its jitted copies.  The
        port's spill copies run eagerly: no capture, no ``compile``
        event."""
        seen = self._compiled.setdefault("spill", set())
        if (kind, n) not in seen:
            seen.add((kind, n))
            get_observability().m.compiled_programs.labels(
                self.tier.name, "spill").set(len(seen))

    def _device_ids(self, blocks: Sequence[int]) -> torch.Tensor:
        """Block ids [n] int64 on the pool's device: on the card through a
        pinned host tensor copied without a sync (the host allocator keeps
        it until the copy has read it)."""
        ids = torch.tensor(list(blocks), dtype=torch.long)
        if self.device.type != "cuda":
            return ids
        return ids.pin_memory().to(self.device, non_blocking=True)

    def _try_demote(self, ids, blocks: List[int]) -> bool:
        """Demote an evicted prefix entry's blocks to host RAM.  True =
        handled here: the blocks were gathered (a snapshot that owns its
        data, block-major for the host tier) and FREED, and the snapshot
        queued for the spill copier with the event recorded after its
        gather.  Only sole-owner data demotes: a block with refcount > 1
        is still mapped by a live slot or another parked entry, so
        freeing it is a decref and its data stays resident."""
        spill = self.kv_spill
        if spill is None or self._stop.is_set():
            return False
        if any(r != 1 for r in self.allocator.refcounts(blocks)):
            return False
        nbytes = self._spill_block_bytes * len(blocks)
        if not spill.accepts(nbytes):
            return False
        try:
            # Profiler stamps are the scheduler thread's (a direct
            # pop_oldest from another thread demotes unstamped).
            with self._stamp("demote"):
                self._note_spill("gather", len(blocks))
                tiles = {name: t.movedim(2, 0).contiguous()
                         for name, t in gather_blocks(
                             self.pool, self._device_ids(blocks)).items()}
                ready = None
                if self.device.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record()
        except BaseException:
            self.allocator.free(blocks)
            raise
        # Later writes to these blocks run on the same stream, after the
        # gather: the blocks go back to the free list now.
        self.allocator.free(blocks)
        spill.offer(ids, (tiles, ready), nbytes, nb=len(blocks))
        return True

    def _promote_copy(self, host_tiles, lo: int, blocks: List[int]) -> None:
        """One promotion grant: host tiles ``lo:lo + len(blocks)`` copied to
        the device (pinned, no sync) and scattered into ``blocks`` on the
        engine's stream, ahead of every later program that reads them."""
        k = len(blocks)
        tiles = {name: t[lo:lo + k].to(self.device, non_blocking=True)
                 .movedim(0, 2) for name, t in host_tiles.items()}
        scatter_blocks(self.pool, self._device_ids(blocks), tiles)

    def _table_row(self, blocks: List[int]) -> np.ndarray:
        row = np.full(self.paged.blocks_per_slot, TRASH_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        return row

    def _set_table_row(self, ix: int, row) -> None:
        """Every table change funnels here, so the device table is copied
        in once per change, not once per tick, and in place: the tick
        programs (and the dense rungs' views) keep reading it."""
        self._tables[ix] = row
        self._tables_dirty = True
        self._kv_weights.pop(ix, None)

    def _alloc_evicting(self, n_blocks: int) -> Optional[List[int]]:
        """Allocate, evicting parked prefixes (LRU) under pressure: live
        admissions outrank parked caches.  With quotas on, a first pass
        evicts the entries of tenants over their KV block budget."""
        blocks = self.allocator.alloc(n_blocks)
        if (self._tenant_quotas is not None and blocks is None
                and self.prefix_cache is not None):
            # The over-budget set is computed once before the sweep (the
            # pop_oldest predicate runs under the cache lock).
            over = self._overquota_parked_tenants()
            while (blocks is None and over
                   and self.prefix_cache.pop_oldest(
                       match=lambda e: isinstance(e.cache, dict)
                       and e.cache.get("tenant") in over) is not None):
                blocks = self.allocator.alloc(n_blocks)
        while (blocks is None and self.prefix_cache is not None
               and self.prefix_cache.pop_oldest() is not None):
            blocks = self.allocator.alloc(n_blocks)
        return blocks

    def _overquota_parked_tenants(self) -> set:
        """Tenants that own tagged parked entries and are over their KV
        block budget (quotas on)."""
        tenants = {e.cache.get("tenant")
                   for e in self.prefix_cache.entries_snapshot()
                   if isinstance(e.cache, dict) and e.cache.get("tenant")}
        over = set()
        for t in tenants:
            q = self._tenant_quota(t)
            if q.kv_blocks and self.tenant_kv_blocks(t) > float(q.kv_blocks):
                over.add(t)
        return over

    def tenant_kv_blocks(self, tenant: Optional[str]) -> float:
        """The tenant's resident-KV bill in pool blocks, each at
        1/refcount (a block shared k ways costs each sharer 1/k): its live
        slots and its tagged parked entries.  An advisory cross-thread
        read (the serving gate and the victim policy call it)."""
        t = tenant or "default"
        owned: List[int] = []
        for slot in self._slots:
            if slot is not None and (slot.request.tenant or "default") == t:
                owned.extend(slot.blocks)
        if self.prefix_cache is not None:
            for e in self.prefix_cache.entries_snapshot():
                cache = e.cache
                if isinstance(cache, dict) and cache.get("tenant") == t:
                    owned.extend(cache.get("blocks") or [])
        if not owned:
            return 0.0
        return sum(1.0 / r if r > 0 else 1.0
                   for r in self.allocator.refcounts(owned))

    # -- admission ---------------------------------------------------------

    def _slot_go_live(self, req: _Request, slot_ix: int, blocks: List[int],
                      *, prompt_len: int, prompt_ids: tuple, budget: int,
                      temp: float, max_blocks: int, pos: int,
                      first: Optional[int] = None,
                      gen: Optional[List[int]] = None,
                      ttft_ms: float = 0.0,
                      pinned_entry: Optional[Any] = None,
                      spec_ok: bool = False) -> None:
        """The go-live tail shared by every admission path (cold or
        replay, monolithic or chunked): publish the slot, its table row
        and decode state, emit the prefill's token (cold: ``first``) or
        resume from the generated prefix (replay: ``gen``, nothing
        emitted), and apply the termination checks.  Speculation
        eligibility is fixed here for the slot's life: the admission must
        have seeded the draft pool (``spec_ok``) and the slot must be
        greedy."""
        if gen is None:
            tokens, cur = [first], first
        else:
            tokens, cur = list(gen), gen[-1]
            ttft_ms = req.replay_ttft_ms or 0.0
        spec = bool(self.spec and spec_ok and temp <= 0)
        # A capped tenant starts at its cap (cap 0: no drafting).
        cap = self._tenant_gamma_cap(req)
        gamma0 = self.spec_gamma_max if cap is None else cap
        slot = _Slot(request=req, blocks=blocks, prompt_len=prompt_len,
                     budget=budget, temperature=temp, ttft_ms=ttft_ms,
                     tokens=tokens, prompt_ids=prompt_ids,
                     max_blocks=max_blocks, pinned_entry=pinned_entry,
                     spec=spec, gamma=gamma0 if spec else 0)
        if gen is None:
            obs_spans.add_token(req.trace)   # the prefill's token
            if req.token_queue is not None:
                req.token_queue.put(first)
        else:
            req.replay_tokens = None
        self._slots[slot_ix] = slot
        self._set_table_row(slot_ix, self._table_row(blocks))
        self._pos[slot_ix] = pos
        self._cur[slot_ix] = cur
        self._temps[slot_ix] = temp
        if gen is None:
            if first == self.tokenizer.eos_id or budget <= 1:
                self._finish(slot_ix)
        elif (cur in (self.tokenizer.eos_id, self.tokenizer.pad_id)
              or len(gen) >= budget):
            self._finish(slot_ix)

    def _chunk_gate(self, bucket: int) -> bool:
        """Chunked prefill only for prompts whose bucket exceeds a chunk
        (chunked admissions skip draft seeding: their slots never
        speculate)."""
        return bool(self.chunk_tokens) and bucket > self.chunk_tokens

    def _admit(self, req: _Request, slot_ix: int) -> bool:
        """Admit ``req`` into free slot ``slot_ix``.  False = stay queued
        (KV pressure, or the chunked-prefill lane is busy)."""
        # Submit-to-prefill-start wait (queue_wait_ms, the registry's
        # histogram) and the other half of TTFT, prefill_wait_ms, stamped
        # when the prefill lands.
        wait_ms = round((time.perf_counter() - req.t_submit) * 1000.0, 3)
        obs_spans.annotate(req.trace, queue_wait_ms=wait_ms,
                           admission_wait_ms=wait_ms)
        ids, bucket = prepare_prompt(self.tokenizer, req.history,
                                     self.tier.prefill_buckets,
                                     self.cfg.max_seq_len,
                                     self.tier.max_new_tokens)
        n = len(ids)
        budget = self.tier.max_new_tokens
        if req.max_new_tokens and req.max_new_tokens > 0:
            budget = min(budget, req.max_new_tokens)
        if req.admit_seq < 0:
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
        if req.replay_tokens:
            return self._admit_replay(req, slot_ix, ids, n, budget)
        bs = self.paged.block_size
        max_seq = self.cfg.max_seq_len

        reused = select_reuse(self.prefix_cache, ids, self._reuse_buckets,
                              max_seq, share=self.share_prefix)
        if self.kv_spill is not None:
            # Probe the host spill tier and prefer it whenever it holds a
            # LONGER prefix than the device cache found (a session's
            # demoted history beats a stranger's short common opener).  A
            # host hit becomes an in-flight chunked prefill whose leading
            # blocks are PROMOTED; the single prefill lane applies.
            dev_m = reused[1] if reused is not None else 0
            if self.kv_spill.peek(ids, max_len=n - 1) > dev_m:
                if self._prefill is not None:
                    if reused is not None:
                        # Hand the device hit back untouched: the deferred
                        # re-admission re-probes both tiers.
                        self._unreuse(reused)
                    # unshare/untake reversed the cache's hit into a miss
                    # (a no-hit defer counted one): mirror it.
                    self._note_prefix_hit("miss")
                    req.needs_chunk = True
                    return False
                claimed = self.kv_spill.claim(ids, max_len=n - 1)
                if claimed is not None and claimed[1] > dev_m:
                    try:
                        if reused is not None:
                            self._unreuse(reused)
                            reused = None
                        self._note_prefix_hit("host")
                        self._start_prefill(req, slot_ix, ids, n, bucket,
                                            budget, promote=claimed)
                    except BaseException:
                        # The claim pinned the entry; until _start_prefill
                        # publishes the promotion the pin is ours to drop.
                        self.kv_spill.release(claimed[0], promoted=False)
                        raise
                    return True
                if claimed is not None:
                    # The peeked entry shrank or died before the claim:
                    # the device hit (if any) still stands.
                    self.kv_spill.release(claimed[0], promoted=False)
        if self.prefix_cache is not None and reused is None:
            self._note_prefix_hit("miss")
        claim = None
        if reused is not None:
            claim = self._reuse_blocks(reused, n, budget)
            if claim is None:
                if self._busy():
                    return False             # KV pressure: stay queued
                # Nothing runs that could ever free a block: the hit's
                # private blocks need what its own pinned entry holds, so
                # it admits cold (the cold path may evict the entry).  The
                # JAX engine requeues it forever (ROADMAP.md C).
                reused = None
        if reused is None and self._chunk_gate(bucket):
            # Long cold prompt: chunked prefill interleaved with decode
            # ticks; one in flight at a time, so a second one waits at
            # the scheduler head (needs_chunk stops the re-tokenizing).
            if self._prefill is not None:
                req.needs_chunk = True
                return False
            self._start_prefill(req, slot_ix, ids, n, bucket, budget)
            return True

        temp = (self.tier.temperature if req.temperature is None
                else req.temperature)
        pinned_entry = None
        if reused is not None:
            entry, m, suffix, sb = reused
            owned, pinned_entry, boundary_src, priv = claim
            try:
                if boundary_src is not None:
                    # The copy must land before the suffix writes, in both
                    # pools: the draft attends the same tables.
                    with self._stamp("cow_copy"):
                        self._cow_copy(boundary_src, priv[0])
                window = next(w for w in self._chunk_windows if w >= m + sb)
                # The draft writes its suffix K/V too; the parked prefix
                # blocks keep whatever draft K/V their writers left (stale
                # draft K/V only lowers acceptance).
                with obs_spans.span(req.trace, "prefill", reused_tokens=m,
                                    suffix_bucket=sb), \
                        self.phases.phase("prefill"), \
                        self._stamp("prefill"):
                    first = self._chunk_first(suffix, sb, m, n, owned,
                                              window, temp, draft=self.spec)
                self.profiler.event("host_sync", site="prefill_first_token")
                # sb suffix rows, their attention over the chunk window.
                self.phases.add_work("prefill", **roofline.prefill_work(
                    self.cfg, window, window - sb, wbytes=self._wbytes))
            except BaseException:
                self.allocator.free(owned)
                if pinned_entry is not None:
                    self.prefix_cache.unpin(pinned_entry)
                raise
            blocks = owned
            max_blocks = len(owned)          # fully materialized: no growth
        else:
            max_blocks = -(-min(bucket + budget, max_seq) // bs)
            # Lazy growth: the prefill bucket plus one tick now; the
            # pre-tick growth pass allocates the rest as the sequence grows.
            need = min(max_blocks,
                       max(bucket // bs,
                           -(-min(n + self.steps_per_tick, max_seq) // bs)))
            blocks = self._alloc_evicting(need)
            if blocks is None:
                return False                 # KV pressure: stay queued
            try:
                with obs_spans.span(req.trace, "prefill", bucket=bucket), \
                        self.phases.phase("prefill"), \
                        self._stamp("prefill"):
                    # The first token must reach the host now (it seeds
                    # the slot): one sync per admission, never per tick.
                    first = self._prefill_first(ids, bucket, temp, blocks)
                self.profiler.event("host_sync", site="prefill_first_token")
                self.phases.add_work("prefill", **roofline.prefill_work(
                    self.cfg, bucket, 0, wbytes=self._wbytes))
            except BaseException:
                self.allocator.free(blocks)
                raise
        ttft_ms = (time.perf_counter() - req.t_submit) * 1000.0
        obs_spans.annotate(req.trace, prefill_wait_ms=round(
            max(0.0, ttft_ms - wait_ms), 3))
        self._slot_go_live(req, slot_ix, blocks, prompt_len=n,
                           prompt_ids=tuple(ids), budget=budget, temp=temp,
                           max_blocks=max_blocks, pos=n, first=first,
                           ttft_ms=ttft_ms, pinned_entry=pinned_entry,
                           spec_ok=True)
        return True

    def _busy(self) -> bool:
        """Whether a slot decodes or a chunked prefill is in flight: work
        that will free blocks."""
        return (self._prefill is not None
                or any(s is not None for s in self._slots))

    def _reuse_blocks(self, reused, n: int, budget: int):
        """The blocks of a prefix hit (``select_reuse``'s result), fully
        materialized for the prompt and its budget: (owned, pinned entry,
        boundary source block, private blocks).  A shared hit maps the
        entry's FULL blocks read-only (increfs) and allocates the rest,
        the first private block taking the copy of the partially filled
        boundary block; an exclusive take owns the entry's blocks and
        writes the boundary block directly.  None when the pool cannot
        hold it: the hit is handed back (counted a miss)."""
        entry, m, _suffix, sb = reused
        bs = self.paged.block_size
        cover = max(m + sb, min(n + budget, self.cfg.max_seq_len))
        need = -(-cover // bs)
        if self.share_prefix:
            n_full = m // bs
            shared = list(entry.cache["blocks"][:n_full])
            boundary_src = (entry.cache["blocks"][n_full] if m % bs
                            else None)
            self.allocator.share(shared)
            try:
                priv = self._alloc_evicting(need - n_full)
            except BaseException:
                self.allocator.free(shared)
                self.prefix_cache.unshare(entry, m)
                raise
            if priv is None:
                self.allocator.free(shared)
                self.prefix_cache.unshare(entry, m)
                self._note_prefix_hit("miss")
                return None
            hit = shared + priv, entry, boundary_src, priv
            self._note_prefix_hit("shared")
            return hit
        owned = list(entry.cache["blocks"])
        if len(owned) < need:
            extra = self._alloc_evicting(need - len(owned))
            if extra is None:
                self.prefix_cache.untake(entry, m)
                self._note_prefix_hit("miss")
                return None
            owned += extra
        elif len(owned) > need:
            self.allocator.free(owned[need:])
            owned = owned[:need]
        self._note_prefix_hit("exclusive")
        return owned, None, None, None

    def _unreuse(self, reused) -> None:
        """Hand an unused prefix-cache hit back (``select_reuse``'s
        result): unpin a shared entry, or return a taken one."""
        entry, m, _suffix, _sb = reused
        if self.share_prefix:
            self.prefix_cache.unshare(entry, m)
        else:
            self.prefix_cache.untake(entry, m)

    def _admit_replay(self, req: _Request, slot_ix: int, ids: List[int],
                      n: int, budget: int) -> bool:
        """Re-admission of a preempted request: replay prompt + generated
        prefix through one cold prefill (rebuilding the K/V of every
        position already consumed), then resume decoding from the last
        generated token.  Nothing is re-sampled or re-emitted (the prefix
        was already streamed), so a greedy continuation equals the
        unpreempted run.  Returns False (stay at the scheduler head) while
        the pool cannot hold the replay."""
        bs = self.paged.block_size
        max_seq = self.cfg.max_seq_len
        gen = list(req.replay_tokens)
        seq = list(ids) + gen[:-1]           # every position whose K/V we need
        bucket = next((bb for bb in self._buckets if bb >= len(seq)), None)
        if bucket is None:
            # No prefill bucket covers prompt + prefix (a deep preemption
            # on a short bucket ladder): finish with what was emitted: the
            # stream saw exactly these tokens.
            gen_ids = trim_at_eos(gen, self.tokenizer.eos_id,
                                  self.tokenizer.pad_id)
            with obs_spans.span(req.trace, "detokenize",
                                tokens=len(gen_ids)):
                text = self.tokenizer.decode(gen_ids)
            req.result = GenerationResult(
                text=text, token_ids=gen_ids, prompt_tokens=n,
                gen_tokens=len(gen_ids), ttft_ms=req.replay_ttft_ms or 0.0,
                total_ms=(time.perf_counter() - req.t_submit) * 1000.0)
            obs_spans.event(req.trace, "replay_truncated",
                            generated=len(gen_ids))
            if req.token_queue is not None:
                req.token_queue.put(None)
            req.done.set()
            return True
        if self._chunk_gate(bucket):
            # A deep replay is the same long-prefill stall as a long cold
            # prompt: chunk it too (replay_tokens stay on the request until
            # the prefill completes, so a cancel replays the same prefix).
            if self._prefill is not None:
                req.needs_chunk = True
                return False
            self._start_prefill(req, slot_ix, ids, n, bucket, budget,
                                gen=gen)
            return True
        max_blocks = -(-min(max(bucket, n + budget), max_seq) // bs)
        need = min(max_blocks,
                   max(bucket // bs,
                       -(-min(len(seq) + self.steps_per_tick, max_seq) // bs)))
        blocks = self._alloc_evicting(need)
        if blocks is None:
            return False                     # still starved: stay at head
        temp = (self.tier.temperature if req.temperature is None
                else req.temperature)
        try:
            with obs_spans.span(req.trace, "prefill", bucket=bucket,
                                replayed_tokens=len(gen)), \
                    self.phases.phase("prefill"), \
                    self._stamp("prefill"):
                # The replay's sampled token is discarded and never read:
                # no sync (the next tick queues behind the prefill).  The
                # draft's twins rebuild its prefix too, so a preempted
                # speculating slot resumes speculating.
                self._prefill_programs(seq, bucket, temp, blocks)
            self.phases.add_work("prefill", **roofline.prefill_work(
                self.cfg, bucket, 0, wbytes=self._wbytes))
            obs_spans.event(req.trace, "replay", replayed_tokens=len(seq),
                            generated=len(gen))
        except BaseException:
            self.allocator.free(blocks)
            raise
        self._slot_go_live(req, slot_ix, blocks, prompt_len=n,
                           prompt_ids=tuple(ids), budget=budget, temp=temp,
                           max_blocks=max_blocks, pos=len(seq), gen=gen,
                           spec_ok=True)
        return True

    def _start_prefill(self, req: _Request, slot_ix: int, ids: List[int],
                       n: int, bucket: int, budget: int,
                       gen: Optional[List[int]] = None,
                       promote: Optional[tuple] = None) -> None:
        """Reserve ``slot_ix`` and register the in-flight chunked prefill
        (of prompt + ``gen[:-1]`` for a replay); blocks are allocated per
        chunk as it advances.  ``promote`` = (claimed host entry, matched
        length): its blocks are promoted instead of recomputed."""
        bs = self.paged.block_size
        max_seq = self.cfg.max_seq_len
        if gen is None:
            seq = list(ids)
            max_blocks = -(-min(bucket + budget, max_seq) // bs)
        else:
            seq = list(ids) + list(gen[:-1])
            max_blocks = -(-min(max(bucket, n + budget), max_seq) // bs)
        temp = (self.tier.temperature if req.temperature is None
                else req.temperature)
        pf = _Prefill(
            request=req, slot_ix=slot_ix, seq=seq, prompt_len=n,
            prompt_ids=tuple(ids), total=len(seq), budget=budget,
            temperature=temp, max_blocks=max_blocks,
            replay=list(gen) if gen is not None else None)
        if promote is not None:
            # The claimed (pinned) entry satisfies the ceil(m / bs) leading
            # blocks; a mid-block boundary is fine: the suffix chunks
            # overwrite their own positions in these private blocks.
            entry, m = promote
            pf.promote_entry = entry
            pf.promote_tokens = m
            pf.promote_nb = -(-m // bs)
            obs_spans.event(req.trace, "kv_promote_start",
                            matched_tokens=m, blocks=pf.promote_nb)
        obs_spans.event(req.trace, "prefill_chunked", tokens=len(seq),
                        chunk_tokens=self.chunk_tokens, replayed=bool(gen))
        # Publication is the LAST statement: from here the promotion pin
        # belongs to the prefill machinery.
        self._prefill = pf

    def _advance_prefill(self) -> bool:
        """Spend up to ``chunk_budget`` tokens on the in-flight prefill
        (decode slots were served first, so active streams stall by at
        most one grant).  Returns whether a chunk landed (False = the
        pool is dry; retry next tick)."""
        pf = self._prefill
        if pf is None:
            return True
        progressed = False
        req = pf.request
        c = self.chunk_tokens
        bs = self.paged.block_size
        span = self.paged.blocks_per_slot * bs
        budget_left = self.chunk_budget
        try:
            if pf.promote_entry is not None:
                moved, budget_left = self._advance_promotion(pf, budget_left)
                progressed = progressed or moved
                if pf.promote_entry is not None:
                    # Still mid-promotion (copier not landed, pool dry or
                    # the promote share spent): retry next tick; decode
                    # never waits on it.
                    return progressed
            while pf.consumed < pf.total and budget_left >= c:
                start = pf.consumed
                if start + c > span:
                    # Final sliver at the table's end: slide the chunk back
                    # so every position stays inside the table (the overlap
                    # recomputes identical K/V).
                    start = span - c
                end = start + c
                need = min(pf.max_blocks, -(-min(end, pf.total) // bs))
                if len(pf.blocks) < need:
                    extra = self._alloc_evicting(need - len(pf.blocks))
                    if extra is None:
                        return progressed
                    pf.blocks.extend(extra)
                window = next(w for w in self._chunk_windows if w >= end)
                k = min(end, pf.total) - start
                # The chunk is the budgeted stall unit; its token (used
                # from the final chunk) reaches the host here.
                t_chunk = time.perf_counter()
                with obs_spans.span(req.trace, "prefill_chunk", start=start,
                                    tokens=k, window=window), \
                        self.phases.phase("prefill"), \
                        self._stamp("chunk_prefill"):
                    first = self._chunk_first(pf.seq[start:start + k], c,
                                              start, pf.total, pf.blocks,
                                              window, pf.temperature)
                get_observability().m.prefill_chunk_ms.labels(
                    self.tier.name).observe(
                        (time.perf_counter() - t_chunk) * 1000.0)
                self.phases.add_work("prefill", **roofline.prefill_work(
                    self.cfg, end, start, wbytes=self._wbytes))
                pf.consumed = min(end, pf.total)
                pf.chunks_done += 1
                progressed = True
                budget_left -= c
                self._progress_t = time.monotonic()
                if pf.consumed >= pf.total:
                    self._finish_prefill(pf, first)
                    return True
        except BaseException as exc:       # surface to the caller
            self._prefill = None
            self._release_promotion(pf)
            slot = self._slots[pf.slot_ix]
            if slot is not None and slot.request is req:
                self._fail_slot(pf.slot_ix, exc)
                return True
            self.allocator.free(pf.blocks)
            self._fail_request(req, exc)
            return True
        return progressed

    def _advance_promotion(self, pf: _Prefill, budget_left: int):
        """Spend part of this tick's chunk budget on host-to-device
        promotion grants: up to ``host_kv_promote_share`` of it, one block
        charged as ``kv_block_size`` tokens, so promotion competes with
        chunk grants under ONE budget and the active streams' TBT bound
        holds.  Each grant is an asynchronous copy and scatter on the
        engine's stream, ordered before the chunk programs that read the
        blocks: no sync.  Returns (progressed, budget_left).

        A still-copying entry (hit during demotion) is waited out, bounded
        by ``_promote_wait_cap`` passes.  An invalidated entry, or one
        whose copier never landed, loses the race: the pin drops and the
        prefill restarts cold from position 0 this same pass (JAX's race
        rule, counted in ``dllm_kv_promotion_races_total``).  An entry
        whose copy FAILED raises its error instead."""
        spill = self.kv_spill
        entry = pf.promote_entry
        bs = self.paged.block_size
        req = pf.request
        state = spill.entry_state(entry)
        if state == COPYING:
            pf.promote_waits += 1
            if pf.promote_waits <= self._promote_wait_cap:
                return False, budget_left
            state = DEAD                        # wedged: lost the race
        if entry.error is not None:
            raise RuntimeError(
                f"tier {self.tier.name}: the host copy of a demoted prefix "
                f"failed: {entry.error!r}") from entry.error
        # The tiles with the state verdict: a concurrent invalidation nulls
        # entry.tiles, never this local reference.
        host_tiles = entry.tiles
        if host_tiles is None:
            state = DEAD
        if state == DEAD:
            spill.release(entry, promoted=False, race=True)
            pf.promote_entry = None
            pf.promote_done = 0
            pf.consumed = 0
            obs_spans.event(req.trace, "kv_promote_race",
                            fallback="cold_prefill")
            return True, budget_left            # cold chunks proceed NOW
        share = max(0.0, min(1.0, self.tier.host_kv_promote_share))
        promo_budget = max(bs, int(self.chunk_budget * share))
        progressed = False
        spent = 0
        while pf.promote_done < pf.promote_nb:
            k = min(pf.promote_nb - pf.promote_done,
                    min(budget_left, promo_budget - spent) // bs)
            if k <= 0:
                break
            need = pf.promote_done + k
            if len(pf.blocks) < need:
                extra = self._alloc_evicting(need - len(pf.blocks))
                if extra is None:
                    # Pool dry: stall like a dry chunk grant (growth
                    # starvation may cancel the prefill first).
                    return progressed, budget_left
                pf.blocks.extend(extra)
            lo = pf.promote_done
            with self._stamp("promote"):
                self._note_spill("write", k)
                self._promote_copy(host_tiles, lo, pf.blocks[lo:need])
            pf.promote_done = need
            budget_left -= k * bs
            spent += k * bs
            progressed = True
            self._progress_t = time.monotonic()
        if pf.promote_done >= pf.promote_nb:
            pf.consumed = pf.promote_tokens
            # Every grant is issued; the pin stays (``promote_held``) until
            # the copies are known complete.
            pf.promote_held, pf.promote_entry = entry, None
            if self.device.type == "cuda":
                pf.promote_event = torch.cuda.Event()
                pf.promote_event.record()
            obs_spans.event(req.trace, "kv_promoted",
                            tokens=pf.promote_tokens, blocks=pf.promote_nb)
        return progressed, budget_left

    def _release_promotion(self, pf: _Prefill, landed: bool = False) -> None:
        """Drop the prefill's promotion pin.  A promotion still granting is
        released unpromoted; a landed one (every grant issued) counts as
        promoted, after its copies are complete: ``landed`` says a sync
        after them (the final chunk's token) already happened, else its
        event is waited on (a cancel or a failure, off the tick's
        path)."""
        spill = self.kv_spill
        if spill is None:
            return
        if pf.promote_entry is not None:
            spill.release(pf.promote_entry, promoted=False)
            pf.promote_entry = None
        if pf.promote_held is not None:
            if pf.promote_event is not None and not landed:
                # dllm-lint: disable=transfer-host-sync -- runs only for a cancelled or failed promotion (landed=False): the served path releases after the final chunk's token sync with landed=True; the copies must land before their pinned host tiles go back to the spill tier
                pf.promote_event.synchronize()
            spill.release(pf.promote_held, promoted=True)
            pf.promote_held = pf.promote_event = None

    def _finish_prefill(self, pf: _Prefill, first: int) -> None:
        """Last chunk landed (its token read: every copy and chunk before
        it is complete): the reserved slot goes live.  A cold prefill
        emits the final chunk's token; a replay discards it and resumes
        from the last emitted token."""
        req = pf.request
        self._prefill = None
        self._release_promotion(pf, landed=True)
        obs_spans.annotate(req.trace, prefill_wait_ms=round(
            (time.perf_counter() - pf.t_start) * 1000.0, 3))
        if pf.replay is not None:
            obs_spans.event(req.trace, "replay", replayed_tokens=pf.total,
                            generated=len(pf.replay), chunked=True)
            self._slot_go_live(req, pf.slot_ix, pf.blocks,
                               prompt_len=pf.prompt_len,
                               prompt_ids=pf.prompt_ids, budget=pf.budget,
                               temp=pf.temperature, max_blocks=pf.max_blocks,
                               pos=pf.total, gen=pf.replay)
            return
        ttft_ms = (time.perf_counter() - req.t_submit) * 1000.0
        self._slot_go_live(req, pf.slot_ix, pf.blocks,
                           prompt_len=pf.prompt_len, prompt_ids=pf.prompt_ids,
                           budget=pf.budget, temp=pf.temperature,
                           max_blocks=pf.max_blocks, pos=pf.total, first=first,
                           ttft_ms=ttft_ms)

    def _cancel_prefill(self, reason: str) -> None:
        """Cancel the in-flight prefill and requeue it at the head: under
        pool starvation the prefill yields FIRST (it has emitted nothing,
        while preempting a decoding slot forces a replay).  Its promotion
        pin drops (re-admission re-claims the entry, or goes cold if it
        is gone); a replay's parked tokens survive untouched."""
        pf = self._prefill
        if pf is None:
            return
        self._prefill = None
        self._release_promotion(pf)
        self.allocator.free(pf.blocks)
        self.prefill_cancelled_total += 1
        pf.request.needs_chunk = True
        obs_spans.event(pf.request.trace, "prefill_cancelled", reason=reason,
                        consumed_tokens=min(pf.consumed, pf.total))
        self._head.appendleft(pf.request)

    def _preempt(self, slot_ix: int) -> None:
        """Evict a RUNNING slot under block starvation: free its blocks
        (its table row goes to the trash block before the next tick),
        park its generated tokens on the request and requeue it at the
        scheduler head.  Its caller or stream sees a stall, never an
        error; ``_admit_replay`` resumes it."""
        slot = self._slots[slot_ix]
        req = slot.request
        req.replay_tokens = list(slot.tokens)
        req.replay_ttft_ms = slot.ttft_ms
        req.preempt_count += 1
        self.preempted_total += 1
        obs_spans.event(req.trace, "preempt", tier=self.tier.name,
                        generated=len(slot.tokens),
                        freed_blocks=len(slot.blocks))
        get_observability().m.preemptions.labels(self.tier.name).inc()
        self._release(slot_ix)               # free ALL blocks, no parking
        self._head.appendleft(req)

    def _spec_plan(self, active: List[int]) -> Optional[int]:
        """The γ bucket of this tick's speculative round, or None for a
        plain decode tick (speculation off, or no active slot both
        eligible and above γ=0: an all-degraded batch pays nothing)."""
        if not self.spec:
            return None
        gmax = 0
        for ix in active:
            slot = self._slots[ix]
            if slot is not None and slot.spec and slot.gamma > 0:
                gmax = max(gmax, slot.gamma)
        return self._gamma_bucket(gmax) if gmax else None

    def _ensure_spec_private(self, active: List[int], gb: int) -> None:
        """Before a speculative round: every block covering positions
        [pos, pos + gb] of an active slot (what the round writes and a
        rejection abandons) must be slot-private.  A shared block there is
        copied first, in BOTH pools, and the slot's reference to the
        shared one dropped.  The admission paths never map a shared block
        at the write frontier, so this is a backstop.  A pool too dry to
        copy preempts the slot (replay is the uniform answer to
        starvation) rather than ever writing a sharer-visible block."""
        bs = self.paged.block_size
        for ix in active:
            slot = self._slots[ix]
            if slot is None:
                continue
            lo = int(self._pos[ix]) // bs
            hi = min((int(self._pos[ix]) + gb) // bs, len(slot.blocks) - 1)
            if hi < lo:
                continue
            idxs = list(range(lo, hi + 1))
            refs = self.allocator.refcounts([slot.blocks[i] for i in idxs])
            for i, r in zip(idxs, refs):
                if r <= 1:
                    continue
                fresh = self._alloc_evicting(1)
                if fresh is None:
                    self._preempt(ix)
                    break
                try:
                    with self._stamp("cow_copy"):
                        self._cow_copy(slot.blocks[i], fresh[0])
                except BaseException:
                    self.allocator.free(fresh)
                    raise
                shared = slot.blocks[i]
                slot.blocks[i] = fresh[0]
                self.allocator.free([shared])    # decref: sharers keep it
                self._set_table_row(ix, self._table_row(slot.blocks))
                obs_spans.event(slot.request.trace, "spec_cow",
                                block=shared, copy=fresh[0])

    def _spec_steps(self, slot: _Slot, gb: Optional[int] = None) -> int:
        """Positions past ``pos`` a speculative round must land in real
        blocks for this slot: its own γ+1 chunk rows (capped by the
        round's bucket when given).  Deeper rows of the fused verify fall
        off the table row into the trash block and are never accepted."""
        g = slot.gamma if slot.spec else 0
        if gb is not None:
            g = min(g, gb)
        return g + 1

    def _rewind_frontier(self, ix: int) -> None:
        """After a round, free every block past what the slot's NEXT round
        can write (its accepted frontier plus its own γ+1 runway).  The
        freed tail is the youngest, slot-private end of the block list,
        never a leading shared-prefix block; freeing is a refcounted
        decref through the one allocator that serves both pools."""
        slot = self._slots[ix]
        if slot is None:
            return
        bs = self.paged.block_size
        end = int(self._pos[ix]) + self._spec_steps(slot)
        need = max(1, min(slot.max_blocks, -(-end // bs)))
        if len(slot.blocks) <= need:
            return
        tail = slot.blocks[need:]
        del slot.blocks[need:]
        self.allocator.free(tail)
        self._set_table_row(ix, self._table_row(slot.blocks))

    def _ensure_growth(self, active: List[int],
                       spec_gb: Optional[int] = None) -> None:
        """Pre-tick lazy KV growth: every active slot's table must cover
        the positions this tick writes: ``decode_steps_per_tick`` for a
        plain tick, the slot's own γ+1 chunk for a speculative round at
        bucket ``spec_gb``.  A dry pool (after evicting parked prefixes)
        first cancels the in-flight prefill, then preempts the YOUNGEST
        slot (with quotas on, the most over-budget tenant's, then the
        youngest): the freed blocks un-starve the elders and the victim
        replays on re-admission.  A sole occupant that cannot grow finishes
        with what it has (preempting itself would replay into the same
        wall)."""
        bs = self.paged.block_size
        for ix in active:
            slot = self._slots[ix]
            if slot is None:
                continue                     # preempted earlier this pass
            steps = (self.steps_per_tick if spec_gb is None
                     else self._spec_steps(slot, spec_gb))
            end = min(int(self._pos[ix]) + steps,
                      slot.prompt_len + slot.budget, self.cfg.max_seq_len)
            need = min(slot.max_blocks, -(-end // bs))
            while len(slot.blocks) < need:
                extra = self._alloc_evicting(need - len(slot.blocks))
                if extra is not None:
                    slot.blocks.extend(extra)
                    self._set_table_row(ix, self._table_row(slot.blocks))
                    break
                if self._prefill is not None:
                    self._cancel_prefill("kv pressure: decoding slot "
                                         "growth starved")
                    continue
                victims = [j for j in active if self._slots[j] is not None]
                if victims == [ix]:
                    # Sole occupant of a pool that cannot hold its next
                    # block: cap the generation here.
                    obs_spans.event(slot.request.trace, "kv_truncated",
                                    generated=len(slot.tokens))
                    self._finish(ix)
                    break
                if self._tenant_quotas is None:
                    victim = max(victims, key=lambda j:
                                 self._slots[j].request.admit_seq)
                else:
                    # The noisy tenant pays for the pressure it made:
                    # resident bill over budget (budget-less tenants 0.0),
                    # then youngest.
                    bills: Dict[Optional[str], float] = {}

                    def _over(j: int) -> float:
                        t = self._slots[j].request.tenant
                        if t not in bills:
                            q = self._tenant_quota(t)
                            bills[t] = (self.tenant_kv_blocks(t)
                                        / float(q.kv_blocks)
                                        if q.kv_blocks else 0.0)
                        return bills[t]
                    victim = max(victims, key=lambda j: (
                        _over(j), self._slots[j].request.admit_seq))
                self._preempt(victim)
                if victim == ix:
                    break                    # the grower itself yielded

    def _next_request(self) -> Optional[_Request]:
        """Head lane first, then the submission queue: FIFO with quotas
        off, deficit-weighted round-robin over tenant lanes with them
        on."""
        if self._head:
            return self._head.popleft()
        if self._tenant_quotas is None:
            try:
                return self._queue.get_nowait()
            except queue.Empty:
                return None
        return self._next_request_dwrr()

    def _next_request_dwrr(self) -> Optional[_Request]:
        """Deficit-weighted round-robin: arrivals drain into per-tenant
        FIFO lanes; each pass tops every occupied lane's deficit up by its
        tenant's weight and serves the first lane (in sorted tenant order,
        so the order is deterministic for one arrival interleaving) whose
        deficit covers one request.  A lane that empties forfeits its
        deficit."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            t = req.tenant or "default"
            self._tenant_lanes.setdefault(t, deque()).append(req)
            self._tenant_deficits.setdefault(t, 0.0)
        occupied = sorted(t for t, lane in self._tenant_lanes.items()
                          if lane)
        if not occupied:
            return None
        # Every top-up adds at least the weight floor, so a deficit
        # reaches 1.0 within bounded passes; the fallback pop keeps the
        # loop total for degenerate weights.
        for _ in range(64):
            for t in occupied:
                if self._tenant_deficits[t] >= 1.0:
                    self._tenant_deficits[t] -= 1.0
                    lane = self._tenant_lanes[t]
                    req = lane.popleft()
                    if not lane:
                        self._tenant_deficits[t] = 0.0
                    return req
            for t in occupied:
                self._tenant_deficits[t] += self._tenant_weight(t)
        t = occupied[0]
        lane = self._tenant_lanes[t]
        req = lane.popleft()
        if not lane:
            self._tenant_deficits[t] = 0.0
        return req

    def _tenant_quota(self, tenant: Optional[str]):
        """The quota row of ``tenant``: the tier's map, else the default
        quota (quotas on only)."""
        return self._tenant_quotas.get(tenant or "default",
                                       self._tenant_default_q)

    def _tenant_weight(self, tenant: Optional[str]) -> float:
        return max(1e-6, float(self._tenant_quota(tenant).weight))

    # -- completion ----------------------------------------------------------

    def _finish(self, slot_ix: int) -> None:
        slot = self._slots[slot_ix]
        gen_ids = trim_at_eos(slot.tokens, self.tokenizer.eos_id,
                              self.tokenizer.pad_id)
        req = slot.request
        with obs_spans.span(req.trace, "detokenize", tokens=len(gen_ids)):
            text = self.tokenizer.decode(gen_ids)
        req.result = GenerationResult(
            text=text, token_ids=gen_ids,
            prompt_tokens=slot.prompt_len, gen_tokens=len(gen_ids),
            ttft_ms=slot.ttft_ms,
            total_ms=(time.perf_counter() - req.t_submit) * 1000.0)
        self._release(slot_ix, park=True)
        if req.token_queue is not None:
            req.token_queue.put(None)        # end-of-stream sentinel
        req.done.set()

    def _release(self, slot_ix: int, park: bool = False) -> None:
        """Free a slot; with ``park`` its prompt blocks move to the prefix
        cache (generation-only trailing blocks go back to the pool)."""
        slot = self._slots[slot_ix]
        if slot.pinned_entry is not None and self.prefix_cache is not None:
            self.prefix_cache.unpin(slot.pinned_entry)
        parked = False
        if park and self.prefix_cache is not None and slot.prompt_ids:
            keep = -(-slot.prompt_len // self.paged.block_size)
            if 0 < keep <= len(slot.blocks):
                cache: Dict[str, Any] = {"blocks": slot.blocks[:keep]}
                if self._tenant_quotas is not None:
                    # Tagged with its tenant, so tenant_kv_blocks bills it
                    # and an over-budget tenant's entry evicts first.
                    cache["tenant"] = slot.request.tenant or "default"
                parked = self.prefix_cache.put(slot.prompt_ids, cache)
                if parked:
                    self.allocator.free(slot.blocks[keep:])
        if not parked:
            self.allocator.free(slot.blocks)
        self._slots[slot_ix] = None
        self._set_table_row(slot_ix, TRASH_BLOCK)
        self._pos[slot_ix] = 0
        self._cur[slot_ix] = 0

    def _fail_request(self, req: _Request, exc: BaseException) -> None:
        req.error = exc
        if req.token_queue is not None:
            req.token_queue.put(None)
        req.done.set()

    def _fail_slot(self, slot_ix: int, exc: BaseException) -> None:
        slot = self._slots[slot_ix]
        if slot is None:
            return
        self._release(slot_ix)
        self._fail_request(slot.request, exc)

    # -- scheduler -----------------------------------------------------------

    def _loop(self) -> None:          # dllm-lint: hot-path
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                self._run_scheduler()
        finally:
            # A still-in-flight prefill requeues, so stop()'s drain fails
            # it with the engine-stopped shape.
            self._cancel_prefill("engine stopping")

    def _admit_pass(self) -> bool:
        """Admit queued requests into free slots; True if any admitted."""
        admitted_any = False
        if self._prefill is not None and self._head and self._head[0].needs_chunk:
            return False                 # FIFO: wait for the prefill lane
        for ix in range(self.paged.max_slots):
            if self._slots[ix] is not None:
                continue
            if self._prefill is not None and self._prefill.slot_ix == ix:
                continue                 # reserved by the in-flight prefill
            req = self._next_request()
            if req is None:
                break
            try:
                # The admission phase covers tokenize and slot/block
                # bookkeeping; its prefill and copy-on-write stamp their
                # own nested phases, so self-times stay disjoint.
                with self._stamp("admit"):
                    admitted = self._admit(req, ix)
                if not admitted:
                    self._head.appendleft(req)
                    break
                admitted_any = True
                self._progress_t = time.monotonic()
            except BaseException as exc:     # surface to the caller
                self._fail_request(req, exc)
        return admitted_any

    def _push_token(self, ix: int, slot: _Slot, tok: int) -> bool:
        """Append and stream one token; finish the slot (and return True)
        on the decode cap, EOS/PAD or the context edge."""
        slot.tokens.append(tok)
        # Tick-granular timeline: a tick's tokens stamp together, when
        # they become observable.
        obs_spans.add_token(slot.request.trace)
        if slot.request.token_queue is not None:
            slot.request.token_queue.put(tok)
        self._pos[ix] += 1
        self._cur[ix] = tok
        if (len(slot.tokens) >= slot.budget
                or tok in (self.tokenizer.eos_id, self.tokenizer.pad_id)
                or self._pos[ix] >= self.cfg.max_seq_len - 1):
            self._finish(ix)
            return True
        return False

    def _emit(self, active: List[int], toks: np.ndarray) -> None:
        """Apply a tick's [T, B] tokens slot by slot (a slot that finishes
        at step t discards its later steps)."""
        for t in range(toks.shape[0]):
            for ix in active:
                slot = self._slots[ix]
                if slot is not None:     # else finished at an earlier step
                    self._push_token(ix, slot, int(toks[t, ix]))

    def _emit_spec(self, active: List[int], out: np.ndarray,
                   n_acc: np.ndarray, gammas: np.ndarray) -> None:
        """Apply one speculative round: per slot, fold the observed
        acceptance into its EWMA (next γ), emit the accepted drafts plus
        the target's pick (n_acc + 1 tokens; a slot that finishes
        mid-round discards the rest) and rewind the rejected tail."""
        drafted = accepted = 0
        for ix in active:
            slot = self._slots[ix]
            if slot is None:
                continue
            k, g_i = int(n_acc[ix]), int(gammas[ix])
            if slot.spec and g_i > 0:
                slot.accept_ewma = ((1.0 - SPEC_EWMA_ALPHA) * slot.accept_ewma
                                    + SPEC_EWMA_ALPHA * k / g_i)
                slot.gamma = self._adapt_gamma(
                    slot.accept_ewma,
                    cap=self._tenant_gamma_cap(slot.request))
                slot.spec_drafted += g_i
                slot.spec_accepted += k
                drafted += g_i
                accepted += k
                acc = self._spec_slot_acc.setdefault(ix, [0, 0])
                acc[0] += g_i
                acc[1] += k
                if slot.gamma == 0:
                    obs_spans.event(slot.request.trace, "spec_degraded",
                                    accept_ewma=round(slot.accept_ewma, 4))
            if not any(self._push_token(ix, slot, int(out[ix, t]))
                       for t in range(k + 1)):
                self._rewind_frontier(ix)
        self.spec_drafted_total += drafted
        self.spec_accepted_total += accepted
        if drafted:
            m = get_observability().m
            m.spec_drafted.labels(self.tier.name).inc(drafted)
            m.spec_accepted.labels(self.tier.name).inc(accepted)

    def _active(self) -> List[int]:
        return [ix for ix, s in enumerate(self._slots) if s is not None]

    def _plan_tick(self, active: List[int]):
        """Grow (and, before a speculative round, make private) every
        active slot's blocks; returns (surviving active slots, the
        round's γ bucket or None for a plain tick).  The plan is redone
        after each step: a slot finished for lack of blocks may be the
        one that set the bucket."""
        spec_gb = self._spec_plan(active)
        self._ensure_growth(active, spec_gb)
        active = self._active()
        if spec_gb is None:
            return active, None
        spec_gb = self._spec_plan(active)
        if spec_gb is not None:
            self._ensure_spec_private(active, spec_gb)
            active = self._active()
            spec_gb = self._spec_plan(active)
        if spec_gb is None and active:
            # The speculating slots are gone: the survivors were grown for
            # their own chunk rows only, so grow them for the plain tick
            # (an under-grown table would send real K/V to the trash).
            self._ensure_growth(active)
            active = self._active()
        return active, spec_gb

    def _add_decode_work(self, active: List[int], wb: int,
                         spec_gb: Optional[int]) -> None:
        """The roofline work of the tick just run over table width ``wb``,
        at the active rows' positions before it (the JAX engine's
        accounting).  A speculative round: the draft's gb + 1 steps, and
        one target verify whose gb + 1 rows share a slot's K/V read.  A
        plain tick: ``decode_steps_per_tick`` steps at the mid-tick
        positions.  The K/V span is the active kernel's
        (``decode_kv_span``)."""
        window = wb * self.paged.block_size
        mid = (spec_gb if spec_gb is not None else self.steps_per_tick) // 2
        kv_ctx = decode_kv_span(window,
                                [int(self._pos[ix]) + mid for ix in active],
                                self.device, block=self.paged.block_size)
        common = dict(kv_quantize=self.tier.kv_quantize, kv_ctx=kv_ctx)
        if spec_gb is not None:
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg_d, spec_gb + 1, window, batch=len(active),
                wbytes=self._wbytes_d, **common))
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg, 1, window, batch=(spec_gb + 1) * len(active),
                wbytes=self._wbytes, kv_batch=len(active), **common))
        else:
            self.phases.add_work("decode", **roofline.decode_work(
                self.cfg, self.steps_per_tick, window, batch=len(active),
                wbytes=self._wbytes, **common))

    def _run_scheduler(self) -> None:
        while not self._stop.is_set():
            admitted_any = self._admit_pass()
            active = self._active()
            spec_gb = None
            if active:
                active, spec_gb = self._plan_tick(active)
            if not active:
                if self._prefill is not None:
                    # No decoding slots: the whole pass is prefill.  A dry
                    # pool backs off instead of spinning.  The record
                    # closes before any wait: a backoff is not tick work.
                    progressed = self._advance_prefill()
                    self._commit(0)
                    if not progressed:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                    self._progress_t = time.monotonic()
                else:
                    # Commit any stamped work (an admission that finished
                    # at once, a KV-pressure deferral) before sleeping.
                    self._commit(0)
                    if not admitted_any:
                        self._progress_t = time.monotonic()
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                continue
            try:
                if spec_gb is None:
                    toks = self._decode_tick()
                else:
                    gammas = np.zeros(self.paged.max_slots, np.int32)
                    for ix in active:
                        if self._slots[ix].spec:
                            gammas[ix] = min(self._slots[ix].gamma, spec_gb)
                    out, n_acc = self._spec_tick(spec_gb, gammas)
                self.tick_ms.append(self._tick_ms)
                self.ticks_total += 1
            except BaseException as exc:
                # A dead tick must not kill the scheduler: fail the
                # in-flight requests and keep serving new ones.
                logger.exception("tier %s: decode tick failed", self.tier.name)
                for ix in active:
                    self._fail_slot(ix, exc)
                self._commit(len(active))
                continue
            # The "emit" phase: the tick's host work after its pull, its
            # accounting and the token fan-out.
            with self._stamp("emit"):
                try:
                    self._account_tick(active, spec_gb)
                except Exception:
                    # Bookkeeping of a tick that ran: its fault fails
                    # neither the tick's requests nor the scheduler.
                    logger.exception("tier %s: tick accounting failed",
                                     self.tier.name)
                if spec_gb is None:
                    self._emit(active, toks)
                else:
                    self._emit_spec(active, out, n_acc, gammas)
            if self._prefill is not None:
                self._advance_prefill()
            self._progress_t = time.monotonic()
            self._commit(len(active))

    def _account_tick(self, active: List[int],
                      spec_gb: Optional[int]) -> None:
        """The bookkeeping of the tick just run: its roofline work; the
        attribution of its decode phase's time, split evenly over the
        slots it served (one program decodes them together), with the KV
        blocks each holds at 1/refcount a block, onto their requests'
        traces (direct engine use, with no trace, is not billed); and the
        tick histogram and counter.  The ``impl`` label keeps the JAX
        names: ``pallas`` is a hand-written kernel on the card, ``xla`` the
        plain version on the CPU."""
        self._add_decode_work(active, self._tick_wb, spec_gb)
        tick_ms = self._tick_ms
        if self.profiler.enabled and not self._warming:
            share = tick_ms / len(active)
            for ix in active:
                trace = self._slots[ix].request.trace
                if trace is None:
                    continue
                kv_ticks = self._kv_weights.get(ix)
                if kv_ticks is None:
                    kv_ticks = sum(1.0 / (r if r > 0 else 1) for r in
                                   self.allocator.refcounts(
                                       self._slots[ix].blocks))
                    self._kv_weights[ix] = kv_ticks
                obs_spans.charge(trace, share, kv_ticks)
        q8 = "_q8" if self.tier.kv_quantize == "int8" else ""
        kind = ("ragged_verify" if spec_gb is not None
                else "ragged_decode" if self.ragged else "paged_decode") + q8
        m = get_observability().m
        m.decode_tick_ms.labels(self.tier.name).observe(tick_ms)
        m.decode_ticks.labels(
            self.tier.name, kind,
            "pallas" if self.device.type == "cuda" else "xla").inc()

    # -- public surface --------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name=f"batcher-{self.tier.name}")
            self._thread.start()

    def stop(self) -> None:
        """Join the loop, then fail everything still queued or in flight
        with the engine-stopped error shape and return every block."""
        with self._lifecycle:
            if self._thread is not None:
                self._stop.set()
                self._wake.set()
                self._thread.join(timeout=5)
                self._thread = None
            shutdown = EngineStoppedError(error_dict(
                f"Request failed: tier {self.tier.name} engine stopped "
                f"mid-flight"))
            # The in-flight prefill holds blocks and maybe a promotion pin:
            # cancel it before the cache clear and the spill stop.
            # dllm-lint: disable=lock-blocking-call -- bounded: the cancel waits only for the in-flight prefill's already-issued promotion copies, which must land before their host tiles are released; the lifecycle lock serializes start, stop and rescue only, and no liveness reader takes it
            self._cancel_prefill("engine stopping")
            if self.prefix_cache is not None:
                # Parked blocks -> free list (_try_demote stands down once
                # _stop is set: no parting spills).
                self.prefix_cache.clear()
            if self.kv_spill is not None:
                # Wait out in-flight demote copies (bounded), then stop the
                # copier: the host tier is consistent at rest.
                self.kv_spill.stop()
            for ix, slot in enumerate(self._slots):
                if slot is not None:
                    self._fail_slot(ix, shutdown)
            while True:
                req = self._next_request()
                if req is None:
                    break
                self._fail_request(req, shutdown)

    # -- crash rescue (serving/replicas.py restart_replica) -------------------

    def capture_requests(self) -> List[_Request]:
        """Harvest every queued and in-flight request for a crash rescue:
        join the scheduler loop, park each decoding slot's generated tokens
        on its request (the ``_preempt`` capture, which ``_admit_replay``
        later resumes on the same greedy tokens), unwind the in-flight
        chunked prefill and drain the head lane and the submission queue.
        The same ``_Request`` objects come back, their ``done`` events,
        token queues and traces intact, so blocked callers and streams
        stall through the rescue instead of failing, and the engine is
        left empty: a following ``stop()`` finds nothing to fail.  Each
        freed slot's table row points at the trash block (``_release``)
        before any later tick could replay against it."""
        captured: List[_Request] = []
        with self._lifecycle:
            if self._thread is not None:
                self._stop.set()
                self._wake.set()
                self._thread.join(timeout=5)
                self._thread = None
            # The in-flight prefill frees its blocks, drops its promotion
            # pin and requeues at the head, where the drain below finds it.
            # dllm-lint: disable=lock-blocking-call -- bounded: the cancel waits only for the in-flight prefill's already-issued promotion copies, which must land before their host tiles are released; the lifecycle lock serializes start, stop and rescue only, and no liveness reader takes it
            self._cancel_prefill("rescue_capture")
            for ix, slot in enumerate(self._slots):
                if slot is None:
                    continue
                req = slot.request
                req.replay_tokens = list(slot.tokens)
                req.replay_ttft_ms = slot.ttft_ms
                req.preempt_count += 1
                obs_spans.event(req.trace, "rescue_capture",
                                tier=self.tier.name,
                                generated=len(slot.tokens))
                self._release(ix)            # free ALL blocks, no parking
                captured.append(req)
            while True:
                req = self._next_request()
                if req is None:
                    break
                captured.append(req)
        return captured

    def adopt_requests(self, reqs: Sequence[_Request]) -> int:
        """Enqueue requests captured off a crashed or wedged engine.  Each
        re-enters through the submission queue; one that carries
        ``replay_tokens`` is admitted by ``_admit_replay`` (a prefill of
        prompt + emitted tokens, then decode from the last one), so a
        greedy continuation equals the uninterrupted run.  Returns the
        number adopted."""
        self.start()
        n = 0
        for req in reqs:
            # The chunk bookmark belongs to the dead engine's prefill lane.
            req.needs_chunk = False
            self._queue.put(req)
            n += 1
        if n:
            self._wake.set()
        return n

    def detach_spill(self) -> Optional[HostKVSpill]:
        """Hand the host spill store out of the engine's lifetime: flush
        the in-flight demote copies (the host tier is consistent at rest),
        then unhook it, so a following ``stop()`` leaves it running.
        Returns the store, or None when the engine has none."""
        spill = self.kv_spill
        if spill is None:
            return None
        spill.flush(timeout_s=5.0)
        self.kv_spill = None
        return spill

    def adopt_spill(self, spill: Optional[HostKVSpill]) -> bool:
        """Install a surviving host spill store into this freshly built
        engine.  Its geometry must match (per-block host bytes, the
        prefix cache's min-prefix floor) or it is refused and the caller
        hands it to a sibling.  The engine's own store, if it built one,
        is stopped and replaced."""
        if (spill is None or self.prefix_cache is None
                or not self.chunk_tokens):
            return False
        if (spill.block_bytes != self._spill_block_bytes
                or spill.min_prefix != self.prefix_cache.min_prefix):
            return False
        old = self.kv_spill
        if old is not None and old is not spill:
            old.stop()
        self.kv_spill = spill
        return True

    def submit(self, history: History, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               token_queue: Optional["queue.Queue"] = None,
               tenant: Optional[str] = None) -> _Request:
        self.start()
        trace = obs_spans.current_trace()
        if tenant is None and trace is not None:
            # Serving path: the router stamps the tenant on the trace, so
            # the tier client's calls bill it without a new argument.
            tenant = trace.attrs.get("tenant")
        req = _Request(history=history, max_new_tokens=max_new_tokens,
                       temperature=temperature, token_queue=token_queue,
                       trace=trace, tenant=tenant)
        self._queue.put(req)
        self._wake.set()
        return req

    def generate(self, history: History, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 tenant: Optional[str] = None) -> GenerationResult:
        req = self.submit(history, max_new_tokens, temperature,
                          tenant=tenant)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def generate_stream(self, history: History,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None,
                        tenant: Optional[str] = None) -> "StreamHandle":
        """Text deltas as tokens come off the shared decode loop; the final
        GenerationResult is ``.result`` once the stream is exhausted."""
        req = self.submit(history, max_new_tokens, temperature,
                          token_queue=queue.Queue(), tenant=tenant)
        eos, pad = self.tokenizer.eos_id, self.tokenizer.pad_id

        def deltas():
            decoder = StreamDecoder(self.tokenizer)
            while True:
                tok = req.token_queue.get()
                if tok is None:
                    break
                if tok in (eos, pad):
                    continue
                text = decoder.feed(tok)
                if text:
                    yield text
            tail = decoder.flush()
            if tail:
                yield tail
            if req.error is not None:
                raise req.error

        return StreamHandle(deltas(), req)

    def queue_depth(self) -> int:
        """Submitted but not yet decoding (the tenant lanes and the
        in-flight chunked prefill included)."""
        laned = sum(len(lane) for lane in list(self._tenant_lanes.values()))
        return (self._queue.qsize() + len(self._head) + laned
                + (1 if self._prefill is not None else 0))

    def pending_work(self) -> int:
        """Queued + active requests (the drain loop's completion signal)."""
        return (self.queue_depth()
                + sum(1 for s in self._slots if s is not None))

    def kv_stats(self) -> Dict[str, Any]:
        """Block-pool snapshot for KV-aware admission: free and reclaimable
        blocks, geometry, the preemption count, the in-flight prefill's
        remaining demand, the sharing picture and, with a spill tier, the
        host tier's occupancy, its demote/promote counters and the
        in-flight promotion's remaining blocks."""
        reclaimable = (self.prefix_cache.reclaimable_blocks()
                       if self.prefix_cache is not None else 0)
        pf = self._prefill
        pending = backlog = 0
        if pf is not None:
            backlog = pf.total - min(pf.consumed, pf.total)
            pending = max(0, min(pf.max_blocks,
                                 -(-pf.total // self.paged.block_size))
                          - len(pf.blocks))
        rs = self.allocator.ref_stats()
        pinned = (self.prefix_cache.stats()["pinned_entries"]
                  if self.prefix_cache is not None else 0)
        spill_fields: Dict[str, int] = {}
        if self.kv_spill is not None:
            ss = self.kv_spill.stats()
            promote_backlog = 0
            if pf is not None and pf.promote_entry is not None:
                promote_backlog = max(0, pf.promote_nb - pf.promote_done)
            spill_fields = {
                "host_entries": ss["entries"],
                "host_blocks": ss["blocks"],
                "host_bytes": ss["bytes"],
                "host_budget_bytes": ss["budget_bytes"],
                "demotions_total": ss["demotions_total"],
                "promotions_total": ss["promotions_total"],
                "promotion_races_total": ss["promotion_races_total"],
                # Entries whose host copy has not landed (queued jobs'
                # entries are already copying).
                "demote_inflight": ss["copying_entries"],
                "promote_backlog_blocks": promote_backlog,
            }
        return {
            **spill_fields,
            "free_blocks": self.allocator.available,
            "reclaimable_blocks": reclaimable,
            "block_size": self.paged.block_size,
            "total_blocks": self.paged.num_blocks - 1,   # minus trash
            "preempted_total": self.preempted_total,
            "prefill_pending_blocks": pending,
            "prefill_backlog_tokens": backlog,
            "shared_blocks": rs["shared_blocks"],
            "dedup_ratio": (round(rs["total_refs"] / rs["allocated_blocks"], 4)
                            if rs["allocated_blocks"] else 1.0),
            "pinned_entries": pinned,
        }

    def max_demand_blocks(self) -> int:
        """Worst-case demand of one request (largest prefill bucket + the
        full decode budget), tokenization-free: when free + reclaimable
        blocks cover it, the tier client's KV gate cannot fire and skips
        tokenizing."""
        bucket = max(self._buckets) if self._buckets else self.cfg.max_seq_len
        return -(-min(bucket + self.tier.max_new_tokens,
                      self.cfg.max_seq_len) // self.paged.block_size)

    def projected_demand_blocks(self, history: History,
                                max_new_tokens: Optional[int] = None) -> int:
        """Pool blocks this request needs at its FULL decode budget (prompt
        bucket + decode cap): the demand side of the KV gate, tokenized as
        ``_admit`` tokenizes it, on the serving thread before submit."""
        _, bucket = prepare_prompt(self.tokenizer, history,
                                   self.tier.prefill_buckets,
                                   self.cfg.max_seq_len,
                                   self.tier.max_new_tokens)
        budget = self.tier.max_new_tokens
        if max_new_tokens and max_new_tokens > 0:
            budget = min(budget, max_new_tokens)
        return -(-min(bucket + budget, self.cfg.max_seq_len)
                 // self.paged.block_size)

    def progress_stall_s(self) -> float:
        """Seconds since the scheduler last progressed WHILE work is
        pending (the decode watchdog's signal); 0.0 when idle."""
        if self._thread is None:
            return 0.0
        if self.queue_depth() == 0 and all(s is None for s in self._slots):
            return 0.0
        return max(0.0, time.monotonic() - self._progress_t)

    def tick_stats(self) -> Dict[str, Any]:
        """Decode-tick wall-time quantiles over the recent-tick ring
        (nearest rank, round(q * (n - 1))), the count of every tick the
        scheduler ran (``ticks``; each is one "decode" phase) and the tick
        programs' keys by stage (``compiled``)."""
        compiled = {stage: sorted(keys, key=lambda k: (type(k).__name__, k))
                    for stage, keys in list(self._compiled.items())}
        ticks: List[float] = []
        for _ in range(3):
            try:
                ticks = sorted(self.tick_ms)
                break
            except RuntimeError:         # ring appended mid-copy
                continue
        if not ticks:
            return {"n": 0, "p50_ms": None, "p95_ms": None,
                    "ticks": self.ticks_total, "compiled": compiled}

        def pct(q: float) -> float:
            return round(ticks[min(len(ticks) - 1,
                                   int(q * (len(ticks) - 1) + 0.5))], 3)

        return {"n": len(ticks), "p50_ms": pct(0.5), "p95_ms": pct(0.95),
                "ticks": self.ticks_total, "compiled": compiled}

    def slot_stats(self) -> Dict[str, Any]:
        """Occupancy snapshot for health(): advisory lock-free reads.
        ``spec_gammas`` maps each active slot to its γ (0 = plain decode
        or spec-ineligible); empty when speculation is off."""
        active = sum(1 for s in self._slots if s is not None)
        total = self.paged.max_slots
        pf = self._prefill
        gammas: Dict[str, int] = {}
        if self.spec:
            for ix, s in enumerate(self._slots):
                if s is not None:
                    gammas[str(ix)] = s.gamma if s.spec else 0
        return {
            "queue_depth": self.queue_depth(),
            "active_slots": active,
            "max_slots": total,
            "slot_occupancy": round(active / max(1, total), 3),
            "preempted_total": self.preempted_total,
            "prefill_inflight": 0 if pf is None else 1,
            "prefill_backlog_tokens": (0 if pf is None else
                                       max(0, pf.total - min(pf.consumed,
                                                             pf.total))),
            "spec_gammas": gammas,
        }

    def spec_stats(self) -> Dict[str, Any]:
        """Speculation snapshot: lifetime draft/accept totals, the
        acceptance ratio, the live per-slot γ map and per-slot-index
        lifetime counts (advisory lock-free reads)."""
        drafted = self.spec_drafted_total
        accepted = self.spec_accepted_total
        return {
            "enabled": self.spec,
            "gamma_max": self.spec_gamma_max,
            "gamma_buckets": list(self._gamma_buckets),
            "drafted_total": drafted,
            "accepted_total": accepted,
            "accept_ratio": (round(accepted / drafted, 4)
                             if drafted else None),
            "slot_gammas": self.slot_stats()["spec_gammas"],
            "per_slot": {
                str(ix): {"drafted": d, "accepted": a,
                          "ratio": round(a / d, 4) if d else None}
                for ix, (d, a) in sorted(self._spec_slot_acc.items())},
        }

    def prefix_affinity(self, history) -> int:
        """Longest parked-prefix token match in the paged pool for
        ``history`` (tokenized as admission would): the router's
        non-destructive prefix-affinity probe."""
        if self.prefix_cache is None or not self._reuse_buckets:
            return 0
        return self.prefix_affinity_tokens(self.affinity_token_ids(history))

    def affinity_token_ids(self, history) -> List[int]:
        """``history`` tokenized as admission would: the shared half of
        the affinity probe, so replica dispatch tokenizes once and peeks
        every replica with the same ids."""
        ids, _ = prepare_prompt(self.tokenizer, history,
                                self.tier.prefill_buckets,
                                self.cfg.max_seq_len,
                                self.tier.max_new_tokens)
        return ids

    def prefix_affinity_tokens(self, ids: Sequence[int]) -> int:
        """Longest parked-prefix match for tokenized ``ids`` in the device
        prefix cache or the host spill tier, capped as select_reuse's
        take() is (a peek: nothing moves).  A demoted prefix counts: a
        session follows its spilled prefix home, since its promotion beats
        a cold prefill elsewhere."""
        if self.prefix_cache is None or not self._reuse_buckets:
            return 0
        cap = self.cfg.max_seq_len - self._reuse_buckets[0]
        best = self.prefix_cache.peek(ids, max_len=cap)
        if self.kv_spill is not None:
            best = max(best, self.kv_spill.peek(ids, max_len=cap))
        return best

    def demote_parked(self) -> int:
        """Evict every unpinned parked prefix now, each through the
        eviction sink (a demote to the spill tier where there is one):
        the scale-down sweep of serving/replicas.py, run before a drain
        stops the engine's demotions.  Returns the entries evicted."""
        if self.prefix_cache is None:
            return 0
        n = 0
        while self.prefix_cache.pop_oldest() is not None:
            n += 1
        return n

    def warmup(self) -> None:
        """Build the programs before traffic that the JAX engine compiles
        before traffic: one short request through the whole path (its
        bucket's prefill and writer, the draft's twins, and the first
        tick's program: the ragged tick, the dense tick's first rung or
        the top γ bucket's round); the dense tick's second rung; with
        speculation on, every γ bucket; with shared prefixes, the
        copy-on-write copies (and the draft's), between two blocks
        allocated for them; with a prefix cache, the chunk program of
        every (reuse bucket, chunk window) a prefix hit can take, with the
        draft's twin; with chunking, the cold chunk's ``(chunk_tokens,
        window)`` for every window a chunk can reach.  Every slot is free
        then, so the extra ticks and chunks write only the trash block
        (the all-trash table row).  The other prefill buckets are built
        on first use, as the JAX engine compiles them.  None of it is
        recorded by the profiler."""
        self._warming = True
        try:
            self.generate("warmup", max_new_tokens=2)
            for w in ([] if self.ragged else self._buckets[1:2]):
                self._decode_tick(min(w // self.paged.block_size,
                                      self.paged.blocks_per_slot))
            if self.spec:
                for gb in self._gamma_buckets:
                    self._spec_tick(gb, np.zeros(self.paged.max_slots,
                                                 np.int32))
            if self.share_prefix:
                blks = self.allocator.alloc(2)
                if blks is not None:
                    try:
                        self._cow_copy(blks[0], blks[1])
                    finally:
                        self.allocator.free(blks)
            if self.prefix_cache is not None and self._buckets:
                for sb in self._reuse_buckets:
                    for window in self._chunk_windows:
                        if window >= sb + 1:
                            self._chunk_first([], sb, 0, 1, [], window, 0.0,
                                              draft=self.spec)
            if (self.chunk_tokens and self._buckets
                    and max(self._buckets) > self.chunk_tokens):
                for window in self._chunk_windows:
                    if window >= self.chunk_tokens:
                        self._chunk_first([], self.chunk_tokens, 0, 1, [],
                                          window, 0.0)
        finally:
            self._warming = False


class StreamHandle:
    """Iterable of text deltas; ``.result`` is the final GenerationResult
    once the stream is exhausted."""

    def __init__(self, gen, request: _Request):
        self._gen = gen
        self.request = request

    def __iter__(self):
        return self._gen

    @property
    def result(self) -> Optional[GenerationResult]:
        return self.request.result
