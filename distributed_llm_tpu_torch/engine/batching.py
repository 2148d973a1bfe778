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

A tick's device work is one **tick program** (``TickProgram``), as the
JAX engine compiles one: the ragged tick is one program, the dense tick
one per window rung ``wb`` (JAX's ``("decode", (wb, tp))``), the
speculative round one per γ bucket (draft steps, verify, acceptance and
the emitted tokens; JAX's draft and verify pair).  On the card each is
captured once as a CUDA graph and replayed every tick; on the CPU, which
has no graphs, the same body runs directly, so the CPU tests run exactly
the code that is captured.  There is no eager tick on the card: a
capture or replay that fails fails the tick's slots, as a failed launch
does.  The programs read static inputs: device buffers allocated once
for the engine's life (positions, tokens, temperatures, γ caps and the
[B, MB] block table, each dense rung a column view of it), filled by
``copy_`` from host arrays (pinned on the card) before every tick; the
table is copied only after a row changed, in place.  Each new program
is recorded by ``_note_compile(stage, key)`` (a log line and the
per-stage key sets in ``tick_stats()["compiled"]``).  ``warmup`` captures
what the JAX engine's compiles: the warm request's program, the dense
tick's second rung and every γ bucket; deeper rungs are captured on
first use.  A program always draws its sampling noise, greedy slots
included (``sample_batched`` keeps their argmax), as JAX's single
compiled tick does: one program per rung, not one per (rung, sampled),
and greedy tokens are the same either way.  Kernel launch counts count
replays (``TickProgram``).

Each scheduler pass is also recorded by the engine's tick-phase profiler
(``self.profiler``, obs/profiler.py; ``profile=False`` gives the
zero-cost null profiler), at the JAX engine's phases: ``admit`` (an
admission, with ``prefill`` and ``cow_copy`` nested in it),
``table_upload`` (the tick's static inputs copied in), ``decode`` (a
plain tick's program, its capture when it is new, and its pull),
``verify`` (a speculative round: one replayed program where the JAX
engine stamps a ``draft`` and a ``verify`` phase), ``emit`` (the tick's
host work after its pull: its accounting, below, and the token fan-out;
the JAX engine leaves the accounting unstamped) and ``chunk_prefill``.
A capture is the port's compile: it stamps the ``compile`` event and
lands inside the tick's phase, as a JAX compile does.  Each decode
tick's time is split evenly over the slots it served and charged to
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
work it launched; a tick's phase wraps the replay, never a capture.  A
speculative round is one "decode" phase where the JAX engine times its
draft and its verify apart.

Not ported yet (ROADMAP.md): host KV spill, preemption and replay,
tenant quotas (and their γ caps), crash capture/adopt, tensor
parallelism and int8 weights.  Without
preemption, a slot whose next block (or copy-on-write block before a
speculative round) cannot be allocated even after evicting every parked
prefix and cancelling the in-flight prefill is finished early with what
it has generated (the JAX engine's rule for a sole occupant); a
full-residency pool, the only kind ported, does not reach that state in
practice.
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
from ..models import transformer
from ..models.transformer import Transformer
from ..obs import get_observability
from ..obs import spans as obs_spans
from ..obs.profiler import DEFAULT_CAPACITY, make_profiler
from ..ops import launches
from ..ops.attention import decode_kv_span
from ..ops.sampling import sample_batched
from ..serving.errors import error_dict
from ..utils import roofline
from ..utils.telemetry import PhaseTimer
from .inference import GenerationResult, prepare_prompt, trim_at_eos
from .paged_kv import (BlockAllocator, PagedConfig, TRASH_BLOCK,
                       chunk_prefill_paged, copy_block, decode_step_paged,
                       init_pool, verify_step_paged, write_prefill_blocks)
from .prefix_cache import PrefixCache, select_reuse
from .tokenizer import StreamDecoder, get_tokenizer

History = Union[str, Sequence[Dict[str, Any]]]

logger = logging.getLogger(__name__)

# Captures are serialized across the process's engines: a capture takes
# the default CUDA generator's state for its own while it runs.
_CAPTURE_LOCK = threading.Lock()

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
    return x.cpu().numpy()


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Capture into ``graph`` on ``stream`` from the engine's memory
    ``pool``, thread-local: ``torch.cuda.graph`` without its
    device-wide synchronize, garbage collection and allocator cache
    flush, which would stall the other engine on the card, and leave the
    next eager prefill to allocate its memory afresh."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


class TickProgram:
    """One tick's device work, ``body()`` -> its output tensor.  Without
    a ``graph`` (the CPU) ``run()`` calls the body.  With one, the body is
    captured once inside ``capture(graph)`` (a context manager) and
    ``run()`` replays it and returns the static output the capture
    allocated.  The kernel launches the capture counted are taken back (a
    capture runs nothing) and added again at every replay, so the
    wrappers' counts count launches on the card."""

    def __init__(self, body: Callable[[], torch.Tensor], graph=None,
                 capture: Optional[Callable] = None):
        self.body = body
        self.graph = graph
        self.out: Optional[torch.Tensor] = None
        self.launch_deltas: Dict[str, int] = {}
        if graph is not None:
            before = launches.counts()
            with capture(graph):
                self.out = body()
            self.launch_deltas = launches.since(before)
            launches.add(self.launch_deltas, -1)

    def run(self) -> torch.Tensor:
        if self.graph is None:
            return self.body()
        self.graph.replay()
        launches.add(self.launch_deltas)
        return self.out


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
    seq: List[int]
    prompt_len: int
    prompt_ids: tuple
    total: int
    budget: int
    temperature: float
    max_blocks: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    consumed: int = 0
    chunks_done: int = 0
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


class ContinuousBatchingEngine:
    """The batched engine behind a tier: ``generate()``/``generate_stream()``
    for concurrent callers, one shared decode loop.  Runs on the card
    unless ``device="cpu"`` is asked for (the plain PyTorch path).
    ``params``/``draft_params`` replace the seeded random target/draft
    weights."""

    # Concurrent callers share the scheduler: the tier client does not
    # serialize them.
    concurrent_safe = True

    def __init__(self, tier: TierConfig, seed: int = 0,
                 params: Optional[Transformer] = None,
                 device: DeviceLike = None,
                 draft_params: Optional[Transformer] = None,
                 profile: bool = True,
                 profile_ticks: int = DEFAULT_CAPACITY):
        tier.check_ported()
        if tier.decode_batch <= 1:
            raise NotImplementedError(
                f"tier {tier.name}: decode_batch={tier.decode_batch} selects "
                "the sequential InferenceEngine (EngineManager builds it); "
                "the batched engine needs decode_batch > 1")
        self.tier = tier
        self.device = resolve_device(device)
        self.cfg = tier.model()
        bad = [b for b in tier.prefill_buckets if b % tier.kv_block_size]
        if bad:
            raise ValueError(
                f"prefill buckets {bad} not multiples of kv_block_size="
                f"{tier.kv_block_size}: prefilled K/V must page evenly")
        self.tokenizer = get_tokenizer(self.cfg)
        self.paged = PagedConfig(block_size=tier.kv_block_size,
                                 max_slots=tier.decode_batch,
                                 max_seq_len=self.cfg.max_seq_len)
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
        if params is None:
            params = transformer.init_params(self.cfg, seed=seed,
                                             device=self.device)
        self.model = params.to(self.device)
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
                self.model_d = draft_params.to(self.device)
            elif tier.draft_preset == tier.model_preset:
                # Self-draft: the draft IS the target (shared weights).
                self.model_d = self.model
            else:
                self.model_d = transformer.init_params(
                    self.cfg_d, seed=seed + 1, device=self.device)
            self.pool_d = init_pool(self.cfg_d, self.paged, tier.kv_quantize,
                                    device=self.device)
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
        # Tick programs by (stage, key), and the keys _note_compile saw.
        self._programs: Dict[tuple, TickProgram] = {}
        self._compiled: Dict[str, set] = {}
        if self.device.type == "cuda":
            # The engine's graphs share one memory pool: they never run
            # at once.
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
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

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(self.device, non_blocking=True)

    def _temp_tensor(self, temp: float) -> torch.Tensor:
        return torch.tensor([temp], dtype=torch.float32, device=self.device)

    def _sampler(self, temps: Sequence[float]) -> Optional[torch.Generator]:
        return self._gen if any(t > 0 for t in temps) else None

    def _prefill_first(self, tok: torch.Tensor, n: int, temp: float):
        """Cold prefill of one bucket (``tok`` [1, S] on the device):
        returns (first token tensor, k_all, v_all [L, S, N_kv, D])."""
        positions = torch.arange(tok.shape[1], device=self.device)[None]
        hidden, (k_all, v_all) = transformer.prefill(self.cfg, self.model,
                                                     tok, positions)
        logits = transformer.logits_from_hidden(self.model, hidden[:, n - 1])
        first = sample_batched(logits, self._temp_tensor(temp),
                               self._sampler([temp]))[0]
        return first, k_all[:, 0], v_all[:, 0]

    def _draft_prefill(self, tok: torch.Tensor, blocks: torch.Tensor) -> None:
        """Seed the draft pool with a cold prompt's K/V: the draft's own
        prefill of the same bucket, paged into the same blocks."""
        positions = torch.arange(tok.shape[1], device=self.device)[None]
        _, (k_all, v_all) = transformer.prefill(self.cfg_d, self.model_d,
                                                tok, positions)
        write_prefill_blocks(self.pool_d, blocks, k_all[:, 0], v_all[:, 0])

    def _chunk_first(self, tokens: np.ndarray, start: int, true_len: int,
                     row: np.ndarray, window: int, temp: float,
                     draft: bool = False):
        """Chunk-prefill into the pool (in place) and sample from the row
        of position ``true_len - 1`` (meaningful for the final chunk).
        ``draft`` also writes the chunk's draft K/V into the draft pool
        (a prefix hit's suffix, so the slot can speculate)."""
        args = (self._to_device(tokens.astype(np.int64)),
                self._to_device(np.array([start], np.int32)),
                self._to_device(np.array([true_len], np.int32)))
        table = self._to_device(row)
        hidden = chunk_prefill_paged(self.cfg, self.model, *args, self.pool,
                                     table, window)
        if draft:
            chunk_prefill_paged(self.cfg_d, self.model_d, *args, self.pool_d,
                                table, window)
        last = min(max(true_len - start - 1, 0), tokens.shape[1] - 1)
        logits = transformer.logits_from_hidden(self.model,
                                                hidden[:, last])
        return sample_batched(logits, self._temp_tensor(temp),
                              self._sampler([temp]))[0]

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

    def _note_compile(self, stage: str, key: int) -> None:
        """Record a NEW tick program for ``stage`` (``"decode"``: the table
        width wb, the ragged tick's being MB; ``"spec"``: the γ bucket)
        and log it: warmup's captures must be visible, and one mid-serve
        stalls every active slot.  The profiler's timeline gets a
        ``compile`` event and the ``dllm_compiled_programs`` gauge the
        stage's count."""
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

    def _built(self, stage: str, key: int) -> TickProgram:
        """The tick program for (``stage``, ``key``), built (captured, on
        the card) at first use."""
        prog = self._programs.get((stage, key))
        if prog is None:
            self._note_compile(stage, key)
            body = (self._decode_body if stage == "decode"
                    else self._spec_body)(key)
            prog = (self._capture(body) if self.device.type == "cuda"
                    else TickProgram(body))
            self._programs[(stage, key)] = prog
        return prog

    def _tick_phase(self):
        """The "decode" phase of a tick: its replay and its pull, on the
        scheduler thread (the serving ticks; warmup's direct ticks are
        not timed)."""
        if threading.current_thread() is self._thread:
            return self.phases.phase("decode")
        return contextlib.nullcontext()

    def _capture(self, body: Callable[[], torch.Tensor]) -> TickProgram:
        """``body`` as a CUDA graph on the engine's capture stream, after
        one run of it there (each kernel's module loads at its first
        launch, which a capture may not do).  That run writes what the
        first replay rewrites from the same inputs.  The engine's
        generator is registered, so each replay draws new numbers; and the
        capture is thread-local (``_capturing``), since another engine's
        scheduler (and the router) may use the card meanwhile."""
        with _CAPTURE_LOCK:
            stream = self._capture_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                body()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._gen)
            return TickProgram(body, graph, lambda g: _capturing(
                g, self._graph_pool, stream))

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
        ``attention_ragged`` (the JAX engine's mesh rule and its env
        override have no counterpart here: one card, no env knobs)."""
        return bool(self.tier.attention_ragged)

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

    def _adapt_gamma(self, ewma: float) -> int:
        """Acceptance EWMA -> the slot's next γ: proportional, with a
        floor at 0 (plain decode) once acceptance stops paying for the
        drafts."""
        gmax = self.spec_gamma_max
        if gmax <= 0 or ewma < SPEC_EWMA_FLOOR:
            return 0
        return max(1, min(gmax, int(ewma * gmax + 0.5)))

    def _note_prefix_hit(self, kind: str) -> None:
        """One admission attempt's prefix-cache outcome (shared |
        exclusive | miss) on ``dllm_prefix_hits_total{tier,kind}``: a
        KV-pressure requeue looks up again on re-admission, as the cache's
        own hit and miss counts do."""
        get_observability().m.prefix_hits.labels(self.tier.name, kind).inc()

    # -- block bookkeeping -------------------------------------------------

    def _prefix_evicted(self, entry) -> None:
        """on_evict sink: return the entry's blocks (a refcounted decref)."""
        blocks = entry.cache.get("blocks") if isinstance(entry.cache, dict) else None
        if blocks:
            self.allocator.free(blocks)

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
        admissions outrank parked caches."""
        blocks = self.allocator.alloc(n_blocks)
        while (blocks is None and self.prefix_cache is not None
               and self.prefix_cache.pop_oldest() is not None):
            blocks = self.allocator.alloc(n_blocks)
        return blocks

    # -- admission ---------------------------------------------------------

    def _slot_go_live(self, req: _Request, slot_ix: int, blocks: List[int],
                      *, prompt_len: int, prompt_ids: tuple, budget: int,
                      temp: float, max_blocks: int, pos: int, first: int,
                      ttft_ms: float, pinned_entry: Optional[Any] = None,
                      spec_ok: bool = False) -> None:
        """The go-live tail shared by every admission path: publish the
        slot, its table row and decode state, emit the prefill's token
        and apply the termination checks.  Speculation eligibility is
        fixed here for the slot's life: the admission must have seeded
        the draft pool (``spec_ok``) and the slot must be greedy."""
        spec = bool(self.spec and spec_ok and temp <= 0)
        slot = _Slot(request=req, blocks=blocks, prompt_len=prompt_len,
                     budget=budget, temperature=temp, ttft_ms=ttft_ms,
                     tokens=[first], prompt_ids=prompt_ids,
                     max_blocks=max_blocks, pinned_entry=pinned_entry,
                     spec=spec, gamma=self.spec_gamma_max if spec else 0)
        obs_spans.add_token(req.trace)       # the prefill's token
        if req.token_queue is not None:
            req.token_queue.put(first)
        self._slots[slot_ix] = slot
        self._set_table_row(slot_ix, self._table_row(blocks))
        self._pos[slot_ix] = pos
        self._cur[slot_ix] = first
        self._temps[slot_ix] = temp
        if first == self.tokenizer.eos_id or budget <= 1:
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
        bs = self.paged.block_size
        max_seq = self.cfg.max_seq_len

        reused = select_reuse(self.prefix_cache, ids, self._reuse_buckets,
                              max_seq, share=self.share_prefix)
        if self.prefix_cache is not None and reused is None:
            self._note_prefix_hit("miss")
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
            cover = max(m + sb, min(n + budget, max_seq))
            need = -(-cover // bs)
            boundary_src = None
            if self.share_prefix:
                # Shared hit: the entry's FULL blocks map read-only into
                # this slot's leading rows; the partially filled boundary
                # block is copied into the first private block, which the
                # suffix then writes.
                n_full = m // bs
                shared = list(entry.cache["blocks"][:n_full])
                if m % bs:
                    boundary_src = entry.cache["blocks"][n_full]
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
                    return False             # KV pressure: stay queued
                owned = shared + priv
                pinned_entry = entry
                self._note_prefix_hit("shared")
            else:
                # Exclusive take: the slot owns the entry's blocks and may
                # write the boundary block directly.
                owned = list(entry.cache["blocks"])
                if len(owned) < need:
                    extra = self._alloc_evicting(need - len(owned))
                    if extra is None:
                        self.prefix_cache.untake(entry, m)
                        self._note_prefix_hit("miss")
                        return False
                    owned += extra
                elif len(owned) > need:
                    self.allocator.free(owned[need:])
                    owned = owned[:need]
                self._note_prefix_hit("exclusive")
            try:
                if boundary_src is not None:
                    # The copy must land before the suffix writes, in both
                    # pools: the draft attends the same tables.
                    with self._stamp("cow_copy"):
                        copy_block(self.pool, boundary_src, priv[0])
                        if self.spec:
                            copy_block(self.pool_d, boundary_src, priv[0])
                tokens = np.full((1, sb), self.tokenizer.pad_id, np.int64)
                tokens[0, :len(suffix)] = suffix
                window = next(w for w in self._chunk_windows if w >= m + sb)
                # The draft writes its suffix K/V too; the parked prefix
                # blocks keep whatever draft K/V their writers left (stale
                # draft K/V only lowers acceptance).
                with obs_spans.span(req.trace, "prefill", reused_tokens=m,
                                    suffix_bucket=sb), \
                        self.phases.phase("prefill"), \
                        self._stamp("prefill"):
                    first = int(self._chunk_first(tokens, m, n,
                                                  self._table_row(owned),
                                                  window, temp,
                                                  draft=self.spec))
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
                tokens = np.full((1, bucket), self.tokenizer.pad_id, np.int64)
                tokens[0, :n] = ids
                with obs_spans.span(req.trace, "prefill", bucket=bucket), \
                        self.phases.phase("prefill"), \
                        self._stamp("prefill"):
                    tok = self._to_device(tokens)
                    first, k_all, v_all = self._prefill_first(tok, n, temp)
                    nb_prefill = bucket // bs
                    blk_dev = self._to_device(np.array(blocks[:nb_prefill],
                                                       np.int64))
                    write_prefill_blocks(self.pool, blk_dev, k_all, v_all)
                    if self.spec:
                        self._draft_prefill(tok, blk_dev)
                    # The first token must reach the host now (it seeds
                    # the slot): one sync per admission, never per tick.
                    first = int(first)
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

    def _start_prefill(self, req: _Request, slot_ix: int, ids: List[int],
                       n: int, bucket: int, budget: int) -> None:
        """Reserve ``slot_ix`` and register the in-flight chunked prefill;
        blocks are allocated per chunk as it advances."""
        bs = self.paged.block_size
        temp = (self.tier.temperature if req.temperature is None
                else req.temperature)
        self._prefill = _Prefill(
            request=req, slot_ix=slot_ix, seq=list(ids), prompt_len=n,
            prompt_ids=tuple(ids), total=len(ids), budget=budget,
            temperature=temp,
            max_blocks=-(-min(bucket + budget, self.cfg.max_seq_len) // bs))
        obs_spans.event(req.trace, "prefill_chunked", tokens=len(ids),
                        chunk_tokens=self.chunk_tokens, replayed=False)

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
                tokens = np.full((1, c), self.tokenizer.pad_id, np.int64)
                tokens[0, :k] = pf.seq[start:start + k]
                # The chunk is the budgeted stall unit; its token (used
                # from the final chunk) reaches the host here.
                t_chunk = time.perf_counter()
                with obs_spans.span(req.trace, "prefill_chunk", start=start,
                                    tokens=k, window=window), \
                        self.phases.phase("prefill"), \
                        self._stamp("chunk_prefill"):
                    first = int(self._chunk_first(tokens, start, pf.total,
                                                  self._table_row(pf.blocks),
                                                  window, pf.temperature))
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
            slot = self._slots[pf.slot_ix]
            if slot is not None and slot.request is req:
                self._fail_slot(pf.slot_ix, exc)
                return True
            self.allocator.free(pf.blocks)
            self._fail_request(req, exc)
            return True
        return progressed

    def _finish_prefill(self, pf: _Prefill, first: int) -> None:
        """Last chunk landed: the reserved slot goes live."""
        self._prefill = None
        obs_spans.annotate(pf.request.trace, prefill_wait_ms=round(
            (time.perf_counter() - pf.t_start) * 1000.0, 3))
        ttft_ms = (time.perf_counter() - pf.request.t_submit) * 1000.0
        self._slot_go_live(pf.request, pf.slot_ix, pf.blocks,
                           prompt_len=pf.prompt_len, prompt_ids=pf.prompt_ids,
                           budget=pf.budget, temp=pf.temperature,
                           max_blocks=pf.max_blocks, pos=pf.total, first=first,
                           ttft_ms=ttft_ms)

    def _cancel_prefill(self, reason: str) -> None:
        """Cancel the in-flight prefill and requeue it at the head: it has
        emitted nothing, so restarting from chunk 0 is free."""
        pf = self._prefill
        if pf is None:
            return
        self._prefill = None
        self.allocator.free(pf.blocks)
        self.prefill_cancelled_total += 1
        pf.request.needs_chunk = True
        obs_spans.event(pf.request.trace, "prefill_cancelled", reason=reason,
                        consumed_tokens=min(pf.consumed, pf.total))
        self._head.appendleft(pf.request)

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
        copy finishes the slot early (no preemption in the port yet)."""
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
                    logger.warning("tier %s: KV pool dry, slot %d finishes "
                                   "after %d tokens", self.tier.name, ix,
                                   len(slot.tokens))
                    self._finish(ix)
                    break
                try:
                    with self._stamp("cow_copy"):
                        copy_block(self.pool, slot.blocks[i], fresh[0])
                        copy_block(self.pool_d, slot.blocks[i], fresh[0])
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
        first cancels the in-flight prefill; failing that, the slot
        finishes with what it has (no preemption in the port yet)."""
        bs = self.paged.block_size
        for ix in active:
            slot = self._slots[ix]
            if slot is None:
                continue
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
                logger.warning("tier %s: KV pool dry, slot %d finishes "
                               "after %d tokens", self.tier.name, ix,
                               len(slot.tokens))
                obs_spans.event(slot.request.trace, "kv_truncated",
                                generated=len(slot.tokens))
                self._finish(ix)
                break

    def _next_request(self) -> Optional[_Request]:
        """Head lane first, then the submission queue (FIFO)."""
        if self._head:
            return self._head.popleft()
        try:
            return self._queue.get_nowait()
        except queue.Empty:
            return None

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
                parked = self.prefix_cache.put(slot.prompt_ids,
                                               {"blocks": slot.blocks[:keep]})
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

    def _loop(self) -> None:
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
                slot.gamma = self._adapt_gamma(slot.accept_ewma)
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
            self._cancel_prefill("engine stopping")
            if self.prefix_cache is not None:
                self.prefix_cache.clear()    # parked blocks -> free list
            for ix, slot in enumerate(self._slots):
                if slot is not None:
                    self._fail_slot(ix, shutdown)
            while True:
                req = self._next_request()
                if req is None:
                    break
                self._fail_request(req, shutdown)

    def submit(self, history: History, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               token_queue: Optional["queue.Queue"] = None) -> _Request:
        self.start()
        req = _Request(history=history, max_new_tokens=max_new_tokens,
                       temperature=temperature, token_queue=token_queue,
                       trace=obs_spans.current_trace())
        self._queue.put(req)
        self._wake.set()
        return req

    def generate(self, history: History, max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None) -> GenerationResult:
        req = self.submit(history, max_new_tokens, temperature)
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def generate_stream(self, history: History,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None) -> "StreamHandle":
        """Text deltas as tokens come off the shared decode loop; the final
        GenerationResult is ``.result`` once the stream is exhausted."""
        req = self.submit(history, max_new_tokens, temperature,
                          token_queue=queue.Queue())
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
        """Submitted but not yet decoding (the in-flight chunked prefill
        included)."""
        return (self._queue.qsize() + len(self._head)
                + (1 if self._prefill is not None else 0))

    def pending_work(self) -> int:
        """Queued + active requests (the drain loop's completion signal)."""
        return (self.queue_depth()
                + sum(1 for s in self._slots if s is not None))

    def kv_stats(self) -> Dict[str, Any]:
        """Block-pool snapshot: free and reclaimable blocks, geometry, the
        in-flight prefill's remaining demand and the sharing picture."""
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
        return {
            "free_blocks": self.allocator.available,
            "reclaimable_blocks": reclaimable,
            "block_size": self.paged.block_size,
            "total_blocks": self.paged.num_blocks - 1,   # minus trash
            "prefill_pending_blocks": pending,
            "prefill_backlog_tokens": backlog,
            "shared_blocks": rs["shared_blocks"],
            "dedup_ratio": (round(rs["total_refs"] / rs["allocated_blocks"], 4)
                            if rs["allocated_blocks"] else 1.0),
            "pinned_entries": pinned,
        }

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
        compiled = {stage: sorted(keys)
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
        ids, _ = prepare_prompt(self.tokenizer, history,
                                self.tier.prefill_buckets,
                                self.cfg.max_seq_len,
                                self.tier.max_new_tokens)
        return self.prefix_affinity_tokens(ids)

    def prefix_affinity_tokens(self, ids: Sequence[int]) -> int:
        """Longest parked-prefix match for tokenized ``ids``, capped as
        select_reuse's take() is (a peek: nothing moves)."""
        if self.prefix_cache is None or not self._reuse_buckets:
            return 0
        return self.prefix_cache.peek(
            ids, max_len=self.cfg.max_seq_len - self._reuse_buckets[0])

    def warmup(self) -> None:
        """Build the tick programs before traffic, as the JAX engine
        compiles them: one short request through the whole path (prefill,
        paging, and the first tick's program: the ragged tick, the dense
        tick's first rung or the top γ bucket's round); the dense tick's
        second rung; with speculation on, every γ bucket.  Every slot is
        free then, so the extra ticks write only the trash block.  None of
        it is recorded by the profiler."""
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
