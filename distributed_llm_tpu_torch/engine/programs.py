"""Device programs: a stage of an engine captured once and replayed.

Every engine of the port runs its device stages as ``TickProgram``s on
static inputs.  On the card a program is a CUDA graph, captured once
from the engine's own memory pool on its own capture stream
(``capture_program``) and replayed on the buffers it was captured
against; on the CPU the same body runs directly.  The batched engine's
ticks and admission stages (``engine/batching.py``) and the sequential
engines' prefill, suffix, grow, decode-segment and speculative-round
programs (``engine/inference.py``, ``engine/speculative.py``) are all
built here.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import threading
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from ..ops import launches

logger = logging.getLogger(__name__)

# Captures are serialized across the process's engines: a capture takes
# the default CUDA generator's state for its own while it runs.
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Capture into ``graph`` on ``stream`` from the engine's memory
    ``pool``, thread-local: ``torch.cuda.graph`` without its
    device-wide synchronize, garbage collection and allocator cache
    flush, which would stall the other engine on the card, and leave the
    next eager prefill to allocate its memory afresh.  The collector is
    off meanwhile: a collection inside the capture may free a dead
    engine's graphs and their memory pool, and a free the capturing
    thread makes invalidates its capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                yield
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()


class TickProgram:
    """One device stage (a tick, or a stage of an admission), ``body()``
    -> its output (a tensor, a tuple of them, or None).  Without a
    ``graph`` (the CPU) ``run()`` calls the body.  With one, the body is
    captured once inside ``capture(graph)`` (a context manager) and
    ``run()`` replays it and returns the static output the capture
    allocated.  Either way ``out`` holds the last run's output, which a
    later stage may read in place.  The kernel launches (and the plain
    paths' calls, and K11's launches by route) the capture counted are
    taken back (a capture runs nothing) and added again at every replay,
    so the counts count what ran on the card (per head shard too)."""

    def __init__(self, body: Callable[[], Any], graph=None,
                 capture: Optional[Callable] = None):
        self.body = body
        self.graph = graph
        self.out: Any = None
        self.launch_deltas: Dict[str, int] = {}
        self.call_deltas: Dict[str, int] = {}
        self.route_deltas: Dict[str, int] = {}
        self.shard_deltas: Dict[int, Dict[str, int]] = {}
        if graph is not None:
            before, calls = launches.counts(), launches.call_counts()
            routes, shards = launches.route_counts(), launches.shard_counts()
            with capture(graph):
                self.out = body()
            self.launch_deltas = launches.since(before)
            self.call_deltas = launches.since(calls, launches.call_counts())
            self.route_deltas = launches.since(routes, launches.route_counts())
            self.shard_deltas = launches.shard_since(shards)
            launches.add(self.launch_deltas, -1)
            launches.add_calls(self.call_deltas, -1)
            launches.add_routes(self.route_deltas, -1)
            launches.add_shards(self.shard_deltas, -1)

    def run(self) -> Any:
        if self.graph is None:
            self.out = self.body()
            return self.out
        self.graph.replay()
        launches.add(self.launch_deltas)
        launches.add_calls(self.call_deltas)
        launches.add_routes(self.route_deltas)
        launches.add_shards(self.shard_deltas)
        return self.out


def capture_program(body: Callable[[], Any], device: torch.device, stream,
                    pool, generators: Iterable[torch.Generator] = ()
                    ) -> TickProgram:
    """``body`` as a CUDA graph on ``stream`` from memory ``pool``, after
    one run of it there (each kernel's module loads at its first launch,
    which a capture may not do).  That run writes what the first replay
    rewrites from the same inputs.  Each of ``generators`` is registered,
    so each replay draws new numbers; and the capture is thread-local
    (``_capturing``), since another engine may use the card meanwhile.
    A capture that fails raises: there is no eager fallback."""
    with _CAPTURE_LOCK:
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            body()
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        return TickProgram(body, graph, lambda g: _capturing(g, pool, stream))


class SequentialPrograms:
    """The program table of a sequential engine (``InferenceEngine``,
    ``SpeculativeEngine``): static device inputs staged in place before a
    run, static outputs, and programs keyed as the JAX engine keys its
    compiled functions, each with the cache rung it runs on
    (``self._programs[(key, rung)]``; the rung is the shape a JAX key
    leaves to its trace).  A program is built (captured, on the card) at
    its first use; ``warmup()`` builds the JAX engine's warm set.
    Subclasses give ``_body(key, rung)``, the generators their programs
    draw from (``self._generators``) and the token pad id
    (``self.tokenizer.pad_id``)."""

    device: torch.device
    _generators: tuple = ()

    def _init_programs(self, inputs) -> None:
        """``inputs``: (name, shape, dtype) of each static input; each has
        a host twin (pinned on the card) it is staged through."""
        pinned = self.device.type == "cuda"
        self._host = {name: torch.zeros(shape, dtype=dtype, pin_memory=pinned)
                      for name, shape, dtype in inputs}
        self._dev = {name: torch.zeros(shape, dtype=dtype, device=self.device)
                     for name, shape, dtype in inputs}
        self._programs: Dict[tuple, TickProgram] = {}
        self._make_program: Callable[[Callable], TickProgram] = TickProgram
        self._staged: Optional[Any] = None
        self._warmed = False
        if self.device.type == "cuda":
            # The engine's graphs share one memory pool: they never run at
            # once, and each writes what it returns into an engine buffer
            # allocated outside every capture.
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._make_program = self._capture
            # Marks when the last staging copies have read their pinned
            # host arrays (which the next staging then may rewrite).
            self._staged = torch.cuda.Event()

    def _stage(self, tokens=None, width: int = 0, **values) -> None:
        """Write a run's inputs into the host arrays and copy them into the
        static device buffers, in place: ``tokens`` right-padded with the
        pad id to ``width``, and each named scalar input.  The copies are
        ordered on the stream before the runs that read them, and the
        host arrays are rewritten only once the previous copies read
        them."""
        if self._staged is not None:
            self._staged.synchronize()
        if tokens is not None:
            host = self._host["tokens"][:, :width]
            host.fill_(self.tokenizer.pad_id)
            host[0, :len(tokens)] = torch.tensor(list(tokens),
                                                 dtype=host.dtype)
            self._dev["tokens"][:, :width].copy_(host, non_blocking=True)
        for name, value in values.items():
            self._host[name].fill_(value)
            self._dev[name].copy_(self._host[name], non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def _built(self, key, rung: int) -> TickProgram:
        """The program ``key`` on cache rung ``rung``, built (captured, on
        the card) at first use.  A capture that fails raises.

        Stage a run's inputs BEFORE building its program: a capture runs
        the body once first (``capture_program``), and that run writes
        the rung's cache from whatever is staged.  On the run's own
        inputs it writes what the first replay rewrites; the static
        inputs it advances (a decode segment's state, a round's token
        and position) are put back, so the replay starts where the
        staging left them."""
        prog = self._programs.get((key, rung))
        if prog is None:
            self._note_compile(key, rung)
            staged = {name: x.clone() for name, x in self._dev.items()}
            prog = self._make_program(self._body(key, rung))
            for name, x in staged.items():
                self._dev[name].copy_(x)
            self._programs[(key, rung)] = prog
        return prog

    def _pick_cache_len(self, needed: int) -> int:
        """Smallest cache-length rung (``self._cache_lens``) covering
        ``needed`` positions, capped at ``self._max_seq``."""
        return next(c for c in self._cache_lens
                    if c >= min(needed, self._max_seq))

    def _body(self, key, rung: int) -> Callable[[], Any]:
        raise NotImplementedError

    def _note_compile(self, key, rung: int) -> None:
        """Log a NEW program: warmup's captures must be visible, and one
        mid-serve stalls the request that meets it."""
        logger.info("tier %s: capturing program %r on rung %d (%d so far%s)",
                    self.tier.name, key, rung, len(self._programs) + 1,
                    ", after warmup" if self._warmed else "")

    def _capture(self, body: Callable[[], Any]) -> TickProgram:
        """``body`` as a CUDA graph on the engine's capture stream and pool,
        the engine's generators registered (``capture_program``)."""
        return capture_program(body, self.device, self._capture_stream,
                               self._graph_pool, self._generators)

    def program_shapes(self) -> Dict[Any, set]:
        """Every built program's key -> the cache rungs it was built on."""
        out: Dict[Any, set] = {}
        for key, rung in self._programs:
            out.setdefault(key, set()).add(rung)
        return out
