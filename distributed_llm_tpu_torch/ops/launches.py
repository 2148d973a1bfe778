"""Launch counts of the hand-written kernels.

Every kernel's wrapper adds one to its ``.launches`` where it launches
its kernel, and nowhere else.  A CUDA graph runs the wrapper's Python
once, at capture, and the kernel at every replay; so a replayed program
(``engine/programs.TickProgram``) records what its capture added
(``since``), takes it back (a capture launches nothing) and adds it again
at every replay (``add``).  The counts then keep meaning kernels run on
the card.  The plain paths (attention, and W1's cast route) count their
calls (``.calls``) the same way (``call_counts``, ``add_calls``): on the
card only the int8 suffix chunk, which has no kernel, runs inside a
program.  So do the bf16 chunk kernel's launches by route and W1's by
regime (``route_counts``, ``add_routes``).
A tensor-parallel step runs each head shard's work inside
``on_shard(s)``, which also tallies the launches made there under shard
``s`` (``shard_counts``; a program's replays add them again,
``add_shards``), so a group's launches read per shard.  ``s`` is the
slot's index in its group; an ``on_shard`` inside another (a MoE
expert slice's slot inside its tensor shard's FFN) tallies what it
launched under its own index only.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

# Launches made inside ``on_shard``, by shard index and kernel name.
_SHARD_LAUNCHES: Dict[int, Dict[str, int]] = {}
# Per open ``on_shard``, innermost last: what the ones inside it tallied.
_OPEN: List[Dict[str, int]] = []


def wrappers() -> Dict[str, Callable]:
    """Every kernel's wrapper, by the kernel's name (its source's stem)."""
    from . import flash_attention as TF
    from . import quant as TQ
    from . import ragged_attention as TR
    return {"ragged_decode": TR.ragged_paged_decode_attention,
            "flash_causal": TF.flash_causal_attention,
            "paged_chunk": TF.paged_chunk_attention,
            "paged_decode": TF.paged_decode_attention,
            "paged_decode_q8": TF.paged_decode_attention_q8,
            "ragged_verify": TR.ragged_paged_verify_attention,
            "ragged_decode_q8": TR.ragged_paged_decode_attention_q8,
            "ragged_verify_q8": TR.ragged_paged_verify_attention_q8,
            "flash_decode": TF.flash_decode_attention,
            "flash_decode_q8": TF.flash_decode_attention_q8,
            "flash_chunk": TF.flash_chunk_attention,
            "flash_chunk_q8": TF.flash_chunk_attention_q8,
            "w8_matmul": TQ.w8_matmul}


def plain_paths() -> Dict[str, Callable]:
    """Every plain path that counts its calls, by its name: the attention
    kernels' plain versions, the int8 suffix chunk and W1's cast route
    (``quant._matmul_plain`` on a CUDA tensor)."""
    from . import attention as TA
    from . import quant as TQ
    return {fn.__name__: fn for fn in (
        TQ._matmul_plain, TA.causal_attention, TA._gather_decode_paged,
        TA._gather_decode_windowed, TA._gather_verify_paged,
        TA._gather_chunk_paged, TA._dequant_chunk_paged,
        TA._decode_contiguous, TA._decode_contiguous_q8,
        TA._chunk_contiguous, TA._chunk_contiguous_q8)}


def counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {name: fn.launches for name, fn in wrappers().items()}


def call_counts() -> Dict[str, int]:
    """Every plain attention path's call count, by name."""
    return {name: fn.calls for name, fn in plain_paths().items()}


def route_counts() -> Dict[str, int]:
    """The bf16 chunk kernel's (K11's) launches by route ("split", "tc")
    and W1's by regime ("w8_decode", "w8_wide")."""
    from . import flash_attention as TF
    from . import quant as TQ
    return {**TF.flash_chunk_attention.route_launches,
            **{f"w8_{r}": n for r, n in TQ.w8_matmul.route_launches.items()}}


def since(before: Dict[str, int],
          now: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """What was counted after ``before`` (a ``counts()``, or with ``now``
    a ``call_counts()`` or ``route_counts()``), by name, names that did
    not move left out."""
    now = counts() if now is None else now
    return {name: now[name] - n for name, n in before.items()
            if now[name] != n}


def add(deltas: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``deltas`` to the kernels' launch counts."""
    fns = wrappers()
    for name, n in deltas.items():
        fns[name].launches += times * n


def add_calls(deltas: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``deltas`` to the plain paths' call counts."""
    fns = plain_paths()
    for name, n in deltas.items():
        fns[name].calls += times * n


def add_routes(deltas: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``deltas`` to the route counts (``route_counts``)."""
    from . import flash_attention as TF
    from . import quant as TQ
    for route, n in deltas.items():
        if route.startswith("w8_"):
            TQ.w8_matmul.route_launches[route[3:]] += times * n
        else:
            TF.flash_chunk_attention.route_launches[route] += times * n


@contextlib.contextmanager
def on_shard(index: int):
    """Tally the launches made inside under shard ``index``, less what
    an ``on_shard`` nested in it tallied."""
    before = counts()
    _OPEN.append({})
    try:
        yield
    finally:
        inner = _OPEN.pop()
        made = since(before)
        tally = _SHARD_LAUNCHES.setdefault(index, {})
        for name, n in made.items():
            if n - inner.get(name, 0):
                tally[name] = tally.get(name, 0) + n - inner.get(name, 0)
            if _OPEN:
                _OPEN[-1][name] = _OPEN[-1].get(name, 0) + n


def shard_counts() -> Dict[int, Dict[str, int]]:
    """Launches by shard index, then kernel name (shards that launched)."""
    return {s: dict(t) for s, t in _SHARD_LAUNCHES.items()}


def shard_since(before: Dict[int, Dict[str, int]]
                ) -> Dict[int, Dict[str, int]]:
    """What each shard counted after ``before`` (a ``shard_counts()``)."""
    out = {}
    for s, tally in _SHARD_LAUNCHES.items():
        d = {name: n - before.get(s, {}).get(name, 0)
             for name, n in tally.items()
             if n != before.get(s, {}).get(name, 0)}
        if d:
            out[s] = d
    return out


def add_shards(deltas: Dict[int, Dict[str, int]], times: int = 1) -> None:
    """Add ``times`` x ``deltas`` to the per-shard tallies."""
    for s, d in deltas.items():
        tally = _SHARD_LAUNCHES.setdefault(s, {})
        for name, n in d.items():
            tally[name] = tally.get(name, 0) + times * n


def reset_shards() -> None:
    """Every shard's tally back to nothing."""
    _SHARD_LAUNCHES.clear()
