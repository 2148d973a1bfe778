"""Launch counts of the hand-written kernels.

Every kernel's wrapper adds one to its ``.launches`` where it launches
its kernel, and nowhere else.  A CUDA graph runs the wrapper's Python
once, at capture, and the kernel at every replay; so a replayed program
(``engine/programs.TickProgram``) records what its capture added
(``since``), takes it back (a capture launches nothing) and adds it again
at every replay (``add``).  The counts then keep meaning kernels run on
the card.  The plain attention paths count their calls (``.calls``) the
same way (``call_counts``, ``add_calls``): on the card only the int8
suffix chunk, which has no kernel, runs inside a program.  So do the
bf16 chunk kernel's launches by route (``route_counts``, ``add_routes``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


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
    """Every plain attention path that counts its calls, by its name: the
    kernels' plain versions and the int8 suffix chunk."""
    from . import attention as TA
    return {fn.__name__: fn for fn in (
        TA.causal_attention, TA._gather_decode_paged,
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
    """The bf16 chunk kernel's (K11's) launches by route."""
    from . import flash_attention as TF
    return dict(TF.flash_chunk_attention.route_launches)


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
    """Add ``times`` x ``deltas`` to the bf16 chunk kernel's route counts."""
    from . import flash_attention as TF
    for route, n in deltas.items():
        TF.flash_chunk_attention.route_launches[route] += times * n
