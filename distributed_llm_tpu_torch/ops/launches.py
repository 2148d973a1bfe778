"""Launch counts of the hand-written kernels.

Every kernel's wrapper adds one to its ``.launches`` where it launches
its kernel, and nowhere else.  A CUDA graph runs the wrapper's Python
once, at capture, and the kernel at every replay; so a replayed program
(``engine/batching.TickProgram``) records what its capture added
(``since``), takes it back (a capture launches nothing) and adds it again
at every replay (``add``).  The counts then keep meaning kernels run on
the card.
"""

from __future__ import annotations

from typing import Callable, Dict


def wrappers() -> Dict[str, Callable]:
    """Every kernel's wrapper, by the kernel's name (its source's stem)."""
    from . import flash_attention as TF
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
            "flash_chunk_q8": TF.flash_chunk_attention_q8}


def counts() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {name: fn.launches for name, fn in wrappers().items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted after ``before`` (a ``counts()``), by name,
    kernels that did not launch left out."""
    now = counts()
    return {name: now[name] - n for name, n in before.items()
            if now[name] != n}


def add(deltas: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``deltas`` to the kernels' launch counts."""
    fns = wrappers()
    for name, n in deltas.items():
        fns[name].launches += times * n
