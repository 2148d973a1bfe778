"""Turn clipping for served replies.

The port's own copy of ``distributed_llm_tpu/serving/turns.py``.  The
tiers serve LMs trained on a raw ``role: content`` chat corpus, so a
generation may run on into further turns; the serving layer clips the
reply at the first role marker, on the sync path (``clip_turn``) and on
the token stream (``ClippedStream``, with a hold-back buffer).
"""

from __future__ import annotations

from typing import Iterator, Optional

_ROLES = ("user:", "assistant:", "system:")
# Longest text a marker can span, for the streaming hold-back.
HOLDBACK = max(len(r) for r in _ROLES) + 1          # +1 for the newline


def _marker_pos(text: str, at_line_start: bool = True) -> Optional[int]:
    """Position of the earliest role marker at a line start, or None.
    ``at_line_start`` says whether position 0 of ``text`` begins a line."""
    best: Optional[int] = None
    for role in _ROLES:
        start = 0
        while True:
            i = text.find(role, start)
            if i < 0:
                break
            if (i == 0 and at_line_start) or (i > 0 and text[i - 1] == "\n"):
                best = i if best is None else min(best, i)
                break
            start = i + 1
    return best


def clip_turn(text: str) -> str:
    """The reply's own turn: drop an echoed leading role label, cut at the
    next role marker.  A clip that would leave nothing returns the
    stripped original."""
    stripped = text.lstrip()
    for role in _ROLES:
        if stripped.startswith(role):
            stripped = stripped[len(role):].lstrip()
            break
    pos = _marker_pos(stripped)
    clipped = stripped[:pos] if pos is not None else stripped
    clipped = clipped.rstrip()
    return clipped if clipped else text.strip()


class ClippedStream:
    """Delta-stream wrapper applying ``clip_turn`` on the fly.

    Holds back the last ``HOLDBACK`` characters so a marker split across
    deltas is still caught.  After a marker the rest of the stream is
    drained silently (not closed), so the engine still finishes the
    request, fills ``result`` and parks its prefix."""

    def __init__(self, handle):
        self._handle = handle
        self._emitted_any = False

    def __iter__(self) -> Iterator[str]:
        buf = ""
        buf_line_start = True
        label_checked = False
        clipped = False
        for delta in self._handle:
            if clipped:
                continue
            buf += delta
            if not label_checked:
                probe = buf.lstrip()
                if (len(probe) < HOLDBACK
                        and any(r.startswith(probe) or probe.startswith(r)
                                for r in _ROLES)):
                    continue
                for role in _ROLES:
                    if probe.startswith(role):
                        buf = probe[len(role):].lstrip()
                        break
                label_checked = True
            pos = _marker_pos(buf, at_line_start=buf_line_start)
            if pos is not None:
                out = buf[:pos].rstrip()
                if out:
                    self._emitted_any = True
                    yield out
                buf = ""
                clipped = True
                continue
            if len(buf) > HOLDBACK:
                out, buf = buf[:-HOLDBACK], buf[-HOLDBACK:]
                buf_line_start = out.endswith("\n")
                if out:
                    self._emitted_any = True
                    yield out
        if not clipped:
            tail = buf.rstrip() if self._emitted_any else clip_turn(buf)
            if tail:
                self._emitted_any = True
                yield tail
        if not self._emitted_any:
            # A stream clipped from its first token mirrors clip_turn's
            # fallback: the stripped whole reply.
            result = getattr(self._handle, "result", None)
            fallback = (getattr(result, "text", "") or "").strip()
            if fallback:
                yield fallback

    @property
    def result(self):
        return getattr(self._handle, "result", None)
