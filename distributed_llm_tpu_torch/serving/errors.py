"""The reference error-dict shape, ``{"error": "<message>"}``.

The port's own copy of ``distributed_llm_tpu/serving/errors.py``: every
failure a client sees carries exactly the ``error`` key, plus the one
sanctioned numeric extension ``retry_after_s``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

ERROR_KEY = "error"

# Every key an error dict may carry, and the keys with a numeric
# contract: the ``error-shape`` lint rule holds every literal to them.
ALLOWED_KEYS = frozenset({ERROR_KEY, "retry_after_s"})
NUMERIC_KEYS = frozenset({"retry_after_s"})


def error_dict(message: str,
               retry_after_s: Optional[float] = None) -> Dict[str, Any]:
    """Construct a conforming error dict."""
    out: Dict[str, Any] = {ERROR_KEY: message}
    if retry_after_s is not None:
        out["retry_after_s"] = round(float(retry_after_s), 2)
    return out


def is_error_shape(raw: Any) -> bool:
    """The router's error predicate: any dict carrying the error key."""
    return isinstance(raw, dict) and ERROR_KEY in raw
