"""The reference error-dict shape, ``{"error": "<message>"}``.

The port's own copy of ``distributed_llm_tpu/serving/errors.py``: every
failure a client sees carries exactly the ``error`` key, plus the one
sanctioned numeric extension ``retry_after_s``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

ERROR_KEY = "error"


def error_dict(message: str,
               retry_after_s: Optional[float] = None) -> Dict[str, Any]:
    """Construct a conforming error dict."""
    out: Dict[str, Any] = {ERROR_KEY: message}
    if retry_after_s is not None:
        out["retry_after_s"] = round(float(retry_after_s), 2)
    return out
