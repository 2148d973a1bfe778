"""Weight products for plain (unquantized) weights.

Counterpart of the plain-weight paths of ``distributed_llm_tpu/ops/
quant.py`` (``matmul``, ``embed_rows``, ``tied_head``).  The projections
and the LM head stay ``x @ w`` on ``torch.matmul``, as the JAX package
leaves them to XLA.  int8 weights come with a later slice.
"""

from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` stored [in, out]."""
    return x @ w


def embed_rows(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table row lookup: [V, H] table, integer tokens [...]."""
    return embed[tokens]


def tied_head(embed: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden @ embed.T`` (tied LM head), returned in float32."""
    return (hidden @ embed.T).float()
