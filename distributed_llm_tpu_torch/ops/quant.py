"""Weight products for plain (unquantized) weights, and the int8 KV rows.

Counterpart of ``distributed_llm_tpu/ops/quant.py``'s plain-weight paths
(``matmul``, ``embed_rows``, ``tied_head``) and its KV-row quantizer
(``quantize_kv_rows``, ``dequantize_kv_rows``), and the in-place KV row
write both caches share (``put_kv_rows``).  The projections and the
LM head stay ``x @ w`` on ``torch.matmul``, as the JAX package leaves
them to XLA.  int8 weights come with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 over the trailing D axis: returns (int8
    values, float32 scales with the D axis dropped).  ``scale`` is
    amax / 127 where amax > 0, else 1; values round half to even and clip
    to +-127 (bit-identical to the JAX package's)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """``int8 * scale`` in float32, cast to ``dtype``."""
    return (q.float() * scale[..., None]).to(dtype)


def put_kv_rows(cache, layer, index, k: torch.Tensor,
                v: torch.Tensor) -> None:
    """Write K/V rows in place at ``cache[name][layer][index]`` (every
    layer when ``layer`` is None), quantizing them first when the cache
    (a paged pool or a contiguous cache) is int8, i.e. holds the
    ``"ks"``/``"vs"`` scale planes."""
    def at(name):
        return cache[name] if layer is None else cache[name][layer]

    if "ks" in cache:
        k, k_sc = quantize_kv_rows(k)
        v, v_sc = quantize_kv_rows(v)
        at("ks")[index] = k_sc
        at("vs")[index] = v_sc
    at("k")[index] = k
    at("v")[index] = v


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` stored [in, out]."""
    return x @ w


def embed_rows(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table row lookup: [V, H] table, integer tokens [...]."""
    return embed[tokens]


def tied_head(embed: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden @ embed.T`` (tied LM head), returned in float32."""
    return (hidden @ embed.T).float()
