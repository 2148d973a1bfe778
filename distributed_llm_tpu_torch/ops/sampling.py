"""Token sampling with a per-request (runtime) temperature.

Counterpart of ``distributed_llm_tpu/ops/sampling.py``'s
``sample_token_dynamic``: every engine's sampler, per slot in a batched
tick and from a static temperature in a sequential engine's programs.
temperature <= 0 is greedy (argmax); above 0 a token is drawn from the
softmax of ``logits / temperature`` by the Gumbel-max rule (what
``jax.random.categorical`` does) from a ``torch.Generator``.  The two
packages draw different numbers from the same seed, so only the greedy
path is compared token for token.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_batched(logits: torch.Tensor, temps: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-row temperature: logits [B, V], temps [B] -> tokens [B];
    greedy where temp <= 0, else a Gumbel-max draw.  ``generator=None``
    means every row is greedy and draws nothing."""
    greedy = logits.argmax(dim=-1)
    if generator is None:
        return greedy
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    scaled = logits.float() / temps.clamp(min=1e-6)[:, None]
    sampled = (scaled + gumbel).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy)
