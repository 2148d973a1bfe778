"""Held-out answer-quality evaluation of a tier's weights.

Counterpart of ``distributed_llm_tpu/training/evaluate.py``: per-token
cross-entropy, perplexity and next-token top-1 accuracy on a held-out
stream of the training mix (``training/data.batches`` from
``HELDOUT_SEED``, far from every training seed), the same token stream
for every tier, so the numbers compare.  On the card by default.

Run:  python -m distributed_llm_tpu_torch.training.evaluate \\
          --preset nano_test --checkpoint checkpoints/nano_test [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MODEL_PRESETS, ModelConfig
from ..device import DeviceLike, resolve_device

HELDOUT_SEED = 773_001  # disjoint from training seeds (pretrain uses ~0-10)


def heldout_batches(batch_size: int, seq_len: int, tokenizer,
                    seed: int = HELDOUT_SEED
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """The training mix (chat + sentence pseudo-text) from a held-out
    seed."""
    from .data import batches
    return batches(batch_size, seq_len, seed=seed, tokenizer=tokenizer)


@torch.no_grad()
def _eval_batch(cfg: ModelConfig, model, tokens: torch.Tensor,
                loss_mask: torch.Tensor) -> Tuple[float, float]:
    """(loss, top-1 next-token accuracy) over one batch."""
    from .. import models
    from ..models import transformer
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    hidden = models.serving_prefill(cfg, model, tokens, positions)[0]
    logits = transformer.logits_from_hidden(model, hidden[:, :-1])
    targets = tokens[:, 1:]
    mask = loss_mask[:, 1:].float()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    acc = torch.sum((logp.argmax(-1) == targets) * mask) / denom
    return float(loss), float(acc)


def eval_quality(cfg: ModelConfig, model, *, n_batches: int = 4,
                 batch_size: int = 8, seq_len: Optional[int] = None,
                 seed: int = HELDOUT_SEED) -> Dict[str, float]:
    """Mean held-out per-token loss, perplexity and next-token accuracy of
    ``model`` (a ``Transformer`` of ``cfg``, on its device).
    Deterministic in (cfg, weights, seed)."""
    from ..engine.tokenizer import get_tokenizer
    seq = seq_len or min(256, cfg.max_seq_len)
    device = model.final_ln.device
    data = heldout_batches(batch_size, seq, get_tokenizer(cfg), seed=seed)
    losses, accs = [], []
    for _, (toks, mask) in zip(range(n_batches), data):
        loss, acc = _eval_batch(
            cfg, model, torch.as_tensor(toks, dtype=torch.long, device=device),
            torch.as_tensor(mask, device=device))
        losses.append(loss)
        accs.append(acc)
    mean_loss = float(np.mean(losses))
    return {
        "eval_loss": round(mean_loss, 4),
        "perplexity": round(float(np.exp(mean_loss)), 3),
        "next_token_acc": round(float(np.mean(accs)), 4),
        "n_tokens": n_batches * batch_size * (seq - 1),
    }


def eval_checkpoint(preset: str, checkpoint_path: str,
                    device: DeviceLike = None, **kw) -> Dict[str, float]:
    """Load a serving checkpoint's weights (what ``TierConfig.
    checkpoint_path`` serves) onto ``device`` and score them."""
    from ..models.checkpoint import load_params_for_tier
    cfg = MODEL_PRESETS[preset]
    model = load_params_for_tier(checkpoint_path, cfg,
                                 device=resolve_device(device))
    return eval_quality(cfg, model, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", required=True, choices=sorted(MODEL_PRESETS))
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cpu runs on the host (default: the card)")
    args = ap.parse_args(argv)
    out = eval_checkpoint(args.preset, args.checkpoint, device=args.device,
                          n_batches=args.batches,
                          batch_size=args.batch_size, seq_len=args.seq_len)
    print(json.dumps({"preset": args.preset, **out}))


if __name__ == "__main__":
    main()
