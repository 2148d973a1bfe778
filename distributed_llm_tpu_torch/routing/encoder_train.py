"""Contrastive training for the semantic encoder (routing/encoder.py).

Counterpart of ``distributed_llm_tpu/routing/encoder_train.py``, on the
card by default.  In-batch-negative NT-Xent: a batch of (anchor,
positive) paraphrase pairs is encoded by the "meaning" head into unit
vectors A, P; logits = A·Pᵀ/τ and the target is the diagonal, every other
pair in the batch a negative, symmetrized.  Beside it, weighted by
``class_weight``, a centroid-classification loss on the label texts
(``routing/semantic_labels.json``) trains the "class" head, a linear
probe on the pooled trunk.

The optimizer is the JAX package's ``optax.adamw`` on
``optax.warmup_cosine_decay_schedule(0, lr, steps // 10, steps)``:
``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 outside the
square root, bias correction by the step count and weight decay 1e-4
scaled by the scheduled rate, the rate set before each step to the
schedule at the number of updates made so far (``lr_at``; the first
update's rate is 0.0, as optax's).  Batches are
``np.random.default_rng(seed).choice(n, batch, replace=False)`` draws,
the JAX package's, so both packages train on the same batches from the
same ``init_encoder_params``.  The artifact is the same fp16 ``.npz``.

Evaluation is held-out template GROUPS (meanings never trained) against
unrelated cross-group pairs: the positive/negative score separation the
cache threshold rides on, for the artifact and the hashed embedder.

Run:  python -m distributed_llm_tpu_torch.routing.encoder_train \\
          --out build/encoder_weights.npz [--device cpu]
(~1.3M parameters; the committed artifact is written only when --out
names it.)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .encoder import MAX_TOKENS, encode_fn, init_encoder_params
from .encoder_data import contrastive_pairs, unrelated_pairs

_LABELS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "semantic_labels.json")


def _token_rows(texts) -> Tuple[np.ndarray, np.ndarray]:
    from ..engine.bpe import load_default
    tok = load_default()
    ids = np.zeros((len(texts), MAX_TOKENS), np.int64)
    mask = np.zeros((len(texts), MAX_TOKENS), np.float32)
    for r, text in enumerate(texts):
        enc = tok.encode(text.lower())[:MAX_TOKENS]
        ids[r, :len(enc)] = enc
        mask[r, :len(enc)] = 1.0
    return ids, mask


def _tokenize_pairs(pairs: List[Tuple[str, str]]):
    a_ids, a_mask = _token_rows([p[0] for p in pairs])
    b_ids, b_mask = _token_rows([p[1] for p in pairs])
    return a_ids, a_mask, b_ids, b_mask


def _tokenize_labels():
    """The label texts and their classes (nano=0, orin=1): the
    centroid-classification batch."""
    with open(_LABELS) as f:
        rows = json.load(f)
    ids, mask = _token_rows([row["text"] for row in rows])
    y = np.asarray([1 if row["label"] == "orin" else 0 for row in rows],
                   np.int64)
    return ids, mask, y


def lr_at(count: int, lr: float, warmup: int, steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)`` at
    ``count`` updates made: linear from 0 over ``warmup``, then a cosine
    to 0 over the remaining ``steps - warmup``."""
    if count < warmup:
        return lr * count / warmup
    t = min(count - warmup, steps - warmup)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / (steps - warmup)))


def loss_fn(p: Dict[str, torch.Tensor], ai, am, bi, bm, li, lm, ly,
            temperature: float, class_weight: float) -> torch.Tensor:
    """NT-Xent on the meaning head plus ``class_weight`` x the class
    head's centroid cross-entropy."""
    za = encode_fn(p, ai, am, head="meaning")     # [B, d] unit
    zb = encode_fn(p, bi, bm, head="meaning")
    logits = za @ zb.T / temperature              # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    l1 = F.cross_entropy(logits, labels, reduction="none")
    l2 = F.cross_entropy(logits.T, labels, reduction="none")
    ntxent = torch.mean(l1 + l2) / 2.0
    zl = encode_fn(p, li, lm, head="class")       # [L, d] unit
    w_orin = ly.float()
    w_nano = 1.0 - w_orin
    cn = (zl * w_nano[:, None]).sum(0) / torch.clamp(w_nano.sum(), min=1.0)
    co = (zl * w_orin[:, None]).sum(0) / torch.clamp(w_orin.sum(), min=1.0)
    cn = cn / torch.clamp(torch.linalg.vector_norm(cn), min=1e-9)
    co = co / torch.clamp(torch.linalg.vector_norm(co), min=1e-9)
    cls_logits = torch.stack([zl @ cn, zl @ co], dim=1) / 0.1
    cls = F.cross_entropy(cls_logits, ly)
    return ntxent + class_weight * cls


def fit(params: Dict[str, np.ndarray], pairs: List[Tuple[str, str]], *,
        steps: int, batch_size: int, lr: float, temperature: float,
        class_weight: float, seed: int, device: DeviceLike = None,
        log: Callable[[str], None] = print
        ) -> Tuple[Dict[str, np.ndarray], List[float]]:
    """``steps`` AdamW updates of ``params`` (numpy, float32) on
    ``pairs``: the trained parameters (numpy) and each step's loss."""
    dev = resolve_device(device)
    a_ids, a_mask, b_ids, b_mask = _tokenize_pairs(pairs)
    labels = [torch.from_numpy(x).to(dev) for x in _tokenize_labels()]
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
         .requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.AdamW(list(p.values()), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    warmup = max(steps // 10, 1)
    rng = np.random.default_rng(seed)
    n = len(pairs)
    losses: List[float] = []
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        idx = rng.choice(n, size=min(batch_size, n), replace=False)
        batch = [torch.from_numpy(x[idx]).to(dev)
                 for x in (a_ids, a_mask, b_ids, b_mask)]
        loss = loss_fn(p, *batch, *labels, temperature, class_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr_at(i - 1, lr, warmup, steps)
        opt.step()
        losses.append(float(loss.detach()))
        if i % 50 == 0 or i == 1:
            log(f"[encoder] step {i}/{steps} loss={losses[-1]:.4f} "
                f"({i / (time.perf_counter() - t0):.1f} steps/s)")
    return {k: v.detach().cpu().numpy() for k, v in p.items()}, losses


def train(out: str, *, steps: int = 600, batch_size: int = 64,
          lr: float = 3e-3, temperature: float = 0.08,
          class_weight: float = 0.3, seed: int = 0,
          device: DeviceLike = None, log=print) -> Dict[str, float]:
    """Train from ``init_encoder_params(seed=seed)``, write the fp16
    artifact to ``out`` and evaluate it (``evaluate``)."""
    pairs = contrastive_pairs("train", seed=seed)
    log(f"[encoder] {len(pairs)} training pairs")
    params, losses = fit(init_encoder_params(seed=seed), pairs, steps=steps,
                         batch_size=batch_size, lr=lr,
                         temperature=temperature, class_weight=class_weight,
                         seed=seed, device=device, log=log)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # fp16 artifact: half the bytes, fp32-restored at load.
    np.savez_compressed(out, **{k: np.asarray(v, np.float16)
                                for k, v in params.items()})
    log(f"[encoder] saved {out}")
    metrics = evaluate(out, device=device, log=log)
    metrics["final_train_loss"] = round(losses[-1], 4)
    return metrics


def evaluate(weights_path: str, device: DeviceLike = None,
             log=print) -> Dict[str, float]:
    """Held-out paraphrase vs unrelated separation for an artifact and for
    the hashed embedder (the gap the encoder exists to close)."""
    from .embedder import HashedNgramEmbedder
    from .encoder import TrainedEncoder

    held = contrastive_pairs("heldout", seed=123)
    unrel = unrelated_pairs(n=min(300, 4 * len(held)), seed=123)

    def sims(embedder, pairs):
        za = embedder.encode([p[0] for p in pairs])
        zb = embedder.encode([p[1] for p in pairs])
        za = za / np.maximum(np.linalg.norm(za, axis=1, keepdims=True), 1e-9)
        zb = zb / np.maximum(np.linalg.norm(zb, axis=1, keepdims=True), 1e-9)
        return np.sum(za * zb, axis=1)

    out: Dict[str, float] = {"heldout_pairs": len(held),
                             "unrelated_pairs": len(unrel)}
    for name, emb in (("encoder", TrainedEncoder(weights_path, device)),
                      ("hashed", HashedNgramEmbedder(device=device))):
        pos, neg = sims(emb, held), sims(emb, unrel)
        # The threshold that best separates positives from negatives,
        # and each side's error at that threshold.
        grid = np.linspace(0.0, 1.0, 201)
        acc = [(np.mean(pos >= t) + np.mean(neg < t)) / 2.0 for t in grid]
        best = int(np.argmax(acc))
        out.update({
            f"{name}_pos_mean": round(float(np.mean(pos)), 4),
            f"{name}_neg_mean": round(float(np.mean(neg)), 4),
            f"{name}_sep_acc": round(float(acc[best]), 4),
            f"{name}_best_threshold": round(float(grid[best]), 3),
            f"{name}_pos_p10": round(float(np.percentile(pos, 10)), 4),
            f"{name}_neg_p90": round(float(np.percentile(neg, 90)), 4),
        })
        log(f"[encoder] {name}: pos={out[f'{name}_pos_mean']} "
            f"neg={out[f'{name}_neg_mean']} "
            f"sep_acc={out[f'{name}_sep_acc']} "
            f"@thr={out[f'{name}_best_threshold']}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="npz path (default: the committed artifact)")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--temperature", type=float, default=0.08)
    ap.add_argument("--class-weight", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu runs on the host (default: the card)")
    args = ap.parse_args(argv)
    from .encoder import _DEFAULT_WEIGHTS
    out = args.out or _DEFAULT_WEIGHTS
    if args.eval_only:
        print(json.dumps(evaluate(out, device=args.device)))
        return
    metrics = train(out, steps=args.steps, batch_size=args.batch_size,
                    lr=args.lr, temperature=args.temperature,
                    class_weight=args.class_weight, seed=args.seed,
                    device=args.device)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
