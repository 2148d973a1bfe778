"""Off-generator generalization eval for the embedding space.

Counterpart of ``distributed_llm_tpu/routing/encoder_eval.py``, on the
card by default.  The encoder's separation on held-out groups
(``encoder_train.evaluate``) comes from the SAME template generator that
produced its training data (routing/encoder_data.py), so it proves
generalization across slot-fillings and held-out wordings only.  The
reference's MiniLM (src/query_router_engine.py:122-131) generalizes to
arbitrary phrasing; this module measures how far the shipped space does,
on the hand-written ``offgen_pairs.json`` suite (the port's own copy):
~50 paraphrase pairs and ~50 unrelated pairs in foreign domains, sentence
shapes and registers, shared-surface-word hard negatives included.

Reported per embedder (hashed / trained encoder / hybrid): positive and
negative cosine means, ROC-AUC (threshold-free ranking quality), the
best-threshold separation accuracy (the encoder_train.evaluate metric),
and hit/false-hit rates at the SHIPPED cache threshold.

Run:  python -m distributed_llm_tpu_torch.routing.encoder_eval \\
          [--out offgen_eval.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..device import DeviceLike

PAIRS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "offgen_pairs.json")


def load_pairs(path: str = PAIRS_PATH
               ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    with open(path) as f:
        data = json.load(f)
    return ([tuple(p) for p in data["paraphrase"]],
            [tuple(p) for p in data["unrelated"]])


def _pair_sims(embedder, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
    za = np.array(embedder.encode([p[0] for p in pairs]), np.float32)
    zb = np.array(embedder.encode([p[1] for p in pairs]), np.float32)
    za /= np.maximum(np.linalg.norm(za, axis=1, keepdims=True), 1e-9)
    zb /= np.maximum(np.linalg.norm(zb, axis=1, keepdims=True), 1e-9)
    return np.sum(za * zb, axis=1)


def _auc(pos: np.ndarray, neg: np.ndarray) -> float:
    """P(random positive scores above random negative); ties count half."""
    greater = (pos[:, None] > neg[None, :]).mean()
    ties = (pos[:, None] == neg[None, :]).mean()
    return float(greater + 0.5 * ties)


def score_embedder(embedder, pos_pairs, neg_pairs,
                   cache_threshold: float) -> Dict[str, float]:
    pos, neg = _pair_sims(embedder, pos_pairs), _pair_sims(embedder, neg_pairs)
    grid = np.linspace(0.0, 1.0, 201)
    acc = [(float(np.mean(pos >= t)) + float(np.mean(neg < t))) / 2.0
           for t in grid]
    best = int(np.argmax(acc))
    return {
        "pos_mean": round(float(np.mean(pos)), 4),
        "pos_p10": round(float(np.percentile(pos, 10)), 4),
        "neg_mean": round(float(np.mean(neg)), 4),
        "neg_p90": round(float(np.percentile(neg, 90)), 4),
        "auc": round(_auc(pos, neg), 4),
        "sep_acc": round(float(acc[best]), 4),
        "best_threshold": round(float(grid[best]), 3),
        # At the threshold production actually ships with:
        "cache_threshold": cache_threshold,
        "hit_rate_paraphrase": round(float(np.mean(pos >= cache_threshold)), 4),
        "false_hit_rate_unrelated": round(
            float(np.mean(neg >= cache_threshold)), 4),
    }


def run_eval(device: DeviceLike = None) -> Dict[str, Dict[str, float]]:
    from ..config import DEFAULT_CACHE_SIMILARITY, HYBRID_CACHE_SIMILARITY
    from .embedder import HybridEmbedder, default_embedder
    from .encoder import default_trained_encoder

    pos_pairs, neg_pairs = load_pairs()
    out: Dict[str, Dict[str, float]] = {
        "suite": {"paraphrase_pairs": len(pos_pairs),
                  "unrelated_pairs": len(neg_pairs),
                  "source": "hand-written off-generator pairs "
                            "(routing/offgen_pairs.json)"},
        "hashed": score_embedder(default_embedder(device), pos_pairs,
                                 neg_pairs, DEFAULT_CACHE_SIMILARITY),
    }
    enc = default_trained_encoder(device)
    if enc is not None:
        out["encoder"] = score_embedder(enc, pos_pairs, neg_pairs,
                                        HYBRID_CACHE_SIMILARITY)
        out["hybrid"] = score_embedder(HybridEmbedder(enc), pos_pairs,
                                       neg_pairs, HYBRID_CACHE_SIMILARITY)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here (else stdout only)")
    ap.add_argument("--device", default=None,
                    help="cpu runs on the host (default: the card)")
    args = ap.parse_args(argv)
    res = run_eval(args.device)
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
