"""Trained semantic text encoder: inference on the router's device.

Counterpart of ``distributed_llm_tpu/routing/encoder.py``'s
``TrainedEncoder``, reading the port's own copy of the trained weights
(``routing/encoder_weights.npz``).  The model: embed(4096, 128) plus
learned positions (64), two pre-LN bidirectional blocks (4-head
attention with padding masked, a tanh-approximated GELU MLP x4), a final
LayerNorm, mean-pooling over the real tokens and one of two dense
projection heads, L2-normalized: "meaning" (the serving space, inside
the hybrid embedder) and "class" (a probe on the pooled trunk, which
the class loss trains without reaching the trunk).  The forward is plain
PyTorch in float32; LayerNorm uses the population variance, as
``jnp.var`` does.  ``init_encoder_params`` is the JAX package's seeded
numpy initialization; training is ``routing/encoder_train.py``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

ENCODER_DIM = 128
MAX_TOKENS = 64
WEIGHTS_BASENAME = "encoder_weights.npz"
_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                WEIGHTS_BASENAME)

N_LAYERS = 2
N_HEADS = 4
MLP_MULT = 4


def init_encoder_params(vocab_size: int = 4096, dim: int = ENCODER_DIM,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded float32 numpy parameters, drawn as the JAX package's
    ``init_encoder_params`` draws them (the same dict for a seed)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params: Dict[str, np.ndarray] = {
        "embed": normal(vocab_size, dim),
        "pos": normal(MAX_TOKENS, dim),
        "out_w": normal(dim, dim),       # meaning head (cache space)
        "out_b": np.zeros(dim, np.float32),
        "cls_w": normal(dim, dim),       # class head (strategy space)
        "cls_b": np.zeros(dim, np.float32),
        "final_ln": np.ones(dim, np.float32),
    }
    for i in range(N_LAYERS):
        params.update({
            f"l{i}_ln1": np.ones(dim, np.float32),
            f"l{i}_wq": normal(dim, dim), f"l{i}_wk": normal(dim, dim),
            f"l{i}_wv": normal(dim, dim), f"l{i}_wo": normal(dim, dim),
            f"l{i}_ln2": np.ones(dim, np.float32),
            f"l{i}_w1": normal(dim, MLP_MULT * dim),
            f"l{i}_b1": np.zeros(MLP_MULT * dim, np.float32),
            f"l{i}_w2": normal(MLP_MULT * dim, dim),
            f"l{i}_b2": np.zeros(dim, np.float32),
        })
    return params


def encode_fn(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              mask: torch.Tensor, head: str = "meaning") -> torch.Tensor:
    """tokens [B, T] int64, mask [B, T] float32 -> [B, dim] unit vectors
    from the requested projection head."""

    def ln(x, g):
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * g

    b, t = tokens.shape
    dim = params["embed"].shape[1]
    hd = dim // N_HEADS
    x = params["embed"][tokens] + params["pos"][None, :t]
    attn_bias = (1.0 - mask)[:, None, None, :] * -1e9              # [B,1,1,T]
    for i in range(N_LAYERS):
        h = ln(x, params[f"l{i}_ln1"])
        q = (h @ params[f"l{i}_wq"]).reshape(b, t, N_HEADS, hd)
        k = (h @ params[f"l{i}_wk"]).reshape(b, t, N_HEADS, hd)
        v = (h @ params[f"l{i}_wv"]).reshape(b, t, N_HEADS, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        probs = torch.softmax(scores + attn_bias, dim=-1)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, dim)
        x = x + att @ params[f"l{i}_wo"]
        h = ln(x, params[f"l{i}_ln2"])
        x = x + (F.gelu(h @ params[f"l{i}_w1"] + params[f"l{i}_b1"],
                        approximate="tanh")
                 @ params[f"l{i}_w2"] + params[f"l{i}_b2"])
    x = ln(x, params["final_ln"])
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    pooled = (x * mask[..., None]).sum(dim=1) / denom
    if head == "class":
        # A linear probe: the class loss does not reach the trunk
        # (identity at inference).
        out = pooled.detach() @ params["cls_w"] + params["cls_b"]
    else:
        out = pooled @ params["out_w"] + params["out_b"]
    return out / torch.clamp(torch.linalg.vector_norm(out, dim=-1,
                                                      keepdim=True), min=1e-9)


class TrainedEncoder:
    """``encode(list[str], head="meaning") -> np.ndarray [n, dim]`` from
    the committed weights, run on ``device``."""

    def __init__(self, weights_path: str = _DEFAULT_WEIGHTS,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        data = np.load(weights_path)
        params = {k: np.asarray(data[k], np.float32) for k in data.files}
        # Single-head files: the class head is the meaning head.
        if "cls_w" not in params:
            params["cls_w"] = params["out_w"]
            params["cls_b"] = params["out_b"]
        self.dim = int(params["out_w"].shape[1])
        self.params = {k: torch.from_numpy(v).to(self.device)
                       for k, v in params.items()}
        from ..engine.bpe import load_default
        self._tok = load_default()

    def _tokens(self, texts: Sequence[str]):
        ids = np.zeros((len(texts), MAX_TOKENS), np.int64)
        mask = np.zeros((len(texts), MAX_TOKENS), np.float32)
        for r, text in enumerate(texts):
            enc = self._tok.encode(text.lower())[:MAX_TOKENS]
            ids[r, :len(enc)] = enc
            mask[r, :len(enc)] = 1.0
        return ids, mask

    @torch.no_grad()
    def encode(self, texts: Sequence[str],
               head: str = "meaning") -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        ids, mask = self._tokens(texts)
        out = encode_fn(self.params, torch.from_numpy(ids).to(self.device),
                        torch.from_numpy(mask).to(self.device), head=head)
        return out.cpu().numpy()


def encoder_available(weights_path: str = _DEFAULT_WEIGHTS) -> bool:
    return os.path.exists(weights_path)


_defaults: Dict[str, TrainedEncoder] = {}
_default_lock = threading.Lock()


def default_trained_encoder(device: DeviceLike = None
                            ) -> Optional[TrainedEncoder]:
    """Shared instance per device, or None without the weights file."""
    dev = resolve_device(device)
    with _default_lock:
        if str(dev) not in _defaults and encoder_available():
            _defaults[str(dev)] = TrainedEncoder(device=dev)
        return _defaults.get(str(dev))
