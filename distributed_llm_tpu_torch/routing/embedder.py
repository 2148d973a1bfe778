"""Self-contained text embedders for the semantic strategy and the
semantic routing cache.

Counterpart of ``distributed_llm_tpu/routing/embedder.py``.
``HashedNgramEmbedder`` builds a signed hashed bag of word 1/2-grams and
character trigrams on the host, projects it to 384 dims by a fixed seeded
Gaussian matrix and L2-normalizes it; the projection runs as one
``torch.matmul`` on the router's device.  The features come from the C++
featurizer (``native/featurizer.cc``, built at first use), as in the JAX
package; ``_features`` is its pure-Python twin, bit-identical, the plain
version the tests hold it against.  ``HybridEmbedder`` concatenates the
trained encoder's unit vector (routing/encoder.py) and the hashed one,
weighted so that a cosine of two hybrid vectors is alpha * cos_encoder +
(1 - alpha) * cos_hashed.  ``get_embedder`` selects one by the config's
``embedding_model``.
"""

from __future__ import annotations

import logging
import re
import threading
import zlib
from typing import Dict, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

_WORD_RE = re.compile(r"[a-z0-9']+")

FEATURE_DIM = 16384
EMBED_DIM = 384
_SEED = 20260729

# Function words carry little routing signal; down-weighting them pushes
# paraphrase pairs above the cache's calibrated similarity threshold.
_STOPWORDS = frozenset(
    "a an and are as at be but by can could did do does for from had has have "
    "he her his how i if in is it its may me my of on or our she should so "
    "that the their them they this to us was we were what when where which "
    "who why will with would you your".split())
_STOP_WEIGHT = 0.15
_BIGRAM_WEIGHT = 0.4
_TRIGRAM_WEIGHT = 0.15


def _hash(token: str) -> int:
    return zlib.crc32(token.encode("utf-8"))


def _features(text: str) -> np.ndarray:
    """Signed hashed bag of word 1/2-grams + char trigrams, content-weighted:
    the C++ featurizer's Python twin, bit-identical to it."""
    vec = np.zeros(FEATURE_DIM, dtype=np.float32)
    # Strip possessive/contraction suffixes so "what's" matches "what".
    words = [w[:-2] if w.endswith("'s") else w.replace("'", "")
             for w in _WORD_RE.findall(text.lower())]

    def bump(token: str, weight: float) -> None:
        # The sum in float64, rounded on store, as the C++ loop does it
        # (numpy 2 would add a Python float to a float32 in float32).
        h = _hash(token)
        sign = 1.0 if (h >> 16) & 1 else -1.0
        i = h % FEATURE_DIM
        vec[i] = float(vec[i]) + sign * weight

    for w in words:
        bump("u:" + w, _STOP_WEIGHT if w in _STOPWORDS else 1.0)
    for a, b in zip(words, words[1:]):
        w = _BIGRAM_WEIGHT
        if a in _STOPWORDS and b in _STOPWORDS:
            w *= _STOP_WEIGHT
        bump("b:" + a + "_" + b, w)
    squashed = "".join(w for w in words if w not in _STOPWORDS)
    for i in range(len(squashed) - 2):
        bump("c:" + squashed[i:i + 3], _TRIGRAM_WEIGHT)
    return vec


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


class HashedNgramEmbedder:
    """``encode(list[str]) -> np.ndarray [n, EMBED_DIM]`` (the surface of
    the reference's SentenceTransformer), projecting on ``device``."""

    def __init__(self, dim: int = EMBED_DIM, seed: int = _SEED,
                 device: DeviceLike = None):
        self.dim = dim
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # Fixed projection; scaled so projected norms are O(1).
        proj = rng.standard_normal((FEATURE_DIM, dim)).astype(np.float32)
        proj /= np.sqrt(dim)
        self._proj = torch.from_numpy(proj).to(self.device)

    def _project(self, feats: np.ndarray) -> np.ndarray:
        f = torch.from_numpy(feats).to(self.device)
        return l2_normalize(torch.matmul(f, self._proj)).cpu().numpy()

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        # Lowering here keeps Unicode case folding (which can map a
        # non-ASCII character into [a-z], e.g. the Kelvin sign) and NUL
        # handling the same for the C++ loop and its Python twin.
        from .. import native
        normalized = [t.lower().replace("\0", " ") for t in texts]
        return self._project(native.featurize_batch(normalized, FEATURE_DIM))


_defaults: Dict[str, HashedNgramEmbedder] = {}
_default_lock = threading.Lock()


def default_embedder(device: DeviceLike = None) -> HashedNgramEmbedder:
    """Shared instance per device (the projection matrix is 24 MB)."""
    dev = resolve_device(device)
    with _default_lock:
        if str(dev) not in _defaults:
            _defaults[str(dev)] = HashedNgramEmbedder(device=dev)
        return _defaults[str(dev)]


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na < 1e-9 or nb < 1e-9:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


class HybridEmbedder:
    """Lexical + semantic ensemble, the shipped embedding space: the
    trained encoder's unit vector scaled by sqrt(alpha) concatenated with
    the hashed-ngram unit vector scaled by sqrt(1 - alpha)."""

    ALPHA = 0.35

    def __init__(self, encoder, hashed: "HashedNgramEmbedder | None" = None,
                 alpha: float = ALPHA):
        self._encoder = encoder
        self._hashed = hashed or default_embedder(encoder.device)
        self._wa = float(np.sqrt(alpha))
        self._wb = float(np.sqrt(1.0 - alpha))
        self.dim = encoder.dim + self._hashed.dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        ze = np.array(self._encoder.encode([t.lower() for t in texts]))
        zh = np.array(self._hashed.encode(list(texts)))
        ze /= np.maximum(np.linalg.norm(ze, axis=1, keepdims=True), 1e-9)
        zh /= np.maximum(np.linalg.norm(zh, axis=1, keepdims=True), 1e-9)
        return np.concatenate([self._wa * ze, self._wb * zh],
                              axis=1).astype(np.float32)


def get_embedder(name: "str | None" = None, device: DeviceLike = None):
    """Config-selected embedder (``embedding_model``) on ``device``:
    "hybrid-lexsem-*" -> HybridEmbedder, "trained-encoder-*" -> the
    trained encoder (both fall back to hashed n-grams without the weights
    file), anything else -> the hashed n-gram embedder."""
    name = str(name) if name else ""
    if name.startswith(("hybrid-lexsem", "trained-encoder")):
        from .encoder import default_trained_encoder
        enc = default_trained_encoder(device)
        if enc is not None:
            if name.startswith("hybrid-lexsem"):
                return HybridEmbedder(enc)
            return enc
        logger.warning("embedding_model=%s but no encoder weights file: "
                       "falling back to hashed n-grams", name)
    return default_embedder(device)
