"""The port's C++ host loops (``distributed_llm_tpu_torch/native/``)
against their Python twins and the JAX package's native library.

- The featurizer gives bit-identical features to the port's
  ``_features`` and to the JAX package's native ``featurize_batch`` on
  every query of the bench's query sets and on tricky text (Unicode case
  folds into ASCII, NUL bytes, accents), and ``HashedNgramEmbedder``
  goes through it.
- The BPE merge loop gives the Python loop's ids, and the JAX package's
  native ids, on the query sets and on random ASCII (a hypothesis
  property); ``encode`` routes long ASCII text to it and everything else
  (non-ASCII, short) to the Python loop, as the JAX package does.
- The library is built from the port's own sources into ``build/native``
  named by their digest; six processes that build at once all load one
  published library; a source the compiler refuses raises with its
  stderr, and nothing falls back.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_llm_tpu import native as jax_native
from distributed_llm_tpu.engine.bpe import load_default as jax_bpe
from distributed_llm_tpu_torch import native
from distributed_llm_tpu_torch.bench.query_sets import query_sets
from distributed_llm_tpu_torch.engine import bpe
from distributed_llm_tpu_torch.routing import embedder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "What is the capital of Japan?",
    "what's the CAPITAL of japan",
    "Debug this: my binary search returns the wrong index (off-by-one).",
    "",
    "    ",
    "it's the user's code, don't touch",
    "numbers 123 and ids a1b2c3 survive; émigré splits on accents",
    "temperature in Kelvin",            # folds into ASCII 'k'
]


def _query_texts():
    out = []
    for items in query_sets.values():
        for item in items:
            out.append(item["query"] if isinstance(item, dict) else item)
    return out


def _python_ids(tok, text):
    return [i for m in bpe._CHUNK_RE.finditer(text)
            for i in tok._encode_chunk(m.group())]


def test_library_is_built_from_the_ports_sources():
    path = native.library_path()
    native.load()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.isfile(path)
    assert all(os.path.dirname(s) == os.path.join(
        REPO, "distributed_llm_tpu_torch", "native") for s in native.SOURCES)
    # The port's copies keep the JAX package's code (the header aside).
    for name in ("featurizer.cc", "bpe_encoder.cc"):
        def body(root):
            text = open(os.path.join(root, name)).read()
            return text[text.index("#include"):]
        assert body(os.path.join(REPO, "distributed_llm_tpu_torch",
                                 "native")) == body(os.path.join(
                                     REPO, "distributed_llm_tpu", "native"))


@pytest.mark.parametrize("which", ["query_sets", "tricky"])
def test_features_bit_identical_to_python_and_jax(which):
    texts = _query_texts() if which == "query_sets" else TEXTS
    normalized = [t.lower().replace("\0", " ") for t in texts]
    got = native.featurize_batch(normalized, embedder.FEATURE_DIM)
    want = np.stack([embedder._features(t) for t in normalized])
    np.testing.assert_array_equal(got, want)
    assert jax_native.available()
    np.testing.assert_array_equal(
        got, jax_native.featurize_batch(normalized, embedder.FEATURE_DIM))


def test_embedder_encodes_through_the_native_featurizer(monkeypatch):
    calls = []
    real = native.featurize_batch
    monkeypatch.setattr(native, "featurize_batch",
                        lambda texts, dim: calls.append(len(texts))
                        or real(texts, dim))
    e = embedder.HashedNgramEmbedder(device="cpu")
    vecs = e.encode(["foo\0bar baz", "temperature in Kelvin"])
    assert calls == [2]
    feats = np.stack([embedder._features(t) for t in
                      ("foo bar baz", "temperature in kelvin")])
    np.testing.assert_allclose(vecs, e._project(feats), rtol=0, atol=0)
    assert e.encode([]).shape == (0, embedder.EMBED_DIM)


def test_bpe_ids_equal_python_and_jax_on_the_query_sets():
    tok = bpe.load_default()
    handle = tok._native_handle()
    jtok = jax_bpe()
    jhandle = jax_native.bpe_load(jtok.merges)
    for text in _query_texts():
        if not text.isascii():
            continue
        want = _python_ids(tok, text)
        assert native.bpe_encode(handle, text) == want, text[:40]
        assert jax_native.bpe_encode(jhandle, text) == want, text[:40]
        long = (text + " ") * 8
        assert tok.encode(long) == jtok.encode(long)


@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.characters(max_codepoint=127), max_size=300))
def test_bpe_native_equals_python_on_ascii(text):
    tok = bpe.load_default()
    assert native.bpe_encode(tok._native_handle(), text) == \
        _python_ids(tok, text)


def test_encode_routes_long_ascii_native_and_the_rest_python(monkeypatch):
    tok = bpe.load_default()
    jtok = jax_bpe()
    calls = []
    real = native.bpe_encode
    monkeypatch.setattr(native, "bpe_encode",
                        lambda h, t: calls.append(len(t)) or real(h, t))
    long_ascii = "user: benchmark the attention kernels now. " * 10
    long_unicode = "café au lait, s'il vous plaît. " * 12
    short = "what is 2+2?"
    for text in (long_ascii, long_unicode, short):
        assert tok.encode(text) == jtok.encode(text)
        assert tok.encode(text)[1:] == _python_ids(tok, text)
    assert calls == [len(long_ascii)] * 2
    with pytest.raises(ValueError, match="ASCII"):
        real(tok._native_handle(), long_unicode)


def test_concurrent_first_builds_load_one_library(tmp_path):
    code = (
        "import sys\n"
        "from distributed_llm_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(tmp_path)!r}\n"
        "lib = native.load()\n"
        "v = native.featurize_batch(['what is a delta'], 64)\n"
        "print(native.library_path(), float(abs(v).sum()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1, lines
    path = lines.pop().split()[0]
    assert os.path.dirname(path) == str(tmp_path)
    # One published library and no temp file left behind.
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("int dllm_abi_version() { return }\n")
    with pytest.raises(native.NativeBuildError, match="broken.cc") as exc:
        native.build([str(bad)], str(tmp_path / "lib.so"))
    assert "error" in str(exc.value)
    assert os.listdir(tmp_path) == ["broken.cc"]
