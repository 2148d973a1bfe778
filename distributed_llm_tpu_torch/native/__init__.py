"""The host loops in C++: the routing featurizer and the BPE merge loop,
bound over ctypes.

Counterpart of ``distributed_llm_tpu/native/``, with the port's own
copies of both sources:

- ``featurizer.cc``: hashed n-gram text features for the routing
  embedder (``routing/embedder.py``), on every routed query and semantic
  cache lookup;
- ``bpe_encoder.cc``: the subword tokenizer's merge loop
  (``engine/bpe.py``), on every long ASCII prompt.

The library is built at first use with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/native/`` at the root of the checkout, named by
a digest of the sources and flags, so a library built from other sources
is never loaded.  Each build compiles to a file of its own (process and
thread in its name) and publishes it with ``os.replace``, so processes
that build at once never load a half-written file.  A failed build
raises with the compiler's stderr: there is no switch and no fallback
(the JAX package's loader skips native when ``DLLM_NATIVE=0`` or no
toolchain is present).  The pure-Python twins stay as the plain versions
the tests hold these loops against, and the BPE twin encodes what the
native loop does not take (non-ASCII text and short prompts), as the JAX
package routes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(SRC_DIR, "featurizer.cc"),
           os.path.join(SRC_DIR, "bpe_encoder.cc"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(SRC_DIR)), "build",
                         "native")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The compiler refused the sources; the message holds its stderr."""


def library_path(sources: Sequence[str] = SOURCES,
                 build_dir: Optional[str] = None) -> str:
    """Where the library built from ``sources`` lives: a digest of their
    bytes, the compiler and its flags names the file."""
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"libdllm_{h.hexdigest()[:16]}.so")


def build(sources: Sequence[str] = SOURCES,
          out: Optional[str] = None) -> str:
    """Compile ``sources`` into ``out`` (default ``library_path()``) and
    return it.  Raises ``NativeBuildError`` with the compiler's stderr."""
    out = out or library_path(sources)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        res = subprocess.run([CXX, *CXX_FLAGS, *sources, "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise NativeBuildError(
                f"{CXX} failed (exit {res.returncode}) on "
                f"{', '.join(os.path.basename(s) for s in sources)}:\n"
                f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The library, built first if no build of these sources exists."""
    global _lib
    if _lib is not None:                  # lock-free fast path (per query)
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(out=path)
            lib = ctypes.CDLL(path)
            lib.dllm_abi_version.argtypes = []
            lib.dllm_abi_version.restype = ctypes.c_int
            if lib.dllm_abi_version() != ABI_VERSION:
                raise NativeBuildError(
                    f"{path}: ABI {lib.dllm_abi_version()}, expected "
                    f"{ABI_VERSION}")
            lib.dllm_featurize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.dllm_featurize_batch.restype = None
            lib.dllm_bpe_load.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.dllm_bpe_load.restype = ctypes.c_int
            lib.dllm_bpe_encode.argtypes = [
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.dllm_bpe_encode.restype = ctypes.c_int
            _lib = lib
    return _lib


def featurize_batch(texts: Sequence[str], dim: int) -> np.ndarray:
    """[n, dim] float32 hashed n-gram features of ``texts`` (lowercased,
    NUL-free: ``HashedNgramEmbedder.encode`` normalizes them first)."""
    lib = load()
    n = len(texts)
    out = np.zeros((n, dim), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in texts])
    lib.dllm_featurize_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dim)
    return out


def bpe_load(merges: Sequence[Sequence[int]]) -> int:
    """Register a merge table (rank = index); returns its encode handle."""
    flat = np.ascontiguousarray(np.asarray(merges, dtype=np.int32).reshape(-1))
    return int(load().dllm_bpe_load(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(merges)))


def bpe_encode(handle: int, text: str) -> List[int]:
    """The ids of ASCII ``text`` under the table ``handle`` registered."""
    if not text.isascii():
        raise ValueError("bpe_encode takes ASCII text only")
    data = text.encode("ascii")
    out = np.empty(max(len(data), 1), dtype=np.int32)
    n = load().dllm_bpe_encode(
        handle, data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size)
    if n < 0:
        raise ValueError(f"bpe_encode: no merge table under handle {handle}")
    return out[:n].tolist()
