"""Build and load the port's CUDA kernels (``csrc/*.cu``): the twelve
attention kernels and W1, the int8-weight product.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes``.  Libraries
land in ``build/kernels/`` at the root of the checkout, named by a digest
of their sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  ``build_all`` compiles every missing library
at once (one ``nvcc`` process per source, all started together); the
first use of a single kernel builds just that one.

Nothing here runs at import: modules that launch kernels import fine on
a machine with no CUDA toolkit, and only a launch needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# source stem -> (C entry point, argtypes).  Pointers and the stream are
# c_void_p (a bare int would be cut to 32 bits); every entry returns the
# launch's cudaError_t.
SIGNATURES: Dict[str, tuple] = {
    # q, k_pool, v_pool, tables, pos, out, partial acc, partial (m, l);
    # B, Nq, Nkv, NB, bs, D, MB, tiles per split, splits; scale; stream
    "ragged_decode": ("ragged_decode_attention",
                      [_P] * 8 + [_I] * 9 + [_F, _P]),
    # q, k_pool, v_pool, tables, pos, out, partial acc, partial (m, l);
    # B, G, Nq, Nkv, NB, bs, D, MB, tiles per split, splits; scale; stream
    "ragged_verify": ("ragged_verify_attention",
                      [_P] * 8 + [_I] * 10 + [_F, _P]),
    # q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, partial acc,
    # partial (m, l); B, Nq, Nkv, NB, bs, D, MB, tiles per split, splits;
    # scale; stream
    "ragged_decode_q8": ("ragged_decode_attention_q8",
                         [_P] * 10 + [_I] * 9 + [_F, _P]),
    # q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, partial acc,
    # partial (m, l); B, G, Nq, Nkv, NB, bs, D, MB, tiles per split,
    # splits; scale; stream
    "ragged_verify_q8": ("ragged_verify_attention_q8",
                         [_P] * 10 + [_I] * 10 + [_F, _P]),
    # q, k_pool, v_pool, tables, pos, out, partial acc, partial (m, l);
    # B, Nq, Nkv, NB, bs, D, wb, tiles per split, splits; table row
    # stride; scale; stream
    "paged_decode": ("paged_decode_attention",
                     [_P] * 8 + [_I] * 9 + [_L, _F, _P]),
    # q, k_pool, v_pool, k_scale, v_scale, tables, pos, out, partial acc,
    # partial (m, l); B, Nq, Nkv, NB, bs, D, wb, tiles per split, splits;
    # table row stride; scale; stream
    "paged_decode_q8": ("paged_decode_attention_q8",
                        [_P] * 10 + [_I] * 9 + [_L, _F, _P]),
    # q, k, v, out; B, S, Nq, Nkv, D; scale; stream
    "flash_causal": ("flash_causal_attention",
                     [_P] * 4 + [_I] * 5 + [_F, _P]),
    # q, k_pool, v_pool, table, start, out; S_c, Nq, Nkv, NB, bs, D,
    # window_blocks; scale; stream
    "paged_chunk": ("paged_chunk_attention",
                    [_P] * 6 + [_I] * 7 + [_F, _P]),
    # The contiguous-cache kernels share one signature: q, k, v, k_scale,
    # v_scale, q_pos, out, partial acc, partial (m, l); B, S_q, Nq, Nkv, D,
    # W, tiles per split, splits; kv and scale batch strides; scale;
    # stream.  bf16 caches pass null scales; the split route takes tiles
    # per split >= 1 and the partials, the tensor-core route 0 and nulls.
    **{name: (entry, [_P] * 9 + [_I] * 8 + [_L, _L, _F, _P])
       for name, entry in (("flash_decode", "flash_decode_attention"),
                           ("flash_decode_q8", "flash_decode_attention_q8"),
                           ("flash_chunk", "flash_chunk_attention"),
                           ("flash_chunk_q8", "flash_chunk_attention_q8"))},
    # W1: x, x row stride; M, K, tile rows, weights; three times q, s, y,
    # N, k-tiles a chunk (unused slots null and 0); partials and their
    # floats, counters and their count; grid; stream
    "w8_matmul": ("w8_matmul", [_P, _L] + [_I] * 4
                  + ([_P] * 3 + [_I] * 2) * 3 + [_P, _L, _P, _L, _I, _P]),
}
_COMMON = ("ragged_verify.cuh", "flash_tc.cuh")

_lock = threading.Lock()
_entries: Dict[str, object] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return nvcc


def library_path(name: str) -> str:
    """Where ``name``'s library lives: digest of its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu",) + _COMMON:
        # dllm-lint: disable=capture-host-impurity -- runs at a kernel's first launch only (entry() memoizes the loaded library), and capture_program runs every body once eagerly before its capture, so no capture reaches it
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel; returns name -> library path.  Raises with nvcc's output
    if any compile fails.  ptxas resource usage goes to ``<lib>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs: List[tuple] = []
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        text = out.decode("utf-8", errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
            continue
        # dllm-lint: disable=capture-host-impurity -- runs at a kernel's first launch only (entry() memoizes the loaded library), and capture_program runs every body once eagerly before its capture, so no capture reaches it
        with open(path + ".log", "w") as f:
            f.write(text)
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _bind(name: str, path: str):
    entry, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(path), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> Dict[str, str]:
    """Build (in parallel) and load every kernel; returns name -> path."""
    with _lock:
        paths = build(SIGNATURES)
        for name, path in paths.items():
            if name not in _entries:
                _entries[name] = _bind(name, path)
        return paths


def entry(name: str):
    """The loaded C entry point of kernel ``name``, built on first use."""
    fn = _entries.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _entries:
            _entries[name] = _bind(name, build([name])[name])
        return _entries[name]


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
