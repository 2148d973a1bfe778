"""W1's plan sweep on the card: how each chunk count, grid and tile of
``csrc/w8_matmul.cu`` times at the full-width projections of nano_1b and
orin_8b, beside the same kernel with its arithmetic taken out.

``ops/quant.w8_plan`` picks one (chunk, grid, tile) a shape; this script
times the others too, so a change to the plan's rule can be judged.  The
"no arithmetic" variant is the kernel's source with each k-tile's widening
and wgmmas cut out (the producer's TMA loads, the ring and the fix-up
stay): its time is what the weight's bytes cost under the same flush.
Every time is a replayed CUDA graph after a 96 MB L2 flush, as
``chip_smoke.py`` times W1 (``chip_smoke.graph_ms``); every output row of
the kernel is held within 1e-2 of the float32 plain version.

    python3 port_tools/w8_sweep.py [PARTS]    # on the card, from the repo root

PARTS is a comma list of ``floor`` (the no-arithmetic variant at 4
rows), ``decode`` (4 and 20 rows: 1-16 chunks, grids of one and two
blocks an SM), ``wide`` (128-2048 rows: 1-8 chunks, beside the cast
route) and ``tile`` (192 and 256 rows: 64- against 128-row tiles, outputs
compared bit for bit); all four by default.  It prints one JSON row a
timing and writes them all to ``w8_sweep.json`` in chip_smoke's report
directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = {"orin_gate": (4096, 14336), "orin_down": (14336, 4096),
          "orin_q": (4096, 4096), "orin_k": (4096, 1024),
          "nano_q": (2048, 2048), "nano_k": (2048, 512),
          "nano_gate": (2048, 8192), "nano_down": (8192, 2048)}
WIDE = ("orin_gate", "orin_k", "orin_down", "nano_q", "nano_k", "nano_gate")


def no_arithmetic_library(build) -> ctypes.CDLL:
    """The kernel's source with a k-tile's widening and wgmmas cut out
    (the lines between its W8_SWEEP_CUT_BEGIN and W8_SWEEP_CUT_END
    markers), built beside the real one.  Fails unless each marker is
    there once, in that order."""
    src = open(os.path.join(build.CSRC_DIR, "w8_matmul.cu")).read()
    marks = [src.count(m) for m in ("W8_SWEEP_CUT_BEGIN", "W8_SWEEP_CUT_END")]
    if marks != [1, 1]:
        raise SystemExit(f"w8_sweep: w8_matmul.cu holds the cut markers "
                         f"{marks} times, not once each")
    start = src.rindex("\n", 0, src.index("W8_SWEEP_CUT_BEGIN")) + 1
    end = src.index("\n", src.index("W8_SWEEP_CUT_END")) + 1
    if end <= start:
        raise SystemExit("w8_sweep: the cut markers are out of order")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "w8_no_arithmetic")
    with open(path + ".cu", "w") as f:
        f.write(src[:start] + src[end:])
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           path + ".so", path + ".cu"],
                          capture_output=True, text=True)
    print(done.stdout[-2000:], done.stderr[-2000:], flush=True)
    done.check_returncode()
    return ctypes.CDLL(path + ".so")


def main(argv=None) -> None:
    import torch

    import chip_smoke as CS
    from distributed_llm_tpu_torch.ops import _build
    from distributed_llm_tpu_torch.ops import quant as Q
    from distributed_llm_tpu_torch.utils import roofline

    if not torch.cuda.is_available():
        raise SystemExit("w8_sweep: no CUDA device")
    parts = (argv or sys.argv[1:] or ["floor,decode,wide,tile"])[0].split(",")
    CS.PEAKS.update(roofline.chip_peaks("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sms = Q._sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev).zero_
    weights = {name: Q.quantize_tensor(
        (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)) for name, (k, n) in SHAPES.items()}
    real = _build.entry("w8_matmul")
    entries = {"kernel": real}
    if "floor" in parts:
        lib = no_arithmetic_library(_build)
        fn = lib.w8_matmul
        fn.argtypes, fn.restype = _build.SIGNATURES["w8_matmul"][1], ctypes.c_int
        entries["no_arithmetic"] = fn

    def geometry(m, name, chunk, bm):
        """(tile columns, tiles, items) of one weight's launch."""
        k, n = SHAPES[name]
        bn = Q.w8_tile(m)[1]
        tiles = -(-m // bm) * -(-n // bn)
        return bn, tiles, tiles * -(-(-(-k // Q.W8_BK)) // chunk)

    def launch(entry, x, name, chunk, grid, bm):
        """One launch of ``entry`` over weight ``name`` with the given
        chunk, grid and tile rows (scratch sized for them)."""
        w = weights[name]
        m, k = x.shape
        n = w.q.shape[1]
        bn, tiles, items = geometry(m, name, chunk, bm)
        y = torch.empty((m, n), dtype=x.dtype, device=dev)
        floats = items * bm * bn
        part = torch.empty(floats + tiles, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(x.data_ptr(), x.stride(0), m, k, bm, 1, w.q.data_ptr(),
                    w.s.data_ptr(), y.data_ptr(), n, chunk,
                    *([None, None, None, 0, 0] * 2), part.data_ptr(),
                    floats, part.data_ptr() + 4 * floats, tiles,
                    min(grid, items), stream)
        _build.check(err, "w8_matmul")
        return y

    rows = []

    def record(part, entry_name, name, m, chunk, grid, bm, check=True):
        k, n = SHAPES[name]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = weights[name]
        entry = entries[entry_name]
        y = launch(entry, x, name, chunk, grid, bm)
        err = None
        if check:
            err = CS.row_rel_err(y, Q._matmul_plain(x.float(), w.q,
                                                    w.s.float()))
            CS.require(err <= CS.KERNEL_REL_TOL, f"w8_sweep: {name} M={m} "
                       f"chunk {chunk} grid {grid} tile {bm}: {err}")
        ms = CS.graph_ms(torch, lambda: launch(entry, x, name, chunk, grid,
                                               bm), flush=flush)
        bound, by = CS.bound(k * n + 2 * n + 2 * m * k + 2 * m * n,
                             2 * m * k * n)
        row = {"part": part, "variant": entry_name, "shape": name, "M": m,
               "chunk": chunk, "grid": min(grid, geometry(m, name, chunk,
                                                          bm)[2]),
               "tile": bm, "ms": ms, "bound_ms": bound,
               "bound_by": by, "rel_err": err,
               "planned": Q.w8_plan(m, [(k, n)], sms).chunks[0][0] == chunk}
        if part == "wide":
            row["cast_ms"] = CS.graph_ms(
                torch, lambda: Q._matmul_plain(x, w.q, w.s), flush=flush)
        rows.append(row)
        print(json.dumps(row), flush=True)
        return y

    def chunks(k, counts):
        kt = -(-k // Q.W8_BK)
        return sorted({-(-kt // c) for c in counts if c <= kt}, reverse=True)

    if "floor" in parts:
        for name in ("orin_gate", "orin_down", "nano_q", "nano_k"):
            k = SHAPES[name][0]
            for chunk in chunks(k, (1, 2, 4, 8)):
                for variant in ("kernel", "no_arithmetic"):
                    record("floor", variant, name, 4, chunk, sms, 8,
                           check=variant == "kernel")
    if "decode" in parts:
        for name, (k, _) in SHAPES.items():
            for m in (4, 20):
                bm = Q.w8_tile(m)[0]
                for chunk in chunks(k, (1, 2, 4, 8, 16)):
                    for grid in (sms, 2 * sms):
                        record("decode", "kernel", name, m, chunk, grid, bm)
    if "wide" in parts:
        for name in WIDE:
            k = SHAPES[name][0]
            for m in (128, 256, 512, 1024, 2048):
                for chunk in chunks(k, (1, 2, 4, 8)):
                    record("wide", "kernel", name, m, chunk, sms,
                           Q.w8_plan(m, [SHAPES[name]], sms).bm)
    if "tile" in parts:
        for name, (k, n) in SHAPES.items():
            for m in (192, 256):
                chunk = Q.w8_plan(m, [(k, n)], sms).chunks[0][0]
                x_seed = gen.get_state()
                ys = []
                for bm in (64, 128):
                    gen.set_state(x_seed)
                    ys.append(record("tile", "kernel", name, m, chunk, sms,
                                     bm))
                CS.require(torch.equal(ys[0], ys[1]), f"w8_sweep: {name} "
                           f"M={m}: 64- and 128-row tiles differ")
    os.makedirs(CS.REPORT_DIR, exist_ok=True)
    with open(os.path.join(CS.REPORT_DIR, "w8_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
