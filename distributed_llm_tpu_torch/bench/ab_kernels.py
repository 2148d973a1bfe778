"""A/B every hand-written kernel against its plain PyTorch version.

Counterpart of the ``micro`` mode of
``distributed_llm_tpu/bench/ab_kernels.py``::

    python -m distributed_llm_tpu_torch.bench.ab_kernels micro
        [--tier nano|orin] [--repeat K] [--fast] [--kinds a,b]
        [--device cpu]

``micro`` times each kernel kind directly, at serving batch sizes, over
the cache-length ladder, at worst-case positions (the full-length
frontier; the ragged kinds at skewed per-slot lengths, the regime they
exist for), the median of K runs.  The plain version stands where the
JAX package has XLA, the hand-written kernel where it has Pallas.  The
twelve attention kinds keep the JAX package's names (``DISPATCH_KINDS``);
``w8`` adds W1, the int8-weight product, at the tier's gate projection.
Every case holds the kernel's output against the plain version's
(``rel_err`` = max |kernel - plain| / max |plain|, the JAX package's
numerics gate: above 0.05 the case is marked ``numerics_mismatch``).

On the card each leg is captured once as a CUDA graph and replayed K
times, each replay after an L2 flush and between two CUDA events (device
time); the bench cluster's tier gives the shapes.  On the CPU each leg is
called K times on the host clock over the tiny batched tiers, and both
legs are the plain version (a CPU tensor takes it): the rows then say
only that the harness runs.

Stated differences from the JAX harness: no ``--write-dispatch`` (every
CUDA tensor takes its kernel, so there is no dispatch table) and no
end-to-end mode (JAX's switches implementations through
``DLLM_ATTENTION``, and the port has no such switch).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from ..device import DeviceLike, resolve_device

# Kind -> the kernel (its wrapper's name in ``ops.launches.wrappers``).
KERNEL_OF = {
    "prefill": "flash_causal", "decode": "flash_decode",
    "decode_q8": "flash_decode_q8", "chunk": "flash_chunk",
    "chunk_q8": "flash_chunk_q8", "paged_decode": "paged_decode",
    "paged_decode_q8": "paged_decode_q8", "ragged_decode": "ragged_decode",
    "ragged_decode_q8": "ragged_decode_q8", "ragged_verify": "ragged_verify",
    "ragged_verify_q8": "ragged_verify_q8", "paged_chunk": "paged_chunk",
    "w8": "w8_matmul"}
ALL_KINDS = frozenset(KERNEL_OF)
MISMATCH_REL_ERR = 0.05
FLUSH_BYTES = 96 << 20          # past the card's 50 MB L2
VERIFY_G = 5                    # γ = 4, the presets' default, plus one


def _median_ms(fn: Callable, repeat: int, on_card: bool,
               flush: Optional[Callable]):
    """(median ms of ``repeat`` runs, the output of one run)."""
    if not on_card:
        out = None
        for _ in range(2):
            out = fn()
        times = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()                          # the first replay uploads it
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(repeat)]
    for start, end in events:
        flush()
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    out = out.clone()
    del graph
    return statistics.median(s.elapsed_time(e) for s, e in events), out


def micro_ab(tier_name: str = "orin", repeat: int = 20, fast: bool = False,
             kinds: Optional[Iterable[str]] = None,
             lengths: Optional[Sequence[int]] = None,
             batches: Optional[Sequence[int]] = None,
             device: DeviceLike = None, log=print) -> dict:
    """Every kind's kernel against its plain version at serving shapes:
    ``{"backend", "card", "model", "repeat", "cases": [...]}``, one case
    per (kind, length, batch).  ``fast`` trims the grid to one mid-ladder
    length and the model's maximum at batches 1 and 8; ``lengths`` and
    ``batches`` set it outright; ``kinds`` restricts it."""
    from ..config import bench_cluster, tiny_batched_cluster
    from ..ops import attention as TA
    from ..ops import flash_attention as TF
    from ..ops import quant as TQ
    from ..ops import ragged_attention as TR

    kinds = ALL_KINDS if kinds is None else set(kinds)
    unknown = kinds - ALL_KINDS
    if unknown:
        raise ValueError(f"unknown kinds {sorted(unknown)}; "
                         f"valid: {sorted(ALL_KINDS)}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cluster = bench_cluster() if on_card else tiny_batched_cluster()
    tier = getattr(cluster, tier_name)
    cfg = tier.model()
    nq, nkv, d, bs = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      tier.kv_block_size)
    if lengths is None:
        lengths = sorted({c for c in (256, 1024) if c < cfg.max_seq_len}
                         | {cfg.max_seq_len})
        if fast:
            lengths = sorted({min(1024, cfg.max_seq_len), cfg.max_seq_len})
    if batches is None:
        batches = (1, 8) if fast else (1, 4, 8)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    flush_buf = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
                 if on_card else None)
    flush = flush_buf.zero_ if on_card else None
    results: dict = {"backend": dev.type,
                     "card": torch.cuda.get_device_name(dev) if on_card
                     else None,
                     "model": cfg.name, "tier": tier_name, "repeat": repeat,
                     "timing": ("graph-replayed, L2 flushed, CUDA events"
                                if on_card else "host clock, plain both legs"),
                     "cases": []}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf16)

    def record(kind: str, length: int, kernel: Callable, plain: Callable,
               args: tuple, detail: dict) -> None:
        """Time both legs; a leg that raises loses with ms None instead
        of ending the A/B."""
        def leg(fn):
            try:
                ms, out = _median_ms(lambda: fn(*args), repeat, on_card,
                                     flush)
                return ms, out, None
            except Exception as exc:
                return None, None, f"{type(exc).__name__}: {exc}"[:200]

        k_ms, k_out, k_err = leg(kernel)
        p_ms, p_out, p_err = leg(plain)
        case = {"kind": kind, "kernel": KERNEL_OF[kind], "length": length,
                **detail, "kernel_ms": k_ms, "plain_ms": p_ms,
                "speedup": (round(p_ms / k_ms, 3) if k_ms and p_ms
                            else None)}
        if k_err:
            case["kernel_error"] = k_err
        if p_err:
            case["plain_error"] = p_err
        if k_out is not None and p_out is not None:
            ref = p_out.float()
            denom = float(ref.abs().max()) or 1.0
            rel = float((k_out.float() - ref).abs().max()) / denom
            case["rel_err"] = round(rel, 5)
            if not rel <= MISMATCH_REL_ERR:
                case["numerics_mismatch"] = True
        results["cases"].append(case)
        log(json.dumps(case))

    def pool(b: int, s: int, extra: int = 1):
        nb = b * (s // bs) + extra
        tables = torch.arange(b * (s // bs), dtype=torch.int32,
                              device=dev).reshape(b, s // bs)
        return randn(nkv, nb, bs, d), randn(nkv, nb, bs, d), tables

    for s in lengths:
        if "prefill" in kinds and s % 128 == 0:
            q, k, v = randn(1, s, nq, d), randn(1, s, nkv, d), randn(1, s, nkv, d)
            record("prefill", s, TF.flash_causal_attention,
                   TA.causal_attention, (q, k, v), {})

        for b in batches:
            if not kinds & {"decode", "decode_q8"}:
                break
            q = randn(b, nq, d)
            kc, vc = randn(b, s, nkv, d), randn(b, s, nkv, d)
            pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
            if "decode" in kinds:
                record("decode", s, TF.flash_decode_attention,
                       TA._decode_contiguous, (q, kc, vc, pos), {"batch": b})
            if "decode_q8" in kinds:
                (kq, ksc), (vq, vsc) = (TQ.quantize_kv_rows(kc),
                                        TQ.quantize_kv_rows(vc))
                record("decode_q8", s, TF.flash_decode_attention_q8,
                       TA._decode_contiguous_q8,
                       (q, kq, vq, ksc, vsc, pos), {"batch": b})

        if kinds & {"chunk", "chunk_q8"}:
            # One 128-token suffix against the window, ending at its end.
            sc = min(128, s)
            q = randn(1, sc, nq, d)
            kc, vc = randn(1, s, nkv, d), randn(1, s, nkv, d)
            qpos = (torch.arange(sc, dtype=torch.int32, device=dev)
                    + (s - sc))[None]
            if "chunk" in kinds:
                record("chunk", s, TF.flash_chunk_attention,
                       TA._chunk_contiguous, (q, kc, vc, qpos), {"chunk": sc})
            if "chunk_q8" in kinds:
                (kq, ksc), (vq, vsc) = (TQ.quantize_kv_rows(kc),
                                        TQ.quantize_kv_rows(vc))
                record("chunk_q8", s, TF.flash_chunk_attention_q8,
                       TA._chunk_contiguous_q8,
                       (q, kq, vq, ksc, vsc, qpos), {"chunk": sc})

        paged = ("paged_decode", "paged_decode_q8", "ragged_decode",
                 "ragged_decode_q8", "ragged_verify", "ragged_verify_q8")
        for b in [x for x in batches if x > 1]:
            if not kinds & set(paged) or s < bs:
                break
            kp, vp, tables = pool(b, s)
            (kq, ksc), (vq, vsc) = (TQ.quantize_kv_rows(kp),
                                    TQ.quantize_kv_rows(vp))
            q = randn(b, nq, d)
            # Dense windowed: every slot at the worst-case frontier.
            full = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
            # Ragged: slot i holds ~(i+1)/b of the window.
            skew = torch.tensor([max(0, s * (i + 1) // b - 1)
                                 for i in range(b)], dtype=torch.int32,
                                device=dev)
            if "paged_decode" in kinds:
                record("paged_decode", s, TF.paged_decode_attention,
                       TA._gather_decode_windowed, (q, kp, vp, tables, full),
                       {"batch": b})
            if "paged_decode_q8" in kinds:
                record("paged_decode_q8", s, TF.paged_decode_attention_q8,
                       lambda q, k, v, ks, vs, t, p:
                       TA._gather_decode_windowed(q, k, v, t, p, ks, vs),
                       (q, kq, vq, ksc, vsc, tables, full), {"batch": b})
            if "ragged_decode" in kinds:
                record("ragged_decode", s, TR.ragged_paged_decode_attention,
                       TA._gather_decode_paged, (q, kp, vp, tables, skew),
                       {"batch": b})
            if "ragged_decode_q8" in kinds:
                record("ragged_decode_q8", s,
                       TR.ragged_paged_decode_attention_q8,
                       lambda q, k, v, ks, vs, t, p:
                       TA._gather_decode_paged(q, k, v, t, p, ks, vs),
                       (q, kq, vq, ksc, vsc, tables, skew), {"batch": b})
            # Verify: a γ+1 chunk per slot ending at its skewed frontier.
            g = VERIFY_G
            qg = randn(b, g, nq, d)
            first = torch.tensor([max(0, s * (i + 1) // b - g)
                                  for i in range(b)], dtype=torch.int32,
                                 device=dev)
            if "ragged_verify" in kinds:
                record("ragged_verify", s, TR.ragged_paged_verify_attention,
                       TA._gather_verify_paged, (qg, kp, vp, tables, first),
                       {"batch": b, "g": g})
            if "ragged_verify_q8" in kinds:
                record("ragged_verify_q8", s,
                       TR.ragged_paged_verify_attention_q8,
                       lambda q, k, v, ks, vs, t, p:
                       TA._gather_verify_paged(q, k, v, t, p, ks, vs),
                       (qg, kq, vq, ksc, vsc, tables, first),
                       {"batch": b, "g": g})

        if "paged_chunk" in kinds and s >= 128 and s % bs == 0:
            # A prefix hit's 128-token suffix through one slot's table.
            sc, nb = 128, s // bs
            kp, vp = randn(nkv, nb + 1, bs, d), randn(nkv, nb + 1, bs, d)
            table = torch.arange(nb, dtype=torch.int32, device=dev)
            start = torch.tensor([s - sc], dtype=torch.int32, device=dev)
            qpos = (torch.arange(sc, dtype=torch.int32, device=dev)
                    + (s - sc))[None]
            q = randn(1, sc, nq, d)
            record("paged_chunk", s,
                   lambda q, k, v, t, st, qp: TF.paged_chunk_attention(
                       q, k, v, t, st, s, q_pos=qp),
                   lambda q, k, v, t, st, qp: TA._gather_chunk_paged(
                       q, k, v, t, qp, s),
                   (q, kp, vp, table, start, qpos), {"chunk": sc})

    if "w8" in kinds:
        # W1 at the gate projection, decode's rows.
        qt = TQ.quantize_tensor(randn(cfg.hidden_size, cfg.ffn_size))
        for b in batches:
            x = randn(b, cfg.hidden_size)
            record("w8", cfg.hidden_size, TQ.w8_matmul, TQ._matmul_plain,
                   (x, qt.q, qt.s), {"batch": b, "n": cfg.ffn_size})
    return results


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=("micro",))
    ap.add_argument("--tier", default="nano", choices=("nano", "orin"))
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--fast", action="store_true",
                    help="trimmed grid (one mid-ladder length and the max)")
    ap.add_argument("--kinds", default=None,
                    help="comma-separated subset of the kinds")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    res = micro_ab(args.tier, repeat=max(args.repeat, 10), fast=args.fast,
                   kinds=(args.kinds.split(",") if args.kinds else None),
                   device=args.device)
    print(json.dumps({k: v for k, v in res.items() if k != "cases"}
                     | {"cases": len(res["cases"])}))


if __name__ == "__main__":
    main()
