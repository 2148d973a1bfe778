"""Benchmark results analysis: results_analysis.ipynb as a module.

Counterpart of ``distributed_llm_tpu/bench/analysis.py``.  The notebook
loads final_results.csv, derives per-token and human-unit metrics, and
plots latency / energy / avg power / latency-per-token / energy-per-token
against the context threshold (results_analysis.ipynb cells 4-22).  Here,
as in the JAX package, the same derivations run over the v2 harness's
CSVs (``bench/tester.py``'s schemas, with req/s, p50 TTFT and decode
tok/s), emit a markdown report, and optionally write the notebook's plot
set as PNGs::

  python -m distributed_llm_tpu_torch.bench.analysis \\
      --summary-csv results.csv --per-query-csv per_query.csv \\
      --output-md report.md --plots-dir plots/

The JAX package reads the CSVs with pandas, which the card's machine
lacks; this module reads them with ``csv`` into a ``Table`` that infers
each column's type as ``pandas.read_csv`` does (int, float with NaN for
missing cells, bool, else text), so its report equals the JAX package's
on the same CSV.  ``--plots-dir`` needs matplotlib and raises an
``ImportError`` that names it where it is missing.
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence

# pandas.read_csv's default missing-value markers.
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))
_INT_RE = re.compile(r"[+-]?\d+")
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))
NAN = float("nan")


def _isna(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _to_float(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None


def _infer(raw: Sequence[str]) -> list:
    """One column's cells typed as pandas.read_csv types them."""
    present = [s for s in raw if s not in _NA]
    missing = len(present) < len(raw)
    if not present:
        return [NAN] * len(raw)
    if all(_INT_RE.fullmatch(s) for s in present):
        return ([NAN if s in _NA else float(int(s)) for s in raw] if missing
                else [int(s) for s in raw])
    floats = [_to_float(s) for s in present]
    if all(f is not None for f in floats):
        return [NAN if s in _NA else float(s) for s in raw]
    if all(s in _TRUE or s in _FALSE for s in present):
        return [NAN if s in _NA else s in _TRUE for s in raw]
    return [NAN if s in _NA else s for s in raw]


class Table:
    """Columns of typed cells: the part of a DataFrame the report uses."""

    def __init__(self, columns: Dict[str, list]):
        self.cols: Dict[str, list] = dict(columns)
        lengths = {len(v) for v in self.cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {sorted(lengths)}")
        self.n = lengths.pop() if lengths else 0

    @classmethod
    def read_csv(cls, path: str) -> "Table":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            raise ValueError(f"{path}: no columns to parse")
        header, body = rows[0], rows[1:]
        return cls({h: _infer([r[i] if i < len(r) else "" for r in body])
                    for i, h in enumerate(header)})

    def __len__(self) -> int:
        return self.n

    def __contains__(self, name: str) -> bool:
        return name in self.cols

    def __getitem__(self, name: str) -> list:
        return self.cols[name]

    def rows(self, order: Optional[Sequence[int]] = None):
        for i in (range(self.n) if order is None else order):
            yield {c: v[i] for c, v in self.cols.items()}


def _float(v: Any) -> float:
    return NAN if _isna(v) else float(v)


def _sort_key(v: Any):
    """Missing values last, as pandas sorts them."""
    return (1, 0) if _isna(v) else (0, v)


def derive_metrics(df: Table) -> Table:
    """Add the notebook's derived columns in human units (s, J, W)."""
    out = dict(df.cols)
    for dev in ("nano", "orin", "overall"):
        lat = f"{dev}_total_latency_ms"
        en = f"{dev}_total_energy_mJ"
        tok = f"{dev}_total_tokens"
        if lat in out:
            out[f"{dev}_latency_s"] = [_float(v) / 1000.0 for v in out[lat]]
        if en in out:
            out[f"{dev}_energy_J"] = [_float(v) / 1000.0 for v in out[en]]
        per_token = lambda num, t: (num / 1000.0 / _float(t)  # noqa: E731
                                    if _float(t) > 0 else NAN)
        if lat in out and tok in out:
            out[f"{dev}_s_per_token"] = [per_token(_float(a), t) for a, t in
                                         zip(out[lat], out[tok])]
        if en in out and tok in out:
            out[f"{dev}_J_per_token"] = [per_token(_float(e), t) for e, t in
                                         zip(out[en], out[tok])]
    return Table(out)


def _fmt(v) -> str:
    if _isna(v) or v == "":
        return "—"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def markdown_report(summary: Table,
                    per_query: Optional[Table] = None) -> str:
    """Markdown tables: one per query set, ordered by strategy/threshold."""
    df = derive_metrics(summary)
    lines: List[str] = ["# Benchmark report", ""]

    cols = ["strategy", "cache_mode", "token_threshold", "routing_accuracy",
            "req_per_s", "p50_ttft_ms", "p50_latency_ms", "decode_tok_per_s",
            "nano_latency_s", "orin_latency_s", "overall_total_tokens"]
    cols = [c for c in cols if c in df]

    qsets = df["query_set"]
    order = ["strategy", "cache_mode", "token_threshold"]
    keys = [df[c] for c in order]
    for qset in sorted({q for q in qsets if not _isna(q)}):
        lines.append(f"## {qset}")
        lines.append("")
        lines.append("| " + " | ".join(cols) + " |")
        lines.append("|" + "---|" * len(cols))
        idx = sorted((i for i in range(len(df)) if qsets[i] == qset),
                     key=lambda i: tuple(_sort_key(k[i]) for k in keys))
        for row in df.rows(idx):
            lines.append("| " + " | ".join(_fmt(row[c]) for c in cols) + " |")
        lines.append("")

    if per_query is not None and len(per_query):
        lines.append("## Device split per strategy")
        lines.append("")
        counts: Dict[Any, Dict[Any, int]] = {}
        for s, d in zip(per_query["strategy"], per_query["device_used"]):
            if not (_isna(s) or _isna(d)):
                counts.setdefault(s, {}).setdefault(d, 0)
                counts[s][d] += 1
        devices = sorted({d for per in counts.values() for d in per})
        lines.append("| strategy | " + " | ".join(map(str, devices)) + " |")
        lines.append("|" + "---|" * (len(devices) + 1))
        for strategy in sorted(counts):
            lines.append(f"| {strategy} | " + " | ".join(
                str(counts[strategy].get(d, 0)) for d in devices) + " |")
        lines.append("")

        lat = [_float(v) for v in per_query["latency_ms"]]
        # pandas' nlargest: descending, ties in row order, NaN last.
        hot = sorted(range(len(per_query)),
                     key=lambda i: (math.isnan(lat[i]),
                                    0.0 if math.isnan(lat[i]) else -lat[i]))[:5]
        lines.append("## Slowest queries")
        lines.append("")
        for i in hot:
            lines.append(f"- **{lat[i]:.0f} ms** "
                         f"[{per_query['device_used'][i]}/"
                         f"{per_query['strategy'][i]}] "
                         f"{str(per_query['query_text'][i])[:90]}")
        lines.append("")
    return "\n".join(lines)


def write_plots(summary: Table, plots_dir: str) -> List[str]:
    """The notebook's plot set vs token threshold + a strategy overview."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("--plots-dir needs matplotlib, which is not "
                          "installed here; the markdown report needs "
                          "nothing beyond the stdlib") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plots_dir, exist_ok=True)
    df = derive_metrics(summary)
    written: List[str] = []

    sweep = [r for r in df.rows() if r["strategy"] == "token"]
    metrics = [("latency_s", "total latency (s)"),
               ("energy_J", "energy (J)"),
               ("s_per_token", "latency per token (s)"),
               ("J_per_token", "energy per token (J)")]
    if len(sweep) > 1:
        lines: Dict[tuple, list] = {}
        for r in sweep:
            lines.setdefault((r["query_set"], r["cache_mode"]), []).append(r)
        for key, label in metrics:
            fig, ax = plt.subplots(figsize=(6, 4))
            # One sorted line per (query set, cache mode) per device.
            for (qset, cmode), grp in sorted(lines.items(), key=str):
                grp = sorted(grp, key=lambda r: _sort_key(r["token_threshold"]))
                for dev in ("nano", "orin"):
                    col = f"{dev}_{key}"
                    if col in df:
                        ax.plot([r["token_threshold"] for r in grp],
                                [r[col] for r in grp], marker="o",
                                label=f"{dev} ({qset}, cache {cmode})")
            ax.set_xlabel("token threshold")
            ax.set_ylabel(label)
            ax.legend(fontsize=7)
            ax.set_title(f"{label} vs threshold (token strategy)")
            path = os.path.join(plots_dir, f"threshold_{key}.png")
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            written.append(path)

    if "req_per_s" in df:
        best: Dict[str, float] = {}
        for r in df.rows():
            v = r["req_per_s"]
            v = _to_float(str(v)) if not _isna(v) else None
            if v is not None and not math.isnan(v):
                best[r["strategy"]] = max(best.get(r["strategy"], v), v)
        if not best:
            return written          # header-only / failed-run CSV
        fig, ax = plt.subplots(figsize=(6, 4))
        names = sorted(best)
        ax.bar(names, [best[n] for n in names])
        ax.set_ylabel("req/s")
        ax.set_title("throughput per routing strategy")
        path = os.path.join(plots_dir, "req_per_s.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--summary-csv", required=True)
    p.add_argument("--per-query-csv", default=None)
    p.add_argument("--output-md", default="benchmark_report.md")
    p.add_argument("--plots-dir", default=None)
    args = p.parse_args(argv)

    summary = Table.read_csv(args.summary_csv)
    per_query = (Table.read_csv(args.per_query_csv)
                 if args.per_query_csv else None)
    report = markdown_report(summary, per_query)
    with open(args.output_md, "w") as f:
        f.write(report)
    print(f"[done] report -> {args.output_md}")
    if args.plots_dir:
        for path in write_plots(summary, args.plots_dir):
            print(f"[done] plot -> {path}")


if __name__ == "__main__":
    main()
