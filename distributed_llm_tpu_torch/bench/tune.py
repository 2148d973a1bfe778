"""Derive measured serving defaults from bench results.

Counterpart of ``distributed_llm_tpu/bench/tune.py``: defaults follow
measurement.  It reads the headline bench's per-tier quant A/B
(``quant.<tier>``: ``speedup`` of int8 weights over bf16,
``kv_int8_speedup`` of an int8 KV cache on top) and the speculative A/B
(``speculative.speedup``), decides each tier's ``quantize`` /
``kv_quantize`` by which leg measured faster, and publishes
``bench/tuning.json`` tagged with the backend it was measured on::

    python -m distributed_llm_tpu_torch.bench.tune \\
        --headline bench_stdout.txt [--spec spec_stdout.txt] [--write]

``config.bench_cluster`` overlays a table only when its backend is
``"cuda"`` (the headline bench's ``backend`` on the card): a table
measured on the CPU never steers the card's cluster.  The repo commits no
table: with none, ``bench_cluster()`` is its hand-set default.  The
speculative default stays behind the JAX package's capability gate
(``SPEC_ENGINE_HAS_PREFIX_REUSE``): a measured decode win is recorded in
the table's evidence, and the default flips only once the gate opens; a
tier serves a draft explicitly through its ``draft_preset``.
"""

from __future__ import annotations

import argparse
import json
import os

TUNING_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tuning.json")
# The backend whose tables steer bench_cluster: the card's.
BACKEND = "cuda"

# Capability gate for the speculative default (see derive), the JAX
# package's: a measured decode-throughput win must not silently cost the
# multi-turn TTFT that session prefix reuse buys.
SPEC_ENGINE_HAS_PREFIX_REUSE = False


def derive(headline: dict, spec: dict = None,
           min_speedup: float = 1.05) -> dict:
    """Measured defaults from bench result dicts.  A feature must WIN by
    ``min_speedup`` to be enabled (ties keep the simpler configuration).

    Guards: an aborted headline is not a measurement (raise); a spec
    artifact that aborted or ran on a DIFFERENT backend is ignored with a
    note; kv_quantize was measured ON TOP of int8 weights, so it is only
    enabled together with them."""
    if headline.get("aborted"):
        raise ValueError("headline bench artifact is an aborted partial — "
                         "refusing to derive defaults from it")
    out: dict = {"backend": headline.get("backend"), "tiers": {}}
    quant = headline.get("quant") or {}
    for tier in ("nano", "orin"):
        q = quant.get(tier) or {}
        entry: dict = {}
        if q.get("speedup"):
            entry["quantize"] = ("int8" if q["speedup"] >= min_speedup
                                 else "none")
        if q.get("kv_int8_speedup"):
            kv_wins = q["kv_int8_speedup"] >= min_speedup
            entry["kv_quantize"] = ("int8" if kv_wins
                                    and entry.get("quantize") == "int8"
                                    else "none")
        if entry:
            entry["evidence"] = {k: q.get(k) for k in ("speedup",
                                                       "kv_int8_speedup")}
            out["tiers"][tier] = entry
    if spec is not None:
        if spec.get("aborted"):
            out["spec_note"] = "spec artifact aborted — ignored"
        elif spec.get("backend") != out["backend"]:
            out["spec_note"] = (f"spec artifact backend "
                                f"{spec.get('backend')!r} != headline "
                                f"{out['backend']!r} — ignored")
        else:
            s = spec.get("speculative") or {}
            if s.get("speedup"):
                orin = out["tiers"].setdefault("orin", {})
                wins = bool(s["speedup"] >= min_speedup)
                orin["speculative"] = wins and SPEC_ENGINE_HAS_PREFIX_REUSE
                if wins and not SPEC_ENGINE_HAS_PREFIX_REUSE:
                    out["spec_note"] = (
                        "spec wins on decode throughput but the "
                        "speculative engine lacks session prefix reuse "
                        "— default stays off (capability gate); serve "
                        "it explicitly with a tier's draft_preset")
                orin.setdefault("evidence", {})["spec_speedup"] = \
                    s["speedup"]
    return out


def load_tuning(backend: str = BACKEND) -> dict:
    """The tuning table's tier overlays, or {} when there is no table or
    it was measured on another backend."""
    try:
        with open(TUNING_PATH) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if data.get("backend") != backend:
        return {}
    return data.get("tiers", {})


def read_result(path: str) -> dict:
    """The first JSON object line of a bench output file."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
    raise ValueError(f"{path}: no JSON line found")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--headline", required=True,
                    help="the bench's output (its JSON result line)")
    ap.add_argument("--spec", default=None,
                    help="a speculative bench run's output")
    ap.add_argument("--min-speedup", type=float, default=1.05)
    ap.add_argument("--write", action="store_true",
                    help="publish bench/tuning.json")
    ap.add_argument("--force", action="store_true",
                    help="overwrite even a card-measured table")
    args = ap.parse_args(argv)

    headline = read_result(args.headline)
    spec = read_result(args.spec) if args.spec else None
    tuning = derive(headline, spec, args.min_speedup)
    print(json.dumps(tuning, indent=1))
    if args.write:
        prior = None
        try:
            with open(TUNING_PATH) as f:
                prior = json.load(f).get("backend")
        except (OSError, ValueError):
            pass
        # Protect a card table from a CPU run; a card run may always
        # refresh (the read side ignores other backends anyway).
        if (prior not in (None, "cpu", tuning["backend"])
                and tuning["backend"] == "cpu" and not args.force):
            print(f"# REFUSING to overwrite {TUNING_PATH}: measured on "
                  f"{prior!r}, this run is on the CPU (--force to "
                  "override)")
            raise SystemExit(1)
        with open(TUNING_PATH + ".tmp", "w") as f:
            json.dump(tuning, f, indent=1)
        os.replace(TUNING_PATH + ".tmp", TUNING_PATH)
        print(f"# wrote {TUNING_PATH}")


if __name__ == "__main__":
    main()
