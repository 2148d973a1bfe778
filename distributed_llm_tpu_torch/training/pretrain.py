"""Pretrain a model preset on the synthetic corpus to a loss plateau and
publish a serving checkpoint.

Counterpart of ``distributed_llm_tpu/training/pretrain.py``.  Data
parallelism takes JAX's rule: the largest count of the devices (default:
every card) that divides the batch, the trainer over that ('dp',) group;
on one card that is the one device.  The model learns the generated corpus
(``training/data.py``) until the eval-window mean loss stops improving,
the train state is written in the versioned layout
(``utils/checkpoint.py``), and a tier serves it through
``TierConfig.checkpoint_path``.

Run:  python -m distributed_llm_tpu_torch.training.pretrain \\
          --preset nano_test --out build/ckpt/nano_test [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..config import MODEL_PRESETS
from ..device import DeviceLike
from ..parallel.mesh import DeviceGroup, DevicesLike, as_devices
from .data import batches
from .trainer import TrainConfig, Trainer


def pretrain(preset: str, out: str, *,
             batch_size: int = 16,
             seq_len: Optional[int] = None,
             max_steps: int = 2000,
             eval_every: int = 25,
             patience: int = 4,
             min_delta: float = 0.02,
             learning_rate: float = 1e-3,
             seed: int = 0,
             save_every: Optional[int] = None,
             resume: bool = False,
             device: DeviceLike = None,
             devices: Optional[DevicesLike] = None,
             log: Callable[[str], None] = print) -> Dict[str, float]:
    """Train ``preset`` until the eval-window mean loss stops improving by
    ``min_delta`` for ``patience`` consecutive windows (or ``max_steps``),
    then checkpoint to ``out``.  ``save_every`` > 0 also checkpoints
    mid-run.  ``resume`` continues from the checkpoint at ``out`` (weights,
    optimizer state, step count); ``max_steps`` then counts additional
    steps, the schedule's horizon is stretched over them
    (``extend_schedule``), and the data stream's seed is offset by the
    saved step count, so it is disjoint from the first run's at any batch
    shape.  Returns {"steps", "final_loss", "seconds", "losses",
    "step_ms"}: the step count, the last eval window's mean loss, the wall
    time, and each step's loss and wall milliseconds (a step ends with
    its loss's host read).  ``devices`` (default: every card, or
    ``device``) are the slots data parallelism may take."""
    cfg = MODEL_PRESETS[preset]
    seq = seq_len or min(256, cfg.max_seq_len)
    devs = as_devices(devices, device)
    dp = next(d for d in range(len(devs), 0, -1) if batch_size % d == 0)
    mesh = DeviceGroup(devs[:dp], ("dp",), (dp,))
    trainer = Trainer(cfg, TrainConfig(batch_size=batch_size, seq_len=seq,
                                       learning_rate=learning_rate,
                                       warmup_steps=min(50, max_steps // 4),
                                       decay_steps=max(1000, max_steps),
                                       seed=seed), mesh)
    resumed_from = 0
    if resume:
        if os.path.isdir(out):
            trainer.load(out)
            resumed_from = trainer.step_count
            if trainer.extend_schedule(resumed_from + max_steps):
                log(f"[pretrain] extended LR schedule to "
                    f"{resumed_from + max_steps} steps")
            log(f"[pretrain] resumed {preset} from {out} at step "
                f"{resumed_from}")
        else:
            log(f"[pretrain] WARNING: --resume but no checkpoint at "
                f"{out} — training from scratch")
    log(f"[pretrain] {preset}: {cfg.num_layers}L/{cfg.hidden_size}h "
        f"({cfg.param_count()/1e6:.2f}M params) batch={batch_size} "
        f"seq={seq} dp={dp} device={trainer.device} max_steps={max_steps}")

    window: collections.deque = collections.deque(maxlen=eval_every)
    losses, step_ms = [], []
    best = float("inf")
    stale = 0
    t0 = time.perf_counter()
    final = float("nan")
    from ..engine.tokenizer import get_tokenizer
    # batches() seeds each batch's rng from (seed << 20) ^ step, so an
    # offset seed is a disjoint stream whatever the batch shape.
    data = batches(batch_size, seq, seed=seed + resumed_from,
                   tokenizer=get_tokenizer(cfg))
    for step, (toks, mask) in enumerate(data, start=1):
        t_step = time.perf_counter()
        metrics = trainer.train_step(toks, mask)
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        window.append(metrics["loss"])
        losses.append(metrics["loss"])
        if step % eval_every == 0:
            mean = float(np.mean(window))
            final = mean
            log(f"[pretrain] step {step}: loss={mean:.4f} "
                f"(best={best:.4f}, {step / (time.perf_counter()-t0):.1f} "
                f"steps/s)")
            if best - mean < min_delta:
                stale += 1
                if stale >= patience:
                    log(f"[pretrain] plateau after {step} steps")
                    break
            else:
                stale = 0
            best = min(best, mean)
        if save_every and step % save_every == 0:
            trainer.save(out)
        if step >= max_steps:
            break
    seconds = time.perf_counter() - t0
    # None: the loop's save_every save already published this exact step.
    path = trainer.save(out) or out
    log(f"[pretrain] saved {path} at step {trainer.step_count} "
        f"(loss={final:.4f})")
    return {"steps": trainer.step_count, "final_loss": final,
            "seconds": seconds, "losses": losses, "step_ms": step_ms}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", required=True, choices=sorted(MODEL_PRESETS))
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--patience", type=int, default=4)
    ap.add_argument("--min-delta", type=float, default=0.02)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from an existing checkpoint at --out "
                         "(max-steps counts additional steps)")
    ap.add_argument("--device", default=None,
                    help="cpu runs on the host (default: the card)")
    args = ap.parse_args(argv)
    pretrain(args.preset, args.out, batch_size=args.batch_size,
             seq_len=args.seq_len, max_steps=args.max_steps,
             eval_every=args.eval_every, patience=args.patience,
             min_delta=args.min_delta, learning_rate=args.learning_rate,
             seed=args.seed, save_every=args.save_every, resume=args.resume,
             device=args.device)


if __name__ == "__main__":
    main()
