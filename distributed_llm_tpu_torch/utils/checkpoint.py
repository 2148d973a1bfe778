"""Versioned train-state checkpoints, the port's own format.

Counterpart of ``distributed_llm_tpu/utils/checkpoint.py`` under the
same preemption-safe layout.  The JAX package writes Orbax; the port
has no Orbax, so each version holds:

- ``params.pt``: the model's ``state_dict``, every leaf whole (the only
  file serving reads: one copy of the weights on disk);
- ``opt_state.pt``: the step count and each leaf's AdamW moments, whole;
- ``meta.json``: the format, the preset, the step and the vocabulary
  size (``peek_vocab_size`` reads only this).

``save_train_state`` writes ``<root>/.v<step>.tmp`` completely, renames
it to ``<root>/v<step>``, then swaps the ``<root>/latest`` symlink by an
atomic rename and prunes all but the newest two versions: a kill at any
instant leaves a complete published version.  A save of the step that
already is ``latest`` is skipped and returns None, as JAX's is.
``models/checkpoint.load_params_for_tier`` serves a root written here
directly (``is_port_checkpoint``), and a JAX Orbax root through its
committed export.

Nothing in a version depends on the group that trained it: a trainer
over a group writes its pieces gathered into whole leaves
(``parallel/sharding.TrainPlacement``), and ``load_train_state`` cuts
them into the loading trainer's pieces, on any group or one device, as
JAX's ``_mesh_like`` restore reshards onto the trainer's mesh.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Optional

import torch

from ..config import ModelConfig
from ..device import DeviceLike

FORMAT = "distributed_llm_tpu_torch/v1"
_VERSION_RE = re.compile(r"^v(\d+)$")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _latest_dir(root: str) -> Optional[str]:
    link = os.path.join(_abspath(root), "latest")
    return os.path.realpath(link) if os.path.islink(link) else None


def _swap_latest(root: str, version_dir: str) -> None:
    """Atomically point <root>/latest at version_dir (symlink rename)."""
    link = os.path.join(root, "latest")
    tmp = os.path.join(root, ".latest.tmp")
    if os.path.lexists(tmp):
        os.unlink(tmp)
    os.symlink(os.path.basename(version_dir), tmp)
    os.replace(tmp, link)


def _prune_versions(root: str, keep: int = 2) -> None:
    current = _latest_dir(root)
    versions = sorted(
        (int(m.group(1)), os.path.join(root, d))
        for d in os.listdir(root)
        if (m := _VERSION_RE.match(d))
        and os.path.isdir(os.path.join(root, d)))
    for _, d in versions[:-keep]:
        if os.path.realpath(d) != current:
            shutil.rmtree(d, ignore_errors=True)


def is_port_checkpoint(path: str) -> bool:
    """Whether ``path`` is a root this module wrote (its ``latest``
    version holds ``meta.json`` of this format)."""
    latest = _latest_dir(path)
    meta = os.path.join(latest, "meta.json") if latest else None
    if meta is None or not os.path.isfile(meta):
        return False
    with open(meta) as f:
        return json.load(f).get("format") == FORMAT


def _moments(trainer) -> dict:
    """Each leaf's AdamW state whole on the CPU: {name: {"step",
    "exp_avg", "exp_avg_sq"}} (empty before the first update)."""
    pl, state = trainer.placement, trainer.optimizer.state
    out = {}
    for name, leaf in pl.leaves.items():
        pieces = leaf.pieces
        first = state.get(next(iter(pieces.values())))
        if not first:
            continue
        out[name] = {"step": first["step"].detach().to("cpu").clone(), **{
            key: pl.whole(name, {k: state[p][key] for k, p in pieces.items()})
            for key in ("exp_avg", "exp_avg_sq")}}
    return out


def save_train_state(path: str, trainer) -> Optional[str]:
    """Write the trainer's weights, optimizer state and step count under a
    new ``v<step>`` version, then publish it as ``latest``.  Returns the
    root, or None when the save was skipped because this exact step is
    already the published ``latest``."""
    root = _abspath(path)
    os.makedirs(root, exist_ok=True)
    version_dir = os.path.join(root, f"v{trainer.step_count}")
    if os.path.realpath(version_dir) == _latest_dir(root):
        # Rewriting the live artifact in place would break the
        # kill-at-any-instant rule; a run that reached this step by
        # another path can step once more to publish its state.
        logging.getLogger(__name__).warning(
            "save skipped: %s is already the published 'latest' at step "
            "%d; if this run's state differs (resume from an older "
            "version), advance one step so it publishes under a new "
            "version", version_dir, trainer.step_count)
        return None
    tmp = os.path.join(root, f".v{trainer.step_count}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    cfg = trainer.cfg
    torch.save(trainer.placement.whole_state(),
               os.path.join(tmp, "params.pt"))
    torch.save({"adamw": _moments(trainer), "step": trainer.step_count},
               os.path.join(tmp, "opt_state.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"format": FORMAT, "preset": cfg.name,
                   "step": trainer.step_count,
                   "vocab_size": cfg.vocab_size,
                   "dtype": cfg.dtype}, f)
    # A stale same-step version from an abandoned run is not the
    # published artifact: it is replaced whole.
    shutil.rmtree(version_dir, ignore_errors=True)
    os.replace(tmp, version_dir)
    _swap_latest(root, version_dir)
    _prune_versions(root)
    return root


def load_train_state(path: str, trainer) -> None:
    """Resume from ``<path>/latest`` in place, whatever group saved it:
    the whole leaves and their AdamW moments cut into the trainer's
    pieces on their devices, and the step count."""
    latest = _latest_dir(path)
    if latest is None:
        raise FileNotFoundError(f"no 'latest' checkpoint under {path!r}")
    pl = trainer.placement
    pl.load_whole(torch.load(os.path.join(latest, "params.pt"),
                             map_location="cpu", weights_only=True))
    opt = torch.load(os.path.join(latest, "opt_state.pt"),
                     map_location="cpu", weights_only=True)
    state = trainer.optimizer.state
    state.clear()
    for name, saved in opt["adamw"].items():
        cut = {key: pl.split(name, saved[key])
               for key in ("exp_avg", "exp_avg_sq")}
        for k, p in pl.leaves[name].pieces.items():
            state[p] = {"step": saved["step"].clone(), **{
                key: blocks[k].to(p.device, copy=True).contiguous()
                for key, blocks in cut.items()}}
    trainer.step_count = int(opt["step"])


def peek_vocab_size(path: str) -> Optional[int]:
    """Row count of the saved embedding table, read from ``meta.json``
    only (no tensor bytes); None if there is none."""
    latest = _latest_dir(path)
    meta = os.path.join(latest or _abspath(path), "meta.json")
    try:
        with open(meta) as f:
            return int(json.load(f)["vocab_size"])
    except (OSError, KeyError, ValueError):
        return None


def load_params_for_tier(path: str, cfg: ModelConfig,
                         device: DeviceLike = None):
    """Serving weights of the root ``path`` (its ``latest`` version's
    ``params.pt``) as a model of ``cfg`` in ``cfg.dtype`` on ``device``
    (default CPU)."""
    from .. import models
    latest = _latest_dir(path)
    if latest is None:
        raise FileNotFoundError(f"no 'latest' checkpoint under {path!r}")
    with open(os.path.join(latest, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("vocab_size") != cfg.vocab_size:
        raise ValueError(f"{path}: vocab {meta.get('vocab_size')} != "
                         f"{cfg.name}'s {cfg.vocab_size}")
    state = torch.load(os.path.join(latest, "params.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    model = models.transformer.Transformer(cfg, device="meta")
    model.load_state_dict(state, assign=True)
    dtype = models.transformer.torch_dtype(cfg)
    model = model.to(device=device or "cpu", dtype=dtype)
    model.requires_grad_(False)
    return model
