"""Serve a tier's trained weights (``TierConfig.checkpoint_path``).

The JAX package's training writes Orbax checkpoints under
``checkpoints/<preset>/v<step>/state`` with a ``latest`` link, and its
``with_default_checkpoints`` points the tiny tiers there.  The port reads
no Orbax: ``port_tools/export_checkpoints.py`` exports each checkpoint's
``params`` to ``weights/<preset>.npz`` in this package (float32 arrays,
which hold the trained bf16 exactly, with the preset and the version
beside them), and this module resolves a JAX checkpoint path to that
export.  A path with no export, or an export of another version than the
one ``latest`` names, raises: nothing falls back to random weights.  A
root the port's own trainer wrote (``utils/checkpoint.py``:
``v<step>/params.pt`` beside ``meta.json``) is read directly.  A root
always loads whole, as one ``Transformer``: a tensor-parallel engine
then splits it over its device group (``parallel/sharding.shard_params``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..config import ModelConfig
from ..device import DeviceLike
from .convert import params_from_jax
from .transformer import Transformer

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")
EXPORTER = "port_tools/export_checkpoints.py"


def _missing(msg: str) -> FileNotFoundError:
    return FileNotFoundError(
        f"{msg}; export the checkpoint with `python {EXPORTER}` (it needs "
        "the JAX package and Orbax) and commit the .npz")


def export_for(path: str) -> str:
    """The committed export of the JAX checkpoint directory ``path``: the
    preset is the directory's name and the version the one its ``latest``
    link names.  Raises ``FileNotFoundError`` when there is no export of
    that version."""
    root = os.path.abspath(os.path.expanduser(path))
    link = os.path.join(root, "latest")
    if not os.path.islink(link):
        raise _missing(f"{path}: not a checkpoint directory with a "
                       "`latest` link")
    version = os.path.basename(os.path.normpath(os.readlink(link)))
    preset = os.path.basename(root)
    npz = os.path.join(WEIGHTS_DIR, f"{preset}.npz")
    if not os.path.isfile(npz):
        raise _missing(f"{path} ({version}): no export {npz}")
    with np.load(npz, allow_pickle=False) as z:
        exported = str(z["version"])
    if exported != version:
        raise _missing(f"{path}: `latest` is {version} but {npz} holds "
                       f"{exported}")
    return npz


def load_export(npz: str) -> Dict[str, object]:
    """An export as the numpy pytree ``params_from_jax`` takes, with its
    ``preset`` and ``version``."""
    with np.load(npz, allow_pickle=False) as z:
        tree: Dict[str, object] = {"embed": z["embed"],
                                   "final_ln": z["final_ln"], "layers": {}}
        for key in z.files:
            if key.startswith("layers/"):
                tree["layers"][key[len("layers/"):]] = z[key]
        tree["preset"] = str(z["preset"])
        tree["version"] = str(z["version"])
    return tree


def load_params_for_tier(path: str, cfg: ModelConfig,
                         device: DeviceLike = None) -> Transformer:
    """The trained weights at ``path`` as a ``Transformer`` in
    ``cfg.dtype`` on ``device`` (default CPU).  ``path`` is a root the
    port's trainer wrote, a JAX checkpoint directory (resolved through
    ``export_for``) or an export's ``.npz``."""
    from ..utils import checkpoint as port_ckpt
    if port_ckpt.is_port_checkpoint(path):
        return port_ckpt.load_params_for_tier(path, cfg, device=device)
    npz = path if path.endswith(".npz") else export_for(path)
    if not os.path.isfile(npz):
        raise _missing(f"{npz}: no such export")
    tree = load_export(npz)
    if tree["preset"] != cfg.name:
        raise ValueError(f"{npz} holds preset {tree['preset']!r}, the tier "
                         f"serves {cfg.name!r}")
    return params_from_jax(cfg, tree, device=device)
