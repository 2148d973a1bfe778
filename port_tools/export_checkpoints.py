"""Export the repo's trained checkpoints for the PyTorch/CUDA port.

The JAX package's training writes Orbax checkpoints under
``checkpoints/<preset>/v<step>/state`` with a ``latest`` link to the
newest version.  The port never imports JAX or Orbax, so it serves these
weights from a numpy export committed inside its package
(``distributed_llm_tpu_torch/weights/<preset>.npz``).  This script writes
that export: it restores the ``params`` subtree of the version ``latest``
names with ``orbax.checkpoint.PyTreeCheckpointer().restore`` and stores
every leaf as float32 (which holds bfloat16 exactly), with the preset and
the version beside the arrays.  The archive's bytes depend only on the
weights: the zip entries are stored uncompressed with a fixed date.

It needs Orbax and JAX, so it runs where the JAX package runs, never on
the card's machine:

    JAX_PLATFORMS=cpu python port_tools/export_checkpoints.py            # every preset with a checkpoint
    JAX_PLATFORMS=cpu python port_tools/export_checkpoints.py nano_test  # one
    python port_tools/export_checkpoints.py --out /tmp/exports nano_test

Run it again after retraining: the port's loader refuses an export whose
version is not the one ``latest`` names.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
import zipfile
from typing import Dict, Iterable, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = os.path.join(REPO, "checkpoints")
OUT_DIR = os.path.join(REPO, "distributed_llm_tpu_torch", "weights")
# A fixed zip date keeps the archive's bytes a function of its arrays.
_ZIP_DATE = (1980, 1, 1, 0, 0, 0)


def latest_version(root: str) -> str:
    """The version directory name ``<root>/latest`` points at."""
    return os.path.basename(os.path.normpath(
        os.readlink(os.path.join(root, "latest"))))


def restore_params(root: str) -> Dict[str, np.ndarray]:
    """The ``params`` subtree of ``root``'s latest version, flattened to
    ``embed``, ``final_ln`` and ``layers/<name>``, as float32 arrays."""
    import orbax.checkpoint as ocp

    state = os.path.join(os.path.abspath(root), latest_version(root), "state")
    params = ocp.PyTreeCheckpointer().restore(state)["params"]
    flat = {"embed": params["embed"], "final_ln": params["final_ln"]}
    flat.update({f"layers/{k}": v for k, v in params["layers"].items()})
    return {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}


def write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """An ``np.load``-able archive with stored entries in key order and a
    fixed date, so that the same arrays always give the same bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for key in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[key]),
                                      allow_pickle=False)
            zf.writestr(zipfile.ZipInfo(key + ".npy", _ZIP_DATE),
                        buf.getvalue())


def export(preset: str, out_dir: str = OUT_DIR,
           checkpoints: str = CHECKPOINTS) -> str:
    """Export ``checkpoints/<preset>`` to ``<out_dir>/<preset>.npz``."""
    root = os.path.join(checkpoints, preset)
    arrays = restore_params(root)
    arrays["preset"] = np.array(preset)
    arrays["version"] = np.array(latest_version(root))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{preset}.npz")
    write_npz(path, arrays)
    return path


def presets_with_checkpoints(checkpoints: str = CHECKPOINTS) -> List[str]:
    return sorted(d for d in os.listdir(checkpoints)
                  if os.path.islink(os.path.join(checkpoints, d, "latest")))


def main(argv: Iterable[str] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("presets", nargs="*",
                   help="presets to export (default: every checkpoint)")
    p.add_argument("--out", default=OUT_DIR,
                   help="output directory (default: the port's weights/)")
    args = p.parse_args(argv)
    for preset in args.presets or presets_with_checkpoints():
        path = export(preset, args.out)
        print(f"{preset}: {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
