"""Device selection for the port's entry points.

Every entry point (engine, manager, ``/query`` app) runs on the card by
default.  With no GPU it raises unless the caller asked for the CPU,
which takes the plain PyTorch versions of the kernels (the tests do).

A program written against the reference's bare modules
(``reference_compat/``) builds its ``Router`` with no device;
``set_default_device("cpu")`` runs such a program on the CPU, the port's
counterpart of ``jax.config.update("jax_platforms", "cpu")``.  No
environment variable picks the device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

_default_device: Optional[torch.device] = None


def set_default_device(device: DeviceLike) -> None:
    """The device ``resolve_device(None)`` names from now on in this
    process; ``None`` gives the card back."""
    global _default_device
    _default_device = None if device is None else torch.device(device)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the default device (``set_default_device``), else
    the current CUDA device; a CUDA request with no card raises instead
    of falling back to the CPU."""
    if device is None:
        device = _default_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
