"""Device selection: entry points run on the card unless asked otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present (the CPU is used only when the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain version"
        )
    return dev
