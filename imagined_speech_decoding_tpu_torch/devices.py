"""Device choice of the port's entry points: what the caller names, never a fallback."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``. A CUDA device raises
    ``RuntimeError`` when no card is visible: the entry points run on the
    card unless the caller passes ``device="cpu"``, and never move to the
    CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
