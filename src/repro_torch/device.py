"""Device resolution for the PyTorch port.

Every entry point of ``repro_torch`` takes a ``device`` argument.  ``None``
means the CUDA card: the port is written for it, and a caller who wants
the CPU (the parity tests, a laptop) says so with ``device="cpu"``.  The
port never falls back to the CPU on its own, because a solve that silently
ran on the host would be reported as if it had run on the card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` a call runs on.

    ``None`` and ``"cuda"`` need a visible CUDA card and raise
    ``RuntimeError`` without one; ``"cpu"`` (or a ``torch.device``) is
    taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the host explicitly")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU), so a
    host clock read next times work done, not work queued."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
