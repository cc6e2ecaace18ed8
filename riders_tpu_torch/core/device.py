"""Device selection: the card by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the first CUDA device; raise when there is none.

    The CPU is used only when the caller names it, so a host without a
    card never runs the fused path on the CPU by accident.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is unavailable")
    return device
