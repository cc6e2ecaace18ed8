"""Device selection: the card by default, the CPU only on request."""

from __future__ import annotations

import numpy as np
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


def check_model_device(name: str, model: torch.nn.Module,
                       device: torch.device) -> None:
    """Raise unless `model`'s weights live on `device`'s type."""
    where = next(model.parameters()).device
    if where.type != device.type:
        raise ValueError(f"{name} lives on {where}, not on {device}")


def to_device(x, device: torch.device, pinned: bool = False
              ) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`.  With `pinned`, a
    copy to a card goes through pinned host memory and is queued on the
    current stream without blocking the host."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if pinned and device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)
