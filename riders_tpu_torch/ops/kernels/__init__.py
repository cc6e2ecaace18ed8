"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in `LAUNCHES`; for CPU tensors it runs the kernel's plain PyTorch
version, which sits beside it.  A CUDA tensor never falls back to the
plain version: it goes to the kernel or raises.
"""

from collections import Counter

import torch

# launches per kernel name; reset with LAUNCHES.clear()
LAUNCHES: Counter = Counter()


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on a CUDA device; raises on a mix or on another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on unsupported or mixed devices: {kinds}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape=None) -> None:
    """Raise unless `t` has the dtype, is contiguous and, where `shape`
    is given, matches it (None entries match any size)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (
            t.dim() != len(shape)
            or any(s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
