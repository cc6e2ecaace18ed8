"""Sparse-depth hygiene: outlier removal and max dilation of ground
truth, on the last two axes of an (..., H, W) array."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool_max(x: torch.Tensor, kernel_size: int, fill) -> torch.Tensor:
    """Stride-1 max over kernel_size windows of the last two axes, after
    a constant pad of kernel_size // 2 with `fill` (a number or a 0-d
    tensor, so the card needs no sync to read it)."""
    pad = (kernel_size // 2,) * 4
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    inside = F.pad(torch.ones_like(x4, dtype=torch.bool), pad)
    x4 = torch.where(inside, F.pad(x4, pad),
                     torch.as_tensor(fill, dtype=x.dtype, device=x.device))
    out = F.max_pool2d(x4, kernel_size, stride=1)
    return out.reshape(lead + out.shape[-2:])


def remove_outliers(depth: torch.Tensor, kernel_size: int = 7,
                    threshold: float = 1.5) -> torch.Tensor:
    """Drop measurements more than `threshold` metres above their local
    minimum.  Holes (zeros) and the border are filled with 10 * the
    array's max before the min-filter, so they never win."""
    max_value = 10.0 * torch.max(depth)
    filled = torch.where(depth > 0.0, depth, max_value)
    min_values = -_pool_max(-filled, kernel_size, -max_value)
    keep = min_values >= depth - threshold
    return torch.where(keep, depth, torch.zeros_like(depth))


def dilate_max(depth: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Max-pool dilation, stride 1, 'same' padding."""
    if kernel_size <= 1:
        return depth
    return _pool_max(depth, kernel_size, float("-inf"))
