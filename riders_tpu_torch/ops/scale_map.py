"""Scale-map synthesis for the Scale Map Learner input.

Every function works on a batch of frames: maps are (B, H, W) and each
frame is reduced over its own (H, W).
"""

from __future__ import annotations

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def normalize_unit_range(data: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) per frame of a (B, H, W) map; a constant
    frame (fewer than two observations) is returned unchanged instead of
    dividing by zero."""
    lo = data.amin(dim=(-2, -1), keepdim=True)
    hi = data.amax(dim=(-2, -1), keepdim=True)
    rng = hi - lo
    ok = rng > _EPS
    safe = torch.where(ok, rng, torch.ones_like(rng))
    return torch.where(ok, (data - lo) / safe, data)


def synthesize_scale_map(int_depth: torch.Tensor,
                         sparse_inv: torch.Tensor,
                         sparse_valid: torch.Tensor,
                         rcnet_inv: torch.Tensor | None = None,
                         rcnet_valid: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Per-pixel observed / prior scale ratios.

    Ones everywhere; rcnet / int_depth where the quasi-dense map is valid;
    radar / int_depth where raw radar is valid; then unit-range
    normalized per frame.
    """
    scales = torch.ones_like(int_depth)
    if rcnet_inv is not None:
        scales = torch.where(rcnet_valid.bool(), rcnet_inv / int_depth,
                             scales)
    scales = torch.where(sparse_valid.bool(), sparse_inv / int_depth, scales)
    return normalize_unit_range(scales)


def grayscale(image: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of (..., 3) RGB: 0.299 R + 0.587 G + 0.114 B."""
    r, g, b = image.unbind(-1)
    return 0.299 * r + 0.587 * g + 0.114 * b


def normalize_intermediate(int_depth: torch.Tensor,
                           int_scales: torch.Tensor,
                           depth_mean: float = 0.729,
                           depth_std: float = 0.210,
                           scales_mean: float = 0.404,
                           scales_std: float = 0.117):
    """Channel standardization of the SML intermediate inputs."""
    d = (int_depth - depth_mean) / depth_std
    s = (int_scales - scales_mean) / scales_std
    return d, s
