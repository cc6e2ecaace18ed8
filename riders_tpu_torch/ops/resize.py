"""2-D resampling with torch / OpenCV semantics.

* ``nearest``: source index floor(i * in / out), computed in integers.
  F.interpolate's float scale can pick another row at the irregular
  sizes of the NTU decoder (latent (4, 1) -> (9, 3) -> ... -> (150, 50)).
* ``bilinear`` with and without align_corners, and ``bicubic``
  (A = -0.75, border-clamped taps, align_corners=False), in float32.

`resize2d` and `edge_pad2d` take NHWC arrays like the JAX package;
`resize_nchw` is the same resampling on the NCHW tensors the models use
internally.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize2d", "resize_nchw", "edge_pad2d", "compute_net_shape",
           "nearest_indices"]


def compute_net_shape(image_shape: Tuple[int, int],
                      target: int = 288,
                      multiple_of: int = 32,
                      method: str = "minimal") -> Tuple[int, int]:
    """Aspect-keeping, multiple-of-32 network input size for a frame.

    'minimal' picks the axis whose scale is closest to 1; 'lower_bound'
    keeps both axes >= target; 'upper_bound' keeps both <= target.
    E.g. 480x640 -> (288, 384); 512x640 -> (288, 352).
    """
    h, w = image_shape
    scale_h = target / h
    scale_w = target / w
    if method == "minimal":
        scale = scale_w if abs(1 - scale_w) < abs(1 - scale_h) else scale_h
        sh = sw = scale
    elif method == "lower_bound":
        sh = sw = max(scale_h, scale_w)
    elif method == "upper_bound":
        sh = sw = min(scale_h, scale_w)
    else:
        raise ValueError(method)

    def constrain(x, min_val=None, max_val=None):
        y = int(np.round(x / multiple_of) * multiple_of)
        if max_val is not None and y > max_val:
            y = int(np.floor(x / multiple_of) * multiple_of)
        if min_val is not None and y < min_val:
            y = int(np.ceil(x / multiple_of) * multiple_of)
        return y

    min_val = target if method == "lower_bound" else None
    max_val = target if method == "upper_bound" else None
    return (constrain(sh * h, min_val, max_val),
            constrain(sw * w, min_val, max_val))


def nearest_indices(in_size: int, out_size: int,
                    device=None) -> torch.Tensor:
    """floor(i * in / out) for i < out, in integer arithmetic."""
    return (torch.arange(out_size, device=device) * in_size) // out_size


def resize_nchw(x: torch.Tensor, out_shape: Tuple[int, int],
                method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of an (N, C, H, W) tensor."""
    h, w = x.shape[-2:]
    h2, w2 = out_shape
    if (h, w) == (h2, w2):
        return x
    if method == "nearest":
        if h != h2:
            x = x.index_select(-2, nearest_indices(h, h2, x.device))
        if w != w2:
            x = x.index_select(-1, nearest_indices(w, w2, x.device))
        return x
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"Unknown resize method: {method}")
    out = F.interpolate(x.float(), size=(h2, w2), mode=method,
                        align_corners=align_corners)
    return out.to(x.dtype)


def resize2d(x: torch.Tensor, out_shape: Tuple[int, int],
             method: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the (-3, -2) spatial axes of an (..., H, W, C) tensor."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x4 = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    out = resize_nchw(x4, out_shape, method, align_corners)
    return out.permute(0, 2, 3, 1).reshape(lead + tuple(out_shape) + (c,))


def edge_pad2d(image: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """Edge-pad (B, H, W, C) by (pad_y, pad_x) per side."""
    x = image.permute(0, 3, 1, 2)
    x = F.pad(x, (pad_x, pad_x, pad_y, pad_y), mode="replicate")
    return x.permute(0, 2, 3, 1)
