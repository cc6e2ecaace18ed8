"""Stage-2 helpers: radar points and their patch boxes."""

from __future__ import annotations

from typing import Tuple

import torch


def shift_points_and_boxes(points: torch.Tensor,
                           patch_size: Tuple[int, int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift (u, v, z) points into padded-image coordinates and build the
    [x1, y1, x2, y2] patch boxes centred on them."""
    pad_y, pad_x = patch_size[0] // 2, patch_size[1] // 2
    offset = torch.tensor([pad_x, pad_y, 0.0], dtype=points.dtype,
                          device=points.device)
    shifted = points + offset
    u, v = shifted[..., 0], shifted[..., 1]
    boxes = torch.stack([u - pad_x, v - pad_y, u + pad_x, v + pad_y], dim=-1)
    return shifted, boxes
