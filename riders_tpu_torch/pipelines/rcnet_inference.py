"""Stage-2 inference: quasi-dense radar depth from RC-Net.

`make_rcnet_infer_fn` runs the staged path: full-image encode, per-point
patch decode, then the thresholded composition inside the bounded
threshold-decay retry (`ops.patches.adaptive_compose`).  The stem, the
RoI pool and every composition of the retry run as CUDA kernels on the
card (their plain versions on the CPU).  The frame's edge padding stays
on the host (`pad_image_for_patches`, a numpy pad).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import (check_model_device,
                                          resolve_device, to_device)
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.ops.patches import adaptive_compose


def pad_image_for_patches(image: np.ndarray,
                          patch_size: Tuple[int, int]) -> np.ndarray:
    """Edge-pad an (H, W, C) image by patch // 2 per side."""
    pad_y, pad_x = patch_size[0] // 2, patch_size[1] // 2
    return np.pad(image, ((pad_y, pad_y), (pad_x, pad_x), (0, 0)),
                  mode="edge")


def shift_points_and_boxes(points: torch.Tensor,
                           patch_size: Tuple[int, int]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift (u, v, z) points into padded-image coordinates and build the
    [x1, y1, x2, y2] patch boxes centred on them."""
    pad_y, pad_x = patch_size[0] // 2, patch_size[1] // 2
    u, v = points[..., 0] + pad_x, points[..., 1] + pad_y
    shifted = torch.stack([u, v, points[..., 2]], dim=-1)
    boxes = torch.stack([u - pad_x, v - pad_y, u + pad_x, v + pad_y], dim=-1)
    return shifted, boxes


def make_rcnet_infer_fn(cfg: RidersConfig, model: RCNet, device=None
                        ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Build fn(batch) on `device` (the card unless device='cpu'; without
    a card and without that request this raises).  The model is put in
    eval mode.

    batch (tensors or numpy arrays):
      image: (B, Hp, Wp, 3) EDGE-PADDED frames in the configured range;
      points: (B, K, 3) radar (u, v, z) in UNPADDED pixel coordinates;
      point_mask: (B, K).
    Returns 'depth' and 'response', (B, H, W) quasi-dense maps, and per
    frame the final 'threshold' and the number of 'retries'.
    """
    device = resolve_device(device)
    check_model_device("rcnet", model, device)
    model.eval()
    patch = cfg.rcnet.patch_size
    frame = cfg.dataset.image_shape
    dtype = next(model.parameters()).dtype
    rc = cfg.rcnet

    @torch.inference_mode()
    def infer(batch: Dict) -> Dict[str, torch.Tensor]:
        image = to_device(batch["image"], device).to(dtype)
        mask = to_device(batch["point_mask"], device).float().contiguous()
        points, boxes = shift_points_and_boxes(
            to_device(batch["points"], device).float(), patch)
        responses = model(image, points, boxes, mask, return_logits=False)
        responses = responses[..., 0].float().contiguous()
        depth, response, thr, retries = adaptive_compose(
            responses, points.contiguous(), mask, frame, patch,
            rc.response_threshold, rc.threshold_decay,
            rc.max_threshold_retries)
        return {"depth": depth, "response": response, "threshold": thr,
                "retries": retries}

    return infer
