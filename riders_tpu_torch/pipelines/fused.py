"""Fused three-stage inference: radar points -> metric depth.

  edge-pad frame -> RC-Net (full-image encode, K-patch decode) ->
  closed-form adaptive threshold -> patch composition (quasi-dense radar
  depth) -> raw-radar scatter -> bounded scale alignment of the mono
  prior -> scale-map synthesis -> SML forward -> bicubic upsample of
  1 / pred -> dense metric depth

The stem, the RoI pool and the composition run as CUDA kernels on the
card (their plain versions on the CPU); the rest is PyTorch.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import (check_model_device,
                                          resolve_device, to_device)
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.ops.kernels.compose import compose_patches
from riders_tpu_torch.ops.patches import adaptive_threshold_value
from riders_tpu_torch.ops.resize import edge_pad2d, resize2d
from riders_tpu_torch.pipelines.rcnet_inference import shift_points_and_boxes
from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs


def _scatter_points(points: torch.Tensor, mask: torch.Tensor,
                    shape) -> torch.Tensor:
    """Scatter (B, K, 3) (u, v, z) points to sparse (B, H, W) depth maps;
    u, v truncate toward zero and clamp to the frame."""
    H, W = shape
    B, K = mask.shape
    u = points[..., 0].to(torch.int64).clamp(0, W - 1)
    v = points[..., 1].to(torch.int64).clamp(0, H - 1)
    z = points[..., 2] * mask
    bi = torch.arange(B, device=points.device)[:, None].expand(B, K)
    out = torch.zeros((B, H, W), dtype=torch.float32, device=points.device)
    return out.index_put_((bi, v, u), z.float())


def make_fused_fn(cfg: RidersConfig, rcnet: RCNet, sml: ScaleMapLearner,
                  device=None) -> Callable[[Dict], torch.Tensor]:
    """Build fn(batch) -> (B, H, W) metric depth on `device` (the card
    unless device='cpu'; without a card and without that request this
    raises).

    batch:
      image: (B, H, W, 3) frames in [0, 1], or uint8 (decoded x / 255);
      mono_pred: (B, H, W) relative inverse-depth prior, or uint16 PNG16
        codes (decoded x / 256);
      radar_points: (B, K, 3) (u, v, z) in unpadded pixel coordinates;
      point_mask: (B, K).
    Tensors or numpy arrays; they are moved to the device.
    """
    device = resolve_device(device)
    check_model_device("rcnet", rcnet, device)
    check_model_device("sml", sml, device)
    patch = cfg.rcnet.patch_size
    H, W = cfg.dataset.image_shape
    pad_y, pad_x = patch[0] // 2, patch[1] // 2
    rc_dtype = next(rcnet.parameters()).dtype
    sml_dtype = next(sml.parameters()).dtype

    as_tensor = lambda x: to_device(x, device)

    @torch.inference_mode()
    def fused(batch: Dict) -> torch.Tensor:
        image = as_tensor(batch["image"])
        if image.dtype == torch.uint8:
            image = image.float() * (1.0 / 255.0)
        mono = as_tensor(batch["mono_pred"])
        if mono.dtype == torch.uint16:
            # through int16 bits: CUDA's uint16 support is bare
            codes = mono.view(torch.int16).int() & 0xFFFF
            mono = codes.float() * (1.0 / 256.0)
        radar_points = as_tensor(batch["radar_points"]).float()
        mask = as_tensor(batch["point_mask"]).float().contiguous()

        padded = edge_pad2d(image.to(rc_dtype), pad_y, pad_x)
        points, boxes = shift_points_and_boxes(radar_points, patch)
        responses = rcnet(padded, points, boxes, mask,
                          return_logits=False)[..., 0].float().contiguous()

        if cfg.rcnet.adaptive_composition:
            thr = adaptive_threshold_value(
                responses, mask, cfg.rcnet.response_threshold,
                cfg.rcnet.threshold_decay, cfg.rcnet.max_threshold_retries)
        else:
            thr = cfg.rcnet.response_threshold
        quasi_depth, _ = compose_patches(responses, points.contiguous(),
                                         mask, (H, W), patch, thr)

        # Raw radar returns on the frame grid: the alignment target.
        radar_sparse = _scatter_points(radar_points, mask, (H, W))
        x, d = prepare_sml_inputs(cfg, image, mono, radar_sparse,
                                  quasi_depth)
        pred_inv, _ = sml(x.to(sml_dtype), d)
        return resize2d(1.0 / pred_inv, (H, W), "bicubic",
                        align_corners=False)[..., 0]

    return fused
