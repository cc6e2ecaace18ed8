"""Stage-1 inputs of the Scale Map Learner, batched over frames."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.ops import alignment, scale_map
from riders_tpu_torch.ops.resize import resize_nchw


def prepare_sml_inputs(cfg: RidersConfig, image: torch.Tensor,
                       mono_pred: torch.Tensor, radar: torch.Tensor,
                       rcnet: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, d) network inputs for B frames.

    image: (B, H, W, 3) in [0, 1]; mono_pred: (B, H, W) relative inverse
    depth prior; radar: (B, H, W) sparse radar depth in metres (0 = no
    return); rcnet: (B, H, W) quasi-dense stage-2 depth in metres, or
    None to synthesize the scale map from the raw radar knots alone
    (sml_train.rcnet_interp 'none'; the 'interp' densifiers are not
    ported).  Returns x (B, net_h, net_w, 3) = normalized (int_depth,
    int_scales, gray) and d (B, net_h, net_w, 1), the aligned inverse
    depth.
    """
    a = cfg.alignment
    net_shape = cfg.sml.net_shape
    radar_inv, radar_valid = alignment.validity_and_inverse(
        radar, a.min_depth, a.max_depth)
    int_depth = alignment.align_mono_prior(
        mono_pred, radar_inv, radar_valid, mode=a.mode,
        mono_type=a.mono_type, bounds_inv=a.bounds_inv,
        bounds_pos=a.bounds_pos, iterations=a.iterations,
        min_pred=a.min_pred, max_pred=a.max_pred,
        max_valid=a.max_valid_pixels)
    if rcnet is not None:
        rcnet_inv, rcnet_valid = alignment.validity_and_inverse(
            rcnet, a.min_depth, a.max_depth)
        scales = scale_map.synthesize_scale_map(
            int_depth, radar_inv, radar_valid, rcnet_inv, rcnet_valid)
    elif cfg.sml_train.rcnet_interp.startswith("interp"):
        raise NotImplementedError(
            f"scale-map source {cfg.sml_train.rcnet_interp!r} is not ported")
    else:
        scales = scale_map.synthesize_scale_map(int_depth, radar_inv,
                                                radar_valid)

    # Nearest resize to the network shape; the luma reduction commutes
    # with it, so it runs first.
    maps = torch.stack([int_depth, scales, scale_map.grayscale(image)], 1)
    d_net, s_net, gray = resize_nchw(maps, net_shape, "nearest").unbind(1)
    dn, sn = scale_map.normalize_intermediate(
        d_net, s_net, cfg.sml.int_depth_mean, cfg.sml.int_depth_std,
        cfg.sml.int_scales_mean, cfg.sml.int_scales_std)
    return torch.stack([dn, sn, gray], dim=-1), d_net[..., None]
