"""Stage-1 inputs of the Scale Map Learner and staged stage-3 inference,
batched over frames.

`make_infer_fn` runs validity / inversion -> bounded scale alignment ->
clamp -> scale-map synthesis -> resize to the network shape ->
normalisation -> SML forward -> bicubic upsample of 1 / pred, and the
per-frame depth metrics when the batch carries the sparse lidar GT.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from riders_tpu_torch.core import metrics as metrics_lib
from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import (check_model_device,
                                          resolve_device, to_device)
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.ops import alignment, interp, scale_map
from riders_tpu_torch.ops.resize import resize2d, resize_nchw


def prepare_sml_inputs(cfg: RidersConfig, image: torch.Tensor,
                       mono_pred: torch.Tensor, radar: torch.Tensor,
                       rcnet: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, d) network inputs for B frames.

    image: (B, H, W, 3) in [0, 1]; mono_pred: (B, H, W) relative inverse
    depth prior; radar: (B, H, W) sparse radar depth in metres (0 = no
    return); rcnet: (B, H, W) quasi-dense stage-2 depth in metres, or
    None for the sources that read no stage-2 map, by
    sml_train.rcnet_interp: 'interp' densifies the radar knots' scales
    by IDW on the device (`interp.idw_scale_map`), 'interp-exact' by
    scipy griddata on the host (`interp.exact_scale_map`), any other
    ('none') takes the raw radar knots alone.  Returns x (B, net_h,
    net_w, 3) = normalized (int_depth, int_scales, gray) and d (B, net_h,
    net_w, 1), the aligned inverse depth.
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
    elif cfg.sml_train.rcnet_interp in ("interp", "interp-exact"):
        densify = (interp.exact_scale_map
                   if cfg.sml_train.rcnet_interp == "interp-exact"
                   else interp.idw_scale_map)
        dense = densify(int_depth, radar_inv, radar_valid)
        # the raw radar knots keep their own ratios
        scales = torch.where(radar_valid.bool(), radar_inv / int_depth,
                             dense)
        scales = scale_map.normalize_unit_range(scales)
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


def make_infer_fn(cfg: RidersConfig, model: ScaleMapLearner,
                  with_metrics: bool = True, device=None
                  ) -> Callable[[Dict], Dict]:
    """Build fn(batch) on `device` (the card unless device='cpu'; without
    a card and without that request this raises).  The model is put in
    eval mode.

    batch (tensors or numpy arrays): image (B, H, W, 3) in [0, 1];
    mono_pred, radar (B, H, W); rcnet (B, H, W), read only when
    sml_train.rcnet_interp names an 'rcnet' source; gt_sparse (B, H, W),
    optional.  Returns 'depth' (B, H, W) metric depth at frame
    resolution, 'int_depth' (B, net_h, net_w) the aligned inverse depth,
    'scales' (B, net_h, net_w, 1), and, when `with_metrics` and the batch
    carries 'gt_sparse', 'metrics': the per-frame metric bundle.
    """
    device = resolve_device(device)
    check_model_device("sml", model, device)
    model.eval()
    frame = cfg.dataset.image_shape
    dtype = next(model.parameters()).dtype
    use_rcnet = "rcnet" in (cfg.sml_train.rcnet_interp or "")
    ev = cfg.eval

    @torch.inference_mode()
    def infer(batch: Dict) -> Dict:
        get = lambda k: to_device(batch[k], device).float()
        rcnet = get("rcnet") if use_rcnet and "rcnet" in batch else None
        x, d = prepare_sml_inputs(cfg, get("image"), get("mono_pred"),
                                  get("radar"), rcnet)
        pred_inv, scales = model(x.to(dtype), d)
        depth = resize2d(1.0 / pred_inv, frame, "bicubic",
                         align_corners=False)[..., 0]
        out = {"depth": depth, "int_depth": d[..., 0], "scales": scales}
        if with_metrics and "gt_sparse" in batch:
            out["metrics"] = metrics_lib.compute_depth_metrics(
                depth, get("gt_sparse"), ev.min_depth_val,
                ev.max_depth_val, ev.delta_threshold)
        return out

    return infer
