"""Depth evaluation metrics.

The seven metrics of the evaluation protocol over the sparse-lidar
validity mask intersected with a (min_depth, max_depth) window: MAE,
RMSE, AbsRel and SqRel in millimetres (x1000), iMAE and iRMSE on the
kilometre-inverse scale (x0.001), and delta < 1.25.  The masked means
weight every pixel by the mask instead of indexing the valid ones, so a
batch of frames reduces in one pass with static shapes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

METRIC_KEYS = ("mae", "rmse", "imae", "irmse", "abs_rel", "sq_rel",
               "delta1")


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over mask per frame (the last two dims)."""
    denom = torch.clamp(mask.sum(dim=(-2, -1)), min=1.0)
    return (x * mask).sum(dim=(-2, -1)) / denom


def _safe(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask > 0, x, torch.ones_like(x))


def masked_mae(pred, target, mask):
    return _masked_mean(torch.abs(target - pred), mask)


def masked_rmse(pred, target, mask):
    return torch.sqrt(_masked_mean((target - pred) ** 2, mask))


def masked_imae(pred, target, mask):
    """Inverse-depth MAE; inputs are depths, the reciprocals guarded by
    the mask."""
    p, t = _safe(pred, mask), _safe(target, mask)
    return _masked_mean(torch.abs(1.0 / t - 1.0 / p), mask)


def masked_irmse(pred, target, mask):
    p, t = _safe(pred, mask), _safe(target, mask)
    return torch.sqrt(_masked_mean((1.0 / t - 1.0 / p) ** 2, mask))


def masked_abs_rel(pred, target, mask):
    return _masked_mean(torch.abs(pred - target) / _safe(target, mask), mask)


def masked_sq_rel(pred, target, mask):
    return _masked_mean((pred - target) ** 2 / _safe(target, mask), mask)


def masked_delta(pred, target, mask, thr: float = 1.25):
    p, t = _safe(pred, mask), _safe(target, mask)
    ratio = torch.maximum(t / p, p / t)
    return _masked_mean((ratio < thr).float(), mask)


def compute_depth_metrics(pred: torch.Tensor, gt_sparse: torch.Tensor,
                          min_depth: float, max_depth: float,
                          delta_threshold: float = 1.25
                          ) -> Dict[str, torch.Tensor]:
    """The metric bundle and `n_valid` of (H, W) or (B, H, W) depths in
    metres; each value is a scalar or (B,) tensor, one per frame.  The
    mask is gt > 0 within (min_depth, max_depth)."""
    pred, gt = pred.float(), gt_sparse.float()
    mask = ((gt > 0) & (gt > min_depth) & (gt < max_depth)).float()
    p_mm, t_mm = 1000.0 * pred, 1000.0 * gt
    p_km, t_km = 0.001 * pred, 0.001 * gt
    return {
        "mae": masked_mae(p_mm, t_mm, mask),
        "rmse": masked_rmse(p_mm, t_mm, mask),
        "imae": masked_imae(p_km, t_km, mask),
        "irmse": masked_irmse(p_km, t_km, mask),
        "abs_rel": masked_abs_rel(p_mm, t_mm, mask),
        "sq_rel": masked_sq_rel(p_mm, t_mm, mask),
        "delta1": masked_delta(pred, gt, mask, delta_threshold),
        "n_valid": mask.sum(dim=(-2, -1)),
    }


def improves_best(results: Mapping[str, float],
                  best: Mapping[str, float]) -> bool:
    """Best-results vote: more than 3 of the 7 metrics improve, each
    compared at 4 decimals (lower is better, delta1 higher)."""
    n = 0
    for k in METRIC_KEYS[:-1]:
        if round(float(results[k]), 4) < round(float(best[k]), 4):
            n += 1
    if round(float(results["delta1"]), 4) > round(float(best["delta1"]), 4):
        n += 1
    return n > 3
