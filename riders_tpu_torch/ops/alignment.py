"""Stage-1 global alignment of a monocular depth prior to sparse radar.

Batched over frames: maps are (B, H, W) and each frame gets its own
scale (and shift).  The bounded scale-only L1 solve is a golden-section
search with a fixed iteration count, the same update rule (`fc < fd`)
and the same valid-pixel gather as the JAX package, so both converge to
the same point; on the card the search is one kernel
(`ops/kernels/golden_section.py`).  `scale_shift_ls` is the closed-form
scale and shift least squares; `scale_shift_ransac` fits it to random
5-pixel samples and keeps the hypothesis with the most inliers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from riders_tpu_torch.ops.kernels.golden_section import golden_section


def scale_shift_ls(prediction: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row least-squares scale and shift, min over (s, t) of
    sum(mask * (s * pred + t - target)^2), reducing every dim but the
    first: (B, ...) maps give (B,) scales and shifts.  A row whose normal
    matrix is not positive definite gets (0, 0)."""
    B = prediction.shape[0]
    p = prediction.float().reshape(B, -1)
    t = target.float().reshape(B, -1)
    m = mask.float().reshape(B, -1)
    a00 = torch.sum(m * p * p, dim=1)
    a01 = torch.sum(m * p, dim=1)
    a11 = torch.sum(m, dim=1)
    b0 = torch.sum(m * p * t, dim=1)
    b1 = torch.sum(m * t, dim=1)
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe, zero)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe, zero)
    return scale, shift


def scale_shift_ransac(prediction: torch.Tensor, target: torch.Tensor,
                       mask: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       gumbel=None, num_iterations: int = 60,
                       sample_size: int = 5,
                       inlier_threshold: float = 0.02
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RANSAC scale and shift of one frame (maps of any shape, N pixels).

    Every hypothesis draws `sample_size` valid pixels without replacement
    by Gumbel top-k (invalid pixels score -inf; ties go to the lower
    index, so a mask with fewer valid pixels fills its sample with the
    first invalid ones), fits `scale_shift_ls` to them, and counts the
    valid pixels within `inlier_threshold`; the first hypothesis with the
    most inliers wins.  The Gumbel noise, (num_iterations, N), is drawn
    from `generator` unless `gumbel` hands it in (numpy or tensor).
    Returns (scale, shift) as 0-dim tensors.
    """
    p = prediction.reshape(-1).float()
    t = target.reshape(-1).float()
    m = mask.reshape(-1).float()
    shape = (num_iterations, p.numel())
    if gumbel is None:
        expo = torch.empty(shape, device=p.device).exponential_(
            generator=generator)
        g = -torch.log(expo)
    else:
        if not isinstance(gumbel, torch.Tensor):
            gumbel = torch.tensor(gumbel)
        g = gumbel.to(device=p.device, dtype=torch.float32)
        if tuple(g.shape) != shape:
            raise ValueError(f"gumbel noise {tuple(g.shape)}, expected "
                             f"{shape}")
    scores = torch.where(m > 0, g, torch.full_like(g, float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :sample_size]
    ps, ts = p[idx], t[idx]
    scale, shift = scale_shift_ls(ps, ts, torch.ones_like(ps))
    residual = torch.abs(p * scale[:, None] + shift[:, None] - t)
    inliers = torch.sum((residual < inlier_threshold).float() * m, dim=1)
    best = torch.argmax(inliers)
    return scale[best], shift[best]


def optimize_scale(prediction: torch.Tensor,
                   target: torch.Tensor,
                   mask: torch.Tensor,
                   bounds: Tuple[float, float],
                   iterations: int = 64,
                   gather_bucket: int = 512,
                   max_valid: int | None = None) -> torch.Tensor:
    """Bounded scale-only solve per frame; returns (B,) scales.

    When `max_valid` bounds the valid pixels and fits `gather_bucket`,
    the objective runs on the `gather_bucket` pixels with the largest
    mask, lowest index first among ties (the order of JAX's top_k).
    """
    B = prediction.shape[0]
    p = prediction.float().reshape(B, -1)
    t = target.float().reshape(B, -1)
    m = mask.float().reshape(B, -1)
    gatherable = (gather_bucket and max_valid is not None
                  and max_valid <= gather_bucket
                  and p.shape[1] > 2 * gather_bucket)
    if gatherable:
        idx = torch.sort(m, dim=1, descending=True,
                         stable=True).indices[:, :gather_bucket]
        p, t, m = p.gather(1, idx), t.gather(1, idx), m.gather(1, idx)
    return golden_section(p.contiguous(), t.contiguous(), m.contiguous(),
                          bounds, iterations)


def clamp_inverse_depth(output: torch.Tensor,
                        clamp_min: float | None = None,
                        clamp_max: float | None = None) -> torch.Tensor:
    """depth >= clamp_min => inv <= 1/clamp_min (when clamp_min > 0);
    depth <= clamp_max => inv >= 1/clamp_max."""
    if clamp_min is not None and clamp_min > 0:
        output = torch.clamp(output, max=1.0 / clamp_min)
    if clamp_max is not None:
        output = torch.clamp(output, min=1.0 / clamp_max)
    return output


def validity_and_inverse(depth: torch.Tensor, min_depth: float,
                         max_depth: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validity window and guarded inversion: invalid entries map to 0.

    Returns (inverse_depth, valid mask as float32)."""
    valid = (depth < max_depth) & (depth > min_depth)
    safe = torch.where(valid, depth, torch.ones_like(depth))
    inv = torch.where(valid, 1.0 / safe, torch.zeros_like(depth))
    return inv, valid.float()


def align_mono_prior(mono_pred: torch.Tensor,
                     target_inv: torch.Tensor,
                     valid: torch.Tensor,
                     mode: str = "s",
                     mono_type: str = "inv",
                     bounds_inv: Tuple[float, float] = (0.01, 0.3),
                     bounds_pos: Tuple[float, float] = (0.5, 1.6),
                     iterations: int = 64,
                     min_pred: float | None = 0.1,
                     max_pred: float | None = 255.0,
                     max_valid: int | None = None) -> torch.Tensor:
    """Stage-1 alignment of (B, H, W) priors; returns the aligned,
    clamped inverse depth `int_depth`.  Mode 's' scales each prior by the
    bounded L1 solve, 'st' by the least-squares scale and shift."""
    if mode == "st":
        scale, shift = scale_shift_ls(mono_pred, target_inv, valid)
        out = mono_pred * scale[:, None, None] + shift[:, None, None]
    elif mode == "s":
        bounds = bounds_inv if mono_type == "inv" else bounds_pos
        scale = optimize_scale(mono_pred, target_inv, valid, bounds,
                               iterations, max_valid=max_valid)
        out = mono_pred * scale[:, None, None]
    else:
        raise ValueError(f"Unknown alignment mode: {mode}")
    return clamp_inverse_depth(out, min_pred, max_pred)
