"""Training losses: masked regression, Sobel smoothness / edge matching,
the SML loss and the positive-weighted BCE of RC-Net.

Every loss is a mask-weighted reduction (no boolean indexing, so no
data-dependent shapes).  Maps keep the JAX package's NHWC layout at
these functions: (N, H, W, 1) for depth-like maps.  The batch
reductions - the sums and means over the batch and the batch-wide
median - go through `parallel.sharding`'s `batch_sum`, `batch_mean` and
`batch_gather`, which span every rank's part of the global batch inside
a sharded training step.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from riders_tpu_torch.parallel.sharding import (batch_gather, batch_mean,
                                                batch_sum)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; torch.abs gives 0 there).  It
    matters wherever a map is flat, e.g. where the SML prediction sits at
    its clamp, so the Sobel terms see exact zeros."""
    return torch.where(x >= 0, x, -x)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return batch_sum(x * mask) / torch.clamp(batch_sum(mask), min=1.0)


def l1_loss(pred, target, mask):
    return masked_mean(_abs(pred - target), mask)


def l2_loss(pred, target, mask):
    return masked_mean((pred - target) ** 2, mask)


def smooth_l1_loss(pred, target, mask, beta: float = 1.0):
    """Huber / smooth-L1 with torch's default beta = 1."""
    diff = _abs(pred - target)
    val = torch.where(diff < beta, 0.5 * diff * diff / beta,
                      diff - 0.5 * beta)
    return masked_mean(val, mask)


_LOSS_FNS = {"l1": l1_loss, "l2": l2_loss, "smoothl1": smooth_l1_loss}


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask as torch.median takes it (the lower middle
    element): masked-out entries sort last as +inf and the element at
    (count - 1) // 2 is picked (index 0, +inf, for an empty mask).  Inside
    a sharded step it is the global batch's median: every rank's part is
    gathered in rank order, which is the batch's own order."""
    x, mask = batch_gather(x, mask)
    flat = x.reshape(-1)
    m = mask.reshape(-1) > 0
    n = torch.sum(m.to(torch.int64))
    s = torch.sort(torch.where(m, flat, torch.full_like(flat, np.inf)))[0]
    return s[torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)]


def sobel_filters(size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Handcrafted size x size Sobel-style gradient filters (gx, gy)."""
    gx = np.ones((size, size), np.float32)
    gy = np.ones((size, size), np.float32)
    c = size // 2
    gx[:, c] = 0.0
    gx[c, c - 1] = 2.0
    gx[c, c + 1] = 2.0
    gx[:, c:] = -gx[:, c:]
    gy[c, :] = 0.0
    gy[c - 1, c] = 2.0
    gy[c + 1, c] = 2.0
    gy[c + 1:, :] = -gy[c + 1:, :]
    return gx, gy


def _filtered(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Edge-replicate pad by half the kernel, then a VALID correlation
    with one 2-D kernel: (N, 1, H, W) -> (N, 1, H, W).

    Summed tap by tap rather than by a library convolution: on a flat
    region every partial sum is an exact multiple of the value, so the
    filter gives exactly 0 there, as XLA's convolution does, and the
    Sobel terms' |.| takes JAX's derivative at 0 (a transform-based
    convolution leaves noise of either sign instead)."""
    n = kernel.shape[0]
    p = n // 2
    H, W = x.shape[-2:]
    xp = F.pad(x, (p, p, p, p), mode="replicate")
    out = None
    for i in range(n):
        for j in range(n):
            if kernel[i, j] != 0:
                term = float(kernel[i, j]) * xp[..., i:i + H, j:j + W]
                out = term if out is None else out + term
    return out


def sobel_smoothness_loss(predict: torch.Tensor, image: torch.Tensor,
                          weights: torch.Tensor, filter_size: int = 7
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-aware smoothness and edge-matching losses.

    predict (N, H, W, 1) depth; image (N, H, W, C) guidance, C = 1 or an
    RGB image reduced to luma; weights (N, H, W, 1).  Returns
    (smoothness, edge_matching) scalars."""
    if image.shape[-1] == 3:
        r, g, b = image.unbind(-1)
        image = (0.299 * r + 0.587 * g + 0.114 * b)[..., None]
    nchw = lambda t: t.permute(0, 3, 1, 2)
    image, predict, weights = nchw(image), nchw(predict), nchw(weights)
    gx, gy = sobel_filters(filter_size)
    gxs, gys = sobel_filters(3)

    image_dy = _filtered(image, gy)
    image_dx = _filtered(image, gx)
    predict_dy = _filtered(predict, gy)
    predict_dx = _filtered(predict, gx)
    # Edge-aware weights from the small-filter gradients.
    weights_x = torch.exp(-torch.abs(_filtered(image, gys)))
    weights_y = torch.exp(-torch.abs(_filtered(image, gxs)))

    area = float(filter_size * filter_size)
    smoothness_x = batch_mean(weights * weights_x * _abs(predict_dx))
    smoothness_y = batch_mean(weights * weights_y * _abs(predict_dy))
    smoothness = (smoothness_x + smoothness_y) / area
    loss_dx = batch_mean(weights * _abs(_abs(predict_dx) - _abs(image_dx)))
    loss_dy = batch_mean(weights * _abs(_abs(predict_dy) - _abs(image_dy)))
    return smoothness, (loss_dx + loss_dy) / area


def sml_loss(image: torch.Tensor,
             output_depth: Union[torch.Tensor, Sequence[torch.Tensor]],
             gt_interp: torch.Tensor,
             gt_sparse: torch.Tensor,
             loss_func: str = "l1",
             w_smoothness: float = 0.2,
             sobel_filter_size: int = 7,
             validity_map_loss_smoothness: torch.Tensor | None = None,
             w_lidar_loss: float = 1.5,
             w_edge: float = 0.0,
             invalid_map_gt: torch.Tensor | None = None,
             w_unsupervised: float = 0.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-3 training loss over (N, H, W, 1) maps; `output_depth` may be
    a deep-to-shallow list of scales, weighted 1 / 2^(n - 1 - i).
    `image` is the guidance channel (the aligned input depth)."""
    fn = _LOSS_FNS[loss_func]
    if w_lidar_loss > 0.0:
        # no double counting where sparse lidar exists
        gt_interp = gt_interp * (gt_sparse <= 0.0).to(gt_interp.dtype)
    valid_gt = (gt_interp > 0).float()
    valid_lidar = (gt_sparse > 0).float()
    outputs = (list(output_depth) if isinstance(output_depth, (list, tuple))
               else [output_depth])
    n_scales = len(outputs)
    if validity_map_loss_smoothness is None:
        validity_map_loss_smoothness = torch.ones_like(gt_interp)

    zero = torch.zeros((), dtype=torch.float32, device=gt_interp.device)
    loss_supervised = loss_lidar = loss_smoothness = zero
    loss_edge = loss_unsupervised = zero
    for scale, output in enumerate(outputs):
        w_scale = 1.0 / (2 ** (n_scales - scale - 1))
        loss_supervised = loss_supervised + w_scale * fn(output, gt_interp,
                                                         valid_gt)
        if w_lidar_loss > 0.0:
            loss_lidar = loss_lidar + w_scale * fn(output, gt_sparse,
                                                   valid_lidar)
        if w_unsupervised > 0.0 and invalid_map_gt is not None:
            inv_mask = invalid_map_gt.float()
            om = masked_median(output, inv_mask)
            im = masked_median(image, inv_mask)
            loss_unsupervised = loss_unsupervised + w_scale * fn(
                output / om, image / im, inv_mask)
        if w_smoothness > 0.0 or w_edge > 0.0:
            sm, ed = sobel_smoothness_loss(output, image,
                                           validity_map_loss_smoothness,
                                           sobel_filter_size)
            loss_smoothness = loss_smoothness + w_scale * sm
            loss_edge = loss_edge + w_scale * ed

    loss = (loss_supervised + w_lidar_loss * loss_lidar
            + w_smoothness * loss_smoothness + w_edge * loss_edge
            + w_unsupervised * loss_unsupervised)
    return loss, {
        "loss": loss,
        "loss_supervised": loss_supervised,
        "loss_lidar": loss_lidar,
        "loss_smoothness": loss_smoothness,
        "loss_edge": loss_edge,
        "loss_unsupervised": loss_unsupervised,
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it (no linear cut-off
    above a threshold, unlike F.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             validity_map: torch.Tensor,
                             w_positive_class: float = 1.0) -> torch.Tensor:
    """Positive-class-weighted BCE over a validity mask, in the stable
    form pw * y * softplus(-x) + (1 - y) * softplus(x)."""
    x, y = logits, targets
    per_elem = (w_positive_class * y * softplus(-x)
                + (1.0 - y) * softplus(x))
    return batch_sum(validity_map * per_elem) / batch_sum(validity_map)
