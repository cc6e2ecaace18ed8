"""Fixed-size RoI max pooling and patch composition, in plain PyTorch.

These are the plain versions of the port's RoI pool (forward and
backward) and composition CUDA kernels (ops/kernels/roi_pool.py,
ops/kernels/compose.py): the kernel wrappers use them for tensors on the
CPU, and the card holds the kernels against them.  All are batched over
frames (B) and radar points (K).

RoI pooling follows torchvision's `roi_pool` on the JAX package's terms:
box edges round half away from zero, floor(x * s + 0.5); the roi size is
end - start + 1 (at least 1); the window starts at the rounded start
clamped to [0, H]; bin p spans [floor(p * roi / out),
ceil((p + 1) * roi / out)) from there, clamped to the map, in exact
integer arithmetic; an empty bin gives 0.

Composition thresholds each response patch, pastes it at the clipped
(round(v) - ph/2, round(u) - pw/2) of the padded canvas (round half to
even), and accumulates max r, sum r and sum r*z in ascending k.
`adaptive_compose` runs the staged path's threshold-decay retry around
a composition.
"""

from __future__ import annotations

import numbers
from typing import Callable, List, Optional, Sequence, Tuple

import torch


def _bin_bounds(start: torch.Tensor, end: torch.Tensor, limit: int,
                out_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) bounds of the out_n bins of each box along one axis,
    clamped to [0, limit]; start/end are the rounded box edges."""
    roi = torch.clamp(end - start + 1, min=1)[..., None]
    s = torch.clamp(start, 0, limit)[..., None]
    p = torch.arange(out_n, device=start.device)
    lo = s + (p * roi) // out_n
    hi = s + ((p + 1) * roi + out_n - 1) // out_n
    return lo.clamp(max=limit), hi.clamp(max=limit)


def _roi_bounds(boxes: torch.Tensor, scale: float, H: int, W: int,
                out_size: Tuple[int, int]):
    """Row and column bin bounds of (B, K, 4) [x1, y1, x2, y2] boxes:
    (lo_h, hi_h) of shape (B, K, out_h) and (lo_w, hi_w) of (B, K, out_w).
    """
    b = boxes.float()
    r = lambda v: torch.floor(v * scale + 0.5).long()
    lo_h, hi_h = _bin_bounds(r(b[..., 1]), r(b[..., 3]), H, out_size[0])
    lo_w, hi_w = _bin_bounds(r(b[..., 0]), r(b[..., 2]), W, out_size[1])
    return lo_h, hi_h, lo_w, hi_w


def roi_max_pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """RoI max pool of K boxes per frame.

    feature: (B, H, W, C); boxes: (B, K, 4) in input-image pixels;
    scale: feature stride reciprocal.  Returns (B, K, out_h, out_w, C).
    """
    B, H, W, C = feature.shape
    lo_h, hi_h, lo_w, hi_w = _roi_bounds(boxes, scale, H, W, out_size)
    th = int((hi_h - lo_h).max().clamp(min=1))
    tw = int((hi_w - lo_w).max().clamp(min=1))
    bi = torch.arange(B, device=feature.device)[:, None, None, None]
    neg = torch.tensor(float("-inf"), dtype=feature.dtype,
                       device=feature.device)
    out = None
    for i in range(th):
        rows = lo_h + i
        ok_r = rows < hi_h
        rows = rows.clamp(max=H - 1)[:, :, :, None]
        for j in range(tw):
            cols = lo_w + j
            ok = ok_r[:, :, :, None] & (cols < hi_w)[:, :, None, :]
            cols = cols.clamp(max=W - 1)[:, :, None, :]
            v = torch.where(ok[..., None], feature[bi, rows, cols], neg)
            out = v if out is None else torch.maximum(out, v)
    return torch.where(out == neg, torch.zeros_like(out), out)


def roi_max_pool_backward(feature: torch.Tensor, boxes: torch.Tensor,
                          pooled: torch.Tensor, grad: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """d(feature) of `roi_max_pool`, applied to the cotangent `grad`.

    feature (B, H, W, C); boxes (B, K, 4); pooled, grad (B, K, out_h,
    out_w, C), `pooled` being the forward's output on these inputs.
    Every bin sends its cotangent to every element of its window that
    equals the bin's max (tied elements each receive it in full, unlike
    autograd of a max chain, which splits it); empty bins send nothing;
    overlapping bins and boxes sum.  Returns feature's shape in f32 (f64
    for an f64 `grad`, which the card's kernel checks use as reference).
    """
    B, H, W, C = feature.shape
    out_size = tuple(pooled.shape[2:4])
    lo_h, hi_h, lo_w, hi_w = _roi_bounds(boxes, scale, H, W, out_size)
    th = int((hi_h - lo_h).max().clamp(min=1))
    tw = int((hi_w - lo_w).max().clamp(min=1))
    bi = torch.arange(B, device=feature.device)[:, None, None, None]
    grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
    dfeat = torch.zeros((B * H * W, C), dtype=grad.dtype,
                        device=feature.device)
    for i in range(th):
        rows = lo_h + i
        ok_r = rows < hi_h
        rows = rows.clamp(max=H - 1)[:, :, :, None]
        for j in range(tw):
            cols = lo_w + j
            ok = ok_r[:, :, :, None] & (cols < hi_w)[:, :, None, :]
            cols = cols.clamp(max=W - 1)[:, :, None, :]
            hit = ok[..., None] & (feature[bi, rows, cols] == pooled)
            flat = ((bi * H + rows) * W + cols).reshape(-1)
            dfeat.index_add_(0, flat, torch.where(
                hit, grad, torch.zeros_like(grad)).reshape(-1, C))
    return dfeat.reshape(B, H, W, C)


def roi_pool_pyramid(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                     boxes: torch.Tensor, patch_size: Tuple[int, int],
                     pool: Callable = roi_max_pool
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Pool every skip (strides 2, 4, ..) to patch * stride^-1 and the
    latent (stride 2^(len(skips)+1)) to patch // stride, for all boxes.
    `pool` is the per-scale pool (the plain one, or a kernel wrapper)."""
    levels = pyramid_levels(len(skips), patch_size)
    pooled = [pool(m, boxes, s, size)
              for m, (s, size) in zip(list(skips) + [latent], levels)]
    return pooled[-1], pooled[:-1]


def pyramid_levels(n_skips: int, patch_size: Tuple[int, int]
                   ) -> List[Tuple[float, Tuple[int, int]]]:
    """(scale, out_size) of each skip, shallow to deep, then the latent's."""
    ph, pw = patch_size
    levels = []
    for i in range(n_skips):
        s = 1.0 / (2 ** (i + 1))
        levels.append((s, (int(ph * s), int(pw * s))))
    stride = 2 ** (n_skips + 1)
    return levels + [(1.0 / stride, (ph // stride, pw // stride))]


def _patch_origins(points: torch.Tensor, image_shape: Tuple[int, int],
                   patch_size: Tuple[int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped top-left (y0, x0) of each point's patch in the padded
    canvas; u, v round half to even."""
    H, W = image_shape
    ph, pw = patch_size
    Hp, Wp = H + 2 * (ph // 2), W + 2 * (pw // 2)
    u = torch.round(points[..., 0]).long()
    v = torch.round(points[..., 1]).long()
    y0 = torch.clamp(v - ph // 2, 0, Hp - ph)
    x0 = torch.clamp(u - pw // 2, 0, Wp - pw)
    return y0, x0


def frame_thresholds(threshold, batch: int, device) -> torch.Tensor:
    """A scalar or per-frame threshold as a (B,) float32 tensor.  A
    Python number is filled on the device (no host-to-device copy, so a
    CUDA graph can capture it)."""
    if isinstance(threshold, numbers.Number):
        return torch.full((batch,), threshold, dtype=torch.float32,
                          device=device)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=device)
    return thr.reshape(-1).expand(batch)


def compose_patches(responses: torch.Tensor, points: torch.Tensor,
                    point_mask: torch.Tensor, image_shape: Tuple[int, int],
                    patch_size: Tuple[int, int], response_threshold
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composite (B, K, ph, pw) responses into quasi-dense depth.

    points: (B, K, 3) (u, v, z) in padded-image coordinates; point_mask
    (B, K); response_threshold a scalar or (B,).  Returns (depth,
    response), two (B, H, W) maps: the response-weighted mean depth where
    the max response is above 0 (else 0), and the max response.
    """
    B, K, ph, pw = responses.shape
    H, W = image_shape
    pad_y, pad_x = ph // 2, pw // 2
    Hp, Wp = H + 2 * pad_y, W + 2 * pad_x
    dev = responses.device
    thr = frame_thresholds(response_threshold, B, dev)
    resp = torch.where(responses < thr[:, None, None, None],
                       torch.zeros_like(responses), responses)
    resp = resp * point_mask[:, :, None, None]
    y0, x0 = _patch_origins(points, image_shape, patch_size)
    z = points[..., 2]

    max_r = torch.zeros((B, Hp, Wp), dtype=torch.float32, device=dev)
    sum_r = torch.zeros_like(max_r)
    sum_rz = torch.zeros_like(max_r)
    bi = torch.arange(B, device=dev)[:, None, None]
    ry = torch.arange(ph, device=dev)[None, :, None]
    rx = torch.arange(pw, device=dev)[None, None, :]
    for k in range(K):
        idx = (bi, y0[:, k, None, None] + ry, x0[:, k, None, None] + rx)
        crop = resp[:, k]
        max_r[idx] = torch.maximum(max_r[idx], crop)
        sum_r[idx] = sum_r[idx] + crop
        sum_rz[idx] = sum_rz[idx] + crop * z[:, k, None, None]

    crop = (slice(None), slice(pad_y, pad_y + H), slice(pad_x, pad_x + W))
    max_r, sum_r, sum_rz = max_r[crop], sum_r[crop], sum_rz[crop]
    safe = torch.where(sum_r > 0, sum_r, torch.ones_like(sum_r))
    depth = torch.where(max_r > 0, sum_rz / safe, torch.zeros_like(sum_r))
    return depth, max_r


def adaptive_threshold_value(responses: torch.Tensor,
                             point_mask: torch.Tensor,
                             response_threshold: float,
                             threshold_decay: float = 0.05,
                             max_retries: int = 8) -> torch.Tensor:
    """Closed form of the adaptive threshold-decay retry: per frame,
    thr0 - k * decay with k = ceil((thr0 - max masked response) / decay)
    clamped to [0, max_retries].  Returns (B,) thresholds."""
    masked = responses * point_mask[..., None, None]
    m = masked.amax(dim=(-3, -2, -1))
    k = torch.ceil((response_threshold - m) / threshold_decay)
    k = torch.clamp(k, 0, max_retries)
    # f32(thr0) - f32(k * decay): the scalar rounds to f32, as a tensor
    return response_threshold - k * threshold_decay


def adaptive_compose(responses: torch.Tensor, points: torch.Tensor,
                     point_mask: torch.Tensor, image_shape: Tuple[int, int],
                     patch_size: Tuple[int, int], response_threshold: float,
                     threshold_decay: float = 0.05, max_retries: int = 8,
                     compose: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Composition with the bounded threshold-decay retry: while a
    frame's composed depth is all zero, lower its threshold by
    `threshold_decay` and compose again, at most `max_retries` times.

    The loop itself runs (not the closed form of
    `adaptive_threshold_value`, which can differ by one f32 ulp), with
    the JAX package's f32 threshold sequence: f32(thr0) first, then
    f32(thr0 - decay) (subtracted in doubles), then minus f32(decay) in
    f32 at each later retry; the threshold returned is the next one plus
    f32(decay).  Each round composes every frame at its current
    threshold and keeps the result of the frames still retrying, so on
    the card a round is one launch of `compose` (the kernel wrapper by
    default; `ops.patches.compose_patches` gives the plain version).

    Returns (depth, response, threshold, retries): (B, H, W) maps and
    (B,) final thresholds and retry counts.
    """
    if compose is None:
        from riders_tpu_torch.ops.kernels.compose import compose_patches \
            as compose
    B = responses.shape[0]
    dev = responses.device
    args = (responses, points, point_mask, image_shape, patch_size)
    depth, resp = compose(*args, frame_thresholds(response_threshold, B,
                                                  dev).contiguous())
    decay = torch.tensor(threshold_decay, dtype=torch.float32, device=dev)
    thr = torch.full((B,), response_threshold - threshold_decay,
                     dtype=torch.float32, device=dev)
    retries = torch.zeros((B,), dtype=torch.int64, device=dev)
    for _ in range(max_retries):
        active = depth.sum(dim=(1, 2)) == 0
        if not bool(active.any()):
            break
        d, r = compose(*args, thr)
        keep = active[:, None, None]
        depth = torch.where(keep, d, depth)
        resp = torch.where(keep, r, resp)
        thr = torch.where(active, thr - decay, thr)
        retries = retries + active.long()
    return depth, resp, thr + decay, retries
