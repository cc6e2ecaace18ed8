"""Plain float32 operations of RIDERS' fused chain around its networks,
the benchmark's reference: resampling, RoI max pooling, the adaptive
threshold, patch composition, the radar scatter, stage-1 alignment and
the scale map.  Written against torch alone, batched over frames.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

_INVPHI = 0.6180339887498949
_INVPHI2 = 0.3819660112501051
_EPS = float(torch.finfo(torch.float32).eps)


# ---- resampling

def resize_nchw(x: torch.Tensor, shape, method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes.  Nearest takes source index
    floor(i * in / out) in integers; bilinear and bicubic (A = -0.75,
    clamped taps) are torch's."""
    h, w = x.shape[-2:]
    h2, w2 = shape
    if (h, w) == (h2, w2):
        return x
    if method == "nearest":
        rows = (torch.arange(h2, device=x.device) * h) // h2
        cols = (torch.arange(w2, device=x.device) * w) // w2
        return x.index_select(-2, rows).index_select(-1, cols)
    return F.interpolate(x, size=(h2, w2), mode=method,
                         align_corners=align_corners)


def edge_pad(image: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Replicate-pad (B, H, W, C) by (py, px) per side."""
    return F.pad(image.permute(0, 3, 1, 2), (px, px, py, py),
                 mode="replicate").permute(0, 2, 3, 1)


def shift_points_and_boxes(points: torch.Tensor, patch):
    """(u, v, z) into padded coordinates and the [x1, y1, x2, y2] boxes
    centred on them."""
    py, px = patch[0] // 2, patch[1] // 2
    u, v = points[..., 0] + px, points[..., 1] + py
    shifted = torch.stack([u, v, points[..., 2]], -1)
    return shifted, torch.stack([u - px, v - py, u + px, v + py], -1)


# ---- RoI max pooling (torchvision's roi_pool rounding)

def bin_bounds(start, end, limit: int, n: int):
    """[lo, hi) of the n bins of each box along one axis, in [0, limit]."""
    roi = torch.clamp(end - start + 1, min=1)[..., None]
    s = torch.clamp(start, 0, limit)[..., None]
    p = torch.arange(n, device=start.device)
    lo = s + (p * roi) // n
    hi = s + ((p + 1) * roi + n - 1) // n
    return lo.clamp(max=limit), hi.clamp(max=limit)


def roi_bounds(boxes, scale: float, H: int, W: int, out):
    """Row and column bin bounds of (B, K, 4) boxes; edges round half
    away from zero, floor(x * scale + 0.5)."""
    r = lambda v: torch.floor(v * scale + 0.5).long()
    lo_h, hi_h = bin_bounds(r(boxes[..., 1]), r(boxes[..., 3]), H, out[0])
    lo_w, hi_w = bin_bounds(r(boxes[..., 0]), r(boxes[..., 2]), W, out[1])
    return lo_h, hi_h, lo_w, hi_w


def roi_max_pool(feature, boxes, scale: float, out):
    """(B, H, W, C) map, (B, K, 4) boxes -> (B, K, oh, ow, C); an empty
    bin gives 0."""
    B, H, W, C = feature.shape
    lo_h, hi_h, lo_w, hi_w = roi_bounds(boxes, scale, H, W, out)
    th = int((hi_h - lo_h).max().clamp(min=1))
    tw = int((hi_w - lo_w).max().clamp(min=1))
    bi = torch.arange(B, device=feature.device)[:, None, None, None]
    neg = torch.tensor(float("-inf"), dtype=feature.dtype,
                       device=feature.device)
    best = None
    for i in range(th):
        rows = lo_h + i
        ok_r = rows < hi_h
        rows = rows.clamp(max=H - 1)[:, :, :, None]
        for j in range(tw):
            cols = lo_w + j
            ok = ok_r[:, :, :, None] & (cols < hi_w)[:, :, None, :]
            v = torch.where(ok[..., None],
                            feature[bi, rows,
                                    cols.clamp(max=W - 1)[:, :, None, :]],
                            neg)
            best = v if best is None else torch.maximum(best, v)
    return torch.where(best == neg, torch.zeros_like(best), best)


def pyramid_levels(n_skips: int, patch) -> List[Tuple[float, Tuple]]:
    """(scale, out size) of each skip, shallow to deep, then the
    latent's."""
    ph, pw = patch
    levels = [(1.0 / 2 ** (i + 1), (int(ph / 2 ** (i + 1)),
                                     int(pw / 2 ** (i + 1))))
              for i in range(n_skips)]
    stride = 2 ** (n_skips + 1)
    return levels + [(1.0 / stride, (ph // stride, pw // stride))]


def roi_pool_pyramid(latent, skips: Sequence, boxes, patch):
    pooled = [roi_max_pool(m, boxes, s, size) for m, (s, size) in
              zip(list(skips) + [latent], pyramid_levels(len(skips), patch))]
    return pooled[-1], pooled[:-1]


# ---- threshold and composition

def adaptive_threshold(responses, mask, thr0: float, decay: float,
                       retries: int) -> torch.Tensor:
    """Per frame thr0 - k * decay, k = ceil((thr0 - max masked response)
    / decay) in [0, retries]: the threshold the decay loop ends at."""
    m = (responses * mask[..., None, None]).amax(dim=(-3, -2, -1))
    k = torch.clamp(torch.ceil((thr0 - m) / decay), 0, retries)
    return thr0 - k * decay


def patch_origins(points, frame, patch):
    """Clipped top-left (y0, x0) of each point's patch on the padded
    canvas; u, v round half to even."""
    (H, W), (ph, pw) = frame, patch
    Hp, Wp = H + 2 * (ph // 2), W + 2 * (pw // 2)
    u = torch.round(points[..., 0]).long()
    v = torch.round(points[..., 1]).long()
    return (torch.clamp(v - ph // 2, 0, Hp - ph),
            torch.clamp(u - pw // 2, 0, Wp - pw))


def compose(responses, points, mask, frame, patch, thr):
    """Thresholded responses pasted around their points: the response-
    weighted mean depth where the max response is above 0, else 0."""
    B, K, ph, pw = responses.shape
    H, W = frame
    py, px = ph // 2, pw // 2
    dev = responses.device
    resp = torch.where(responses < thr[:, None, None, None],
                       torch.zeros_like(responses), responses)
    resp = resp * mask[:, :, None, None]
    y0, x0 = patch_origins(points, frame, patch)
    z = points[..., 2]
    shape = (B, H + 2 * py, W + 2 * px)
    max_r = torch.zeros(shape, device=dev)
    sum_r = torch.zeros(shape, device=dev)
    sum_rz = torch.zeros(shape, device=dev)
    bi = torch.arange(B, device=dev)[:, None, None]
    ry = torch.arange(ph, device=dev)[None, :, None]
    rx = torch.arange(pw, device=dev)[None, None, :]
    for k in range(K):
        idx = (bi, y0[:, k, None, None] + ry, x0[:, k, None, None] + rx)
        crop = resp[:, k]
        max_r[idx] = torch.maximum(max_r[idx], crop)
        sum_r[idx] = sum_r[idx] + crop
        sum_rz[idx] = sum_rz[idx] + crop * z[:, k, None, None]
    inner = (slice(None), slice(py, py + H), slice(px, px + W))
    max_r, sum_r, sum_rz = max_r[inner], sum_r[inner], sum_rz[inner]
    safe = torch.where(sum_r > 0, sum_r, torch.ones_like(sum_r))
    return torch.where(max_r > 0, sum_rz / safe, torch.zeros_like(sum_r))


def scatter_points(points, mask, frame) -> torch.Tensor:
    """(B, K, 3) (u, v, z) to sparse (B, H, W) depth; u, v truncate and
    clamp to the frame."""
    H, W = frame
    B, K = mask.shape
    u = points[..., 0].long().clamp(0, W - 1)
    v = points[..., 1].long().clamp(0, H - 1)
    bi = torch.arange(B, device=points.device)[:, None].expand(B, K)
    out = torch.zeros((B, H, W), device=points.device)
    return out.index_put_((bi, v, u), points[..., 2] * mask)


# ---- stage 1: alignment and the scale map

def validity_and_inverse(depth, lo: float, hi: float):
    valid = (depth < hi) & (depth > lo)
    safe = torch.where(valid, depth, torch.ones_like(depth))
    return (torch.where(valid, 1.0 / safe, torch.zeros_like(depth)),
            valid.float())


def _l1(s, p, t, m):
    return torch.sum(m * torch.abs(s[:, None] * p - t), dim=1)


def optimize_scale(pred, target, mask, bounds, iterations: int,
                   max_valid, bucket: int = 512) -> torch.Tensor:
    """Bounded L1 scale per frame by golden-section search; with a valid-
    pixel bound that fits the bucket, on the `bucket` pixels of largest
    mask, lowest index first."""
    B = pred.shape[0]
    p, t, m = (a.reshape(B, -1) for a in (pred, target, mask))
    if (max_valid is not None and max_valid <= bucket
            and p.shape[1] > 2 * bucket):
        idx = torch.sort(m, dim=1, descending=True,
                         stable=True).indices[:, :bucket]
        p, t, m = p.gather(1, idx), t.gather(1, idx), m.gather(1, idx)
    lo = torch.full((B,), bounds[0], device=p.device)
    hi = torch.full((B,), bounds[1], device=p.device)
    c, d = lo + _INVPHI2 * (hi - lo), lo + _INVPHI * (hi - lo)
    fc, fd = _l1(c, p, t, m), _l1(d, p, t, m)
    for _ in range(iterations):
        left = fc < fd
        new_lo = torch.where(left, lo, c)
        new_hi = torch.where(left, d, hi)
        new_d = torch.where(left, c, d)
        new_fd = torch.where(left, fc, fd)
        new_c = new_lo + _INVPHI2 * (new_hi - new_lo)
        new_fc = _l1(new_c, p, t, m)
        c_out = torch.where(left, new_c, new_d)
        fc_out = torch.where(left, new_fc, new_fd)
        d_probe = new_lo + _INVPHI * (new_hi - new_lo)
        fd_probe = _l1(d_probe, p, t, m)
        d = torch.where(left, new_d, d_probe)
        fd = torch.where(left, new_fd, fd_probe)
        lo, hi, c, fc = new_lo, new_hi, c_out, fc_out
    return 0.5 * (lo + hi)


def unit_range(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) per frame; a constant frame unchanged."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    rng = x.amax(dim=(-2, -1), keepdim=True) - lo
    ok = rng > _EPS
    return torch.where(ok, (x - lo) / torch.where(ok, rng,
                                                  torch.ones_like(rng)), x)


def sml_inputs(al: dict, sml: dict, image, mono, radar, quasi):
    """The SML's (x, d) at its net shape from the frame, the prior, the
    sparse radar depth and the quasi-dense RC-Net depth."""
    if al["mode"] != "s" or al["mono_type"] != "inv":
        raise ValueError("the reference writes alignment mode 's' on an "
                         "inverse-depth prior only")
    r_inv, r_ok = validity_and_inverse(radar, al["min_depth"],
                                       al["max_depth"])
    scale = optimize_scale(mono, r_inv, r_ok, al["bounds_inv"],
                           al["iterations"], al["max_valid_pixels"])
    int_depth = mono * scale[:, None, None]
    if al["min_pred"] > 0:
        int_depth = int_depth.clamp(max=1.0 / al["min_pred"])
    int_depth = int_depth.clamp(min=1.0 / al["max_pred"])
    q_inv, q_ok = validity_and_inverse(quasi, al["min_depth"],
                                       al["max_depth"])
    scales = torch.ones_like(int_depth)
    scales = torch.where(q_ok.bool(), q_inv / int_depth, scales)
    scales = torch.where(r_ok.bool(), r_inv / int_depth, scales)
    scales = unit_range(scales)
    r, g, b = image.unbind(-1)
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    maps = resize_nchw(torch.stack([int_depth, scales, gray], 1),
                       tuple(sml["net_shape"]), "nearest")
    d_net, s_net, gray = maps.unbind(1)
    dn = (d_net - sml["int_depth_mean"]) / sml["int_depth_std"]
    sn = (s_net - sml["int_scales_mean"]) / sml["int_scales_std"]
    return torch.stack([dn, sn, gray], -1), d_net[..., None]
