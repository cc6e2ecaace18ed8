"""Sparse-depth densification: host Delaunay and device IDW.

* ``delaunay_interpolate`` / ``delaunay_interpolate_windowed`` - the
  offline lidar densification of preprocessing: barycentric
  interpolation over the Delaunay triangulation of the valid pixels, by
  the native library (`io/native.py`) or by scipy's Qhull, on the host.
* ``interpolate_scale_knots`` / ``exact_scale_map`` - the 'interp-exact'
  scale-map source: scipy griddata of the knots' observed / prior
  ratios, ones outside their hull; host work, one frame at a time.
* ``idw_scale_map`` / ``idw_interpolate`` - the 'interp' scale-map
  source: inverse-distance weighting over the first 128 knots, on the
  caller's device, an approximation of the griddata map selected by
  configuration.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# elements of one (K, rows, W) chunk of the IDW sums (f32: 32 MB)
IDW_CHUNK_ELEMS = 1 << 23


def delaunay_interpolate(depth_map: np.ndarray,
                         validity_map: Optional[np.ndarray] = None,
                         log_space: bool = False,
                         use_native: bool = True) -> np.ndarray:
    """Barycentric (Delaunay) interpolation of a sparse (H, W) map over
    its valid pixels (by default the positive ones); 0 outside their hull
    and everywhere with fewer than 3.  With `log_space` the values are
    interpolated as logarithms (fill log 1e-3) and results under 0.1 are
    zeroed.

    The linear path runs on the native library when `use_native` (it
    raises when the library cannot be built), else on scipy; the log
    path always on scipy.  The two linear forms differ only where
    cocircular grid points make the triangulation ambiguous."""
    if depth_map.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {depth_map.shape}")
    if validity_map is None:
        validity_map = depth_map > 0.0
    if use_native and not log_space and validity_map.sum() >= 3:
        from riders_tpu_torch.io.native import delaunay_interpolate_native
        return delaunay_interpolate_native(depth_map, validity_map)

    from scipy.interpolate import LinearNDInterpolator

    rows, cols = depth_map.shape
    ridx, cidx = np.where(validity_map)
    if len(ridx) < 3:
        return np.zeros_like(depth_map)
    values = depth_map[ridx, cidx]
    if log_space:
        values = np.log(values)
    interp = LinearNDInterpolator(
        points=np.stack([ridx, cidx], axis=1), values=values,
        fill_value=0 if not log_space else np.log(1e-3))
    qr, qc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    out = interp(np.stack([qr.ravel(), qc.ravel()], axis=1)).reshape(
        rows, cols)
    if log_space:
        out = np.exp(out)
        out[out < 1e-1] = 0.0
    return out.astype(np.float32)


def delaunay_interpolate_windowed(depth_map: np.ndarray,
                                  validity_map: Optional[np.ndarray] = None,
                                  log_space: bool = False,
                                  window_size: int = 12) -> np.ndarray:
    """`delaunay_interpolate`, kept only at pixels with a positive
    measurement inside their window_size x window_size neighbourhood."""
    from scipy.ndimage import maximum_filter

    if validity_map is None:
        validity_map = depth_map > 0.0
    dense = delaunay_interpolate(depth_map, validity_map, log_space)
    has_neighbor = maximum_filter(
        (depth_map > 0).astype(np.float32), size=window_size,
        mode="nearest") > 0
    return np.where(has_neighbor, dense, 0.0).astype(np.float32)


def interpolate_scale_knots(int_depth: np.ndarray, sparse_inv: np.ndarray,
                            valid: np.ndarray) -> np.ndarray:
    """Dense (H, W) scale map: griddata (linear, over the Delaunay
    triangulation) of the knots' ratios sparse_inv / int_depth at the
    valid pixels, ones outside their hull and everywhere with fewer than
    3 knots."""
    from scipy.interpolate import griddata

    ridx, cidx = np.where(valid > 0)
    if len(ridx) < 3:
        return np.ones_like(int_depth, np.float32)
    knots = sparse_inv[ridx, cidx] / int_depth[ridx, cidx]
    grid_r, grid_c = np.mgrid[0:int_depth.shape[0], 0:int_depth.shape[1]]
    out = griddata(np.stack([ridx, cidx], axis=1), knots,
                   (grid_r, grid_c), method="linear", fill_value=1.0)
    return out.astype(np.float32)


def exact_scale_map(int_depth_inv: torch.Tensor, sparse_inv: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """`interpolate_scale_knots` of each frame of (B, H, W) maps: each
    frame is copied to the host, interpolated there and copied back to
    the maps' device (the 'interp-exact' source)."""
    out = [torch.from_numpy(interpolate_scale_knots(
        *(t.detach().float().cpu().numpy() for t in frame)))
        for frame in zip(int_depth_inv, sparse_inv, valid)]
    return torch.stack(out).to(int_depth_inv.device)


def knot_indices(valid: torch.Tensor, max_knots: int = 128) -> torch.Tensor:
    """The flat indices of the first `max_knots` valid pixels of each
    (H, W) frame of `valid` (B, H, W), in row-major order, then, to fill
    the bucket, the first invalid ones: the order of a top-k of the 0/1
    mask that puts ties at their lowest index first.  A stable sort
    keeps it on every device."""
    flat = valid.reshape(valid.shape[0], -1).float()
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices
    return order[:, :max_knots]


def idw_scale_map(int_depth_inv: torch.Tensor, sparse_inv: torch.Tensor,
                  valid: torch.Tensor, max_knots: int = 128) -> torch.Tensor:
    """Dense scale maps of (B, H, W) frames by IDW (the 'interp'
    source): the ratios sparse_inv / int_depth_inv at each frame's first
    `max_knots` valid pixels (`knot_indices`), spread over the frame by
    `idw_interpolate`; ones in a frame with no knot."""
    B, H, W = int_depth_inv.shape
    idx = knot_indices(valid, max_knots)
    take = lambda t: t.reshape(B, -1).gather(1, idx)
    knot_mask = take(valid.float())
    uv = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    ratios = take(sparse_inv) / torch.clamp(take(int_depth_inv), min=1e-8)
    out = []
    for b in range(B):
        dense = idw_interpolate(uv[b], ratios[b], knot_mask[b], (H, W))
        out.append(torch.where(knot_mask[b].sum() > 0, dense,
                               torch.ones_like(dense)))
    return torch.stack(out)


def idw_interpolate(points_uv: torch.Tensor, points_val: torch.Tensor,
                    point_mask: torch.Tensor, shape: Tuple[int, int],
                    power: float = 2.0, eps: float = 1e-6) -> torch.Tensor:
    """Inverse-distance-weighted densification of K points over an
    (H, W) frame: sum_k m_k v_k / d2_k^(p/2) over sum_k m_k / d2_k^(p/2),
    d2 the squared pixel distance plus eps; zeros when no point is valid.

    points_uv: (K, 2) (u, v); points_val, point_mask: (K,).  Rows go in
    chunks of about IDW_CHUNK_ELEMS (K, rows, W) elements, so the
    intermediates stay near 32 MB each whatever the frame."""
    H, W = shape
    K = points_uv.shape[0]
    dev = points_uv.device
    uu = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    pu = points_uv[:, 0, None, None]
    pv = points_uv[:, 1, None, None]
    mask = point_mask[:, None, None]
    val = points_val[:, None, None]
    rows = max(1, IDW_CHUNK_ELEMS // max(K * W, 1))
    out = []
    for r0 in range(0, H, rows):
        vv = torch.arange(r0, min(r0 + rows, H), dtype=torch.float32,
                          device=dev)[None, :, None]
        du = uu - pu
        dv = vv - pv
        d2 = du * du + dv * dv + eps
        w = mask / (d2 ** (power / 2.0))
        denom = w.sum(0)
        num = (w * val).sum(0)
        out.append(num / torch.clamp(denom, min=eps))
    dense = torch.cat(out, 0)
    return torch.where(point_mask.sum() > 0, dense, torch.zeros_like(dense))
