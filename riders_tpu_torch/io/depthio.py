"""Host-side image / depth-map IO in the on-disk interchange formats.

* 16-bit PNG depth maps with a x256 fixed-point codec (a map whose codes
  overflow 16 bits is written as a 32-bit mode-'I' PNG), and x2^14
  response maps;
* RGB images as float32, raw or normalised to [0, 1];
* n x 3 (u, v, depth) radar point lists as .npy, scattered to sparse
  maps, and the fixed-size point bucket with its mask.

The files are byte-identical to those of the JAX package's
`io/depthio.py`, so stage outputs move between the two packages.
Pillow is imported where a file is read or written, not with the module.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

DEPTH_MULTIPLIER = 256.0
RESPONSE_MULTIPLIER = float(2 ** 14)


def _pil_image():
    from PIL import Image
    return Image


def load_image(path: str, normalize: bool = False) -> np.ndarray:
    """Load an RGB image as float32 HWC, in [0, 1] with `normalize`."""
    image = np.asarray(_pil_image().open(path).convert("RGB"), np.float32)
    if normalize:
        image = image / 255.0
    return image


def read_image_unit(path: str) -> np.ndarray:
    """Load an RGB image in [0, 1], grayscale promoted to 3 channels."""
    return load_image(path, normalize=True)


def load_depth(path: str, multiplier: float = DEPTH_MULTIPLIER) -> np.ndarray:
    """Load a 16-bit PNG depth map; non-positive values zeroed."""
    z = np.array(_pil_image().open(path), dtype=np.float32) / multiplier
    z[z <= 0] = 0.0
    return z


def _save_fixed_point(x: np.ndarray, path: str, multiplier: float) -> None:
    code = np.uint32(np.asarray(x) * multiplier)
    Image = _pil_image()
    if code.max(initial=0) <= np.iinfo(np.uint16).max:
        Image.fromarray(code.astype(np.uint16)).save(path)
    else:
        Image.fromarray(code.astype(np.int32), mode="I").save(path)


def save_depth(z: np.ndarray, path: str,
               multiplier: float = DEPTH_MULTIPLIER) -> None:
    """Save a depth map as a fixed-point PNG (16-bit, else mode 'I')."""
    _save_fixed_point(z, path, multiplier)


def load_response(path: str,
                  multiplier: float = RESPONSE_MULTIPLIER) -> np.ndarray:
    """Load an RC-Net response map."""
    return np.array(_pil_image().open(path), dtype=np.float32) / multiplier


def save_response(response: np.ndarray, path: str,
                  multiplier: float = RESPONSE_MULTIPLIER) -> None:
    """Save an RC-Net response map."""
    _save_fixed_point(response, path, multiplier)


def save_color_depth(z: np.ndarray, path: str,
                     max_depth: Optional[float] = None) -> None:
    """Save a viridis-coloured depth picture, scaled to [min, max] of the
    map or to [0, max_depth]."""
    z = np.asarray(z, np.float32)
    if max_depth is None:
        rng = np.max(z) - np.min(z)
        zn = (z - np.min(z)) / (rng if rng > 0 else 1.0)
    else:
        zn = np.clip(z, None, max_depth) / max_depth
    _pil_image().fromarray(np.uint8(_viridis(zn) * 255)).save(path)


def _viridis(x: np.ndarray) -> np.ndarray:
    """Viridis colormap lookup, x in [0, 1] -> RGBA float: matplotlib's
    where it is installed, else an 11-anchor linear approximation."""
    try:
        import matplotlib.pyplot as plt
        return plt.cm.viridis(x)
    except ImportError:
        anchors = np.array([
            [0.267, 0.005, 0.329], [0.283, 0.141, 0.458],
            [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
            [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
            [0.135, 0.659, 0.518], [0.267, 0.749, 0.441],
            [0.478, 0.821, 0.318], [0.741, 0.873, 0.150],
            [0.993, 0.906, 0.144]], np.float32)
        t = np.clip(x, 0.0, 1.0) * (len(anchors) - 1)
        i0 = np.floor(t).astype(np.int32)
        i1 = np.minimum(i0 + 1, len(anchors) - 1)
        w = (t - i0)[..., None]
        rgb = anchors[i0] * (1 - w) + anchors[i1] * w
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)


def load_radar_points(path: str) -> np.ndarray:
    """Radar returns as an (N, 3) float32 (u, v, depth) array, from an
    .npy point list or from the nonzero pixels of a sparse PNG depth
    map."""
    if path.endswith(".npy"):
        pts = np.load(path).astype(np.float32)
        if pts.ndim == 1:
            pts = pts[None, :]
        return pts
    depth_map = load_depth(path)
    v, u = np.where(depth_map > 0)
    z = depth_map[depth_map > 0]
    return np.column_stack([u, v, z]).astype(np.float32)


def scatter_points_to_map(points: np.ndarray,
                          shape: Tuple[int, int]) -> np.ndarray:
    """Scatter (u, v, depth) points onto an H x W sparse depth map,
    map[int(v), int(u)] = depth, later points winning; points off the
    map are dropped."""
    out = np.zeros(shape, np.float32)
    for u, v, z in points[:, :3]:
        if 0 <= int(v) < shape[0] and 0 <= int(u) < shape[1]:
            out[int(v), int(u)] = z
    return out


def pad_points(points: np.ndarray, max_points: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad or truncate a point list to a fixed bucket: (points
    (max_points, 3), valid (max_points,) float32)."""
    n = min(points.shape[0], max_points)
    out = np.zeros((max_points, 3), np.float32)
    valid = np.zeros((max_points,), np.float32)
    out[:n] = points[:n]
    valid[:n] = 1.0
    return out, valid


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
