"""The seeded pool of frames a cell serves, in host memory.

Each frame is in the compact form that `FusedInferenceDataset(compact=
True)` stages: a uint8 RGB thermal image, the uint16 PNG16 code (x256)
of the monocular inverse-depth prior, and the radar points (u, v, z)
with their mask, padded to the configuration's bucket.  As in the port's
`bench.make_batch`, the points sit on a depth field that the prior
follows: here a smooth field (a random 8 x 10 grid of 5-55 m, upsampled
bilinearly) and a prior of (1 / depth) / 0.05 with 2% multiplicative
noise.  The image is the field's normalised inverse depth with per-pixel
noise.  Every frame of the pool differs; the real points of a frame lie
on distinct pixels, none at (0, 0), where the padded slots scatter.

The fields and images are drawn on the device by a torch.Generator in a
few large calls and copied to the host once; the point positions come
from numpy's generator.  The same seed gives the same pool.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

GRID = (8, 10)                 # the depth field's random control grid
DEPTH_RANGE = (5.0, 55.0)      # metres
MONO_SCALE = 0.05              # prior = (1 / depth) / MONO_SCALE


def make_pool(frame, bucket: int, real: int, n_batches: int, batch: int,
              seed: int, device) -> List[Dict[str, np.ndarray]]:
    """`n_batches` host batches of `batch` distinct frames: image (B, H,
    W, 3) uint8, mono_pred (B, H, W) uint16, radar_points (B, K, 3) f32,
    point_mask (B, K) f32, K = `bucket` with `real` real points."""
    H, W = frame
    n = n_batches * batch
    g = torch.Generator(device=device).manual_seed(seed)
    lo, hi = DEPTH_RANGE
    grid = lo + (hi - lo) * torch.rand((n, 1) + GRID, generator=g,
                                       device=device)
    depth = F.interpolate(grid, size=(H, W), mode="bilinear",
                          align_corners=True)[:, 0]
    noise = torch.randn((2, n, H, W), generator=g, device=device)
    mono = (1.0 / depth) / MONO_SCALE * (1.0 + 0.02 * noise[0])
    codes = torch.round(mono * 256.0).clamp(1, 65535).to(torch.int32)
    inv = 1.0 / depth
    gray = (inv - 1.0 / hi) / (1.0 / lo - 1.0 / hi)
    image = torch.round(255.0 * (0.15 + 0.7 * gray + 0.05 * noise[1]))
    image = image.clamp(0, 255).to(torch.uint8)[..., None].expand(
        n, H, W, 3)

    rng = np.random.default_rng(seed)
    flat = np.stack([rng.choice(H * W - 1, real, replace=False) + 1
                     for _ in range(n)])                       # (n, real)
    v, u = flat // W, flat % W
    z = depth.reshape(n, -1).gather(
        1, torch.from_numpy(flat).to(device)).cpu().numpy()
    points = np.zeros((n, bucket, 3), np.float32)
    points[:, :real] = np.stack([u, v, z], -1)
    mask = np.zeros((n, bucket), np.float32)
    mask[:, :real] = 1.0

    image = image.contiguous().cpu().numpy()
    codes = codes.cpu().numpy().astype(np.uint16)
    return [{"image": image[s:s + batch],
             "mono_pred": codes[s:s + batch],
             "radar_points": points[s:s + batch],
             "point_mask": mask[s:s + batch]}
            for s in range(0, n, batch)]


def take(pool: List[Dict[str, np.ndarray]], index) -> Dict[str, np.ndarray]:
    """The frames at (batch, frame) pairs `index`, stacked."""
    return {k: np.stack([pool[b][k][f] for b, f in index])
            for k in pool[0]}
