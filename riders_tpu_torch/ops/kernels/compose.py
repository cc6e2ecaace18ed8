"""Quasi-dense patch composition.

`compose_patches` launches the CUDA kernel (csrc/compose.cu) for CUDA
tensors and runs its plain version, `ops.patches.compose_patches`, for
CPU tensors; the two agree bit for bit.  The kernel's blocks own tiles
of TILE output pixels and gather only over the points whose patches
meet their tile; `tile_points` mirrors that culling on the host.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
TILE = (8, 128)             # output rows, columns of a block (compose.cu)


def tile_points(points: torch.Tensor, frame: Tuple[int, int],
                patch: Tuple[int, int], tile: Tuple[int, int] = TILE
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's culled point lists: for each frame b and tile (i, j)
    of `tile` output pixels (clipped to the frame), the k whose patch
    window [y0, y0 + ph) x [x0, x0 + pw) in padded coordinates meets the
    tile, in ascending k.  Masked points are listed too.  Returns (lists
    (B, TY, TX, K) int64, each list then -1, counts (B, TY, TX))."""
    (H, W), (ph, pw), (th, tw) = frame, patch, tile
    y0, x0 = patches._patch_origins(points, frame, patch)     # (B, K)
    ty, tx = torch.arange(0, H, th), torch.arange(0, W, tw)
    cy0, cy1 = ty + ph // 2, (ty + th).clamp(max=H) + ph // 2
    cx0, cx1 = tx + pw // 2, (tx + tw).clamp(max=W) + pw // 2
    rows = ((y0[:, None, :] < cy1[:, None])
            & (y0[:, None, :] + ph > cy0[:, None]))           # (B, TY, K)
    cols = ((x0[:, None, :] < cx1[:, None])
            & (x0[:, None, :] + pw > cx0[:, None]))           # (B, TX, K)
    meets = rows[:, :, None] & cols[:, None]                  # (B, TY, TX, K)
    # each listed k's slot: the listed points before it (the kernel's
    # ballot popcounts, summed over lanes, warps and rounds)
    K = meets.shape[-1]
    slot = torch.where(meets, meets.long().cumsum(-1) - 1, K)
    lists = torch.full(meets.shape[:-1] + (K + 1,), -1, dtype=torch.long)
    lists.scatter_(-1, slot, torch.arange(K).expand(meets.shape))
    return lists[..., :K], meets.sum(-1)


def compose_patches(responses: torch.Tensor, points: torch.Tensor,
                    point_mask: torch.Tensor, image_shape: Tuple[int, int],
                    patch_size: Tuple[int, int], response_threshold
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See `ops.patches.compose_patches`.  On CUDA every input is a
    contiguous f32 tensor; the threshold is a scalar or a (B,) tensor."""
    if on_cpu(responses, points, point_mask):
        return patches.compose_patches(responses, points, point_mask,
                                       image_shape, patch_size,
                                       response_threshold)
    B, K, ph, pw = responses.shape
    if (ph, pw) != tuple(patch_size):
        raise ValueError(f"responses {tuple(responses.shape)} do not match "
                         f"patch {tuple(patch_size)}")
    require(responses, "responses", torch.float32)
    require(points, "points", torch.float32, (B, K, 3))
    require(point_mask, "point_mask", torch.float32, (B, K))
    thr = patches.frame_thresholds(response_threshold, B,
                                   responses.device).contiguous()
    H, W = image_shape
    depth = torch.empty((B, H, W), dtype=torch.float32,
                        device=responses.device)
    max_resp = torch.empty_like(depth)
    fn = kernel_function("compose", "riders_compose_patches", _ARGTYPES)
    check(fn(responses.data_ptr(), points.data_ptr(), point_mask.data_ptr(),
             thr.data_ptr(), depth.data_ptr(), max_resp.data_ptr(), B, K, H,
             W, ph, pw, stream_handle(responses)), "compose")
    LAUNCHES["compose"] += 1
    return depth, max_resp
