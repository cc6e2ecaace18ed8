"""Quasi-dense patch composition.

`compose_patches` launches the CUDA kernel (csrc/compose.cu) for CUDA
tensors and runs its plain version, `ops.patches.compose_patches`, for
CPU tensors; the two agree bit for bit.
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
