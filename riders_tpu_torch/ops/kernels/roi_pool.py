"""RoI max pool of K fixed-size boxes per frame, at every pyramid scale.

`roi_max_pool` launches the CUDA kernel (csrc/roi_pool.cu) for CUDA
tensors and runs its plain version, `ops.patches.roi_max_pool`, for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                          ctypes.c_void_p]


def roi_max_pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """feature (B, H, W, C) NHWC, boxes (B, K, 4) f32 [x1, y1, x2, y2];
    returns (B, K, out_h, out_w, C).  On CUDA the feature is contiguous
    bf16 and the boxes contiguous f32."""
    if on_cpu(feature, boxes):
        return patches.roi_max_pool(feature, boxes, scale, out_size)
    B, H, W, C = feature.shape
    require(feature, "feature", torch.bfloat16)
    require(boxes, "boxes", torch.float32, (B, None, 4))
    K = boxes.shape[1]
    out_h, out_w = out_size
    out = torch.empty((B, K, out_h, out_w, C), dtype=torch.bfloat16,
                      device=feature.device)
    fn = kernel_function("roi_pool", "riders_roi_max_pool", _ARGTYPES)
    check(fn(feature.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W,
             C, K, out_h, out_w, scale, stream_handle(feature)), "roi_pool")
    LAUNCHES["roi_pool"] += 1
    return out


def roi_pool_pyramid(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                     boxes: torch.Tensor, patch_size: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`ops.patches.roi_pool_pyramid` through the kernel wrapper: one
    launch per scale on CUDA."""
    return patches.roi_pool_pyramid(latent, skips, boxes, patch_size,
                                    pool=roi_max_pool)
