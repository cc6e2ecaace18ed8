"""RoI max pool of K fixed-size boxes per frame, at every pyramid scale,
and its backward.

`roi_max_pool` launches the CUDA forward kernel (csrc/roi_pool.cu) for
CUDA tensors, bf16 or f32, and runs its plain version,
`ops.patches.roi_max_pool`, for CPU tensors; it counts bf16 launches as
`roi_pool` and f32 ones as `roi_pool_f32`.  `roi_max_pool_backward`
does the same for d(feature) (`ops.patches.roi_max_pool_backward`), f32
only, as the training forward runs f32.  `RoIMaxPool` joins the two as
an autograd function; `roi_pool_pyramid` routes through it whenever
grad is enabled.
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
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]
# element type -> (kernel symbol, launch counter)
_FORWARD = {torch.bfloat16: ("riders_roi_max_pool", "roi_pool"),
            torch.float32: ("riders_roi_max_pool_f32", "roi_pool_f32")}
MAX_BOXES_BWD = 2048        # the backward stages 16 bytes per box per block


def roi_max_pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """feature (B, H, W, C) NHWC, boxes (B, K, 4) f32 [x1, y1, x2, y2];
    returns (B, K, out_h, out_w, C).  On CUDA the feature is contiguous
    bf16 or f32 and the boxes contiguous f32."""
    if on_cpu(feature, boxes):
        return patches.roi_max_pool(feature, boxes, scale, out_size)
    B, H, W, C = feature.shape
    if feature.dtype not in _FORWARD:
        raise TypeError(f"feature: expected bf16 or f32, got "
                        f"{feature.dtype}")
    require(feature, "feature", feature.dtype)
    require(boxes, "boxes", torch.float32, (B, None, 4))
    K = boxes.shape[1]
    out_h, out_w = out_size
    out = torch.empty((B, K, out_h, out_w, C), dtype=feature.dtype,
                      device=feature.device)
    symbol, counter = _FORWARD[feature.dtype]
    fn = kernel_function("roi_pool", symbol, _ARGTYPES)
    check(fn(feature.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W,
             C, K, out_h, out_w, scale, stream_handle(feature)), counter)
    LAUNCHES[counter] += 1
    return out


def roi_max_pool_backward(feature: torch.Tensor, boxes: torch.Tensor,
                          pooled: torch.Tensor, grad: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """d(feature) (B, H, W, C) f32 from the forward's inputs, its output
    `pooled` and the cotangent `grad` (both (B, K, out_h, out_w, C)).
    On CUDA every tensor is contiguous f32."""
    if on_cpu(feature, boxes, pooled, grad):
        return patches.roi_max_pool_backward(feature, boxes, pooled, grad,
                                             scale)
    B, H, W, C = feature.shape
    require(feature, "feature", torch.float32)
    require(boxes, "boxes", torch.float32, (B, None, 4))
    K = boxes.shape[1]
    if K > MAX_BOXES_BWD:
        raise ValueError(f"boxes: at most {MAX_BOXES_BWD} per frame, got {K}")
    require(pooled, "pooled", torch.float32, (B, K, None, None, C))
    require(grad, "grad", torch.float32, tuple(pooled.shape))
    out_h, out_w = pooled.shape[2:4]
    dfeat = torch.empty_like(feature)
    fn = kernel_function("roi_pool", "riders_roi_max_pool_bwd_f32",
                         _BWD_ARGTYPES)
    check(fn(feature.data_ptr(), boxes.data_ptr(), pooled.data_ptr(),
             grad.data_ptr(), dfeat.data_ptr(), B, H, W, C, K, out_h, out_w,
             scale, stream_handle(feature)), "roi_pool_bwd")
    LAUNCHES["roi_pool_bwd"] += 1
    return dfeat


class RoIMaxPool(torch.autograd.Function):
    """`roi_max_pool` with `roi_max_pool_backward` as its gradient.  The
    boxes get no gradient (the JAX custom VJP returns zeros for them)."""

    @staticmethod
    def forward(ctx, feature, boxes, scale, out_size):
        pooled = roi_max_pool(feature, boxes, scale, out_size)
        ctx.save_for_backward(feature, boxes, pooled)
        ctx.scale = scale
        return pooled

    @staticmethod
    def backward(ctx, grad):
        feature, boxes, pooled = ctx.saved_tensors
        dfeat = roi_max_pool_backward(feature, boxes, pooled,
                                      grad.contiguous(), ctx.scale)
        return dfeat.to(feature.dtype), None, None, None


def roi_max_pool_diff(feature: torch.Tensor, boxes: torch.Tensor,
                      scale: float, out_size: Tuple[int, int]
                      ) -> torch.Tensor:
    """Differentiable `roi_max_pool` (the kernels on CUDA)."""
    return RoIMaxPool.apply(feature, boxes, scale, tuple(out_size))


def roi_pool_pyramid(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                     boxes: torch.Tensor, patch_size: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`ops.patches.roi_pool_pyramid` through the kernel wrappers: one
    launch per scale on CUDA, and one backward launch per scale when grad
    is enabled."""
    pool = roi_max_pool_diff if torch.is_grad_enabled() else roi_max_pool
    return patches.roi_pool_pyramid(latent, skips, boxes, patch_size,
                                    pool=pool)
