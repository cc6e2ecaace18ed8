"""RoI max pool of K fixed-size boxes per frame, at every pyramid scale,
and its backward.

`roi_max_pool` launches the CUDA forward kernel (csrc/roi_pool.cu) for
CUDA tensors, bf16 or f32, and runs its plain version,
`ops.patches.roi_max_pool`, for CPU tensors; it counts bf16 launches as
`roi_pool` and f32 ones as `roi_pool_f32`.  `roi_max_pool_backward`
does the same for d(feature) (`ops.patches.roi_max_pool_backward`), f32
only, as the training forward runs f32.  `RoIMaxPool` joins the two as
an autograd function; `roi_pool_pyramid` routes through it whenever
grad is enabled.  The backward kernel runs one block per (frame, tile):
`bwd_tiles` sizes the tile, and `bwd_tile_boxes` gives the boxes a
tile's block lists (the kernel builds that list itself, on the card).

`roi_max_pool_4d` is the same pool on a map or on a canvas read in place
over its true extent (a `NEG`-padded canvas, as the JAX package's 4D
pool takes it), the same kernel given the canvas's pitches, counted as
`roi_pool_4d`; `roi_pool_pyramid_4d` pools every scale with it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
NEG = -1e30                 # the fill of a padded canvas, as in JAX
# element type -> launch counter of the plain-map forward
_COUNTERS = {torch.bfloat16: "roi_pool", torch.float32: "roi_pool_f32"}
MAX_BOXES_BWD = 2048        # the backward lists 20 bytes per box per block
BWD_TILE_ROWS = 8           # rows per backward tile
BWD_TILE_SLOTS = 512        # (pixel, channel group) slots per tile: two
                            # for each of the block's 256 threads


def bwd_tiles(W: int, C: int) -> Tuple[int, int, int]:
    """The backward kernel's tile: (rows, columns, channels per thread).
    A thread owns 4 channels (one float4) where C % 4 == 0, else 1; a
    tile holds about BWD_TILE_SLOTS of these slots (8 x 8 pixels at
    C = 32, 8 x 2 at C = 128)."""
    v = 4 if C % 4 == 0 else 1
    per_row = BWD_TILE_SLOTS // BWD_TILE_ROWS
    cols = max(1, min(W, per_row // -(-C // v)))
    return BWD_TILE_ROWS, cols, v


def bwd_tile_boxes(boxes: torch.Tensor, scale: float, H: int, W: int,
                   rows: Tuple[int, int], cols: Tuple[int, int]
                   ) -> torch.Tensor:
    """(B, K) bool: the boxes whose clamped window meets the tile
    [rows) x [cols), the list the backward kernel compacts per block (in
    ascending k).  The window of a box is [s, min(s + roi, limit)) on
    each axis, s its rounded start clamped to the map."""
    r = lambda v: torch.floor(v.float() * scale + 0.5).long()
    meets = None
    for (x1, x2), limit, (lo, hi) in (((1, 3), H, rows), ((0, 2), W, cols)):
        start = r(boxes[..., x1])
        roi = torch.clamp(r(boxes[..., x2]) - start + 1, min=1)
        s = torch.clamp(start, 0, limit)
        m = (s < hi) & (torch.clamp(s + roi, max=limit) > lo)
        meets = m if meets is None else meets & m
    return meets


def _forward(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
             out_size: Tuple[int, int], true_hw: Tuple[int, int],
             counter: str) -> torch.Tensor:
    """Launch the forward kernel on the leading `true_hw` of `feature`."""
    if feature.dtype not in _COUNTERS:
        raise TypeError(f"feature: expected bf16 or f32, got "
                        f"{feature.dtype}")
    B, rows, cols, C = feature.shape
    require(feature, "feature", feature.dtype)
    require(boxes, "boxes", torch.float32, (B, None, 4))
    K = boxes.shape[1]
    (H, W), (out_h, out_w) = true_hw, out_size
    out = torch.empty((B, K, out_h, out_w, C), dtype=feature.dtype,
                      device=feature.device)
    fn = kernel_function("roi_pool", "riders_roi_max_pool", _ARGTYPES)
    check(fn(feature.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W,
             C, K, out_h, out_w, scale, rows, cols,
             int(feature.dtype == torch.float32), stream_handle(feature)),
          counter)
    LAUNCHES[counter] += 1
    return out


def roi_max_pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """feature (B, H, W, C) NHWC, boxes (B, K, 4) f32 [x1, y1, x2, y2];
    returns (B, K, out_h, out_w, C).  On CUDA the feature is contiguous
    bf16 or f32 and the boxes contiguous f32."""
    if on_cpu(feature, boxes):
        return patches.roi_max_pool(feature, boxes, scale, out_size)
    return _forward(feature, boxes, scale, out_size, feature.shape[1:3],
                    _COUNTERS.get(feature.dtype, "roi_pool"))


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
    if dfeat.numel() == 0:
        return dfeat
    tile_h, tile_w, v = bwd_tiles(W, C)
    aligned = all(t.data_ptr() % 16 == 0 for t in (feature, pooled, grad,
                                                   dfeat))
    fn = kernel_function("roi_pool", "riders_roi_max_pool_bwd_f32",
                         _BWD_ARGTYPES)
    check(fn(feature.data_ptr(), boxes.data_ptr(), pooled.data_ptr(),
             grad.data_ptr(), dfeat.data_ptr(), B, H, W, C, K, out_h, out_w,
             scale, tile_h, tile_w, int(v == 4 and aligned),
             stream_handle(feature)), "roi_pool_bwd")
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


def roi_max_pool_4d(feature: torch.Tensor, boxes: torch.Tensor,
                    scale: float, out_size: Tuple[int, int],
                    true_hw: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """`roi_max_pool` of feature (B, H, W, C), or with `true_hw=(H, W)` of
    the leading (H, W) of a canvas (B, rows >= H, cols >= W, C) read in
    place (its padding, `NEG` in the JAX package, is never read).  On
    CUDA the canvas is contiguous bf16 or f32 and the boxes contiguous
    f32.  Returns (B, K, out_h, out_w, C)."""
    rows, cols = feature.shape[1:3]
    H, W = true_hw if true_hw is not None else (rows, cols)
    if rows < H or cols < W:
        raise ValueError(f"canvas {tuple(feature.shape)} is smaller than "
                         f"its true extent {(H, W)}")
    if on_cpu(feature, boxes):
        return patches.roi_max_pool(feature[:, :H, :W], boxes, scale,
                                    out_size)
    return _forward(feature, boxes, scale, out_size, (H, W), "roi_pool_4d")


def roi_pool_pyramid_4d(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                        boxes: torch.Tensor, patch_size: Tuple[int, int],
                        skip1_true_hw: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`roi_pool_pyramid` through `roi_max_pool_4d`, skips[0] optionally a
    canvas with true extent `skip1_true_hw`; inference only (no
    backward)."""
    skip1 = skips[0] if len(skips) else None

    def pool(feature, boxes, scale, out_size):
        hw = skip1_true_hw if feature is skip1 else None
        return roi_max_pool_4d(feature, boxes, scale, out_size, hw)
    return patches.roi_pool_pyramid(latent, skips, boxes, patch_size,
                                    pool=pool)
