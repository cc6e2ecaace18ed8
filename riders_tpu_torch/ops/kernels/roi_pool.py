"""RoI max pool of K fixed-size boxes per frame, at every pyramid scale,
and its backward.

`roi_max_pool` launches the CUDA forward kernel (csrc/roi_pool.cu) for
CUDA tensors, bf16 or f32, and runs its plain version,
`ops.patches.roi_max_pool`, for CPU tensors; it counts bf16 launches as
`roi_pool` and f32 ones as `roi_pool_f32`.  The forward kernel takes a
table of up to five maps: `roi_pool_pyramid` pools a whole pyramid in
one launch (one count), `roi_max_pool` is a table of one.  `fwd_plan`
splits the work into blocks of one (scale, frame, box, strip of output
rows).  `roi_max_pool_backward` does the same
for d(feature) (`ops.patches.roi_max_pool_backward`), f32 only, as the
training forward runs f32.  `RoIMaxPool` joins the two as an autograd
function, one forward and one backward launch per scale;
`roi_pool_pyramid` routes through it where grad is enabled and a map
requires it.  The backward kernel runs one block per (frame, tile):
`bwd_tiles` sizes the tile, and `bwd_tile_boxes` gives the boxes a
tile's block lists (the kernel builds that list itself, on the card).

`roi_max_pool_4d` is the same pool on a map or on a canvas read in place
over its true extent (a `NEG`-padded canvas, as the JAX package's 4D
pool takes it), the same kernel given the canvas's pitches, counted as
`roi_pool_4d`; `roi_pool_pyramid_4d` pools every scale in one launch.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
NEG = -1e30                 # the fill of a padded canvas, as in JAX
# element type -> launch counter of the plain-map forward
_COUNTERS = {torch.bfloat16: "roi_pool", torch.float32: "roi_pool_f32"}
FWD_BLOCK_ELEMS = 2048      # (output row, thread slot) elements a forward
                            # block aims at: 8 per thread
FWD_MAX_SCALES = 5          # maps per forward launch (its table's rows)
MAX_BOXES_BWD = 2048        # the backward lists 20 bytes per box per block
BWD_TILE_ROWS = 8           # rows per backward tile
BWD_TILE_SLOTS = 512        # (pixel, channel group) slots per tile: two
                            # for each of the block's 256 threads


class FwdScale(NamedTuple):
    """One map's row of the forward kernel's table: output rows, channels
    per thread slot (`vec`), slots per output row, output rows per block
    (`rows`), blocks per (frame, box) (`strips`) and the scale's first
    block."""
    out_h: int
    vec: int
    slots: int
    rows: int
    strips: int
    block0: int


def fwd_vec(C: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Channels per forward thread slot: one 16-byte vector (8 bf16, 4
    f32) where C is a multiple of it and the pointers are aligned, else
    1."""
    wide = 16 // dtype.itemsize
    return wide if C % wide == 0 and aligned else 1


def fwd_plan(B: int, K: int, scales: Sequence[Tuple[int, int, int, int]]
             ) -> List[FwdScale]:
    """The forward launch's work split.  scales: (C, out_h, out_w, vec)
    per map.  A block pools `rows` output rows of one (frame, box) at one
    scale, about FWD_BLOCK_ELEMS (row, slot) elements; the strips of a
    patch are balanced.  Blocks are numbered scale by scale, then
    (frame, box), then strip."""
    plan, block0 = [], 0
    for C, out_h, out_w, vec in scales:
        slots = out_w * (C // vec)
        if out_h <= 0 or slots <= 0:
            plan.append(FwdScale(out_h, vec, max(slots, 0), 1, 0, block0))
            continue
        rows = max(1, min(out_h, -(-FWD_BLOCK_ELEMS // slots)))
        strips = -(-out_h // rows)
        rows = -(-out_h // strips)
        plan.append(FwdScale(out_h, vec, slots, rows, strips, block0))
        block0 += B * K * strips
    return plan


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


def _forward(levels, boxes: torch.Tensor, counter: str
             ) -> List[torch.Tensor]:
    """One launch of the forward kernel pooling every level, a (feature,
    (H, W) true extent, scale, out_size) each, of which the leading
    (H, W) is read; returns the pooled maps."""
    dtype = levels[0][0].dtype
    if dtype not in _COUNTERS:
        raise TypeError(f"feature: expected bf16 or f32, got {dtype}")
    if len(levels) > FWD_MAX_SCALES:
        raise ValueError(f"at most {FWD_MAX_SCALES} maps per launch")
    B = levels[0][0].shape[0]
    require(boxes, "boxes", torch.float32, (B, None, 4))
    K = boxes.shape[1]
    outs, dims, shapes = [], [], []
    for feature, (H, W), _, (out_h, out_w) in levels:
        require(feature, "feature", dtype, (B, None, None, None))
        C = feature.shape[3]
        out = torch.empty((B, K, out_h, out_w, C), dtype=dtype,
                          device=feature.device)
        aligned = feature.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
        outs.append(out)
        shapes.append((C, out_h, out_w, fwd_vec(C, dtype, aligned)))
        dims.append((H, W, C) + tuple(feature.shape[1:3]) + (out_h, out_w))
    plan = fwd_plan(B, K, shapes)
    if all(s.strips == 0 for s in plan):
        return outs
    n = len(levels)
    fn = kernel_function("roi_pool", "riders_roi_pool_pyramid",
                         _FWD_ARGTYPES)
    check(fn((ctypes.c_void_p * n)(*[lv[0].data_ptr() for lv in levels]),
             (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
             (ctypes.c_int * (10 * n))(*[v for d, s in zip(dims, plan)
                                         for v in d + (s.vec, s.rows,
                                                       s.strips)]),
             (ctypes.c_float * n)(*[lv[2] for lv in levels]), n,
             boxes.data_ptr(), B, K, int(dtype == torch.float32),
             stream_handle(boxes)), counter)
    LAUNCHES[counter] += 1
    return outs


def roi_max_pool(feature: torch.Tensor, boxes: torch.Tensor, scale: float,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """feature (B, H, W, C) NHWC, boxes (B, K, 4) f32 [x1, y1, x2, y2];
    returns (B, K, out_h, out_w, C).  On CUDA the feature is contiguous
    bf16 or f32 and the boxes contiguous f32."""
    if on_cpu(feature, boxes):
        return patches.roi_max_pool(feature, boxes, scale, out_size)
    return _forward([(feature, feature.shape[1:3], scale, out_size)], boxes,
                    _COUNTERS.get(feature.dtype, "roi_pool"))[0]


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


def _pyramid(maps: Sequence[torch.Tensor], true_hw, boxes: torch.Tensor,
             patch_size: Tuple[int, int], counter: str
             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Every map of a pyramid (skips shallow to deep, then the latent),
    each read over its true extent, in one forward launch (FWD_MAX_SCALES
    maps per launch)."""
    levels = [(m, hw, s, size) for m, hw, (s, size) in zip(
        maps, true_hw, patches.pyramid_levels(len(maps) - 1, patch_size))]
    outs = []
    for i in range(0, len(levels), FWD_MAX_SCALES):
        outs += _forward(levels[i:i + FWD_MAX_SCALES], boxes, counter)
    return outs[-1], outs[:-1]


def roi_pool_pyramid(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                     boxes: torch.Tensor, patch_size: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`ops.patches.roi_pool_pyramid` through the kernels.  On CUDA, one
    forward launch pools the whole pyramid; where a map needs a gradient
    (grad enabled), each scale goes through `RoIMaxPool` instead, one
    forward and one backward launch per scale."""
    maps = list(skips) + [latent]
    if torch.is_grad_enabled() and any(m.requires_grad for m in maps):
        return patches.roi_pool_pyramid(latent, skips, boxes, patch_size,
                                        pool=roi_max_pool_diff)
    if on_cpu(*maps, boxes):
        return patches.roi_pool_pyramid(latent, skips, boxes, patch_size)
    return _pyramid(maps, [m.shape[1:3] for m in maps], boxes, patch_size,
                    _COUNTERS.get(latent.dtype, "roi_pool"))


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
    return _forward([(feature, (H, W), scale, out_size)], boxes,
                    "roi_pool_4d")[0]


def roi_pool_pyramid_4d(latent: torch.Tensor, skips: Sequence[torch.Tensor],
                        boxes: torch.Tensor, patch_size: Tuple[int, int],
                        skip1_true_hw: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """`roi_pool_pyramid` through the 4D pool, skips[0] optionally a
    canvas with true extent `skip1_true_hw`, all scales in one launch on
    CUDA (counted as `roi_pool_4d`); inference only (no backward)."""
    maps = list(skips) + [latent]
    true_hw = [m.shape[1:3] for m in maps]
    if len(skips) and skip1_true_hw is not None:
        true_hw[0] = tuple(skip1_true_hw)
        if any(t > s for t, s in zip(true_hw[0], maps[0].shape[1:3])):
            raise ValueError(f"canvas {tuple(maps[0].shape)} is smaller "
                             f"than its true extent {true_hw[0]}")
    if on_cpu(*maps, boxes):
        return patches.roi_pool_pyramid(
            latent, [m[:, :H, :W] for m, (H, W) in zip(skips, true_hw)],
            boxes, patch_size)
    return _pyramid(maps, true_hw, boxes, patch_size, "roi_pool_4d")
