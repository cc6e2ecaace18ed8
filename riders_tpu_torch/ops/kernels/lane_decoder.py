"""The lane-major decoder's convolutions on NHWC bf16 patch maps.

`lane_conv3x3` (a SAME 3x3 conv over the channel concat of one or two
maps, folded BN, optional leaky-relu) and `lane_upconv2x` (nearest x2
upsample + that conv) launch the CUDA kernels of csrc/lane_decoder.cu for
CUDA tensors and run `lane_conv3x3_plain` / `lane_upconv2x_plain` for CPU
tensors; they count launches as `lane_conv3x3` and `lane_upconv2x`.

Both take packed weights, made once per module by `pack_conv` /
`pack_upconv` from an HWIO (3, 3, Ci, Co) kernel: the conv's weights are
bf16(k), the upconv's bf16(nearest2x_phase_kernel(k)), composed in f32
and rounded once, as the JAX package packs them.  Inputs are bf16,
products accumulate in f32, then acc * scale + bias (scale None: linear),
leaky-relu(slope) (None: none), and one rounding to bf16.

`conv_plan` sizes the conv kernel's blocks: the column tile from Co, and
the padded positions each block stages (its tile's span in the
zero-bordered frame stack plus the (W + 3) halo on either side).  Where
every input comes in whole 16-byte channel runs and a column tile's
weights fit in shared memory beside two stages of rows, within
RESIDENT_SMEM_LIMIT, the weights stay resident in a persistent grid
whose tiles are runs of 256 padded positions; otherwise they stream with
the rows, one block per tile of output pixels, shrunk until two stages
fit.

`upconv_plan` sizes the upconv kernel's blocks the same way on the
coarse map: where F <= 32, the input comes in whole 16-byte runs and the
weights fit within RESIDENT_SMEM_LIMIT, all four output phases of a
tile go to one block of a persistent grid with the weights resident, so
each input byte is staged once; otherwise the weights stream with
64-column tiles of one phase.  Each phase multiplies only the four
coarse taps `phase_taps` names, where its composed weights are nonzero.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from riders_tpu_torch.models.layers import (depth_to_space2,
                                            nearest2x_phase_kernel)
from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_CONV_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_UP_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p])

# the conv kernel's tiles (compiled in csrc/lane_decoder.cu): output
# channels per block -> (most output pixels per block, input channels per
# staged chunk) with streamed weights; with resident weights every tile
# takes RESIDENT_BK channels per chunk
CONV_TILES = {8: (256, 32), 16: (256, 32), 32: (256, 32), 64: (256, 16)}
RESIDENT_BK = 32
SMEM_LIMIT = 232448         # bytes of shared memory a block may use
# Resident weights where their kernel needs at most this much shared
# memory (one block per SM past 113 KB): at 4096-6144 patches the 64 -> 64
# convs' 148-155 KB ran 6-12% faster than streaming the weights, the
# 128 -> 64 convs' 217-220 KB no faster, on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md)
RESIDENT_SMEM_LIMIT = 160 * 1024
# the upconv kernel's tiles (compiled in csrc/lane_decoder.cu): streamed
# weights take (columns of one phase, most coarse pixels, input channels
# per staged chunk) per block; resident weights take all four phases of
# F <= 32 columns and UPCONV_RESIDENT_M padded positions per tile with
# RESIDENT_BK channels per chunk (256 positions, one block per SM, ran
# slower than 128, two, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
UPCONV_TILE = (64, 256, 16)
UPCONV_RESIDENT_BN, UPCONV_RESIDENT_M = 32, 128


@dataclass(frozen=True)
class ConvPlan:
    bn: int                 # output channels per block
    tile_m: int             # the tile's most output pixels per block
    bk: int                 # input channels per staged chunk
    resident: bool          # weights resident, a persistent grid
    bm: int                 # output pixels (resident: padded positions)
                            # per tile
    rows: int               # padded positions staged per tile and chunk
    smem: int               # bytes of shared memory per block
    tiles: int              # tiles (streamed: blocks) along the pixels


def halo_rows(bm: int, H: int, W: int) -> int:
    """Padded positions a block of `bm` consecutive output pixels stages:
    its pixels' span in the stack of (H+2) x (W+2) frames (each row break
    adds 2, each frame break 2 (W+2) more) plus W+3 on either side."""
    k = bm - 1
    span = k + 2 * -(-k // W) + 2 * (W + 2) * -(-k // (H * W))
    return span + 2 * (W + 3) + 1


def conv_smem(bn: int, tile_m: int, bk: int, rows: int,
              taps: int = 9) -> int:
    """Bytes of shared memory with streamed weights: two stages of `rows`
    staged rows of bk + 8 bf16 and taps x bn x bk weights, the epilogue
    tile (tile_m rows of bn + 8 bf16) overlapping them, and the rows'
    source table."""
    ring = 2 * (rows * (bk + 8) + taps * bn * bk) * 2
    return max(ring, tile_m * (bn + 8) * 2) + 4 * rows


def resident_smem(bn: int, bk: int, rows: int, chunks: int,
                  taps: int = 9, epilogue_rows: int = 256) -> int:
    """Bytes of shared memory with resident weights: all `chunks` chunks'
    taps x bn x bk weights, two stages of `rows` rows of bk bf16, the
    epilogue tile (the conv's 256 rows of bn + 8 bf16; none for the
    upconv, which stores from registers) and the rows' source table."""
    return (chunks * taps * bn * bk + 2 * rows * bk
            + epilogue_rows * (bn + 8)) * 2 + 4 * rows


def padded_span(N: int, H: int, W: int) -> Tuple[int, int]:
    """The padded positions of the first and the last map pixel in the
    stack of N (H+2) x (W+2) zero-bordered frames."""
    Wp = W + 2
    return Wp + 1, (N - 1) * (H + 2) * Wp + H * Wp + W


def conv_plan(N: int, H: int, W: int, cis: Sequence[int], co: int,
              vec: bool = True) -> ConvPlan:
    """The conv kernel's tiling of an (N, H, W) map stack with input
    widths `cis` into Co channels (vec: the inputs come in whole 16-byte
    channel runs); raises where even 16 pixels' halo does not fit."""
    bn = next((t for t in (8, 16, 32) if co <= t), 64)
    tile_m, bk = CONV_TILES[bn]
    M = N * H * W
    top = min(tile_m, -(-M // 16) * 16)
    if vec:
        rows = 256 + 2 * (W + 3)
        chunks = sum(-(-c // RESIDENT_BK) for c in cis)
        smem = resident_smem(bn, RESIDENT_BK, rows, chunks)
        if smem <= RESIDENT_SMEM_LIMIT:
            first, last = padded_span(N, H, W)
            return ConvPlan(bn, 256, RESIDENT_BK, True, 256, rows, smem,
                            (last - first) // 256 + 1)
    for bm in range(top, 0, -16):
        rows = halo_rows(bm, H, W)
        smem = conv_smem(bn, tile_m, bk, rows)
        if smem <= SMEM_LIMIT:
            return ConvPlan(bn, tile_m, bk, False, bm, rows, smem,
                            -(-M // bm))
    raise ValueError(f"lane_conv3x3: maps {W} wide need a halo beyond "
                     f"shared memory")


@dataclass(frozen=True)
class UpconvPlan:
    bn: int                 # columns of F per block and phase
    tile_m: int             # the tile's most coarse pixels per block
    bk: int                 # input channels per staged chunk
    resident: bool          # weights resident, a persistent grid, all
                            # four phases a block (else one)
    bm: int                 # coarse pixels (resident: padded positions)
                            # per tile
    rows: int               # padded positions staged per tile and chunk
    smem: int               # bytes of shared memory per block
    tiles: int              # tiles (streamed: blocks) along the pixels
    col_blocks: int         # blocks along the columns (gridDim.y)


def phase_taps(p: int) -> Tuple[Tuple[int, int], ...]:
    """The coarse taps (dy, dx) that output phase p = (r, s) = divmod(p, 2)
    reads, in the kernel's order i = 0..3: (r + i // 2, s + i % 2)."""
    r, s = divmod(p, 2)
    return tuple((r + i // 2, s + i % 2) for i in range(4))


def upconv_plan(N: int, h: int, w: int, ci: int, f: int,
                vec: bool = True) -> UpconvPlan:
    """The upconv kernel's tiling of an (N, h, w) coarse map stack with
    Ci input channels into 4F columns (vec: the input comes in whole
    16-byte channel runs); raises where even 16 pixels' halo does not
    fit."""
    if f <= UPCONV_RESIDENT_BN and vec:
        bn, bm = UPCONV_RESIDENT_BN, UPCONV_RESIDENT_M
        rows = bm + 2 * (w + 3)
        smem = resident_smem(bn, RESIDENT_BK, rows, -(-ci // RESIDENT_BK),
                             16, 0)
        if smem <= RESIDENT_SMEM_LIMIT:
            first, last = padded_span(N, h, w)
            return UpconvPlan(bn, bm, RESIDENT_BK, True, bm, rows, smem,
                              (last - first) // bm + 1, 1)
    bn, tile_m, bk = UPCONV_TILE
    M = N * h * w
    for bm in range(min(tile_m, -(-M // 16) * 16), 0, -16):
        rows = halo_rows(bm, h, w)
        smem = conv_smem(bn, tile_m, bk, rows, 4)
        if smem <= SMEM_LIMIT:
            return UpconvPlan(bn, tile_m, bk, False, bm, rows, smem,
                              -(-M // bm), 4 * -(-f // bn))
    raise ValueError(f"lane_upconv2x: maps {w} wide need a halo beyond "
                     f"shared memory")


def pack_conv(k: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Ci, Co) -> the conv kernel's (Co, 3, 3, Ci) bf16."""
    return k.permute(3, 0, 1, 2).to(torch.bfloat16).contiguous()


def pack_upconv(k: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Ci, F) -> the upconv kernel's phase-composed
    (4F, 3, 3, Ci) bf16, composed in f32 and rounded once."""
    return pack_conv(nearest2x_phase_kernel(k.float()))


def _epilogue(y: torch.Tensor, scale, bias, slope) -> torch.Tensor:
    if scale is not None:
        y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    if slope is not None:
        y = torch.where(y > 0, y, slope * y)
    return y.to(torch.bfloat16)


def lane_conv3x3_plain(xs: Sequence[torch.Tensor],
                       ws: Sequence[torch.Tensor],
                       scale: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor],
                       slope: Optional[float]) -> torch.Tensor:
    """xs: (N, H, W, Ci_k) maps; ws: their (Co, 3, 3, Ci_k) weight slices.
    Returns the SAME 3x3 conv of the channel concat, (N, H, W, Co) bf16:
    an f32 conv of the bf16-rounded inputs and weights, then the
    epilogue."""
    x = torch.cat([t.to(torch.bfloat16).float() for t in xs], -1)
    w = torch.cat([t.to(torch.bfloat16).float() for t in ws], -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), padding=1)
    return _epilogue(y, scale, bias, slope).permute(0, 2, 3, 1).contiguous()


def lane_upconv2x_plain(x: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor],
                        slope: Optional[float]) -> torch.Tensor:
    """x (N, h, w, Ci); w the (4F, 3, 3, Ci) phase-composed weights; scale,
    bias (F,).  Returns (N, 2h, 2w, F) bf16: the conv with the composed
    weights on the coarse map, then depth_to_space2."""
    f = w.shape[0] // 4
    tile = (lambda t: None if t is None else t.repeat(4))
    y = lane_conv3x3_plain([x], [w], tile(scale), tile(bias), slope)
    return depth_to_space2(y, f).contiguous()


def _scale_bias(scale, bias, n: int):
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias: give both or neither")
    if scale is None:
        return 0, 0
    require(scale, "scale", torch.float32, (n,))
    require(bias, "bias", torch.float32, (n,))
    return scale.data_ptr(), bias.data_ptr()


def _vectorised(*tensors: torch.Tensor) -> int:
    """1 when every map's channels come in whole 16-byte runs."""
    return int(all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
                   for t in tensors))


def _act(slope):
    return (0.0, 0) if slope is None else (float(slope), 1)


def lane_conv3x3(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                 scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                 slope: Optional[float]) -> torch.Tensor:
    """See `lane_conv3x3_plain`.  On CUDA: one or two contiguous bf16
    (N, H, W, Ci_k) maps, contiguous bf16 (Co, 3, 3, Ci_k) weights and
    contiguous f32 (Co,) scale and bias, or neither."""
    sb = [t for t in (scale, bias) if t is not None]
    if on_cpu(*xs, *ws, *sb):
        return lane_conv3x3_plain(xs, ws, scale, bias, slope)
    if len(xs) not in (1, 2) or len(ws) != len(xs):
        raise ValueError(f"one or two inputs with a weight each, got "
                         f"{len(xs)} inputs and {len(ws)} weights")
    N, H, W = xs[0].shape[:3]
    Co = ws[0].shape[0]
    for i, (x, w) in enumerate(zip(xs, ws)):
        require(x, f"x{i}", torch.bfloat16, (N, H, W, None))
        require(w, f"w{i}", torch.bfloat16, (Co, 3, 3, x.shape[3]))
    sp, bp = _scale_bias(scale, bias, Co)
    out = torch.empty((N, H, W, Co), dtype=torch.bfloat16,
                      device=xs[0].device)
    if out.numel() == 0:
        return out
    x1, w1, c1 = ((xs[1].data_ptr(), ws[1].data_ptr(), xs[1].shape[3])
                  if len(xs) == 2 else (0, 0, 0))
    vec = _vectorised(*xs, *ws)
    plan = conv_plan(N, H, W, [x.shape[3] for x in xs], Co, bool(vec))
    fn = kernel_function("lane_decoder", "riders_lane_conv3x3",
                         _CONV_ARGTYPES)
    check(fn(xs[0].data_ptr(), ws[0].data_ptr(), xs[0].shape[3], x1, w1, c1,
             sp, bp, out.data_ptr(), N, H, W, Co, *_act(slope), vec,
             plan.bn, plan.tile_m, plan.bk, int(plan.resident), plan.bm,
             plan.rows, stream_handle(out)), "lane_conv3x3")
    LAUNCHES["lane_conv3x3"] += 1
    return out


def lane_upconv2x(x: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor],
                  slope: Optional[float]) -> torch.Tensor:
    """See `lane_upconv2x_plain`.  On CUDA: a contiguous bf16 (N, h, w, Ci)
    map, contiguous bf16 (4F, 3, 3, Ci) weights from `pack_upconv` and
    contiguous f32 (F,) scale and bias, or neither."""
    sb = [t for t in (scale, bias) if t is not None]
    if on_cpu(x, w, *sb):
        return lane_upconv2x_plain(x, w, scale, bias, slope)
    N, h, w_, ci = x.shape
    if w.shape[0] % 4:
        raise ValueError(f"upconv weights: 4F rows expected, got "
                         f"{tuple(w.shape)}")
    f = w.shape[0] // 4
    require(x, "x", torch.bfloat16)
    require(w, "w", torch.bfloat16, (4 * f, 3, 3, ci))
    sp, bp = _scale_bias(scale, bias, f)
    out = torch.empty((N, 2 * h, 2 * w_, f), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    vec = _vectorised(x, w)
    plan = upconv_plan(N, h, w_, ci, f, bool(vec))
    fn = kernel_function("lane_decoder", "riders_lane_upconv2x",
                         _UP_ARGTYPES)
    check(fn(x.data_ptr(), w.data_ptr(), ci, sp, bp, out.data_ptr(), N, h,
             w_, f, *_act(slope), vec, plan.bn, plan.tile_m, plan.bk,
             int(plan.resident), plan.bm, plan.rows, stream_handle(out)),
          "lane_upconv2x")
    LAUNCHES["lane_upconv2x"] += 1
    return out
