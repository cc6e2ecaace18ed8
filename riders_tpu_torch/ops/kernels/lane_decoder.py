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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

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
                  + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_UP_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])


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
    fn = kernel_function("lane_decoder", "riders_lane_conv3x3",
                         _CONV_ARGTYPES)
    check(fn(xs[0].data_ptr(), ws[0].data_ptr(), xs[0].shape[3], x1, w1, c1,
             sp, bp, out.data_ptr(), N, H, W, Co, *_act(slope),
             _vectorised(*xs, *ws), stream_handle(out)), "lane_conv3x3")
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
    _scale_bias(scale, bias, f)
    s4, b4 = ((scale.repeat(4), bias.repeat(4)) if scale is not None
              else (None, None))
    out = torch.empty((N, 2 * h, 2 * w_, f), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn = kernel_function("lane_decoder", "riders_lane_upconv2x",
                         _UP_ARGTYPES)
    check(fn(x.data_ptr(), w.data_ptr(), ci,
             0 if s4 is None else s4.data_ptr(),
             0 if b4 is None else b4.data_ptr(), out.data_ptr(), N, h, w_, f,
             *_act(slope), _vectorised(x, w), stream_handle(out)),
          "lane_upconv2x")
    LAUNCHES["lane_upconv2x"] += 1
    return out
