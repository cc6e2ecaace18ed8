"""Fused stem: k x k / s2 conv + folded BN + max(y, slope * y), and
MaxPool2d(3, 2, 1).

`stem_conv_pool` launches a CUDA kernel for CUDA tensors and runs
`stem_conv_pool_plain` for CPU tensors.  Both fold the BN scale into the
weights in f32 and round them to the input dtype (as the TPU kernel
does), accumulate in f32, add the bias, apply max(y, slope * y) (slope
0.2: RC-Net's leaky relu; 0: relu; 1: linear), round to the input
dtype, then max-pool that rounded map.

Two hand-written kernels serve the card, chosen by shape:
* (k, Cin, Cout) = (7, 3, 32), RC-Net's stem, goes to the tuned kernel
  of csrc/stem.cu (launch count "stem").  It runs the 7x7x3 contraction
  as a GEMM on the tensor cores (mma.sync m16n8k16) with K = the 147
  taps (ky, kx, ci), each kernel row's 21 padded to 24, then to 176, in
  the order `k_order` gives.  `pack_weights` lays the folded weights out
  in the order its lanes read their B fragments; `k_offsets` gives each
  k's offset in the block's staged input tile, from which the lanes
  gather A.
* Every other odd k, Cin and Cout goes to the general kernel of
  csrc/stem_general.cu (launch count "stem_general"), on the plan of
  `general_plan` and the weights of `general_weights`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

KERNEL_SIZE, CIN, COUT = 7, 3, 32
NEGATIVE_SLOPE = 0.2              # the leaky relu of RC-Net's stem
K_STEPS = 11                      # K = 7 kernel rows x 24 padded to 176:
                                  # eleven 16-deep mma steps
POOLED_TILE = (8, 16)             # pooled rows, columns of a block (stem.cu)
STAGED_ROW_PITCH = 216            # bf16 per staged input row (stem.cu SP)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _folded(weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """BN scale folded into (Cout, Cin, k, k) weights, in f32."""
    return weight.float() * scale.float()[:, None, None, None]


def k_order() -> np.ndarray:
    """(176, 2): the staged-window element (ky, j) that GEMM row k holds,
    j = kx * 3 + ci of kernel row ky; (-1, -1) for the 29 padding rows.
    Each kernel row's 21 taps fill three groups of 8 rows (the last with
    3 rows of padding), k = 8 G + i holding kernel row G // 3, tap
    8 (G % 3) + i; group 21 is padding.  Lane t of the kernel loads rows
    (8 G + 2 t, + 1) as one 32-bit word at offset `k_offsets()[8 G]` + 2 t
    of its pixel's window."""
    order = np.full((16 * K_STEPS, 2), -1, np.int64)
    for G in range(3 * KERNEL_SIZE):
        for i in range(8):
            j = 8 * (G % 3) + i
            if j < KERNEL_SIZE * CIN:
                order[8 * G + i] = (G // 3, j)
    return order


def pack_weights(weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The folded weights as the kernel reads B: bf16 GEMM rows k in
    `k_order` (each kernel row's 21 taps padded to 24, then 176 rows), 32
    output channels each, the padding rows zero, in fragment order (s,
    half, lane, word, element).  Lane 4 g + t's 16 bytes of half h at
    k-step s are the m16n8k16 B fragments of n-tiles 2h and 2h + 1: per
    n-tile, rows (k, k + 1) and (k + 8, k + 9) at k = 16 s + 2 t, column
    8 n + g."""
    taps = _folded(weight, scale).to(torch.bfloat16).permute(2, 3, 1, 0)
    rows = KERNEL_SIZE * CIN
    wk = torch.cat([taps.reshape(KERNEL_SIZE, rows, COUT),
                    taps.new_zeros((KERNEL_SIZE, 24 - rows, COUT))], 1)
    wk = torch.cat([wk.reshape(-1, COUT), taps.new_zeros(
        (16 * K_STEPS - 24 * KERNEL_SIZE, COUT))])
    # k = 16 s + 8 u + 2 t + e, co = 16 h + 8 nn + g  ->  (s, h, g, t, nn,
    # u, e): word 2 nn + u of lane 4 g + t's half h
    return wk.reshape(K_STEPS, 2, 4, 2, 2, 2, 8).permute(
        0, 4, 6, 2, 5, 1, 3).contiguous().reshape(-1)


def k_offsets() -> np.ndarray:
    """(176,) the K -> shared offset table: GEMM row k's element in a
    staged input tile, relative to the pixel's input window corner,
    ky * STAGED_ROW_PITCH + j (stem.cu's koffset per group of 8); -1 for
    padding."""
    ky, j = k_order().T
    return np.where(ky >= 0, ky * STAGED_ROW_PITCH + j, -1)


def stem_conv_pool_plain(x: torch.Tensor, weight: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         slope: float = NEGATIVE_SLOPE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, W, Cin) NHWC; weight (Cout, Cin, k, k); scale, bias
    (Cout,); the activation max(y, slope * y).  Returns the conv map (B,
    ceil(H/2), ceil(W/2), Cout) and its MaxPool2d(3, 2, 1), both NHWC in
    x's dtype."""
    k = weight.shape[-1]
    w = _folded(weight, scale).to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, stride=2, padding=k // 2)
    y = y + bias.float()[None, :, None, None]
    y = torch.maximum(y, slope * y).to(x.dtype)
    pooled = F.max_pool2d(y, 3, 2, 1)
    return y.permute(0, 2, 3, 1), pooled.permute(0, 2, 3, 1)


# ---- the general kernel (csrc/stem_general.cu)

GENERAL_SMEM_LIMIT = 232448       # 227 KB of dynamic shared memory
GENERAL_PIXELS_PER_THREAD = 4     # stem_general.cu PPT
GENERAL_CHANNELS_PER_THREAD = 8   # stem_general.cu CG
_GENERAL_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                     + [ctypes.c_float, ctypes.c_void_p])


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def general_smem_bytes(tp: int, co: int, cin: int, k: int) -> int:
    """Shared memory of a general-kernel plan (stem_general.cu:layout):
    the chunk's f32 weights, the staged f32 input tile in its column-
    parity layout, the tap offsets and the bf16 conv tile."""
    ti = 4 * tp + k
    halfw = (ti + 1) // 2
    taps = k * k * cin
    tch = 2 * tp + 1
    return (_align16(taps * co * 4) + _align16(ti * 2 * halfw * cin * 4)
            + _align16(taps * 4) + _align16(tch * tch * co * 2))


def general_plan(cin: int, cout: int, k: int) -> Tuple[int, int, int, int]:
    """(tp, co, threads, smem_bytes) of the general kernel: a tp x tp
    tile of pooled outputs per block, Cout in chunks of co channels, one
    thread per four conv pixels and eight channels of a chunk.  The
    largest tile (8, 4, 2, 1), then the largest chunk (Cout rounded up
    to 8 and at most 32, then 16, 8), whose shared memory fits 227 KB;
    raises for a shape that no plan fits."""
    if k % 2 != 1 or min(cin, cout, k) < 1:
        raise ValueError(f"stem kernel: an odd k and Cin, Cout >= 1, got "
                         f"k={k}, Cin={cin}, Cout={cout}")
    widest = min(32, -(-cout // 8) * 8)
    for tp in (8, 4, 2, 1):
        for co in sorted({widest, 16, 8}, reverse=True):
            if co > widest:
                continue
            smem = general_smem_bytes(tp, co, cin, k)
            if smem <= GENERAL_SMEM_LIMIT:
                tch = 2 * tp + 1
                slots = -(-tch * tch // GENERAL_PIXELS_PER_THREAD)
                items = slots * (co // GENERAL_CHANNELS_PER_THREAD)
                threads = min(1024, -(-items // 32) * 32)
                return tp, co, threads, smem
    raise ValueError(
        f"stem kernel: a {k}x{k} stem over Cin={cin} needs more than "
        f"{GENERAL_SMEM_LIMIT} bytes of shared memory at its smallest "
        f"plan (a 1x1 pooled tile, 8 channels)")


def general_weights(weight: torch.Tensor, scale: torch.Tensor, co: int
                    ) -> torch.Tensor:
    """The folded weights as the general kernel reads them: rounded to
    bf16, held in f32, (chunks, k, k, Cin, co) with Cout zero-padded to
    whole chunks of co channels."""
    cout, cin, k, _ = weight.shape
    w = _folded(weight, scale).to(torch.bfloat16).float()
    chunks = -(-cout // co)
    w = F.pad(w.permute(2, 3, 1, 0), (0, chunks * co - cout))
    return w.reshape(k, k, cin, chunks, co).permute(3, 0, 1, 2, 4
                                                    ).contiguous()


def stem_conv_pool(x: torch.Tensor, weight: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor,
                   slope: float = NEGATIVE_SLOPE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused stem; see `stem_conv_pool_plain` for the contract.  On
    CUDA it takes a contiguous bf16 NHWC image, a (Cout, Cin, k, k)
    weight with an odd k, and returns contiguous NHWC outputs: (7, 3, 32)
    on the tuned kernel, every other shape on the general one."""
    if on_cpu(x, weight, scale, bias):
        return stem_conv_pool_plain(x, weight, scale, bias, slope)
    cout, cin, k, kw = weight.shape
    require(x, "image", torch.bfloat16, (None, None, None, cin))
    if kw != k:
        raise ValueError(f"stem weight: a square kernel, got "
                         f"{tuple(weight.shape)}")
    if scale.shape != (cout,) or bias.shape != (cout,):
        raise ValueError(f"stem scale/bias: expected ({cout},)")
    if (k, cin, cout) != (KERNEL_SIZE, CIN, COUT):
        return _launch_general(x, weight, scale, bias, slope)
    if x.data_ptr() % 16:
        raise ValueError("image: the stem kernel reads 16-byte aligned rows")
    return _launch(x, pack_weights(weight, scale), bias.float().contiguous(),
                   slope)


def _launch_general(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor, slope: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The general kernel on a checked CUDA image."""
    cout, cin, k, _ = weight.shape
    tp, co, threads, smem = general_plan(cin, cout, k)
    B, H, W, _ = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    out = torch.empty((B, Ho, Wo, cout), dtype=torch.bfloat16,
                      device=x.device)
    pooled = torch.empty((B, Hp, Wp, cout), dtype=torch.bfloat16,
                         device=x.device)
    if pooled.numel() == 0:
        return out, pooled
    wk = general_weights(weight, scale, co)
    bk = F.pad(bias.float(), (0, wk.shape[0] * co - cout)).contiguous()
    fn = kernel_function("stem_general", "riders_stem_general",
                         _GENERAL_ARGTYPES)
    check(fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
             pooled.data_ptr(), B, H, W, cin, cout, k, tp, co, threads,
             smem, float(slope), stream_handle(x)), "stem_general")
    LAUNCHES["stem_general"] += 1
    return out, pooled


def _launch(x: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
            slope: float = NEGATIVE_SLOPE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tuned kernel on a checked CUDA image, `pack_weights`' output
    and the f32 bias."""
    B, H, W, _ = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    out = torch.empty((B, Ho, Wo, COUT), dtype=torch.bfloat16,
                      device=x.device)
    pooled = torch.empty((B, Hp, Wp, COUT), dtype=torch.bfloat16,
                         device=x.device)
    if pooled.numel() == 0:
        return out, pooled
    fn = kernel_function("stem", "riders_stem_conv_pool", _ARGTYPES)
    check(fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
             pooled.data_ptr(), B, H, W, float(slope), stream_handle(x)),
          "stem")
    LAUNCHES["stem"] += 1
    return out, pooled
