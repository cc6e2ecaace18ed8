"""Fused stem: 7x7/s2 conv + folded BN + leaky-relu, and MaxPool2d(3, 2, 1).

`stem_conv_pool` launches the CUDA kernel (csrc/stem.cu) for CUDA
tensors and runs `stem_conv_pool_plain` for CPU tensors.  Both fold the
BN scale into the weights in f32 and round them to the input dtype (as
the TPU kernel does), accumulate in f32, add the bias, apply the leaky
relu, round to the input dtype, then max-pool that rounded map.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

KERNEL_SIZE, CIN, COUT = 7, 3, 32
NEGATIVE_SLOPE = 0.2              # the leaky relu of RC-Net's stem
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _folded(weight: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """BN scale folded into (Cout, Cin, k, k) weights, in f32."""
    return weight.float() * scale.float()[:, None, None, None]


def stem_conv_pool_plain(x: torch.Tensor, weight: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, W, Cin) NHWC; weight (Cout, Cin, k, k); scale, bias
    (Cout,).  Returns the conv map (B, ceil(H/2), ceil(W/2), Cout) and its
    MaxPool2d(3, 2, 1), both NHWC in x's dtype."""
    k = weight.shape[-1]
    w = _folded(weight, scale).to(x.dtype).float()
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w, stride=2, padding=k // 2)
    y = y + bias.float()[None, :, None, None]
    y = F.leaky_relu(y, NEGATIVE_SLOPE).to(x.dtype)
    pooled = F.max_pool2d(y, 3, 2, 1)
    return y.permute(0, 2, 3, 1), pooled.permute(0, 2, 3, 1)


def stem_conv_pool(x: torch.Tensor, weight: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused stem; see `stem_conv_pool_plain` for the contract.  On
    CUDA it takes a contiguous bf16 NHWC image with 3 channels and a
    (32, 3, 7, 7) weight, and returns contiguous NHWC outputs."""
    if on_cpu(x, weight, scale, bias):
        return stem_conv_pool_plain(x, weight, scale, bias)
    require(x, "image", torch.bfloat16, (None, None, None, CIN))
    if tuple(weight.shape) != (COUT, CIN, KERNEL_SIZE, KERNEL_SIZE):
        raise ValueError(f"stem weight: expected {(COUT, CIN, 7, 7)}, got "
                         f"{tuple(weight.shape)}")
    if scale.shape != (COUT,) or bias.shape != (COUT,):
        raise ValueError("stem scale/bias: expected (32,)")
    B, H, W, _ = x.shape
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    # (ky, kx, ci, co) bf16 weights and f32 bias, as the kernel reads them
    wk = _folded(weight, scale).permute(2, 3, 1, 0).contiguous().to(
        torch.bfloat16)
    bk = bias.float().contiguous()
    out = torch.empty((B, Ho, Wo, COUT), dtype=torch.bfloat16,
                      device=x.device)
    pooled = torch.empty((B, Hp, Wp, COUT), dtype=torch.bfloat16,
                         device=x.device)
    fn = kernel_function("stem", "riders_stem_conv_pool", _ARGTYPES)
    check(fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
             pooled.data_ptr(), B, H, W, stream_handle(x)), "stem")
    LAUNCHES["stem"] += 1
    return out, pooled
