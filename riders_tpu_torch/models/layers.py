"""Layer primitives of RC-Net (NCHW inside, channels_last on the card).

Semantics follow the JAX package's layers, which follow torch:
conv padding kernel_size // 2 symmetric, bias-free convs, leaky-relu
slope 0.2, BatchNorm eps 1e-5 with flax's running-statistics update
(`BatchNorm2d`), and UpConv = nearest resize to the target shape + conv.
Module and attribute names mirror the flax parameter tree so
`models.from_jax` can load JAX variables by path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.ops.kernels.stem import KERNEL_SIZE, stem_conv_pool
from riders_tpu_torch.ops.resize import resize_nchw

BN_EPS = 1e-5
BN_MOMENTUM = 0.1           # flax momentum 0.9: ra = 0.9 ra + 0.1 batch
# the activations the fused stem kernel applies, as max(y, slope * y)
STEM_SLOPES = {"leaky_relu": 0.2, "relu": 0.0, "linear": 1.0}


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's semantics, used by every BN of RC-Net and SML.

    In training it normalises with the batch's biased variance, as torch
    does, and updates the running statistics as flax does:
    ra = 0.9 ra + 0.1 batch, with the *biased* batch variance (torch's
    own BatchNorm2d stores the unbiased one).  In eval it uses the
    running statistics.  The eps is the module's (1e-5 for RC-Net and
    the SML stem, 1e-3 for EfficientNet)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(
                self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(
                self.running_var.dtype), alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def bn_fold(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A BatchNorm's running statistics folded into per-channel f32
    (scale, bias)."""
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return g, bn.bias.float() - bn.running_mean.float() * g


def activation_fn(name: str) -> Optional[Callable]:
    """Activation factory: 'linear' -> None, leaky-relu slope 0.2."""
    if "linear" in name:
        return None
    if "leaky_relu" in name:
        return lambda x: F.leaky_relu(x, 0.2)
    if "relu" in name:
        return F.relu
    if "elu" in name:
        return F.elu
    if "sigmoid" in name:
        return torch.sigmoid
    raise ValueError(f"Unsupported activation function: {name}")


class ConvBlock(nn.Module):
    """conv -> [batch norm] -> [activation]; the conv has no bias."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel_size, stride,
                              kernel_size // 2, bias=False)
        self.bn = BatchNorm2d(features) if use_batch_norm else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.activation(x) if self.activation is not None else x


class FusedStemConv(nn.Module):
    """7x7 stride-2 conv -> BN -> activation, plus MaxPool2d(3, 2, 1) of
    its output.

    In eval on a bf16 image, for the activations of `STEM_SLOPES`, it runs
    the fused stem kernel with the BN running statistics folded in (its
    plain version on the CPU).  Otherwise (training, an f32 image, elu or
    sigmoid) it runs the library conv, the BN (over the batch in
    training), the activation and the max pool, as the JAX stem does off
    its Pallas path.  Takes the NHWC image and returns (conv map, pooled
    map) as NCHW tensors, channels_last on the kernel path."""

    def __init__(self, in_ch: int = 3, features: int = 32,
                 activation_name: str = "leaky_relu"):
        super().__init__()
        self.activation = activation_fn(activation_name)
        self.slope = STEM_SLOPES.get(activation_name)
        self.conv = nn.Conv2d(in_ch, features, KERNEL_SIZE, 2,
                              KERNEL_SIZE // 2, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if (self.training or x.dtype != torch.bfloat16
                or self.slope is None):
            h = self.bn(self.conv(x.permute(0, 3, 1, 2)))
            if self.activation is not None:
                h = self.activation(h)
            return h, F.max_pool2d(h, 3, 2, 1)
        out, pooled = stem_conv_pool(x.contiguous(), self.conv.weight,
                                     *bn_fold(self.bn), self.slope)
        return out.permute(0, 3, 1, 2), pooled.permute(0, 3, 1, 2)


class UpConvBlock(nn.Module):
    """Nearest resize to `shape`, then a ConvBlock."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.conv = ConvBlock(in_ch, features, kernel_size, 1, activation,
                              use_batch_norm)

    def forward(self, x: torch.Tensor, shape: Tuple[int, int]
                ) -> torch.Tensor:
        return self.conv(resize_nchw(x, shape, "nearest"))


class FullyConnected(nn.Module):
    """Linear (with bias) -> activation."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[Callable] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=True)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.linear(x)
        return self.activation(x) if self.activation is not None else x


class ResNetBlock(nn.Module):
    """Basic residual block with a 1x1 projection on shape mismatch."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.conv1 = ConvBlock(in_ch, features, 3, stride, activation,
                               use_batch_norm)
        self.conv2 = ConvBlock(features, features, 3, 1, activation,
                               use_batch_norm)
        self.projection = (ConvBlock(in_ch, features, 1, stride)
                           if in_ch != features or stride != 1 else None)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.projection is not None:
            x = self.projection(x)
        out = out + x
        return self.activation(out) if self.activation else out


class DecoderBlock(nn.Module):
    """Nearest upsample to the skip's shape (or `shape`) + conv, concat the
    skip after it, fusion conv."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.deconv = UpConvBlock(in_ch, features, 3, activation,
                                  use_batch_norm)
        self.conv = ConvBlock(features + skip_ch, features, 3, 1, activation,
                              use_batch_norm)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        target = tuple(skip.shape[-2:]) if skip is not None else tuple(shape)
        h = self.deconv(x, target)
        if skip is not None:
            h = torch.cat([h, skip], dim=1)
        return self.conv(h)


# Nearest x2 taps composed through a 3-tap conv: for output phase p,
# _M_NEAREST2[p][j, d] maps conv tap d of the upsampled map to tap j of
# the coarse map (up[2i + p + d - 1] = x[i + j - 1]); row j = 2 (p = 0)
# or j = 0 (p = 1) is a structural zero.
_M_NEAREST2 = (((1.0, 0.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
               ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))


def nearest2x_phase_kernel(k: torch.Tensor) -> torch.Tensor:
    """Compose nearest-x2 upsample + 3x3 conv into one 3x3 conv on the
    coarse map whose output is the PHASE tensor: k (3, 3, Ci, F) HWIO ->
    (3, 3, Ci, 4F), output block (py * 2 + px) * F + f holding
    conv3x3(up2(x), k)[2i + py, 2j + px, f].  Summed in k's dtype (f32
    for the lane decoder, as in the JAX package)."""
    m = [torch.tensor(p, dtype=k.dtype, device=k.device) for p in _M_NEAREST2]
    return torch.cat([torch.einsum("ja,abio,lb->jlio", m[py], k, m[px])
                      for py in range(2) for px in range(2)], dim=-1)


def phase_compose_3x3(k: torch.Tensor) -> torch.Tensor:
    """Compose depth-to-space(2x) + zero-padded 3x3 conv into a 3x3 conv
    on the phase tensor: k (3, 3, C, F) -> (3, 3, 4C, 4F) with
    conv(z, K2)[i, j, (py, px, f)] = conv3x3(y, k)[2i + py, 2j + px, f]
    where z[i, j, (ry, rx, c)] = y[2i + ry, 2j + rx, c].  A fine tap
    2i + py + dy lands on coarse cell i + qy, phase ry, with (qy, ry) =
    divmod(py + dy, 2); the coarse conv's zero padding is exactly the fine
    conv's zero ring.  Every entry is a copy of one of k's, so the result
    is exact in any dtype."""
    C, F_ = k.shape[2], k.shape[3]
    k2 = k.new_zeros((3, 3, 4 * C, 4 * F_))
    for py in (0, 1):
        for px in (0, 1):
            for ry in (0, 1):
                for rx in (0, 1):
                    for qy in (-1, 0, 1):
                        dy = 2 * qy + ry - py
                        if not -1 <= dy <= 1:
                            continue
                        for qx in (-1, 0, 1):
                            dx = 2 * qx + rx - px
                            if not -1 <= dx <= 1:
                                continue
                            bi = (ry * 2 + rx) * C
                            bo = (py * 2 + px) * F_
                            k2[qy + 1, qx + 1, bi:bi + C, bo:bo + F_] = \
                                k[dy + 1, dx + 1]
    return k2


def depth_to_space2(z: torch.Tensor, features: int) -> torch.Tensor:
    """(..., h, w, 4F) phase-major -> (..., 2h, 2w, F)."""
    h, w = z.shape[-3], z.shape[-2]
    z = z.reshape(z.shape[:-1] + (2, 2, features))
    z = torch.movedim(z, (-3, -2), (-4, -2))
    return z.reshape(z.shape[:-5] + (2 * h, 2 * w, features))


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights for a model without a checkpoint: He-normal
    conv and linear weights, small biases, and BatchNorm affine terms and
    running statistics away from 0 / 1 so that BN folding is exercised.
    Draws on the CPU from a torch.Generator, so every device gets the
    same weights."""
    g = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, values: torch.Tensor) -> None:
        t.copy_(values.to(t.dtype))

    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            fill(m.weight, torch.randn(m.weight.shape, generator=g)
                 * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                fill(m.bias, 0.02 * torch.randn(m.bias.shape, generator=g))
        elif isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            fill(m.weight, 0.8 + 0.4 * torch.rand(n, generator=g))
            fill(m.bias, 0.1 * torch.randn(n, generator=g))
            fill(m.running_mean, 0.1 * torch.randn(n, generator=g))
            fill(m.running_var, 0.5 + torch.rand(n, generator=g))
        elif isinstance(m, nn.LayerNorm):
            n = m.normalized_shape
            fill(m.weight, 1.0 + 0.05 * torch.randn(n, generator=g))
            fill(m.bias, 0.05 * torch.randn(n, generator=g))
    return module


@torch.no_grad()
def init_training_(module: nn.Module, seed: int = 0) -> nn.Module:
    """The seeded initial weights of a training run, with flax's default
    initialisers, as the JAX package's trainers start from: conv and
    linear weights LeCun-normal truncated at two standard deviations,
    zero biases, BatchNorm, LayerNorm and GroupNorm at scale 1 and shift
    0, running statistics 0 / 1, and a module's own raw parameters by its
    `reset_jax_init_(generator)`.  Draws on the CPU from a
    torch.Generator, so every device gets the same weights."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            # flax's variance_scaling(1, 'fan_in', 'truncated_normal'); a
            # transposed conv's weight is (in, out, kh, kw)
            fan_in = (m.weight[:, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d)
                      else m.weight[0].numel())
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=g)
            m.weight.copy_(w.to(m.weight.dtype))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
        if hasattr(m, "reset_jax_init_"):
            m.reset_jax_init_(g)
    return module


def place(module: nn.Module, device: torch.device,
          dtype: torch.dtype) -> nn.Module:
    """Move a model to its device and dtype in eval mode (a trainer puts
    it in train mode); on the card its 4-D weights (and so its
    activations) use channels_last memory."""
    module = module.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        module = module.to(memory_format=torch.channels_last)
    return module
