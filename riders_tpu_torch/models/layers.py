"""Layer primitives of RC-Net (NCHW inside, channels_last on the card).

Semantics follow the JAX package's layers, which follow torch:
conv padding kernel_size // 2 symmetric, bias-free convs, leaky-relu
slope 0.2, BatchNorm eps 1e-5 with flax's running-statistics update
(`BatchNorm2d`), and UpConv = nearest resize to the target shape + conv.
Module and attribute names mirror the flax parameter tree so
`models.from_jax` can load JAX variables by path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.ops.kernels.stem import (KERNEL_SIZE, stem_apply,
                                               stem_weights)
from riders_tpu_torch.ops.resize import resize_nchw
from riders_tpu_torch.parallel.sharding import (batch_norm_axis,
                                                cross_rank_batch_norm)

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
    the SML stem, 1e-3 for EfficientNet).

    Inside a sharded training step the statistics are the global
    batch's, over the mesh axis `parallel.sharding.batch_norm_axis`
    names (`parallel.sharding.cross_rank_batch_norm`)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__(num_features, eps=eps, momentum=BN_MOMENTUM)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean.to(
                self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(
                self.running_var.dtype), alpha=m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        axis = batch_norm_axis(self)
        if axis is not None:
            y, mean, var = cross_rank_batch_norm(x, self.weight, self.bias,
                                                 self.eps, axis)
            self._update_running(mean, var)
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
        self._update_running(mean, var)
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
    """k x k stride-2 conv -> [BN] -> activation, with `fuse_pool` also
    MaxPool2d(3, 2, 1) of its output.

    In eval on a bf16 image, for the activations of `STEM_SLOPES` and a
    kernel size with k % 4 == 3 (JAX's condition for its Pallas stem), it
    runs the fused stem kernel with the BN running statistics folded in,
    or scale 1 and bias 0 without BN (its plain version on the CPU); the
    packed weights are kept until a parameter or statistic changes.
    Otherwise (training, an f32 image, elu or sigmoid, another k) it
    runs the library conv, the BN (over the batch in training), the
    activation and the max pool, as the JAX stem does off its Pallas
    path.  Takes the NHWC image and returns the conv map, or with
    `fuse_pool` (conv map, pooled map), as NCHW tensors, channels_last
    on the kernel path."""

    def __init__(self, in_ch: int = 3, features: int = 32,
                 activation_name: str = "leaky_relu",
                 use_batch_norm: bool = True,
                 kernel_size: int = KERNEL_SIZE, fuse_pool: bool = False):
        super().__init__()
        self.activation = activation_fn(activation_name)
        self.slope = STEM_SLOPES.get(activation_name)
        self.kernel_size = kernel_size
        self.fuse_pool = fuse_pool
        self.conv = nn.Conv2d(in_ch, features, kernel_size, 2,
                              kernel_size // 2, bias=False)
        self.bn = BatchNorm2d(features) if use_batch_norm else None
        self._packed: dict = {}

    def _fold(self, device: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.bn is not None:
            return bn_fold(self.bn)
        n = self.conv.out_channels
        return (torch.ones(n, device=device), torch.zeros(n, device=device))

    def forward(self, x: torch.Tensor):
        if (self.training or x.dtype != torch.bfloat16
                or self.slope is None or self.kernel_size % 4 != 3):
            h = self.conv(x.permute(0, 3, 1, 2))
            if self.bn is not None:
                h = self.bn(h)
            if self.activation is not None:
                h = self.activation(h)
            return (h, F.max_pool2d(h, 3, 2, 1)) if self.fuse_pool else h
        packed = cached_weights(
            self._packed, "stem", [self], lambda: stem_weights(
                self.conv.weight, *self._fold(x.device),
                pool=self.fuse_pool))
        maps = stem_apply(x.contiguous(), packed, self.slope)
        if not self.fuse_pool:
            return maps.permute(0, 3, 1, 2)
        return maps[0].permute(0, 3, 1, 2), maps[1].permute(0, 3, 1, 2)


class TransposeConvBlock(nn.Module):
    """Stride-2 transposed conv with torch's output_padding=1 (the output
    is exactly twice the input) -> [BN] -> [activation]; no bias."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_ch, features, kernel_size, 2,
                                         kernel_size // 2, output_padding=1,
                                         bias=False)
        self.bn = BatchNorm2d(features) if use_batch_norm else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.activation(x) if self.activation is not None else x


def phase_form_on(flag: Optional[bool], x: torch.Tensor) -> bool:
    """Whether a phase-composed form (`UpConvBlock.fast_2x`,
    `MultiScaleDecoder.phase_tail`) runs on `x`: `flag` when it is set;
    None turns it on for bf16 on the card, as the JAX package's None on
    every backend but the CPU (on the H100 both cut the fused call's
    device time, PERF.md §6)."""
    if flag is not None:
        return flag
    return x.dtype == torch.bfloat16 and x.is_cuda


class UpConvBlock(nn.Module):
    """Nearest resize to `shape`, then a ConvBlock.

    With ``fast_2x``, in eval, for an exact x2 target and a 3x3 kernel,
    the resize composes into the conv (`nearest2x_phase_kernel`): one
    conv on the coarse map emits the four output phases, the BN's
    running statistics apply in f32, then the activation and one
    depth-to-space; nearest repetition makes this exact, borders
    included.  True forces it, False keeps the literal path, and None
    (the default) chooses by `phase_form_on`."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False,
                 fast_2x: Optional[bool] = None):
        super().__init__()
        self.conv = ConvBlock(in_ch, features, kernel_size, 1, activation,
                              use_batch_norm)
        self.fast_2x = fast_2x
        self._derived = {}

    def forward(self, x: torch.Tensor, shape: Tuple[int, int]
                ) -> torch.Tensor:
        block = self.conv
        if not (phase_form_on(self.fast_2x, x) and not self.training
                and tuple(shape) == (2 * x.shape[-2], 2 * x.shape[-1])
                and block.conv.kernel_size == (3, 3)):
            return block(resize_nchw(x, shape, "nearest"))
        weight, fold = cached_weights(
            self._derived, "fast_2x", [block], lambda: (
                oihw(nearest2x_phase_kernel(hwio(block.conv))),
                None if block.bn is None else bn_fold(block.bn)))
        z = phase_conv(x, weight, fold)
        if block.activation is not None:
            z = block.activation(z)
        return phases_to_space(z, block.conv.out_channels)


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


class ResNetBottleneckBlock(nn.Module):
    """Bottleneck residual block, 1x1 -> 3x3 (stride) -> 1x1 (4x width),
    with a 1x1 projection on shape mismatch."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.conv1 = ConvBlock(in_ch, features, 1, 1, activation,
                               use_batch_norm)
        self.conv2 = ConvBlock(features, features, 3, stride, activation,
                               use_batch_norm)
        self.conv3 = ConvBlock(features, 4 * features, 1, 1, activation,
                               use_batch_norm)
        self.projection = (ConvBlock(in_ch, 4 * features, 1, stride)
                           if in_ch != 4 * features or stride != 1
                           else None)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        if self.projection is not None:
            x = self.projection(x)
        out = out + x
        return self.activation(out) if self.activation else out


class VGGBlock(nn.Module):
    """`n_conv` stacked 3x3 ConvBlocks, the stride on the last."""

    def __init__(self, in_ch: int, features: int, n_conv: int = 2,
                 stride: int = 2, activation: Optional[Callable] = None,
                 use_batch_norm: bool = False):
        super().__init__()
        self.n_conv = n_conv
        for i in range(n_conv):
            self.add_module(f"conv{i}", ConvBlock(
                in_ch if i == 0 else features, features, 3,
                stride if i == n_conv - 1 else 1, activation,
                use_batch_norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_conv):
            x = getattr(self, f"conv{i}")(x)
        return x


class DecoderBlock(nn.Module):
    """Upsample, concat the skip after it, fusion conv.  deconv_type
    "up": nearest resize to the skip's shape (or `shape`, or 2x) + conv;
    "transpose": a stride-2 TransposeConvBlock (exactly 2x)."""

    def __init__(self, in_ch: int, skip_ch: int, features: int,
                 activation: Optional[Callable] = None,
                 use_batch_norm: bool = False, deconv_type: str = "up"):
        super().__init__()
        if deconv_type not in ("up", "transpose"):
            raise ValueError(f"deconv_type: 'up' or 'transpose', got "
                             f"{deconv_type!r}")
        self.deconv_type = deconv_type
        block = UpConvBlock if deconv_type == "up" else TransposeConvBlock
        self.deconv = block(in_ch, features, 3, activation, use_batch_norm)
        self.conv = ConvBlock(features + skip_ch, features, 3, 1, activation,
                              use_batch_norm)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                shape: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.deconv_type == "transpose":
            h = self.deconv(x)
        else:
            target = (tuple(skip.shape[-2:]) if skip is not None
                      else tuple(shape) if shape is not None
                      else (2 * x.shape[-2], 2 * x.shape[-1]))
            h = self.deconv(x, target)
        if skip is not None:
            h = torch.cat([h, skip], dim=1)
        return self.conv(h)


def cached_weights(cache: dict, key: str, modules: Sequence[nn.Module],
                   make: Callable[[], Tuple]) -> Tuple:
    """`make()` cached in `cache` until a tensor of `modules` is replaced
    or changed in place (for a tensor made in inference mode, which
    keeps no version counter: replaced).  With gradients enabled on
    trainable weights it is made anew, under autograd, at every call."""
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return make()
    stamp = tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                  for t in tensors)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = cache[key] = (stamp, make())
    return hit[1]


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's weight as an f32 HWIO kernel."""
    return conv.weight.float().permute(2, 3, 1, 0)


def oihw(k: torch.Tensor) -> torch.Tensor:
    return k.permute(3, 2, 0, 1).contiguous()


def phase_conv(x: torch.Tensor, weight: torch.Tensor,
               fold: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """3x3 conv (zero padding 1) of NCHW x with an OIHW phase kernel in
    x's dtype, then, with `fold` = (scale, bias) of F channels, the
    per-channel affine tiled over the four phase blocks in f32."""
    z = F.conv2d(x, weight.to(x.dtype), padding=1)
    if fold is None:
        return z
    g, b = (t.repeat(4)[None, :, None, None] for t in fold)
    return (z.float() * g + b).to(x.dtype)


def phases_to_space(z: torch.Tensor, features: int) -> torch.Tensor:
    """NCHW phase tensor (N, 4F, h, w), block (py * 2 + px) * F + f ->
    (N, F, 2h, 2w): `depth_to_space2` in the NCHW layout."""
    n, _, h, w = z.shape
    z = z.reshape(n, 2, 2, features, h, w).permute(0, 3, 4, 1, 5, 2)
    return z.reshape(n, features, 2 * h, 2 * w)


# Nearest x2 taps composed through a 3-tap conv: for output phase p,
# _M_NEAREST2[p][j, d] maps conv tap d of the upsampled map to tap j of
# the coarse map (up[2i + p + d - 1] = x[i + j - 1]); row j = 2 (p = 0)
# or j = 0 (p = 1) is a structural zero.
_M_NEAREST2 = (((1.0, 0.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
               ((0.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))


def phase_kernel(k: torch.Tensor, taps) -> torch.Tensor:
    """Compose an x2 upsample whose phase-p taps are taps[p] (3 x 3, coarse
    tap j x conv tap d) with a 3x3 conv: k (3, 3, Ci, F) HWIO -> (3, 3,
    Ci, 4F), output block (py * 2 + px) * F + f holding the conv of the
    upsampled map at (2i + py, 2j + px).  Summed in k's dtype."""
    m = [torch.tensor(p, dtype=k.dtype, device=k.device) for p in taps]
    return torch.cat([torch.einsum("ja,abio,lb->jlio", m[py], k, m[px])
                      for py in range(2) for px in range(2)], dim=-1)


def nearest2x_phase_kernel(k: torch.Tensor) -> torch.Tensor:
    """Compose nearest-x2 upsample + 3x3 conv into one 3x3 conv on the
    coarse map whose output is the PHASE tensor: k (3, 3, Ci, F) HWIO ->
    (3, 3, Ci, 4F), output block (py * 2 + px) * F + f holding
    conv3x3(up2(x), k)[2i + py, 2j + px, f].  Summed in k's dtype (f32
    for the lane decoder, as in the JAX package)."""
    return phase_kernel(k, _M_NEAREST2)


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


class PatchEmbed(nn.Conv2d):
    """The p x p, stride-p patch embedding (VALID: a remainder of rows or
    columns is dropped), computed as one matmul over the unfolded patches
    with the conv's own weights.  In bf16 on the card the library's conv
    for it moved `validate_sml`'s seven metrics 2-270x further from the
    f32 host's than this matmul does (sq_rel 1.08% against 0.06%,
    `chip_smoke.py` phase 10c).  The DPT ViT / BEiT and Swin backbones
    use it."""

    def __init__(self, in_ch: int, out_ch: int, patch: int):
        super().__init__(in_ch, out_ch, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        p = self.kernel_size[0]
        gh, gw = H // p, W // p
        x = x[:, :, :gh * p, :gw * p].reshape(B, C, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, C * p * p)
        h = F.linear(x, self.weight.reshape(self.out_channels, -1),
                     self.bias)
        return h.transpose(1, 2).reshape(B, self.out_channels, gh, gw)


class KeepF32(nn.Module):
    """A module whose parameters named in `F32_PARAMS` (dotted names under
    it) never drop below float32: `.to(bfloat16)` and the like leave them
    float32 with their values untouched, as flax keeps every parameter in
    float32 whatever a module's compute dtype.  For the small parameters
    that the JAX modules use only in float32 arithmetic (Swin V2's logit
    scale and position-bias MLP, the relative-position and attention-bias
    tables added to float32 logits)."""

    F32_PARAMS: Tuple[str, ...] = ()

    def _apply(self, fn, recurse=True):
        kept = {name: p.detach().clone() for name, p in
                self.named_parameters() if name in self.F32_PARAMS}
        super()._apply(fn, recurse)
        for name, p in self.named_parameters():
            if (name in kept and p.is_floating_point()
                    and p.element_size() < 4):
                p.data = kept[name].to(p.device, torch.float32)
        return self
