"""EfficientNet-Lite3 encoder backbone returning the four MiDaS taps.

The lite variant: fixed 32-channel stem, no squeeze-excite, relu6,
BatchNorm eps 1e-3, and TF-style asymmetric 'SAME' padding: total pad
max((ceil(n / s) - 1) * s + k - n, 0) with the smaller half on the
top / left, applied with an explicit F.pad.

Stage table (lite3): (kernel, stride, expand, out_channels, repeats)
  s0 DS k3 s1 e1 -> 24 x1;  s1 MB k3 s2 e6 -> 32 x3 (tap, /4);
  s2 MB k5 s2 e6 -> 48 x3 (tap, /8);  s3 MB k3 s2 e6 -> 96 x5;
  s4 MB k5 s1 e6 -> 136 x5 (tap, /16);  s5 MB k5 s2 e6 -> 232 x6;
  s6 MB k3 s1 e6 -> 384 x1 (tap, /32).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.models.layers import BatchNorm2d

LITE3_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (3, 1, 1, 24, 1),
    (3, 2, 6, 32, 3),
    (5, 2, 6, 48, 3),
    (3, 2, 6, 96, 5),
    (5, 1, 6, 136, 5),
    (5, 2, 6, 232, 6),
    (3, 1, 6, 384, 1),
)
LITE3_TAPS: Tuple[int, ...] = (1, 2, 4, 6)
BN_EPS = 1e-3


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.hardtanh(x, 0.0, 6.0)


class SameConv2d(nn.Conv2d):
    """Conv with TF 'SAME' padding (asymmetric, lower half first)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, 0, groups=groups,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        (top, bottom), (left, right) = pads
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class DepthwiseSeparable(nn.Module):
    """Lite stage-0 block: dw kxk + BN + relu6, pw 1x1 + BN (no act)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.conv_dw = SameConv2d(in_ch, in_ch, kernel, stride, groups=in_ch)
        self.bn1 = BatchNorm2d(in_ch, eps=BN_EPS)
        self.conv_pw = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn2 = BatchNorm2d(features, eps=BN_EPS)
        self.residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = relu6(self.bn1(self.conv_dw(x)))
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class MBConv(nn.Module):
    """Inverted-residual block, lite variant (no squeeze-excite)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, expand: int = 6):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid, eps=BN_EPS)
        self.conv_dw = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn2 = BatchNorm2d(mid, eps=BN_EPS)
        self.conv_pwl = nn.Conv2d(mid, features, 1, bias=False)
        self.bn3 = BatchNorm2d(features, eps=BN_EPS)
        self.residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = relu6(self.bn1(self.conv_pw(x)))
        h = relu6(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class EfficientNetLite3(nn.Module):
    """Backbone returning the feature taps (NCHW); `stages`, `taps` and
    `stem_features` default to the lite3 plan and are shrunk in tests."""

    def __init__(self, in_ch: int = 3,
                 stages: Tuple[Tuple[int, int, int, int, int], ...]
                 = LITE3_STAGES,
                 taps: Tuple[int, ...] = LITE3_TAPS,
                 stem_features: int = 32):
        super().__init__()
        self.conv_stem = SameConv2d(in_ch, stem_features, 3, 2)
        self.bn_stem = BatchNorm2d(stem_features, eps=BN_EPS)
        self.taps = tuple(taps)
        self.stage_blocks: List[List[str]] = []
        prev = stem_features
        for si, (k, s, e, c, r) in enumerate(stages):
            names = []
            for bi in range(r):
                stride = s if bi == 0 else 1
                name = f"stage{si}_block{bi}"
                block = (DepthwiseSeparable(prev, c, k, stride) if e == 1
                         else MBConv(prev, c, k, stride, e))
                self.add_module(name, block)
                names.append(name)
                prev = c
            self.stage_blocks.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = relu6(self.bn_stem(self.conv_stem(x)))
        taps = []
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                h = getattr(self, name)(h)
            if si in self.taps:
                taps.append(h)
        return taps
