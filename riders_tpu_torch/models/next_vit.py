"""Next-ViT-Large backbone of the DPT family (the `next_vit_large_6m`
row).

timm's `nextvit_large` as the JAX package's `models/next_vit.py` has it:
a four-conv stem to /4, then four stages of Next Convolution Blocks
(NCB: multi-head convolutional attention and an MLP) with a Next
Transformer Block (NTB: efficient spatially reduced MHSA on a slice of
the channels, MHCA on the rest) closing each transformer-bearing group;
depths (3, 4, 30, 3), strides /4 /8 /16 /32, hooks on the flat block
list at (2, 6, 36, 39).

Every BatchNorm of the reference is folded by
`models.convert.convert_next_vit_state_dict`: a conv followed by its BN
into the conv, a standalone norm into an `Affine` (per-channel weight
and bias).  E-MHSA's key / value reduction is timm's AvgPool1d over the
row-major token sequence: the mean of each group of sr^2 consecutive
tokens, the remainder past (N // sr^2) sr^2 dropped; it is not a 2-D
pool.  Maps are NCHW (channels_last on the card); module and attribute
names mirror the JAX package's flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _make_divisible(v: float, divisor: int = 32) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def mhsa_channels(out_ch: int, mix_block_ratio: float) -> int:
    """The channels an NTB gives its E-MHSA (the rest go to its MHCA)."""
    return _make_divisible(int(out_ch * mix_block_ratio))


@dataclasses.dataclass(frozen=True)
class NextViTConfig:
    """timm nextvit_large hyperparameters.  `stage_chans` overrides the
    per-block output channels; None selects the nextvit_large plan."""

    depths: Tuple[int, int, int, int] = (3, 4, 30, 3)
    strides: Tuple[int, int, int, int] = (1, 2, 2, 2)
    sr_ratios: Tuple[int, int, int, int] = (8, 4, 2, 1)
    stem_chs: Tuple[int, int, int] = (64, 32, 64)
    head_dim: int = 32
    mix_block_ratio: float = 0.75
    mlp_ratio_ncb: int = 3
    mlp_ratio_ntb: int = 2
    hooks: Tuple[int, ...] = (2, 6, 36, 39)
    stage_chans: Any = None


def stage_plan(cfg: NextViTConfig
               ) -> Tuple[List[List[str]], List[List[int]]]:
    """Each stage's block types ('ncb' / 'ntb') and output channels."""
    d = cfg.depths
    types = [["ncb"] * d[0],
             ["ncb"] * (d[1] - 1) + ["ntb"],
             (["ncb"] * 4 + ["ntb"]) * (d[2] // 5),
             ["ncb"] * (d[3] - 1) + ["ntb"]]
    if cfg.stage_chans is not None:
        chans = [list(c) for c in cfg.stage_chans]
    else:
        chans = [[96] * d[0],
                 [192] * (d[1] - 1) + [256],
                 ([384] * 4 + [512]) * (d[2] // 5),
                 [768] * (d[3] - 1) + [1024]]
    if [len(c) for c in chans] != list(d):
        raise ValueError(f"next_vit stage channels {chans} do not match "
                         f"the depths {d}")
    return types, chans


class Affine(nn.Module):
    """A folded BatchNorm: per-channel weight and bias over axis 1 of an
    NCHW map or the last axis of (B, N, C) tokens (`channels_last`)."""

    def __init__(self, features: int, channels_last: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.channels_last = channels_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channels_last:
            return x * self.weight + self.bias
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class Pointwise(nn.Linear):
    """A Dense over the channels of an NCHW map (a 1x1 conv holding a
    Linear's (out, in) weight, as the flax Dense it mirrors)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight[:, :, None, None], self.bias)


def avgpool2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False) of an
    NCHW map: a pad row / column at the end of an odd side is left out
    of its window's mean."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


class PatchEmbed(nn.Module):
    """Stride 2: the ceil average pool and a 1x1 conv (BN folded); a
    change of channels: the 1x1 conv; else the identity (no `conv`)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = (nn.Conv2d(in_ch, out_ch, 1)
                     if stride == 2 or in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = avgpool2x2_ceil(x)
        return self.conv(x) if self.conv is not None else x


class MHCA(nn.Module):
    """Multi-head convolutional attention: a 3x3 conv in groups of
    `head_dim` channels (BN folded), relu, a biasless 1x1 projection."""

    def __init__(self, dim: int, head_dim: int = 32):
        super().__init__()
        self.group_conv = nn.Conv2d(dim, dim, 3, 1, 1,
                                    groups=dim // head_dim)
        self.projection = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(F.relu(self.group_conv(x)))


class Mlp(nn.Module):
    """The 1x1-conv MLP with relu."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.conv1 = Pointwise(dim, hidden)
        self.conv2 = Pointwise(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class NCBlock(nn.Module):
    """Next convolution block: patch embed, + MHCA, norm, + MLP."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 mlp_ratio: int, head_dim: int = 32):
        super().__init__()
        self.patch_embed = PatchEmbed(in_ch, out_ch, stride)
        self.mhca = MHCA(out_ch, head_dim)
        self.norm = Affine(out_ch)
        self.mlp = Mlp(out_ch, _make_divisible(out_ch * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x + self.mhca(x)
        return x + self.mlp(self.norm(x))


class EMHSA(nn.Module):
    """Efficient MHSA over (B, N, C) tokens: keys and values from the
    mean of each sr^2 consecutive tokens (then a folded BatchNorm1d),
    float32 logits and softmax."""

    def __init__(self, dim: int, sr_ratio: int, head_dim: int = 32):
        super().__init__()
        self.sr_ratio, self.head_dim = sr_ratio, head_dim
        self.heads = dim // head_dim
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm = Affine(dim, channels_last=True) if sr_ratio > 1 else None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        B, N, C = tokens.shape
        hd = self.head_dim

        def heads(t):
            return t.reshape(B, t.shape[1], self.heads, hd).transpose(1, 2)

        kv = tokens
        if self.sr_ratio > 1:
            r = self.sr_ratio ** 2
            kv = tokens[:, :(N // r) * r].reshape(B, N // r, r, C).mean(2)
            kv = self.norm(kv)
        q, k, v = heads(self.q(tokens)), heads(self.k(kv)), heads(self.v(kv))
        attn = (q @ k.transpose(-2, -1)).to(torch.float32)
        attn = (attn * hd ** -0.5).softmax(-1).to(tokens.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class NTBlock(nn.Module):
    """Next transformer block: E-MHSA on `mhsa_channels` of the output
    channels, MHCA on the rest, concatenated, then an MLP."""

    def __init__(self, in_ch: int, out_ch: int, sr_ratio: int,
                 stride: int = 1, mix_block_ratio: float = 0.75,
                 mlp_ratio: int = 2, head_dim: int = 32):
        super().__init__()
        mhsa_ch = mhsa_channels(out_ch, mix_block_ratio)
        mhca_ch = out_ch - mhsa_ch
        self.patch_embed = PatchEmbed(in_ch, mhsa_ch, stride)
        self.norm1 = Affine(mhsa_ch)
        self.e_mhsa = EMHSA(mhsa_ch, sr_ratio, head_dim)
        self.projection = PatchEmbed(mhsa_ch, mhca_ch, 1)
        self.mhca = MHCA(mhca_ch, head_dim)
        self.norm2 = Affine(out_ch)
        self.mlp = Mlp(out_ch, _make_divisible(out_ch * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        B, C, H, W = x.shape
        out = self.norm1(x).flatten(2).transpose(1, 2)
        out = self.e_mhsa(out).transpose(1, 2).reshape(B, C, H, W)
        x = x + out
        out = self.projection(x)
        out = out + self.mhca(out)
        x = torch.cat([x, out], dim=1)
        return x + self.mlp(self.norm2(x))


class NextViTBackbone(nn.Module):
    """The nextvit_large trunk of an NCHW image: the maps after the
    blocks in `config.hooks`, (B, C, H/s, W/s) for s in (4, 8, 16, 32)
    and C in (96, 256, 512, 1024) (`out_channels`)."""

    def __init__(self, config: NextViTConfig = NextViTConfig(),
                 in_channels: int = 3):
        super().__init__()
        cfg = self.config = config
        s0, s1, s2 = cfg.stem_chs
        cin = in_channels
        for j, (c, s) in enumerate(((s0, 2), (s1, 1), (s2, 1), (s2, 2))):
            self.add_module(f"stem_conv{j}", nn.Conv2d(cin, c, 3, s, 1))
            cin = c
        types, chans = stage_plan(cfg)
        flat = [c for stage in chans for c in stage]
        self.out_channels = tuple(flat[h] for h in cfg.hooks
                                  if h < len(flat))
        i, in_ch = 0, s2
        for si in range(4):
            for bi, (bt, c) in enumerate(zip(types[si], chans[si])):
                stride = cfg.strides[si] if bi == 0 else 1
                block = (NCBlock(in_ch, c, stride, cfg.mlp_ratio_ncb,
                                 cfg.head_dim) if bt == "ncb" else
                         NTBlock(in_ch, c, cfg.sr_ratios[si], stride,
                                 cfg.mix_block_ratio, cfg.mlp_ratio_ntb,
                                 cfg.head_dim))
                self.add_module(f"blocks_{i}", block)
                in_ch = c
                i += 1
        self.n_blocks = i
        if len(self.out_channels) != len(cfg.hooks):
            raise ValueError(f"next_vit hooks {cfg.hooks} past its {i} "
                             "blocks")

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = x
        for j in range(4):
            h = F.relu(getattr(self, f"stem_conv{j}")(h))
        taps = []
        for i in range(self.n_blocks):
            h = getattr(self, f"blocks_{i}")(h)
            if i in self.config.hooks:
                taps.append(h)
        return taps
