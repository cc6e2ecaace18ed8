"""DPT Swin2-L/24-384 as RIDERS' scale map learner, in float32: the
reference of `sml.model_type` "dpt-swin2-large".

Written from MiDaS v3.1's `dpt_swin2_large_384` (https://github.com/
isl-org/MiDaS; arXiv 2307.14460): `midas/backbones/swin2.py` and
`swin_common.py` (timm's Swin V2 hooked after the last block of each
stage, its tokens laid out on the stage's grid), `midas/blocks.py`
(scratch convs, RefineNet fusion) and `midas/dpt_depth.py` (fusion
order, head); Swin Transformer V2 from arXiv 2111.09883 (timm 0.6.12's
`swin_transformer_v2.py`, `swinv2_large_window12to24_192to384`), DPT
from arXiv 2103.13413.

Backbone: a 4x4 stride-4 patch conv and a LayerNorm, then four stages
of blocks on a grid of tokens that halves from stage to stage.  Each
stage's window is the configured one, or the stage's grid where that is
smaller; odd blocks of a stage whose grid the window does not cover
shift the grid cyclically by half a window before the windows are cut
(and back after), and mask the logits between tokens that came from
different regions of the unshifted grid with -100.  A block is post-norm:

    x = x + norm1(attn(x));  x = x + norm2(mlp(x))

with an exact-GELU MLP of ratio 4.  The attention projects to q, k and
v with biases on q and v only, normalises q and k to unit length per
head, takes their dot products times exp(min(logit_scale, log 100)) and
adds 16 sigmoid of a continuous position bias: a 2 -> 512 -> heads MLP
(relu, no second bias) over the window's relative offsets, each offset
divided by (pretrained window - 1), times 8, mapped by
sign(t) log2(1 + |t|) / 3.  Between stages, patch merging concatenates
each 2x2 neighbourhood (top-left, bottom-left, top-right, bottom-right),
projects 4C -> 2C without bias and normalises.

Neck: the four maps at strides 4, 8, 16 and 32 go straight into 3x3
convs without bias to `features`; RefineNet fusion from the deepest map
up (residual conv units, bilinear resize with align_corners True to the
next map's size, x2 for the last, a 1x1 out conv).  Head: conv 3x3 to
features / 2, bilinear x2 (align_corners True), conv 3x3 to 32, relu,
conv 1x1 to 1, relu.

Departures from MiDaS:
- seeded weights (`benchmark/weights.py`), not the pretrained checkpoint:
  q / v biases 0, and the logit scale declared "ones" (a scale of e),
  where timm starts it at log(10): the benchmark's initialisers have no
  such constant;
- RIDERS' scale head in place of MiDaS' depth output: the head's output
  is a scale correction, scales = relu(1 + out), pred = d * scales,
  clamped to [1 / max_pred, 1 / min_pred];
- the input is the SML's three channels (normalised prior, normalised
  scale map, gray), not a normalised RGB image;
- timm's final norm after the last stage, which no hook reads, is left
  out; eval only (no dropout, no drop path).

Precision: `emulate_` (the bf16 yardstick, the fp8 control) leaves the
logit scale and the position-bias MLP in float32, as the system computes
them in its bf16 model; every other weight and matmul input is rounded.

The shift mask, the window partition and the coordinate table are built
here from their definitions, not from the system's helpers.  Module and
tensor names are the system's state-dict keys, so that the benchmark's
weights load into both.  The widths are parameters of `DPTSwin2`;
`SML(sml_section)` fixes the published ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.chain import f32_exact


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def to_windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w * w, C): the w x w tiles, row-major
    over the grid of tiles, each tile's tokens row-major."""
    C = x.shape[-1]
    tiles = x.unfold(1, w, w).unfold(2, w, w)   # (B, H/w, W/w, C, w, w)
    return tiles.permute(0, 1, 2, 4, 5, 3).reshape(-1, w * w, C)


def from_windows(t: torch.Tensor, w: int, B: int, H: int, W: int
                 ) -> torch.Tensor:
    """The inverse of `to_windows`."""
    C = t.shape[-1]
    t = t.reshape(B, H // w, W // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, C)


def shift_mask(H: int, W: int, w: int, s: int) -> torch.Tensor:
    """(nW, w^2, w^2): 0 between two tokens of a shifted window that
    came from the same region of the unshifted grid, -100 otherwise.
    Along each axis the regions are [0, n - w), [n - w, n - s) and
    [n - s, n)."""
    def regions(n):
        i = torch.arange(n)
        return (i >= n - w).long() + (i >= n - s).long()
    label = regions(H)[:, None] * 3 + regions(W)[None, :]
    label = to_windows(label[None, :, :, None], w)[..., 0]   # (nW, w^2)
    same = label[:, :, None] == label[:, None, :]
    return torch.where(same, 0.0, -100.0)


def log_coords(w: int, pretrained: int) -> torch.Tensor:
    """((2w - 1)^2, 2) relative offsets (dy, dx), dy-major, each divided
    by (pretrained - 1) (by w - 1 without a pretrained window), times 8,
    then sign(t) log2(1 + |t|) / log2(8)."""
    r = torch.arange(1 - w, w, dtype=torch.float64)
    t = torch.cartesian_prod(r, r) * (8.0 / ((pretrained or w) - 1))
    return (torch.sign(t) * torch.log2(1.0 + t.abs()) / 3.0).float()


def pair_rows(w: int) -> torch.Tensor:
    """(w^2, w^2): the row of `log_coords` that holds query i's offset
    from key j."""
    p = torch.arange(w * w)
    y, x = p // w, p % w
    dy = y[:, None] - y[None, :] + w - 1
    dx = x[:, None] - x[None, :] + w - 1
    return dy * (2 * w - 1) + dx


class BiasLinear(nn.Module):
    """A linear layer of the position-bias MLP.  Not an nn.Linear, so
    that `chain.emulate_` leaves its weights and activations float32:
    the MLP, like the logit scale, is float32 arithmetic in the system's
    bf16 model, and the yardstick rounds only what the system rounds."""

    INIT = {"weight": "w", "bias": "b"}

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class WindowAttention(nn.Module):
    """Swin V2's scaled cosine window attention with its continuous
    position bias.  `emulate_` rounds the qkv kernel and the q / v
    biases, and on every call the qkv projection's input and output and
    the inputs and outputs of q k^T and attn v; the logit scale, the
    position-bias MLP (`BiasLinear`), the logits, the bias, the mask and
    the softmax stay float32, as in the system."""

    INIT = {"qkv_kernel": "w", "q_bias": "b", "v_bias": "b",
            "logit_scale": "ones"}

    def __init__(self, dim: int, heads: int, window: int, pretrained: int):
        super().__init__()
        self.heads, self.window, self.pretrained = heads, window, pretrained
        self.qkv_kernel = nn.Parameter(torch.empty(3 * dim, dim))
        self.q_bias = nn.Parameter(torch.empty(dim))
        self.v_bias = nn.Parameter(torch.empty(dim))
        self.logit_scale = nn.Parameter(torch.empty(heads, 1, 1))
        self.cpb_fc1 = BiasLinear(2, 512)
        self.cpb_fc2 = BiasLinear(512, heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.rounding = _same
        self.tables = {}     # device -> (coords, rows); derived, not state

    def emulate_(self, rounding) -> None:
        with torch.no_grad():
            for p in (self.qkv_kernel, self.q_bias, self.v_bias):
                p.copy_(rounding(p))
        self.rounding = rounding

    def position_bias(self) -> torch.Tensor:
        """(heads, N, N): 16 sigmoid of the MLP at each pair's offset."""
        device = self.cpb_fc1.weight.device
        key = str(device)
        if key not in self.tables:
            self.tables[key] = (
                log_coords(self.window, self.pretrained).to(device),
                pair_rows(self.window).reshape(-1).to(device))
        coords, rows = self.tables[key]
        table = self.cpb_fc2(F.relu(self.cpb_fc1(coords)))
        N = self.window ** 2
        bias = table[rows].reshape(N, N, self.heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        r = self.rounding
        B, N, C = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = r(F.linear(r(x), self.qkv_kernel, bias))
        q, k, v = qkv.reshape(B, N, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)
        q, k = r(F.normalize(q, dim=-1)), r(F.normalize(k, dim=-1))
        logits = r(q @ k.transpose(-2, -1))
        scale = self.logit_scale.clamp(max=float(np.log(100.0))).exp()
        logits = logits * scale + self.position_bias()
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(B // nW, nW, self.heads, N, N)
                      + mask[:, None]).reshape(B, self.heads, N, N)
        out = r(r(logits.softmax(-1)) @ v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    """A post-norm Swin V2 block on an (H, W) grid of tokens."""

    def __init__(self, dim: int, heads: int, grid: Tuple[int, int],
                 window: int, shift: int, pretrained: int, mlp_ratio: float):
        super().__init__()
        self.grid, self.window, self.shift = grid, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window, pretrained)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.masks = {}      # device -> mask; derived, not state

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), w, s = self.grid, self.window, self.shift
        B, L, C = x.shape
        h = x.reshape(B, H, W, C)
        mask = None
        if s:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
            key = str(x.device)
            if key not in self.masks:
                self.masks[key] = shift_mask(H, W, w, s).to(x.device)
            mask = self.masks[key]
        h = from_windows(self.attn(to_windows(h, w), mask), w, B, H, W)
        if s:
            h = torch.roll(h, shifts=(s, s), dims=(1, 2))
        return h.reshape(B, L, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.norm1(self.attention(x))
        return x + self.norm2(self.mlp_fc2(F.gelu(self.mlp_fc1(x))))


class PatchMerging(nn.Module):
    """Each 2x2 neighbourhood's four tokens side by side, in the order
    (0, 0), (1, 0), (0, 1), (1, 1) of (row, column) within it, projected
    to `out` channels, then normalised."""

    def __init__(self, dim: int, out: int, grid: Tuple[int, int]):
        super().__init__()
        self.grid = grid
        self.reduction = nn.Linear(4 * dim, out, bias=False)
        self.norm = nn.LayerNorm(out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (H, W), (B, _, C) = self.grid, x.shape
        h = x.reshape(B, H // 2, 2, W // 2, 2, C)       # (.., dy, .., dx, C)
        h = h.permute(0, 1, 3, 4, 2, 5).reshape(B, H * W // 4, 4 * C)
        return self.norm(self.reduction(h))


class SwinV2(nn.Module):
    """The backbone: the NCHW map after the last block of each stage."""

    def __init__(self, in_channels: int, net_shape: Tuple[int, int],
                 embed: int, depths: Sequence[int], heads: Sequence[int],
                 window: int, pretrained_windows: Sequence[int], patch: int,
                 mlp_ratio: float):
        super().__init__()
        self.patch_embed = nn.Conv2d(in_channels, embed, patch, patch)
        self.patch_norm = nn.LayerNorm(embed, eps=1e-5)
        grid = (net_shape[0] // patch, net_shape[1] // patch)
        self.stages = []
        for si, depth in enumerate(depths):
            dim = embed * 2 ** si
            w = min(window, *grid)
            if grid[0] % w or grid[1] % w:
                raise ValueError(f"stage {si}: grid {grid}, window {w}")
            for bi in range(depth):
                shift = w // 2 if bi % 2 and min(grid) > w else 0
                self.add_module(f"stage{si}_block{bi}", Block(
                    dim, heads[si], grid, w, shift, pretrained_windows[si],
                    mlp_ratio))
            if si < len(depths) - 1:
                self.add_module(f"downsample{si}",
                                PatchMerging(dim, 2 * dim, grid))
            self.stages.append((depth, grid))
            grid = (grid[0] // 2, grid[1] // 2)

    def forward(self, x: torch.Tensor):
        h = self.patch_embed(x).flatten(2).transpose(1, 2)
        h = self.patch_norm(h)
        maps = []
        for si, (depth, (H, W)) in enumerate(self.stages):
            for bi in range(depth):
                h = getattr(self, f"stage{si}_block{bi}")(h)
            maps.append(h.transpose(1, 2).reshape(len(h), -1, H, W))
            if si < len(self.stages) - 1:
                h = getattr(self, f"downsample{si}")(h)
        return maps


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, 1, 1)
        self.conv2 = nn.Conv2d(f, f, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class Fusion(nn.Module):
    def __init__(self, f: int, has_skip: bool):
        super().__init__()
        self.res_conf_unit1 = ResidualConvUnit(f) if has_skip else None
        self.res_conf_unit2 = ResidualConvUnit(f)
        self.out_conv = nn.Conv2d(f, f, 1)

    def forward(self, x: torch.Tensor, skip=None, size=None):
        if skip is not None:
            x = x + self.res_conf_unit1(skip)
        x = self.res_conf_unit2(x)
        if size is None:
            x = F.interpolate(x, scale_factor=2, mode="bilinear",
                              align_corners=True)
        else:
            x = F.interpolate(x, size=tuple(size), mode="bilinear",
                              align_corners=True)
        return self.out_conv(x)


class DPTSwin2(nn.Module):
    """The network at any widths.  forward(x, d): x (N, h, w, in_channels)
    the SML's input at `net_shape`, d (N, h, w, 1) the aligned inverse
    depth; returns pred (N, h, w, 1)."""

    HEAD = "head_conv3"

    def __init__(self, *, in_channels: int, net_shape: Tuple[int, int],
                 embed: int, depths: Sequence[int], heads: Sequence[int],
                 window: int, pretrained_windows: Sequence[int], patch: int,
                 mlp_ratio: float, features: int, head_features: int,
                 min_pred: float, max_pred: float):
        super().__init__()
        self.min_pred, self.max_pred = min_pred, max_pred
        self.pretrained = SwinV2(in_channels, net_shape, embed, depths,
                                 heads, window, pretrained_windows, patch,
                                 mlp_ratio)
        for i in range(len(depths)):
            self.add_module(f"layer{i + 1}_rn", nn.Conv2d(
                embed * 2 ** i, features, 3, 1, 1, bias=False))
        for i in range(4, 0, -1):
            self.add_module(f"refinenet{i}", Fusion(features, i != 4))
        self.head_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.head_conv2 = nn.Conv2d(features // 2, head_features, 3, 1, 1)
        self.head_conv3 = nn.Conv2d(head_features, 1, 1)

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor that the head's last conv reads."""
        with f32_exact():
            l1, l2, l3, l4 = [
                getattr(self, f"layer{i + 1}_rn")(m) for i, m in
                enumerate(self.pretrained(x.permute(0, 3, 1, 2)))]
            p = self.refinenet4(l4, size=l3.shape[-2:])
            p = self.refinenet3(p, l3, size=l2.shape[-2:])
            p = self.refinenet2(p, l2, size=l1.shape[-2:])
            p = self.refinenet1(p, l1)
            h = F.interpolate(self.head_conv1(p), scale_factor=2,
                              mode="bilinear", align_corners=True)
            return F.relu(self.head_conv2(h))

    def forward(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        with f32_exact():
            out = F.relu(self.head_conv3(self.head_input(x)))
            pred = d * F.relu(1.0 + out.permute(0, 2, 3, 1))
        if self.min_pred > 0:
            pred = pred.clamp(max=1.0 / self.min_pred)
        return pred.clamp(min=1.0 / self.max_pred)


class SML(DPTSwin2):
    """Swin2-L/24-384 with the DPT neck at the published widths
    (`WIDTHS`): embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48)
    of 32, window 24 (pretrained 12, 12, 12, 6), MLP ratio 4, 4x4
    patches, the four stage maps into fusion at 256, at the
    configuration's `net_shape`."""

    WIDTHS = dict(embed=192, depths=(2, 2, 18, 2), heads=(6, 12, 24, 48),
                  window=24, pretrained_windows=(12, 12, 12, 6), patch=4,
                  mlp_ratio=4.0, features=256, head_features=32)

    def __init__(self, sml: dict):
        if sml["model_type"] != "dpt-swin2-large":
            raise ValueError(f"not dpt-swin2-large: {sml['model_type']!r}")
        super().__init__(in_channels=sml["in_channels"],
                         net_shape=tuple(sml["net_shape"]),
                         min_pred=sml["min_pred"], max_pred=sml["max_pred"],
                         **self.WIDTHS)
