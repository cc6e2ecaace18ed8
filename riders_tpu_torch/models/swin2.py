"""Swin Transformer V2 (and V1) backbone of the DPT Scale Map Learner.

timm 0.6.12's swin_transformer_v2.py semantics at a fixed input size,
as the JAX package's `models/swin2.py` has them:

* post-norm blocks: x + norm1(attn(x)), x + norm2(mlp(x));
* scaled cosine attention: q and k L2-normalised per head in float32
  (torch's F.normalize floor of 1e-12), a learned per-head logit scale
  clamped at log(100);
* a log-spaced continuous relative position bias: a 2-layer MLP (2 ->
  512 -> heads) in float32 over the sign(x) log2(1 + 8|x|) / log2(8)
  coordinate table, squashed by 16 sigmoid;
* q / v-only qkv bias;
* cyclic-shift windows on odd blocks with the region mask (-100); the
  window is clamped to the stage's grid and the shift dropped where the
  window covers it;
* patch merging (even / even, odd / even, even / odd, odd / odd concat,
  4C -> 2C linear, then the norm) at the end of each stage but the last.

`version=1` selects Swin V1 (timm swin_transformer.py, the reference's
`swinl12_384` row): pre-norm blocks, scaled dot-product attention with a
directly learned relative position bias table, full qkv bias, and the
norm before the reduction in patch merging.

Under a profiler each V2 window attention opens the DPT SML's mirrored
attention span `dpt.attn` (`core.tracing`), as BEiT's attention does,
from after its qkv projection up to its output projection: the L2
norms, the logit scale, the position bias, the mask, the softmax and
attn v.  Between the two projections bf16 inference on the card runs
one hand-written kernel (`ops.kernels.swin2_attention`), everything else
its plain version.  `COUNTS["cpb_tables"]` counts the position-bias
tables computed (one a V2 block call), "attn_kernel" / "attn_plain" the
path each call took.

The logits, the position bias and the softmax stay float32 in a bf16
model, and so do the parameters used only in that arithmetic (the logit
scale, the position-bias MLP, V1's table: `layers.KeepF32`).  Module and
attribute names mirror the JAX package's flax tree, so `models.from_jax`
loads its variables by path.  Tokens are (B, L, C); the backbone takes
an NCHW image and returns NCHW maps.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.core.tracing import span
from riders_tpu_torch.models.layers import KeepF32, PatchEmbed
from riders_tpu_torch.ops.kernels.swin2_attention import (
    grid_mask, masked_softmax, pair_index, split_heads, swin2_attention,
    swin2_attention_path, swin2_attention_plain)

# "cpb_tables", the continuous position-bias tables computed by the V2
# attention's MLP (`WindowAttentionV2.position_table`); "attn_kernel" /
# "attn_plain", the path of each V2 attention call
# (`ops.kernels.swin2_attention.swin2_attention_path`)
COUNTS: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class Swin2Config:
    """swinv2_large_window12to24_192to384 by default."""

    patch_size: int = 4
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 24
    pretrained_window_sizes: Tuple[int, ...] = (12, 12, 12, 6)
    mlp_ratio: float = 4.0
    version: int = 2


# timm swin_large_patch4_window12_384 (the reference's swinl12_384 row).
SWIN1_LARGE = Swin2Config(window_size=12, version=1)


def _log_coords_table(window: int, pretrained_window: int) -> np.ndarray:
    """(2w-1, 2w-1, 2) log-spaced normalised relative coordinates, scaled
    by the pretrained window (the window itself when that is 0)."""
    r = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    denom = (pretrained_window - 1) if pretrained_window > 0 else (
        window - 1)
    table = table / denom * 8.0
    table = (np.sign(table) * np.log2(np.abs(table) + 1.0)
             / np.log2(8.0))
    return table.astype(np.float32)


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window^2, C), windows row-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def _unpartition(x: torch.Tensor, window: int, B: int, H: int,
                 W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _on_device(cache: Dict[str, torch.Tensor], make, device
               ) -> torch.Tensor:
    """A module's numpy constant `make()` as a tensor on `device`, made
    once per device, outside inference mode (a later call under autograd
    may save it for backward)."""
    key = str(device)
    if key not in cache:
        with torch.inference_mode(False):
            cache[key] = torch.from_numpy(make()).to(device)
    return cache[key]


class WindowAttentionV2(KeepF32):
    """Scaled cosine window attention with the continuous position bias.

    `qkv_kernel` is held as a Linear weight (3C, C); the flax leaf of
    that name is its transpose (`JAX_TRANSPOSED`)."""

    JAX_TRANSPOSED = ("qkv_kernel",)
    F32_PARAMS = ("logit_scale", "cpb_fc1.weight", "cpb_fc1.bias",
                  "cpb_fc2.weight")

    def __init__(self, dim: int, num_heads: int, window: int,
                 pretrained_window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.pretrained_window = pretrained_window
        self.qkv_kernel = nn.Parameter(torch.empty(3 * dim, dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.empty(num_heads, 1, 1))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        self._coords: Dict[str, torch.Tensor] = {}
        self.reset_jax_init_(None)

    @torch.no_grad()
    def reset_jax_init_(self, g: Optional[torch.Generator]) -> None:
        """flax's initialisers: normal(0.02) kernel, zero q / v biases, a
        logit scale of log(10)."""
        self.qkv_kernel.copy_(0.02 * torch.randn(self.qkv_kernel.shape,
                                                 generator=g))
        self.q_bias.zero_()
        self.v_bias.zero_()
        self.logit_scale.fill_(math.log(10.0))

    def position_table(self) -> torch.Tensor:
        """(heads, (2w-1)^2) float32: the MLP over the log coordinate
        table, one row a head, before its 16 sigmoid (applied by the
        attention, `swin2_attention_plain` after its gather)."""
        COUNTS["cpb_tables"] += 1
        device = self.cpb_fc1.weight.device
        table = _on_device(self._coords, lambda: _log_coords_table(
            self.window, self.pretrained_window).reshape(-1, 2), device)
        f32 = torch.float32
        h = F.relu(F.linear(table, self.cpb_fc1.weight.to(f32),
                            self.cpb_fc1.bias.to(f32)))
        return F.linear(h, self.cpb_fc2.weight.to(f32)).t().contiguous()

    def forward(self, x: torch.Tensor, shift: int, grid: Tuple[int, int]
                ) -> torch.Tensor:
        """Bw windows (Bw, w^2, C) of (gh, gw) `grid`s rolled by `shift`
        (0: unshifted, no mask), row major a frame after another."""
        Bw, N, C = x.shape
        nh = self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias]).to(x.dtype)
        qkv = F.linear(x, self.qkv_kernel.to(x.dtype), bias)
        # everything between the two projections, so that the SML's first
        # and last kernels stay outside every `dpt.attn` range
        with span("dpt.attn", mirror=True):
            scale = torch.exp(torch.clamp(self.logit_scale,
                                          max=math.log(100.0))).reshape(-1)
            table = self.position_table()
            path = swin2_attention_path(x.dtype, x.device.type,
                                        self.training,
                                        torch.is_grad_enabled(), C // nh, N)
            COUNTS[f"attn_{path}"] += 1
            attend = swin2_attention if path == "kernel" else \
                swin2_attention_plain
            out = attend(qkv, table, scale, self.window, shift, grid, nh)
        return self.proj(out)


class WindowAttentionV1(KeepF32):
    """Swin V1 window attention: scaled dot product with a directly
    learned relative position bias table, full qkv bias."""

    F32_PARAMS = ("rel_pos_bias_table",)

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.reset_jax_init_(None)

    @torch.no_grad()
    def reset_jax_init_(self, g: Optional[torch.Generator]) -> None:
        """flax's normal(0.02) table."""
        self.rel_pos_bias_table.copy_(0.02 * torch.randn(
            self.rel_pos_bias_table.shape, generator=g))

    def forward(self, x: torch.Tensor, shift: int, grid: Tuple[int, int]
                ) -> torch.Tensor:
        """As `WindowAttentionV2.forward`."""
        Bw, N, C = x.shape
        nh = self.num_heads
        q, k, v = (split_heads(t, nh) for t in self.qkv(x).chunk(3, dim=-1))
        attn = (q @ k.transpose(-2, -1)).to(torch.float32)
        attn = attn * (C // nh) ** -0.5
        idx = pair_index(self.window, x.device)
        bias = self.rel_pos_bias_table[idx].reshape(N, N, nh)
        attn = attn + bias.permute(2, 0, 1)[None].to(torch.float32)
        mask = grid_mask(tuple(grid), self.window, shift, x.device)
        attn = masked_softmax(attn, mask).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(Bw, N, C)
        return self.proj(out)


class SwinBlockV2(nn.Module):
    """One Swin block over a (H, W) grid of tokens: post-norm (V2) or
    pre-norm with V1 attention (version 1)."""

    def __init__(self, dim: int, num_heads: int,
                 resolution: Tuple[int, int], window: int, shift: int,
                 pretrained_window: int, mlp_ratio: float = 4.0,
                 version: int = 2):
        super().__init__()
        self.resolution = tuple(resolution)
        self.window = window
        self.shift = shift
        self.version = version
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = (WindowAttentionV1(dim, num_heads, window)
                     if version == 1 else
                     WindowAttentionV2(dim, num_heads, window,
                                       pretrained_window))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def attention(self, tokens: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, _, C = tokens.shape
        s, w = self.shift, self.window
        h = tokens.reshape(B, H, W, C)
        if s > 0:
            h = torch.roll(h, (-s, -s), dims=(1, 2))
        h = _unpartition(self.attn(_partition(h, w), s, (H, W)), w, B, H, W)
        if s > 0:
            h = torch.roll(h, (s, s), dims=(1, 2))
        return h.reshape(B, H * W, C)

    def mlp(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.mlp_fc2(F.gelu(self.mlp_fc1(tokens)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.version == 1:
            x = x + self.attention(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.norm1(self.attention(x))
        return x + self.norm2(self.mlp(x))


class PatchMergingV2(nn.Module):
    """The 2x2 neighbourhoods concatenated (4C) and reduced to `out_dim`;
    V2 norms after the reduction, V1 before it."""

    def __init__(self, dim: int, out_dim: int, resolution: Tuple[int, int],
                 version: int = 2):
        super().__init__()
        self.resolution = tuple(resolution)
        self.version = version
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim if version == 1 else out_dim,
                                 eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        h = x.reshape(B, H, W, C)
        h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                       h[:, 0::2, 1::2], h[:, 1::2, 1::2]], dim=-1)
        h = h.reshape(B, L // 4, 4 * C)
        if self.version == 1:
            return self.reduction(self.norm(h))
        return self.norm(self.reduction(h))


def stage_windows(config: Swin2Config, grid: Tuple[int, int]
                  ) -> List[Tuple[Tuple[int, int], int]]:
    """Each stage's (grid, window): the window clamped to the grid (timm
    _calc_window_shift); raises ValueError for a grid the window does
    not divide."""
    out = []
    res = tuple(grid)
    for si in range(len(config.depths)):
        window = min(config.window_size, min(res))
        if res[0] % window or res[1] % window:
            raise ValueError(
                f"swin2 stage {si} grid {res} is not divisible by its "
                f"window {window}; use a square input whose side is a "
                f"multiple of {config.patch_size * config.window_size * 2} "
                "(the reference fixes swin2 nets at 384x384)")
        out.append((res, window))
        res = (res[0] // 2, res[1] // 2)
    return out


class SwinV2Backbone(nn.Module):
    """The four stage taps, (B, C_i, H/s, W/s) at strides s = 4, 8, 16,
    32 with C_i = embed_dim 2^i (`out_channels`), of an NCHW image of
    `net_shape`.  The
    blocks' windows, shifts and masks are fixed by `net_shape`; another
    input size raises ValueError."""

    def __init__(self, config: Swin2Config = Swin2Config(),
                 net_shape: Tuple[int, int] = (384, 384),
                 in_channels: int = 3):
        super().__init__()
        cfg = self.config = config
        p = cfg.patch_size
        self.grid = (net_shape[0] // p, net_shape[1] // p)
        self.patch_embed = PatchEmbed(in_channels, cfg.embed_dim, p)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.stages: List[Tuple[List[str], Tuple[int, int], int]] = []
        for si, (res, window) in enumerate(stage_windows(cfg, self.grid)):
            dim = cfg.embed_dim * 2 ** si
            names = []
            for bi in range(cfg.depths[si]):
                shift = (window // 2 if (bi % 2 == 1 and min(res) > window)
                         else 0)
                self.add_module(f"stage{si}_block{bi}", SwinBlockV2(
                    dim, cfg.num_heads[si], res, window, shift,
                    cfg.pretrained_window_sizes[si], cfg.mlp_ratio,
                    cfg.version))
                names.append(f"stage{si}_block{bi}")
            if si < len(cfg.depths) - 1:
                self.add_module(f"downsample{si}", PatchMergingV2(
                    dim, 2 * dim, res, cfg.version))
            self.stages.append((names, res, dim))
        self.out_channels = tuple(dim for _, _, dim in self.stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.patch_embed(x)
        B, C, gh, gw = h.shape
        if (gh, gw) != self.grid:
            raise ValueError(f"swin2 built for a {self.grid} patch grid, "
                             f"got {(gh, gw)}")
        h = self.patch_norm(h.flatten(2).transpose(1, 2))
        taps = []
        for si, (names, res, dim) in enumerate(self.stages):
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h.reshape(B, res[0], res[1], dim).permute(0, 3, 1, 2))
            if si < len(self.stages) - 1:
                h = getattr(self, f"downsample{si}")(h)
        return taps
