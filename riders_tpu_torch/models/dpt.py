"""DPT Scale Map Learner: the big-backbone SML variants.

A transformer encoder tapped at four depths, DPT reassembly (readout
projection, spatial restore, per-tap resize), RefineNet fusion at
`features` channels and the multiplicative scale-map head:

    scales = relu(1 + out);  pred = d * scales          (inverse depth)

then clamps pred <= 1/min_pred and pred >= 1/max_pred.

Backbone families built here (`models/factory.py:DPT_FAMILIES` maps the
model_type strings to them):
* 'vit'        - plain ViT with an absolute position embedding, its grid
  part resized bilinearly (align_corners=False) to the runtime grid;
* 'beit'       - BEiT: q/v-only qkv bias, layer-scale gammas and a
  relative position bias table resized to the runtime window, added in
  f32 before an f32 softmax;
* 'vit_hybrid' - ResNetV2-50 stages (weight-standardised TF-SAME convs,
  GroupNorm(32)) feeding a 1x1 patch embed into ViT-B; taps 1-2 are the
  first two stage maps.
The 'swin2', 'levit' and 'next_vit' families raise NotImplementedError.

Module and attribute names mirror the JAX package's flax parameter tree,
so `models.from_jax` loads its variables by path; `models.convert` loads
reference checkpoints.  Inputs and outputs are NHWC like the JAX model;
inside, maps are NCHW (channels_last on the card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.models.layers import place
from riders_tpu_torch.models.sml import ResidualConvUnit
from riders_tpu_torch.ops.resize import resize_nchw

UNPORTED = {"swin2": "Swin2 / Swin-V1", "levit": "LeViT",
            "next_vit": "Next-ViT"}


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    net_shape: Tuple[int, int] = (512, 672)   # minimal 512-resize of 480x640
    backbone: str = "vit"                     # 'vit' | 'beit' | 'vit_hybrid'
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    reassemble_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256
    in_channels: int = 3
    min_pred: Optional[float] = 0.1
    max_pred: Optional[float] = 255.0
    # pretrained grid (vit_large_patch16_384: 24x24 + cls;
    # beitl16_512: 32x32 + cls)
    pretrained_grid: int = 24


def _unported(backbone: str) -> NotImplementedError:
    return NotImplementedError(
        f"the DPT {UNPORTED[backbone]} backbone is not ported yet "
        f"(ROADMAP.md A6)")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _nchw(tokens: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """(B, gh*gw, C) tokens -> (B, C, gh, gw)."""
    B, _, C = tokens.shape
    return tokens.reshape(B, grid[0], grid[1], C).permute(0, 3, 1, 2)


def _resized_pos_embed(pos: torch.Tensor, grid: int,
                       out: Tuple[int, int]) -> torch.Tensor:
    """(1, grid*grid + 1, C) -> (1, gh*gw + 1, C): the cls row as it is,
    the grid part resized bilinearly with align_corners=False."""
    C = pos.shape[-1]
    cls, g = pos[:, :1], pos[:, 1:]
    g = resize_nchw(g.reshape(1, grid, grid, C).permute(0, 3, 1, 2), out,
                    "bilinear", False)
    g = g.permute(0, 2, 3, 1).reshape(1, out[0] * out[1], C)
    return torch.cat([cls, g], dim=1)


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, biased
    projections): `query` / `key` / `value` / `out` Linears, softmax of
    q k^T / sqrt(hd)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape

        def heads(t):
            return t.reshape(B, N, self.num_heads, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(self.query(x)), heads(self.key(x)), heads(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(B, N, C))


class ViTBlock(nn.Module):
    """Pre-norm transformer block: LayerNorm eps 1e-5, exact GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, grid=None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(_gelu(self.mlp_fc1(self.norm2(x))))


def beit_rel_pos_index(gh: int, gw: int) -> np.ndarray:
    """Relative position index of a (gh, gw) window plus cls token, of
    shape (gh*gw+1, gh*gw+1), into a table of (2gh-1)*(2gw-1) + 3 rows:
    the spatial offsets, then cls<->cls, cls->token, token->cls."""
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    n = gh * gw
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel + 1     # cls -> token
    idx[0:, 0] = num_rel + 2     # token -> cls
    idx[0, 0] = num_rel          # cls -> cls
    return idx


class BEiTAttention(nn.Module):
    """BEiT attention: one qkv projection with q / v biases only, and a
    learned relative position bias, parametrised at the pretrained square
    grid and resized bilinearly (align_corners=False) to the runtime
    window on every call (the table is trained, so the resize stays in
    the graph).  The bias is added to f32 logits before an f32 softmax.

    `qkv_kernel` is held as a torch Linear weight (3C, C); the flax leaf
    of that name is its transpose (`JAX_TRANSPOSED`)."""

    JAX_TRANSPOSED = ("qkv_kernel",)

    def __init__(self, dim: int, num_heads: int, pretrained_grid: int):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_grid = pg = pretrained_grid
        self.qkv_kernel = nn.Parameter(torch.empty(3 * dim, dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.rel_pos_bias_table = nn.Parameter(
            torch.empty((2 * pg - 1) ** 2 + 3, num_heads))
        self.proj = nn.Linear(dim, dim)
        self._index: Dict[Tuple, torch.Tensor] = {}
        self.reset_jax_init_(None)

    @torch.no_grad()
    def reset_jax_init_(self, g: Optional[torch.Generator]) -> None:
        """flax's initialisers: normal(0.02) kernel and table, zero q / v
        biases."""
        for p in (self.qkv_kernel, self.rel_pos_bias_table):
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
        self.q_bias.zero_()
        self.v_bias.zero_()

    def _rel_index(self, grid, device) -> torch.Tensor:
        key = (tuple(grid), str(device))
        if key not in self._index:
            self._index[key] = torch.from_numpy(
                beit_rel_pos_index(*grid).reshape(-1)).to(device)
        return self._index[key]

    def rel_pos_bias(self, grid: Tuple[int, int]) -> torch.Tensor:
        """(heads, N, N) f32 bias of a (gh, gw) window plus cls."""
        gh, gw = grid
        pg, h = self.pretrained_grid, self.num_heads
        table = self.rel_pos_bias_table.float()
        spatial = table[:-3]
        if (gh, gw) != (pg, pg):
            spatial = spatial.reshape(1, 2 * pg - 1, 2 * pg - 1, h)
            spatial = F.interpolate(
                spatial.permute(0, 3, 1, 2), size=(2 * gh - 1, 2 * gw - 1),
                mode="bilinear", align_corners=False)
            spatial = spatial.permute(0, 2, 3, 1).reshape(-1, h)
        full = torch.cat([spatial, table[-3:]], dim=0)
        n = gh * gw + 1
        bias = full[self._rel_index(grid, full.device)]
        return bias.reshape(n, n, h).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]
                ) -> torch.Tensor:
        B, N, C = x.shape
        hd = C // self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv_kernel, bias)
        q, k, v = qkv.reshape(B, N, 3, self.num_heads, hd).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = (q @ k.transpose(-2, -1)).float() / math.sqrt(hd)
        attn = (attn + self.rel_pos_bias(grid)[None]).softmax(-1)
        out = (attn.to(x.dtype) @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class BEiTBlock(nn.Module):
    """BEiT block: layer-scale (gamma) residuals around the
    relative-position attention and the MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 pretrained_grid: int):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = BEiTAttention(dim, num_heads, pretrained_grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    @torch.no_grad()
    def reset_jax_init_(self, g: Optional[torch.Generator]) -> None:
        self.gamma_1.fill_(1.0)
        self.gamma_2.fill_(1.0)

    def forward(self, x: torch.Tensor, grid: Tuple[int, int]
                ) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x), grid)
        h = self.mlp_fc2(_gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.gamma_2 * h


class _Tokens(nn.Module):
    """The cls token, the optional absolute position embedding and the
    transformer blocks shared by the ViT, BEiT and hybrid backbones."""

    def _build(self, cfg: DPTConfig, beit: bool, pos: bool) -> None:
        C, pg = cfg.embed_dim, cfg.pretrained_grid
        self.grid = pg
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = (nn.Parameter(torch.empty(1, pg * pg + 1, C))
                          if pos else None)
        for i in range(cfg.depth):
            block = (BEiTBlock(C, cfg.num_heads, cfg.mlp_ratio, pg) if beit
                     else ViTBlock(C, cfg.num_heads, cfg.mlp_ratio))
            self.add_module(f"block{i}", block)
        self.depth = cfg.depth
        self.reset_jax_init_(None)

    @torch.no_grad()
    def reset_jax_init_(self, g: Optional[torch.Generator]) -> None:
        """flax's initialisers: zero cls token, normal(0.02) position
        embedding."""
        self.cls_token.zero_()
        if self.pos_embed is not None:
            self.pos_embed.copy_(
                0.02 * torch.randn(self.pos_embed.shape, generator=g))

    def run_blocks(self, h: torch.Tensor, hooks) -> Tuple[List, Tuple]:
        """(B, C, gh, gw) patch embedding -> the token sequences after the
        blocks in `hooks`, and the grid."""
        B, C, gh, gw = h.shape
        tokens = torch.cat([self.cls_token.expand(B, 1, C).to(h.dtype),
                            h.flatten(2).transpose(1, 2)], dim=1)
        if self.pos_embed is not None:
            tokens = tokens + _resized_pos_embed(self.pos_embed, self.grid,
                                                 (gh, gw)).to(h.dtype)
        taps = []
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, (gh, gw))
            if i in hooks:
                taps.append(tokens)
        return taps, (gh, gw)


class PatchEmbed(nn.Conv2d):
    """The p x p, stride-p patch embedding (VALID: a remainder of rows or
    columns is dropped), computed as one matmul over the unfolded patches
    with the conv's own weights.  In bf16 on the card the library's conv
    for it moved `validate_sml`'s seven metrics 2-270x further from the
    f32 host's than this matmul does (sq_rel 1.08% against 0.06%,
    `chip_smoke.py` phase 10c)."""

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


class ViTBackbone(_Tokens):
    """ViT / BEiT with a cls token; returns the token sequences at the
    config's hooks and the grid."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.hooks = cfg.hooks
        p = cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.in_channels, cfg.embed_dim, p)
        self._build(cfg, beit=cfg.backbone == "beit",
                    pos=cfg.backbone == "vit")

    def forward(self, x: torch.Tensor):
        return self.run_blocks(self.patch_embed(x), self.hooks)


def same_pads(shape, kernel: int, stride: int) -> Tuple[int, int, int, int]:
    """TF-SAME (left, right, top, bottom) padding of a (H, W) map: total
    max((ceil(n / s) - 1) * s + k - n, 0), the smaller half first."""
    pads = []
    for n in reversed(tuple(shape)):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class StdConv(nn.Conv2d):
    """Weight-standardised conv with TF-SAME padding (timm StdConv2dSame):
    each output channel's kernel to zero mean and unit biased variance,
    eps 1e-6, in f32."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        w = ((w - mean) / torch.sqrt(var + 1e-6)).to(x.dtype)
        x = F.pad(x, same_pads(x.shape[-2:], self.kernel_size[0],
                               self.stride[0]))
        return F.conv2d(x, w, None, self.stride)


class GNAct(nn.Module):
    """GroupNorm(32), eps 1e-5, and an optional relu."""

    def __init__(self, channels: int, apply_act: bool = True):
        super().__init__()
        self.gn = nn.GroupNorm(32, channels, eps=1e-5)
        self.apply_act = apply_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gn(x)
        return F.relu(h) if self.apply_act else h


class ResNetV2Bottleneck(nn.Module):
    """timm resnetv2 non-preact Bottleneck: 1x1 / 3x3 / 1x1 StdConvs, each
    followed by GroupNorm (+ relu but the last), a StdConv + GroupNorm
    projection on a change of shape, relu after the residual add."""

    def __init__(self, in_ch: int, mid: int, out: int, stride: int = 1):
        super().__init__()
        if in_ch != out or stride != 1:
            self.downsample_conv = StdConv(in_ch, out, 1, stride)
            self.downsample_norm = GNAct(out, False)
        else:
            self.downsample_conv = None
        self.conv1 = StdConv(in_ch, mid, 1)
        self.norm1 = GNAct(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GNAct(mid)
        self.conv3 = StdConv(mid, out, 1)
        self.norm3 = GNAct(out, False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.downsample_conv is not None:
            shortcut = self.downsample_norm(self.downsample_conv(x))
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class ResNetV2Stages(nn.Module):
    """The truncated ResNetV2-50 of the hybrid's patch embed: 7x7/2
    StdConv + GroupNorm / relu stem, a 3x3/2 TF-SAME max pool (padded
    with -inf), and bottleneck stages (default 3, 4, 9 blocks of 256,
    512, 1024 channels at strides 1, 2, 2).  Returns each stage's output
    (/4, /8, /16)."""

    def __init__(self, in_channels: int = 3,
                 layers: Tuple[int, ...] = (3, 4, 9),
                 channels: Tuple[int, ...] = (256, 512, 1024)):
        super().__init__()
        self.stem_conv = StdConv(in_channels, 64, 7, 2)
        self.stem_norm = GNAct(64)
        self.stages = []
        cin = 64
        for si, (n, c) in enumerate(zip(layers, channels)):
            names = []
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                self.add_module(f"stage{si}_block{bi}",
                                ResNetV2Bottleneck(cin, c // 4, c, stride))
                names.append(f"stage{si}_block{bi}")
                cin = c
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.stem_norm(self.stem_conv(x))
        h = F.max_pool2d(F.pad(h, same_pads(h.shape[-2:], 3, 2),
                               value=float("-inf")), 3, 2)
        outs = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            outs.append(h)
        return outs


class HybridViTBackbone(_Tokens):
    """`vitb_rn50_384`: ResNetV2 stages feed a 1x1 patch embed into ViT
    blocks; returns the first two stage maps, the token sequences at
    hooks[2:], and the grid."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.hooks = cfg.hooks[2:]
        self.backbone = ResNetV2Stages(cfg.in_channels)
        self.patch_embed = nn.Conv2d(1024, cfg.embed_dim, 1)
        self._build(cfg, beit=False, pos=True)

    def forward(self, x: torch.Tensor):
        f4, f8, f16 = self.backbone(x)
        taps, grid = self.run_blocks(self.patch_embed(f16), self.hooks)
        return (f4, f8), taps, grid


class Reassemble(nn.Module):
    """DPT reassembly of one tap: the 'project' readout folds the cls
    token into every patch token (Linear over [patch, cls] + GELU), a
    1x1 conv sets the channels, and a per-tap resize restores the map
    (scale 4 / 2: ConvTranspose k = s = scale; 1: identity; -2: 3x3/2
    conv)."""

    def __init__(self, in_dim: int, out_channels: int, scale: int):
        super().__init__()
        self.readout_project = nn.Linear(2 * in_dim, in_dim)
        self.project = nn.Conv2d(in_dim, out_channels, 1)
        if scale in (4, 2):
            self.resize = nn.ConvTranspose2d(out_channels, out_channels,
                                             scale, scale)
        elif scale == -2:
            self.resize = nn.Conv2d(out_channels, out_channels, 3, 2, 1)
        else:
            self.resize = None

    def forward(self, tokens: torch.Tensor, grid: Tuple[int, int]
                ) -> torch.Tensor:
        cls, patches = tokens[:, :1], tokens[:, 1:]
        h = _gelu(self.readout_project(
            torch.cat([patches, cls.expand_as(patches)], dim=-1)))
        h = self.project(_nchw(h, grid))
        return self.resize(h) if self.resize is not None else h


class FusionBlockL(nn.Module):
    """RefineNet fusion with an explicit target size: optional skip
    through a residual unit, a residual unit, bilinear resize to `size`
    (or x2) with align_corners=True, 1x1 out conv."""

    def __init__(self, features: int, has_skip: bool = True):
        super().__init__()
        self.res_conf_unit1 = (ResidualConvUnit(features) if has_skip
                               else None)
        self.res_conf_unit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out = x
        if skip is not None:
            out = out + self.res_conf_unit1(skip)
        out = self.res_conf_unit2(out)
        size = tuple(size) if size is not None else (2 * out.shape[-2],
                                                     2 * out.shape[-1])
        return self.out_conv(resize_nchw(out, size, "bilinear", True))


class DPTScaleMapLearner(nn.Module):
    """The DPT SML.

    forward(x, d): x (N, H, W, in_channels) network input, d (N, H, W, 1)
    unnormalised aligned inverse depth, both NHWC.  Returns (pred,
    scales), both (N, H, W, 1) float32."""

    def __init__(self, config: DPTConfig = DPTConfig(), device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        if cfg.backbone in UNPORTED:
            raise _unported(cfg.backbone)
        if cfg.backbone not in ("vit", "beit", "vit_hybrid"):
            raise ValueError(f"unknown DPT backbone {cfg.backbone!r}")
        C, rc = cfg.embed_dim, cfg.reassemble_channels
        if cfg.backbone == "vit_hybrid":
            self.pretrained = HybridViTBackbone(cfg)
            self.reassemble3 = Reassemble(C, rc[2], 1)
            self.reassemble4 = Reassemble(C, rc[3], -2)
        else:
            self.pretrained = ViTBackbone(cfg)
            for i, scale in enumerate((4, 2, 1, -2)):
                self.add_module(f"reassemble{i + 1}",
                                Reassemble(C, rc[i], scale))
        f = cfg.features
        for i, c in enumerate(rc):
            self.add_module(f"layer{i + 1}_rn",
                            nn.Conv2d(c, f, 3, 1, 1, bias=False))
        self.refinenet4 = FusionBlockL(f, has_skip=False)
        self.refinenet3 = FusionBlockL(f)
        self.refinenet2 = FusionBlockL(f)
        self.refinenet1 = FusionBlockL(f)
        self.head_conv1 = nn.Conv2d(f, f // 2, 3, 1, 1)
        self.head_conv2 = nn.Conv2d(f // 2, 32, 3, 1, 1)
        self.head_conv3 = nn.Conv2d(32, 1, 1)
        place(self, device, dtype)

    def forward(self, x: torch.Tensor, d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        x = x.to(self.head_conv3.weight.dtype).permute(0, 3, 1, 2)
        if cfg.backbone == "vit_hybrid":
            (f4, f8), taps, grid = self.pretrained(x)
            maps = [f4, f8, self.reassemble3(taps[0], grid),
                    self.reassemble4(taps[1], grid)]
        else:
            taps, grid = self.pretrained(x)
            maps = [getattr(self, f"reassemble{i + 1}")(t, grid)
                    for i, t in enumerate(taps)]
        l1, l2, l3, l4 = (getattr(self, f"layer{i + 1}_rn")(h)
                          for i, h in enumerate(maps))
        p4 = self.refinenet4(l4, size=l3.shape[-2:])
        p3 = self.refinenet3(p4, l3, size=l2.shape[-2:])
        p2 = self.refinenet2(p3, l2, size=l1.shape[-2:])
        p1 = self.refinenet1(p2, l1)

        h = self.head_conv1(p1)
        h = resize_nchw(h, (2 * h.shape[-2], 2 * h.shape[-1]), "bilinear",
                        True)
        h = F.relu(self.head_conv2(h))
        out = F.relu(self.head_conv3(h).float()).permute(0, 2, 3, 1)

        scales = F.relu(1.0 + out)
        pred = d.float() * scales
        if cfg.min_pred is not None and cfg.min_pred > 0:
            pred = torch.clamp(pred, max=1.0 / cfg.min_pred)
        if cfg.max_pred is not None:
            pred = torch.clamp(pred, min=1.0 / cfg.max_pred)
        return pred, scales
