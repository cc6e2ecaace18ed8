"""LeViT-384 backbone of the DPT family (the `levit_384` row).

timm's `levit_384` as the JAX package's `models/levit.py` has it: a
hybrid stem of four 3x3 / 2 convs with hard-swish between them (to /16;
timm's stem_b16, whose weights the reference checkpoints hold, has none
after the last conv, where the JAX model applies one), then three
stages of residual attention / MLP pairs with learned per-offset
attention biases, and a stride-2 attention subsample with its MLP
between stages.  Every BatchNorm of the reference is folded into the
conv or linear before it (by `models.convert.convert_levit_state_dict`,
timm's own `fuse()`), so the modules are plain convs and linears with
bias.

Each attention-bias table holds one entry per unique (|dy|, |dx|) offset
of its token grid, so its width depends on the input size: the backbone
is built for `net_shape` (a ceil(H / 16) x ceil(W / 16) grid) and raises
on another.  The logits, the biases and the softmax are float32 in a
bf16 model, and the tables stay float32 (`layers.KeepF32`).  Module and
attribute names mirror the JAX package's flax tree.  Tokens are (B, N,
C); the backbone takes an NCHW image and returns NCHW maps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.models.layers import KeepF32


@dataclasses.dataclass(frozen=True)
class LeViTConfig:
    """timm levit_384 hyperparameters (embed 384 / 512 / 768)."""

    embed_dims: Tuple[int, int, int] = (384, 512, 768)
    key_dim: int = 32
    num_heads: Tuple[int, int, int] = (6, 9, 12)
    depths: Tuple[int, int, int] = (4, 4, 4)
    attn_ratio: int = 2
    mlp_ratio: int = 2
    down_attn_ratio: int = 4      # AttentionSubsample attn_ratio
    down_mlp_ratio: int = 2
    hooks: Tuple[int, int, int] = (3, 11, 21)   # flat block indices


def _bias_idxs(points_q, points_kv, stride: int = 1):
    """timm levit attention_bias_idxs: one learned bias per unique
    absolute (dy, dx) offset, gathered into a dense (Nq, Nkv) index;
    returns the index and the number of offsets."""
    offsets = {}
    idxs = []
    for p1 in points_q:
        for p2 in points_kv:
            off = (abs(p1[0] * stride - p2[0]), abs(p1[1] * stride - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    idx = np.asarray(idxs, np.int32).reshape(len(points_q), len(points_kv))
    return idx, len(offsets)


def _grid_points(gh: int, gw: int):
    return [(y, x) for y in range(gh) for x in range(gw)]


def stem_grid(net_shape: Tuple[int, int]) -> Tuple[int, int]:
    """The token grid after the four 3x3 / 2 pad-1 stem convs."""
    return (-(-net_shape[0] // 16), -(-net_shape[1] // 16))


def sub_grid(grid: Tuple[int, int], stride: int = 2) -> Tuple[int, int]:
    """The subsample's query grid: every `stride`-th token, ceil."""
    return ((grid[0] - 1) // stride + 1, (grid[1] - 1) // stride + 1)


class _OffsetBias(KeepF32):
    """A learned (heads, offsets) table gathered into a dense (heads, Nq,
    Nkv) float32 bias of a fixed query / key grid pair."""

    F32_PARAMS = ("attention_biases",)

    def _init_bias(self, heads: int, grid_q, grid_kv, stride: int) -> None:
        idx, n_off = _bias_idxs(_grid_points(*grid_q),
                                _grid_points(*grid_kv), stride)
        self._bias_index = torch.from_numpy(idx.reshape(-1).astype(np.int64))
        self._bias_shape = (heads, idx.shape[0], idx.shape[1])
        self._index_on: Dict[str, torch.Tensor] = {}
        self.attention_biases = nn.Parameter(torch.zeros(heads, n_off))

    def bias(self) -> torch.Tensor:
        table = self.attention_biases
        key = str(table.device)
        if key not in self._index_on:
            self._index_on[key] = self._bias_index.to(table.device)
        return table[:, self._index_on[key]].reshape(
            self._bias_shape).to(torch.float32)


def _attend(q, k, v, kd: int, bias: torch.Tensor, dtype) -> torch.Tensor:
    """softmax(q k^T / sqrt(kd) + bias) v with float32 logits; q, k, v are
    (B, heads, N, d); returns (B, Nq, heads * dv)."""
    attn = (q @ k.transpose(-2, -1)).to(torch.float32)
    attn = (attn * kd ** -0.5 + bias[None]).softmax(-1).to(dtype)
    out = attn @ v
    B, h, N, dv = out.shape
    return out.transpose(1, 2).reshape(B, N, h * dv)


class LeViTAttention(_OffsetBias):
    """Residual attention block: per-head interleaved qkv, learned offset
    biases, hard-swish before the output projection."""

    def __init__(self, dim: int, key_dim: int, num_heads: int,
                 attn_ratio: int, grid: Tuple[int, int]):
        super().__init__()
        self.kd, self.h = key_dim, num_heads
        self.vd = key_dim * attn_ratio
        self.qkv = nn.Linear(dim, num_heads * (2 * key_dim + self.vd))
        self.proj = nn.Linear(num_heads * self.vd, dim)
        self._init_bias(num_heads, grid, grid, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        kd = self.kd
        qkv = self.qkv(x).reshape(B, N, self.h, 2 * kd + self.vd)
        q, k, v = (t.transpose(1, 2) for t in
                   qkv.split([kd, kd, self.vd], dim=-1))
        out = F.hardswish(_attend(q, k, v, kd, self.bias(), x.dtype))
        return x + self.proj(out)


class LeViTSubsample(_OffsetBias):
    """Attention subsample: queries from every second token of the grid
    (ceil), keys and values from all; not residual (the token count and
    width change)."""

    def __init__(self, in_dim: int, out_dim: int, key_dim: int,
                 num_heads: int, attn_ratio: int, grid: Tuple[int, int],
                 stride: int = 2):
        super().__init__()
        self.kd, self.h = key_dim, num_heads
        self.vd = key_dim * attn_ratio
        self.grid, self.stride = tuple(grid), stride
        self.kv = nn.Linear(in_dim, num_heads * (key_dim + self.vd))
        self.q = nn.Linear(in_dim, num_heads * key_dim)
        self.proj = nn.Linear(num_heads * self.vd, out_dim)
        self._init_bias(num_heads, sub_grid(grid, stride), grid, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        kd, s = self.kd, self.stride
        kv = self.kv(x).reshape(B, N, self.h, kd + self.vd)
        k, v = (t.transpose(1, 2) for t in kv.split([kd, self.vd], dim=-1))
        sub = x.reshape(B, *self.grid, C)[:, ::s, ::s].reshape(B, -1, C)
        q = self.q(sub).reshape(B, -1, self.h, kd).transpose(1, 2)
        return self.proj(F.hardswish(_attend(q, k, v, kd, self.bias(),
                                             x.dtype)))


class LeViTMlp(nn.Module):
    """Residual MLP with hard-swish."""

    def __init__(self, dim: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(F.hardswish(self.fc1(x)))


class LeViTBackbone(nn.Module):
    """The LeViT-384 trunk of an NCHW image of `net_shape`: the three
    hooked token maps as (B, C_i, gh_i, gw_i), dims (384, 512, 768)
    (`out_channels`) at strides 16 / 32 / 64.  The blocks after the last
    hook (22-27 of levit_384) hold checkpoint weights but reach no
    output, so they are not run (their parameters get no gradient; the
    JAX model's gradients there are zero)."""

    def __init__(self, config: LeViTConfig = LeViTConfig(),
                 net_shape: Tuple[int, int] = (224, 224),
                 in_channels: int = 3):
        super().__init__()
        cfg = self.config = config
        e0 = cfg.embed_dims[0]
        cin = in_channels
        for j, c in enumerate((e0 // 8, e0 // 4, e0 // 2, e0)):
            self.add_module(f"stem_conv{2 * j}", nn.Conv2d(cin, c, 3, 2, 1))
            cin = c
        self.grid = grid = stem_grid(net_shape)
        # (flat block index, grid after it, width after it)
        self.blocks: List[Tuple[int, Tuple[int, int], int]] = []
        i = 0
        for si in range(3):
            dim = cfg.embed_dims[si]
            for _ in range(cfg.depths[si]):
                self.add_module(f"blocks_{i}", LeViTAttention(
                    dim, cfg.key_dim, cfg.num_heads[si], cfg.attn_ratio,
                    grid))
                self.add_module(f"blocks_{i + 1}",
                                LeViTMlp(dim, cfg.mlp_ratio))
                self.blocks += [(i, grid, dim), (i + 1, grid, dim)]
                i += 2
            if si < 2:
                out_dim = cfg.embed_dims[si + 1]
                # subsample heads = in_dim // key_dim (timm down_ops)
                self.add_module(f"blocks_{i}", LeViTSubsample(
                    dim, out_dim, cfg.key_dim, dim // cfg.key_dim,
                    cfg.down_attn_ratio, grid))
                grid = sub_grid(grid)
                self.add_module(f"blocks_{i + 1}",
                                LeViTMlp(out_dim, cfg.down_mlp_ratio))
                self.blocks += [(i, grid, out_dim), (i + 1, grid, out_dim)]
                i += 2
        self.out_channels = tuple(dim for j, _, dim in self.blocks
                                  if j in cfg.hooks)
        if len(self.out_channels) != 3:
            raise ValueError(f"levit hooks {cfg.hooks} do not name three "
                             f"of its {i} blocks")

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The /16 map of the four stem convs, hard-swish between them."""
        h = self.stem_conv0(x)
        for j in (2, 4, 6):
            h = getattr(self, f"stem_conv{j}")(F.hardswish(h))
        return h

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.stem(x)
        B, C, gh, gw = h.shape
        if (gh, gw) != self.grid:
            raise ValueError(f"levit built for a {self.grid} token grid, "
                             f"got {(gh, gw)}")
        tokens = h.flatten(2).transpose(1, 2)
        taps = []
        last = max(self.config.hooks)
        for i, grid, dim in self.blocks[:last + 1]:
            tokens = getattr(self, f"blocks_{i}")(tokens)
            if i in self.config.hooks:
                taps.append(tokens.reshape(B, *grid, dim).permute(0, 3, 1, 2))
        return taps
