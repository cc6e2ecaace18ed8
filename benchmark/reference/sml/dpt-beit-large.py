"""DPT BEiT-L/16-512 as RIDERS' scale map learner, in float32: the
reference of `sml.model_type` "dpt-beit-large".

Written from MiDaS v3.1's `dpt_beit_large_512` (https://github.com/
isl-org/MiDaS; arXiv 2307.14460): `midas/backbones/beit.py` (BEiT with
its relative position bias resized to the input's window,
`_get_rel_pos_bias`), `midas/backbones/utils.py` and `midas/blocks.py`
(readout, reassembly, RefineNet fusion) and `midas/dpt_depth.py`
(scratch convs, fusion order, head); BEiT from arXiv 2106.08254 (timm's
`beit_large_patch16_512`), DPT from arXiv 2103.13413.

Backbone: a 16x16 stride-16 patch conv, a cls token in front, no
absolute position embedding, and blocks of

    x = x + gamma_1 * attn(norm1(x));  x = x + gamma_2 * mlp(norm2(x))

with an exact-GELU MLP.  The attention projects to q, k and v with
biases on q and v only, scales q by head_dim^-1/2, adds to q k^T a
relative position bias and takes the softmax over the keys.  The bias
table holds (2g - 1)^2 spatial rows for the pretrained g x g grid and 3
rows for the cls token; on every call the spatial rows are resized
bilinearly (align_corners False) to the (2gh - 1) x (2gw - 1) offsets of
the input's gh x gw window, the cls rows kept, and the table gathered by
each (query, key) pair's relative position.

Neck: the tokens after the hooked blocks, each through the 'project'
readout (Linear(2C -> C) and GELU over [patch, cls]), laid out on the
window, a 1x1 conv to its reassembly width and a resize (ConvTranspose
4/4, 2/2, none, conv 3x3/2).  Scratch: 3x3 convs without bias to
`features`; RefineNet fusion from the deepest map up (residual conv
units, bilinear resize with align_corners True to the next map's size,
x2 for the last, a 1x1 out conv).  Head: conv 3x3 to features / 2,
bilinear x2 (align_corners True), conv 3x3 to 32, relu, conv 1x1 to 1,
relu.

Departures from MiDaS:
- seeded weights (`benchmark/weights.py`), not the pretrained checkpoint:
  gammas of 1, the table N(0, 0.02), the head's last conv calibrated;
- RIDERS' scale head in place of MiDaS' depth output: the head's output
  is a scale correction, scales = relu(1 + out), pred = d * scales,
  clamped to [1 / max_pred, 1 / min_pred];
- the input is the SML's three channels (normalised prior, normalised
  scale map, gray), not a normalised RGB image;
- LayerNorm eps 1e-5, the system's, where timm builds BEiT's with 1e-6;
- the table's three cls rows in the system's order (cls <-> cls,
  cls -> token, token -> cls), where timm's is (cls -> token,
  token -> cls, cls <-> cls): a checkpoint's table maps by permuting them;
- timm's final norm after the last block, which no hook reads, is left
  out; eval only (no dropout, no drop path).

Module and tensor names are the system's state-dict keys, so that the
benchmark's weights load into both.  The widths are parameters of
`DPTBEiT`; `SML(sml_section)` fixes the published ones.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.chain import f32_exact


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class ConvTranspose(nn.ConvTranspose2d):
    """A transposed conv whose weight and bias the benchmark's weights
    fill, rounded by `emulate_` as chain.emulate_ rounds a conv."""

    INIT = {"weight": "w_t", "bias": "b"}
    rounding = staticmethod(_same)

    def emulate_(self, rounding) -> None:
        with torch.no_grad():
            self.weight.copy_(rounding(self.weight))
        self.rounding = rounding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rounding(super().forward(self.rounding(x)))


def relative_position_index(gh: int, gw: int) -> torch.Tensor:
    """(n + 1, n + 1) rows of the resized table for a gh x gw window plus
    cls (n = gh * gw): the spatial offset (dy, dx) of each token pair at
    row (dy + gh - 1) * (2gw - 1) + dx + gw - 1, then the cls rows."""
    yx = torch.stack(torch.meshgrid(torch.arange(gh), torch.arange(gw),
                                    indexing="ij")).flatten(1)
    rel = (yx[:, :, None] - yx[:, None, :]).permute(1, 2, 0)
    spatial = (rel[..., 0] + gh - 1) * (2 * gw - 1) + rel[..., 1] + gw - 1
    rows = (2 * gh - 1) * (2 * gw - 1)
    n = gh * gw
    index = torch.empty(n + 1, n + 1, dtype=torch.long)
    index[1:, 1:] = spatial
    index[0, 1:] = rows + 1          # cls -> token
    index[1:, 0] = rows + 2          # token -> cls
    index[0, 0] = rows               # cls <-> cls
    return index


class Attention(nn.Module):
    """BEiT self-attention with the resized relative position bias.
    `emulate_` rounds the qkv kernel and the table, and on every call the
    qkv projection's input and output and the inputs and outputs of
    q k^T and attn v; the logits, the bias and the softmax stay float32,
    as in the system."""

    INIT = {"qkv_kernel": "w", "q_bias": "b", "v_bias": "b",
            "rel_pos_bias_table": ("normal", 0.02)}

    def __init__(self, dim: int, heads: int, grid: int):
        super().__init__()
        self.heads, self.grid = heads, grid
        self.scale = (dim // heads) ** -0.5
        self.qkv_kernel = nn.Parameter(torch.empty(3 * dim, dim))
        self.q_bias = nn.Parameter(torch.empty(dim))
        self.v_bias = nn.Parameter(torch.empty(dim))
        self.rel_pos_bias_table = nn.Parameter(
            torch.empty((2 * grid - 1) ** 2 + 3, heads))
        self.proj = nn.Linear(dim, dim)
        self.rounding = _same
        self.indices = {}    # (window, device) -> index; derived, not state

    def emulate_(self, rounding) -> None:
        with torch.no_grad():
            self.qkv_kernel.copy_(rounding(self.qkv_kernel))
            self.rel_pos_bias_table.copy_(rounding(self.rel_pos_bias_table))
        self.rounding = rounding

    def relative_position_bias(self, window: Tuple[int, int]
                               ) -> torch.Tensor:
        """(heads, n + 1, n + 1) bias of the window (MiDaS'
        `_get_rel_pos_bias`)."""
        gh, gw = window
        g, table = self.grid, self.rel_pos_bias_table
        old = table[:-3].reshape(1, 2 * g - 1, 2 * g - 1, self.heads)
        new = F.interpolate(old.permute(0, 3, 1, 2),
                            size=(2 * gh - 1, 2 * gw - 1), mode="bilinear",
                            align_corners=False)
        full = torch.cat([new.permute(0, 2, 3, 1).reshape(-1, self.heads),
                          table[-3:]])
        key = (window, str(table.device))
        if key not in self.indices:
            self.indices[key] = relative_position_index(gh, gw).to(
                table.device)
        index = self.indices[key]
        n = gh * gw + 1
        return full[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, window: Tuple[int, int]
                ) -> torch.Tensor:
        r = self.rounding
        B, N, C = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = r(F.linear(r(x), self.qkv_kernel, bias))
        q, k, v = qkv.reshape(B, N, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)
        logits = r((q * self.scale) @ k.transpose(-2, -1))
        attn = (logits + self.relative_position_bias(window)).softmax(-1)
        out = r(r(attn) @ v)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    INIT = {"gamma_1": "ones", "gamma_2": "ones"}

    def __init__(self, dim: int, heads: int, mlp_dim: int, grid: int):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.empty(dim))
        self.gamma_2 = nn.Parameter(torch.empty(dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads, grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, mlp_dim)
        self.mlp_fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor, window: Tuple[int, int]
                ) -> torch.Tensor:
        x = x + self.gamma_1 * self.attn(self.norm1(x), window)
        return x + self.gamma_2 * self.mlp_fc2(F.gelu(self.mlp_fc1(
            self.norm2(x))))


class BEiT(nn.Module):
    """The backbone: the token sequences after the hooked blocks."""

    INIT = {"cls_token": "zeros"}

    def __init__(self, in_channels: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, patch: int, grid: int, hooks: Sequence[int]):
        super().__init__()
        self.depth, self.hooks = depth, tuple(hooks)
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, heads, mlp_dim, grid))

    def forward(self, x: torch.Tensor, window: Tuple[int, int]):
        h = self.patch_embed(x).flatten(2).transpose(1, 2)
        h = torch.cat([self.cls_token.expand(len(h), -1, -1), h], 1)
        taps = []
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, window)
            if i in self.hooks:
                taps.append(h)
        return taps


class Reassemble(nn.Module):
    """'project' readout, tokens to the window, 1x1 conv, resize."""

    def __init__(self, dim: int, channels: int, scale: int):
        super().__init__()
        self.readout_project = nn.Linear(2 * dim, dim)
        self.project = nn.Conv2d(dim, channels, 1)
        if scale in (4, 2):
            self.resize = ConvTranspose(channels, channels, scale, scale)
        elif scale == -2:
            self.resize = nn.Conv2d(channels, channels, 3, 2, 1)
        else:
            self.resize = None

    def forward(self, tokens: torch.Tensor, window: Tuple[int, int]
                ) -> torch.Tensor:
        patches = tokens[:, 1:]
        readout = tokens[:, :1].expand_as(patches)
        h = F.gelu(self.readout_project(torch.cat([patches, readout], -1)))
        h = h.transpose(1, 2).unflatten(2, window)
        h = self.project(h)
        return h if self.resize is None else self.resize(h)


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


class DPTBEiT(nn.Module):
    """The network at any widths.  forward(x, d): x (N, h, w, in_channels)
    the SML's input, d (N, h, w, 1) the aligned inverse depth; returns
    pred (N, h, w, 1)."""

    HEAD = "head_conv3"

    def __init__(self, *, in_channels: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, patch: int, grid: int,
                 hooks: Sequence[int], channels: Sequence[int],
                 features: int, head_features: int, min_pred: float,
                 max_pred: float):
        super().__init__()
        self.patch = patch
        self.min_pred, self.max_pred = min_pred, max_pred
        self.pretrained = BEiT(in_channels, dim, depth, heads, mlp_dim,
                               patch, grid, hooks)
        for i, (c, scale) in enumerate(zip(channels, (4, 2, 1, -2))):
            self.add_module(f"reassemble{i + 1}", Reassemble(dim, c, scale))
        for i, c in enumerate(channels):
            self.add_module(f"layer{i + 1}_rn",
                            nn.Conv2d(c, features, 3, 1, 1, bias=False))
        for i in range(4, 0, -1):
            self.add_module(f"refinenet{i}", Fusion(features, i != 4))
        self.head_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.head_conv2 = nn.Conv2d(features // 2, head_features, 3, 1, 1)
        self.head_conv3 = nn.Conv2d(head_features, 1, 1)

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor that the head's last conv reads."""
        with f32_exact():
            x = x.permute(0, 3, 1, 2)
            window = (x.shape[-2] // self.patch, x.shape[-1] // self.patch)
            l1, l2, l3, l4 = [
                getattr(self, f"layer{i + 1}_rn")(
                    getattr(self, f"reassemble{i + 1}")(t, window))
                for i, t in enumerate(self.pretrained(x, window))]
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


class SML(DPTBEiT):
    """BEiT-L/16-512 with the DPT neck at the published widths: 24 blocks
    of width 1024, 16 heads of 64, MLP 4096, 16x16 patches, a 32x32
    pretrained grid, hooks after blocks 5, 11, 17 and 23, reassembly to
    256, 512, 1024 and 1024 channels, fusion at 256."""

    def __init__(self, sml: dict):
        if sml["model_type"] != "dpt-beit-large":
            raise ValueError(f"not dpt-beit-large: {sml['model_type']!r}")
        super().__init__(in_channels=sml["in_channels"], dim=1024, depth=24,
                         heads=16, mlp_dim=4096, patch=16, grid=32,
                         hooks=(5, 11, 17, 23),
                         channels=(256, 512, 1024, 1024), features=256,
                         head_features=32, min_pred=sml["min_pred"],
                         max_pred=sml["max_pred"])
