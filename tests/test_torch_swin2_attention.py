"""The Swin V2 window attention between the qkv and output projections
(`ops/kernels/swin2_attention.py`, `models/swin2.py:WindowAttentionV2`)
on the CPU: the plain version against the attention as the block computed
it before the split into `position_table` and `swin2_attention_plain`;
the kernel's index arithmetic and its band / region rule
(csrc/swin2_attention.cu) mirrored in numpy against `rel_pos_index` and
`shift_mask` at every block geometry of Swin2-L, Swin2-B and Swin2-T,
padding included; the path chosen by `swin2_attention_path`; and the
wrapper and counters on CPU tensors."""

import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from riders_tpu_torch.models import swin2
from riders_tpu_torch.models.factory import _swin_plan
from riders_tpu_torch.ops.kernels import LAUNCHES
from riders_tpu_torch.ops.kernels.swin2_attention import (
    MAX_TOKENS, rel_pos_index, shift_mask, swin2_attention,
    swin2_attention_path, swin2_attention_plain)

BM, BN = 192, 32        # query rows a block, keys a step (the kernel's)
# the DPT rows whose backbone is Swin V2, at their nets
MODELS = {"large": (384, 384), "base": (384, 384), "tiny": (256, 256)}


def _attention_before_split(attn, x, mask):
    """`WindowAttentionV2.forward` as it was before `position_table` and
    `swin2_attention_plain`: the MLP's (R, heads) output gathered to
    (N, N, heads), squashed by 16 sigmoid and permuted, added to the
    scaled f32 logits with the (nW, N, N) mask."""
    Bw, N, C = x.shape
    nh, w = attn.num_heads, attn.window
    bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                      attn.v_bias]).to(x.dtype)
    qkv = F.linear(x, attn.qkv_kernel.to(x.dtype), bias)
    q, k, v = (t.reshape(Bw, N, nh, C // nh).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))

    def l2n(t):
        t32 = t.to(torch.float32)
        n = torch.sqrt((t32 * t32).sum(-1, keepdim=True))
        return (t32 / torch.clamp(n, min=1e-12)).to(t.dtype)

    scale = torch.exp(torch.clamp(attn.logit_scale, max=math.log(100.0)))
    coords = torch.from_numpy(swin2._log_coords_table(
        w, attn.pretrained_window).reshape(-1, 2))
    f32 = torch.float32
    h = F.relu(F.linear(coords, attn.cpb_fc1.weight.to(f32),
                        attn.cpb_fc1.bias.to(f32)))
    table = F.linear(h, attn.cpb_fc2.weight.to(f32))
    index = torch.from_numpy(rel_pos_index(w, w).reshape(-1).astype(
        np.int64))
    rel = (16.0 * torch.sigmoid(table[index].reshape(N, N, nh))).permute(
        2, 0, 1)
    logits = (l2n(q) @ l2n(k).transpose(-2, -1)).to(torch.float32)
    logits = logits * scale[None] + rel[None]
    if mask is not None:
        nW = mask.shape[0]
        logits = (logits.reshape(Bw // nW, nW, nh, N, N)
                  + mask[None, :, None]).reshape(Bw, nh, N, N)
    probs = logits.softmax(-1).to(x.dtype)
    out = (probs @ v).transpose(1, 2).reshape(Bw, N, C)
    return attn.proj(out)


def _window_attention(dtype, dim, heads, window, seed=3):
    """A V2 window attention on seeded weights, its logit scales from 3
    to 900: the first heads under the clamp at log(100), the last over
    it."""
    g = torch.Generator().manual_seed(seed)
    attn = swin2.WindowAttentionV2(dim, heads, window, max(window // 2, 2))
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 4)
        attn.logit_scale.copy_(torch.log(torch.logspace(
            math.log10(3.0), math.log10(900.0), heads)).reshape(heads, 1, 1))
    return attn.to(dtype).eval()


# (dim, heads, window, grid, shift, frames): unshifted and shifted 8x8
# grids, a wide grid, an odd window, and a stage's window clamped to its
# 2x2 grid (the backbone drops the shift there)
GEOMETRIES = [(16, 4, 4, (8, 8), 0, 2), (16, 4, 4, (8, 8), 2, 2),
              (16, 2, 4, (8, 12), 2, 1), (12, 2, 3, (6, 6), 1, 1),
              (16, 4, 2, (2, 2), 0, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim,heads,window,grid,shift,frames", GEOMETRIES)
def test_plain_attention_as_before_the_split(dtype, dim, heads, window,
                                             grid, shift, frames):
    """The block's attention through `position_table` and
    `swin2_attention_plain` equals the pre-split attention bit for bit,
    shifted and unshifted."""
    attn = _window_attention(dtype, dim, heads, window)
    nW = (grid[0] // window) * (grid[1] // window)
    x = torch.randn((frames * nW, window * window, dim),
                    generator=torch.Generator().manual_seed(4)).to(dtype)
    mask = torch.from_numpy(shift_mask(*grid, window, shift)) if shift \
        else None
    with torch.no_grad():
        got = attn(x, shift, grid)
        want = _attention_before_split(attn, x, mask)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_position_table_layout_and_gradient():
    """`position_table` is the contiguous (heads, (2w-1)^2) float32 MLP
    output, counted once a call, and passes the gradient to the MLP."""
    attn = _window_attention(torch.float32, 16, 4, 4)
    swin2.COUNTS.clear()
    table = attn.position_table()
    assert swin2.COUNTS == {"cpb_tables": 1}
    assert table.shape == (4, 49) and table.is_contiguous()
    assert table.dtype == torch.float32
    table.sum().backward()
    assert attn.cpb_fc2.weight.grad is not None
    assert attn.cpb_fc1.weight.grad is not None


def block_geometries(model):
    """Every distinct (grid, window, shift, heads) of the V2 blocks of a
    Swin row's backbone at its net, built on the meta device."""
    config, _ = _swin_plan(model)
    with torch.device("meta"):
        backbone = swin2.SwinV2Backbone(config, MODELS[model])
    return sorted({(b.resolution, b.window, b.shift, b.attn.num_heads)
                   for b in backbone.modules()
                   if isinstance(b, swin2.SwinBlockV2)})


def kernel_index(w):
    """The table index the kernel reads for every (row, key) of its
    blocks and steps, padding included: a_i - b_j from the per-row and
    per-key offsets it computes (a padding row the centre's, a padding
    key 0)."""
    n = w * w
    rows, keys = -(-n // BM) * BM, -(-n // BN) * BN
    w2 = 2 * w - 1
    centre = (w - 1) * w2 + w - 1
    i = np.arange(rows)[:, None]
    j = np.arange(keys)[None, :]
    yi, xi = np.where(i < n, i // w, 0), np.where(i < n, i % w, 0)
    yj, xj = np.where(j < n, j // w, 0), np.where(j < n, j % w, 0)
    return (yi * w2 + xi + centre) - (yj * w2 + xj), n


def kernel_mask(grid, w, shift):
    """The mask the kernel adds in each window of one frame: a token's
    region is (row band, column band), band 0 off the last window of its
    axis, else 1 below w - shift and 2 from there; -100 where a row's
    region and a key's differ, in windows on the last row or column of a
    shifted grid (the others skip the test)."""
    nwy, nwx = grid[0] // w, grid[1] // w
    c = np.arange(w * w)
    out = np.zeros((nwy * nwx, w * w, w * w), np.float32)
    for win in range(nwy * nwx):
        wy, wx = win // nwx, win % nwx
        last_y, last_x = shift > 0 and wy == nwy - 1, \
            shift > 0 and wx == nwx - 1
        if not (last_y or last_x):
            continue

        def band(t, last):
            return np.where(t < w - shift, 1, 2) if last else 0 * t
        region = 3 * band(c // w, last_y) + band(c % w, last_x)
        out[win] = np.where(region[:, None] != region[None, :], -100.0, 0.0)
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_index_matches_rel_pos_index(model):
    for _, w, _, _ in block_geometries(model):
        idx, n = kernel_index(w)
        np.testing.assert_array_equal(idx[:n, :n], rel_pos_index(w, w))
        # padding rows and keys still read inside the table (then
        # dropped or masked)
        assert idx.min() >= 0 and idx.max() < (2 * w - 1) ** 2


@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_regions_match_shift_mask(model):
    """Each shifted geometry's regions give `shift_mask` exactly, and an
    unshifted one no mask; the window is at most 576 tokens and its head
    width 32, so every block takes the kernel."""
    geometries = block_geometries(model)
    assert any(s for _, _, s, _ in geometries)
    config, _ = _swin_plan(model)
    for grid, w, shift, _ in geometries:
        assert w * w <= MAX_TOKENS
        got = kernel_mask(grid, w, shift)
        if shift:
            np.testing.assert_array_equal(got, shift_mask(*grid, w, shift))
        else:
            assert not got.any()
    assert all(config.embed_dim * 2 ** i // h == 32
               for i, h in enumerate(config.num_heads))


@pytest.mark.parametrize(
    "dtype,device,training,grad,head_dim,tokens",
    list(itertools.product((torch.bfloat16, torch.float32, torch.float16),
                           ("cuda", "cpu"), (False, True), (False, True),
                           (32, 64), (576, 144, 577))))
def test_swin2_attention_path(dtype, device, training, grad, head_dim,
                              tokens):
    want = ("kernel" if (dtype, device, training, grad, head_dim)
            == (torch.bfloat16, "cuda", False, False, 32)
            and tokens <= 576 else "plain")
    assert swin2_attention_path(dtype, device, training, grad, head_dim,
                                tokens) == want


def test_cpu_wrapper_runs_the_plain_version_and_counts():
    """On CPU tensors the wrapper is the plain version, launches nothing,
    and a bf16 block's forward in inference mode counts one table and
    one "attn_plain"."""
    g = torch.Generator().manual_seed(5)
    heads, w = 2, 4
    qkv = torch.randn((8, w * w, 3 * heads * 32), generator=g).to(
        torch.bfloat16)
    table = torch.randn((heads, (2 * w - 1) ** 2), generator=g)
    scale = torch.rand(heads, generator=g) * 20
    LAUNCHES.clear()
    for shift in (0, 2):
        assert torch.equal(
            swin2_attention(qkv, table, scale, w, shift, (8, 8), heads),
            swin2_attention_plain(qkv, table, scale, w, shift, (8, 8),
                                  heads))
    attn = _window_attention(torch.bfloat16, 64, heads, w)
    swin2.COUNTS.clear()
    with torch.inference_mode():
        attn(torch.randn((8, w * w, 64), generator=g).to(torch.bfloat16), 2,
             (8, 8))
    assert swin2.COUNTS == {"cpb_tables": 1, "attn_plain": 1}
    assert not LAUNCHES


def test_backbone_counts_one_plain_attention_a_block():
    """A bf16 backbone forward on the CPU in inference mode: one table
    and one plain attention a block, no launch."""
    config = swin2.Swin2Config(embed_dim=64, depths=(2, 2, 2, 2),
                               num_heads=(2, 4, 8, 16), window_size=4,
                               pretrained_window_sizes=(2, 2, 2, 2))
    torch.manual_seed(6)
    backbone = swin2.SwinV2Backbone(config, (64, 64)).to(
        torch.bfloat16).eval()
    swin2.COUNTS.clear()
    LAUNCHES.clear()
    with torch.inference_mode():
        taps = backbone(torch.randn(1, 3, 64, 64).to(torch.bfloat16))
    assert [t.shape[1] for t in taps] == [64, 128, 256, 512]
    assert swin2.COUNTS == {"cpb_tables": 8, "attn_plain": 8}
    assert not LAUNCHES
