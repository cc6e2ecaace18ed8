"""The BEiT attention between the qkv and output projections
(`ops/kernels/attention.py`, `models/dpt.py:BEiTAttention`) on the CPU:
the kernel's index arithmetic (csrc/beit_attention.cu) mirrored in numpy
against `beit_rel_pos_index`, the path chosen by `attention_path`, the
plain version against the attention as the block computed it before the
split into `rel_pos_table` and `beit_attention_plain`, and the wrapper
and counters on CPU tensors."""

import itertools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from riders_tpu_torch.models import dpt
from riders_tpu_torch.ops.kernels import LAUNCHES
from riders_tpu_torch.ops.kernels.attention import (
    attention_path, beit_attention, beit_attention_plain, beit_rel_pos_index,
    table_rows)

BM, BN = 128, 64        # query rows a block, keys a stage (the kernel's)


def kernel_index(gh, gw):
    """The table index the kernel reads for every (row, key) of its
    blocks and stages, padding included: a_i - b_j from the per-row and
    per-key offsets it computes, the cls entries swapped in where the
    first stage or the warp holding row 0 meets row or key 0."""
    n = gh * gw + 1
    rows = -(-n // BM) * BM
    keys = -(-n // BN) * BN
    w2 = 2 * gw - 1
    centre = (gh - 1) * w2 + gw - 1
    nrel = (2 * gh - 1) * w2
    i = np.arange(rows)[:, None]
    j = np.arange(keys)[None, :]
    p, q = np.maximum(i - 1, 0), np.maximum(j - 1, 0)
    a = np.where((i >= 1) & (i < n), (p // gw) * w2 + p % gw + centre,
                 centre)
    b = np.where((j >= 1) & (j < n), (q // gw) * w2 + q % gw, 0)
    idx = np.broadcast_to(a - b, (rows, keys)).copy()
    # `edge`: the first key stage, or the warp of 32 rows holding row 0
    edge = (j < BN) | (i < 32)
    idx = np.where(edge & (i == 0), np.where(j == 0, nrel, nrel + 1), idx)
    idx = np.where(edge & (i != 0) & (j == 0), nrel + 2, idx)
    return idx, n


@pytest.mark.parametrize("grid", [(32, 40), (24, 24), (4, 5), (1, 3)])
def test_kernel_index_matches_beit_rel_pos_index(grid):
    idx, n = kernel_index(*grid)
    np.testing.assert_array_equal(idx[:n, :n], beit_rel_pos_index(*grid))
    # padding rows and keys still read inside the table (then masked)
    assert idx.min() >= 0 and idx.max() < table_rows(grid)


@pytest.mark.parametrize(
    "dtype,device,training,grad,head_dim",
    list(itertools.product((torch.bfloat16, torch.float32, torch.float16),
                           ("cuda", "cpu"), (False, True), (False, True),
                           (64, 32, 128))))
def test_attention_path(dtype, device, training, grad, head_dim):
    want = ("kernel" if (dtype, device, training, grad, head_dim)
            == (torch.bfloat16, "cuda", False, False, 64) else "plain")
    assert attention_path(dtype, device, training, grad, head_dim) == want


def _attention_before_split(attn, x, grid):
    """`BEiTAttention.forward` as it was before `rel_pos_table` and
    `beit_attention_plain`: the (R, heads) table resized and gathered into
    a permuted (heads, N, N) bias, added to the f32 logits."""
    B, N, C = x.shape
    h = attn.num_heads
    hd = C // h
    bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                      attn.v_bias])
    qkv = F.linear(x, attn.qkv_kernel, bias)
    q, k, v = qkv.reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0)
    gh, gw = grid
    pg = attn.pretrained_grid
    table = attn.rel_pos_bias_table.float()
    spatial = table[:-3]
    if (gh, gw) != (pg, pg):
        spatial = spatial.reshape(1, 2 * pg - 1, 2 * pg - 1, h)
        spatial = F.interpolate(
            spatial.permute(0, 3, 1, 2), size=(2 * gh - 1, 2 * gw - 1),
            mode="bilinear", align_corners=False)
        spatial = spatial.permute(0, 2, 3, 1).reshape(-1, h)
    full = torch.cat([spatial, table[-3:]], dim=0)
    index = torch.from_numpy(beit_rel_pos_index(gh, gw).reshape(-1))
    rel = full[index].reshape(N, N, h).permute(2, 0, 1)
    logits = (q @ k.transpose(-2, -1)).float() / math.sqrt(hd)
    probs = (logits + rel[None]).softmax(-1)
    out = (probs.to(x.dtype) @ v).transpose(1, 2).reshape(B, N, C)
    return attn.proj(out)


def _block_attention(dtype, heads=4, dim=64, grid=4):
    g = torch.Generator().manual_seed(3)
    attn = dpt.BEiTAttention(dim, heads, grid)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) / 4)
    return attn.to(dtype).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [(4, 4), (3, 5), (1, 3)])
def test_plain_attention_as_before_the_split(dtype, window):
    """The block's output through `rel_pos_table` and
    `beit_attention_plain` equals the pre-split attention bit for bit, at
    the pretrained window and resized ones."""
    attn = _block_attention(dtype)
    n = window[0] * window[1] + 1
    x = torch.randn((2, n, 64), generator=torch.Generator().manual_seed(4)
                    ).to(dtype)
    with torch.no_grad():
        got = attn(x, window)
        want = _attention_before_split(attn, x, window)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_rel_pos_table_layout_and_gradient():
    """`rel_pos_table` is the contiguous (heads, R) float32 table, counted
    once a call, and passes the gradient to the parameter."""
    attn = _block_attention(torch.float32)
    dpt.COUNTS.clear()
    table = attn.rel_pos_table((3, 5))
    assert dpt.COUNTS == {"bias_tables": 1}
    assert table.shape == (4, table_rows((3, 5))) and table.is_contiguous()
    assert table.dtype == torch.float32
    table.sum().backward()
    assert attn.rel_pos_bias_table.grad is not None
    # the three cls rows pass through unresized
    assert torch.equal(table[:, -3:], attn.rel_pos_bias_table[-3:].t())


def test_cpu_wrapper_runs_the_plain_version_and_counts():
    """On CPU tensors the wrapper is the plain version, launches nothing,
    and a block's forward counts one "attn_plain"."""
    g = torch.Generator().manual_seed(5)
    grid, heads = (3, 5), 4
    qkv = torch.randn((2, 16, 3 * 4 * 16), generator=g).to(torch.bfloat16)
    table = torch.randn((heads, table_rows(grid)), generator=g)
    LAUNCHES.clear()
    assert torch.equal(beit_attention(qkv, table, grid, heads),
                       beit_attention_plain(qkv, table, grid, heads))
    attn = _block_attention(torch.bfloat16)
    dpt.COUNTS.clear()
    with torch.inference_mode():
        attn(torch.randn((2, 16, 64), generator=g).to(torch.bfloat16), grid)
    assert dpt.COUNTS == {"bias_tables": 1, "attn_plain": 1}
    assert not LAUNCHES
