"""The host-side plans of the lane conv (B7) and RoI backward (B5)
kernels, on the CPU: the conv's weight packing, its block tiling and the
halo each block stages, mirrored index for index from
csrc/lane_decoder.cu; the backward's tiles and the boxes each tile lists,
against brute force from `ops.patches`' bin bounds."""

import numpy as np
import pytest
import torch

from riders_tpu_torch.models.layers import nearest2x_phase_kernel
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import lane_decoder as LD
from riders_tpu_torch.ops.kernels import roi_pool

# (N, H, W, input widths, Co): decode_full's call geometries at a small
# patch batch, and the edges of the plan (tiny maps, a wide map, one
# pixel, widths that are not whole 16-byte runs)
CONV_SHAPES = [(5, 9, 3, (256, 128), 256), (5, 18, 6, (128, 128), 128),
               (3, 37, 12, (128,), 64), (2, 75, 25, (32, 32), 32),
               (2, 75, 25, (64,), 4), (2, 75, 25, (64,), 64),
               (4, 15, 6, (256,), 256), (2, 30, 12, (128, 128), 128),
               (1, 120, 50, (64,), 64), (7, 13, 7, (32,), 32),
               (300, 1, 1, (64,), 256), (3, 1, 1, (16,), 16),
               (300, 1, 1, (32,), 32), (1, 3, 300, (32,), 64),
               (1, 1, 1, (8,), 8), (2, 11, 4, (13, 6), 20)]


def _plan(N, H, W, cis, co):
    return LD.conv_plan(N, H, W, cis, co, all(c % 8 == 0 for c in cis))


@pytest.mark.parametrize("shape", [(3, 3, 24, 40), (3, 3, 13, 4),
                                   (3, 3, 64, 128)])
def test_packed_weights_unpack_to_hwio_bitwise(shape):
    k = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32))
    packed = LD.pack_conv(k)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (shape[3], 3, 3, shape[2])
    assert torch.equal(packed.permute(1, 2, 3, 0), k.to(torch.bfloat16))
    up = LD.pack_upconv(k)
    assert torch.equal(up.permute(1, 2, 3, 0), nearest2x_phase_kernel(
        k).to(torch.bfloat16))


def _padpos(m, H, W):
    n, r = np.divmod(m, H * W)
    y, x = np.divmod(r, W)
    return n * (H + 2) * (W + 2) + (y + 1) * (W + 2) + x + 1


def _tile_outputs(plan, N, H, W, t):
    """Tile t's accumulator rows as the kernel maps them: (the output
    pixel of each row or -1, each row's padded position, the padded
    position the tile's staged rows start at)."""
    M, Wp, HWp = N * H * W, W + 2, (H + 2) * (W + 2)
    if plan.resident:
        first, last = LD.padded_span(N, H, W)
        P = first + t * plan.bm + np.arange(plan.bm)
        P = P[P <= last]
        n, rem = np.divmod(P, HWp)
        y, x = rem // Wp - 1, rem % Wp - 1
        inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        return np.where(inside, (n * H + y) * W + x, -1), P, P[0] - first
    m = np.arange(t * plan.bm, min((t + 1) * plan.bm, M))
    P = _padpos(m, H, W)
    return m, P, P[0] - (Wp + 1)


@pytest.mark.parametrize("N,H,W,cis,co", CONV_SHAPES)
def test_conv_plan_blocks_cover_every_pixel_once(N, H, W, cis, co):
    plan = _plan(N, H, W, cis, co)
    M = N * H * W
    assert plan.bn in LD.CONV_TILES and plan.bn >= min(co, 64)
    assert plan.bn // 2 < co or plan.bn == 8
    most, bk = LD.CONV_TILES[plan.bn]
    assert plan.tile_m == most
    assert 0 < plan.bm <= most and plan.bm % 16 == 0
    if plan.resident:
        assert all(c % 8 == 0 for c in cis) and plan.bk == LD.RESIDENT_BK
        assert plan.bm == 256 and plan.rows == 256 + 2 * (W + 3)
        chunks = sum(-(-c // plan.bk) for c in cis)
        assert plan.smem == LD.resident_smem(plan.bn, plan.bk, plan.rows,
                                             chunks)
    else:
        assert plan.bk == bk
        assert plan.smem == LD.conv_smem(plan.bn, most, bk, plan.rows)
        assert (plan.tiles - 1) * plan.bm < M
    assert plan.smem <= LD.SMEM_LIMIT
    outs = [_tile_outputs(plan, N, H, W, t)[0] for t in range(plan.tiles)]
    # one block per tile, or a persistent grid of g blocks (block b takes
    # tiles b, b + g, ...)
    for g in (1, 5, 132, plan.tiles):
        owner = np.zeros(M, np.int64)
        for b in range(min(g, plan.tiles)):
            for t in range(b, plan.tiles, g):
                np.add.at(owner, outs[t][outs[t] >= 0], 1)
        assert (owner == 1).all()


@pytest.mark.parametrize("N,H,W,cis,co,resident", [
    (768, 75, 25, (64,), 32, True), (768, 75, 25, (32, 32), 32, True),
    (768, 75, 25, (32,), 64, True), (768, 75, 25, (64,), 4, True),
    (512, 120, 50, (32,), 64, True), (512, 120, 50, (64,), 4, True),
    (768, 75, 25, (64,), 64, False), (512, 120, 50, (64,), 64, False),
    (768, 37, 12, (128,), 64, False), (768, 18, 6, (128, 128), 128, False),
    (768, 9, 3, (256, 128), 256, False), (2, 11, 4, (13, 6), 20, False)])
def test_conv_plan_keeps_weights_resident_where_they_fit(N, H, W, cis, co,
                                                         resident):
    """decode_full's 75x25 / 120x50 calls with Ci * Co <= 2048 keep their
    weights in shared memory; larger weights, and widths that are not
    whole 16-byte runs, stream them."""
    plan = _plan(N, H, W, cis, co)
    assert plan.resident == resident
    assert plan.smem <= (LD.RESIDENT_SMEM_LIMIT if resident
                         else LD.SMEM_LIMIT)


@pytest.mark.parametrize("N,H,W,cis,co", CONV_SHAPES)
def test_conv_plan_halo_holds_every_tap(N, H, W, cis, co):
    """The kernel's index math in numpy: each tile stages `rows` padded
    positions from its start, with a source table that is -1 on the zero
    border; every tap of every output row must land in the staged rows,
    on its pixel's true neighbour (or on the border)."""
    plan = _plan(N, H, W, cis, co)
    Wp, HWp = W + 2, (H + 2) * (W + 2)
    for t in range(plan.tiles):
        pix, P, p0 = _tile_outputs(plan, N, H, W, t)
        assert p0 >= 0
        Q = p0 + np.arange(plan.rows)
        n, rem = np.divmod(Q, HWp)
        y, x = rem // Wp - 1, rem % Wp - 1
        ok = (n < N) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
        src = np.where(ok, (n * H + y) * W + x, -1)
        real = pix >= 0
        n_m, r_m = np.divmod(pix[real], H * W)
        y_m, x_m = np.divmod(r_m, W)
        for dy in range(3):
            for dx in range(3):
                row = P - p0 + (dy - 1) * Wp + (dx - 1)
                assert row.min() >= 0 and row.max() < plan.rows
                ys, xs = y_m + dy - 1, x_m + dx - 1
                inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
                want = np.where(inside, (n_m * H + ys) * W + xs, -1)
                np.testing.assert_array_equal(src[row[real]], want)


def test_conv_plan_shrinks_then_refuses_wide_maps():
    assert LD.conv_plan(300, 1, 1, (32,), 32, vec=False).bm \
        < LD.CONV_TILES[32][0]
    with pytest.raises(ValueError):
        _plan(1, 3, 5000, (64,), 64)


@pytest.mark.parametrize("H,W,C", [(331, 345, 32), (166, 173, 64),
                                   (21, 22, 128), (23, 31, 5), (7, 3, 3000),
                                   (1, 1, 4)])
def test_bwd_tiles_cover_every_position_once(H, W, C):
    th, tw, v = roi_pool.bwd_tiles(W, C)
    assert v == (4 if C % 4 == 0 else 1)
    assert 1 <= tw <= W and th >= 1
    assert th * tw * -(-C // v) <= roi_pool.BWD_TILE_SLOTS or tw == 1
    cover = np.zeros((H, W), np.int64)
    for r in range(0, H, th):
        for c in range(0, W, tw):
            cover[r:min(r + th, H), c:min(c + tw, W)] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("scale,out_size,K", [
    (0.5, (75, 25), 40), (1 / 32, (4, 1), 40), (0.25, (9, 4), 300),
    (0.5, (12, 30), 17)])
def test_bwd_tile_box_list_matches_brute_force(scale, out_size, K):
    """A box is listed for a tile exactly when one of its non-empty bins
    (from `ops.patches`' bounds) meets the tile; boxes past the map, on
    half pixels and smaller than their bins included."""
    rng = np.random.default_rng(K)
    B, H, W = 3, 29, 41
    lo = rng.uniform(-0.3, 1.2, (B, K, 2)) * np.array([W, H]) / scale
    size = rng.uniform(0.2, 1.5, (B, K, 2)) * np.array(out_size[::-1]) \
        / scale
    lo[:, ::4] = np.floor(lo[:, ::4]) + 0.5
    boxes = torch.from_numpy(np.concatenate([lo, lo + size], -1)).float()
    lo_h, hi_h, lo_w, hi_w = patches._roi_bounds(boxes, scale, H, W,
                                                 out_size)
    th, tw, _ = roi_pool.bwd_tiles(W, 32)
    for r in range(0, H, th):
        for c in range(0, W, tw):
            r1, c1 = min(r + th, H), min(c + tw, W)
            rows = (torch.minimum(hi_h, torch.tensor(r1))
                    > torch.maximum(lo_h, torch.tensor(r))).any(-1)
            cols = (torch.minimum(hi_w, torch.tensor(c1))
                    > torch.maximum(lo_w, torch.tensor(c))).any(-1)
            got = roi_pool.bwd_tile_boxes(boxes, scale, H, W, (r, r1),
                                          (c, c1))
            assert torch.equal(got, rows & cols)
