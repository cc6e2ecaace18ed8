"""The host-side plans of the lane conv (B7), lane upconv (B8), RoI
backward (B5), stem (B1), RoI forward (B2 / B6) and compose (B4)
kernels, on the CPU: the conv's and upconv's weight packing, block
tiling and the halo each block stages, mirrored index for index from
csrc/lane_decoder.cu; the backward's tiles and the boxes each tile
lists, against brute force from `ops.patches`' bin bounds; the stem's
packed B fragments, its K -> shared offset table and its tiles
(csrc/stem.cu), and the general stem's plan and index math emulated in
numpy (csrc/stem_general.cu); the forward's work table and per-block bin table
(csrc/roi_pool.cu) against `ops.patches`; compose's per-tile point lists
(csrc/compose.cu) against brute force."""

import numpy as np
import pytest
import torch

from riders_tpu_torch.models.layers import nearest2x_phase_kernel
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import lane_decoder as LD
from riders_tpu_torch.ops.kernels import compose, roi_pool, stem

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
    if getattr(plan, "resident", False):
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
    (768, 75, 25, (64,), 64, True), (512, 120, 50, (64,), 64, True),
    (768, 37, 12, (128,), 64, False), (768, 18, 6, (128, 128), 128, False),
    (768, 9, 3, (256, 128), 256, False), (2, 11, 4, (13, 6), 20, False)])
def test_conv_plan_keeps_weights_resident_where_they_fit(N, H, W, cis, co,
                                                         resident):
    """decode_full's 75x25 / 120x50 calls with Ci * Co <= 4096 keep their
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
    _check_halo(_plan(N, H, W, cis, co), N, H, W)


def _check_halo(plan, N, H, W):
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


# (N, h, w, Ci, F): decode_full's upconv calls at a small patch batch
# (NTU 9x3 256 -> 128, ZJU 15x6 256 -> 128 and 60x25 64 -> 32) and the
# card tests' odd ones (F not a multiple of 16, Ci not of 8)
UPCONV_SHAPES = [(5, 9, 3, 256, 128), (4, 15, 6, 256, 128),
                 (3, 60, 25, 64, 32), (3, 9, 3, 256, 128), (2, 5, 3, 24, 16),
                 (3, 4, 7, 40, 12), (2, 3, 2, 12, 32), (1, 60, 25, 64, 32),
                 (2, 7, 5, 16, 8), (2, 6, 4, 64, 72), (2, 9, 3, 256, 32)]


def _up_plan(N, h, w, ci, f):
    return LD.upconv_plan(N, h, w, ci, f, ci % 8 == 0)


@pytest.mark.parametrize("N,h,w,ci,f", UPCONV_SHAPES)
def test_upconv_plan_writes_every_fine_output_once(N, h, w, ci, f):
    """The upconv grid as csrc/lane_decoder.cu decodes it: block (x, y)
    owns tile x (coarse pixels x bm .., or with resident weights the
    padded positions of tile x, the border ones dropped) and, with all
    four phases (resident, F <= bn) or phase y // tiles of F, columns f0
    = (y % tiles) bn ..; coarse pixel (n, i, j), phase (r, s) goes to
    fine pixel (n, 2i + r, 2j + s).  Every fine (pixel, channel) is
    written once."""
    plan = _up_plan(N, h, w, ci, f)
    phases = 4 if plan.resident else 1
    assert phases == 1 or f <= plan.bn
    ftiles = -(-f // plan.bn)
    assert plan.col_blocks == 4 // phases * ftiles
    if plan.resident:
        assert ci % 8 == 0 and plan.bn == LD.UPCONV_RESIDENT_BN
        bm = LD.UPCONV_RESIDENT_M
        assert (plan.tile_m, plan.bk, plan.bm) == (bm, LD.RESIDENT_BK, bm)
        assert plan.rows == bm + 2 * (w + 3)
        assert plan.smem == LD.resident_smem(plan.bn, plan.bk, plan.rows,
                                             -(-ci // plan.bk), 16, 0)
        assert plan.smem <= LD.RESIDENT_SMEM_LIMIT
    else:
        assert (plan.bn, plan.tile_m, plan.bk) == LD.UPCONV_TILE
        assert 0 < plan.bm <= plan.tile_m and plan.bm % 16 == 0
        assert plan.rows == LD.halo_rows(plan.bm, h, w)
        assert plan.smem == LD.conv_smem(plan.bn, plan.tile_m, plan.bk,
                                         plan.rows, 4)
        assert plan.smem <= LD.SMEM_LIMIT
    written = np.zeros((N, 2 * h, 2 * w, f), np.int64)
    for bx in range(plan.tiles):
        m = _tile_outputs(plan, N, h, w, bx)[0]
        n, rem = np.divmod(m[m >= 0], h * w)
        i, j = np.divmod(rem, w)
        for by in range(plan.col_blocks):
            p0 = 0 if phases == 4 else by // ftiles
            f0 = (by % ftiles) * plan.bn
            cols = np.arange(f0, min(f0 + plan.bn, f))
            for p in range(p0, p0 + phases):
                r, s_ = divmod(p, 2)
                np.add.at(written, (n[:, None], 2 * i[:, None] + r,
                                    2 * j[:, None] + s_, cols[None]), 1)
    assert (written == 1).all()


@pytest.mark.parametrize("N,h,w,ci,f", UPCONV_SHAPES)
def test_upconv_plan_halo_holds_every_tap(N, h, w, ci, f):
    """The upconv stages rows as the conv does: every tap of every coarse
    pixel of a block lands in its staged rows."""
    _check_halo(_up_plan(N, h, w, ci, f), N, h, w)


@pytest.mark.parametrize("p", range(4))
def test_upconv_phase_taps_are_the_nonzero_taps(p):
    """Phase p's four taps (the ones the kernel multiplies) decode from
    `pack_upconv` to the composed kernel's taps for that phase's columns,
    bit for bit, and the five others are zero there."""
    rng = np.random.default_rng(p)
    ci, f = 12, 8
    k = torch.from_numpy(rng.standard_normal((3, 3, ci, f)).astype(
        np.float32))
    packed = LD.pack_upconv(k)[p * f:(p + 1) * f]            # (F, 3, 3, ci)
    composed = nearest2x_phase_kernel(k)[..., p * f:(p + 1) * f]
    taps = LD.phase_taps(p)
    assert len(set(taps)) == 4
    for dy, dx in np.ndindex(3, 3):
        got = packed[:, dy, dx].permute(1, 0)
        if (dy, dx) in taps:
            assert bool(got.ne(0).all())
            assert torch.equal(got, composed[dy, dx].to(torch.bfloat16))
        else:
            assert not bool(got.any()) and not bool(composed[dy, dx].any())


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


# ---- the stem (B1): packed weights and the K -> shared offset table

def test_stem_packed_weights_unpack_to_folded_weights_bitwise():
    """Decoded by the kernel's own reading (lane 4 g + t, k-step s, half
    h, word w, element e -> n-tile 2 h + w // 2, GEMM row k = 16 s + 2 t
    + 8 (w % 2) + e, column 8 n + g), the packed weights hold, in row k,
    the folded bf16 weights of the tap `k_order` names, every (k,
    column) once, the 29 padding rows zero."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((32, 3, 7, 7)).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    packed = stem.pack_weights(w, scale)
    steps = stem.K_STEPS
    assert packed.dtype == torch.bfloat16 and packed.shape == (
        16 * steps * 32,)
    frags = packed.view(torch.int16).numpy().reshape(steps, 2, 32, 4, 2)
    got = np.zeros((16 * steps, 32), np.int16)
    seen = np.zeros((16 * steps, 32), np.int64)
    for s, h, lane, word, e in np.ndindex(frags.shape):
        g, t = divmod(lane, 4)
        k = 16 * s + 2 * t + 8 * (word % 2) + e
        co = 8 * (2 * h + word // 2) + g
        got[k, co] = frags[s, h, lane, word, e]
        seen[k, co] += 1
    assert (seen == 1).all()
    folded = (w * scale[:, None, None, None]).to(torch.bfloat16).permute(
        2, 3, 1, 0).view(torch.int16).numpy()               # (ky, kx, ci, co)
    order = stem.k_order()
    real = order[:, 0] >= 0
    assert real.sum() == 147 and (~real).sum() == 29
    assert not got[~real].any()
    ky, j = order[real].T
    assert np.array_equal(got[real], folded[ky, j // 3, j % 3])


def test_stem_k_offsets_hit_every_tap_once():
    """The K -> shared offset table: the GEMM rows hold each (ky, kx, ci)
    exactly once, at offset ky * pitch + kx * 3 + ci of the staged
    window; a group of 8 rows is 8 consecutive taps of one kernel row
    from an even offset, so lane t's pair (8 G + 2 t, + 1) is the 32-bit
    word at the group's offset + 2 t."""
    off, order = stem.k_offsets(), stem.k_order()
    pitch = stem.STAGED_ROW_PITCH
    real = off >= 0
    assert off.shape == (16 * stem.K_STEPS,) and real.sum() == 147
    ky, rem = np.divmod(off[real], pitch)
    kx, ci = np.divmod(rem, 3)
    taps = set(zip(ky.tolist(), kx.tolist(), ci.tolist()))
    assert len(taps) == 147 and taps == set(np.ndindex(7, 7, 3))
    assert np.array_equal(order[real, 0], ky)
    groups = off.reshape(-1, 8)
    for grp in groups:
        if grp[0] < 0:
            assert (grp < 0).all()
            continue
        assert grp[0] % 2 == 0
        n = int((grp >= 0).sum())
        assert np.array_equal(grp[:n], grp[0] + np.arange(n))
        assert (grp[n:] < 0).all()


def test_stem_a_loads_fall_on_distinct_banks():
    """The 32 lanes of an A load: rows g are conv columns 4 g (+ d) of
    one conv row, 12 g words apart, and lane t adds 2 t elements to the
    group's offset, so the 32 words fall on 32 banks in every group."""
    off = stem.k_offsets()
    pitch = stem.STAGED_ROW_PITCH
    for G in range(3 * 7):
        for lr, d in np.ndindex(17, 4):
            words = {(2 * lr * pitch + (4 * g + d) * 6 + 2 * t
                      + int(off[8 * G])) // 2 % 32
                     for g in range(8) for t in range(4)}
            assert len(words) == 32


@pytest.mark.parametrize("H,W", [(662, 690), (752, 740), (5, 3), (9, 70),
                                 (67, 131), (130, 2), (17, 9)])
def test_stem_tiles_cover_the_maps_and_their_windows(H, W):
    """The kernel's grid of 8 x 16 pooled tiles, in numpy: the owned conv
    pixels (tile rows and columns 1..) cover the conv map once, every
    pooled pixel once, each pool window and each conv pixel's 7x7 input
    window within the staged tile."""
    (tph, tpw), pitch = stem.POOLED_TILE, stem.STAGED_ROW_PITCH
    tch, tcw = 2 * tph + 1, 2 * tpw + 1
    tih, tiw = 2 * (tch - 1) + 7, 2 * (tcw - 1) + 7
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    conv = np.zeros((Ho, Wo), np.int64)
    pool = np.zeros((Hp, Wp), np.int64)
    for pr0 in range(0, Hp, tph):
        for pc0 in range(0, Wp, tpw):
            cr0, cc0 = 2 * pr0 - 1, 2 * pc0 - 1
            rows = cr0 + np.arange(1, tch)
            cols = cc0 + np.arange(1, tcw)
            conv[np.ix_(rows[rows < Ho], cols[cols < Wo])] += 1
            pr, pc = pr0 + np.arange(tph), pc0 + np.arange(tpw)
            pool[np.ix_(pr[pr < Hp], pc[pc < Wp])] += 1
            # pooled (pr0 + i, pc0 + j) reads tile rows 2i..2i+2, which
            # are conv rows 2 (pr0 + i) - 1 .. + 1: MaxPool2d(3, 2, 1)
            assert 2 * (tph - 1) + 2 < tch and 2 * (tpw - 1) + 2 < tcw
    assert (conv == 1).all() and (pool == 1).all()
    # the M tiles: 0..33 take conv row tile // 2, columns 4 g + 2 half +
    # tile % 2; 34 and 35 the last column (stem.cu:tile_pixel)
    owner = np.zeros((tch, tcw), np.int64)
    for tile, half, g in np.ndindex(36, 2, 8):
        if tile < 2 * tch:
            owner[tile // 2, 4 * g + 2 * half + tile % 2] += 1
        elif 16 * (tile - 2 * tch) + 8 * half + g < tch:
            owner[16 * (tile - 2 * tch) + 8 * half + g, tcw - 1] += 1
    assert (owner == 1).all()
    base = 2 * (tch - 1) * pitch + 2 * (tcw - 1) * 3   # the last pixel
    assert base + stem.k_offsets().max() + 1 < tih * pitch
    assert 2 * (tcw - 1) * 3 + 6 * 3 + 2 < tiw * 3 <= pitch


# ---- the stem's general form (B1, csrc/stem_general.cu): plan and tiles

def _tile_pixel(tile, h, g, tch, s):
    """stem_general.cu:tile_pixel: (lr, lc, valid) of row g + 8 h of M
    tile `tile`."""
    if tile < 2 * tch:
        p = tile & 1
        lc = (4 * g + 2 * h + p if s == 4 else
              2 * g + 16 * h + p if s == 2 else g + 8 * h + 16 * p)
        return tile >> 1, lc, True
    lr = 16 * (tile - 2 * tch) + 8 * h + g
    return lr, 32, lr < tch


def _pixel_slot(lr, lc, tch, s):
    """stem_general.cu:pixel_slot, the inverse of `_tile_pixel`."""
    if lc == 32:
        return (2 * tch + (lr >> 4)) * 16 + (lr & 15)
    if s == 4:
        p, h, g = lc & 1, (lc >> 1) & 1, lc >> 2
    elif s == 2:
        p, g, h = lc & 1, (lc >> 1) & 7, lc >> 4
    else:
        g, h, p = lc & 7, (lc >> 3) & 1, lc >> 4
    return (2 * lr + p) * 16 + 8 * h + g


def _column_stride(cps):
    return 4 if cps % 2 else 2 if cps % 4 else 1


def _swizzle(m, ntp):
    return ((m & 7) >> {8: 0, 4: 1, 2: 2, 1: 3}[ntp]) & (ntp - 1)


def _offsets(k, cin, pool, plan):
    """stem_general.cu's offset table: entry G is 4 x the staged offset
    of group G's first tap from a pixel's base ((G // gr) sp + 8 (G %
    gr)) + its kind (0 whole, 1 a kernel row's tail, masked past k cps
    taps, 2 a padding group, offset 0)."""
    geo = stem.general_geometry(k, cin, pool, *plan[:4])
    G = np.arange(2 * geo.ksc)
    kyl, gi = np.divmod(G, geo.gr)
    tail = (gi == geo.gr - 1) & ((k * geo.cps) % 8 != 0)
    return np.where(G < geo.ng, (kyl * geo.sp + 8 * gi) * 4 + tail, 2)


GENERAL_SHAPES = [(3, 64, 7), (1, 32, 7), (3, 8, 7), (3, 16, 3),
                  (3, 32, 11), (2, 24, 11), (1, 8, 7), (3, 5, 7),
                  (64, 64, 7), (101, 8, 7)]


@pytest.mark.parametrize("cin,cout,k", GENERAL_SHAPES)
def test_stem_general_plan_fits_and_covers_the_tile(cin, cout, k):
    """With and without the pool: the plan's shared memory is its
    geometry's and fits 227 KB (two blocks an SM for the stems of up to
    three channels, which take all of K in one chunk); its warps run
    every M tile, the M tiles cover the conv tile's pixels once and
    `pixel_slot` inverts them; the staged rows hold every A load of
    every pixel, and an A load's 32 lanes fall on 32 banks."""
    for pool in (True, False):
        plan = stem.general_plan(cin, cout, k, pool)
        geo = stem.general_geometry(k, cin, pool, *plan[:4])
        assert plan.smem == geo.total <= stem.GENERAL_SMEM_LIMIT
        assert plan.nt == min(8, -(-cout // 8))
        assert plan.threads == 32 * geo.warps <= stem.GENERAL_MAX_THREADS
        assert geo.warps * geo.ppw * 2 >= geo.nm
        assert geo.ppw == (2 if geo.nchunks == 1 else 1)
        if cin <= 3:
            assert geo.nchunks == 1
            assert plan.smem <= stem.GENERAL_TWO_BLOCKS
        s = _column_stride(geo.cps)
        assert geo.cps % 8 and (s * geo.cps) % 8 == 4
        seen = np.zeros((geo.tch, geo.tcw), np.int64)
        for tile, h, g in np.ndindex(geo.nm, 2, 8):
            lr, lc, ok = _tile_pixel(tile, h, g, geo.tch, s)
            if ok:
                seen[lr, lc] += 1
                assert _pixel_slot(lr, lc, geo.tch, s) == tile * 16 + 8 * h + g
        assert (seen == 1).all()
        tab = _offsets(k, cin, pool, plan)
        last = 2 * (geo.tch - 1) * geo.sp + 2 * (geo.tcw - 1) * geo.cps
        assert last + (tab >> 2).max() + 7 < geo.tih * geo.sp
        assert geo.tiw * geo.cps <= geo.sp and geo.sp % 8 == 0
        assert (tab >> 2).min() % 2 == 0 == (tab >> 2).max() % 2
        for tile, h in np.ndindex(2 * geo.tch, 2):
            banks = set()
            for g, t in np.ndindex(8, 4):
                lr, lc, _ = _tile_pixel(tile, h, g, geo.tch, s)
                el = 2 * lr * geo.sp + 2 * lc * geo.cps + 2 * t
                banks.add(el // 2 % 32)
            assert len(banks) == 32


@pytest.mark.parametrize("cin,k", [(102, 7), (44, 11), (424, 3), (185, 5)])
def test_stem_general_plan_refuses_what_no_plan_fits(cin, k):
    """Wide inputs (Cin 102 at k = 7, 44 at 11, 424 at 3, 185 at 5)
    plan with K streamed over slices of Cin; what no plan fits is a
    kernel of 389 x 389 or more with the pool, 437 x 437 without (one
    kernel row of 4 channels and 64 output channels a chunk outgrow
    227 KB)."""
    for pool, largest in ((True, 387), (False, 435)):
        plan = stem.general_plan(cin, 64, k, pool)
        assert stem.general_geometry(k, cin, pool, *plan[:4]).nchunks > 1
        stem.general_plan(cin, 64, largest, pool)
        with pytest.raises(ValueError, match="shared memory"):
            stem.general_plan(cin, 64, largest + 2, pool)


@pytest.mark.parametrize("cin,cout,k,pool", [
    (3, 64, 7, True), (1, 32, 7, True), (3, 16, 3, False),
    (2, 24, 11, True), (64, 40, 3, True), (101, 8, 7, False),
    (3, 64, 31, True), (16, 20, 5, False)])
def test_stem_general_k_order_covers_every_tap_once(cin, cout, k, pool):
    """The K chunks' GEMM rows hold every (ky, kx, ci) exactly once; the
    packed weights, decoded by the fragment rule (lane 4 g + t, k-step
    s, pair q, word w = 2 nn + r, element e -> GEMM row 16 s + 8 r +
    2 t + e, column 16 q + 8 nn + g), are the folded bf16 weights of
    those taps and zero on every padding row and column; the offset
    table's groups point each tap at its staged element (kernel row ky
    of the chunk, column kx, channel ci of the slice)."""
    plan = stem.general_plan(cin, cout, k, pool)
    geo = stem.general_geometry(k, cin, pool, *plan[:4])
    kmap = stem.general_k_map(k, cin, plan.kyc, plan.cs)
    real = kmap[..., 0] >= 0
    taps = [tuple(v) for v in kmap[real].tolist()]
    assert len(taps) == k * k * cin == len(set(taps))
    rng = np.random.default_rng(cin + cout + k)
    w = torch.from_numpy(rng.standard_normal((cout, cin, k, k)).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    nq = (plan.nt + 1) // 2
    nco = -(-cout // (8 * plan.nt))
    packed = stem.pack_general(w, scale, plan)
    frags = packed.view(torch.int16).numpy().reshape(
        nco, geo.nchunks, geo.ksc, nq, 32, 2, 2, 2)
    got = np.zeros((nco, geo.nchunks, 16 * geo.ksc, 16 * nq), np.int16)
    seen = np.zeros(got.shape, np.int64)
    for idx in np.ndindex(frags.shape):
        n, c, s, q, lane, nn, r, e = idx
        g, t = divmod(lane, 4)
        kk, col = 16 * s + 8 * r + 2 * t + e, 16 * q + 8 * nn + g
        got[n, c, kk, col] = frags[idx]
        seen[n, c, kk, col] += 1
    assert (seen == 1).all()
    folded = (w * scale[:, None, None, None]).to(torch.bfloat16).view(
        torch.int16).numpy()                                 # (co, ci, ky, kx)
    for n in range(nco):
        for col in range(16 * nq):
            co = 8 * plan.nt * n + col
            if col >= 8 * plan.nt or co >= cout:
                assert not got[n, :, :, col].any()
                continue
            ky, kx, ci = kmap[real].T
            assert np.array_equal(got[n, :, :, col][real],
                                  folded[co, ci, ky, kx])
            assert not got[n, :, :, col][~real].any()
    tab = _offsets(k, cin, pool, plan)
    tail = k * geo.cps - 8 * (geo.gr - 1)
    for c, kk in zip(*np.nonzero(real)):
        ky, kx, ci = kmap[c, kk]
        G, e = divmod(int(kk), 8)
        kind = tab[G] & 3
        assert kind == 0 or (kind == 1 and e < tail)
        row, el = divmod(int(tab[G] >> 2) + e, geo.sp)
        assert row == ky - plan.kyc * (c // geo.ncs)
        assert divmod(el, geo.cps) == (kx, ci - plan.cs * (c % geo.ncs))


def _emulate_stem_general(x, weight, scale, bias, slope, clip_max, lead,
                          pool, plan):
    """csrc/stem_general.cu in numpy, block by block, with its index
    math: each K chunk staged (raw rows realigned where the chunk holds
    all of Cin in its own pitch, else element by element) into a buffer
    that starts NaN, the offset table and each lane's pixel base gather
    A (tails and padding groups masked), the packed weights decoded by
    the fragment rule, the accumulators kept over the chunks, products
    summed in f64 (the kernel sums them in f32); the epilogue's bf16
    rounding into the swizzled M-order conv tile (-inf outside the conv
    extent), then the owned conv pixels and the pooled maxima read back
    through the swizzle.  Returns (out, pooled, writes of each out /
    pooled element)."""
    B, H, W, cin = x.shape
    cout, _, k, _ = weight.shape
    geo = stem.general_geometry(k, cin, pool, *plan[:4])
    nt, tile = plan.nt, plan.tile
    nq, ntp = (nt + 1) // 2, 1 << (nt - 1).bit_length()
    nco = -(-cout // (8 * nt))
    frags = stem.pack_general(weight, scale, plan).float().numpy().reshape(
        nco, geo.nchunks, geo.ksc, nq, 8, 4, 2, 2, 2)   # q, g, t, nn, r, e
    bmat = frags.transpose(0, 1, 2, 7, 5, 8, 3, 6, 4).reshape(
        nco, geo.nchunks, 16 * geo.ksc, 16 * nq)[..., :8 * nt]
    bk = np.zeros(nco * 8 * nt)
    bk[:cout] = bias.numpy()
    tab = _offsets(k, cin, pool, plan)
    valid = k * geo.cps - 8 * (geo.gr - 1)
    keep = np.ones((2 * geo.ksc, 8), bool)
    keep[(tab & 3) == 1, valid:] = False
    keep[(tab & 3) == 2] = False
    koff = (tab >> 2)[:, None] + np.arange(8)               # (groups, 8)
    koff, keep = koff.reshape(-1), keep.reshape(-1)
    xs = x.float().numpy()
    flat = xs.reshape(-1)
    Ho, Wo = -(-H // 2), -(-W // 2)
    Hp, Wp = -(-Ho // 2), -(-Wo // 2)
    out = np.zeros((B, Ho, Wo, cout), np.float32)
    pooled = np.zeros((B, Hp, Wp, cout), np.float32)
    n_out, n_pool = np.zeros(out.shape, int), np.zeros(pooled.shape, int)
    s = _column_stride(geo.cps)
    pix = [_tile_pixel(tl, h, g, geo.tch, s)
           for tl in range(geo.nm) for h in range(2) for g in range(8)]
    lr = np.array([min(p[0], geo.tch - 1) for p in pix])
    lc = np.array([p[1] for p in pix])
    ok = np.array([p[2] for p in pix])
    base = 2 * lr * geo.sp + 2 * lc * geo.cps
    r, e = np.divmod(np.arange(geo.tih * geo.sp), geo.sp)
    col, cc = np.divmod(e, geo.cps)
    grid_y = -(-(Hp if pool else Ho) // tile)
    grid_x = -(-(Wp if pool else Wo) // (16 if pool else 32))
    for b, by, bx, n in np.ndindex(B, grid_y, grid_x, nco):
        co0 = 8 * nt * n
        if pool:
            pr0, pc0 = by * tile, bx * 16
            cr0, cc0 = 2 * pr0 - 1, 2 * pc0 - 1
        else:
            cr0, cc0 = by * tile, bx * 32
        ir0, ic0 = 2 * cr0 - lead, 2 * cc0 - lead
        acc = np.zeros((16 * geo.nm, 8 * nt))
        for c in range(geo.nchunks):
            kc, csi = divmod(c, geo.ncs)
            gr = ir0 + kc * plan.kyc + r
            s_in = np.full(geo.tih * geo.sp, np.nan)
            if geo.rawc:
                lo = (b * H + gr) * W * cin
                el = lo + ic0 * cin + e
                inside = (gr >= 0) & (gr < H) & (el >= lo) & (
                    el < lo + W * cin)
                s_in[:] = np.where(inside, flat[np.where(inside, el, 0)], 0)
            else:
                gc, ci = ic0 + col, plan.cs * csi + cc
                inside = ((gr >= 0) & (gr < H) & (col < geo.tiw) & (gc >= 0)
                          & (gc < W) & (cc < plan.cs) & (ci < cin))
                s_in[:] = np.where(inside, xs[b, gr.clip(0, H - 1),
                                              gc.clip(0, W - 1),
                                              ci.clip(0, cin - 1)], 0)
            a = s_in[base[:, None] + koff[None, :]]
            a = np.where(keep[None, :], a, 0.0)
            assert not np.isnan(a).any()            # staged, not stale
            acc += a @ bmat[n, c]
        y = acc + bk[co0:co0 + 8 * nt]
        y = np.maximum(y, slope * y)
        if clip_max is not None:
            y = np.where(y > clip_max, clip_max, y)
        y = torch.from_numpy(y).float().to(torch.bfloat16).float().numpy()
        gr, gc = cr0 + lr, cc0 + lc
        inside = (gr >= 0) & (gr < Ho) & (gc >= 0) & (gc < Wo)
        y[~inside] = -np.inf
        conv = np.full((16 * geo.nm, ntp, 8), np.nan)
        for m in np.flatnonzero(ok):
            for q in range(nt):
                conv[m, q ^ _swizzle(m, ntp)] = y[m, 8 * q:8 * q + 8]

        def read(lr_, lc_):
            m = _pixel_slot(lr_, lc_, geo.tch, s)
            v = np.stack([conv[m, q ^ _swizzle(m, ntp)] for q in range(nt)])
            v = v.reshape(-1)[:min(8 * nt, cout - co0)]
            assert not np.isnan(v).any()
            return v

        sl = slice(co0, co0 + min(8 * nt, cout - co0))
        d = 1 if pool else 0
        for i, j in np.ndindex(2 * tile if pool else tile, 32):
            R, C = cr0 + d + i, cc0 + d + j
            if R < Ho and C < Wo:
                out[b, R, C, sl] = read(d + i, d + j)
                n_out[b, R, C, sl] += 1
        if not pool:
            continue
        for i, j in np.ndindex(tile, 16):
            if pr0 + i < Hp and pc0 + j < Wp:
                win = np.stack([read(2 * i + dy, 2 * j + dx)
                                for dy in range(3) for dx in range(3)])
                pooled[b, pr0 + i, pc0 + j, sl] = win.max(0)
                n_pool[b, pr0 + i, pc0 + j, sl] += 1
    return out, pooled, n_out, n_pool


@pytest.mark.parametrize("cin,cout,k,hw,form", [
    (3, 16, 3, (37, 53), {}), (1, 8, 7, (22, 41), {}),
    (2, 20, 11, (19, 30), {}), (3, 20, 7, (21, 27), dict(pool=False)),
    (3, 40, 5, (13, 9), dict(pool=False, plan=(2, 1, 3))),
    (3, 16, 3, (24, 34), dict(clip_max=6.0, lead=0)),
    (3, 72, 7, (19, 23), dict(lead=2, clip_max=0.3)),
    (12, 13, 3, (11, 37), dict(plan=(1, 1, 8))),
    (9, 24, 5, (14, 20), dict(pool=False, plan=(2, 5, 4)))])
def test_stem_general_emulated_matches_plain(cin, cout, k, hw, form):
    """The emulated kernel writes every conv and pooled element once and
    agrees with `stem_conv_pool_plain` to one bf16 step (they differ only
    in summation order), at ragged extents, Cout not a multiple of 8 or
    wider than one block, without the pool, with a clip and another
    lead, and on forced small tiles and chunked K (plan = (tile, kyc,
    cs))."""
    form = dict(form)
    pool, lead = form.get("pool", True), form.get("lead", (k - 1) // 2)
    clip_max = form.get("clip_max")
    g = torch.Generator().manual_seed(cin * 100 + cout + k)
    x = torch.rand((2,) + hw + (cin,), generator=g).to(torch.bfloat16)
    weight = torch.randn((cout, cin, k, k), generator=g) * (
        2.0 / (cin * k * k)) ** 0.5
    scale = 0.5 + torch.rand(cout, generator=g)
    bias = 0.1 * torch.randn(cout, generator=g)
    plan = stem.general_plan(cin, cout, k, pool)
    if "plan" in form:
        tile, kyc, cs = form["plan"]
        geo = stem.general_geometry(k, cin, pool, tile, kyc, cs, plan.nt)
        plan = stem.GeneralPlan(tile, kyc, cs, plan.nt, 32 * geo.warps,
                                geo.total)
    for slope in (0.2, 0.0, 1.0):
        out, pooled, n_out, n_pool = _emulate_stem_general(
            x, weight, scale, bias, slope, clip_max, lead, pool, plan)
        assert (n_out == 1).all()
        want = stem.stem_conv_pool_plain(x, weight, scale, bias, slope,
                                         pool=pool, clip_max=clip_max,
                                         lead=lead)
        if pool:
            assert (n_pool == 1).all()
        got = (out, pooled) if pool else (out,)
        for a, ref in zip(got, want if pool else (want,)):
            ref = ref.float().numpy()
            assert a.shape == ref.shape
            np.testing.assert_allclose(a, ref, rtol=2 ** -7, atol=1e-4)


# ---- the RoI forward (B2, B3, B6): work table and bin table

def _fwd_block_work(plan, K, block):
    """Block `block`'s work as csrc/roi_pool.cu decodes it: (scale, frame,
    box, first output row, rows)."""
    i = max(j for j, s in enumerate(plan) if s.block0 <= block)
    s = plan[i]
    bk, strip = divmod(block - s.block0, s.strips)
    p0 = strip * s.rows
    return i, bk // K, bk % K, p0, min(s.rows, s.out_h - p0)


def _fwd_slot_table(x1, x2, scale, W, C, vec, out_w):
    """A forward block's shared table of one box as csrc/roi_pool.cu
    fills it: per thread slot of an output row, its column bin [w0, w1)
    and channel offset (edges in f32 without a fused multiply-add)."""
    f = lambda v: int(np.floor(np.float32(np.float32(v) * np.float32(scale))
                               + np.float32(0.5)))
    rs, roi = f(x1), max(f(x2) - f(x1) + 1, 1)
    sw = min(max(rs, 0), W)
    per_pixel = C // vec
    table = []
    for j in range(out_w * per_pixel):
        q, c = divmod(j, per_pixel)
        table.append((min(sw + (q * roi) // out_w, W),
                      min(sw + ((q + 1) * roi + out_w - 1) // out_w, W),
                      c * vec))
    return table


def _pyramid_scales(C, patch, dtype, vec=True):
    sizes = [(int(patch[0] / 2 ** (i + 1)), int(patch[1] / 2 ** (i + 1)))
             for i in range(4)] + [(patch[0] // 32, patch[1] // 32)]
    return [(c, oh, ow, roi_pool.fwd_vec(c, dtype, vec))
            for c, (oh, ow) in zip(C, sizes)]


RC_WIDTHS = (32, 64, 128, 128, 128)


@pytest.mark.parametrize("B,K,patch,dtype,C", [
    (16, 48, (150, 50), torch.bfloat16, RC_WIDTHS),     # fused NTU
    (16, 32, (240, 100), torch.bfloat16, RC_WIDTHS),    # fused ZJU
    (24, 40, (150, 50), torch.float32, RC_WIDTHS),      # training NTU
    (4, 30, (240, 100), torch.float32, RC_WIDTHS),      # training ZJU
    (2, 1, (64, 32), torch.bfloat16, (3,) * 5),         # scalar path, K=1
    (2, 300, (64, 32), torch.float32, (3,) * 5),
    (1, 7, (40, 8), torch.bfloat16, (3000, 8, 16, 5, 24))])  # wide rows
def test_fwd_plan_covers_every_output_row_once(B, K, patch, dtype, C):
    scales = _pyramid_scales(C, patch, dtype)
    plan = roi_pool.fwd_plan(B, K, scales)
    cover = [np.zeros((B, K, max(oh, 0)), np.int64) for _, oh, _, _ in scales]
    blocks = sum(B * K * s.strips for s in plan)
    for blk in range(blocks):
        i, b, k, p0, rows = _fwd_block_work(plan, K, blk)
        assert 1 <= rows <= plan[i].rows <= 2048
        cover[i][b, k, p0:p0 + rows] += 1
    for c, (_, _, ow, _) in zip(cover, scales):
        assert (c == (1 if ow > 0 else 0)).all()     # empty outputs: none
    for s, (c, oh, ow, vec) in zip(plan, scales):
        if ow == 0:
            continue
        assert c % s.vec == 0 and s.slots == ow * (c // s.vec)
        # about FWD_BLOCK_ELEMS elements a block, or the whole patch
        elems = roi_pool.FWD_BLOCK_ELEMS
        assert s.strips == 1 or s.rows * s.slots >= elems // 2
        assert s.rows == 1 or s.rows * s.slots < elems + s.slots


def test_fwd_vec_is_a_16_byte_vector_where_c_allows():
    assert roi_pool.fwd_vec(32, torch.bfloat16) == 8
    assert roi_pool.fwd_vec(12, torch.bfloat16) == 1
    assert roi_pool.fwd_vec(12, torch.float32) == 4
    assert roi_pool.fwd_vec(3, torch.float32) == 1
    assert roi_pool.fwd_vec(64, torch.float32, aligned=False) == 1


@pytest.mark.parametrize("scale,out_w,W,C,vec", [
    (0.5, 25, 345, 32, 8), (1 / 32, 1, 22, 128, 8), (0.25, 12, 173, 64, 4),
    (0.5, 50, 31, 3, 1), (0.125, 6, 9, 128, 4), (0.5, 40, 30, 8, 8)])
def test_fwd_slot_table_matches_bin_bounds(scale, out_w, W, C, vec):
    """The forward block's per-slot column bins equal `ops.patches`'
    bounds and its channel offsets walk the pixel: boxes past either edge
    of the map, on half pixels, and smaller than their output (roi <
    out)."""
    rng = np.random.default_rng(out_w + C)
    n = 64
    x1 = rng.uniform(-0.3, 1.2, n) * W / scale
    x1[::4] = np.floor(x1[::4]) + 0.5
    x1[1] = -50 / scale                                 # left of the map
    x1[2] = (W + 3) / scale                             # right of it
    size = rng.uniform(0.1, 1.5, n) * out_w / scale
    x2 = x1 + size
    r = lambda v: torch.floor(torch.tensor(v, dtype=torch.float32) * scale
                              + 0.5).long()
    lo, hi = patches._bin_bounds(r(x1), r(x2), W, out_w)
    per_pixel = C // vec
    for i in range(n):
        table = _fwd_slot_table(float(np.float32(x1[i])),
                                float(np.float32(x2[i])), scale, W, C, vec,
                                out_w)
        assert len(table) == out_w * per_pixel
        for j, (w0, w1, c0) in enumerate(table):
            q = j // per_pixel
            assert (w0, w1) == (int(lo[i, q]), int(hi[i, q]))
            assert c0 == (j % per_pixel) * vec


# ---- compose (B4): each tile's culled point list

def _compose_points(geometry, rng):
    """(points (B, K, 3) in padded coordinates, frame, patch): the fused
    path's NTU and ZJU buckets (real points at pixels, the masked slots
    at the origin as the path zeroes them), the card test's K = 300 with
    points off the frame and on half pixels, and every real point of a
    frame within 3 pixels of one spot."""
    frame, patch, B, K, real = {
        "ntu": ((512, 640), (150, 50), 2, 48, 40),
        "zju": ((512, 640), (240, 100), 2, 32, 30),
        "k300": ((45, 70), (30, 12), 3, 300, 300),
        "clustered": ((512, 640), (150, 50), 2, 48, 40)}[geometry]
    (H, W), (ph, pw) = frame, patch
    if geometry == "k300":
        u = rng.random((B, K)) * (W + 2 * pw) - pw // 2
        v = rng.random((B, K)) * (H + 2 * ph) - ph // 2
        u[:, ::3] = np.floor(u[:, ::3]) + 0.5
    elif geometry == "clustered":
        spot = rng.random((B, 1, 2)) * [W + pw, H + ph]
        u, v = np.moveaxis(spot + rng.uniform(-3, 3, (B, K, 2)), -1, 0)
    else:
        u = rng.integers(0, W, (B, K)) + pw // 2
        v = rng.integers(0, H, (B, K)) + ph // 2
    pts = np.stack([u, v, 1 + 50 * rng.random((B, K))], -1)
    pts[:, real:] = 0.0
    return torch.from_numpy(pts.astype(np.float32)), frame, patch


def _covered(points, frame, patch):
    """(B, K, H, W): the output pixels inside each point's patch window,
    its origin rounded half to even and clipped to the padded frame."""
    (H, W), (ph, pw) = frame, patch
    pts = points.numpy().astype(np.float64)
    y0 = np.clip(np.rint(pts[..., 1]).astype(np.int64) - ph // 2, 0,
                 H + 2 * (ph // 2) - ph)
    x0 = np.clip(np.rint(pts[..., 0]).astype(np.int64) - pw // 2, 0,
                 W + 2 * (pw // 2) - pw)
    ys = np.arange(H) + ph // 2
    xs = np.arange(W) + pw // 2
    rows = (ys >= y0[..., None]) & (ys < y0[..., None] + ph)
    cols = (xs >= x0[..., None]) & (xs < x0[..., None] + pw)
    return rows[..., :, None] & cols[..., None, :]


COMPOSE_GEOMETRIES = ["ntu", "zju", "k300", "clustered"]


@pytest.mark.parametrize("geometry", COMPOSE_GEOMETRIES)
def test_tile_points_match_brute_force(geometry):
    """Each tile's list is the k whose patch covers one of its pixels,
    in ascending order, then -1; the counts match."""
    points, frame, patch = _compose_points(geometry,
                                           np.random.default_rng(6))
    (H, W), (th, tw) = frame, compose.TILE
    lists, counts = compose.tile_points(points, frame, patch)
    cover = _covered(points, frame, patch)
    B, K = points.shape[:2]
    assert lists.shape == (B, -(-H // th), -(-W // tw), K)
    for b, i, j in np.ndindex(*lists.shape[:3]):
        want = [k for k in range(K)
                if cover[b, k, i * th:(i + 1) * th, j * tw:(j + 1) * tw].any()]
        got = lists[b, i, j].tolist()
        assert got == want + [-1] * (K - len(want))
        assert int(counts[b, i, j]) == len(want)


@pytest.mark.parametrize("geometry", COMPOSE_GEOMETRIES)
def test_tile_lists_hold_every_covering_point(geometry):
    """Every (pixel, k) with the pixel inside k's window has k in the
    list of the pixel's tile, and no tile lists more than K points."""
    points, frame, patch = _compose_points(geometry,
                                           np.random.default_rng(7))
    th, tw = compose.TILE
    lists, counts = compose.tile_points(points, frame, patch)
    cover = _covered(points, frame, patch)
    listed = np.zeros(lists.shape, bool)         # (B, TY, TX, K) by k
    b, i, j, slot = np.nonzero(lists.numpy() >= 0)
    listed[b, i, j, lists.numpy()[b, i, j, slot]] = True
    b, k, y, x = np.nonzero(cover)
    assert listed[b, y // th, x // tw, k].all()
    if geometry == "clustered":      # 40 real points in one spot's tiles
        assert int(counts.max()) >= 40


@pytest.mark.parametrize("geometry", ["k300", "clustered_small"])
def test_compose_over_tile_lists_equals_plain(geometry):
    """The kernel's gather in torch: each tile composed from its listed
    points alone (the others' masks 0: a point that covers none of the
    tile's pixels adds nothing to them) equals the plain composition of
    all points, bit for bit."""
    rng = np.random.default_rng(8)
    if geometry == "k300":
        points, frame, patch = _compose_points("k300", rng)
    else:
        frame, patch = (40, 300), (20, 10)
        spot = rng.random((2, 1, 2)) * [310, 60]
        uv = spot + rng.uniform(-3, 3, (2, 24, 2))
        z = 1 + 50 * rng.random((2, 24, 1))
        points = torch.from_numpy(np.concatenate([uv, z], -1).astype(
            np.float32))
    B, K = points.shape[:2]
    (H, W), (ph, pw), (th, tw) = frame, patch, compose.TILE
    resp = torch.from_numpy(rng.random((B, K, ph, pw)).astype(np.float32))
    mask = torch.from_numpy((rng.random((B, K)) > 0.2).astype(np.float32))
    thr = torch.tensor([0.3, -0.2, 0.6][:B])
    want = patches.compose_patches(resp, points, mask, frame, patch, thr)
    lists, _ = compose.tile_points(points, frame, patch)
    for i, j in np.ndindex(*lists.shape[1:3]):
        keep = torch.zeros((B, K))
        for b in range(B):
            ks = lists[b, i, j]
            keep[b, ks[ks >= 0]] = 1.0
        got = patches.compose_patches(resp, points, mask * keep, frame,
                                      patch, thr)
        tile = (slice(None), slice(i * th, (i + 1) * th),
                slice(j * tw, (j + 1) * tw))
        for g, w in zip(got, want):
            assert torch.equal(g[tile], w[tile])
