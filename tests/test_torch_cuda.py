"""The CUDA kernels against their plain PyTorch versions on the card, at
small and awkward shapes (ragged tiles, boxes past the map, fractional
and half-pixel coordinates, long point lists, tied maxima).
`chip_smoke.py` covers the fused and training paths' own shapes.  These
tests need a card: the `dev` fixture skips them without one.  Run them
on the card with

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX, which the machine with
the card need not have.)
"""

import copy
import math
from collections import Counter

import pytest
import torch

from riders_tpu_torch.models import dpt, lane_decode
from riders_tpu_torch.models.lane_decode import DECODES
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import (LAUNCHES, attention, compose,
                                          lane_decoder, roi_pool, stem)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("hw", [(17, 9), (37, 53), (64, 64), (130, 202),
                                (5, 3), (9, 70), (67, 131), (130, 2)])
def test_stem_kernel_matches_plain(dev, hw):
    """Within one bf16 rounding step: both sum the same bf16 products in
    f32, in different orders.  Extents that are not multiples of the
    kernel's 8 x 16 pooled tile, and maps narrower than one tile."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((2,) + hw + (3,), generator=g, device=dev).to(
        torch.bfloat16)
    w = 0.2 * torch.randn((32, 3, 7, 7), generator=g, device=dev)
    scale = 0.5 + torch.rand(32, generator=g, device=dev)
    bias = 0.1 * torch.randn(32, generator=g, device=dev)
    before = LAUNCHES["stem"]
    got = stem.stem_conv_pool(x, w, scale, bias)
    assert LAUNCHES["stem"] == before + 1
    want = stem.stem_conv_pool_plain(x, w, scale, bias)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        a, b = a.float(), b.float()
        limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
        assert bool(((a - b).abs() <= limit).all())


@pytest.mark.parametrize("slope", [0.0, 1.0], ids=["relu", "linear"])
@pytest.mark.parametrize("hw", [(37, 53), (130, 202), (9, 70)])
def test_stem_kernel_slopes_match_plain(dev, hw, slope):
    """relu (slope 0) and linear (slope 1) within one bf16 step of the
    plain version; slope 0.2 given explicitly is the default call, bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((2,) + hw + (3,), generator=g, device=dev).to(
        torch.bfloat16)
    w = 0.2 * torch.randn((32, 3, 7, 7), generator=g, device=dev)
    scale = 0.5 + torch.rand(32, generator=g, device=dev)
    bias = 0.1 * torch.randn(32, generator=g, device=dev)
    got = stem.stem_conv_pool(x, w, scale, bias, slope)
    want = stem.stem_conv_pool_plain(x, w, scale, bias, slope)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        a, b = a.float(), b.float()
        limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
        assert bool(((a - b).abs() <= limit).all())
    if slope == 0.0:
        assert float(got[0].float().min()) >= 0.0
    else:
        assert float(got[0].float().min()) < 0.0
    for a, b in zip(stem.stem_conv_pool(x, w, scale, bias, 0.2),
                    stem.stem_conv_pool(x, w, scale, bias)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cin,cout,k", [
    (3, 64, 7), (1, 32, 7), (3, 8, 7), (3, 16, 3), (3, 32, 11),
    (2, 24, 11), (3, 5, 7), (64, 40, 3), (8, 64, 7), (20, 72, 5)])
@pytest.mark.parametrize("hw", [(37, 53), (9, 70), (130, 2)])
def test_stem_general_kernel_matches_plain(dev, hw, cin, cout, k):
    """Every shape but (7, 3, 32) goes to the general kernel, within one
    bf16 step of the plain version at each slope: ragged tiles, Cout not
    a multiple of 8, a chunked Cout, plans with a smaller tile and K in
    Cin slices staged by 8-byte copies (Cin 64, 8 and 20)."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + k)
    x = torch.rand((2,) + hw + (cin,), generator=g, device=dev).to(
        torch.bfloat16)
    w = torch.randn((cout, cin, k, k), generator=g, device=dev) * (
        2.0 / (cin * k * k)) ** 0.5
    scale = 0.5 + torch.rand(cout, generator=g, device=dev)
    bias = 0.1 * torch.randn(cout, generator=g, device=dev)
    for slope in (0.2, 0.0, 1.0):
        before = dict(LAUNCHES)
        got = stem.stem_conv_pool(x, w, scale, bias, slope)
        assert LAUNCHES["stem_general"] == before.get("stem_general",
                                                      0) + 1
        assert LAUNCHES["stem"] == before.get("stem", 0)
        want = stem.stem_conv_pool_plain(x, w, scale, bias, slope)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.is_contiguous()
            a, b = a.float(), b.float()
            limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
            assert bool(((a - b).abs() <= limit).all())


def test_stem_general_kernel_refuses_a_shape_no_plan_fits(dev):
    """Cin 102 at k = 7 plans with K streamed over slices of Cin and
    agrees with the plain version; a 389 x 389 kernel over 8 channels
    finds no plan."""
    g = torch.Generator(device=dev).manual_seed(102)
    x = torch.rand((1, 20, 20, 102), generator=g, device=dev).to(
        torch.bfloat16)
    w = torch.randn((8, 102, 7, 7), generator=g, device=dev) / 60.0
    one, zero = torch.ones(8, device=dev), torch.zeros(8, device=dev)
    for a, b in zip(stem.stem_conv_pool(x, w, one, zero),
                    stem.stem_conv_pool_plain(x, w, one, zero)):
        a, b = a.float(), b.float()
        limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
        assert bool(((a - b).abs() <= limit).all())
    x = torch.rand((1, 20, 20, 8), device=dev).to(torch.bfloat16)
    w = torch.randn((64, 8, 389, 389), device=dev)
    one, zero = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        stem.stem_conv_pool(x, w, one, zero)


STEM_FORMS = [
    (3, 64, 7, dict(pool=False)), (3, 16, 3, dict(clip_max=6.0, lead=0)),
    (3, 16, 3, dict(pool=False, clip_max=6.0, lead=0)),
    (3, 32, 7, dict(pool=False)), (3, 32, 7, dict(clip_max=0.5)),
    (3, 32, 7, dict(lead=2)), (1, 8, 7, dict(pool=False, lead=0)),
    (3, 32, 11, dict(pool=False, clip_max=0.4)), (64, 72, 3,
                                                  dict(pool=False)),
    (3, 20, 5, dict(lead=0))]


@pytest.mark.parametrize("cin,cout,k,form", STEM_FORMS)
@pytest.mark.parametrize("hw", [(37, 53), (130, 202), (9, 70)])
def test_stem_general_forms_match_plain(dev, hw, cin, cout, k, form):
    """pool=False, a clip and another lead go to the general kernel
    whatever the shape ((3, 32, 7) included), one `stem_general` launch
    a call, within one bf16 step of the plain version at each slope; a
    clip of 6 with slope 0 is relu6."""
    g = torch.Generator(device=dev).manual_seed(cin + cout + k)
    x = torch.rand((2,) + hw + (cin,), generator=g, device=dev).to(
        torch.bfloat16)
    w = torch.randn((cout, cin, k, k), generator=g, device=dev) * (
        4.0 / (cin * k * k)) ** 0.5
    scale = 0.5 + torch.rand(cout, generator=g, device=dev)
    bias = torch.randn(cout, generator=g, device=dev)
    for slope in (0.2, 0.0, 1.0):
        before = dict(LAUNCHES)
        got = stem.stem_conv_pool(x, w, scale, bias, slope, **form)
        assert LAUNCHES["stem_general"] == before.get("stem_general",
                                                      0) + 1
        assert LAUNCHES["stem"] == before.get("stem", 0)
        want = stem.stem_conv_pool_plain(x, w, scale, bias, slope, **form)
        if not form.get("pool", True):
            got, want = (got,), (want,)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.is_contiguous()
            a, b = a.float(), b.float()
            limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
            assert bool(((a - b).abs() <= limit).all())
            if "clip_max" in form:       # the clip as bf16 rounds it
                assert float(a.max()) <= float(torch.tensor(
                    form["clip_max"]).to(torch.bfloat16))


def test_fused_stem_keeps_its_packed_weights(dev):
    """bf16 eval: the packed weights are made once and kept while the
    parameters and statistics stay, made anew after an in-place change
    (the BN's running mean), for both kernels; fuse_pool=False returns
    the conv map alone on the general kernel."""
    from riders_tpu_torch.models.layers import FusedStemConv, init_random_
    x = torch.rand((2, 30, 44, 3), device=dev).to(torch.bfloat16)
    for cout, pool in ((32, True), (16, True), (32, False)):
        mod = init_random_(FusedStemConv(3, cout, fuse_pool=pool)).to(
            dev, torch.bfloat16).eval()
        with torch.no_grad():
            first = mod(x)
            packed = mod._packed["stem"]
            again = mod(x)
            assert mod._packed["stem"] is packed
            mod.bn.running_mean.add_(0.5)
            moved = mod(x)
            assert mod._packed["stem"] is not packed
        first = first if pool else (first,)
        again = again if pool else (again,)
        moved = moved if pool else (moved,)
        assert first[0].shape == (2, cout, 15, 22)
        for a, b, c in zip(first, again, moved):
            assert torch.equal(a, b) and not torch.equal(a, c)


def test_fused_stem_routes_kernel_sizes_as_jax(dev):
    """bf16 eval: k % 4 == 3 on a hand-written kernel, k = 5 on the
    library conv (no launch), as JAX's Pallas condition routes."""
    from riders_tpu_torch.models.layers import FusedStemConv, init_random_
    x = torch.rand((2, 30, 44, 3), device=dev).to(torch.bfloat16)
    for k, kind in ((3, "stem_general"), (5, None), (7, "stem"),
                    (11, "stem_general")):
        mod = init_random_(FusedStemConv(3, 32, kernel_size=k,
                                                 fuse_pool=True)).to(
            dev, torch.bfloat16).eval()
        before = dict(LAUNCHES)
        with torch.no_grad():
            h, p = mod(x)
        launched = {n: LAUNCHES[n] - before.get(n, 0)
                    for n in ("stem", "stem_general")}
        assert launched == {n: int(n == kind) for n in launched}
        assert h.shape == (2, 32, 15, 22) and p.shape == (2, 32, 8, 11)


def test_stem_without_batch_norm_runs_the_kernels(dev):
    """A BN-free bf16 eval FusedStemConv: the (7, 3, 32) stem on the
    tuned kernel, a 16-wide or one-channel stem on the general one, each
    equal to the plain version on scale 1 and bias 0."""
    from riders_tpu_torch.models.layers import FusedStemConv, init_random_
    g = torch.Generator(device=dev).manual_seed(9)
    for cin, cout, kind in ((3, 32, "stem"), (3, 16, "stem_general"),
                            (1, 32, "stem_general")):
        mod = init_random_(FusedStemConv(cin, cout, use_batch_norm=False,
                                                  fuse_pool=True))
        mod = mod.to(dev, torch.bfloat16).eval()
        x = torch.rand((2, 40, 56, cin), generator=g, device=dev).to(
            torch.bfloat16)
        before = LAUNCHES[kind]
        with torch.no_grad():
            h, p = mod(x)
        assert LAUNCHES[kind] == before + 1 and mod.bn is None
        one = torch.ones(cout, device=dev)
        want = stem.stem_conv_pool_plain(x, mod.conv.weight, one, 0 * one,
                                         0.2)
        for a, b in zip((h, p), want):
            a, b = a.permute(0, 2, 3, 1).float(), b.float()
            limit = 2 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-4
            assert bool(((a - b).abs() <= limit).all())


def _boxes(g, dev, B, K, H, W, scale, out_size):
    """Fractional boxes of the pool's patch size around and past the map:
    box 0 at the origin, box 1 entirely outside, box 2 on a half pixel."""
    ph, pw = out_size[0] / scale, out_size[1] / scale
    x1 = (torch.rand((B, K), generator=g, device=dev) * 1.4 - 0.2) * W / scale
    y1 = (torch.rand((B, K), generator=g, device=dev) * 1.4 - 0.2) * H / scale
    x1[:, 0], y1[:, 0] = 0.0, 0.0
    x1[:, 1:2], y1[:, 1:2] = W / scale + 5, H / scale + 5
    x1[:, 2:3] = torch.floor(x1[:, 2:3]) + 0.5
    return torch.stack([x1, y1, x1 + pw, y1 + ph], -1).contiguous()


@pytest.mark.parametrize("dtype,counter", [
    (torch.bfloat16, "roi_pool"), (torch.float32, "roi_pool_f32")])
@pytest.mark.parametrize("C,out_size,scale", [
    (3, (7, 3), 1 / 32), (32, (37, 12), 0.25), (128, (18, 6), 0.125),
    (8, (60, 25), 0.5)])
def test_roi_pool_kernel_matches_plain(dev, C, out_size, scale, dtype,
                                       counter):
    """Bitwise, bf16 (inference) and f32 (the training forward):
    fractional, negative and out-of-map boxes included."""
    g = torch.Generator(device=dev).manual_seed(1)
    B, K, H, W = 2, 9, 23, 31
    feat = torch.randn((B, H, W, C), generator=g, device=dev).to(dtype)
    boxes = _boxes(g, dev, B, K, H, W, scale, out_size)
    before = LAUNCHES[counter]
    got = roi_pool.roi_max_pool(feat, boxes, scale, out_size)
    assert LAUNCHES[counter] == before + 1
    want = patches.roi_max_pool(feat, boxes, scale, out_size)
    assert got.shape == want.shape == (B, K) + out_size + (C,)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert not bool(got[:, 1].any())          # empty bins are 0


@pytest.mark.parametrize("dtype,counter", [
    (torch.bfloat16, "roi_pool"), (torch.float32, "roi_pool_f32")])
@pytest.mark.parametrize("C", [3, 32, 64, 128])
@pytest.mark.parametrize("K", [1, 300])
def test_roi_pool_pyramid_is_one_launch(dev, dtype, counter, C, K):
    """The whole pyramid (four skips and the latent) in one launch, each
    scale bitwise equal to the plain pool: 16-byte vectors where C
    allows (C = 3 takes the scalar path), K from 1 to 300 boxes."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, patch, hw = 2, (64, 32), (80, 56)
    maps = [torch.randn((B, -(-hw[0] // 2 ** (i + 1)),
                         -(-hw[1] // 2 ** (i + 1)), C), generator=g,
                        device=dev).to(dtype) for i in range(5)]
    boxes = _boxes(g, dev, B, K, hw[0] // 2, hw[1] // 2, 0.5,
                   (patch[0] // 2, patch[1] // 2))
    before = LAUNCHES[counter]
    lat, skips = roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes, patch)
    assert LAUNCHES[counter] == before + 1
    want_lat, want_skips = patches.roi_pool_pyramid(maps[-1], maps[:-1],
                                                    boxes, patch)
    for a, b in zip([lat] + skips, [want_lat] + want_skips):
        assert a.shape == b.shape and a.dtype == dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_pool_pyramid_4d_is_one_launch(dev, dtype):
    """B6: skip1 a NEG canvas far wider than its true extent, the rest
    plain maps, all five scales in one launch, bitwise equal to the plain
    pyramid on the true extent."""
    g = torch.Generator(device=dev).manual_seed(8)
    B, K, patch, (H, W) = 2, 40, (150, 50), (100, 75)
    widths = (32, 64, 128, 128, 128)
    maps = [torch.randn((B, -(-H // 2 ** i), -(-W // 2 ** i), c),
                        generator=g, device=dev).to(dtype)
            for i, c in enumerate(widths)]
    canvas = torch.full((B, H + 96, W + 200, 32), roi_pool.NEG, dtype=dtype,
                        device=dev)
    canvas[:, :H, :W] = maps[0]
    boxes = _boxes(g, dev, B, K, H, W, 0.5, (75, 25))
    before = LAUNCHES["roi_pool_4d"]
    lat, skips = roi_pool.roi_pool_pyramid_4d(maps[-1], [canvas] + maps[1:-1],
                                              boxes, patch, (H, W))
    assert LAUNCHES["roi_pool_4d"] == before + 1
    want_lat, want_skips = patches.roi_pool_pyramid(maps[-1], maps[:-1],
                                                    boxes, patch)
    for a, b in zip([lat] + skips, [want_lat] + want_skips):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("C,out_size,scale,K,ties,hw", [
    (3, (7, 3), 1 / 32, 9, False, (23, 31)),
    (32, (37, 12), 0.25, 9, False, (23, 31)),
    (128, (18, 6), 0.125, 9, True, (23, 31)),
    (8, (60, 25), 0.5, 9, True, (23, 31)),
    (5, (9, 4), 0.25, 300, False, (23, 31)),
    (16, (12, 5), 0.5, 300, True, (23, 31)),
    (32, (6, 4), 0.5, 1, False, (70, 90)),       # K=1: most tiles boxless
    (64, (9, 5), 0.25, 9, False, (61, 47)),      # tiles past the map edge
    (32, (12, 5), 0.5, 9, True, (45, 70)),       # float4 path, exact ties
    (128, (4, 1), 1 / 32, 40, True, (21, 22)),   # NTU latent, ties
    (12, (5, 3), 0.25, 2048, False, (19, 27))])  # K at the wrapper's limit
def test_roi_backward_kernel_matches_plain(dev, C, out_size, scale, K,
                                           ties, hw):
    """Against the plain backward in f64: the kernel sums each element's
    contributions in f64 and rounds once, so it is within 1e-6 |p| + 1e-6
    of the plain sum p (half an f32 ulp, in fact).  Two launches are
    bitwise equal.  Integer features tie inside bins, where every tied
    element gets the full cotangent; ragged widths, tiles that no box
    meets, boxes past the map, K from 1 to the wrapper's limit."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, (H, W) = 2, hw
    feat = torch.randn((B, H, W, C), generator=g, device=dev)
    if ties:
        feat = torch.round(2 * feat)
    boxes = _boxes(g, dev, B, K, H, W, scale, out_size)
    pooled = roi_pool.roi_max_pool(feat, boxes, scale, out_size)
    grad = torch.randn(pooled.shape, generator=g, device=dev)
    before = LAUNCHES["roi_pool_bwd"]
    got = roi_pool.roi_max_pool_backward(feat, boxes, pooled, grad, scale)
    again = roi_pool.roi_max_pool_backward(feat, boxes, pooled, grad, scale)
    assert LAUNCHES["roi_pool_bwd"] == before + 2
    assert got.shape == feat.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = patches.roi_max_pool_backward(feat, boxes, pooled, grad.double(),
                                         scale)
    assert bool(((got.double() - want).abs()
                 <= 1e-6 * want.abs() + 1e-6).all())


def test_roi_pool_autograd_on_card(dev):
    """The pyramid under autograd launches the backward kernel once per
    scale and gives the plain backward's gradient."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, K, patch = 2, 5, (64, 32)
    maps = [torch.randn((B, 40 // 2 ** i, 28 // 2 ** i, 8), generator=g,
                        device=dev, requires_grad=True) for i in range(5)]
    boxes = _boxes(g, dev, B, K, 80, 56, 1.0, patch)
    before = LAUNCHES["roi_pool_bwd"]
    lat, skips = roi_pool.roi_pool_pyramid(maps[-1], maps[:-1], boxes, patch)
    outs = [lat] + skips
    ws = [torch.randn(o.shape, generator=g, device=dev) for o in outs]
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    assert LAUNCHES["roi_pool_bwd"] == before + 5
    for i, (o, w) in enumerate(zip(outs, ws)):
        m = maps[-1] if i == 0 else maps[i - 1]
        s = 1 / 32 if i == 0 else 1 / 2 ** i
        want = patches.roi_max_pool_backward(m.detach(), boxes, o.detach(),
                                             w.double(), s)
        assert bool(((m.grad.double() - want).abs()
                     <= 1e-6 * want.abs() + 1e-6).all())


@pytest.mark.parametrize("K", [1, 7, 300])
def test_compose_kernel_matches_plain(dev, K):
    """Bitwise: half-pixel centres (round half to even), points outside
    the frame (clipped), masked points, a negative threshold."""
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, W, ph, pw = 3, 45, 70, 30, 12
    resp = torch.rand((B, K, ph, pw), generator=g, device=dev)
    u = torch.rand((B, K), generator=g, device=dev) * (W + 2 * pw) - pw // 2
    v = torch.rand((B, K), generator=g, device=dev) * (H + 2 * ph) - ph // 2
    u[:, ::3] = torch.floor(u[:, ::3]) + 0.5
    z = 1 + 50 * torch.rand((B, K), generator=g, device=dev)
    pts = torch.stack([u, v, z], -1).contiguous()
    mask = (torch.rand((B, K), generator=g, device=dev) > 0.3).float()
    thr = torch.tensor([0.4, -0.3, 0.9], device=dev)
    before = LAUNCHES["compose"]
    got = compose.compose_patches(resp, pts, mask, (H, W), (ph, pw), thr)
    assert LAUNCHES["compose"] == before + 1
    want = patches.compose_patches(resp, pts, mask, (H, W), (ph, pw), thr)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    scalar = compose.compose_patches(resp, pts, mask, (H, W), (ph, pw), 0.5)
    ref = patches.compose_patches(resp, pts, mask, (H, W), (ph, pw), 0.5)
    assert all(torch.equal(a, b) for a, b in zip(scalar, ref))


@pytest.mark.parametrize("K,frame,patch", [
    (48, (512, 640), (150, 50)), (300, (45, 70), (30, 12)),
    (300, (200, 700), (24, 10))])
def test_compose_kernel_clustered_points_match_plain(dev, K, frame, patch):
    """Bitwise with every point of a frame within 3 pixels of one spot,
    so the tiles there list all K (the longest culled lists), masked
    points at the origin; a frame whose width is not a multiple of 4
    takes the scalar stores."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, (H, W), (ph, pw) = 2, frame, patch
    spot = torch.rand((B, 1, 2), generator=g, device=dev) * torch.tensor(
        [W + pw, H + ph], device=dev)
    uv = spot + 3 * (2 * torch.rand((B, K, 2), generator=g, device=dev) - 1)
    z = 1 + 50 * torch.rand((B, K, 1), generator=g, device=dev)
    mask = (torch.rand((B, K), generator=g, device=dev) > 0.2).float()
    pts = (torch.cat([uv, z], -1) * mask[..., None]).contiguous()
    resp = torch.rand((B, K, ph, pw), generator=g, device=dev)
    thr = torch.tensor([0.2, -0.1], device=dev)
    for W_ in (W, W - 3):
        got = compose.compose_patches(resp, pts, mask, (H, W_), (ph, pw),
                                      thr)
        want = patches.compose_patches(resp, pts, mask, (H, W_), (ph, pw),
                                       thr)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.rand((1, 20, 20, 3), device=dev)
    w = torch.randn((32, 3, 7, 7), device=dev)
    one, zero = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(TypeError):
        stem.stem_conv_pool(x, w, one, zero)               # f32 image
    xb = torch.rand((1, 3, 20, 20), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        stem.stem_conv_pool(xb.permute(0, 2, 3, 1), w, one, zero)
    with pytest.raises(ValueError):
        stem.stem_conv_pool(x.to(torch.bfloat16), w.cpu(), one, zero)
    feat = torch.rand((1, 8, 8, 4), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):
        roi_pool.roi_max_pool(feat, torch.zeros((1, 2, 4)), 0.5, (2, 2))
    with pytest.raises(TypeError):
        roi_pool.roi_max_pool(feat.half(), torch.zeros((1, 2, 4),
                              device=dev), 0.5, (2, 2))
    boxes = torch.zeros((1, 2, 4), device=dev)
    pooled = torch.zeros((1, 2, 2, 2, 4), device=dev)
    with pytest.raises(TypeError):                          # bf16 backward
        roi_pool.roi_max_pool_backward(feat, boxes, pooled.bfloat16(),
                                       pooled.bfloat16(), 0.5)
    with pytest.raises(ValueError):                         # grad shape
        roi_pool.roi_max_pool_backward(feat.float(), boxes, pooled,
                                       pooled[:, :1].contiguous(), 0.5)
    resp = torch.rand((1, 2, 4, 4), device=dev)
    with pytest.raises(TypeError):
        compose.compose_patches(resp.double(), torch.zeros((1, 2, 3),
                                device=dev, dtype=torch.float64),
                                torch.ones((1, 2), device=dev), (8, 8),
                                (4, 4), 0.1)


def _lane_within_one_step(got, want):
    """B7 / B8 against their plain versions: one bf16 rounding step,
    |k - p| <= 2^-7 |p| + 1e-3 max|p| (same bf16 products, f32 sums in
    another order)."""
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    a, b = got.float(), want.float()
    bar = 2 ** -7 * b.abs() + 1e-3 * b.abs().max()
    assert bool(((a - b).abs() <= bar).all()), float((a - b).abs().max())


@pytest.mark.parametrize("N,H,W,cis,co,act", [
    (3, 9, 3, (256, 128), 256, True),    # NTU deconv4 fusion, 3 patches
    (5, 7, 5, (24, 40), 33, True),       # Ci % 16 != 0, Co past a tile
    (2, 11, 4, (13, 6), 20, True),       # Ci % 8 != 0: scalar loads
    (7, 10, 6, (64,), 4, False),         # the output conv: linear, Co 4
    (1, 1, 1, (32,), 16, True),          # a 1x1 map: every tap but one out
    (3, 75, 25, (32, 32), 32, True),     # NTU deconv1 fusion
    (5, 13, 7, (32,), 32, True),         # W + 2 = 9 divides no block run
    (1, 75, 25, (64,), 64, True),        # a single patch over many blocks
    (1, 9, 3, (256, 128), 256, True),    # N = 1: one block, bm cut to 32
    (4, 75, 25, (64,), 4, False),        # Co = 4: the 8-column tile
    (3, 9, 3, (12,), 8, True),           # Ci % 8 != 0 at Co = 8
    (4, 18, 6, (128, 64), 128, True),    # two inputs of unequal width
    (300, 1, 1, (64,), 256, True),       # 1x1 maps, two column tiles
    (300, 1, 1, (32,), 32, True),        # 1x1 maps: the halo cuts bm
    (1, 3, 300, (32,), 64, True),        # a wide map
    (40, 75, 25, (32, 32), 32, True),    # resident: several tiles a block
    (6, 20, 10, (32,), 128, True),       # resident: two column tiles
    (37, 75, 25, (64,), 4, False)])      # resident Co 4, a partial tile
def test_lane_conv3x3_kernel_matches_plain(dev, N, H, W, cis, co, act):
    g = torch.Generator(device=dev).manual_seed(11)
    xs = [torch.randn((N, H, W, c), generator=g, device=dev).to(
        torch.bfloat16) for c in cis]
    k = 0.1 * torch.randn((3, 3, sum(cis), co), generator=g, device=dev)
    ws = [lane_decoder.pack_conv(k[:, :, sum(cis[:i]):sum(cis[:i + 1])])
          for i in range(len(cis))]
    scale, bias = ((0.5 + torch.rand(co, generator=g, device=dev),
                    0.1 * torch.randn(co, generator=g, device=dev))
                   if act else (None, None))
    slope = 0.2 if act else None
    before = LAUNCHES["lane_conv3x3"]
    got = lane_decoder.lane_conv3x3(xs, ws, scale, bias, slope)
    assert LAUNCHES["lane_conv3x3"] == before + 1
    want = lane_decoder.lane_conv3x3_plain(xs, ws, scale, bias, slope)
    _lane_within_one_step(got, want)


@pytest.mark.parametrize("N,h,w,ci,f", [
    (3, 9, 3, 256, 128),                 # NTU deconv3
    (2, 5, 3, 24, 16),                   # odd extent
    (3, 4, 7, 40, 12),                   # F = 12: 16-byte runs split
    (2, 3, 2, 12, 32),                   # Ci % 8 != 0: scalar loads
    (1, 60, 25, 64, 32),                 # ZJU deconv1
    (4, 15, 6, 256, 128),                # ZJU deconv3
    (2, 7, 5, 16, 8),                    # F = 8, Ci = 16: one chunk
    (2, 6, 4, 64, 72),                   # F = 72: a partial column tile
    (2, 9, 3, 256, 32)])                 # F = 32, weights too big to keep
def test_lane_upconv2x_kernel_matches_plain(dev, N, h, w, ci, f):
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((N, h, w, ci), generator=g, device=dev).to(torch.bfloat16)
    k = 0.1 * torch.randn((3, 3, ci, f), generator=g, device=dev)
    wp = lane_decoder.pack_upconv(k)
    scale = 0.5 + torch.rand(f, generator=g, device=dev)
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    before = LAUNCHES["lane_upconv2x"]
    got = lane_decoder.lane_upconv2x(x, wp, scale, bias, 0.2)
    assert LAUNCHES["lane_upconv2x"] == before + 1
    want = lane_decoder.lane_upconv2x_plain(x, wp, scale, bias, 0.2)
    assert got.shape == (N, 2 * h, 2 * w, f)
    _lane_within_one_step(got, want)


def _rcnet_decoder_call(dev, preset, B=3, K=30):
    """A full-width bf16 RC-Net of the preset in eval on seeded random
    weights and the decoder's inputs of one forward over a 96x128 frame,
    B*K = 90 patches (no multiple of 128), captured by a hook."""
    from riders_tpu_torch.core.config import ntu_config, zju_config
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines.rcnet_inference import (
        shift_points_and_boxes)
    cfg = (ntu_config if preset == "ntu" else zju_config)().rcnet
    model = init_random_(RCNet(cfg, device=dev, dtype=torch.bfloat16),
                         7).eval()
    g = torch.Generator(device=dev).manual_seed(31)
    (ph, pw), frame = cfg.patch_size, (96, 128)
    pts, _ = _points(g, dev, B, K, frame, K)
    pts, boxes = shift_points_and_boxes(pts, cfg.patch_size)
    image = torch.rand((B, frame[0] + 2 * (ph // 2),
                        frame[1] + 2 * (pw // 2), 3), generator=g,
                       device=dev)
    got = {}
    hook = model.decoder.register_forward_pre_hook(
        lambda m, args: got.update(args=(args[0].clone(),
                                         [t.clone() for t in args[1]])))
    with torch.inference_mode():
        model(image, pts, boxes)
    hook.remove()
    return model.decoder, got["args"]


@pytest.mark.parametrize("preset", ["ntu", "zju"])
def test_rcnet_default_decoder_is_the_lane_decode_on_card(dev, preset,
                                                         monkeypatch):
    """bf16 eval on the card at a patch batch of 90 (no multiple of the
    JAX kernels' 128): the decoder's forward is the lane decode, counted
    "full" with its B7 / B8 launches and bitwise `decode_full`'s; each of
    its B7 / B8 calls within one bf16 step of the plain version on the
    same inputs, and the whole within 5% of the max of the literal
    logits, which `literal` computes without a launch (chip_smoke's
    LANE_DECODE_BAR)."""
    dec, (x, skips) = _rcnet_decoder_call(dev, preset)
    assert x.shape[0] % 128 != 0
    out, launched = {}, {}
    with torch.inference_mode():
        for name, run, decodes, kernels in (
                ("default", dec, {"full": 1},
                 {"lane_conv3x3", "lane_upconv2x"}),
                ("literal", dec.literal, {}, set())):
            DECODES.clear()
            before = Counter(LAUNCHES)
            out[name] = run(x, skips)
            launched[name] = dict(LAUNCHES - before)
            assert dict(DECODES) == decodes
            assert set(launched[name]) == kernels
        assert torch.equal(lane_decode.decode_full(dec, x, skips),
                           out["default"])
        checked = Counter()

        def held(name):
            kernel = getattr(lane_decoder, name)
            plain = getattr(lane_decoder, f"{name}_plain")

            def call(*args):
                got = kernel(*args)
                _lane_within_one_step(got, plain(*args))
                checked[name] += 1
                return got
            return call

        for name in ("lane_conv3x3", "lane_upconv2x"):
            monkeypatch.setattr(lane_decode, name, held(name))
        assert torch.equal(dec(x, skips), out["default"])
        assert dict(checked) == launched["default"]
        monkeypatch.undo()
    lit = out["literal"].float()
    assert out["default"].shape == lit.shape == (x.shape[0], 1) + tuple(
        dec.output_shape)
    rel = float((out["default"].float() - lit).abs().max() / lit.abs().max())
    assert rel < 0.05, rel


def test_decode_full_replays_from_a_cuda_graph(dev):
    """The default decoder (decode_full) captured in a CUDA graph after
    a warm-up on a side stream: each replay equals the eager call on the
    same inputs bit for bit."""
    dec, (x, skips) = _rcnet_decoder_call(dev, "ntu", B=2, K=20)
    with torch.inference_mode():
        want = dec(x, skips)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                dec(x, skips)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        DECODES.clear()
        with torch.cuda.graph(graph):
            static = dec(x, skips)
        assert dict(DECODES) == {"full": 1}
        for _ in range(3):
            static.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(static, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,out_size,scale", [
    (8, (60, 25), 0.5), (32, (37, 12), 0.25), (128, (9, 3), 1 / 16)])
def test_roi_pool_4d_kernel_on_a_wide_canvas(dev, C, out_size, scale,
                                             dtype):
    """B6 bitwise against the plain version: a canvas whose rows and
    pitch reach well past H + win_h and W + win_w, its padding NEG, and
    the same pool on the plain map."""
    g = torch.Generator(device=dev).manual_seed(13)
    B, K, H, W = 2, 9, 23, 31
    feat = torch.randn((B, H, W, C), generator=g, device=dev).to(dtype)
    canvas = torch.full((B, H + 40, W + 70, C), roi_pool.NEG, dtype=dtype,
                        device=dev)
    canvas[:, :H, :W] = feat
    boxes = _boxes(g, dev, B, K, H, W, scale, out_size)
    want = patches.roi_max_pool(feat, boxes, scale, out_size)
    before = LAUNCHES["roi_pool_4d"]
    got = roi_pool.roi_max_pool_4d(canvas, boxes, scale, out_size, (H, W))
    plain = roi_pool.roi_max_pool_4d(feat, boxes, scale, out_size)
    assert LAUNCHES["roi_pool_4d"] == before + 2
    assert torch.equal(got, want) and torch.equal(plain, want)


def test_lane_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn((2, 4, 4, 8), device=dev).to(torch.bfloat16)
    w = lane_decoder.pack_conv(torch.randn((3, 3, 8, 8), device=dev))
    with pytest.raises(TypeError):
        lane_decoder.lane_conv3x3([x.float()], [w], None, None, None)
    with pytest.raises(ValueError):                         # weight's Ci
        lane_decoder.lane_conv3x3([x], [w[..., :4].contiguous()], None,
                                  None, None)
    with pytest.raises(ValueError):                         # scale alone
        lane_decoder.lane_conv3x3([x], [w], torch.ones(8, device=dev), None,
                                  None)
    with pytest.raises(ValueError):                         # not contiguous
        lane_decoder.lane_upconv2x(x.transpose(1, 2), w.repeat(4, 1, 1, 1),
                                   None, None, None)
    with pytest.raises(ValueError):                         # mixed devices
        lane_decoder.lane_conv3x3([x], [w.cpu()], None, None, None)
    wu = lane_decoder.pack_upconv(torch.randn((3, 3, 8, 8), device=dev))
    with pytest.raises(ValueError):                         # a 4F scale
        lane_decoder.lane_upconv2x(x, wu, torch.ones(32, device=dev),
                                   torch.zeros(32, device=dev), 0.2)


# ---- the staged, served and driver paths on the card -----------------------

def _narrow_cfg(frame=(64, 96), patch=(66, 34), K=8):
    import dataclasses
    from riders_tpu_torch.core.config import ntu_config
    cfg = ntu_config()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=frame,
                                    max_points=K),
        sml=dataclasses.replace(cfg.sml, net_shape=(64, 96), features=8),
        # narrow widths, but the stem kernel's 32 output channels
        rcnet=dataclasses.replace(
            cfg.rcnet, patch_size=patch,
            n_filters_encoder_image=(32, 16, 32, 32, 32),
            n_neurons_encoder_depth=(8, 16, 32, 32, 32),
            n_filters_decoder=(64, 32, 16, 8, 4), attention_layers=1,
            attention_heads=4))


def _points(g, dev, B, K, frame, n_real):
    H, W = frame
    u = torch.randint(0, W, (B, K), generator=g, device=dev).float()
    v = torch.randint(0, H, (B, K), generator=g, device=dev).float()
    z = 1 + 40 * torch.rand((B, K), generator=g, device=dev)
    mask = torch.zeros((B, K), device=dev)
    mask[:, :n_real] = 1.0
    return torch.stack([u, v, z], -1), mask


def test_adaptive_compose_on_card_matches_plain(dev):
    """Every round of the retry is one B4 launch, and the card's loop is
    bitwise the plain composition's on the same responses."""
    g = torch.Generator(device=dev).manual_seed(20)
    B, K, frame, patch = 4, 12, (72, 96), (30, 16)
    pts, mask = _points(g, dev, B, K, frame, 9)
    pts[..., 0] += patch[1] // 2
    pts[..., 1] += patch[0] // 2
    resp = torch.rand((B, K) + patch, generator=g, device=dev)
    resp *= torch.tensor([0.9, 0.33, 0.21, 0.05], device=dev)[
        :, None, None, None]
    before = LAUNCHES["compose"]
    got = patches.adaptive_compose(resp, pts, mask, frame, patch, 0.4)
    rounds = LAUNCHES["compose"] - before - 1
    want = patches.adaptive_compose(resp, pts, mask, frame, patch, 0.4,
                                    compose=patches.compose_patches)
    assert rounds == int(got[3].max()) > 0
    assert len(set(got[3].tolist())) > 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_rcnet_infer_fn_launches_the_kernels(dev):
    import numpy as np
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines.rcnet_inference import (
        make_rcnet_infer_fn, pad_image_for_patches)
    cfg = _narrow_cfg()
    g = torch.Generator(device=dev).manual_seed(21)
    B, K = 2, cfg.dataset.max_points
    pts, mask = _points(g, dev, B, K, cfg.dataset.image_shape, 6)
    frames = torch.rand((B,) + cfg.dataset.image_shape + (3,),
                        generator=g, device=dev).cpu().numpy()
    image = torch.from_numpy(np.stack(
        [pad_image_for_patches(f, cfg.rcnet.patch_size) for f in frames]))
    model = init_random_(RCNet(cfg.rcnet, dtype=torch.bfloat16), 0)
    fn = make_rcnet_infer_fn(cfg, model)
    LAUNCHES.clear()
    out = fn({"image": image, "points": pts, "point_mask": mask})
    assert LAUNCHES["stem"] >= 1 and LAUNCHES["roi_pool"] == 1
    assert LAUNCHES["compose"] == 1 + int(out["retries"].max())
    assert out["depth"].shape == (B,) + cfg.dataset.image_shape
    assert bool(torch.isfinite(out["depth"]).all())


def test_fused_server_on_card_equals_direct_calls(dev):
    import numpy as np
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.fused import make_fused_fn
    from riders_tpu_torch.pipelines.serving import FusedServer
    cfg = _narrow_cfg()
    rcnet = init_random_(RCNet(cfg.rcnet, dtype=torch.bfloat16), 0)
    sml = init_random_(ScaleMapLearner(cfg.sml, dtype=torch.bfloat16), 1)
    fn = make_fused_fn(cfg, rcnet, sml)
    rng = np.random.default_rng(0)
    H, W = cfg.dataset.image_shape
    K = cfg.dataset.max_points
    batches = []
    for _ in range(4):
        g = torch.Generator(device="cpu").manual_seed(len(batches))
        pts, mask = _points(g, "cpu", 2, K, (H, W), 5)
        batches.append({
            "image": rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8),
            "mono_pred": rng.integers(300, 9000, (2, H, W),
                                      dtype=np.uint16),
            "radar_points": pts.numpy(), "point_mask": mask.numpy()})
    direct = [fn(b).cpu().numpy() for b in batches]
    server = FusedServer(fn, depth=2)
    served = list(server.run(iter(batches)))
    assert not server.uploader.is_alive()
    for a, b in zip(served, direct):
        assert np.array_equal(a, b)


def test_fused_call_launches_the_scale_search_once(dev, monkeypatch):
    """Stage 1's golden-section search is one kernel launch a fused call,
    and its plain loop never runs on the card's tensors."""
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.ops.kernels import golden_section
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    def refuse(p, *args):
        raise AssertionError(f"the plain loop ran on {p.device}")

    monkeypatch.setattr(golden_section, "golden_section_plain", refuse)
    cfg = _narrow_cfg()
    rcnet = init_random_(RCNet(cfg.rcnet, dtype=torch.bfloat16), 0)
    sml = init_random_(ScaleMapLearner(cfg.sml, dtype=torch.bfloat16), 1)
    fn = make_fused_fn(cfg, rcnet, sml)
    H, W = cfg.dataset.image_shape
    g = torch.Generator(device=dev).manual_seed(25)
    pts, mask = _points(g, dev, 3, cfg.dataset.max_points, (H, W), 6)
    depth = 5 + 40 * torch.rand((3, H, W), generator=g, device=dev)
    batch = {"image": torch.rand((3, H, W, 3), generator=g, device=dev),
             "mono_pred": (1.0 / depth) / 0.05, "radar_points": pts,
             "point_mask": mask}
    for _ in range(2):
        before = LAUNCHES["golden_section"]
        out = fn(batch)
        torch.cuda.synchronize()
        assert LAUNCHES["golden_section"] == before + 1
    assert bool(torch.isfinite(out).all())


def test_bench_chain_graph_replay_equals_eager(dev):
    """The fused call captured as a CUDA graph (`bench.Chain`): one stem,
    one RoI pool, one compose and one golden-section launch and one
    decode_full's B7 / B8 launches counted during capture, the
    replayed depth bitwise an eager call's on the same input, and each
    replay carrying 1e-12 * depth.sum() into the first pixel alone."""
    from riders_tpu_torch import bench
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.fused import make_fused_fn
    cfg = _narrow_cfg()
    rcnet = init_random_(RCNet(cfg.rcnet, dtype=torch.bfloat16), 0)
    sml = init_random_(ScaleMapLearner(cfg.sml, dtype=torch.bfloat16), 1)
    fn = make_fused_fn(cfg, rcnet, sml)
    H, W = cfg.dataset.image_shape
    g = torch.Generator(device=dev).manual_seed(24)
    pts, mask = _points(g, dev, 2, cfg.dataset.max_points, (H, W), 6)
    depth = 5 + 40 * torch.rand((2, H, W), generator=g, device=dev)
    batch = {"image": torch.rand((2, H, W, 3), generator=g, device=dev),
             "mono_pred": (1.0 / depth) / 0.05, "radar_points": pts,
             "point_mask": mask}
    DECODES.clear()
    chain = bench.Chain(fn, batch, graph=True)
    # the patch decoder on B7 / B8 (66x34 patches: three exact-x2 stages,
    # one irregular, four fusions, the three-conv tail), as eagerly
    assert chain.launches == {"stem": 1, "roi_pool": 1, "compose": 1,
                              "golden_section": 1, "lane_conv3x3": 8,
                              "lane_upconv2x": 3}
    assert dict(DECODES) == {"full": bench.WARMUP + 1}
    for _ in range(3):
        image = chain.batch["image"].clone()
        got = chain().clone()
        assert torch.equal(got, fn(dict(chain.batch, image=image)))
        now = chain.batch["image"].view(-1)
        want = image.view(-1)[:1] + 1e-12 * got.sum()
        assert torch.equal(now[:1], want)
        assert torch.equal(now[1:], image.view(-1)[1:])
    assert bool(torch.isfinite(got).all())


def test_metrics_and_loader_on_card(dev):
    import numpy as np
    from riders_tpu_torch.core.metrics import compute_depth_metrics
    from riders_tpu_torch.io.input_pipeline import BatchLoader
    g = torch.Generator().manual_seed(22)
    pred = 1 + 60 * torch.rand((3, 40, 50), generator=g)
    gt = 1 + 60 * torch.rand((3, 40, 50), generator=g)
    gt[torch.rand(gt.shape, generator=g) < 0.7] = 0
    cpu = compute_depth_metrics(pred, gt, 0.0, 50.0)
    card = compute_depth_metrics(pred.to(dev), gt.to(dev), 0.0, 50.0)
    for k in cpu:
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-5,
                                   atol=0)
    data = [{"x": np.full((4, 5), i, np.float32),
             "c": np.full((3,), i, np.uint16)} for i in range(5)]
    loader = BatchLoader(data, 2, shuffle=False, drop_last=False)
    batches = list(loader.epoch())
    assert [b["x"].device.type for b in batches] == ["cuda"] * 3
    assert batches[-1]["x"].shape == (1, 4, 5)
    assert int(batches[2]["c"].view(torch.int16)[0, 0]) == 4


def test_idw_scale_map_on_card_matches_cpu(dev):
    """At the NTU frame, with 0, 40 and 900 knots: the card keeps the
    CPU's knots (the first 128 valid pixels in row-major order) and its
    map within rtol 1e-5."""
    from riders_tpu_torch.ops import interp
    g = torch.Generator().manual_seed(23)
    B, H, W = 3, 512, 640
    prior = 0.05 + torch.rand((B, H, W), generator=g)
    valid = torch.zeros((B, H * W))
    for b, n in enumerate((0, 40, 900)):
        valid[b, torch.randperm(H * W, generator=g)[:n]] = 1.0
    valid = valid.reshape(B, H, W)
    sparse = valid * (0.02 + 0.3 * torch.rand((B, H, W), generator=g))
    cpu = interp.idw_scale_map(prior, sparse, valid)
    card = interp.idw_scale_map(prior.to(dev), sparse.to(dev),
                                valid.to(dev))
    assert torch.equal(interp.knot_indices(valid.to(dev)).cpu(),
                       interp.knot_indices(valid))
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=0)
    assert bool((card[0] == 1).all())


def _write_frames(root, scene, n, frame, seed):
    """A scene of the on-disk layout: thermal PNGs, the mono prior, radar
    returns, sparse and interpolated lidar depth (x256 PNG16)."""
    import numpy as np
    from PIL import Image
    from riders_tpu_torch.io import depthio
    rng = np.random.default_rng(seed)
    H, W = frame
    dirs = {d: depthio.ensure_dir(f"{root}/{scene}/{d}") for d in (
        "thermal_undistort", "any", "radar_png", "lidar_png",
        "lidar_png_int")}
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for f in range(n):
        name = f"{f:06d}.png"
        depth = 5 + 30 * yy / H + 10 * xx / W + rng.random((H, W))
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                        ).save(f"{dirs['thermal_undistort']}/{name}")
        depthio.save_depth((1 / depth) / 0.05 * (0.9 + 0.2 * rng.random(
            (H, W))), f"{dirs['any']}/{name}")
        for d, k in (("radar_png", 30), ("lidar_png", 400)):
            sparse = np.zeros((H, W), np.float32)
            idx = rng.choice(H * W, k, replace=False)
            sparse.reshape(-1)[idx] = depth.reshape(-1)[idx]
            depthio.save_depth(sparse, f"{dirs[d]}/{name}")
        depthio.save_depth(depth, f"{dirs['lidar_png_int']}/{name}")


@pytest.mark.parametrize("trainer", ["rcnet", "sml"])
def test_training_driver_step_on_card(dev, tmp_path, trainer):
    """One step of each training driver on the card: finite loss, a
    checkpoint, and (RC-Net) the RoI forward and backward kernels."""
    import dataclasses
    import json
    from riders_tpu_torch.core import checkpoint
    from riders_tpu_torch.pipelines import drivers
    cfg = _narrow_cfg(frame=(96, 128), K=16)
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, root=str(tmp_path),
                                    train_scenes=("s",)),
        rcnet_train=dataclasses.replace(cfg.rcnet_train, batch_size=2,
                                        points_per_frame=6,
                                        n_step_per_summary=1),
        sml_train=dataclasses.replace(cfg.sml_train, batch_size=2,
                                      rcnet_interp="interp",
                                      n_step_per_summary=1))
    _write_frames(str(tmp_path), "s", 2, (96, 128), 24)
    ckpt = str(tmp_path / "ckpt")
    LAUNCHES.clear()
    getattr(drivers, f"train_{trainer}")(cfg, ckpt, max_steps=1)
    if trainer == "rcnet":
        assert LAUNCHES["roi_pool_f32"] == LAUNCHES["roi_pool_bwd"] == 5
    assert checkpoint.all_steps(ckpt) == [1]
    with open(f"{ckpt}/scalars-train.jsonl") as f:
        loss = json.loads(f.readline())["loss"]
    assert loss == loss and abs(loss) < float("inf")


def test_nccl_world_of_one_sharded_fused_on_card(dev):
    """An NCCL world of one (the machine has one card): the sharded fused
    path on its (1, 1) mesh launches each kernel once a call, gathers
    over both axes, and equals `make_fused_fn` bit for bit; the process
    group is gone after."""
    import socket
    import torch.distributed as dist
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.parallel import sharding as sh
    from riders_tpu_torch.pipelines.fused import (make_fused_fn,
                                                  make_sharded_fused_fn)
    cfg = _narrow_cfg()
    rcnet = init_random_(RCNet(cfg.rcnet, dtype=torch.bfloat16), 0)
    sml = init_random_(ScaleMapLearner(cfg.sml, dtype=torch.bfloat16), 1)
    H, W = cfg.dataset.image_shape
    g = torch.Generator(device=dev).manual_seed(0)
    pts, mask = _points(g, dev, 2, cfg.dataset.max_points, (H, W), 5)
    batch = {"image": torch.rand((2, H, W, 3), generator=g, device=dev),
             "mono_pred": 0.5 + torch.rand((2, H, W), generator=g,
                                           device=dev),
             "radar_points": pts, "point_mask": mask}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    assert sh.initialize_multihost(address, 1, 0, timeout_s=120).type == \
        "cuda"
    try:
        assert dist.get_backend() == "nccl"
        mesh = sh.make_mesh(1, 1)
        fn = make_sharded_fused_fn(cfg, rcnet, sml, mesh)
        LAUNCHES.clear()
        got = fn(batch)
        assert {k: LAUNCHES[k] for k in ("stem", "roi_pool", "compose")} \
            == {"stem": 1, "roi_pool": 1, "compose": 1}
        assert mesh.calls == {"all_gather:points": 1, "all_gather:data": 1}
        assert torch.equal(got, make_fused_fn(cfg, rcnet, sml)(batch))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("form", ["fast_2x", "phase_tail"])
def test_fast_forms_on_card_match_literal(dev, form):
    """Each fast form in bf16 on the card against the literal form on the
    same module, within two bf16 steps of the larger magnitude plus 2^-7
    of the output's max abs (both round each op's output in bf16, at
    different points); the default (None) is the fast form."""
    from riders_tpu_torch.models import layers
    from riders_tpu_torch.models.rcnet import MultiScaleDecoder
    torch.manual_seed(0)
    if form == "fast_2x":
        m = layers.UpConvBlock(12, 16, 3, layers.activation_fn(
            "leaky_relu"), True)
        args = (torch.randn(4, 12, 75, 25), (150, 50))
    else:
        m = MultiScaleDecoder(24, [8, 16], (16, 16, 8), (32, 32))
        args = (torch.randn(6, 24, 4, 4), [torch.randn(6, 8, 16, 16),
                                           torch.randn(6, 16, 8, 8)])
    m = layers.init_random_(m).to(dev, torch.bfloat16).eval()
    args = [a.to(dev, torch.bfloat16) if isinstance(a, torch.Tensor) else
            [t.to(dev, torch.bfloat16) for t in a] if isinstance(a, list)
            else a for a in args]
    with torch.no_grad():
        setattr(m, form, False)
        literal = m(*args).float()
        setattr(m, form, True)
        fast = m(*args).float()
        setattr(m, form, None)
        default = m(*args).float()
    # None takes the fast form for bf16 on the card
    assert torch.equal(default, fast)
    assert fast.shape == literal.shape
    assert not torch.equal(fast, literal)
    limit = 2 * 2 ** -7 * torch.maximum(fast.abs(), literal.abs()) + \
        2 ** -7 * float(literal.abs().max())
    assert bool(((fast - literal).abs() <= limit).all())


@pytest.mark.parametrize("channels_last", [False, True])
def test_cross_rank_batch_norm_on_card_matches_batch_norm(dev,
                                                          channels_last):
    """The cross-rank BatchNorm's card form (ATen's fused batch-norm
    operations; one rank, no process group) against torch's train-mode
    BatchNorm, f32: the output, the input, weight and bias gradients and
    the statistics within 1e-4 of their max abs, on channels with a
    large mean against their spread as well."""
    from riders_tpu_torch.parallel import sharding as sh
    g = torch.Generator(device=dev).manual_seed(0)
    scale = torch.tensor([1.0, 1e-2, 0.3, 3.0], device=dev)
    shift = torch.tensor([0.5, 30.0, -2.0, 0.0], device=dev)
    x = torch.randn((6, 4, 17, 23), generator=g, device=dev) * \
        scale[None, :, None, None] + shift[None, :, None, None]
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.rand(4, generator=g, device=dev) + 0.5
    b = torch.randn(4, generator=g, device=dev)
    dy = torch.randn(x.shape, generator=g, device=dev)
    leaves = [[t.clone().requires_grad_() for t in (x, w, b)]
              for _ in range(2)]
    want = torch.nn.functional.batch_norm(leaves[0][0], None, None,
                                          *leaves[0][1:], True, 0.0, 1e-5)
    got, mean, var = sh.cross_rank_batch_norm(
        *leaves[1], 1e-5, sh.make_mesh().axis(sh.DATA_AXIS))
    (want * dy).sum().backward()
    (got * dy).sum().backward()
    pairs = [(got, want)] + [(a.grad, c.grad) for a, c in
                             zip(leaves[1], leaves[0])]
    v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    pairs += [(mean, m), (var, v)]
    for a, c in pairs:
        a, c = a.detach().float(), c.detach().float()
        limit = 1e-4 * c.abs() + 1e-4 * float(c.abs().max())
        assert bool(((a - c).abs() <= limit).all())


def test_cross_rank_batch_norm_on_card_is_exact_in_f64(dev):
    """The card form in f64 against torch's train-mode BatchNorm in f64:
    the output and the input, weight and bias gradients within 1e-10 of
    their max abs (ATen's batch-norm operations accumulate f64 in f64)."""
    from riders_tpu_torch.parallel import sharding as sh
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((6, 4, 17, 23), generator=g, device=dev,
                    dtype=torch.float64) * 2.0 + 0.5
    w = torch.rand(4, generator=g, device=dev, dtype=torch.float64) + 0.5
    b = torch.randn(4, generator=g, device=dev, dtype=torch.float64)
    dy = torch.randn(x.shape, generator=g, device=dev, dtype=torch.float64)
    leaves = [[t.clone().requires_grad_() for t in (x, w, b)]
              for _ in range(2)]
    want = torch.nn.functional.batch_norm(leaves[0][0], None, None,
                                          *leaves[0][1:], True, 0.0, 1e-5)
    got = sh.cross_rank_batch_norm(*leaves[1], 1e-5,
                                   sh.make_mesh().axis(sh.DATA_AXIS))[0]
    (want * dy).sum().backward()
    (got * dy).sum().backward()
    for a, c in [(got, want)] + [(p.grad, q.grad) for p, q in
                                 zip(leaves[1], leaves[0])]:
        assert float((a - c).abs().max()) <= 1e-10 * float(c.abs().max())


def _beit_inputs(dev, batch, window, heads, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = window[0] * window[1] + 1
    qkv = torch.randn((batch, n, 3 * heads * 64), generator=g,
                      device=dev).to(torch.bfloat16)
    table = torch.randn((heads, attention.table_rows(window)), generator=g,
                        device=dev)
    return qkv, table


@pytest.mark.parametrize("batch,window,heads", [
    (1, (1, 3), 2), (2, (4, 5), 4), (3, (7, 9), 3), (2, (12, 11), 2),
    (1, (32, 40), 2)])
def test_beit_attention_kernel_matches_f32_attention(dev, batch, window,
                                                     heads):
    """One key tile holding row 0, key 0 and the ragged tail; several
    query blocks and key tiles; the BEiT cell's window.  Within one bf16
    step of the output's largest value of float32 attention on the same
    bf16 inputs, and of the plain version beyond its own distance from
    it (the plain version rounds q k^T to bf16)."""
    qkv, table = _beit_inputs(dev, batch, window, heads)
    before = LAUNCHES["beit_attention"]
    got = attention.beit_attention(qkv, table, window, heads).float()
    assert LAUNCHES["beit_attention"] == before + 1
    plain = attention.beit_attention_plain(qkv, table, window, heads).float()
    B, N, _ = qkv.shape
    q, k, v = qkv.float().reshape(B, N, 3, heads, 64).permute(
        2, 0, 3, 1, 4).unbind(0)
    bias = table[:, attention._rel_index(window, table.device)].reshape(
        heads, N, N)
    ref = ((q @ k.transpose(-2, -1) / 8 + bias).softmax(-1) @ v).transpose(
        1, 2).reshape(B, N, heads * 64)
    step = 2.0 ** (int(torch.log2(ref.abs().max()).floor()) - 7)
    assert float((got - ref).abs().max()) <= step
    assert float((got - plain).abs().max()) <= (
        float((plain - ref).abs().max()) + step)


def test_beit_attention_kernel_refuses_what_it_does_not_take(dev):
    qkv, table = _beit_inputs(dev, 1, (4, 5), 2)
    with pytest.raises(TypeError):
        attention.beit_attention(qkv.float(), table, (4, 5), 2)
    with pytest.raises(TypeError):
        attention.beit_attention(qkv, table.double(), (4, 5), 2)
    with pytest.raises(ValueError):
        attention.beit_attention(qkv, table, (4, 5), 4)      # width 32
    with pytest.raises(ValueError):
        attention.beit_attention(qkv, table[:, 1:].contiguous(), (4, 5),
                                 2)                          # table rows
    with pytest.raises(ValueError):
        attention.beit_attention(qkv, table, (3, 5), 2)      # tokens


def test_beit_block_takes_the_kernel_for_bf16_inference_only(dev):
    """A bf16 BEiT block on the card runs the kernel in eval with grad
    off, and the plain version in training mode or with grad on."""
    block = dpt.BEiTAttention(128, 2, 4).to(dev, torch.bfloat16).eval()
    x = torch.randn((2, 21, 128), device=dev).to(torch.bfloat16)
    dpt.COUNTS.clear()
    before = LAUNCHES["beit_attention"]
    with torch.inference_mode():
        block(x, (4, 5))
    with torch.no_grad():
        block.train()(x, (4, 5))
    block.eval()(x, (4, 5))
    assert LAUNCHES["beit_attention"] == before + 1
    assert dpt.COUNTS == {"bias_tables": 3, "attn_kernel": 1,
                          "attn_plain": 2}


def _swin2_inputs(dev, windows, w, heads, seed=0):
    """N(0, 1) qkv rows in bf16, an N(0, 4) position-bias MLP output and
    logit scales from 3 to 900 (the last heads clamped at 100)."""
    from riders_tpu_torch.ops.kernels import swin2_attention as sw
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((windows, w * w, 3 * heads * sw.HEAD_DIM),
                      generator=g, device=dev).to(torch.bfloat16)
    table = 2 * torch.randn((heads, (2 * w - 1) ** 2), generator=g,
                            device=dev)
    scale = torch.clamp(torch.logspace(math.log10(3.0), math.log10(900.0),
                                       heads, device=dev), max=100.0)
    return qkv, table, scale


def _swin2_f32(qkv, table, scale, w, shift, grid, heads):
    """Float32 attention on the same bf16 inputs: q and k normalised in
    float32 and rounded to bf16 as both versions do, every later step in
    float32."""
    from riders_tpu_torch.ops.kernels import swin2_attention as sw
    Bw, N, C3 = qkv.shape
    q, k, v = (sw.split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    logits = sw.l2_normalize(q).float() @ sw.l2_normalize(k).float().transpose(-2, -1)
    bias = 16 * torch.sigmoid(table.t()[sw.pair_index(w, table.device)])
    logits = logits * scale[:, None, None] + bias.reshape(
        N, N, heads).permute(2, 0, 1)
    mask = sw.grid_mask(tuple(grid), w, shift, qkv.device)
    probs = sw.masked_softmax(logits, mask)
    return (probs @ v.float()).transpose(1, 2).reshape(Bw, N, C3 // 3)


@pytest.mark.parametrize("frames,grid,w,shift,heads", [
    (2, (96, 96), 24, 0, 6), (2, (96, 96), 24, 12, 6),
    (2, (48, 48), 24, 0, 12), (2, (48, 48), 24, 12, 12),
    (2, (24, 24), 24, 0, 24), (2, (12, 12), 12, 0, 48),
    (2, (64, 64), 16, 8, 3), (2, (32, 32), 16, 0, 6), (2, (8, 8), 8, 0, 24),
    (3, (8, 12), 4, 2, 2), (1, (5, 5), 5, 0, 1), (2, (1, 1), 1, 0, 2)],
    ids=["L0", "L0_shifted", "L1", "L1_shifted", "L2", "L3", "T0_shifted",
         "T1", "T3", "w4_shifted", "w5", "w1"])
def test_swin2_attention_kernel_matches_f32_attention(dev, frames, grid, w,
                                                      shift, heads):
    """Each Swin2-L stage's shape (B=2), shifted and unshifted, Swin2-T's
    w = 16 and w = 8, and windows whose rows and keys the kernel pads;
    the last heads' logit scales at the clamp.  One launch a call, within
    two bf16 steps of the output's largest value of float32 attention on
    the same bf16 inputs, and of the plain version beyond its own
    distance from it (the plain version rounds q^ k^^T to bf16, an error
    the logit scale multiplies: 14 steps at Swin2-L's stage 0, B=16).
    One step is the output's and P's rounding; the other a q^ or k^
    element that rounds to the next bf16 value: the kernel's norm and the
    float32 attention's sum their squares in other orders, and at a
    logit scale of 100 one such element moves a near one-hot row's
    output by up to ~1.1 steps (1.03 seen at stage 0, B=16), while its
    mean error stays at the plain version's seventh."""
    from riders_tpu_torch.ops.kernels import swin2_attention as sw
    windows = frames * (grid[0] // w) * (grid[1] // w)
    qkv, table, scale = _swin2_inputs(dev, windows, w, heads)
    before = LAUNCHES["swin2_attention"]
    got = sw.swin2_attention(qkv, table, scale, w, shift, grid,
                             heads).float()
    assert LAUNCHES["swin2_attention"] == before + 1
    plain = sw.swin2_attention_plain(qkv, table, scale, w, shift, grid,
                                     heads).float()
    ref = _swin2_f32(qkv, table, scale, w, shift, grid, heads)
    tol = 2.0 ** (int(torch.log2(ref.abs().max()).floor()) - 6)
    assert float((got - ref).abs().max()) <= tol
    assert float((got - plain).abs().max()) <= (
        float((plain - ref).abs().max()) + tol)
    assert float((got - ref).abs().sum()) <= float((plain - ref).abs().sum())


def test_swin2_attention_kernel_refuses_what_it_does_not_take(dev):
    from riders_tpu_torch.ops.kernels import swin2_attention as sw
    qkv, table, scale = _swin2_inputs(dev, 8, 4, 2)
    args = (4, 2, (8, 8), 2)
    with pytest.raises(TypeError):
        sw.swin2_attention(qkv.float(), table, scale, *args)
    with pytest.raises(TypeError):
        sw.swin2_attention(qkv, table.double(), scale, *args)
    with pytest.raises(ValueError):
        sw.swin2_attention(qkv, table, scale, 4, 2, (8, 8), 4)  # width 16
    with pytest.raises(ValueError):
        sw.swin2_attention(qkv, table[:, 1:].contiguous(), scale, *args)
    with pytest.raises(ValueError):
        sw.swin2_attention(qkv, table, scale[:1], *args)
    with pytest.raises(ValueError):
        sw.swin2_attention(qkv, table, scale, 3, 1, (6, 6), 2)  # tokens
    with pytest.raises(ValueError):
        sw.swin2_attention(qkv[:6], table, scale, *args)   # 6 of 4 a grid
    big, big_table, big_scale = _swin2_inputs(dev, 1, 25, 1)
    with pytest.raises(ValueError):
        sw.swin2_attention(big, big_table, big_scale, 25, 0, (25, 25), 1)


def test_swin2_block_takes_the_kernel_for_bf16_inference_only(dev):
    """A bf16 Swin V2 block on the card runs the kernel in eval with grad
    off, and the plain version in training mode or with grad on."""
    from riders_tpu_torch.models import swin2
    block = swin2.SwinBlockV2(64, 2, (8, 8), 4, 2, 2).to(
        dev, torch.bfloat16).eval()
    x = torch.randn((2, 64, 64), device=dev).to(torch.bfloat16)
    swin2.COUNTS.clear()
    before = LAUNCHES["swin2_attention"]
    with torch.inference_mode():
        block(x)
    with torch.no_grad():
        block.train()(x)
    block.eval()(x)
    assert LAUNCHES["swin2_attention"] == before + 1
    assert swin2.COUNTS == {"cpb_tables": 3, "attn_kernel": 1,
                            "attn_plain": 2}


def test_swin2_backbone_on_the_kernel_matches_the_plain_path(dev):
    """A bf16 SwinV2Backbone (head width 32, windows 8 / 8 / 8 / 4,
    stages 0 and 1 shifted) at 128x128 on its initial weights: one launch
    a block in inference, and each tap within twice the plain path's own
    relative L1 distance from the float32 model (plain path, same
    weights) of the plain path's taps."""
    from unittest import mock
    from riders_tpu_torch.models import swin2
    config = swin2.Swin2Config(embed_dim=64, depths=(2, 2, 2, 2),
                               num_heads=(2, 4, 8, 16), window_size=8,
                               pretrained_window_sizes=(4, 4, 4, 2))
    torch.manual_seed(0)
    f32 = swin2.SwinV2Backbone(config, (128, 128)).to(dev).eval()
    bf16 = copy.deepcopy(f32).to(torch.bfloat16)
    x = torch.randn((2, 3, 128, 128), device=dev)
    before = LAUNCHES["swin2_attention"]
    swin2.COUNTS.clear()
    with torch.inference_mode():
        want = f32(x)
        assert LAUNCHES["swin2_attention"] == before
        got = bf16(x.to(torch.bfloat16))
        assert LAUNCHES["swin2_attention"] == before + 8
        assert swin2.COUNTS["attn_kernel"] == 8
        with mock.patch.object(swin2, "swin2_attention_path",
                               lambda *a: "plain"):
            plain = bf16(x.to(torch.bfloat16))
    for g, p, w in zip(got, plain, want):
        g, p = g.float(), p.float()
        plain_err = float((p - w).abs().sum() / w.abs().sum())
        assert float((g - p).abs().sum() / p.abs().sum()) <= 2 * plain_err
