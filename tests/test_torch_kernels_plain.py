"""The plain PyTorch versions of the three CUDA kernels (RoI pool, patch
composition, fused stem) against the JAX package on the CPU: its XLA
formulations and its Pallas kernels in interpret mode.  The kernel
wrappers run these plain versions for CPU tensors, and the card holds
the kernels against them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models.layers import FusedStemConv as JaxStem
from riders_tpu.ops.pallas.compose import compose_patches_pallas
from riders_tpu.ops.pallas.roi_pool import (_NEG, roi_max_pool_pallas_foldw,
                                            roi_pool_pyramid_pallas,
                                            roi_window_pad_folded,
                                            unfold_pooled)
from riders_tpu.ops.pallas.stem import stem_conv_pallas
from riders_tpu.ops.patches import (compose_patches_batched,
                                    roi_pool_pyramid_batched)
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.models.layers import FusedStemConv
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import compose, roi_pool, stem

t = torch.from_numpy
GEOMETRIES = {"zju": (240, 100), "ntu": (150, 50)}


def _points(rng, B, K, H, W):
    """Integer pixel (u, v, z) points including the frame corners."""
    u = rng.integers(0, W, (B, K)).astype(np.float32)
    v = rng.integers(0, H, (B, K)).astype(np.float32)
    u[:, :2], v[:, :2] = [0, W - 1], [0, H - 1]
    z = (1 + 50 * rng.random((B, K))).astype(np.float32)
    return np.stack([u, v, z], -1)


def _pyramid_inputs(rng, patch, B=2, K=5, H=64, W=96, C=8):
    """Encoder-shaped maps of an edge-padded frame: skips at /2../16 and
    the latent at /32, plus boxes of padded-coordinate patches."""
    ph, pw = patch
    Hp, Wp = H + 2 * (ph // 2), W + 2 * (pw // 2)
    maps = []
    for i in range(5):
        h, w = Hp, Wp
        for _ in range(i + 1):
            h, w = -(-h // 2), -(-w // 2)
        maps.append(rng.standard_normal((B, h, w, C)).astype(np.float32))
    pts = _points(rng, B, K, H, W)
    x1, y1 = pts[..., 0], pts[..., 1]
    boxes = np.stack([x1, y1, x1 + pw, y1 + ph], -1).astype(np.float32)
    return maps[4], maps[:4], boxes


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_roi_pool_plain_matches_jax(rng, geometry):
    """The plain pyramid against the XLA pool and the Pallas kernel in
    interpret mode; a max is exact, so equality is exact."""
    patch = GEOMETRIES[geometry]
    latent, skips, boxes = _pyramid_inputs(rng, patch)
    got_lat, got_sk = roi_pool.roi_pool_pyramid(
        t(latent), [t(s) for s in skips], t(boxes), patch)
    args = (jnp.asarray(latent), [jnp.asarray(s) for s in skips],
            jnp.asarray(boxes), patch)
    xla_lat, xla_sk = roi_pool_pyramid_batched(*args, use_pallas=False)
    pl_lat, pl_sk = roi_pool_pyramid_pallas(*args, interpret=True)
    for got, xla, pal in zip([got_lat] + got_sk, [xla_lat] + list(xla_sk),
                             [pl_lat] + list(pl_sk)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_roi_pool_plain_matches_foldw_skip1(rng, geometry):
    """Skip1 (/2, C=32): the port pools the plain NHWC map; the TPU path
    pools the stem's W-folded canvas (foldw kernel + unfold_pooled)."""
    patch = GEOMETRIES[geometry]
    latent, skips, boxes = _pyramid_inputs(rng, patch, C=32)
    feat = skips[0]
    B, H, W, C = feat.shape
    out = (patch[0] // 2, patch[1] // 2)
    win_h, win_w = roi_window_pad_folded(patch, 0.5, C)
    R, Wo2 = H + win_h, -(-(W + win_w) // 8) * 8
    canvas = np.full((B, R, Wo2, C), _NEG, np.float32)
    canvas[:, :H, :W] = feat
    folded = canvas.reshape(B, R, Wo2 // 4, 4 * C)
    ref = unfold_pooled(roi_max_pool_pallas_foldw(
        jnp.asarray(folded), jnp.asarray(boxes), 0.5, out, patch,
        true_hw=(H, W), channels=C, interpret=True), out[1], C)
    got = roi_pool.roi_max_pool(t(feat), t(boxes), 0.5, out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_compose_plain_matches_jax(rng, geometry):
    """Per-frame thresholds (one negative, as ZJU's 0.1 - 8 * 0.05), points
    on the frame edges, masked points.  Sums run in ascending k in all
    three.  The max-response map is exact.  XLA on the CPU fuses each
    sum_rz + r * z into one FMA (one rounding) where the port rounds r * z
    first, as the CUDA kernel does, so depth agrees to about one f32 ulp
    (rtol 1e-6)."""
    ph, pw = (s // 5 for s in GEOMETRIES[geometry])
    H, W, B, K = 72, 96, 3, 7
    resp = rng.random((B, K, ph, pw)).astype(np.float32)
    pts = _points(rng, B, K, H, W)
    pts[:, 2:4, :2] += 0.5            # half-pixel centres round to even
    pts[..., :2] += [pw // 2, ph // 2]  # padded coordinates
    mask = (rng.random((B, K)) > 0.3).astype(np.float32)
    thr = np.asarray([0.4, -0.3, 0.75], np.float32)

    got_d, got_r = compose.compose_patches(
        t(resp), t(pts), t(mask), (H, W), (ph, pw), t(thr))
    args = (jnp.asarray(resp), jnp.asarray(pts), jnp.asarray(mask), (H, W),
            (ph, pw), jnp.asarray(thr))
    for ref_d, ref_r in (compose_patches_batched(*args, use_pallas=False),
                         compose_patches_pallas(*args, interpret=True)):
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(ref_r))


def test_adaptive_threshold_matches_jax(rng):
    from riders_tpu.ops.patches import adaptive_threshold_value
    resp = rng.random((4, 5, 6, 7)).astype(np.float32)
    resp[1] *= 0.26     # needs decay
    resp[2] = 0.0       # empty: bounded retries
    resp[3] *= 0.05     # deep decay
    mask = (rng.random((4, 5)) > 0.2).astype(np.float32)
    ref = adaptive_threshold_value(jnp.asarray(resp), jnp.asarray(mask),
                                   0.4, 0.05, 8)
    got = patches.adaptive_threshold_value(t(resp), t(mask), 0.4, 0.05, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _stem_vars(rng, H=46, W=58, B=2):
    image = rng.random((B, H, W, 3)).astype(np.float32)
    model = JaxStem(32, 7, "leaky_relu", True, fuse_pool=True)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.asarray(image)))
    bn = variables["batch_stats"]["bn"]
    bn["mean"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
    bn["var"] = (0.5 + rng.random(32)).astype(np.float32)
    variables["params"]["bn"]["scale"] = (0.8 + 0.4 * rng.random(32)
                                          ).astype(np.float32)
    variables["params"]["bn"]["bias"] = (0.1 * rng.standard_normal(32)
                                         ).astype(np.float32)
    return model, variables, image


def test_stem_plain_matches_literal_f32(rng):
    """f32: the plain stem (BN folded into the weights) against flax's
    literal conv -> BN -> leaky-relu -> max-pool.  Folding reassociates
    the BN affine, so agreement is to f32 rounding (rtol 1e-4)."""
    model, variables, image = _stem_vars(rng)
    ref_h, ref_p = model.apply(variables, jnp.asarray(image))
    port = load_jax_variables(FusedStemConv(3, 32, fuse_pool=True),
                              variables).eval()
    with torch.no_grad():
        h, p = port(t(image))
    np.testing.assert_allclose(h.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_h), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_p), rtol=1e-4, atol=1e-5)


def test_stem_plain_matches_pallas_bf16(rng):
    """bf16: the plain stem against stem_conv_pallas(pool=True) in
    interpret mode, sliced to the conv extent.  Both round the folded
    weights to bf16 and accumulate in f32, differing only in summation
    order, so outputs agree to one bf16 rounding step (2^-8 relative;
    atol 1e-3 for values near 0)."""
    model, variables, image = _stem_vars(rng)
    bn, stats = variables["params"]["bn"], variables["batch_stats"]["bn"]
    g = (bn["scale"] / np.sqrt(stats["var"] + 1e-5)).astype(np.float32)
    b = (bn["bias"] - stats["mean"] * g).astype(np.float32)
    kernel = variables["params"]["conv"]["kernel"]
    ref_h, ref_p = stem_conv_pallas(
        jnp.asarray(image), jnp.asarray(kernel), jnp.asarray(g),
        jnp.asarray(b), k=7, pool=True, interpret=True)
    Ho, Wo = -(-image.shape[1] // 2), -(-image.shape[2] // 2)
    ref_h = np.asarray(ref_h[:, :Ho, :Wo], np.float32)
    ref_p = np.asarray(ref_p, np.float32)
    h, p = stem.stem_conv_pool(
        t(image).to(torch.bfloat16),
        t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        t(g), t(b))
    assert h.shape == ref_h.shape and p.shape == ref_p.shape
    for got, ref in ((h, ref_h), (p, ref_p)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=2 ** -8, atol=1e-3)


@pytest.mark.parametrize("slope", [0.0, 0.2, 1.0],
                         ids=["relu", "leaky_relu", "linear"])
def test_stem_plain_slopes_match_pallas(rng, slope):
    """The plain stem at each slope JAX's FusedStemConv sends to its
    Pallas kernel (relu 0, leaky-relu 0.2, linear 1) against
    stem_conv_pallas(negative_slope=slope, pool=True) in interpret mode:
    max(y, slope * y) in both, the same bf16 products summed in f32 in
    other orders, so one bf16 rounding step (2^-8 relative; atol 1e-3
    for values near 0)."""
    model, variables, image = _stem_vars(rng)
    bn, stats = variables["params"]["bn"], variables["batch_stats"]["bn"]
    g = (bn["scale"] / np.sqrt(stats["var"] + 1e-5)).astype(np.float32)
    b = (bn["bias"] - stats["mean"] * g).astype(np.float32)
    kernel = variables["params"]["conv"]["kernel"]
    ref_h, ref_p = stem_conv_pallas(
        jnp.asarray(image), jnp.asarray(kernel), jnp.asarray(g),
        jnp.asarray(b), k=7, negative_slope=slope, pool=True,
        interpret=True)
    Ho, Wo = -(-image.shape[1] // 2), -(-image.shape[2] // 2)
    h, p = stem.stem_conv_pool_plain(
        t(image).to(torch.bfloat16),
        t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))), t(g), t(b),
        slope)
    for got, ref in ((h, np.asarray(ref_h[:, :Ho, :Wo], np.float32)),
                     (p, np.asarray(ref_p, np.float32))):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=2 ** -8, atol=1e-3)
    if slope == 0.0:
        assert float(p.float().min()) >= 0.0
    if slope == 1.0:
        assert float(h.float().min()) < 0.0


@pytest.mark.parametrize("slope", [0.2, 0.0, 1.0],
                         ids=["leaky_relu", "relu", "linear"])
@pytest.mark.parametrize("cin,cout,k", [(1, 8, 7), (3, 16, 3), (3, 64, 7),
                                        (2, 24, 11)])
def test_stem_plain_general_shapes_match_pallas(rng, cin, cout, k, slope):
    """The plain stem (the contract of B1's general kernel) at stem
    widths, input channels and kernel sizes besides (7, 3, 32) against
    stem_conv_pallas(pool=True) in interpret mode, as
    tests/test_pallas_stem.py runs it: the same folded bf16 products
    summed in f32 in other orders, so one bf16 rounding step (2^-8
    relative; atol 1e-3 for values near 0)."""
    image = rng.random((2, 30, 38, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, cin, cout))
              * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32)
    g = (0.5 + rng.random(cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    ref_h, ref_p = stem_conv_pallas(
        jnp.asarray(image), jnp.asarray(kernel), jnp.asarray(g),
        jnp.asarray(b), k=k, negative_slope=slope, pool=True,
        interpret=True)
    Ho, Wo = -(-image.shape[1] // 2), -(-image.shape[2] // 2)
    h, p = stem.stem_conv_pool_plain(
        t(image).to(torch.bfloat16),
        t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))), t(g), t(b),
        slope)
    for got, ref in ((h, np.asarray(ref_h[:, :Ho, :Wo], np.float32)),
                     (p, np.asarray(ref_p, np.float32))):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=2 ** -8, atol=1e-3)
