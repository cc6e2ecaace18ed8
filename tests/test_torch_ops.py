"""The port's plain ops (riders_tpu_torch.ops) against riders_tpu.ops on
the CPU, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.ops import alignment as jalign
from riders_tpu.ops import resize as jresize
from riders_tpu.ops import scale_map as jscale
from riders_tpu_torch.ops import alignment, resize, scale_map

t = torch.from_numpy

# Sizes of the NTU decoder chain (non-x2 steps), a downsample and the
# SML input resize.
RESIZE_CASES = [((4, 1), (9, 3)), ((9, 3), (18, 6)), ((18, 6), (37, 12)),
                ((37, 12), (75, 25)), ((75, 25), (150, 50)),
                ((13, 17), (7, 5)), ((64, 80), (36, 44))]
METHODS = [("nearest", False), ("bilinear", True), ("bilinear", False),
           ("bicubic", False)]


@pytest.mark.parametrize("method,ac", METHODS)
@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize2d_matches_jax(rng, method, ac, src, dst):
    x = rng.random((2,) + src + (3,)).astype(np.float32)
    ref = np.asarray(jresize.resize2d(jnp.asarray(x), dst, method, ac))
    got = resize.resize2d(t(x), dst, method, ac).numpy()
    assert got.shape == ref.shape
    if method == "nearest":
        # a selection: exact
        np.testing.assert_array_equal(got, ref)
    else:
        # separable f32 weights built two ways (float64 matrices in JAX,
        # f32 lambdas in torch) over up to 16 taps of [0, 1] data:
        # agreement to f32 rounding of the tap sums
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_edge_pad_and_net_shape(rng):
    x = rng.random((2, 9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.edge_pad2d(t(x), 4, 3).numpy(),
        np.asarray(jresize.edge_pad2d(jnp.asarray(x), 4, 3)))
    for shape in ((480, 640), (512, 640), (96, 128), (300, 500)):
        for method in ("minimal", "lower_bound", "upper_bound"):
            assert (resize.compute_net_shape(shape, method=method)
                    == jresize.compute_net_shape(shape, method=method))


def _maps(rng, B=3, H=24, W=20):
    d = (0.05 + rng.random((B, H, W))).astype(np.float32)
    sparse = np.where(rng.random((B, H, W)) < 0.1,
                      rng.random((B, H, W)), 0).astype(np.float32)
    valid = (sparse > 0).astype(np.float32)
    rc = np.where(rng.random((B, H, W)) < 0.4,
                  rng.random((B, H, W)), 0).astype(np.float32)
    return d, sparse, valid, rc, (rc > 0).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize_unit_range", "synthesize",
                                "synthesize_rcnet", "grayscale",
                                "normalize_intermediate"])
def test_scale_map_matches_jax(rng, fn):
    d, sparse, valid, rc, rcv = _maps(rng)
    if fn == "normalize_unit_range":
        x = d.copy()
        x[1] = 0.5   # a constant frame takes the guard
        ref = jax.vmap(jscale.normalize_unit_range)(jnp.asarray(x))
        got = scale_map.normalize_unit_range(t(x))
    elif fn.startswith("synthesize"):
        extra = (rc, rcv) if fn == "synthesize_rcnet" else ()
        ref = jax.vmap(jscale.synthesize_scale_map)(
            *map(jnp.asarray, (d, sparse, valid) + extra))
        got = scale_map.synthesize_scale_map(
            *map(t, (d, sparse, valid) + extra))
    elif fn == "grayscale":
        img = rng.random((2, 5, 6, 3)).astype(np.float32)
        ref = jscale.grayscale(jnp.asarray(img))
        got = scale_map.grayscale(t(img))
    else:
        ref = jnp.stack(jscale.normalize_intermediate(jnp.asarray(d),
                                                      jnp.asarray(rc)))
        got = torch.stack(scale_map.normalize_intermediate(t(d), t(rc)))
    # elementwise f32 arithmetic in the same order: rounding-level
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_validity_and_inverse_matches_jax(rng):
    depth = (rng.random((2, 16, 12)) * 140 - 20).astype(np.float32)
    depth[0, 0, :3] = [0.0, 100.0, 99.99]
    inv_r, v_r = jalign.validity_and_inverse(jnp.asarray(depth), 0.0, 100.0)
    inv, v = alignment.validity_and_inverse(t(depth), 0.0, 100.0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(inv_r))


@pytest.mark.parametrize("max_valid", [None, 512])
def test_align_mono_prior_matches_jax(rng, max_valid):
    """Golden-section alignment, dense objective and gathered bucket.
    The 64 iterations converge to ~1e-9 of the interval, so the scales
    agree to f32 rounding of the sums (rtol 1e-5)."""
    B, H, W = 3, 40, 48
    depth = (5 + 40 * rng.random((B, H, W))).astype(np.float32)
    mono = ((1.0 / depth) / 0.05 * (1 + 0.1 * rng.standard_normal(
        (B, H, W)))).astype(np.float32)
    radar = np.zeros((B, H, W), np.float32)
    for b in range(B):
        idx = rng.choice(H * W, 30, replace=False)
        radar[b].flat[idx] = depth[b].flat[idx]
    inv, valid = jalign.validity_and_inverse(jnp.asarray(radar), 0.0, 100.0)
    ref = jax.vmap(lambda m, i, v: jalign.align_mono_prior(
        m, i, v, max_valid=max_valid))(jnp.asarray(mono), inv, valid)
    inv_t, valid_t = alignment.validity_and_inverse(t(radar), 0.0, 100.0)
    got = alignment.align_mono_prior(t(mono), inv_t, valid_t,
                                     max_valid=max_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
