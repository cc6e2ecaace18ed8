"""The port's RoI-pool backward (the plain version of the CUDA kernel,
`ops.patches.roi_max_pool_backward`) and its autograd function against
the JAX package on the CPU.

The JAX training path's rule is the Pallas custom VJP
(`roi_max_pool_pallas_diff`, run here with interpret=True): every bin
sends its cotangent to every element equal to its max.  Without ties
XLA autograd of the max chain agrees with it; with ties (integer
features) only the Pallas rule is the reference.  Sums run in another
order than the Pallas kernel's, so gradients are held at rtol 1e-5,
atol 1e-5 (the bar of tests/test_pallas_parity.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.ops.pallas.roi_pool import (roi_max_pool_pallas_diff,
                                            roi_pool_pyramid_pallas_diff)
from riders_tpu.ops.patches import roi_max_pool as jax_roi_max_pool
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import roi_pool

t = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)


def _centred_boxes(rng, B, K, patch, img_hw):
    ph, pw = patch
    cx = rng.integers(pw // 2, img_hw[1] - pw // 2, (B, K))
    cy = rng.integers(ph // 2, img_hw[0] - ph // 2, (B, K))
    return np.stack([cx - pw // 2, cy - ph // 2, cx + pw // 2,
                     cy + ph // 2], -1).astype(np.float32)


def _port_grad(feature, boxes, scale, out_size, w):
    """d(sum(pool * w))/d(feature) through the port's plain backward."""
    f, b = t(feature), t(boxes)
    pooled = patches.roi_max_pool(f, b, scale, out_size)
    return patches.roi_max_pool_backward(f, b, pooled, t(w), scale).numpy()


def _pallas_grad(feature, boxes, scale, out_size, patch, w):
    return np.asarray(jax.grad(lambda x: jnp.sum(roi_max_pool_pallas_diff(
        x, jnp.asarray(boxes), scale, out_size, patch, interpret=True)
        * w))(jnp.asarray(feature)))


def _xla_grad(feature, boxes, scale, out_size, patch, w):
    return np.asarray(jax.grad(lambda x: jnp.sum(jax.vmap(
        lambda fb, bb: jax_roi_max_pool(fb, bb, scale, out_size, patch))(
            x, jnp.asarray(boxes)) * w))(jnp.asarray(feature)))


@pytest.mark.parametrize("patch,scale,out_size,feat", [
    # ZJU pyramid levels on the padded frame (shrunk extents)
    ((240, 100), 0.5, (120, 50), (150, 120, 4)),
    ((240, 100), 1 / 32., (7, 3), (23, 24, 8)),
    # NTU pyramid levels
    ((150, 50), 0.25, (37, 12), (90, 80, 8)),
    ((150, 50), 1 / 16., (9, 3), (42, 44, 8)),
])
def test_plain_backward_matches_pallas_and_xla(rng, patch, scale, out_size,
                                               feat):
    """Both geometries' scales, standard-normal features (no ties): the
    Pallas rule and XLA autograd agree, and the port matches both."""
    H, W, C = feat
    f = rng.standard_normal((1, H, W, C)).astype(np.float32)
    boxes = _centred_boxes(rng, 1, 3, patch,
                           (int(H / scale), int(W / scale)))
    w = rng.standard_normal((1, 3) + out_size + (C,)).astype(np.float32)
    got = _port_grad(f, boxes, scale, out_size, w)
    np.testing.assert_allclose(
        got, _pallas_grad(f, boxes, scale, out_size, patch, w), **TOL)
    np.testing.assert_allclose(
        got, _xla_grad(f, boxes, scale, out_size, patch, w), **TOL)


def _edge_boxes():
    """Overlapping boxes (identical and shifted by one pixel), boxes at
    the map's corners, one reaching past the bottom-right edge and one
    starting at negative coordinates, all of the patch size (48, 32) and
    for a 64x48 map at scale 0.5."""
    return np.asarray([[[10, 12, 42, 60], [10, 12, 42, 60],
                        [12, 14, 44, 62], [0, 0, 32, 48]],
                       [[64, 80, 96, 128], [80, 100, 112, 148],
                        [-9, -14, 23, 34], [11, 13, 43, 61]]], np.float32)


def test_plain_backward_overlaps_and_edges(rng):
    patch, scale, out_size = (48, 32), 0.5, (24, 16)
    f = rng.standard_normal((2, 64, 48, 8)).astype(np.float32)
    boxes = _edge_boxes()
    w = rng.standard_normal((2, 4) + out_size + (8,)).astype(np.float32)
    got = _port_grad(f, boxes, scale, out_size, w)
    np.testing.assert_allclose(
        got, _pallas_grad(f, boxes, scale, out_size, patch, w), **TOL)
    np.testing.assert_allclose(
        got, _xla_grad(f, boxes, scale, out_size, patch, w), **TOL)


def test_plain_backward_ties_follow_the_pallas_rule(rng):
    """Integer-valued features tie inside most bins: every tied element
    receives the bin's full cotangent, as the Pallas VJP sends it; XLA
    autograd of the max chain splits it instead, so it is not the
    reference here (and must differ, or the case tests nothing)."""
    patch, scale, out_size = (48, 32), 0.5, (24, 16)
    f = np.round(rng.standard_normal((2, 64, 48, 8))).astype(np.float32)
    boxes = _edge_boxes()
    w = rng.standard_normal((2, 4) + out_size + (8,)).astype(np.float32)
    got = _port_grad(f, boxes, scale, out_size, w)
    np.testing.assert_allclose(
        got, _pallas_grad(f, boxes, scale, out_size, patch, w), **TOL)
    xla = _xla_grad(f, boxes, scale, out_size, patch, w)
    assert not np.allclose(got, xla, **TOL)


def test_autograd_function_on_cpu(rng):
    """RoIMaxPool on CPU tensors: the plain forward, the plain backward
    as its gradient, and no gradient for the boxes."""
    scale, out_size = 0.5, (24, 16)
    f = t(rng.standard_normal((2, 64, 48, 8)).astype(np.float32))
    boxes = t(_edge_boxes())
    w = t(rng.standard_normal((2, 4) + out_size + (8,)).astype(np.float32))
    x = f.clone().requires_grad_(True)
    b = boxes.clone().requires_grad_(True)
    out = roi_pool.roi_max_pool_diff(x, b, scale, out_size)
    assert torch.equal(out.detach(),
                       patches.roi_max_pool(f, boxes, scale, out_size))
    (out * w).sum().backward()
    assert b.grad is None
    want = patches.roi_max_pool_backward(f, boxes, out.detach(), w, scale)
    assert torch.equal(x.grad, want)


def _pyramid_inputs(rng, patch, B=2, K=3, Hp=96, Wp=80):
    maps = [rng.standard_normal((B, -(-Hp // 2 ** (i + 1)),
                                 -(-Wp // 2 ** (i + 1)), 4 * (i + 1))
                                ).astype(np.float32) for i in range(5)]
    return maps, _centred_boxes(rng, B, K, patch, (Hp, Wp))


def test_pyramid_gradients_match_the_jax_pyramid(rng):
    """`roi_pool_pyramid` under autograd against jax.grad of the
    differentiable Pallas pyramid (five scales, patch 64x32)."""
    patch = (64, 32)
    maps, boxes = _pyramid_inputs(rng, patch)
    lat, skips = roi_pool_pyramid_pallas_diff(
        jnp.asarray(maps[-1]), [jnp.asarray(m) for m in maps[:-1]],
        jnp.asarray(boxes), patch, interpret=True)
    ws = [rng.standard_normal(o.shape).astype(np.float32)
          for o in [lat] + skips]

    def loss(ms):
        la, sk = roi_pool_pyramid_pallas_diff(ms[-1], list(ms[:-1]),
                                              jnp.asarray(boxes), patch,
                                              interpret=True)
        return sum(jnp.sum(o * w) for o, w in zip([la] + sk, ws))

    want = jax.grad(loss)([jnp.asarray(m) for m in maps])
    xs = [t(m).requires_grad_(True) for m in maps]
    p_lat, p_skips = roi_pool.roi_pool_pyramid(xs[-1], xs[:-1], t(boxes),
                                               patch)
    outs = [p_lat] + p_skips
    for got, ref in zip(outs, [lat] + skips):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    sum((o * t(w)).sum() for o, w in zip(outs, ws)).backward()
    for x, ref in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), **TOL)


def test_pyramid_without_grad_is_the_plain_forward(rng):
    """With grad disabled the pyramid runs the plain pool and builds no
    graph, whatever the inputs require."""
    patch = (64, 32)
    maps, boxes = _pyramid_inputs(rng, patch)
    xs = [t(m).requires_grad_(True) for m in maps]
    with torch.no_grad():
        lat, skips = roi_pool.roi_pool_pyramid(xs[-1], xs[:-1], t(boxes),
                                               patch)
    want = patches.roi_pool_pyramid(t(maps[-1]), [t(m) for m in maps[:-1]],
                                    t(boxes), patch)
    for got, ref in zip([lat] + skips, [want[0]] + want[1]):
        assert got.grad_fn is None and torch.equal(got, ref)
