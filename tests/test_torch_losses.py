"""The port's training losses (ops/losses.py) and ground-truth hygiene
ops (ops/outlier.py) against the JAX package on the CPU in f32, at rtol
1e-5, with masks that include empty ones; the loss gradients too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.ops import losses as jl
from riders_tpu.ops import outlier as jo
from riders_tpu_torch.ops import losses as tl
from riders_tpu_torch.ops import outlier as to

t = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-7)


def _maps(rng, shape=(2, 20, 24, 1), holes=0.4):
    pred = (1 + 30 * rng.random(shape)).astype(np.float32)
    target = (1 + 30 * rng.random(shape)).astype(np.float32)
    target[rng.random(shape) < holes] = 0.0
    return pred, target


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()
                                          if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("name", ["l1", "l2", "smoothl1"])
@pytest.mark.parametrize("empty", [False, True], ids=["mask", "empty"])
def test_regression_losses(rng, name, empty):
    pred, target = _maps(rng)
    target[0, :2] = pred[0, :2] + 0.3          # |diff| < beta for smoothl1
    mask = (target > 0).astype(np.float32) * (0.0 if empty else 1.0)
    got = tl._LOSS_FNS[name](t(pred), t(target), t(mask))
    _close(got, jl._LOSS_FNS[name](jnp.asarray(pred), jnp.asarray(target),
                                   jnp.asarray(mask)))
    _close(tl.masked_mean(t(pred), t(mask)),
           jl.masked_mean(jnp.asarray(pred), jnp.asarray(mask)))


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 480])
def test_masked_median(rng, n_valid):
    """The lower middle element over the mask (+inf for an empty mask)."""
    x = rng.standard_normal((1, 20, 24, 1)).astype(np.float32)
    mask = np.zeros(x.size, np.float32)
    mask[rng.permutation(x.size)[:n_valid]] = 1.0
    mask = mask.reshape(x.shape)
    got = tl.masked_median(t(x), t(mask))
    want = jl.masked_median(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [3, 5, 7])
def test_sobel_filters(size):
    for a, b in zip(tl.sobel_filters(size), jl.sobel_filters(size)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("channels,size", [(1, 7), (3, 5)])
def test_sobel_smoothness_loss_and_gradient(rng, channels, size):
    pred, _ = _maps(rng)
    image = rng.random((2, 20, 24, channels)).astype(np.float32)
    weights = rng.random((2, 20, 24, 1)).astype(np.float32)
    x = t(pred).requires_grad_(True)
    sm, ed = tl.sobel_smoothness_loss(x, t(image), t(weights), size)
    jsm, jed = jl.sobel_smoothness_loss(jnp.asarray(pred),
                                        jnp.asarray(image),
                                        jnp.asarray(weights), size)
    _close(sm, jsm)
    _close(ed, jed)
    (sm + ed).backward()
    jg = jax.grad(lambda p: sum(jl.sobel_smoothness_loss(
        p, jnp.asarray(image), jnp.asarray(weights), size)))(
            jnp.asarray(pred))
    _close(x.grad, jg, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("case", ["default", "unsupervised_multiscale",
                                  "no_lidar_smoothl1", "empty_masks"])
def test_sml_loss_and_gradient(rng, case):
    """Every term and the gradient of the total against the output."""
    image, gt_interp = _maps(rng)
    pred, gt_sparse = _maps(rng, holes=0.9)
    kw = dict(loss_func="l1", w_smoothness=0.2, w_lidar_loss=1.5,
              w_edge=0.1, sobel_filter_size=7)
    invalid = gt_interp <= 0
    outputs = [pred]
    if case == "unsupervised_multiscale":
        kw.update(w_unsupervised=0.3)
        outputs = [pred * 0.9, pred]
    elif case == "no_lidar_smoothl1":
        kw.update(w_lidar_loss=0.0, loss_func="smoothl1", w_smoothness=0.0)
    elif case == "empty_masks":
        gt_interp[:] = 0.0
        gt_sparse[:] = 0.0
        invalid[:] = False
    xs = [t(o).requires_grad_(True) for o in outputs]
    arg = xs if len(xs) > 1 else xs[0]
    loss, info = tl.sml_loss(t(image), arg, t(gt_interp), t(gt_sparse),
                             invalid_map_gt=t(invalid), **kw)

    def jloss(outs):
        arg = outs if len(outs) > 1 else outs[0]
        return jl.sml_loss(jnp.asarray(image), arg, jnp.asarray(gt_interp),
                           jnp.asarray(gt_sparse),
                           invalid_map_gt=jnp.asarray(invalid), **kw)

    jouts = [jnp.asarray(o) for o in outputs]
    jloss_value, jinfo = jloss(jouts)
    assert set(info) == set(jinfo)
    for k in info:
        _close(info[k], jinfo[k])
    loss.backward()
    jg = jax.grad(lambda o: jloss(o)[0])(jouts)
    for x, g in zip(xs, jg):
        _close(x.grad, g, rtol=1e-5, atol=1e-10)


def test_weighted_bce_with_logits_and_gradient(rng):
    """Logits up to +-60 (past F.softplus's linear cut-off at 20), a
    validity map with holes."""
    logits = (30 * rng.standard_normal((2, 3, 8, 6, 1))).astype(np.float32)
    logits[0, 0, 0, 0, 0] = 60.0
    logits[0, 0, 0, 1, 0] = -60.0
    labels = (rng.random(logits.shape) < 0.4).astype(np.float32)
    validity = (rng.random(logits.shape) < 0.7).astype(np.float32)
    x = t(logits).requires_grad_(True)
    got = tl.weighted_bce_with_logits(x, t(labels), t(validity), 2.5)
    f = lambda z: jl.weighted_bce_with_logits(
        z, jnp.asarray(labels), jnp.asarray(validity), 2.5)
    _close(got, f(jnp.asarray(logits)))
    got.backward()
    _close(x.grad, jax.grad(f)(jnp.asarray(logits)), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kernel,threshold", [(3, 1.5), (7, 0.5), (5, 3.0)])
def test_remove_outliers(rng, kernel, threshold):
    depth = (5 + 20 * rng.random((2, 1, 30, 26))).astype(np.float32)
    depth[rng.random(depth.shape) < 0.5] = 0.0
    got = to.remove_outliers(t(depth), kernel, threshold)
    want = jo.remove_outliers(jnp.asarray(depth), kernel, threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got.numpy() == 0).sum()) < depth.size


def test_remove_outliers_all_holes():
    depth = np.zeros((1, 1, 9, 9), np.float32)
    np.testing.assert_array_equal(
        to.remove_outliers(t(depth), 3, 1.5).numpy(),
        np.asarray(jo.remove_outliers(jnp.asarray(depth), 3, 1.5)))


@pytest.mark.parametrize("kernel", [1, 2, 3, 4, 7])
def test_dilate_max(rng, kernel):
    """Odd and even windows: an even one grows the map by one, as
    reduce_window with (k // 2, k // 2) padding does."""
    depth = (20 * rng.random((2, 17, 21))).astype(np.float32)
    depth[rng.random(depth.shape) < 0.6] = 0.0
    got = to.dilate_max(t(depth), kernel)
    want = jo.dilate_max(jnp.asarray(depth), kernel)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
