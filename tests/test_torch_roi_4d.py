"""The port's 4D RoI pool (B6's plain version, `roi_max_pool_4d`) against
the JAX package's `roi_max_pool_pallas4d` in interpret mode, bitwise, on
a map and on a _NEG-padded canvas read over its true extent (as
tests/test_pallas_parity.py holds the Pallas kernel); and the 4D pyramid
against the port's `roi_pool_pyramid`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from riders_tpu.ops.pallas.roi_pool import (_NEG, roi_max_pool_pallas4d,
                                            roi_window_pad)
from riders_tpu_torch.ops import patches
from riders_tpu_torch.ops.kernels import roi_pool

t = torch.from_numpy


def _boxes(rng, B, K, img_h, img_w, patch):
    ph, pw = patch
    cx = rng.integers(pw // 2, img_w - pw // 2, (B, K))
    cy = rng.integers(ph // 2, img_h - ph // 2, (B, K))
    return np.stack([cx - pw // 2, cy - ph // 2, cx + pw // 2,
                     cy + ph // 2], -1).astype(np.float32)


@pytest.mark.parametrize("patch,scale,out_size,feat", [
    ((240, 100), 0.5, (120, 50), (180, 110, 8)),      # ZJU skip1, cut
    ((240, 100), 1 / 32., (7, 3), (23, 24, 16)),      # ZJU latent
    ((150, 50), 0.25, (37, 12), (66, 73, 8)),         # NTU skip2, cut
    ((150, 50), 1 / 16., (9, 3), (42, 44, 16)),       # NTU skip4
])
@pytest.mark.parametrize("canvas", [False, True], ids=["map", "canvas"])
def test_roi_max_pool_4d_plain_matches_pallas4d(rng, patch, scale, out_size,
                                                feat, canvas):
    H, W, C = feat
    B, K = 2, 5
    f = rng.standard_normal((B, H, W, C)).astype(np.float32)
    boxes = _boxes(rng, B, K, int(H / scale), int(W / scale), patch)
    if canvas:
        win_h, win_w = roi_window_pad(patch, scale, C)
        x = np.full((B, H + win_h, W + win_w, C), _NEG, np.float32)
        x[:, :H, :W] = f
        hw = (H, W)
    else:
        x, hw = f, None
    want = roi_max_pool_pallas4d(jnp.asarray(x), jnp.asarray(boxes), scale,
                                 out_size, patch, interpret=True, true_hw=hw)
    got = roi_pool.roi_max_pool_4d(t(x), t(boxes), scale, out_size, hw)
    assert got.shape == (B, K) + out_size + (C,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roi_max_pool_4d_canvas_at_edges_and_refusals(rng):
    """Boxes at and past the true extent on a canvas: the padding never
    enters a bin (it is never read), exactly as if the map were cut out;
    a canvas smaller than its true extent is refused."""
    H, W, C = 20, 14, 4
    f = rng.standard_normal((1, H, W, C)).astype(np.float32)
    x = np.full((1, H + 9, W + 11, C), 5.0, np.float32)    # not _NEG
    x[:, :H, :W] = f
    boxes = np.asarray([[[0, 0, 16, 24], [20, 28, 36, 52],
                         [30, 44, 46, 68]]], np.float32)
    got = roi_pool.roi_max_pool_4d(t(x), t(boxes), 0.5, (6, 4), (H, W))
    want = patches.roi_max_pool(t(f), t(boxes), 0.5, (6, 4))
    assert torch.equal(got, want)
    assert not bool(got[0, 2].any())                       # empty bins
    with pytest.raises(ValueError, match="smaller"):
        roi_pool.roi_max_pool_4d(t(f), t(boxes), 0.5, (6, 4), (H + 1, W))


def test_roi_pool_pyramid_4d_matches_pyramid(rng):
    """Every scale, skips[0] once as a map and once as a canvas with
    skip1_true_hw, equals the port's roi_pool_pyramid (bf16 maps)."""
    patch, B, K = (64, 32), 2, 6
    Hp, Wp = 100, 90
    maps, h, w = [], Hp, Wp
    for c in (8, 16, 16, 16, 16):
        h, w = -(-h // 2), -(-w // 2)
        maps.append(t(rng.standard_normal((B, h, w, c)).astype(np.float32)
                      ).to(torch.bfloat16))
    boxes = t(_boxes(rng, B, K, Hp, Wp, patch))
    want_lat, want_sk = patches.roi_pool_pyramid(maps[-1], maps[:-1], boxes,
                                                 patch)
    s1 = maps[0]
    canvas = torch.full((B, s1.shape[1] + 7, s1.shape[2] + 13, 8), _NEG,
                        dtype=torch.bfloat16)
    canvas[:, :s1.shape[1], :s1.shape[2]] = s1
    for skip1, hw in ((s1, None), (canvas, tuple(s1.shape[1:3]))):
        lat, sk = roi_pool.roi_pool_pyramid_4d(maps[-1], [skip1] + maps[1:-1],
                                               boxes, patch, hw)
        assert torch.equal(lat, want_lat)
        assert len(sk) == len(want_sk)
        assert all(torch.equal(a, b) for a, b in zip(sk, want_sk))
