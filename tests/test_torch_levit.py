"""The port's LeViT-384 backbone (riders_tpu_torch.models.levit) and its
DPT Scale Map Learner against the JAX package's (riders_tpu.models.levit,
riders_tpu.models.dpt) on the CPU, from the same variables
(`jax.eval_shape` of the JAX model filled from a seeded numpy generator,
test_torch_dpt.py's `seeded`) and the same seeded numpy inputs, at
tests/test_convert_levit.py's narrow widths:

* the bias index bitwise, square and odd grids, stride 1 and 2;
* the attention (per-head interleaved qkv, offset biases) and the
  subsample on an odd 5x7 grid (queries from a ceil 3x4 grid);
* the backbone's three taps at net 80x112 (token grids 5x7, 3x4, 2x2);
* the whole DPT SML at that net: the 3-level decode, the hard-swish
  ConvTranspose layers and the narrow head, whose 74x106 map is resized
  to the 80x112 prior (align_corners=True); and at 64x64, where the
  transposed convs land at 58x58;
* the net the backbone was built for is the only one it takes.
All f32 comparisons at rtol 1e-4, atol 1e-4.  The JAX model applies a
hard-swish after its fourth stem conv, where timm's stem_b16 (and
tests/test_convert_levit.py's twin) has none and the port follows timm
(ROADMAP.md C): the tests against JAX give the port's stem that
activation (`jax_stem`); the port against the twin is
test_torch_convert.py's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from riders_tpu.models import dpt as jdpt
from riders_tpu.models import levit as jlevit
from riders_tpu_torch.models import dpt as tdpt
from riders_tpu_torch.models import levit as tlevit
from riders_tpu_torch.models.from_jax import load_jax_variables
from test_torch_dpt import dpt_forwards, dpt_inputs, jax_variables

RTOL = 1e-4
PLAN = dict(embed_dims=(16, 24, 32), key_dim=4, num_heads=(2, 3, 4),
            depths=(2, 2, 2), attn_ratio=2, down_attn_ratio=4,
            hooks=(1, 7, 13))
NET = (80, 112)            # token grids 5x7, 3x4, 2x2


@pytest.fixture
def jax_stem(monkeypatch):
    """The port's stem with the JAX model's hard-swish after its fourth
    conv."""
    timm = tlevit.LeViTBackbone.stem
    monkeypatch.setattr(tlevit.LeViTBackbone, "stem",
                        lambda self, x: F.hardswish(timm(self, x)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("grid_q,grid_kv,stride", [
    ((4, 4), (4, 4), 1), ((5, 7), (5, 7), 1), ((3, 4), (5, 7), 2),
    ((7, 7), (14, 14), 2)])
def test_bias_index_is_jax_s_bitwise(grid_q, grid_kv, stride):
    got = tlevit._bias_idxs(tlevit._grid_points(*grid_q),
                            tlevit._grid_points(*grid_kv), stride)
    want = jlevit._bias_idxs(jlevit._grid_points(*grid_q),
                             jlevit._grid_points(*grid_kv), stride)
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


def _tokens(rng, grid, C, B=2):
    return rng.standard_normal((B, grid[0] * grid[1], C)).astype(np.float32)


def test_levit_attention_matches_jax(rng):
    """16 channels, key dim 4, 2 heads (qkv interleaved per head: q, k,
    v of head 0, then of head 1), on an odd 5x7 grid."""
    grid = (5, 7)
    x = _tokens(rng, grid, 16)
    jmod = jlevit.LeViTAttention(16, 4, 2, 2, grid)
    variables = jax_variables(jmod, rng, x)
    variables["params"]["attention_biases"] *= 20
    port = load_jax_variables(tlevit.LeViTAttention(16, 4, 2, 2, grid),
                              variables)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(),
               jmod.apply(variables, jnp.asarray(x)))


def test_levit_subsample_on_an_odd_grid_matches_jax(rng):
    """16 -> 24 channels, 4 heads: queries from x[::2, ::2] of the 5x7
    grid (3x4), keys and values from all 35 tokens."""
    grid = (5, 7)
    x = _tokens(rng, grid, 16)
    jmod = jlevit.LeViTSubsample(16, 24, 4, 4, 4, grid)
    variables = jax_variables(jmod, rng, x)
    variables["params"]["attention_biases"] *= 20
    want = jmod.apply(variables, jnp.asarray(x))
    port = load_jax_variables(tlevit.LeViTSubsample(16, 24, 4, 4, 4, grid),
                              variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 12, 24)
    _close(got.numpy(), want)


def test_levit_backbone_taps_match_jax(rng, jax_stem):
    x = rng.standard_normal((2,) + NET + (3,)).astype(np.float32)
    jmod = jlevit.LeViTBackbone(jlevit.LeViTConfig(**PLAN))
    variables = jax_variables(jmod, rng, x)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = load_jax_variables(tlevit.LeViTBackbone(
        tlevit.LeViTConfig(**PLAN), NET), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert port.out_channels == (16, 24, 32)
    assert [tuple(g.shape[2:]) for g in got] == [(5, 7), (3, 4), (2, 2)]
    assert len(want) == 3
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def dpt_configs(net=NET):
    common = dict(net_shape=net, backbone="levit", hooks=PLAN["hooks"],
                  reassemble_channels=PLAN["embed_dims"], features=16,
                  head_features_1=4, head_features_2=4)
    return (jdpt.DPTConfig(levit=jlevit.LeViTConfig(**PLAN), **common),
            tdpt.DPTConfig(levit=tlevit.LeViTConfig(**PLAN), **common))


@pytest.mark.parametrize("net", [NET, (64, 64)], ids=["80x112", "64x64"])
def test_levit_dpt_forward_matches_jax(rng, net, jax_stem):
    """The head's map (74x106 at 80x112, 58x58 at 64x64) is resized to
    the prior's shape in both packages."""
    jconfig, tconfig = dpt_configs(net)
    x, d = dpt_inputs(rng, net)
    variables = jax_variables(jdpt.DPTScaleMapLearner(config=jconfig), rng,
                              x, d)
    # the narrow head (4 channels) varies little at `seeded`'s scale
    variables["params"]["head_conv3"]["kernel"] *= np.float32(100.0)
    (want_pred, want_scales), (pred, scales) = dpt_forwards(
        jconfig, tconfig, variables, x, d, "f32")
    assert pred.shape == want_pred.shape == d.shape
    assert float(scales.std()) > 0.05
    _close(pred, want_pred)
    _close(scales, want_scales)


def test_levit_takes_only_its_net():
    """The bias tables are sized by the token grid of the net the model
    was built for; another input raises instead of misindexing."""
    _, tconfig = dpt_configs()
    model = tdpt.DPTScaleMapLearner(tconfig, "cpu")
    with pytest.raises(ValueError, match="grid"):
        model(torch.zeros(1, 96, 112, 3), torch.ones(1, 96, 112, 1))
    with pytest.raises(ValueError, match="hooks"):
        tlevit.LeViTBackbone(tlevit.LeViTConfig(**dict(PLAN, hooks=(1, 40,
                                                                    41))))


def test_levit_stem_is_timm_s(rng):
    """Four 3x3 / 2 convs with hard-swish between them and none after the
    last (timm's stem_b16)."""
    x = torch.from_numpy(rng.standard_normal((2, 3) + NET).astype(
        np.float32))
    port = tlevit.LeViTBackbone(tlevit.LeViTConfig(**PLAN), NET)
    with torch.no_grad():
        h = x
        for j in (0, 2, 4, 6):
            h = getattr(port, f"stem_conv{j}")(h)
            want = h
            h = F.hardswish(h)
        assert torch.equal(port.stem(x), want)
