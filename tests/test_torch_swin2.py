"""The port's Swin V2 / V1 backbone (riders_tpu_torch.models.swin2) and
its DPT Scale Map Learner against the JAX package's
(riders_tpu.models.swin2, riders_tpu.models.dpt) on the CPU, from the
same variables (`jax.eval_shape` of the JAX model filled from a seeded
numpy generator, test_torch_dpt.py's `seeded`) and the same seeded
numpy inputs.

* the numpy helpers bitwise: relative position index, log coordinate
  table, shift mask;
* V2 and V1 window attention with and without the shift mask, the V2
  logit scale on both sides of its clamp at log(100);
* V2 and V1 blocks with and without a shift, and patch merging;
* backbones at net 64x64 with window 4 (grids 16, 8, 4, 2: stage 2's
  window covers its grid, so it runs unshifted, and stage 3 clamps its
  window to 2), and the indivisible-grid error;
* the whole DPT SML, V2 and V1, one SML training step of the tiny V2
  DPT (loss f32, gradients f64), and a bf16 model that keeps the
  float32 parameters float32.
All f32 comparisons at rtol 1e-4, atol 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models import dpt as jdpt
from riders_tpu.models import swin2 as jswin
from riders_tpu_torch.models import dpt as tdpt
from riders_tpu_torch.models import swin2 as tswin
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.ops.kernels import swin2_attention as tattn
from test_torch_dpt import (check_dpt_step, dpt_forwards, dpt_inputs,
                            jax_variables)

RTOL = 1e-4
PLAN = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
            window_size=4, pretrained_window_sizes=(2, 2, 2, 2))
NET = (64, 64)           # patch grids 16, 8, 4, 2


def plans(version=2, **kw):
    """The same Swin plan in each package's config class."""
    plan = dict(PLAN, version=version, **kw)
    return jswin.Swin2Config(**plan), tswin.Swin2Config(**plan)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("window,pretrained", [(4, 2), (6, 3), (7, 0),
                                               (24, 12)])
def test_swin_helpers_are_jax_s_bitwise(window, pretrained):
    np.testing.assert_array_equal(tattn.rel_pos_index(window, window),
                                  jswin._rel_pos_index(window, window))
    got = tswin._log_coords_table(window, pretrained)
    want = jswin._log_coords_table(window, pretrained)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("hw,window,shift", [((8, 8), 4, 2),
                                             ((12, 8), 4, 2),
                                             ((24, 24), 12, 6)])
def test_shift_mask_is_jax_s_bitwise(hw, window, shift):
    got = tattn.shift_mask(*hw, window, shift)
    want = jswin._shift_mask(*hw, window, shift)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert set(np.unique(got)) == {0.0, -100.0}


def _tokens(rng, B, N, C):
    return rng.standard_normal((B, N, C)).astype(np.float32)


@pytest.mark.parametrize("version", [2, 1])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
def test_window_attention_matches_jax(rng, version, masked):
    """8 windows of 4x4 tokens, C 16, 4 heads; with the mask of an 8x8
    grid shifted by 2 (4 windows a frame, 2 frames).  V2's logit scales
    straddle the clamp: two heads under log(100), two over it."""
    dim, heads, window = 16, 4, 4
    x = _tokens(rng, 8, window * window, dim)
    mask = tattn.shift_mask(8, 8, window, 2) if masked else None
    if version == 2:
        jmod = jswin.WindowAttentionV2(dim, heads, window, 2)
        port = tswin.WindowAttentionV2(dim, heads, window, 2)
    else:
        jmod = jswin.WindowAttentionV1(dim, heads, window)
        port = tswin.WindowAttentionV1(dim, heads, window)
    variables = jax_variables(jmod, rng, x, static=(mask,))
    if version == 2:
        variables["params"]["logit_scale"] = np.log(np.array(
            [3.0, 30.0, 150.0, 900.0], np.float32)).reshape(heads, 1, 1)
    want = jmod.apply(variables, jnp.asarray(x), mask)
    load_jax_variables(port, variables)
    with torch.no_grad():       # the port's attention takes shift and grid
        got = port(torch.from_numpy(x), 2 if masked else 0, (8, 8))
    _close(got.numpy(), want)


@pytest.mark.parametrize("version", [2, 1])
@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_matches_jax(rng, version, shift):
    """A block over an 8x12 grid, window 4, C 16, 2 heads; the shifted
    block rolls the grid and masks across regions."""
    dim, res = 16, (8, 12)
    x = _tokens(rng, 2, res[0] * res[1], dim)
    jmod = jswin.SwinBlockV2(dim, 2, res, 4, shift, 2, version=version)
    variables = jax_variables(jmod, rng, x)
    want = jmod.apply(variables, jnp.asarray(x))
    port = load_jax_variables(
        tswin.SwinBlockV2(dim, 2, res, 4, shift, 2, version=version),
        variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("version", [2, 1])
def test_patch_merging_matches_jax(rng, version):
    """The (0,0), (1,0), (0,1), (1,1) concat order; V1 norms the 4C
    concat, V2 the reduction."""
    res = (6, 8)
    x = _tokens(rng, 2, res[0] * res[1], 8)
    jmod = jswin.PatchMergingV2(16, res, version=version)
    variables = jax_variables(jmod, rng, x)
    want = jmod.apply(variables, jnp.asarray(x))
    port = load_jax_variables(tswin.PatchMergingV2(8, 16, res, version),
                              variables)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("version", [2, 1])
def test_swin_backbone_matches_jax(rng, version):
    """Net 64x64, window 4: stages at grids 16, 8, 4 and 2; stage 2 runs
    unshifted (its window covers the grid) and stage 3 clamps its window
    to 2."""
    jplan, tplan = plans(version)
    assert [w for _, w in tswin.stage_windows(tplan, (16, 16))] == [4, 4, 4,
                                                                     2]
    x = rng.standard_normal((2,) + NET + (3,)).astype(np.float32)
    jmod = jswin.SwinV2Backbone(jplan)
    variables = jax_variables(jmod, rng, x)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = load_jax_variables(tswin.SwinV2Backbone(tplan, NET), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    assert port.out_channels == (8, 16, 32, 64)
    for g, w in zip(got, want):
        assert g.shape[1] == w.shape[-1]
        _close(g.permute(0, 2, 3, 1).numpy(), w)


def test_swin_rejects_indivisible_grids():
    """A 64x88 net: stage 0's 16x22 grid is not a multiple of its window
    4, in both packages; the port says so when it is built, JAX when it
    runs.  A built backbone refuses another input size."""
    jplan, tplan = plans()
    with pytest.raises(ValueError, match="not divisible"):
        jswin.SwinV2Backbone(jplan).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 64, 88, 3)))
    with pytest.raises(ValueError, match="not divisible"):
        tswin.SwinV2Backbone(tplan, (64, 88))
    port = tswin.SwinV2Backbone(tplan, NET)
    with pytest.raises(ValueError, match="grid"):
        port(torch.zeros(1, 3, 64, 96))


def dpt_configs(version=2, net=NET):
    jplan, tplan = plans(version)
    common = dict(net_shape=net, backbone="swin2", features=8,
                  reassemble_channels=(8, 16, 32, 64))
    return (jdpt.DPTConfig(swin2=jplan, **common),
            tdpt.DPTConfig(swin2=tplan, **common))


@pytest.mark.parametrize("version", [2, 1])
def test_swin_dpt_forward_matches_jax(rng, version):
    jconfig, tconfig = dpt_configs(version)
    x, d = dpt_inputs(rng, NET)
    variables = jax_variables(jdpt.DPTScaleMapLearner(config=jconfig), rng,
                              x, d)
    (want_pred, want_scales), (pred, scales) = dpt_forwards(
        jconfig, tconfig, variables, x, d, "f32")
    assert float(scales.std()) > 0.05
    _close(pred, want_pred)
    _close(scales, want_scales)


def test_swin_dpt_sml_step_matches_jax():
    check_dpt_step(*dpt_configs(), np.random.default_rng(13))


def test_bf16_swin_keeps_its_f32_parameters(rng):
    """In a bf16 model the logit scale and the position-bias MLP stay
    float32 with their loaded values (as flax keeps them), and so does
    the head's last conv; everything else is bf16, and the forward
    runs."""
    jconfig, tconfig = dpt_configs()
    x, d = dpt_inputs(rng, NET)
    variables = jax_variables(jdpt.DPTScaleMapLearner(config=jconfig), rng,
                              x, d)
    f32 = tdpt.DPTScaleMapLearner(tconfig, "cpu")
    load_jax_variables(f32, variables)
    bf16 = tdpt.DPTScaleMapLearner(tconfig, "cpu", torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    kept = {k for k, v in bf16.state_dict().items()
            if v.dtype == torch.float32}
    assert kept == {k for k in f32.state_dict() if k.endswith((
        "logit_scale", "cpb_fc1.weight", "cpb_fc1.bias", "cpb_fc2.weight",
        "head_conv3.weight", "head_conv3.bias"))}
    for k in kept:
        assert torch.equal(bf16.state_dict()[k], f32.state_dict()[k]), k
    with torch.no_grad():
        pred, _ = bf16(torch.from_numpy(x), torch.from_numpy(d))
        want, _ = f32(torch.from_numpy(x), torch.from_numpy(d))
    assert pred.dtype == torch.float32 and bool(torch.isfinite(pred).all())
    assert float((pred - want).abs().max() / want.abs().max()) < 0.05
    assert dataclasses.asdict(tconfig.swin2) == dataclasses.asdict(
        jconfig.swin2)
