"""The port's Next-ViT backbone (riders_tpu_torch.models.next_vit) and its
DPT Scale Map Learner against the JAX package's
(riders_tpu.models.next_vit, riders_tpu.models.dpt) on the CPU, from the
same variables (`jax.eval_shape` of the JAX model filled from a seeded
numpy generator, test_torch_dpt.py's `seeded`) and the same seeded numpy
inputs, at tests/test_convert_next_vit.py's narrow plan:

* the ceil average pool (count_include_pad=False) on odd maps;
* E-MHSA with its 1-D key / value pool over sr^2 consecutive tokens on
  token counts that sr^2 does not divide (the tail dropped), and with
  sr 1;
* NCBlock (stride 2 on an odd map, and a change of width) and NTBlock;
* the backbone's four taps and the whole DPT SML at net 52x76 (maps
  13x19, 7x10, 4x5, 2x3), the hooks taken from NextViTConfig.
All f32 comparisons at rtol 1e-4, atol 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models import dpt as jdpt
from riders_tpu.models import next_vit as jnv
from riders_tpu_torch.models import dpt as tdpt
from riders_tpu_torch.models import next_vit as tnv
from riders_tpu_torch.models.from_jax import load_jax_variables
from test_torch_dpt import dpt_forwards, dpt_inputs, jax_variables

RTOL = 1e-4
PLAN = dict(depths=(1, 2, 5, 2),
            stage_chans=((32,), (48, 128), (64, 64, 64, 64, 128),
                         (96, 128)),
            stem_chs=(16, 8, 16), head_dim=16, sr_ratios=(8, 4, 2, 1),
            hooks=(0, 2, 7, 9))
NET = (52, 76)             # maps 13x19, 7x10, 4x5, 2x3


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=RTOL)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(7, 9), (8, 5), (6, 10), (1, 3)])
def test_ceil_avgpool_matches_jax(rng, hw):
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    want = jnv._avgpool2x2_ceil(jnp.asarray(x))
    got = tnv.avgpool2x2_ceil(_nchw(x))
    assert got.shape[2:] == want.shape[1:3] == ((hw[0] + 1) // 2,
                                                (hw[1] + 1) // 2)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n,sr", [(70, 4), (37, 2), (20, 1), (9, 3)])
def test_emhsa_matches_jax(rng, n, sr):
    """32 channels, 2 heads of 16; N = 70 with sr^2 = 16 keeps 4 groups
    and drops 6 tokens, N = 9 with sr^2 = 9 keeps one."""
    x = rng.standard_normal((2, n, 32)).astype(np.float32)
    jmod = jnv.EMHSA(32, sr, 16)
    variables = jax_variables(jmod, rng, x)
    port = load_jax_variables(tnv.EMHSA(32, sr, 16), variables)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)).numpy(),
               jmod.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("block,in_ch,out_ch,stride", [
    ("ncb", 32, 32, 1), ("ncb", 16, 48, 2), ("ntb", 48, 128, 1),
    ("ntb", 64, 128, 2)])
def test_blocks_match_jax(rng, block, in_ch, out_ch, stride):
    """On a 7x9 map: NCBlock as the identity embed and as the stride-2
    pool + conv; NTBlock (96 E-MHSA channels at sr 2, 32 MHCA) with a
    width change and with stride 2."""
    x = rng.standard_normal((2, 7, 9, in_ch)).astype(np.float32)
    if block == "ncb":
        jmod = jnv.NCBlock(in_ch, out_ch, stride, 3, 16)
        port = tnv.NCBlock(in_ch, out_ch, stride, 3, 16)
    else:
        jmod = jnv.NTBlock(in_ch, out_ch, 2, stride, 0.75, 2, 16)
        port = tnv.NTBlock(in_ch, out_ch, 2, stride, 0.75, 2, 16)
    variables = jax_variables(jmod, rng, x)
    load_jax_variables(port, variables)
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), jmod.apply(variables, jnp.asarray(x)))


def test_next_vit_backbone_matches_jax(rng):
    x = rng.standard_normal((2,) + NET + (3,)).astype(np.float32)
    jmod = jnv.NextViTBackbone(jnv.NextViTConfig(**PLAN))
    variables = jax_variables(jmod, rng, x)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = load_jax_variables(tnv.NextViTBackbone(
        tnv.NextViTConfig(**PLAN)), variables)
    with torch.no_grad():
        got = port(_nchw(x))
    assert port.out_channels == (32, 128, 128, 128)
    assert [tuple(g.shape[2:]) for g in got] == [(13, 19), (7, 10), (4, 5),
                                                 (2, 3)]
    assert len(want) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w)


def test_next_vit_dpt_forward_matches_jax(rng):
    """DPTConfig.hooks differs from NextViTConfig.hooks here; both
    packages take the backbone's."""
    common = dict(net_shape=NET, backbone="next_vit", hooks=(5, 6, 7, 8),
                  reassemble_channels=(32, 128, 128, 128), features=16,
                  head_features_2=4)
    jconfig = jdpt.DPTConfig(next_vit=jnv.NextViTConfig(**PLAN), **common)
    tconfig = tdpt.DPTConfig(next_vit=tnv.NextViTConfig(**PLAN), **common)
    x, d = dpt_inputs(rng, NET)
    variables = jax_variables(jdpt.DPTScaleMapLearner(config=jconfig), rng,
                              x, d)
    (want_pred, want_scales), (pred, scales) = dpt_forwards(
        jconfig, tconfig, variables, x, d, "f32")
    assert float(scales.std()) > 0.05
    _close(pred, want_pred)
    _close(scales, want_scales)


@pytest.mark.parametrize("out_ch,ratio", [(1024, 0.75), (128, 0.75),
                                          (95, 0.75), (100, 0.7)])
def test_mhsa_channels_are_the_model_s(out_ch, ratio):
    want = jnv._make_divisible(int(out_ch * ratio))
    assert tnv.mhsa_channels(out_ch, ratio) == want
    assert tnv._make_divisible(out_ch * ratio) == jnv._make_divisible(
        out_ch * ratio)
