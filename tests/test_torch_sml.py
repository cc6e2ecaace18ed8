"""The port's Scale Map Learner and its EfficientNet-Lite3 backbone
against the JAX models on the CPU in f32, on the JAX model's own random
variables (BatchNorm statistics moved away from 0 / 1) loaded through
models.from_jax.  The bar for f32 module forwards is rtol 1e-4, as in
tests/test_convert_*.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core.config import SMLConfig as JaxSMLConfig
from riders_tpu.models.efficientnet import EfficientNetLite3 as JaxEffNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu_torch.core.config import SMLConfig
from riders_tpu_torch.models.efficientnet import EfficientNetLite3
from riders_tpu_torch.models.from_jax import load_jax_variables, sml_from_jax
from torch_common import TINY_STAGES, TINY_TAPS, perturbed

t = torch.from_numpy


def test_sml_matches_jax(rng):
    jcfg = JaxSMLConfig(net_shape=(64, 96), features=8)
    backbone = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                    backbone_stem=8)
    model = JaxSML(config=jcfg, **backbone)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    d = (0.02 + 0.5 * rng.random((2, 64, 96, 1))).astype(np.float32)
    variables = perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(d)), rng)
    ref_pred, ref_scales = jax.jit(model.apply)(variables, jnp.asarray(x),
                                                jnp.asarray(d))
    port = sml_from_jax(SMLConfig(net_shape=(64, 96), features=8),
                        variables, device="cpu", **backbone)
    with torch.no_grad():
        pred, scales = port(t(x), t(d))
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref_pred),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(scales.numpy(), np.asarray(ref_scales),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 96), (50, 70)])
def test_efficientnet_taps_match_jax(rng, hw):
    """The four taps alone: a wrong TF-SAME split (lower half on the
    top / left) shifts every stride-2 stage and shows up here.  (50, 70)
    also takes the odd-extent pads."""
    model = JaxEffNet(stages=TINY_STAGES, taps=TINY_TAPS, stem_features=8)
    x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    variables = perturbed(jax.jit(model.init)(jax.random.PRNGKey(2),
                                              jnp.asarray(x)), rng)
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = load_jax_variables(
        EfficientNetLite3(3, TINY_STAGES, TINY_TAPS, 8), variables).eval()
    with torch.no_grad():
        taps = port(t(x).permute(0, 3, 1, 2))
    assert len(taps) == len(ref) == 4
    for got, want in zip(taps, ref):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-5)
