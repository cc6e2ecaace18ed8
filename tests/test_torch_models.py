"""RC-Net and the JAX-variable loader of the port against the JAX package
on the CPU in f32: the JAX model's own randomly initialised variables (with
BatchNorm statistics moved away from 0 / 1) are loaded into the port
through models.from_jax, and both run the same numpy inputs.  The bar
for f32 module forwards is rtol 1e-4, as in tests/test_convert_*.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core.config import RCNetConfig as JaxRCNetConfig
from riders_tpu.models.efficientnet import EfficientNetLite3 as JaxEffNet
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.rcnet import ResNetEncoder as JaxEncoder
from riders_tpu_torch.core.config import RCNetConfig
from riders_tpu_torch.models.efficientnet import EfficientNetLite3
from riders_tpu_torch.models.from_jax import (load_jax_variables,
                                              rcnet_from_jax)
from riders_tpu_torch.models.rcnet import ResNetEncoder
from torch_common import NARROW_RCNET, TINY_STAGES, perturbed, rcnet_inputs

t = torch.from_numpy


@pytest.mark.parametrize("patch", [(64, 32), (70, 38)],
                         ids=["div32", "not_div32"])
def test_rcnet_matches_jax(rng, patch):
    """Logits and masked responses.  (70, 38) pools to a (2, 1) latent and
    decodes through non-x2 resizes (8, 4) -> (17, 9) -> (35, 19), as the
    NTU geometry (150, 50) does."""
    jcfg = JaxRCNetConfig(patch_size=patch, **NARROW_RCNET)
    model = JaxRCNet(config=jcfg)
    image, pts, boxes, mask = rcnet_inputs(rng, patch)
    args = tuple(map(jnp.asarray, (image, pts, boxes, mask)))
    variables = perturbed(jax.jit(model.init)(jax.random.PRNGKey(0), *args),
                          rng)
    apply = jax.jit(model.apply, static_argnames="return_logits")
    ref_logits = np.asarray(apply(variables, *args))
    ref_resp = np.asarray(apply(variables, *args, return_logits=False))

    port = rcnet_from_jax(RCNetConfig(patch_size=patch, **NARROW_RCNET),
                          variables, device="cpu")
    with torch.no_grad():
        logits = port(*map(t, (image, pts, boxes, mask)))
        resp = port(*map(t, (image, pts, boxes, mask)), return_logits=False)
    assert logits.shape == ref_logits.shape == (2, 4) + patch + (1,)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(resp.numpy(), ref_resp, rtol=1e-4, atol=1e-6)


def test_from_jax_rejects_unused_and_missing_leaves(rng):
    model = JaxEffNet(stages=TINY_STAGES[:2], taps=(0, 1), stem_features=8)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))))
    port = EfficientNetLite3(3, TINY_STAGES[:2], (0, 1), 8)
    load_jax_variables(port, variables)        # exact tree: loads
    extra = jax.tree.map(lambda a: a, variables)
    extra["params"]["stray"] = {"kernel": np.zeros((1, 1, 8, 8), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(port, extra)
    short = jax.tree.map(lambda a: a, variables)
    del short["batch_stats"]["bn_stem"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(port, short)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["relu", "linear"])
def test_encoder_stem_activations_match_jax(rng, activation, dtype):
    """The encoder with the stem activations besides leaky-relu that JAX's
    stem sends to its kernel (slope 0 and 1), from the same variables.
    f32: the library conv -> BN -> activation path on both sides, rtol
    1e-4 with atol 1e-5 of the map's max (with no activation the maps
    grow to ~10, and values that cancel to near 0 keep that much f32
    error).  bf16 eval: JAX on the CPU takes its literal branch, the port
    the stem kernel's plain version (BN folded, max(y, slope y)); both
    round at other places through nine convolutions, so each output is
    held to 5% of its max, the lane decoder's bar."""
    filters = NARROW_RCNET["n_filters_encoder_image"]
    image = rng.random((2, 46, 58, 3)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    model = JaxEncoder(filters, activation, dtype=jdt)
    variables = perturbed(model.init(jax.random.PRNGKey(1),
                                     jnp.asarray(image)), rng)
    ref_lat, ref_skips = model.apply(variables, jnp.asarray(image))
    port = load_jax_variables(ResNetEncoder(filters, activation),
                              variables).to(getattr(torch, dtype)).eval()
    with torch.no_grad():
        lat, skips = port(t(image).to(getattr(torch, dtype)))
    errs = []
    for got, ref in zip([lat] + skips, [ref_lat] + list(ref_skips)):
        got = got.permute(0, 2, 3, 1).float().numpy()
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape and np.isfinite(got).all()
        if dtype == "float32":
            np.testing.assert_allclose(
                got, ref, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(ref).max()))
        else:
            errs.append(np.abs(got - ref).max() / np.abs(ref).max())
    assert all(e <= 0.05 for e in errs), errs
