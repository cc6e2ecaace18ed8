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
from riders_tpu_torch.core.config import RCNetConfig
from riders_tpu_torch.models.efficientnet import EfficientNetLite3
from riders_tpu_torch.models.from_jax import (load_jax_variables,
                                              rcnet_from_jax)
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
