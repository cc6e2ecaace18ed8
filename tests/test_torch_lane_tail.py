"""The port's lane tail (MultiScaleDecoder(lane_mode="tail")) against the
JAX package's own lane tail, its Pallas kernels in interpret mode, on the
same variables and numpy inputs (exact-x2 64x32 patch, N = 128).  Both
run the literal decoder to deconv2 and the same packed bf16 weights from
deconv1 on; the JAX literal stages run in bf16 and the port's (an f32
model on the CPU) in f32, so the two differ by bf16 roundings of the
deconv2 map: the bar is 2% of the output's max.  Its own file so that
the test workers spread it (the interpret-mode tail takes about a
minute)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models.rcnet import MultiScaleDecoder as JaxDecoder
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.models.rcnet import MultiScaleDecoder
from torch_common import perturbed

N, PATCH = 128, (64, 32)
SKIPS_HW = [(32, 16), (16, 8), (8, 4), (4, 2)]
FILTERS, SKIP_CH, X_CH = (16, 16, 8, 8, 8), (8, 8, 16, 16), 16


def test_lane_tail_matches_jax_lane_tail(rng):
    x = rng.standard_normal((N, 2, 1, X_CH)).astype(np.float32)
    skips = [rng.standard_normal((N, h, w, c)).astype(np.float32)
             for (h, w), c in zip(SKIPS_HW, SKIP_CH)]
    jx, jskips = jnp.asarray(x), [jnp.asarray(s) for s in skips]
    dec = JaxDecoder(FILTERS, PATCH, 1, "leaky_relu", True,
                     dtype=jnp.bfloat16, phase_tail=False, lane_mode="tail")
    variables = perturbed(dec.init(jax.random.PRNGKey(7), jx, jskips), rng)
    want = np.asarray(dec.apply(variables, jx, jskips), np.float32)

    port = load_jax_variables(
        MultiScaleDecoder(X_CH, SKIP_CH, FILTERS, PATCH, lane_mode="tail"),
        variables).eval()
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(nchw(x), [nchw(s) for s in skips])
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape == (N,) + PATCH + (1,)
    rel = np.abs(got - want).max() / np.abs(want).max()
    print("port tail vs JAX tail, max abs / max:", rel)
    assert rel < 0.02, rel
