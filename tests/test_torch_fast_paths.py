"""The port's phase-composed fast forms against the JAX package's same
forms and against the port's literal forms, on the CPU:
`UpConvBlock(fast_2x=True)` and `MultiScaleDecoder(phase_tail=True)`, on
the JAX modules' variables (BN statistics moved away from 0 / 1) carried
across by models.from_jax, at the shapes of tests/test_models.py's tests
of these forms; and the SML's output head, which the port keeps literal,
against JAX's literal head (`OutputConv(fast_upsample=False)`).

* f32: against JAX's form at rtol 1e-4 (atol 1e-5 of the output's max
  abs); a fast form also against the port's literal form at the bar of
  JAX's own test of that form (rtol 1e-4 / atol 1e-5 for the upconv,
  rtol 1e-3 / atol 2e-4 for the decoder tail).
* bf16, on variables rounded to bf16 so both packages hold the same
  weights: against JAX's form within one bf16 step (2^-7 of the larger
  magnitude, plus 2^-7 of the output's max abs).
* `None` keeps the literal form off the card (on the card it takes the
  fast form for bf16 `fast_2x` and `phase_tail`, tests/test_torch_cuda.py);
  a target that is not exactly x2 falls back to it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models import layers as jlayers
from riders_tpu.models.rcnet import MultiScaleDecoder as JaxDecoder
from riders_tpu.models.sml import OutputConv as JaxOutputConv
from riders_tpu_torch.models import layers
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.models.rcnet import MultiScaleDecoder
from riders_tpu_torch.models.sml import OutputConv
from torch_common import perturbed

BF16_STEP = 2.0 ** -7


def _to_bf16(variables):
    return jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), variables)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _check(got, want, rtol, atol_rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


def _bf16_close(got, want):
    scale = float(np.abs(want).max())
    limit = BF16_STEP * np.maximum(np.abs(got), np.abs(want)) + \
        BF16_STEP * scale
    assert (np.abs(got - want) <= limit).all(), float(
        np.abs(got - want).max())


def _upconv(rng):
    x = rng.standard_normal((2, 9, 7, 12)).astype(np.float32)
    act = jlayers.activation_fn("leaky_relu")
    variables = perturbed(jax.jit(
        lambda k, x: jlayers.UpConvBlock(16, 3, act, True).init(
            k, x, (18, 14)))(jax.random.PRNGKey(0), jnp.asarray(x)), rng)

    def port(dtype, fast):
        m = layers.UpConvBlock(12, 16, 3, layers.activation_fn("leaky_relu"),
                               True, fast_2x=fast)
        return load_jax_variables(m, variables).to(dtype).eval()

    def jax_fn(v, dtype, x):
        return jax.jit(lambda v, x: jlayers.UpConvBlock(
            16, 3, act, True, dtype=dtype, fast_2x=True).apply(
                v, x, (18, 14)))(v, x)
    return x, variables, port, jax_fn, lambda m, t: m(t, (18, 14))


def _decoder(rng):
    x = rng.standard_normal((3, 4, 4, 24)).astype(np.float32)
    skips = [rng.standard_normal((3, 16, 16, 8)).astype(np.float32),
             rng.standard_normal((3, 8, 8, 16)).astype(np.float32)]
    kw = dict(n_filters=(16, 16, 8), output_shape=(32, 32),
              output_channels=1)
    variables = perturbed(jax.jit(JaxDecoder(phase_tail=False, **kw).init)(
        jax.random.PRNGKey(0), jnp.asarray(x),
        [jnp.asarray(s) for s in skips]), rng)
    t_skips = [torch.from_numpy(s).permute(0, 3, 1, 2) for s in skips]

    def port(dtype, fast):
        m = MultiScaleDecoder(24, [8, 16], (16, 16, 8), (32, 32),
                              phase_tail=fast)
        return load_jax_variables(m, variables).to(dtype).eval()

    def jax_fn(v, dtype, x):
        return jax.jit(JaxDecoder(dtype=dtype, phase_tail=True, **kw).apply)(
            v, x, [jnp.asarray(s, dtype) for s in skips])
    return x, variables, port, jax_fn, lambda m, t: m(
        t, [s.to(t.dtype) for s in t_skips])


FORMS = {"fast_2x": (_upconv, (1e-4, 1e-5)),
         "phase_tail": (_decoder, (1e-3, 2e-4))}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_form_f32_matches_jax_and_literal(form):
    build, literal_bar = FORMS[form]
    x, variables, port, jax_fn, call = build(np.random.default_rng(0))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        fast = _nhwc(call(port(torch.float32, True), t))
        literal = _nhwc(call(port(torch.float32, None), t))
    want = np.asarray(jax_fn(variables, jnp.float32, jnp.asarray(x)))
    assert fast.shape == want.shape
    _check(fast, want, 1e-4, 1e-5)
    _check(fast, literal, *literal_bar)
    assert not np.array_equal(fast, literal)        # the fast form ran


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_form_bf16_matches_jax(form):
    build, _ = FORMS[form]
    x, variables, port, jax_fn, call = build(np.random.default_rng(1))
    variables = _to_bf16(variables)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    with torch.no_grad():
        got = _nhwc(call(port(torch.bfloat16, True),
                         torch.from_numpy(x).permute(0, 3, 1, 2).to(
                             torch.bfloat16)))
    want = np.asarray(jax_fn(variables, jnp.bfloat16,
                             jnp.asarray(x, jnp.bfloat16)), np.float32)
    _bf16_close(got, want)


def test_fast_forms_fall_back_to_the_literal_form():
    """A not-exactly-x2 target and train mode take the literal upconv;
    the decoder tail needs eval; None is the literal form on the CPU."""
    rng = np.random.default_rng(2)
    _, variables, port, _, _ = _upconv(rng)
    fast, literal = port(torch.float32, True), port(torch.float32, None)
    t = torch.from_numpy(rng.standard_normal((2, 12, 9, 7)).astype(
        np.float32))
    with torch.no_grad():
        for shape in ((19, 15), (18, 15)):
            assert torch.equal(fast(t, shape), literal(t, shape))
        assert not torch.equal(fast(t, (18, 14)), literal(t, (18, 14)))
    x, _, dport, _, call = _decoder(rng)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(call(dport(torch.float32, True).train(), t),
                           call(dport(torch.float32, None).train(), t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_form_default_is_literal_on_the_cpu(dtype):
    """`phase_form_on`: a set flag decides; None takes the phase form
    only for bf16 on the card, so never for a CPU tensor."""
    x = torch.zeros(1, dtype=dtype)
    assert layers.phase_form_on(True, x) is True
    assert layers.phase_form_on(False, x) is False
    assert layers.phase_form_on(None, x) is False


@pytest.mark.parametrize("hw", [(15, 21), (72, 88)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_head_matches_jax(dtype, hw):
    """The SML's output head against JAX's literal head in f32 (rtol 1e-4,
    atol 1e-5 of the max) and in bf16 (one bf16 step)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2,) + hw + (64,)).astype(np.float32)
    variables = perturbed(jax.jit(JaxOutputConv(64).init)(
        jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    if dtype == "bfloat16":
        variables = _to_bf16(variables)
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    t_dtype, j_dtype = getattr(torch, dtype), getattr(jnp, dtype)
    head = load_jax_variables(OutputConv(64), variables).to(t_dtype).eval()
    with torch.no_grad():
        got = _nhwc(head(torch.from_numpy(x).permute(0, 3, 1, 2).to(
            t_dtype)))
    want = np.asarray(jax.jit(JaxOutputConv(
        64, dtype=j_dtype, fast_upsample=False).apply)(
            variables, jnp.asarray(x, j_dtype)), np.float32)
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 1)
    if dtype == "float32":
        _check(got, want, 1e-4, 1e-5)
    else:
        _bf16_close(got, want)
