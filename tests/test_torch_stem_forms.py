"""B1's remaining forms against the JAX package on the CPU: the conv map
alone (pool=False), a clip (relu6 is slope 0 with a clip at 6) and
another top/left padding (`lead`; 0 is TF-SAME), the port's plain stem
(the contract of its general kernel, csrc/stem_general.cu) against
`stem_conv_pallas(..., interpret=True)`, and the port's
`FusedStemConv(fuse_pool=False)` against JAX's.  Inputs are made with
numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models.layers import FusedStemConv as JaxStem
from riders_tpu.ops.pallas.stem import stem_conv_pallas
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.models.layers import FusedStemConv
from riders_tpu_torch.ops.kernels import stem

t = torch.from_numpy
# one bf16 rounding step: both sum the same folded bf16 products in f32
# in other orders (test_torch_kernels_plain.py's bar for the stem)
BF16_STEP = dict(rtol=2 ** -8, atol=1e-3)


def _inputs(rng, B, H, W, cin, cout, k, w_scale=None, b_scale=0.1):
    image = rng.random((B, H, W, cin)).astype(np.float32)
    w_scale = (2.0 / (k * k * cin)) ** 0.5 if w_scale is None else w_scale
    kernel = (rng.standard_normal((k, k, cin, cout)) * w_scale
              ).astype(np.float32)
    g = (0.5 + rng.random(cout)).astype(np.float32)
    b = (b_scale * rng.standard_normal(cout)).astype(np.float32)
    return image, kernel, g, b


def _port_plain(image, kernel, g, b, slope, **form):
    return stem.stem_conv_pool_plain(
        t(image).to(torch.bfloat16),
        t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))), t(g), t(b),
        slope, **form)


def _close(got, ref):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16_STEP)


@pytest.mark.parametrize("slope", [0.2, 0.0, 1.0],
                         ids=["leaky_relu", "relu", "linear"])
@pytest.mark.parametrize("cin,cout,k", [(3, 16, 3), (1, 8, 7), (3, 32, 7)])
def test_stem_without_pool_matches_pallas(rng, cin, cout, k, slope):
    """pool=False: the conv map alone, as JAX's stem_conv_pallas returns
    it (its canvas sliced to the conv extent)."""
    image, kernel, g, b = _inputs(rng, 2, 30, 38, cin, cout, k)
    ref = stem_conv_pallas(jnp.asarray(image), jnp.asarray(kernel),
                           jnp.asarray(g), jnp.asarray(b), k=k,
                           negative_slope=slope, pool=False, interpret=True)
    Ho, Wo = -(-image.shape[1] // 2), -(-image.shape[2] // 2)
    got = _port_plain(image, kernel, g, b, slope, pool=False)
    _close(got, np.asarray(ref[:, :Ho, :Wo], np.float32))


@pytest.mark.parametrize("pool", [False, True], ids=["map", "pooled"])
def test_stem_relu6_tf_same_matches_pallas(rng, pool):
    """JAX's efficientnet case (tests/test_pallas_stem.py): B=2, 64x96,
    Cin 3 -> 16, k = 3, relu6 (slope 0, clip 6), lead=0; its inputs are
    scaled as there, so that the clip binds on part of the map."""
    B, H, W, cin, cout, k = 2, 64, 96, 3, 16, 3
    image = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, cin, cout)) * 0.5
              ).astype(np.float32)
    g = (0.5 + rng.random(cout)).astype(np.float32)
    b = (rng.standard_normal(cout) * 2.0).astype(np.float32)
    ref = stem_conv_pallas(jnp.asarray(image), jnp.asarray(kernel),
                           jnp.asarray(g), jnp.asarray(b), k=3,
                           negative_slope=0.0, clip_max=6.0, lead=0,
                           pool=pool, block_rows=8, interpret=True)
    got = _port_plain(image, kernel, g, b, 0.0, pool=pool, clip_max=6.0,
                      lead=0)
    if pool:
        ref, ref_p = ref
        _close(got[1], np.asarray(ref_p, np.float32))
        got = got[0]
    ref = np.asarray(ref[:, :H // 2], np.float32)
    _close(got, ref)
    assert (ref == 6.0).any() and (ref == 0.0).any()
    assert float(got.float().max()) == 6.0


@pytest.mark.parametrize("cin,cout,k,hw", [
    (3, 16, 3, (30, 38)), (3, 32, 7, (31, 37)), (1, 8, 11, (26, 40))])
def test_stem_lead_zero_with_pool_matches_pallas(rng, cin, cout, k, hw):
    """lead=0 (no top/left padding, the zero tail below and to the
    right) with the fused pool, at even and odd extents."""
    image, kernel, g, b = _inputs(rng, 2, *hw, cin, cout, k)
    ref, ref_p = stem_conv_pallas(
        jnp.asarray(image), jnp.asarray(kernel), jnp.asarray(g),
        jnp.asarray(b), k=k, lead=0, pool=True, interpret=True)
    Ho, Wo = -(-hw[0] // 2), -(-hw[1] // 2)
    h, p = _port_plain(image, kernel, g, b, 0.2, lead=0)
    _close(h, np.asarray(ref[:, :Ho, :Wo], np.float32))
    _close(p, np.asarray(ref_p, np.float32))


def _stem_vars(rng, k=3, cout=16, H=34, W=46, B=2):
    """JAX's FusedStemConv(fuse_pool=False) variables, the BN statistics
    and affine made from `rng`."""
    image = rng.random((B, H, W, 3)).astype(np.float32)
    model = JaxStem(cout, k, "leaky_relu", True)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0),
                                          jnp.asarray(image)))
    bn = variables["batch_stats"]["bn"]
    bn["mean"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    bn["var"] = (0.5 + rng.random(cout)).astype(np.float32)
    variables["params"]["bn"]["scale"] = (0.8 + 0.4 * rng.random(cout)
                                          ).astype(np.float32)
    variables["params"]["bn"]["bias"] = (0.1 * rng.standard_normal(cout)
                                         ).astype(np.float32)
    return model, variables, image


@pytest.mark.parametrize("k,cout", [(3, 16), (7, 32)])
def test_fused_stem_without_pool_matches_jax_f32(rng, k, cout):
    """f32: the port's FusedStemConv(fuse_pool=False) against JAX's
    literal conv -> BN -> leaky-relu; one map, no pooled one.  The same
    operations in other orders: rtol 1e-4."""
    model, variables, image = _stem_vars(rng, k, cout)
    ref = model.apply(variables, jnp.asarray(image))
    port = load_jax_variables(FusedStemConv(3, cout, kernel_size=k),
                              variables).eval()
    assert not port.fuse_pool
    with torch.no_grad():
        h = port(t(image))
    assert isinstance(h, torch.Tensor)
    np.testing.assert_allclose(h.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k,cout", [(3, 16), (7, 32)])
def test_fused_stem_without_pool_matches_pallas_bf16(rng, k, cout):
    """bf16 eval: the port's FusedStemConv(fuse_pool=False) (the plain
    stem on the CPU, the BN's statistics folded in) against
    stem_conv_pallas(pool=False) in interpret mode on the same folded
    scale and bias: one bf16 step."""
    model, variables, image = _stem_vars(rng, k, cout)
    bn, stats = variables["params"]["bn"], variables["batch_stats"]["bn"]
    g = (bn["scale"] / np.sqrt(stats["var"] + 1e-5)).astype(np.float32)
    b = (bn["bias"] - stats["mean"] * g).astype(np.float32)
    ref = stem_conv_pallas(
        jnp.asarray(image), jnp.asarray(variables["params"]["conv"]
                                        ["kernel"]),
        jnp.asarray(g), jnp.asarray(b), k=k, pool=False, interpret=True)
    Ho, Wo = -(-image.shape[1] // 2), -(-image.shape[2] // 2)
    port = load_jax_variables(FusedStemConv(3, cout, kernel_size=k),
                              variables).eval()
    with torch.no_grad():
        h = port(t(image).to(torch.bfloat16))
    _close(h.permute(0, 2, 3, 1), np.asarray(ref[:, :Ho, :Wo], np.float32))


@pytest.mark.parametrize("cin,cout,k,form,kind", [
    (3, 32, 7, {}, "stem"), (3, 32, 7, dict(pool=False), "stem_general"),
    (3, 16, 3, dict(pool=False, clip_max=6.0, lead=0), "stem_general"),
    (8, 20, 5, dict(lead=1), "stem_general")])
def test_stem_apply_runs_cpu_weights_on_the_plain_version(rng, cin, cout, k,
                                                          form, kind):
    """`stem_weights` of CPU weights names the kernel that would serve the
    shape and form on the card and packs nothing; `stem_apply` of a CPU
    image is then the plain version, bit for bit, as is
    `stem_conv_pool`."""
    image, kernel, g, b = _inputs(rng, 2, 21, 26, cin, cout, k)
    x = t(image).to(torch.bfloat16)
    w = t(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    sw = stem.stem_weights(w, t(g), t(b), **form)
    assert sw.kind == kind
    assert sw.weight is None and sw.bias is None and sw.plan is None
    want = stem.stem_conv_pool_plain(x, w, t(g), t(b), 0.2, **form)
    for got in (stem.stem_apply(x, sw, 0.2),
                stem.stem_conv_pool(x, w, t(g), t(b), 0.2, **form)):
        if not form.get("pool", True):
            got, want_ = (got,), (want,)
        else:
            want_ = want
        for a, c in zip(got, want_):
            assert torch.equal(a, c)


def test_fused_stem_keeps_its_weights_on_cpu(rng):
    """bf16 eval on the CPU: `FusedStemConv` keeps its `stem_weights`
    while the parameters and statistics stay, and makes them anew after
    an in-place change (the BN's running mean); its output follows."""
    x = t(rng.random((2, 30, 44, 3)).astype(np.float32)).to(torch.bfloat16)
    mod = FusedStemConv(3, 16, fuse_pool=True).to(torch.bfloat16).eval()
    with torch.no_grad():
        first = mod(x)
        kept = mod._packed["stem"]
        assert kept[1].kind == "stem_general"
        again = mod(x)
        assert mod._packed["stem"] is kept
        mod.bn.running_mean.add_(0.5)
        moved = mod(x)
        assert mod._packed["stem"] is not kept
    for a, b, c in zip(first, again, moved):
        assert torch.equal(a, b) and not torch.equal(a, c)
