"""RC-Net in every form the JAX package builds, the port against the JAX
package on the CPU: the BN-free stem, other stem widths and input
channels, the multi-resolution decoder (depths 5-7, output functions,
several output channels), `return_all_scales`, the transposed-conv,
bottleneck and VGG blocks, softmax LoFTR attention and masks, the
decoder converter's multi-resolution output convs, and a training step of
the BN-free multi-resolution model.  JAX's own initialised variables
(BatchNorm statistics and affine terms moved away from 0 / 1 by
`perturbed`) are loaded through `models.from_jax`, and both packages run
the same numpy inputs.  f32 module forwards are held to rtol 1e-4, as in
tests/test_convert_*.py; each test states its atol."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.models import attention as jatt
from riders_tpu.models import convert as jconvert
from riders_tpu.models import layers as jlayers
from riders_tpu.models.rcnet import MultiScaleDecoder as JaxDecoder
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.rcnet import ResNetEncoder as JaxEncoder
from riders_tpu.pipelines import rcnet_training as jrt
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.models import attention as tatt
from riders_tpu_torch.models import convert as tconvert
from riders_tpu_torch.models import layers as tlayers
from riders_tpu_torch.models.from_jax import (load_jax_variables,
                                              load_state, rcnet_from_jax,
                                              torch_state_from_jax)
from riders_tpu_torch.models.rcnet import (MultiScaleDecoder, RCNet,
                                          ResNetEncoder)
from riders_tpu_torch.pipelines import rcnet_training as trt
from torch_common import NARROW_RCNET, perturbed, rcnet_inputs

t = torch.from_numpy
PATCH = (64, 32)


def _nchw(a):
    return t(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


def _variables(model, rng, *args):
    """Variables of the JAX model's shapes (traced with `jax.eval_shape`,
    not run: flax's init of an RC-Net compiles for tens of seconds),
    LeCun-normal kernels (flax's default), unit scales and zero biases,
    then `perturbed`."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)
                    ).astype(np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(
            s.shape, np.float32)
    return perturbed(jax.tree_util.tree_map_with_path(fill, shapes), rng)


def _jax_rcnet(rng, **overrides):
    """A JAX RC-Net at the narrow widths, its perturbed variables and
    its inputs (a one-channel frame where the config says so)."""
    cfg = dict(NARROW_RCNET, patch_size=PATCH)
    cfg.update(overrides)
    model = JaxRCNet(config=jconfig.RCNetConfig(**cfg))
    image, pts, boxes, mask = rcnet_inputs(rng, PATCH)
    image = image[..., :cfg.get("input_channels_image", 3)].copy()
    args = tuple(map(jnp.asarray, (image, pts, boxes, mask)))
    return cfg, model, _variables(model, rng, *args), (image, pts, boxes,
                                                        mask)


# ---- the stem: no BN, other widths and input channels (ROADMAP C1) --------

@pytest.mark.parametrize("overrides", [
    dict(use_batch_norm=False),
    dict(n_filters_encoder_image=(16, 16, 32, 32, 32)),
    dict(input_channels_image=1)], ids=["no_bn", "stem16", "cin1"])
def test_rcnet_stem_variants_match_jax(rng, overrides):
    """`rcnet_from_jax` loads each variant (without BN the stem holds no
    BN, as JAX's has none), and logits and responses agree at rtol 1e-4
    (atol 1e-5 / 1e-6)."""
    cfg, model, variables, inputs = _jax_rcnet(rng, **overrides)
    both = jax.jit(lambda v, *a: (model.apply(v, *a), model.apply(
        v, *a, return_logits=False)))
    ref_logits, ref_resp = map(np.asarray, both(
        variables, *map(jnp.asarray, inputs)))
    port = rcnet_from_jax(tconfig.RCNetConfig(**cfg), variables,
                          device="cpu")
    assert (port.encoder_image.conv1.bn is None) == (
        not cfg.get("use_batch_norm", True))
    with torch.no_grad():
        logits = port(*map(t, inputs))
        resp = port(*map(t, inputs), return_logits=False)
    assert logits.shape == ref_logits.shape == (2, 4) + PATCH + (1,)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(resp.numpy(), ref_resp, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("filters,cin,use_bn", [
    ((8, 16, 32, 32, 32), 3, False), ((16, 16, 32, 32, 32), 3, True),
    ((8, 16, 32, 32, 32), 1, True)], ids=["no_bn", "stem16", "cin1"])
def test_encoder_stem_variants_bf16_match_jax(rng, filters, cin, use_bn):
    """bf16 eval: JAX on the CPU takes its literal branch, the port the
    stem kernel's plain version (BN folded, or scale 1 and bias 0 without
    BN); both round at other places through nine convolutions, so each
    output is held to 5% of its max, the bar of
    test_torch_models.py::test_encoder_stem_activations_match_jax."""
    image = rng.random((2, 46, 58, cin)).astype(np.float32)
    model = JaxEncoder(filters, "leaky_relu", use_bn, dtype=jnp.bfloat16)
    variables = _variables(model, rng, jnp.asarray(image))
    ref_lat, ref_skips = model.apply(variables, jnp.asarray(image))
    port = load_jax_variables(
        ResNetEncoder(filters, "leaky_relu", use_bn, in_ch=cin),
        variables).to(torch.bfloat16).eval()
    with torch.no_grad():
        lat, skips = port(t(image).to(torch.bfloat16))
    for got, ref in zip([lat] + skips, [ref_lat] + list(ref_skips)):
        got = _nhwc(got.float())
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def test_fused_stem_kernel_sizes_match_the_library_path(rng):
    """A BN-free stem at k = 3, 5, 7, 11: bf16 eval (the kernel's plain
    version, scale 1 and bias 0, for k % 4 == 3; the library conv for k
    = 5, as JAX's Pallas condition routes) and the train-mode library
    path give the same maps, to bf16 rounding (2^-6 of the max).  Which
    path ran shows on the card (test_torch_cuda.py)."""
    image = t(rng.random((2, 23, 30, 3)).astype(np.float32)).to(
        torch.bfloat16)
    for k in (3, 5, 7, 11):
        stem = tlayers.init_random_(tlayers.FusedStemConv(
            3, 8, use_batch_norm=False, kernel_size=k, fuse_pool=True)).to(
                torch.bfloat16).eval()
        assert stem.bn is None and stem.conv.kernel_size == (k, k)
        with torch.no_grad():
            h, p = stem(image)
            stem.train()
            lh, lp = stem(image)
        assert h.shape == lh.shape == (2, 8, 12, 15)
        assert p.shape == lp.shape == (2, 8, 6, 8)
        for a, b in ((h, lh), (p, lp)):
            a, b = a.float(), b.float()
            assert bool(((a - b).abs() <= 2 ** -6 * b.abs().max()).all())


# ---- the multi-resolution decoder ------------------------------------------

def _decoder_inputs(rng, depth, deep):
    """x (2, 2, 2, 24) and skips shallow -> deep, each twice the next:
    depth - 1 skips (deconv0 upsamples to the output shape) or, `deep`,
    depth skips (deconv0 takes skips[0])."""
    x = rng.standard_normal((2, 2, 2, 24)).astype(np.float32)
    channels = [4, 4, 4, 4, 8, 8, 16][-(depth if deep else depth - 1):]
    n = len(channels)
    skips = [rng.standard_normal(
        (2, 2 ** (n + 1 - i), 2 ** (n + 1 - i), c)).astype(np.float32)
        for i, c in enumerate(channels)]
    out_hw = 2 ** (n + 1) if deep else 2 ** depth
    return x, skips, (out_hw, out_hw)


@pytest.mark.parametrize("depth,n_res,output_func,out_ch,deep", [
    (6, 1, "linear", 1, False), (7, 3, "sigmoid", 1, False),
    (5, 1, "linear_upsample", 1, False), (5, 2, "linear", 1, False),
    (5, 4, "linear", 1, False), (5, 1, "linear", 2, False),
    (5, 3, "linear", 1, True)],
    ids=["d6", "d7_res3_sigmoid", "linear_upsample", "res2", "res4",
         "out2", "res3_deep"])
def test_multiscale_decoder_matches_jax(rng, depth, n_res, output_func,
                                        out_ch, deep):
    """Each output of the list form (a single-resolution decoder's one
    map as a list of one) at rtol 1e-4, atol 1e-5 of the output's max:
    depths 6 and 7 (deconv5 / deconv6), sigmoid output convs, output0 as
    the bilinear x2 of output1, n_resolution 2-4, two output channels,
    and a pyramid as deep as the decoder (deconv0 takes skips[0] and the
    upsampled output1)."""
    x, skips, out_shape = _decoder_inputs(rng, depth, deep)
    n_filters = (16, 16, 16, 8, 8, 8, 8)[:depth]
    kw = dict(output_channels=out_ch, activation="leaky_relu",
              use_batch_norm=True, n_resolution=n_res,
              output_func=output_func)
    model = JaxDecoder(n_filters, out_shape, phase_tail=False, **kw)
    jx, jskips = jnp.asarray(x), [jnp.asarray(s) for s in skips]
    variables = _variables(model, rng, jx, jskips)
    ref = model.apply(variables, jx, jskips)
    ref = list(ref) if isinstance(ref, (list, tuple)) else [ref]
    port = load_jax_variables(MultiScaleDecoder(
        24, [s.shape[-1] for s in skips], n_filters, out_shape, **kw),
        variables).eval()
    with torch.no_grad():
        got = port(_nchw(x), [_nchw(s) for s in skips])
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(ref) == max(n_res, 2 if "upsample" in
                                       output_func else 1)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert _nhwc(a).shape == b.shape and b.shape[-1] == out_ch
        np.testing.assert_allclose(_nhwc(a), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


def test_decoder_refuses_an_n_resolution_outside_its_depth():
    """n_resolution runs from 1 to depth - 1, as in the JAX package."""
    for n_resolution in (0, 5):
        with pytest.raises(ValueError, match="n_resolution"):
            MultiScaleDecoder(64, [8, 16, 32, 32], n_resolution=n_resolution)


def test_rcnet_all_scales_match_jax(rng):
    """`return_all_scales=True` with n_resolution 3: the deep -> shallow
    list of three masked logit maps at rtol 1e-4 (atol 1e-5), each twice
    the last; the default return is the list's last, bit for bit."""
    cfg, model, variables, inputs = _jax_rcnet(rng, n_resolution=3)
    ref = jax.jit(lambda v, *a: model.apply(v, *a, return_all_scales=True))(
        variables, *map(jnp.asarray, inputs))
    port = rcnet_from_jax(tconfig.RCNetConfig(**cfg), variables,
                          device="cpu")
    with torch.no_grad():
        got = port(*map(t, inputs), return_all_scales=True)
        last = port(*map(t, inputs))
    assert len(got) == len(ref) == 3
    assert got[-1].shape == (2, 4) + PATCH + (1,)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    for a, b in zip(got, got[1:]):
        assert (2 * a.shape[2], 2 * a.shape[3]) == b.shape[2:4]
    assert torch.equal(last, got[-1])


def test_multiresolution_needs_a_pyramid_of_doublings(rng):
    """At a patch whose pooled pyramid does not double from scale to
    scale (70 x 38 -> 17 x 9 -> 35 x 19, as NTU's 150 x 50 does), the x2
    upsampled output2 cannot be concatenated to the next skip: both
    packages raise for n_resolution 3."""
    cfg = dict(NARROW_RCNET, patch_size=(70, 38), n_resolution=3)
    model = JaxRCNet(config=jconfig.RCNetConfig(**cfg))
    inputs = rcnet_inputs(rng, (70, 38))
    with pytest.raises(Exception):
        jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       *map(jnp.asarray, inputs))
    port = tlayers.init_random_(RCNet(tconfig.RCNetConfig(**cfg), "cpu"))
    with pytest.raises(RuntimeError), torch.no_grad():
        port(*map(t, inputs))


def test_entry_points_take_a_multiresolution_rcnet(tmp_path, monkeypatch):
    """A BN-free n_resolution 3 RC-Net through every entry point that
    takes one, on the CPU: the CLI's train-rcnet (the trainer and its
    driver, two steps), run-rcnet (the staged path and its driver) and
    val-rcnet on the drivers' mini-dataset, and `make_fused_fn` on the
    trained weights: each consumes the full-resolution output, so each
    writes or returns finite depth of the frame's shape."""
    import os
    import test_torch_cli as tc
    from riders_tpu_torch.core import checkpoint as tckpt
    from riders_tpu_torch.io import depthio
    from riders_tpu_torch.models.sml import ScaleMapLearner
    from riders_tpu_torch.pipelines.fused import make_fused_fn

    def mini(root="", **_):
        cfg = tc._mini_config(root)
        return cfg.replace(rcnet=dataclasses.replace(
            cfg.rcnet, use_batch_norm=False, n_resolution=3))

    root = str(tmp_path)
    tc.make_mini_dataset(root, ["scene-a", "scene-b"])
    monkeypatch.setattr(tconfig, "zju_config", mini)
    ckpt, out = os.path.join(root, "ckpt"), os.path.join(root, "out")
    assert tc.run(root, "train-rcnet", "--ckpt", ckpt,
                  "--max-steps", "2") == 0
    assert tckpt.all_steps(ckpt) == [2]
    assert tc.run(root, "run-rcnet", "--ckpt", ckpt, "--output", out,
                  "--threshold", "0.3") == 0
    pred = os.path.join(out, "rcnet_0.3", "scene-b", "depth_predicted")
    depth = depthio.load_depth(os.path.join(pred, sorted(os.listdir(pred))[0]))
    assert depth.shape == (96, 128) and np.isfinite(depth).all()
    assert tc.run(root, "val-rcnet", "--ckpt", ckpt) == 0

    cfg = mini(root)
    rcnet = tckpt.restore_model(ckpt, RCNet(cfg.rcnet, "cpu"))
    assert rcnet.decoder.n_resolution == 3 and hasattr(rcnet.decoder,
                                                      "output2")
    sml = tlayers.init_random_(ScaleMapLearner(cfg.sml, "cpu", **tc.BACKBONE))
    g = np.random.default_rng(3)
    pts = np.stack([g.integers(0, 128, (2, 16)), g.integers(0, 96, (2, 16)),
                    5 + 30 * g.random((2, 16))], -1).astype(np.float32)
    batch = dict(image=g.random((2, 96, 128, 3)).astype(np.float32),
                 mono_pred=(0.5 + g.random((2, 96, 128))).astype(np.float32),
                 radar_points=pts, point_mask=np.ones((2, 16), np.float32))
    depth = make_fused_fn(cfg, rcnet, sml, device="cpu")(batch)
    assert depth.shape == (2, 96, 128) and bool(torch.isfinite(depth).all())


# ---- the blocks -------------------------------------------------------------

def _blocks():
    act_j = jlayers.activation_fn("leaky_relu")
    act_t = tlayers.activation_fn("leaky_relu")
    return {
        "transpose_conv": (
            jlayers.TransposeConvBlock(12, 3, act_j, True),
            tlayers.TransposeConvBlock(6, 12, 3, act_t, True), False),
        "decoder_transpose": (
            jlayers.DecoderBlock(12, act_j, True, "transpose"),
            tlayers.DecoderBlock(6, 5, 12, act_t, True, "transpose"), True),
        "bottleneck": (
            jlayers.ResNetBottleneckBlock(4, 2, act_j, True),
            tlayers.ResNetBottleneckBlock(6, 4, 2, act_t, True), False),
        "vgg": (
            jlayers.VGGBlock(10, 3, 2, act_j, True),
            tlayers.VGGBlock(6, 10, 3, 2, act_t, True), False)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["transpose_conv", "decoder_transpose",
                                  "bottleneck", "vgg"])
def test_blocks_match_jax(rng, name, train):
    """Outputs at rtol 1e-4 (atol 1e-5 of the max); in train mode the
    BatchNorms normalise over the batch and the running statistics after
    the call match too (rtol 1e-4, atol 1e-4 of their max).  The
    transposed conv's output is exactly twice its input."""
    jblock, tblock, with_skip = _blocks()[name]
    x = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 14, 18, 5)).astype(np.float32)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(skip),) if with_skip else ())
    variables = _variables(jblock, rng, *jargs)
    port = load_jax_variables(tblock, variables).train(train)
    if train:
        ref, updates = jblock.apply(variables, *jargs, train=True,
                                    mutable=["batch_stats"])
    else:
        ref = jblock.apply(variables, *jargs)
    with torch.no_grad():
        got = port(_nchw(x), _nchw(skip)) if with_skip else port(_nchw(x))
    ref = np.asarray(ref)
    if name in ("transpose_conv", "decoder_transpose"):
        assert ref.shape[1:3] == (14, 18)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    if train:
        want = torch_state_from_jax(
            {"batch_stats": jax.device_get(updates["batch_stats"])})
        state = port.state_dict()
        for key, w in want.items():
            np.testing.assert_allclose(state[key].numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)


# ---- attention --------------------------------------------------------------

def _masks(rng, n, l, s):
    """Query and key masks with zeros, every key row keeping a valid
    key."""
    qm = (rng.random((n, l)) > 0.3).astype(np.float32)
    km = (rng.random((n, s)) > 0.4).astype(np.float32)
    km[:, 0] = 1.0
    return qm, km


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masks"])
def test_full_attention_matches_jax(rng, masked):
    """Softmax attention at rtol 1e-4 (atol 1e-6).  With both masks, a
    query row whose own mask is 0 has every logit at -inf and is NaN in
    both packages; the valid rows agree."""
    n, l, s, h, d = 3, 7, 5, 2, 8
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((n, l, h, d), (n, s, h, d), (n, s, h, d)))
    qm, km = _masks(rng, n, l, s) if masked else (None, None)
    qm_j = None if qm is None else jnp.asarray(qm)
    km_j = None if km is None else jnp.asarray(km)
    ref = np.asarray(jatt.full_attention(*map(jnp.asarray, (q, k, v)),
                                         qm_j, km_j))
    got = tatt.full_attention(t(q), t(k), t(v),
                              None if qm is None else t(qm),
                              None if km is None else t(km)).numpy()
    if masked:
        dead = qm == 0
        assert dead.any() and np.isnan(ref[dead]).all()
        assert np.isnan(got[dead]).all()
        got, ref = got[~dead], ref[~dead]
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masks"])
@pytest.mark.parametrize("kind", ["linear", "full"])
def test_loftr_layer_matches_jax(rng, kind, masked):
    """One encoder layer of each kind at rtol 1e-4 (atol 1e-5).  Linear
    attention takes both masks (zeros in each); full attention takes a
    key mask with zeros and an all-valid query mask, so that every row
    keeps a valid key (a fully masked row is NaN on both sides,
    test_full_attention_matches_jax)."""
    n, l, s, c = 3, 6, 9, 32
    x = rng.standard_normal((n, l, c)).astype(np.float32)
    src = rng.standard_normal((n, s, c)).astype(np.float32)
    xm, sm = _masks(rng, n, l, s)
    if kind == "full":
        xm = np.ones_like(xm)
    layer = jatt.LoFTREncoderLayer(c, 4, kind)
    variables = _variables(layer, rng, jnp.asarray(x), jnp.asarray(src))
    margs = (jnp.asarray(xm), jnp.asarray(sm)) if masked else ()
    ref = np.asarray(layer.apply(variables, jnp.asarray(x),
                                 jnp.asarray(src), *margs))
    port = load_jax_variables(tatt.LoFTREncoderLayer(c, 4, kind), variables)
    with torch.no_grad():
        got = port(t(x), t(src), *((t(xm), t(sm)) if masked else ()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_local_feature_transformer_full_attention_matches_jax(rng):
    """The self / cross stack with softmax attention and key masks on
    both streams (each stream's mask also masks its queries in the self
    layers, so both keep every token valid in the query role: all-ones
    masks except the keys'); rtol 1e-4, atol 1e-5."""
    n, l0, l1, c = 2, 5, 6, 32
    f0 = rng.standard_normal((n, l0, c)).astype(np.float32)
    f1 = rng.standard_normal((n, l1, c)).astype(np.float32)
    m0, m1 = np.ones((n, l0), np.float32), np.ones((n, l1), np.float32)
    stack = jatt.LocalFeatureTransformer(c, 4, ("self", "cross"), 2, "full")
    args = tuple(map(jnp.asarray, (f0, f1, m0, m1)))
    variables = _variables(stack, rng, *args)
    r0, r1 = stack.apply(variables, *args)
    port = load_jax_variables(tatt.LocalFeatureTransformer(
        c, 4, ("self", "cross"), 2, "full"), variables)
    with torch.no_grad():
        g0, g1 = port(*map(t, (f0, f1, m0, m1)))
    for a, b in ((g0, r0), (g1, r1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


# ---- the converter's multi-resolution output convs -------------------------

def test_decoder_converter_maps_multiresolution_outputs(rng):
    """A synthetic reference decoder state dict with `decoder.output{1,2,
    3}`: the port's converter loads into a port decoder with n_resolution
    4 and equals, leaf by leaf, JAX's converter loaded through
    `from_jax`."""
    n_filters = (16, 16, 16, 8, 8)
    skip_ch = [4, 4, 8, 8]
    dec = MultiScaleDecoder(24, skip_ch, n_filters, (32, 32),
                            n_resolution=4)
    sd = {}
    for key, v in dec.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        ref = "decoder." + key.replace(".bn.", ".batch_norm.")
        sd[ref] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if key.endswith("running_var"):
            sd[ref] = np.abs(sd[ref]) + 0.5
    assert {f"decoder.output{r}.conv.weight" for r in (1, 2, 3)} <= set(sd)
    port_state = {k[len("decoder."):]: v for k, v in
                  tconvert.convert_rcnet_decoder_state_dict(sd).items()}
    dec_p, dec_s = jconvert.convert_rcnet_decoder_state_dict(sd)
    jax_state = torch_state_from_jax({"params": dec_p, "batch_stats": dec_s},
                                     dec)
    assert set(port_state) == set(jax_state)
    for key in port_state:
        np.testing.assert_array_equal(port_state[key], jax_state[key],
                                      err_msg=key)
    load_state(dec, port_state)


# ---- training ---------------------------------------------------------------

def test_bn_free_multiresolution_step_matches_jax(rng):
    """One training step of the BN-free, n_resolution 3 RC-Net in f32 at
    the bars of test_torch_training.py: loss and aux at rtol 1e-4, every
    gradient at rtol 1e-4 with atol 1e-4 of the tensor's max abs (1e-10
    of the largest gradient where a tensor's is 0 up to rounding)."""
    import test_torch_training as tt
    overrides = dict(NARROW_RCNET, patch_size=PATCH, use_batch_norm=False,
                     n_resolution=3)
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.ntu_config()
        cfgs.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=tt.FRAME),
            rcnet=dataclasses.replace(cfg.rcnet, **overrides)))
    jcfg, tcfg = cfgs
    model = JaxRCNet(config=jcfg.rcnet)
    batch = tt._rcnet_batch(rng)
    variables = _variables(model, rng, *[
        jnp.asarray(batch[k])
        for k in ("image", "points", "boxes", "point_mask")])
    assert "batch_stats" not in variables
    stash = tt._grad_stash()
    jstate = jrt.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"], batch_stats={},
                            opt_state=stash.init(variables["params"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new, aux = jax.jit(jrt.make_rcnet_train_step(jcfg, model, stash))(
        jstate, jbatch)
    port = rcnet_from_jax(tcfg.rcnet, variables, device="cpu")
    state = trt.init_rcnet_train_state(tcfg, port, tt.STEPS_PER_EPOCH)
    state, port_aux = trt.make_rcnet_train_step(tcfg)(state, batch)
    tt._check_aux(port_aux, aux)
    tt._check_grads(port, new.opt_state)
