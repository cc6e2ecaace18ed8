"""The lane-major decoder of the port against the JAX package on the CPU.

Per kernel: the plain versions of B7 (`lane_conv3x3_plain`) and B8
(`lane_upconv2x_plain`) against the Pallas kernels in interpret mode on
the same numpy inputs, within one bf16 rounding step:
|got - want| <= 2^-7 |want| + 1e-3 max|want| (the two sum the same bf16
products in f32 in different orders, then round once).  The JAX kernels
take zero-bordered (H+2, W+2, C, N) maps; their border is stripped and N
moved first before the comparison.

Helpers: the phase compositions and depth_to_space2 exactly (f32), the
nearest resize bitwise.

Decoder: `lane_decode.decode_full` on the port's MultiScaleDecoder
holding a JAX decoder's variables, against JAX's literal bf16 decoder
(phase_tail=False) within 5% of its max, the bar of JAX's own lane tests
(tests/test_lane_decoder.py); at an exact-x2 patch, at NTU's and ZJU's
irregular pyramids, and at a patch batch that is no multiple of 128.
decode_full refuses each decoder `lane_decode.unsupported` names.

The path: `lane_decode.decode_path` is "full" for a bf16 CUDA input in
eval with grad disabled on the decoder decode_full decodes, and
"literal" off any of these; the decoder's forward on each such input
runs `literal` without an error, counts "literal" in
`lane_decode.DECODES`, and equals `literal` bit for bit.  The lane path
itself on the card is in tests/test_torch_cuda.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.models import layers as JL
from riders_tpu.models.rcnet import MultiScaleDecoder as JaxDecoder
from riders_tpu.ops.pallas import lane_decoder as LD
from riders_tpu_torch.models import lane_decode
from riders_tpu_torch.models import layers as TL
from riders_tpu_torch.models.from_jax import load_jax_variables
from riders_tpu_torch.models.lane_decode import DECODES
from riders_tpu_torch.models.rcnet import MultiScaleDecoder
from riders_tpu_torch.ops.kernels import lane_decoder as TLD
from riders_tpu_torch.ops.resize import resize2d
from torch_common import perturbed

N = 128                     # the JAX lane kernels' smallest patch batch
FILTERS = (16, 16, 8, 8, 8)
SKIP_CH = (8, 8, 16, 16)
X_CH = 16


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _from_lane(y):
    """JAX's padded (H+2, W+2, C, N) output -> (N, H, W, C) f32."""
    return np.transpose(np.asarray(y, np.float32)[1:-1, 1:-1], (3, 0, 1, 2))


def _within_one_step(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    bar = 2 ** -7 * np.abs(want) + 1e-3 * np.abs(want).max()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want).max()


def test_lane_conv3x3_plain_two_inputs_matches_pallas(rng):
    H, W, C1, C2, CO = 9, 6, 32, 16, 24
    x1 = rng.standard_normal((N, H, W, C1)).astype(np.float32)
    x2 = rng.standard_normal((N, H, W, C2)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, C1 + C2, CO))).astype(np.float32)
    sc = (0.5 + rng.random(CO)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(CO)).astype(np.float32)
    want = _from_lane(LD.lane_conv3x3(
        [LD.to_lane(jnp.asarray(x1)), LD.to_lane(jnp.asarray(x2))],
        [jnp.asarray(k[:, :, :C1]), jnp.asarray(k[:, :, C1:])],
        jnp.asarray(sc), jnp.asarray(bi), 0.2, interpret=True))
    kt = torch.from_numpy(k)
    got = TLD.lane_conv3x3(
        [torch.from_numpy(x1), torch.from_numpy(x2)],
        [TLD.pack_conv(kt[:, :, :C1]), TLD.pack_conv(kt[:, :, C1:])],
        torch.from_numpy(sc), torch.from_numpy(bi), 0.2)
    assert got.dtype == torch.bfloat16
    _within_one_step(got, want)


def test_lane_conv3x3_plain_linear_one_input_matches_pallas(rng):
    """The output conv's case: one input, scale=None (linear), no
    activation, Co = 4 (the JAX package pads it to 8 for the TPU)."""
    H, W, CI, CO = 8, 5, 32, 4
    x = rng.standard_normal((N, H, W, CI)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, CI, CO))).astype(np.float32)
    kp = np.pad(k, ((0, 0), (0, 0), (0, 0), (0, 8 - CO)))
    want = _from_lane(LD.lane_conv3x3(
        [LD.to_lane(jnp.asarray(x))], [jnp.asarray(kp)], None, None, None,
        interpret=True))[..., :CO]
    got = TLD.lane_conv3x3([torch.from_numpy(x)],
                           [TLD.pack_conv(torch.from_numpy(k))], None, None,
                           None)
    _within_one_step(got, want)


def test_lane_upconv2x_plain_odd_extent_matches_pallas(rng):
    h, w, CI, F = 5, 3, 24, 16
    x = rng.standard_normal((N, h, w, CI)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, CI, F))).astype(np.float32)
    sc = (0.5 + rng.random(F)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(F)).astype(np.float32)
    want = _from_lane(LD.lane_upconv2x(
        LD.to_lane(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(sc),
        jnp.asarray(bi), 0.2, interpret=True))
    got = TLD.lane_upconv2x(torch.from_numpy(x),
                            TLD.pack_upconv(torch.from_numpy(k)),
                            torch.from_numpy(sc), torch.from_numpy(bi), 0.2)
    assert got.shape == (N, 2 * h, 2 * w, F)
    _within_one_step(got, want)


def test_phase_helpers_match_jax_exactly(rng):
    k = rng.standard_normal((3, 3, 6, 5)).astype(np.float32)
    kt = torch.from_numpy(k)
    np.testing.assert_array_equal(
        TL.nearest2x_phase_kernel(kt).numpy(),
        np.asarray(JL.nearest2x_phase_kernel(jnp.asarray(k))))
    np.testing.assert_array_equal(
        TL.phase_compose_3x3(kt).numpy(),
        np.asarray(JL.phase_compose_3x3(jnp.asarray(k))))
    z = rng.standard_normal((2, 3, 4, 5, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.depth_to_space2(torch.from_numpy(z), 3).numpy(),
        np.asarray(JL.depth_to_space2(jnp.asarray(z), 3)))


def test_phase_kernel_is_nearest_then_conv(rng):
    """The composed kernel on the coarse map, then depth_to_space2,
    equals nearest x2 followed by the 3x3 conv (f32, same sums up to
    order)."""
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 4, 6)).astype(np.float32))
    conv = lambda t, kk: torch.nn.functional.conv2d(
        t.permute(0, 3, 1, 2), kk.permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1)
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    want = conv(up, k)
    got = TL.depth_to_space2(conv(x, TL.nearest2x_phase_kernel(k)), 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,out_hw", [
    ((4, 1), (9, 3)), ((18, 6), (37, 12)), ((37, 12), (75, 25)),
    ((7, 3), (15, 6)), ((30, 12), (60, 25)), ((12, 5), (25, 12))])
def test_nearest_resize_matches_jax_lane_resize_bitwise(rng, hw, out_hw):
    """The nearest resize (`ops.resize.resize2d` 'nearest' on an NHWC
    map, which the lane path's gather equals) against JAX's
    `nearest_resize_lane`."""
    x = rng.standard_normal((3,) + hw + (5,)).astype(np.float32)
    want = _from_lane(LD.nearest_resize_lane(LD.to_lane(jnp.asarray(x)),
                                             out_hw))
    got = resize2d(torch.from_numpy(_bf16(x)), out_hw, "nearest")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,out_hw", [
    ((4, 1), (9, 3)), ((18, 6), (37, 12)), ((37, 12), (75, 25)),
    ((7, 3), (15, 6)), ((30, 12), (60, 25)), ((12, 5), (25, 12))])
def test_lane_nearest_gather_equals_resize2d_bitwise(rng, hw, out_hw):
    """decode_full's irregular stages resize in one gather pass: equal to
    `resize2d` 'nearest' bit for bit, and contiguous NHWC for B7."""
    x = torch.from_numpy(_bf16(rng.standard_normal(
        (3,) + hw + (5,)).astype(np.float32))).to(torch.bfloat16)
    got = lane_decode._nearest(x, out_hw)
    assert got.is_contiguous() and got.shape == (3,) + out_hw + (5,)
    assert torch.equal(got, resize2d(x, out_hw, "nearest"))


def _decoder_case(rng, patch, skips_hw, n=N):
    lh, lw = patch[0] // 32, patch[1] // 32
    x = rng.standard_normal((n, lh, lw, X_CH)).astype(np.float32)
    skips = [rng.standard_normal((n, h, w, c)).astype(np.float32)
             for (h, w), c in zip(skips_hw, SKIP_CH)]
    dec = JaxDecoder(FILTERS, patch, 1, "leaky_relu", True,
                     dtype=jnp.bfloat16, phase_tail=False)
    jx, jskips = jnp.asarray(x), [jnp.asarray(s) for s in skips]
    variables = perturbed(dec.init(jax.random.PRNGKey(42), jx, jskips), rng)
    want = np.asarray(dec.apply(variables, jx, jskips), np.float32)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    return variables, nchw(x), [nchw(s) for s in skips], want


def _port_decoder(variables, patch):
    port = MultiScaleDecoder(X_CH, SKIP_CH, FILTERS, patch)
    return load_jax_variables(port, variables).eval()


GEOMETRIES = {
    "x2_64x32": ((64, 32), [(32, 16), (16, 8), (8, 4), (4, 2)]),
    "ntu_150x50": ((150, 50), [(75, 25), (37, 12), (18, 6), (9, 3)]),
    "zju_240x100": ((240, 100), [(120, 50), (60, 25), (30, 12), (15, 6)]),
}
# (geometry, patch batch); 90 is no multiple of the JAX kernels' 128
DECODE_CASES = {"x2_64x32": ("x2_64x32", N), "ntu_150x50": ("ntu_150x50", N),
                "zju_240x100": ("zju_240x100", N),
                "ntu_150x50_n90": ("ntu_150x50", 90)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_lane_decoder_matches_jax_literal_bf16(rng, case):
    geometry, n = DECODE_CASES[case]
    patch, skips_hw = GEOMETRIES[geometry]
    variables, x, skips, want = _decoder_case(rng, patch, skips_hw, n)
    port = _port_decoder(variables, patch)
    with torch.no_grad():
        got = lane_decode.decode_full(port, x, skips)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape == (n,) + patch + (1,)
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.05, rel


def test_decode_full_refuses_a_decoder_it_cannot_decode(rng):
    """decode_full raises ValueError with `unsupported`'s reason on each
    decoder or skip list it does not decode, before any work."""
    x, skips = _inputs(rng, 2)
    refused = [
        (dict(use_batch_norm=False), skips),
        (dict(activation="relu"), skips),
        (dict(n_resolution=2), skips),
        (dict(output_func="upsample"), skips),
        (dict(output_channels=2), skips),
        (dict(output_func="sigmoid"), skips),
        (dict(n_filters=FILTERS[1:], skip_channels=SKIP_CH[1:]),
         skips[1:]),
        ({}, skips[:3]),
        ({}, [torch.zeros(2, SKIP_CH[0], 31, 16)] + skips[1:]),
    ]
    for kw, given in refused:
        dec = _decoder(**kw)
        reason = lane_decode.unsupported(dec, len(given),
                                         tuple(given[0].shape[-2:]))
        assert reason, kw
        with torch.no_grad(), pytest.raises(ValueError) as info:
            lane_decode.decode_full(dec, x, given)
        assert str(info.value) == reason


def test_lane_weights_are_packed_once_and_follow_the_parameters(rng):
    patch, skips_hw = GEOMETRIES["x2_64x32"]
    variables, x, skips, _ = _decoder_case(rng, patch, skips_hw)
    port = _port_decoder(variables, patch)
    decode = lambda: lane_decode.decode_full(port, x, skips)
    with torch.no_grad():
        first = decode()
        packed = {k: id(v[1]) for k, v in port._lane_packed.items()}
        assert len(packed) == 9              # 4 upconvs, 4 fusions, tail
        again = decode()
        assert {k: id(v[1]) for k, v in port._lane_packed.items()} == packed
        torch.testing.assert_close(first, again, rtol=0, atol=0)
        port.output0.conv.weight.mul_(2.0)
        decode()
    assert id(port._lane_packed["tail"][1]) != packed["tail"]


# ---- the path: the lane decode for bf16 inference on the card ----

def _decoder(n_filters=FILTERS, skip_channels=SKIP_CH, **kw):
    """A narrow decoder at the 64x32 geometry, BN statistics moved off
    their initial values."""
    patch = GEOMETRIES["x2_64x32"][0]
    return TL.init_random_(MultiScaleDecoder(X_CH, skip_channels, n_filters,
                                             patch, **kw), 3).eval()


def _inputs(rng, n, dtype=torch.float32, skips_hw=None, skip_ch=SKIP_CH):
    patch, default_hw = GEOMETRIES["x2_64x32"]
    x = torch.from_numpy(rng.standard_normal(
        (n, X_CH, patch[0] // 32, patch[1] // 32)).astype(np.float32))
    skips = [torch.from_numpy(rng.standard_normal(
        (n, c, h, w)).astype(np.float32))
        for (h, w), c in zip(skips_hw or default_hw, skip_ch)]
    return x.to(dtype), [s.to(dtype) for s in skips]


# an input the default decodes in full on the card, and each way off it
ELIGIBLE = dict(dtype=torch.bfloat16, device_type="cuda", training=False,
                grad_enabled=False)
OFF_PATH = {
    "f32": dict(dtype=torch.float32),
    "cpu": dict(device_type="cpu"),
    "train_mode": dict(training=True),
    "grad_enabled": dict(grad_enabled=True),
    "several_resolutions": dict(decoder=dict(n_resolution=2)),
    "no_batch_norm": dict(decoder=dict(use_batch_norm=False)),
    "relu": dict(decoder=dict(activation="relu")),
    "two_output_channels": dict(decoder=dict(output_channels=2)),
    "sigmoid_output": dict(decoder=dict(output_func="sigmoid")),
    "depth_4": dict(decoder=dict(n_filters=FILTERS[1:])),
    "output_not_x2": dict(skip1_hw=(31, 16)),
    "full_resolution_skip": dict(n_skips=5),
}


def _decode_path(decoder=None, n_skips=4, skip1_hw=(32, 16), **kw):
    patch = GEOMETRIES["x2_64x32"][0]
    decoder = decoder or {}
    filters = decoder.pop("n_filters", FILTERS)
    dec = MultiScaleDecoder(X_CH, SKIP_CH[-(len(filters) - 1):], filters,
                            patch, **decoder)
    return lane_decode.decode_path(**dict(ELIGIBLE, **kw), dec=dec,
                                   n_skips=n_skips, skip1_hw=skip1_hw)


def test_default_path_is_full_for_bf16_inference_on_the_card():
    """The choice is a function of what the decoder observes: a bf16
    CUDA input in eval with grad disabled, on the decoder decode_full
    decodes, whatever the patch batch (no multiple-of-128 rule)."""
    assert _decode_path() == "full"


@pytest.mark.parametrize("case", sorted(OFF_PATH))
def test_default_path_is_literal_off_the_lane_decode(case):
    assert _decode_path(**OFF_PATH[case]) == "literal"


X2_HW = GEOMETRIES["x2_64x32"][1]
DEFAULT_LITERAL = {
    "cpu_bf16": dict(dtype=torch.bfloat16),
    "f32": dict(),
    "train_mode": dict(train=True),
    "grad_enabled": dict(grad=True),
    "several_resolutions": dict(decoder=dict(n_resolution=2)),
    "no_batch_norm": dict(decoder=dict(use_batch_norm=False)),
    "relu": dict(decoder=dict(activation="relu")),
    "two_output_channels": dict(decoder=dict(output_channels=2)),
    "sigmoid_output": dict(decoder=dict(output_func="sigmoid")),
    "depth_4": dict(decoder=dict(n_filters=FILTERS[1:],
                                 skip_channels=SKIP_CH[:3]),
                    inputs=dict(skips_hw=X2_HW[:3], skip_ch=SKIP_CH[:3])),
    "output_not_x2": dict(inputs=dict(skips_hw=[(31, 16)] + X2_HW[1:])),
    "full_resolution_skip": dict(
        decoder=dict(skip_channels=(4,) + SKIP_CH),
        inputs=dict(skips_hw=[(64, 32)] + X2_HW, skip_ch=(4,) + SKIP_CH)),
}


@pytest.mark.parametrize("case", sorted(DEFAULT_LITERAL))
def test_default_decoder_takes_the_literal_path_off_the_card(rng, case):
    """The decoder's forward on each input it must not decode in full
    runs the literal path without an error, counts "literal" in DECODES,
    and equals `literal` bit for bit."""
    kw = DEFAULT_LITERAL[case]
    dtype = kw.get("dtype", torch.float32)
    dec = _decoder(**kw.get("decoder", {})).to(dtype)
    if kw.get("train"):
        dec.train()
    forced = copy.deepcopy(dec)
    x, skips = _inputs(rng, 6, dtype, **kw.get("inputs", {}))
    with torch.set_grad_enabled(bool(kw.get("grad"))):
        DECODES.clear()
        got = dec(x, skips)
        assert dict(DECODES) == {"literal": 1}
        want = forced.literal(x, skips)
        assert dict(DECODES) == {"literal": 1}
    for a, b in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        assert a.dtype == dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["full", "literal"])
def test_decodes_counts_each_call_by_path(rng, mode, monkeypatch):
    """The forward counts its path once a call, in eval with grad
    disabled; in train mode it counts "literal".  "full" is reached on
    the CPU by asking `decode_path` as for a bf16 input on the card."""
    real = lane_decode.decode_path
    if mode == "full":
        monkeypatch.setattr(lane_decode, "decode_path",
                            lambda dtype, device, *a: real(
                                torch.bfloat16, "cuda", *a))
    dec = _decoder()
    x, skips = _inputs(rng, N)
    DECODES.clear()
    with torch.no_grad():
        got = dec(x, skips)
        assert dict(DECODES) == {mode: 1}
        want = (lane_decode.decode_full if mode == "full" else
                type(dec).literal)(dec, x, skips)
        assert torch.equal(got, want)
        dec.train()
        dec(x[:4], [s[:4] for s in skips])
    assert dict(DECODES) == ({mode: 1, "literal": 1} if mode != "literal"
                             else {"literal": 2})
