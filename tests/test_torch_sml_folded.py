"""The port's W-folded SML path (riders_tpu_torch.ops.fold,
riders_tpu_torch.models.sml_folded) against the JAX package's
(riders_tpu/ops/fold.py, riders_tpu/models/sml_folded.py) on the CPU.

* The fold round trip; `fold_conv_kernel` bit for bit against JAX's.
* `folded_conv`, `folded_depthwise` and `folded_pointwise` against JAX's
  functions over the strides, kernels and fold factors of
  tests/test_sml_folded.py, at rtol 1e-5 (both sum the same f32
  products in their own orders).
* `folded_sml_apply` on the full lite3 plan at a 64x96 net, on the JAX
  model's variables (traced with `jax.eval_shape` and filled from numpy)
  carried across by models.from_jax: in f32 against the port's module
  and against JAX's `folded_sml_apply` at rtol 1e-4.  In bf16 the bar is
  JAX's own spread: the median relative error of the port's folded
  output against JAX's folded output, and against the port's module,
  within that of JAX's folded output against JAX's module (bf16 rounds
  each op's output, and these random full-width weights carry ~1% of
  that noise to the output in either package).
* The `supports_folding` gate and `make_fused_fn` taking the folded
  path under RIDERS_SML_FOLD=1.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core.config import SMLConfig as JaxSMLConfig
from riders_tpu.models import sml_folded as jax_folded
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.ops import fold as jfold
from riders_tpu_torch.core.config import SMLConfig
from riders_tpu_torch.models import sml_folded
from riders_tpu_torch.models.from_jax import sml_from_jax
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.ops import fold
from test_torch_rcnet_variants import _variables
from torch_common import TINY_STAGES, TINY_TAPS

NET = (64, 96)


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(k), (3, 2, 0, 1))))


def test_fold_unfold_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 6, 16, 3)).astype(np.float32))
    xf = fold.fold_w(x, 4)
    assert xf.shape == (2, 6, 4, 12)
    # lane convention: x_f[..., w', f * C + c] == x[..., 4 w' + f, c]
    assert xf[0, 0, 1, 2 * 3 + 1] == x[0, 0, 4 + 2, 1]
    assert torch.equal(fold.unfold_w(xf, 4), x)
    assert torch.equal(fold.refold_w(fold.refold_w(xf, 4, 8), 8, 4), xf)
    np.testing.assert_array_equal(
        fold.refold_w(xf, 4, 2).numpy(),
        np.asarray(jfold.refold_w(jnp.asarray(xf.numpy()), 4, 2)))
    with pytest.raises(ValueError, match="fold"):
        fold.fold_w(x[..., :15, :], 4)


@pytest.mark.parametrize("stride,kernel,F_out", [
    (1, 3, 4), (2, 3, 4), (2, 5, 4), (1, 5, 2), (2, 3, 2)])
def test_folded_conv_matches_jax(stride, kernel, F_out):
    rng = np.random.default_rng(1)
    W, H, Ci, Co = 32, 10, 5, 7
    F_in = stride * F_out
    x = rng.standard_normal((2, H, W, Ci)).astype(np.float32)
    k = rng.standard_normal((kernel, kernel, Ci, Co)).astype(np.float32)
    pad_h = fold.tf_same_pads(H, kernel, stride)
    pad_w = fold.tf_same_pads(W, kernel, stride)
    assert (pad_h, pad_w) == (jfold.tf_same_pads(H, kernel, stride),
                              jfold.tf_same_pads(W, kernel, stride))
    want_k, want_pads = jfold.fold_conv_kernel(jnp.asarray(k), F_in, F_out,
                                               stride, pad_w[0])
    got_k, got_pads = fold.fold_conv_kernel(_oihw(k), F_in, F_out, stride,
                                            pad_w[0])
    assert got_pads == want_pads
    np.testing.assert_array_equal(got_k.numpy(), _oihw(want_k).numpy())
    want = jfold.folded_conv(jfold.fold_w(jnp.asarray(x), F_in),
                             jnp.asarray(k), F_in=F_in, F_out=F_out,
                             stride=(stride, stride), pad_h=pad_h,
                             pad_w_left=pad_w[0])
    got = fold.folded_conv(fold.fold_w(torch.from_numpy(x), F_in), _oihw(k),
                           F_in=F_in, F_out=F_out, stride=(stride, stride),
                           pad_h=pad_h, pad_w_left=pad_w[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(fold.unfold_w(got, F_out).numpy(),
                               np.asarray(jfold.unfold_w(want, F_out)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,kernel", [(1, 3), (2, 3), (1, 5), (2, 5)])
def test_folded_depthwise_matches_jax(stride, kernel):
    rng = np.random.default_rng(2)
    W, H, C, F_out = 32, 12, 6, 4
    F_in = stride * F_out
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    k = rng.standard_normal((kernel, kernel, 1, C)).astype(np.float32)
    args = dict(F_in=F_in, F_out=F_out, stride=(stride, stride),
                pad_h=fold.tf_same_pads(H, kernel, stride),
                pad_w_left=fold.tf_same_pads(W, kernel, stride)[0])
    want = jfold.folded_depthwise(jfold.fold_w(jnp.asarray(x), F_in),
                                  jnp.asarray(k), **args)
    got = fold.folded_depthwise(fold.fold_w(torch.from_numpy(x), F_in),
                                _oihw(k), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_folded_pointwise_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 8, 5)).astype(np.float32)
    k = rng.standard_normal((5, 9)).astype(np.float32)
    want = jfold.folded_pointwise(jfold.fold_w(jnp.asarray(x), 4),
                                  jnp.asarray(k), 4)
    got = fold.folded_pointwise(fold.fold_w(torch.from_numpy(x), 4),
                                torch.from_numpy(k.T.copy()), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        fold.fold_pw_kernel(torch.from_numpy(k.T.copy()), 4).numpy().T,
        np.asarray(jfold.fold_pw_kernel(jnp.asarray(k), 4)))


@pytest.fixture(scope="module")
def folded_setup():
    """The full lite3 SML at a 64x96 net: JAX's model and variables, its
    input, and the port's f32 module on those variables."""
    rng = np.random.default_rng(4)
    model = JaxSML(config=JaxSMLConfig(net_shape=NET))
    x = rng.random((2,) + NET + (3,)).astype(np.float32)
    d = (0.5 + rng.random((2,) + NET + (1,))).astype(np.float32)
    variables = _variables(model, rng, jnp.asarray(x), jnp.asarray(d))
    port = sml_from_jax(SMLConfig(net_shape=NET), variables, device="cpu")
    return model, variables, x, d, port


def test_folded_sml_matches_module_and_jax_f32(folded_setup):
    model, variables, x, d, port = folded_setup
    tx, td = torch.from_numpy(x), torch.from_numpy(d)
    with torch.no_grad():
        ref_pred, ref_scales = port(tx, td)
        got_pred, got_scales = sml_folded.folded_sml_apply(port, tx, td)
    np.testing.assert_allclose(got_scales.numpy(), ref_scales.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_pred.numpy(), ref_pred.numpy(),
                               rtol=1e-4, atol=1e-5)
    want_pred, want_scales = _jax_folded(model)(variables, x, d)
    np.testing.assert_allclose(got_scales.numpy(), np.asarray(want_scales),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=1e-4, atol=1e-5)


def _jax_folded(model):
    return jax.jit(lambda v, x, d: jax_folded.folded_sml_apply(model, v, x,
                                                               d))


def _median_rel(a, b):
    return float(np.median(np.abs(a - b) / np.maximum(np.abs(b), 1e-3)))


def test_folded_sml_matches_jax_bf16(folded_setup):
    _, variables, x, d, _ = folded_setup
    model = JaxSML(config=JaxSMLConfig(net_shape=NET), dtype=jnp.bfloat16)
    port = sml_from_jax(SMLConfig(net_shape=NET), variables, device="cpu",
                        dtype=torch.bfloat16)
    with torch.no_grad():
        tx, td = torch.from_numpy(x), torch.from_numpy(d)
        got = sml_folded.folded_sml_apply(port, tx, td)[0].float().numpy()
        module = port(tx, td)[0].float().numpy()
    want = np.asarray(_jax_folded(model)(variables, x, d)[0], np.float32)
    literal = np.asarray(jax.jit(model.apply)(variables, x, d)[0],
                         np.float32)
    spread = _median_rel(want, literal)
    assert _median_rel(got, want) <= spread, (_median_rel(got, want), spread)
    assert _median_rel(got, module) <= spread
    assert np.isfinite(got).all() and got.shape == want.shape


def test_supports_folding_gates(monkeypatch):
    sml = ScaleMapLearner(SMLConfig(), "cpu", torch.bfloat16)
    monkeypatch.delenv("RIDERS_SML_FOLD", raising=False)
    assert not sml_folded.supports_folding(sml, (288, 384))
    monkeypatch.setenv("RIDERS_SML_FOLD", "1")
    assert sml_folded.supports_folding(sml, (288, 384))
    assert sml_folded.supports_folding(sml, (288, 352))
    assert not sml_folded.supports_folding(sml, (288, 350))
    shrunk = ScaleMapLearner(SMLConfig(), "cpu", torch.bfloat16,
                             backbone_stages=TINY_STAGES,
                             backbone_taps=TINY_TAPS, backbone_stem=8)
    assert not sml_folded.supports_folding(shrunk, (288, 384))
    assert not sml_folded.supports_folding(torch.nn.Linear(1, 1),
                                           (288, 384))


def test_fused_path_takes_the_folded_sml(folded_setup, monkeypatch):
    """make_fused_fn picks the folded SML under JAX's conditions: bf16,
    midas-small and supports_folding."""
    from riders_tpu_torch.core.config import zju_config
    from riders_tpu_torch.models.layers import init_random_
    from riders_tpu_torch.models.rcnet import RCNet
    from riders_tpu_torch.pipelines import fused
    from torch_common import NARROW_RCNET

    cfg = zju_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=(96, 128),
                                    max_points=4),
        sml=dataclasses.replace(cfg.sml, net_shape=NET),
        rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32),
                                  **NARROW_RCNET))
    rcnet = init_random_(RCNet(cfg.rcnet, "cpu"))
    calls = []
    real = sml_folded.folded_sml_apply
    monkeypatch.setattr(sml_folded, "folded_sml_apply",
                        lambda *a: calls.append(1) or real(*a))
    bf16 = copy.deepcopy(folded_setup[4]).to(torch.bfloat16)
    for flag, sml, fold in (("0", bf16, False), ("1", folded_setup[4], False),
                            ("1", bf16, True)):
        monkeypatch.setenv("RIDERS_SML_FOLD", flag)
        assert fused._Stages(cfg, rcnet, sml, torch.device("cpu")
                             ).fold == fold
    fn = fused.make_fused_fn(cfg, rcnet, bf16, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((1, 96, 128, 3), np.float32),
             "mono_pred": (0.5 + rng.random((1, 96, 128))).astype(
                 np.float32),
             "radar_points": np.asarray([[[10.0, 20.0, 5.0]] * 4],
                                        np.float32),
             "point_mask": np.ones((1, 4), np.float32)}
    depth = fn(batch)
    assert len(calls) == 1 and depth.shape == (1, 96, 128)
    assert bool(torch.isfinite(depth).all())
