"""The port's DPT Scale Map Learner (riders_tpu_torch.models.dpt) against
the JAX package's (riders_tpu.models.dpt) on the CPU, from the same
variables and the same seeded numpy inputs.

The variables are the JAX model's own tree (`jax.eval_shape` of its
init, so no init is compiled) filled from a seeded numpy generator:
LeCun-normal kernels as flax draws them, and every other leaf (biases,
norm scales, BEiT's gammas, q / v biases and relative-position table,
the cls token and position embedding) drawn away from its initial 0 / 1,
so that each one matters.  They reach the port through
`models.from_jax`, whose rules for the ConvTranspose, attention and raw
leaves are chosen by the owning module's type.

Held at f32 rtol 1e-4, atol 1e-4: the forwards of the vit and beit
backbones at tiny sizes, beit on a non-square resized window (net 48x80,
window 3x5 against the pretrained 4x4), the hybrid with its ResNetV2-50
stages, `Reassemble` at all four scales (its ConvTranspose has as many
input as output channels, so a wrong layout would load without a shape
error), StdConv and narrow ResNetV2 stages at odd sizes (TF-SAME's
asymmetric pads).  Then one SML training step of the tiny BEiT DPT in
both packages (the loss and its terms in f32 at rtol 1e-4; every
gradient with both networks in f64 at rtol 1e-4), and validate_sml with
a tiny DPT on test_torch_drivers.py's mini-dataset at that file's
tolerance."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import checkpoint as jckpt
from riders_tpu.models import dpt as jdpt
from riders_tpu.pipelines import drivers as jdrivers
from riders_tpu.pipelines import sml_training as jst
from riders_tpu_torch.core import checkpoint as tckpt
from riders_tpu_torch.core import metrics as tmetrics
from riders_tpu_torch.models import dpt as tdpt
from riders_tpu_torch.models.from_jax import (dpt_from_jax,
                                              load_jax_variables,
                                              torch_state_from_jax)
from riders_tpu_torch.pipelines import drivers as tdrivers
from riders_tpu_torch.pipelines import sml_training as tst
from test_drivers import make_mini_dataset
from test_torch_drivers import _abstract_state, _zeros, mini_configs
from test_torch_training import (STEPS_PER_EPOCH, _check_aux, _configs,
                                 _grad_stash, _jax_state, _sml_batch)

RTOL = 1e-4
TINY = dict(embed_dim=16, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
            reassemble_channels=(8, 12, 16, 16), features=8,
            pretrained_grid=4)
HYBRID = dict(TINY, reassemble_channels=(256, 512, 16, 16))


def seeded(shapes, rng):
    """Fill a tree of ShapeDtypeStructs: kernels LeCun-normal (fan-in:
    every axis but the last; BEiT's qkv kernel is (in, 3C)), norm scales
    and gammas 1 + N(0, 0.1), everything else N(0, 0.05); an SML head's
    last conv is scaled by 0.3 and gets bias 1, so that its relu passes
    a varied map."""
    def fill(path, s):
        name = path[-1].key
        if name in ("kernel", "qkv_kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name in ("scale", "gamma_1", "gamma_2"):
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    head = tree["params"].get("head_conv3")
    if head is not None:
        head["kernel"] *= np.float32(0.3)
        head["bias"][:] = 1.0
    return tree


def jax_variables(model, rng, *arrays, static=()):
    """`seeded` variables of `model` for `arrays` (and the `static`
    arguments after them)."""
    return seeded(jax.eval_shape(
        lambda key, *a: model.init(key, *a, *static),
        jax.random.PRNGKey(0), *[jnp.asarray(a) for a in arrays]), rng)


def dpt_inputs(rng, net, B=2):
    x = rng.standard_normal((B,) + tuple(net) + (3,)).astype(np.float32)
    d = (rng.random((B,) + tuple(net) + (1,)) * 5).astype(np.float32)
    return x, d


def _forwards(cfg, variables, x, d, dtype):
    """(JAX, port) (pred, scales) as numpy, both networks in `dtype`."""
    jtype, ttype = {"f32": (jnp.float32, torch.float32),
                    "f64": (jnp.float64, torch.float64)}[dtype]
    with jax.enable_x64(dtype == "f64"):
        v = jax.tree.map(lambda a: np.asarray(a, jtype), variables)
        model = jdpt.DPTScaleMapLearner(config=jdpt.DPTConfig(**cfg),
                                        dtype=jtype)
        want = jax.jit(model.apply)(v, x, d)
        want = [np.asarray(w) for w in want]
    port = dpt_from_jax(tdpt.DPTConfig(**cfg), variables, device="cpu",
                        dtype=ttype)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(d))
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("backbone,net,dims", [
    ("vit", (64, 64), TINY), ("beit", (64, 64), TINY),
    ("beit", (48, 80), TINY)], ids=["vit", "beit", "beit-48x80"])
def test_dpt_forward_matches_jax(rng, backbone, net, dims):
    cfg = dict(dims, net_shape=net, backbone=backbone)
    x, d = dpt_inputs(rng, net)
    variables = jax_variables(jdpt.DPTScaleMapLearner(
        config=jdpt.DPTConfig(**cfg)), rng, x, d)
    (want_pred, want_scales), (pred, scales) = _forwards(cfg, variables, x,
                                                         d, "f32")
    assert float(scales.std()) > 0.05
    np.testing.assert_allclose(pred, want_pred, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(scales, want_scales, rtol=RTOL, atol=RTOL)


def test_dpt_hybrid_forward_matches_jax(rng):
    """The hybrid at 64x64 (its full ResNetV2-50 stages, a narrow ViT).
    With both networks in f64 (StdConv's standardisation, BEiT's softmax
    and the head's relu stay f32 in both) at rtol 1e-4.  In f32, sixteen
    random-weight bottlenecks amplify rounding: each package's /16 stage
    map lies ~6e-4 (of ~13) from the f64 one, and the two f32 packages'
    predictions differ by up to 1.3e-4 relative on a few pixels
    (ROADMAP.md C); there the port's f32 prediction is held within twice
    JAX's own f32 distance from the f64 prediction."""
    cfg = dict(HYBRID, net_shape=(64, 64), backbone="vit_hybrid")
    x, d = dpt_inputs(rng, (64, 64))
    variables = jax_variables(jdpt.DPTScaleMapLearner(
        config=jdpt.DPTConfig(**cfg)), rng, x, d)
    (want_pred, want_scales), (pred, scales) = _forwards(cfg, variables, x,
                                                         d, "f64")
    assert float(scales.std()) > 0.05
    np.testing.assert_allclose(pred, want_pred, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(scales, want_scales, rtol=RTOL, atol=RTOL)

    (jax32, _), (port32, _) = _forwards(cfg, variables, x, d, "f32")
    spread = np.abs(jax32 - want_pred).max()
    assert 0 < np.abs(port32 - want_pred).max() <= 2 * spread


@pytest.mark.parametrize("scale", [4, 2, 1, -2])
def test_reassemble_matches_jax(rng, scale):
    """Tokens of a 3x5 grid plus cls, C = out = 12: the ConvTranspose
    (scales 4 and 2) has in == out channels, so its flax kernel (kh, kw,
    in, out), correlated unflipped, loads into the torch (in, out, kh,
    kw) weight with no shape error whether or not it is flipped."""
    grid, C = (3, 5), 12
    tokens = rng.standard_normal((2, 16, C)).astype(np.float32)
    model = jdpt.Reassemble(C, scale)
    variables = jax_variables(model, rng, tokens, static=(grid,))
    want = model.apply(variables, jnp.asarray(tokens), grid)
    port = load_jax_variables(tdpt.Reassemble(C, C, scale), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), grid).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_convtranspose_layout_is_chosen_by_module_type(rng):
    """The same flax kernel lands flipped in a ConvTranspose2d and
    transposed in a Conv2d."""
    k = rng.standard_normal((2, 2, 3, 3)).astype(np.float32)
    variables = {"params": {"a": {"kernel": k}, "b": {"kernel": k}}}
    module = torch.nn.Module()
    module.a = torch.nn.ConvTranspose2d(3, 3, 2, 2, bias=False)
    module.b = torch.nn.Conv2d(3, 3, 2, 2, bias=False)
    state = torch_state_from_jax(variables, module)
    np.testing.assert_array_equal(state["a.weight"],
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    np.testing.assert_array_equal(state["b.weight"], k.transpose(3, 2, 0, 1))


def test_std_conv_and_resnet_stages_match_jax(rng):
    """StdConv 3x3/2 and narrow ResNetV2 stages (one, two, one blocks of
    128, 256, 256 channels) on a 37x45 map: TF-SAME pads asymmetrically
    there, and the stem's max pool pads with -inf."""
    x = rng.standard_normal((2, 37, 45, 8)).astype(np.float32)
    conv = jdpt.StdConv(16, 3, 2)
    variables = jax_variables(conv, rng, x)
    port = load_jax_variables(tdpt.StdConv(8, 16, 3, 2), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(conv.apply(variables, x)),
                               rtol=RTOL, atol=RTOL)

    x = rng.standard_normal((2, 37, 45, 3)).astype(np.float32)
    plan = dict(layers=(1, 2, 1), channels=(128, 256, 256))
    stages = jdpt.ResNetV2Stages(**plan)
    variables = jax_variables(stages, rng, x)
    want = jax.jit(stages.apply)(variables, x)
    port = load_jax_variables(tdpt.ResNetV2Stages(3, **plan), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("grid", [(4, 4), (3, 5), (18, 22)])
def test_beit_rel_pos_index_matches_jax(grid):
    np.testing.assert_array_equal(tdpt.beit_rel_pos_index(*grid),
                                  jdpt._beit_rel_pos_index(*grid))


def test_unported_backbones_raise():
    for backbone in ("swin2", "levit", "next_vit"):
        with pytest.raises(NotImplementedError, match="A6"):
            tdpt.DPTScaleMapLearner(tdpt.DPTConfig(backbone=backbone),
                                    "cpu")


# ---- one SML training step ----------------------------------------------

STEP_NET = (64, 96)       # grid 4x6 against the pretrained 4x4


def _step_configs():
    return [c.replace(sml=dataclasses.replace(c.sml, net_shape=STEP_NET))
            for c in _configs()]


def _step_variables(rng):
    model = jdpt.DPTScaleMapLearner(config=jdpt.DPTConfig(
        net_shape=STEP_NET, backbone="beit", **TINY))
    variables = jax_variables(model, rng, *dpt_inputs(rng, STEP_NET, 1))
    # a small head keeps scales = relu(1 + out) near 1 and the
    # prediction inside its clamps (test_torch_training.py's reason)
    head = variables["params"]["head_conv3"]
    head["kernel"] = (0.02 * head["kernel"]).astype(np.float32)
    head["bias"][:] = 0.1
    variables["batch_stats"] = {}
    return variables


def test_dpt_sml_step_matches_jax():
    """The loss and its terms in f32; every gradient with both networks
    in f64 (stage 1 and the loss stay f32, and BEiT's softmax runs in
    f32 in both packages), by key, at rtol 1e-4 with atol 1e-4 of the
    tensor's max abs."""
    rng = np.random.default_rng(12)
    jcfg, tcfg = _step_configs()
    variables = _step_variables(rng)
    batch = _sml_batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = tst.make_train_step(tcfg)
    stash = _grad_stash()

    def jax_step(dtype, v):
        model = jdpt.DPTScaleMapLearner(config=jdpt.DPTConfig(
            net_shape=STEP_NET, backbone="beit", **TINY), dtype=dtype)
        return jax.jit(jst.make_train_step(jcfg, model, stash))(
            _jax_state(v, stash), jbatch)

    def port(dtype, v):
        model = dpt_from_jax(tdpt.DPTConfig(
            net_shape=STEP_NET, backbone="beit", **TINY), v, device="cpu",
            dtype=dtype)
        _, info = step(tst.init_train_state(tcfg, model, STEPS_PER_EPOCH),
                       batch)
        return model, info

    _, aux = jax_step(jnp.float32, variables)
    _, info = port(torch.float32, variables)
    _check_aux(info, aux)

    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        new, aux = jax_step(jnp.float64, v64)
        model, info = port(torch.float64, v64)
        _check_aux(info, aux)
        want = torch_state_from_jax({"params": jax.device_get(
            new.opt_state)}, model)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for key, p in got.items():
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=key)


# ---- validate_sml ---------------------------------------------------------

STEPS = (1, 2)


def test_validate_sml_with_a_dpt_matches_jax(tmp_path, monkeypatch):
    """Both packages' validate_sml over two checkpoints of the same tiny
    BEiT DPT weights, each in its own format, on the mini dataset: every
    step's seven metrics and the best bundle within rtol 1e-3 (the bar of
    test_torch_drivers.py), the same best step."""
    root = str(tmp_path)
    make_mini_dataset(root, ["scene-a", "scene-b"])
    jcfg, tcfg = mini_configs(root)
    net = jcfg.sml.net_shape
    jcfg, tcfg = (c.replace(sml=dataclasses.replace(
        c.sml, model_type="dpt-beit-base")) for c in (jcfg, tcfg))
    dcfg = dict(TINY, net_shape=net, backbone="beit")
    jmodel = jdpt.DPTScaleMapLearner(config=jdpt.DPTConfig(**dcfg))
    template = _zeros(_abstract_state(jst.init_train_state, jcfg, jmodel))
    rng = np.random.default_rng(31)
    dirs = {k: os.path.join(root, "ckpt", k) for k in ("jax", "torch")}
    for step in STEPS:
        variables = jax_variables(jmodel, rng, *dpt_inputs(rng, net, 1))
        head = variables["params"]["head_conv3"]
        head["kernel"] = (1e-3 * head["kernel"]).astype(np.float32)
        head["bias"][:] = 0.02 * step
        jckpt.save_train_state(dirs["jax"], template.replace(
            step=jnp.int32(step), params=variables["params"]))
        state = tst.init_train_state(tcfg, dpt_from_jax(
            tdpt.DPTConfig(**dcfg), variables, device="cpu"), 1)
        state.step = step
        tckpt.save_train_state(dirs["torch"], state)

    monkeypatch.setattr(jst, "init_train_state",
                        lambda *a, **k: (template, None))
    monkeypatch.setattr(jdrivers, "build_sml_model",
                        lambda cfg, dtype=jnp.float32:
                        jdpt.DPTScaleMapLearner(
                            config=jdpt.DPTConfig(**dcfg), dtype=dtype))
    monkeypatch.setattr(tdrivers, "build_sml_model",
                        lambda cfg, device, dtype: tdpt.DPTScaleMapLearner(
                            tdpt.DPTConfig(**dcfg), device, dtype))
    bundles = {"jax": [], "torch": []}
    for name, mod in (("jax", jdrivers.metrics_lib),
                      ("torch", tdrivers.metrics_lib)):
        def vote(results, best, _vote=mod.improves_best, _to=bundles[name]):
            _to.append(dict(results))
            return _vote(results, best)
        monkeypatch.setattr(mod, "improves_best", vote)

    ref = jdrivers.validate_sml(jcfg, dirs["jax"], batch_size=2)
    got = tdrivers.validate_sml(tcfg, dirs["torch"], batch_size=2,
                                device="cpu")
    assert got["step"] == ref["step"] in STEPS
    assert len(bundles["jax"]) == len(bundles["torch"]) == 2
    for a, b in zip(bundles["jax"] + [ref], bundles["torch"] + [got]):
        for k in tmetrics.METRIC_KEYS:
            assert np.isfinite(b[k]), k
            np.testing.assert_allclose(b[k], a[k], rtol=1e-3, err_msg=k)
