"""The port's drivers (pipelines.drivers) against the JAX package's on a
synthetic mini-dataset in a temp dir (tests/test_drivers.py's), with
narrow RC-Net widths, a tiny SML backbone and f32, from checkpoints of
the same weights in each package's own format (two steps each).

* run_rcnet: the same file tree; decoded depth within one PNG code
  (1/256 m): the f32 compositions differ in the last ulp.
* evaluate_results_dir: each package on the same tree, rtol 1e-6.
* validate_rcnet / validate_sml: best bundles within rtol 1e-3 (the bar
  of test_torch_fused.py) and the same best step.  The vote rounds each
  metric to 4 decimals, so a metric that the two packages put on either
  side of a rounding boundary could flip it (the packages sum in
  different orders); on this data every metric's two steps lie further
  apart than that, which the test checks rather than assumes."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from riders_tpu.core import checkpoint as jckpt
from riders_tpu.core import config as jconfig
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.pipelines import drivers as jdrivers
from riders_tpu.pipelines import rcnet_training as jrc_train
from riders_tpu.pipelines import sml_training as jsml_train
from riders_tpu_torch.core import checkpoint as tckpt
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.core import metrics as tmetrics
from riders_tpu_torch.io import depthio
from riders_tpu_torch.models.from_jax import rcnet_from_jax, sml_from_jax
from riders_tpu_torch.pipelines import drivers as tdrivers
from riders_tpu_torch.pipelines.rcnet_training import init_rcnet_train_state
from riders_tpu_torch.pipelines.sml_training import init_train_state
from test_drivers import make_mini_dataset
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS, perturbed

BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)
STEPS = (1, 2)


def mini_configs(root):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config(root=root)
        out.append(cfg.replace(
            dataset=dataclasses.replace(
                cfg.dataset, image_shape=(96, 128), max_points=16,
                train_scenes=("scene-a",), val_scenes=("scene-b",)),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32),
                                      **NARROW_RCNET),
            compute_dtype="float32"))
    return out


def _abstract_state(init, cfg, model):
    """The TrainState that the JAX `init` builds, as shapes (traced, not
    run: the eager flax init of these models takes ~30 s each)."""
    return jax.eval_shape(
        lambda: init(cfg, model, jax.random.PRNGKey(0), 1)[0])


def _zeros(tree):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)


def _random_variables(state, rng):
    """LeCun-normal kernels (flax's default), unit scales and zero
    biases, then `perturbed` (BN statistics and affine terms away from 0 / 1).  An SML head's last
    conv is scaled by 1e-3, so that the scales it regresses stay near 1,
    as a trained one's do, and depth stays in the metric range."""
    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)
                    ).astype(np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(
            s.shape, np.float32)
    tree = jax.tree_util.tree_map_with_path(
        fill, {"params": state.params, "batch_stats": state.batch_stats})
    tree = perturbed(tree, rng)
    head = tree["params"].get("output_conv", {}).get("conv3")
    if head is not None:
        head["kernel"] *= np.float32(1e-3)
    return tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The mini dataset, RC-Net and SML checkpoints at steps 1 and 2 of
    random weights, saved by each package from the same variables, and
    the JAX drivers' restore templates."""
    root = str(tmp_path_factory.mktemp("mini_drivers"))
    make_mini_dataset(root, ["scene-a", "scene-b"])
    jcfg, tcfg = mini_configs(root)
    rng = np.random.default_rng(21)
    dirs = {k: os.path.join(root, "ckpt", k)
            for k in ("jax_rc", "torch_rc", "jax_sml", "torch_sml")}
    templates = {
        "rc": _zeros(_abstract_state(jrc_train.init_rcnet_train_state,
                                     jcfg, JaxRCNet(config=jcfg.rcnet))),
        "sml": _zeros(_abstract_state(jsml_train.init_train_state, jcfg,
                                      JaxSML(config=jcfg.sml, **BACKBONE)))}
    builders = {
        "rc": (lambda v: rcnet_from_jax(tcfg.rcnet, v, device="cpu"),
               init_rcnet_train_state),
        "sml": (lambda v: sml_from_jax(tcfg.sml, v, device="cpu",
                                       **BACKBONE), init_train_state)}
    for step in STEPS:
        for kind, (build, init) in builders.items():
            variables = _random_variables(templates[kind], rng)
            jckpt.save_train_state(dirs[f"jax_{kind}"], templates[kind].replace(
                step=jnp.int32(step), params=variables["params"],
                batch_stats=variables["batch_stats"]))
            tstate = init(tcfg, build(variables), 1)
            tstate.step = step
            tckpt.save_train_state(dirs[f"torch_{kind}"], tstate)
    return root, dirs, templates


@pytest.fixture
def jax_templates(setup, monkeypatch):
    """The JAX drivers restore into the fixture's templates instead of
    initialising their models eagerly."""
    templates = setup[2]
    monkeypatch.setattr(jrc_train, "init_rcnet_train_state",
                        lambda *a, **k: (templates["rc"], None))
    monkeypatch.setattr(jsml_train, "init_train_state",
                        lambda *a, **k: (templates["sml"], None))


@pytest.fixture
def tiny_sml(monkeypatch):
    """Both packages' validate_sml build the tiny-backbone SML."""
    monkeypatch.setattr(jdrivers, "build_sml_model",
                        lambda cfg, dtype=jnp.float32: JaxSML(
                            config=cfg.sml, dtype=dtype, **BACKBONE))
    monkeypatch.setattr(tdrivers, "build_sml_model",
                        lambda cfg, device, dtype: tdrivers.ScaleMapLearner(
                            cfg.sml, device, dtype, **BACKBONE))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_all_steps_lists_saved_steps(setup, tmp_path):
    _, dirs, _ = setup
    assert tckpt.all_steps(dirs["torch_rc"]) == list(STEPS)
    assert tckpt.all_steps(str(tmp_path / "none")) == []


def test_run_rcnet_and_evaluate_match_jax(setup, jax_templates, tmp_path):
    root, dirs, _ = setup
    jcfg, tcfg = mini_configs(root)
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    jdrivers.run_rcnet(jcfg, dirs["jax_rc"], out["jax"],
                       scenes=("scene-b",))
    tdrivers.run_rcnet(tcfg, dirs["torch_rc"], out["torch"],
                       scenes=("scene-b",), device="cpu")
    tree = _tree(out["jax"])
    assert tree == _tree(out["torch"])
    assert len(tree) == 6 and all(
        p.startswith("rcnet_0.1/scene-b/depth_predicted") for p in tree)
    n_positive = 0
    for path in tree:
        if "colors" in path:
            continue
        a, b = (depthio.load_depth(os.path.join(out[k], path))
                for k in ("jax", "torch"))
        assert np.abs(a - b).max() <= 1.0 / 256.0 + 1e-6
        n_positive += int((b > 0).sum())
    assert n_positive > 0

    # each package scores each tree; on the same tree they agree
    for tree_of in ("jax", "torch"):
        result_root = os.path.join(out[tree_of], "rcnet_0.1")
        a = jdrivers.evaluate_results_dir(jcfg, result_root,
                                          "depth_predicted")
        b = tdrivers.evaluate_results_dir(tcfg, result_root,
                                          "depth_predicted", device="cpu")
        assert set(a) == set(b) == set(tmetrics.METRIC_KEYS)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
        assert np.isfinite(b["mae"])


def _same_vote(jax_steps, torch_steps):
    """Each metric orders the two steps the same way in both packages
    at the vote's 4 decimals: either the steps are equal in both, or
    their gap exceeds twice the packages' difference."""
    (j1, j2), (t1, t2) = jax_steps, torch_steps
    for k in tmetrics.METRIC_KEYS:
        if t1[k] == t2[k] and j1[k] == j2[k]:
            continue
        noise = max(abs(t1[k] - j1[k]), abs(t2[k] - j2[k]))
        if abs(round(t1[k], 4) - round(t2[k], 4)) <= 2 * noise + 1e-4:
            return False
    return True


def test_validate_rcnet_matches_jax(setup, jax_templates, capsys):
    root, dirs, _ = setup
    jcfg, tcfg = mini_configs(root)
    ref = jdrivers.validate_rcnet(jcfg, dirs["jax_rc"])
    got = tdrivers.validate_rcnet(tcfg, dirs["torch_rc"], device="cpu")
    assert got["step"] == ref["step"] in STEPS
    for k in ("mae", "rmse", "imae", "irmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    assert "RC-Net validation step 1" in capsys.readouterr().out


def test_validate_sml_matches_jax(setup, jax_templates, tiny_sml, tmp_path,
                                  monkeypatch):
    root, dirs, _ = setup
    jcfg, tcfg = mini_configs(root)
    bundles = {"jax": [], "torch": []}
    for name, mod in (("jax", jdrivers.metrics_lib),
                      ("torch", tdrivers.metrics_lib)):
        def vote(results, best, _vote=mod.improves_best, _to=bundles[name]):
            _to.append(dict(results))
            return _vote(results, best)
        monkeypatch.setattr(mod, "improves_best", vote)

    ref = jdrivers.validate_sml(jcfg, dirs["jax_sml"], batch_size=2)
    got = tdrivers.validate_sml(tcfg, dirs["torch_sml"], batch_size=2,
                                output_path=str(tmp_path),
                                save_output=True, device="cpu")
    assert got["step"] == ref["step"] in STEPS
    for k in tmetrics.METRIC_KEYS:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    # every step's bundle (newest first) agrees, and no metric of the
    # two steps sits so close to the other that the packages' difference
    # could flip its vote
    assert len(bundles["jax"]) == len(bundles["torch"]) == 2
    for a, b in zip(bundles["jax"], bundles["torch"]):
        for k in tmetrics.METRIC_KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-3, err_msg=k)
    assert _same_vote(bundles["jax"], bundles["torch"])

    sml_dir = tmp_path / "SML"
    assert sorted(os.listdir(sml_dir)) == [
        "mosaic-step1.png", "mosaic-step2.png", "scene-b"]
    assert len(os.listdir(sml_dir / "scene-b" / "sml_depth")) == 3
    # the PNGs (of the last step swept, step 1) score as that step did,
    # within the x256 codec
    scored = tdrivers.evaluate_results_dir(tcfg, str(sml_dir),
                                           device="cpu")
    for k in tmetrics.METRIC_KEYS:
        np.testing.assert_allclose(scored[k], bundles["torch"][-1][k],
                                   rtol=2e-2, err_msg=k)


def test_validate_sml_refuses_unported_families(setup):
    root, dirs, _ = setup
    _, tcfg = mini_configs(root)
    cfg = tcfg.replace(sml=dataclasses.replace(tcfg.sml,
                                               model_type="dpt-swin2-large"))
    with pytest.raises(NotImplementedError, match="dpt-swin2-large"):
        tdrivers.validate_sml(cfg, dirs["torch_sml"], device="cpu")
