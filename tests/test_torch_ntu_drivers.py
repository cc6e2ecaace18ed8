"""The port's drivers against the JAX package's on the NTU protocol:
tests/test_ntu_drivers.py's mini NTU configuration (the preset's
thresholds 0.4 / 0.5, its 70 m evaluation cap, a 66x34 patch whose
downsample pyramid is odd: 33,17 -> 16,8 -> 8,4 -> 4,2) on its synthetic
scenes, whose depths reach ~69 m, with narrow RC-Net widths, a tiny SML
backbone and f32, from checkpoints of the same weights in each
package's own format (test_torch_drivers.py's method).

* run_rcnet at 0.4 and at 0.5: the same file tree; decoded depth within
  one PNG code (1/256 m).
* validate_rcnet: the same best step, its bundle within rtol 1e-5 (on
  this data the two bundles are bitwise equal; the decoded maps differ
  only in the compositions' last ulp).
* validate_sml, reading rcnet_0.5 with the 70 m cap: every step's bundle
  within rtol 1e-3, the same best step, and no metric's two steps so
  close that the packages' difference could flip the 4-decimal vote;
  a 50 m cap scores differently in both packages.
* The port's own chain end to end: train_rcnet -> run_rcnet at 0.4 and
  0.5 -> train_sml (reads rcnet_0.4) -> validate_sml (rcnet_0.5, 70 m).
"""

import dataclasses
import os

import numpy as np
import pytest

from riders_tpu.core import config as jconfig
from riders_tpu.pipelines import drivers as jdrivers
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.core import metrics as tmetrics
from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.manifest import build_manifest
from riders_tpu_torch.pipelines import drivers as tdrivers
from test_drivers import make_mini_dataset
from test_torch_drivers import (STEPS, _same_vote, _tree, build_tiny_sml,
                                restore_into, save_checkpoints)
from torch_common import NARROW_RCNET

THRESHOLDS = (0.4, 0.5)
NTU_SPAN = (5.0, 48.0, 15.0)      # depths to ~69 m, past ZJU's 50 m cap


def mini_ntu_configs(root):
    """tests/test_ntu_drivers.py's `mini_ntu_config` in each package (the
    NTU preset's protocol fields verbatim, geometry and budgets cut),
    with NARROW_RCNET widths and an 8-feature SML."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.ntu_config(root=root)
        out.append(cfg.replace(
            dataset=dataclasses.replace(
                cfg.dataset, image_shape=(96, 128), max_points=16,
                train_scenes=("scene-a",), val_scenes=("scene-b",)),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=(66, 34),
                                      **NARROW_RCNET),
            sml_train=dataclasses.replace(
                cfg.sml_train, batch_size=2, n_step_per_checkpoint=2,
                n_step_per_summary=1, learning_schedule=(1, 2)),
            rcnet_train=dataclasses.replace(
                cfg.rcnet_train, batch_size=1, points_per_frame=4,
                n_step_per_checkpoint=2, n_step_per_summary=1,
                learning_schedule=(1,)),
            compute_dtype="float32"))
    return out


def at_threshold(cfg, thr):
    return cfg.replace(rcnet=dataclasses.replace(cfg.rcnet,
                                                 response_threshold=thr))


def capped(cfg, max_depth):
    return cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                max_depth_val=max_depth))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The NTU mini dataset, checkpoints of the same random weights in
    each package, and both packages' run_rcnet trees at 0.4 and 0.5 of
    the validation scene: JAX's in the dataset's own output tree, where
    validate_sml reads rcnet_0.5, the port's beside it."""
    root = str(tmp_path_factory.mktemp("mini_ntu"))
    make_mini_dataset(root, ["scene-a", "scene-b"], depth_span=NTU_SPAN)
    jcfg, tcfg = mini_ntu_configs(root)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.sml_train.rcnet_interp, tcfg.sml_train.rcnet_interp_val,
            tcfg.eval.max_depth_val) == ("rcnet_0.4", "rcnet_0.5", 70.0)
    dirs, templates = save_checkpoints(root, jcfg, tcfg,
                                       np.random.default_rng(23))
    trees = {"jax": os.path.join(root, "output"),
             "torch": os.path.join(root, "port_output")}
    with pytest.MonkeyPatch.context() as mp:
        restore_into(mp, templates)
        for thr in THRESHOLDS:
            jdrivers.run_rcnet(at_threshold(jcfg, thr), dirs["jax_rc"],
                               trees["jax"], scenes=("scene-b",),
                               save_color=False)
            tdrivers.run_rcnet(at_threshold(tcfg, thr), dirs["torch_rc"],
                               trees["torch"], scenes=("scene-b",),
                               save_color=False, device="cpu")
    return root, dirs, templates, trees


@pytest.fixture
def jax_templates(setup, monkeypatch):
    restore_into(monkeypatch, setup[2])


@pytest.fixture
def tiny_sml(monkeypatch):
    build_tiny_sml(monkeypatch)


@pytest.mark.parametrize("thr", THRESHOLDS)
def test_run_rcnet_matches_jax(setup, thr):
    trees = setup[3]
    tag = f"rcnet_{thr}"
    roots = {k: os.path.join(v, tag) for k, v in trees.items()}
    tree = _tree(roots["jax"])
    assert tree == _tree(roots["torch"])
    assert tree == [f"scene-b/depth_predicted/{i:06d}.png"
                    for i in range(3)]
    n_positive = 0
    for path in tree:
        a, b = (depthio.load_depth(os.path.join(roots[k], path))
                for k in ("jax", "torch"))
        assert np.abs(a - b).max() <= 1.0 / 256.0 + 1e-6
        n_positive += int((b > 0).sum())
    assert n_positive > 0
    print(f"{tag}: {n_positive} positive pixels")


def test_thresholds_reach_run_rcnet(setup):
    """0.4 and 0.5 write different maps: the threshold reaches the
    driver."""
    torch_tree = setup[3]["torch"]
    maps = [depthio.load_depth(os.path.join(
        torch_tree, f"rcnet_{thr}", "scene-b", "depth_predicted",
        "000000.png")) for thr in THRESHOLDS]
    assert (maps[0] > 0).sum() > (maps[1] > 0).sum()


def test_validate_rcnet_matches_jax(setup, jax_templates):
    root, dirs = setup[:2]
    jcfg, tcfg = mini_ntu_configs(root)
    ref = jdrivers.validate_rcnet(jcfg, dirs["jax_rc"])
    got = tdrivers.validate_rcnet(tcfg, dirs["torch_rc"], device="cpu")
    print(f"validate_rcnet: JAX {ref}, port {got}")
    assert got["step"] == ref["step"] in STEPS
    for k in ("mae", "rmse", "imae", "irmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_validate_sml_matches_jax_at_the_70m_cap(setup, jax_templates,
                                                 tiny_sml, monkeypatch):
    root, dirs = setup[:2]
    jcfg, tcfg = mini_ntu_configs(root)
    bundles = {"jax": [], "torch": []}
    for name, mod in (("jax", jdrivers.metrics_lib),
                      ("torch", tdrivers.metrics_lib)):
        def vote(results, best, _vote=mod.improves_best, _to=bundles[name]):
            _to.append(dict(results))
            return _vote(results, best)
        monkeypatch.setattr(mod, "improves_best", vote)

    best = {}
    for cap in (70.0, 50.0):
        ref = jdrivers.validate_sml(capped(jcfg, cap), dirs["jax_sml"],
                                    batch_size=2)
        got = tdrivers.validate_sml(capped(tcfg, cap), dirs["torch_sml"],
                                    batch_size=2, device="cpu")
        print(f"validate_sml at {cap} m: rel. differences " + str({
            k: abs(got[k] - ref[k]) / abs(ref[k])
            for k in tmetrics.METRIC_KEYS if ref[k]}))
        assert got["step"] == ref["step"] in STEPS
        for k in tmetrics.METRIC_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-3,
                                       err_msg=f"{k} at {cap} m")
        best[cap] = (ref, got)
    # at 70 m every step's bundle (newest first) agrees, and no metric
    # of the two steps sits so close to the other that the packages'
    # difference could flip its vote
    steps = {k: v[:2] for k, v in bundles.items()}
    for a, b in zip(steps["jax"], steps["torch"]):
        for k in tmetrics.METRIC_KEYS:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-3, err_msg=k)
    assert _same_vote(steps["jax"], steps["torch"])
    # the scene's depths reach past 50 m, so the caps score differently
    for ref, got in zip(best[70.0], best[50.0]):
        assert got["mae"] != ref["mae"]


def test_port_ntu_chain_end_to_end(tmp_path, tiny_sml):
    """train_rcnet -> run_rcnet at 0.4 and 0.5 -> train_sml (rcnet_0.4)
    -> validate_sml (rcnet_0.5, 70 m cap), the port alone on its own
    copy of the mini dataset."""
    root = str(tmp_path / "mini_ntu")
    make_mini_dataset(root, ["scene-a", "scene-b"], depth_span=NTU_SPAN)
    cfg = mini_ntu_configs(root)[1]
    rc_ckpt = str(tmp_path / "rc_ckpt")
    tdrivers.train_rcnet(cfg, rc_ckpt, max_steps=2, device="cpu")
    out_root = os.path.join(root, "output")
    for thr in THRESHOLDS:
        tdrivers.run_rcnet(at_threshold(cfg, thr), rc_ckpt, out_root,
                           scenes=("scene-a", "scene-b"), save_color=False,
                           device="cpu")
        d = depthio.load_depth(os.path.join(
            out_root, f"rcnet_{thr}", "scene-b", "depth_predicted",
            "000000.png"))
        assert d.shape == (96, 128)
    records = build_manifest(cfg.dataset, ("scene-a",),
                             rcnet_interp="rcnet_0.4")
    assert all("rcnet_0.4" in r.rcnet for r in records)
    sml_ckpt = str(tmp_path / "sml_ckpt")
    tdrivers.train_sml(cfg, sml_ckpt, max_steps=2, device="cpu")
    vrecords = build_manifest(cfg.dataset, ("scene-b",),
                              rcnet_interp="rcnet_0.5")
    assert all("rcnet_0.5" in r.rcnet for r in vrecords)
    best = tdrivers.validate_sml(cfg, sml_ckpt, batch_size=2, device="cpu")
    assert np.isfinite(best["mae"]) and best["step"] == 2
    best50 = tdrivers.validate_sml(capped(cfg, 50.0), sml_ckpt,
                                   batch_size=2, device="cpu")
    assert best50["mae"] != best["mae"]
