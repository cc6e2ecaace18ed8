"""The port's `tools/compare_goldens` against the JAX package's
`tools/compare_goldens.py`, on the CPU.

Both tools score the same two trees, a goldens tree and a riders tree
written from a numpy seed on tests/test_drivers.py's mini-dataset:
x256 sml_depth PNGs, int_depth / int_scales .npy maps in one scene only,
and one frame missing on the riders side.

* The per-scene report equals the JAX tool's exactly, with and without
  --root; both tools print it in one form, which one parser reads.
* The relative metric deviations agree to 1e-6 (torch against XLA
  metrics on the CPU), and the budget verdicts are the same: true for a
  riders tree within the budget, false for both when its PNGs are
  scaled by 1.05.
* --min-depth / --max-depth: at their defaults the port's numbers are
  the JAX tool's; at other values the JAX tool's stay as they were (it
  parses the flags and keeps the preset's window) and the port's are
  JAX's `evaluate_results_dir` under that window.
* Without a card, the default device raises.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from riders_tpu.core.config import zju_config as jzju_config
from riders_tpu.pipelines import drivers as jdrivers
from riders_tpu_torch.io import depthio
from riders_tpu_torch.tools import compare_goldens as tgoldens
from test_drivers import make_mini_dataset

REPO = Path(__file__).resolve().parents[1]
SCENES = ("scene-a", "scene-b")
N_FRAMES = 3


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_compare_goldens_script", REPO / "tools" / "compare_goldens.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jtool = _load_jax_tool()


def _write_tree(tree, depths, maps, skip=()):
    """sml_depth PNGs of `depths` {(scene, fid): map}, the .npy `maps`
    {(scene, fid): (int_depth, int_scales)}, leaving out `skip`."""
    for (scene, fid), depth in depths.items():
        if (scene, fid) in skip:
            continue
        out = depthio.ensure_dir(os.path.join(tree, scene, "sml_depth"))
        depthio.save_depth(depth, os.path.join(out, fid + ".png"))
        if (scene, fid) in maps:
            for key, m in zip(("int_depth", "int_scales"),
                              maps[(scene, fid)]):
                d = depthio.ensure_dir(os.path.join(tree, scene, key))
                np.save(os.path.join(d, fid + ".npy"), m)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(dataset root, goldens, riders, riders scaled by 1.05): goldens a
    10% overestimate of the GT field with 2% noise, riders the goldens
    with 0.3% noise, stage-1 maps in scene-a only, scene-b's last frame
    missing on the riders side."""
    base = tmp_path_factory.mktemp("goldens")
    root = str(base / "data")
    make_mini_dataset(root, list(SCENES), n_frames=N_FRAMES)
    rng = np.random.default_rng(11)
    golden, riders, scaled, maps_g, maps_r = {}, {}, {}, {}, {}
    for scene in SCENES:
        for f in range(N_FRAMES):
            fid = f"{f:06d}"
            truth = depthio.load_depth(os.path.join(
                root, scene, "lidar_png_int", fid + ".png"))
            g = truth * (1.1 + 0.02 * rng.standard_normal(truth.shape))
            r = g * (1.0 + 0.003 * rng.standard_normal(truth.shape))
            golden[(scene, fid)] = g.astype(np.float32)
            riders[(scene, fid)] = r.astype(np.float32)
            scaled[(scene, fid)] = (1.05 * r).astype(np.float32)
            if scene == "scene-a":
                m = rng.random((2,) + truth.shape).astype(np.float32)
                maps_g[(scene, fid)] = tuple(m)
                maps_r[(scene, fid)] = tuple(
                    m + 0.01 * rng.standard_normal(m.shape).astype(
                        np.float32))
    skip = {("scene-b", f"{N_FRAMES - 1:06d}")}
    paths = [str(base / n) for n in ("golden", "riders", "scaled")]
    _write_tree(paths[0], golden, maps_g)
    _write_tree(paths[1], riders, maps_r, skip)
    _write_tree(paths[2], scaled, maps_r, skip)
    return (root, *paths)


def _parse(text):
    """The report, the relative deviations and the verdict from either
    tool's stdout."""
    report, rel, verdict = {}, None, None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        scene, _, rest = line.partition(" ")
        if scene in SCENES and rest.startswith("{"):
            report[scene] = ast.literal_eval(rest)
        elif line.startswith("relative deviation: "):
            block = [line[len("relative deviation: "):]]
            for nxt in lines[i + 1:]:
                block.append(nxt)
                if nxt == "}":
                    break
            rel = json.loads("\n".join(block))
        elif line.startswith("within 1% parity budget: "):
            verdict = ast.literal_eval(line.rsplit(" ", 1)[1])
    return report, rel, verdict


def _run_jax(capsys, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["compare_goldens.py"] + argv)
    capsys.readouterr()
    jtool.main()
    return _parse(capsys.readouterr().out)


def _run_port(capsys, argv):
    capsys.readouterr()
    assert tgoldens.main(argv + ["--device", "cpu"]) == 0
    return _parse(capsys.readouterr().out)


@pytest.mark.parametrize("with_root", [False, True])
def test_report_matches_jax_tool(trees, capsys, monkeypatch, with_root):
    root, golden, riders, _ = trees
    argv = [golden, riders] + (["--root", root] if with_root else [])
    want = _run_jax(capsys, monkeypatch, argv)
    got = _run_port(capsys, argv)
    assert got[0] == want[0]
    assert set(want[0]) == set(SCENES)
    assert want[0]["scene-b"]["int_depth"] is None
    assert want[0]["scene-b"]["int_scales"] is None
    assert all(v is not None for v in want[0]["scene-a"].values())
    out = tgoldens.compare_goldens(golden, riders,
                                   root if with_root else None,
                                   device="cpu")
    assert out["report"] == want[0]
    if not with_root:
        assert want[1:] == got[1:] == (None, None)
        assert set(out) == {"report"}
        return
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert abs(got[1][k] - want[1][k]) <= 1e-6, k
    assert got[2] is want[2] is True
    assert out["within_budget"] is True
    assert out["relative_deviation"] == pytest.approx(got[1], rel=1e-12)


def test_scaled_riders_tree_fails_the_budget_in_both(trees, capsys,
                                                     monkeypatch):
    root, golden, _, scaled = trees
    argv = [golden, scaled, "--root", root]
    want = _run_jax(capsys, monkeypatch, argv)
    got = _run_port(capsys, argv)
    assert got[0] == want[0]
    assert got[2] is want[2] is False
    for k in want[1]:
        assert abs(got[1][k] - want[1][k]) <= 1e-6, k
    assert min(got[1][k] for k in ("mae", "rmse")) > 0.01


@pytest.mark.parametrize("window", [("0", "50"), ("8", "20")])
def test_depth_window(trees, capsys, monkeypatch, window):
    """The defaults give the JAX tool's numbers; another window leaves the
    JAX tool's unchanged and moves the port's to JAX's metrics under
    that window."""
    root, golden, riders, _ = trees
    base = [golden, riders, "--root", root]
    flags = ["--min-depth", window[0], "--max-depth", window[1]]
    default = tgoldens.compare_goldens(golden, riders, root, device="cpu")
    got = tgoldens.compare_goldens(golden, riders, root,
                                   *map(float, window), device="cpu")
    jax_default = _run_jax(capsys, monkeypatch, base)
    jax_flags = _run_jax(capsys, monkeypatch, base + flags)
    assert jax_flags == jax_default
    assert _run_port(capsys, base + flags)[1] == got["relative_deviation"]
    cfg = jzju_config(root=root)
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, val_scenes=SCENES),
        eval=dataclasses.replace(cfg.eval, min_depth_val=float(window[0]),
                                 max_depth_val=float(window[1])))
    for tree, key in ((golden, "golden_metrics"), (riders, "riders_metrics")):
        want = jdrivers.evaluate_results_dir(cfg, tree)
        assert got[key] == pytest.approx(want, rel=1e-6), key
    if window == ("0", "50"):
        assert got == default
    else:
        assert got["golden_metrics"]["mae"] != default["golden_metrics"][
            "mae"]
        assert got["relative_deviation"] != default["relative_deviation"]


def test_default_device_raises_without_a_card(trees, monkeypatch):
    root, golden, riders, _ = trees
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgoldens.compare_goldens(golden, riders, root)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgoldens.main([golden, riders])
