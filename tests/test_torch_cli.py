"""The port's command line (riders_tpu_torch.cli) against the JAX
package's `riders`.

* `_load_config`: the same field paths as JAX's and equal to it on
  every field, for each preset and every override flag; each preset's
  `dataclasses.asdict` equal to JAX's, and its `log_params` lines (what
  both trainers log) JAX's.
* Every subcommand but `bench` runs with `--device cpu` on the
  synthetic mini-dataset of tests/test_drivers.py (the presets cut to
  its 96x128 frames, narrow RC-Net widths and a tiny SML backbone), and
  writes what its driver writes.
* `bench` reaches `riders_tpu_torch.bench.main` with its flags;
  `--multihost` with its companion flags joins a gloo world of one
  around the command; without
  `--device`, every subcommand raises on a host with no card before it
  reads a file.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from riders_tpu import cli as jcli
from riders_tpu_torch import cli as tcli
from riders_tpu_torch.core import checkpoint as tckpt
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.preprocess import project as tproject
from riders_tpu_torch.pipelines import drivers as tdrivers
from test_drivers import make_mini_dataset
from test_torch_preprocess import write_raw_scene
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS

BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)

OVERRIDES = {
    "train-sml": ["--train-scenes", "s1", "s2", "--val-scenes", "v1",
                  "--rcnet-interp", "interp", "--batch-size", "3"],
    "train-rcnet": ["--train-scenes", "s1", "--batch-size", "5"],
    "run-rcnet": ["--val-scenes", "v1", "v2", "--threshold", "0.25"],
    "val-sml": ["--rcnet-interp", "interp-exact", "--val-scenes", "v1"],
    "val-rcnet": [],
    "eval-dir": ["--val-scenes", "v1"],
    "preprocess": [],
}
REQUIRED = {"train-sml": ["--ckpt", "c"], "train-rcnet": ["--ckpt", "c"],
            "run-rcnet": ["--ckpt", "c", "--output", "o"],
            "val-sml": ["--ckpt", "c"], "val-rcnet": ["--ckpt", "c"],
            "eval-dir": ["--results", "r"], "preprocess": ["--output", "o"]}


def _field_paths(cfg, path=""):
    """The dotted path of every leaf field of a configuration tree."""
    for f in dataclasses.fields(cfg):
        x = getattr(cfg, f.name)
        if dataclasses.is_dataclass(x):
            yield from _field_paths(x, f"{path}{f.name}.")
        else:
            yield f"{path}{f.name}"


def _common_fields(a, b, path=""):
    """(path, port value, JAX value) of every leaf field the two
    configuration trees share."""
    names = {f.name for f in dataclasses.fields(a)} & {
        f.name for f in dataclasses.fields(b)}
    for name in sorted(names):
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            yield from _common_fields(x, y, f"{path}{name}.")
        else:
            yield f"{path}{name}", x, y


@pytest.mark.parametrize("dataset", ["zju", "ntu"])
@pytest.mark.parametrize("command", sorted(OVERRIDES))
def test_load_config_matches_jax(command, dataset):
    configs = []
    for extra in ([], OVERRIDES[command]):
        args = tcli._parser().parse_args(
            [command, "--dataset", dataset, "--root", "/data/x"]
            + REQUIRED[command] + extra)
        got, want = tcli._load_config(args), jcli._load_config(args)
        assert set(_field_paths(got)) == set(_field_paths(want))
        fields = list(_common_fields(got, want))
        assert len(fields) > 70
        for path, x, y in fields:
            assert x == y, path
        configs.append(got)
    assert configs[0].dataset.root == "/data/x"
    assert (configs[0] != configs[1]) == bool(OVERRIDES[command])


@pytest.mark.parametrize("preset", ["zju_config", "ntu_config"])
def test_config_dicts_and_logged_params_match_jax(preset, capsys):
    """Both trainers log `log_params(asdict(cfg))`: the same key=value
    lines in both packages."""
    from riders_tpu.core import config as jconfig
    from riders_tpu.core import logging as jlog
    from riders_tpu_torch.core import logging as tlog

    got = dataclasses.asdict(getattr(tconfig, preset)(root="/data/x"))
    want = dataclasses.asdict(getattr(jconfig, preset)(root="/data/x"))
    assert got == want
    capsys.readouterr()
    jlog.log_params(None, want)
    jax_lines = capsys.readouterr().out
    tlog.log_params(None, got)
    assert capsys.readouterr().out == jax_lines
    assert len(jax_lines.splitlines()) == len(want) == 9


def test_bench_and_multihost_raise(mini, monkeypatch):
    """`bench` runs `riders_tpu_torch.bench.main` with its flags (as
    `riders bench` runs bench.py); `--multihost` joins a world of one
    (gloo, with `--device cpu`) for the command and leaves it after."""
    import socket
    import torch.distributed as dist
    from riders_tpu_torch import bench as tbench

    calls = []
    monkeypatch.setattr(tbench, "main", lambda argv: calls.append(argv) or 0)
    assert tcli.main(["bench"]) == 0
    assert tcli.main(["bench", "--zju"]) == 0
    assert tcli.main(["bench", "--ntu"]) == 0
    assert calls == [[], ["--zju"], ["--ntu"]]
    seen = []
    real = tdrivers.evaluate_results_dir

    def spy(cfg, *a, **k):
        seen.append((dist.get_backend(), dist.get_world_size(),
                     dist.get_rank(), str(k["device"])))
        return real(cfg, *a, **k)

    monkeypatch.setattr(tdrivers, "evaluate_results_dir", spy)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root, _, _ = mini
    assert run(root, "eval-dir", "--results", root, "--subdir", "lidar_png",
               "--multihost",
               "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
               "--process-id", "0") == 0
    assert seen == [("gloo", 1, 0, "cpu")]
    assert not dist.is_initialized()


@pytest.mark.parametrize("command", sorted(REQUIRED))
def test_default_device_raises_without_a_card(monkeypatch, tmp_path,
                                              command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main([command, "--root", missing] + [
            missing if a in ("c", "o", "r") else a
            for a in REQUIRED[command]])
    assert not os.path.exists(missing)


ZJU_PRESET = tconfig.zju_config


def _mini_config(root="", **_):
    """The zju preset cut to the mini dataset."""
    cfg = ZJU_PRESET(root=root)
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, image_shape=(96, 128), max_points=16,
            train_scenes=("scene-a",), val_scenes=("scene-b",)),
        sml=dataclasses.replace(cfg.sml, net_shape=(64, 96), features=8),
        rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32),
                                  **NARROW_RCNET),
        sml_train=dataclasses.replace(
            cfg.sml_train, batch_size=2, n_step_per_checkpoint=2,
            n_step_per_summary=1, learning_schedule=(1, 2)),
        rcnet_train=dataclasses.replace(
            cfg.rcnet_train, batch_size=1, points_per_frame=4,
            n_step_per_checkpoint=2, n_step_per_summary=1,
            learning_schedule=(1,)),
        compute_dtype="float32")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The mini dataset, the zju preset cut to it, and the two trainers
    run through the CLI (two steps each)."""
    root = str(tmp_path_factory.mktemp("mini_cli"))
    make_mini_dataset(root, ["scene-a", "scene-b"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "zju_config", _mini_config)
        mp.setattr(tdrivers, "build_sml_model",
                   lambda cfg, device, dtype: tdrivers.ScaleMapLearner(
                       cfg.sml, device, dtype, **BACKBONE))
        ckpt = {k: os.path.join(root, "ckpt", k) for k in ("rcnet", "sml")}
        for command in ("train-rcnet", "train-sml"):
            assert tcli.main([command, "--root", root, "--device", "cpu",
                              "--ckpt", ckpt[command[6:]],
                              "--max-steps", "2"]) == 0
        yield root, ckpt, mp


def run(root, *args):
    return tcli.main([args[0], "--root", root, "--device", "cpu",
                      *args[1:]])


def test_cli_trainers_write_checkpoints(mini):
    _, ckpt, _ = mini
    for kind in ("rcnet", "sml"):
        assert tckpt.all_steps(ckpt[kind]) == [2]
        with open(os.path.join(ckpt[kind], "scalars-train.jsonl")) as f:
            steps = [json.loads(line).get("step") for line in f]
        assert steps[:2] == [1, 2]
    assert os.path.exists(os.path.join(ckpt["rcnet"], "summaries",
                                       "step2.png"))


def test_cli_train_sml_interp_resumes(mini, tmp_path):
    root, ckpt, _ = mini
    out = str(tmp_path / "sml_interp")
    for steps in ("1", "2"):
        assert run(root, "train-sml", "--ckpt", out, "--rcnet-interp",
                   "interp", "--max-steps", steps, "--resume") == 0
    assert tckpt.all_steps(out) == [1, 2]


def test_cli_run_rcnet_val_rcnet_and_eval_dir(mini, tmp_path, capsys):
    root, ckpt, _ = mini
    out = str(tmp_path / "out")
    assert run(root, "run-rcnet", "--ckpt", ckpt["rcnet"], "--output", out,
               "--threshold", "0.3") == 0
    pred_dir = os.path.join(out, "rcnet_0.3", "scene-b", "depth_predicted")
    assert len(os.listdir(pred_dir)) == 3
    assert depthio.load_depth(os.path.join(pred_dir, "000000.png")
                              ).shape == (96, 128)
    assert run(root, "val-rcnet", "--ckpt", ckpt["rcnet"]) == 0
    assert "RC-Net best" in capsys.readouterr().out
    log = str(tmp_path / "eval.log")
    assert run(root, "eval-dir", "--results", os.path.join(out, "rcnet_0.3"),
               "--subdir", "depth_predicted", "--log", log) == 0
    with open(log) as f:
        assert "Scored 3 frames" in f.read()


def test_cli_val_sml_with_a_depth_predictor(mini, tmp_path, monkeypatch):
    root, ckpt, _ = mini
    seen = []
    real = tdrivers.validate_sml

    def spy(cfg, *a, **k):
        seen.append(cfg)
        return real(cfg, *a, **k)

    monkeypatch.setattr(tdrivers, "validate_sml", spy)
    out = str(tmp_path / "val")
    assert run(root, "val-sml", "--ckpt", ckpt["sml"], "--output", out,
               "--save-output", "--depth-predictor", "midas_small",
               "--void-sparsity", "500") == 0
    sml = seen[0].sml
    assert sml.net_shape == (288, 384)
    assert (sml.int_depth_mean, sml.int_scales_std) == (0.731, 0.136)
    assert len(os.listdir(os.path.join(out, "SML", "scene-b",
                                       "sml_depth"))) == 3


def test_cli_preprocess(mini, tmp_path, capsys):
    raw = str(tmp_path / "raw")
    write_raw_scene(raw, "scene-z", tproject.zju_calibration(), 1, seed=4,
                    n_lidar=3000, n_radar=100)
    out = str(tmp_path / "processed")
    assert tcli.main(["preprocess", "--root", raw, "--output", out,
                      "--device", "cpu"]) == 0
    assert "scene-z: 1 frames" in capsys.readouterr().out
    for d in ("thermal_undistort", "radar_png", "radar_npy", "lidar_png",
              "lidar_png_int"):
        assert len(os.listdir(os.path.join(out, "scene-z", d))) == 1, d
    dense = depthio.load_depth(os.path.join(out, "scene-z", "lidar_png_int",
                                            "000000.png"))
    assert dense.shape == (480, 640) and np.count_nonzero(dense) > 1000
