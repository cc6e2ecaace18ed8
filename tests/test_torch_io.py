"""The port's IO against the JAX package's on the CPU: depth / response
PNG files (byte-identical, and each package reads the other's), the
dataset manifest, the stage-3 and stage-2 datasets (samples
byte-identical, training augmentations included) and BatchLoader
(batches equal for 1 and 4 threads, and for spawned decode processes),
on a synthetic mini-dataset written to a temp dir."""

import dataclasses
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from riders_tpu.core import config as jconfig
from riders_tpu.io import depthio as jdepthio
from riders_tpu.io import input_pipeline as jpipe
from riders_tpu.io import manifest as jmanifest
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.io import depthio as tdepthio
from riders_tpu_torch.io import input_pipeline as tpipe
from riders_tpu_torch.io import manifest as tmanifest
from test_drivers import make_mini_dataset

SCENES = ("scene-a", "scene-b")


def mini_configs(root, **sml_train):
    """The mini dataset's config in both packages: 96x128 frames, 48x32
    patches, a 16-point bucket, f32."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config(root=root)
        out.append(cfg.replace(
            dataset=dataclasses.replace(
                cfg.dataset, image_shape=(96, 128), max_points=16,
                train_scenes=SCENES[:1], val_scenes=SCENES[1:]),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96)),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32)),
            sml_train=dataclasses.replace(cfg.sml_train, **sml_train),
            compute_dtype="float32"))
    return out


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    """Two scenes of three frames, their stage-2 maps at thresholds 0.1
    and 0.2, and an .npy radar twin of scene-a's radar PNGs."""
    root = str(tmp_path_factory.mktemp("mini_io"))
    make_mini_dataset(root, list(SCENES))
    shutil.copytree(os.path.join(root, "output", "rcnet_0.1"),
                    os.path.join(root, "output", "rcnet_0.2"))
    npy = os.path.join(root, "scene-npy")
    shutil.copytree(os.path.join(root, "scene-a"), npy)
    radar_dir = os.path.join(npy, "radar_png")
    for name in sorted(os.listdir(radar_dir)):
        pts = jdepthio.load_radar_points(os.path.join(radar_dir, name))
        os.remove(os.path.join(radar_dir, name))
        np.save(os.path.join(radar_dir, name[:-4] + ".npy"), pts)
    return root


def _same_sample(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---- depthio ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["depth16", "depth32", "response",
                                  "color", "color_capped"])
def test_depthio_files_identical_and_cross_read(tmp_path, rng, kind):
    z = (80.0 * rng.random((20, 30))).astype(np.float32)
    z[rng.random(z.shape) < 0.3] = 0.0
    if kind == "depth32":
        z[3, 4] = 400.0                 # over 255.99 m: a mode-'I' PNG
    if kind == "response":
        z = (z / 80.0).astype(np.float32)
    paths = {}
    for name, mod in (("jax", jdepthio), ("torch", tdepthio)):
        paths[name] = str(tmp_path / f"{name}.png")
        if kind.startswith("color"):
            mod.save_color_depth(z, paths[name],
                                 50.0 if kind == "color_capped" else None)
        elif kind == "response":
            mod.save_response(z, paths[name])
        else:
            mod.save_depth(z, paths[name])
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    if kind.startswith("color"):
        return
    load = "load_response" if kind == "response" else "load_depth"
    ref = getattr(jdepthio, load)(paths["torch"])
    np.testing.assert_array_equal(getattr(tdepthio, load)(paths["jax"]),
                                  ref)
    if kind == "depth32":
        # Pillow writes mode 'I' as a 16-bit PNG: both packages clip
        # 400 m to the largest code, 65535 / 256 m
        assert ref[3, 4] == np.float32(65535 / 256.0)
        z[3, 4] = ref[3, 4]
    assert np.abs(ref - z).max() <= 1.0 / (
        256.0 if kind != "response" else 2 ** 14)


def test_depthio_points_and_images(tmp_path, rng, mini_root):
    pts = np.concatenate([rng.random((30, 2)) * [[128, 96]],
                          1 + 40 * rng.random((30, 1))], 1)
    pts[-1, :2] = [-3, 500]             # off the map: dropped
    np.save(tmp_path / "r.npy", pts.astype(np.float32))
    np.save(tmp_path / "one.npy", pts[0].astype(np.float32))
    for name in ("r.npy", "one.npy"):
        path = str(tmp_path / name)
        a, b = (m.load_radar_points(path) for m in (jdepthio, tdepthio))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            jdepthio.scatter_points_to_map(a, (96, 128)),
            tdepthio.scatter_points_to_map(b, (96, 128)))
        for n in (8, 64):
            for x, y in zip(jdepthio.pad_points(a, n),
                            tdepthio.pad_points(b, n)):
                np.testing.assert_array_equal(x, y)
    scene = os.path.join(mini_root, "scene-a")
    for sub, fn in (("radar_png", "load_radar_points"),
                    ("thermal_undistort", "load_image")):
        path = os.path.join(scene, sub, "000001.png")
        np.testing.assert_array_equal(getattr(jdepthio, fn)(path),
                                      getattr(tdepthio, fn)(path))
    np.testing.assert_array_equal(
        jdepthio.load_image(path, normalize=True),
        tdepthio.read_image_unit(path))


# ---- manifest --------------------------------------------------------------

@pytest.mark.parametrize("rcnet_interp", [None, "rcnet_0.1"])
def test_build_manifest_matches_jax(mini_root, rcnet_interp):
    jcfg, tcfg = mini_configs(mini_root)
    scenes = SCENES + ("scene-npy",)
    a = jmanifest.build_manifest(jcfg.dataset, scenes[:2], rcnet_interp)
    b = tmanifest.build_manifest(tcfg.dataset, scenes[:2], rcnet_interp)
    assert [dataclasses.asdict(r) for r in a] == [
        dataclasses.asdict(r) for r in b]
    assert len(b) == 6 and all(r.gt_sparse for r in b)
    # scene-npy has no stage-2 maps: only without require_all
    if rcnet_interp:
        with pytest.raises(ValueError, match="mismatch"):
            tmanifest.build_manifest(tcfg.dataset, scenes, rcnet_interp)
    a = jmanifest.build_manifest(jcfg.dataset, scenes, rcnet_interp,
                                 require_all=False)
    b = tmanifest.build_manifest(tcfg.dataset, scenes, rcnet_interp,
                                 require_all=False)
    assert [dataclasses.asdict(r) for r in a] == [
        dataclasses.asdict(r) for r in b]
    with pytest.raises(ValueError, match="no frames"):
        tmanifest.build_manifest(tcfg.dataset, ("nowhere",),
                                 require_all=False)
    if rcnet_interp:
        assert (tmanifest.swap_rcnet_threshold(b[0], 0.2)
                == jmanifest.swap_rcnet_threshold(a[0], 0.2))


# ---- datasets --------------------------------------------------------------

AUG = dict(random_crop_size=(80, 100), random_rcnet_thresholds=(0.1, 0.2),
           random_radar_noise=(-0.01, 0.01), random_flip=True)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("scene", ["scene-a", "scene-npy"])
def test_sml_frame_dataset_matches_jax(mini_root, train, scene):
    jcfg, tcfg = mini_configs(mini_root, **AUG)
    interp = "rcnet_0.1" if scene == "scene-a" else None
    recs = [m.build_manifest(c.dataset, (scene,), interp)
            for m, c in ((jmanifest, jcfg), (tmanifest, tcfg))]
    jds = jpipe.SMLFrameDataset(jcfg, recs[0], train=train, seed=5)
    tds = tpipe.SMLFrameDataset(tcfg, recs[1], train=train, seed=5)
    for epoch in range(2 if train else 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            _same_sample(jds[i], tds[i])


def test_sml_frame_dataset_refuses_dense_radar(mini_root):
    _, tcfg = mini_configs(mini_root)
    tcfg = tcfg.replace(alignment=dataclasses.replace(
        tcfg.alignment, max_valid_pixels=10))
    recs = tmanifest.build_manifest(tcfg.dataset, ("scene-a",))
    with pytest.raises(ValueError, match="max_valid_pixels"):
        tpipe.SMLFrameDataset(tcfg, recs)[0]


@pytest.mark.parametrize("image_range", [(0.0, 1.0), (-1.0, 1.0)])
def test_rcnet_inference_dataset_matches_jax(mini_root, image_range):
    out = []
    for mod, pipe, man in ((jconfig, jpipe, jmanifest),
                           (tconfig, tpipe, tmanifest)):
        cfg = mini_configs(mini_root)[mod is tconfig]
        cfg = cfg.replace(rcnet=dataclasses.replace(
            cfg.rcnet, normalized_image_range=image_range))
        recs = man.build_manifest(cfg.dataset, SCENES)
        out.append(pipe.RCNetInferenceDataset(cfg, recs))
    for i in range(len(out[1])):
        _same_sample(out[0][i], out[1][i])
    s = out[1][0]
    assert s["image"].shape == (96 + 48, 128 + 32, 3)
    assert s["points"].shape == (16, 3) and s["point_mask"].sum() == 16


# ---- BatchLoader -----------------------------------------------------------

def _loaders(mini_root, **kw):
    jcfg, tcfg = mini_configs(mini_root, **AUG)
    recs = [m.build_manifest(c.dataset, SCENES, "rcnet_0.1")
            for m, c in ((jmanifest, jcfg), (tmanifest, tcfg))]
    jl = jpipe.BatchLoader(jpipe.SMLFrameDataset(jcfg, recs[0], True, 7),
                           batch_size=4, seed=3, device_put=False,
                           drop_last=False)
    tl = tpipe.BatchLoader(tpipe.SMLFrameDataset(tcfg, recs[1], True, 7),
                           batch_size=4, seed=3, drop_last=False, **kw)
    return jl, tl


@pytest.mark.parametrize("threads", [1, 4])
def test_batch_loader_matches_jax(mini_root, threads):
    jl, tl = _loaders(mini_root, num_threads=threads, device_put=False)
    assert len(tl) == len(jl) == 2
    for _ in range(2):                  # epochs reshuffle and re-augment
        ja, ta = list(jl.epoch()), list(tl.epoch())
        assert len(ja) == len(ta) == 2
        for a, b in zip(ja, ta):
            _same_sample(a, b)


def test_batch_loader_device_put_and_processes(mini_root):
    """device_put gives tensors on the loader's device; decode in spawned
    processes gives the same batches as threads."""
    jl, tl = _loaders(mini_root, device="cpu", num_workers=2)
    assert tl.mp_context == "spawn"
    try:
        for _ in range(2):
            for a, b in zip(jl.epoch(), tl.epoch()):
                assert all(isinstance(v, torch.Tensor) and
                           v.device.type == "cpu" for v in b.values())
                _same_sample(a, {k: v.numpy() for k, v in b.items()})
        assert tl._pool is not None
    finally:
        tl.close()
    assert tl._pool is None


def test_batch_loader_early_close_and_errors(mini_root, monkeypatch):
    _, tl = _loaders(mini_root, device_put=False, prefetch=1)
    it = tl.epoch()
    next(it)
    it.close()                          # the producer stops and joins
    tl.dataset.records[1] = dataclasses.replace(
        tl.dataset.records[1], mono_pred="/nonexistent.png")
    with pytest.raises(FileNotFoundError):
        list(tl.epoch())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.BatchLoader(tl.dataset, 2)        # device_put to the card


# ---- logging ---------------------------------------------------------------

def test_logging_matches_jax(tmp_path, rng, monkeypatch, capsys):
    """ScalarWriter's JSON lines, the metric table, log_params and the
    mosaic PNG equal the JAX package's (TensorBoard absent: the import
    fails, as where it is not installed); `trace` writes the profiler's
    trace and, beside it, the port's spans of every thread on its
    clock."""
    from riders_tpu.core import logging as jlog
    from riders_tpu_torch.core import logging as tlog
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    scalars = {"loss": np.float32(0.25), "n": 3, "skip": "text",
               "t": torch.tensor(1.5)}
    arrays = {"resp": rng.random((4, 5)).astype(np.float32),
              "empty": np.zeros((0,), np.float32)}
    results = {k: float(i) + 0.123456 for i, k in enumerate(
        ("mae", "rmse", "imae", "irmse", "abs_rel", "sq_rel", "delta1"))}
    panels = [rng.random((12, 16, 3)).astype(np.float32),
              40 * rng.random((6, 8)).astype(np.float32)]
    out = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        d = tmp_path / name
        w = mod.ScalarWriter(str(d), "val")
        w.write(7, {k: v for k, v in scalars.items()
                    if name == "torch" or k != "t"})
        w.write_histograms(7, arrays)
        w.close()
        mod.log_evaluation_results("Results", results, 3, str(d / "log"))
        mod.log_params(str(d / "log"), {"b": 2, "a": (1, 2)})
        mod.save_image_mosaic(str(d / "m.png"), [panels, panels[::-1]],
                              max_depth=50.0)
        out[name] = [(d / f).read_bytes() for f in
                     ("scalars-val.jsonl", "log", "m.png")]
    jl, tl = out["jax"][0].splitlines(), out["torch"][0].splitlines()
    assert b'"t": 1.5' in tl[0] and tl[0].replace(b', "t": 1.5', b"") == jl[0]
    assert out["jax"][1:] == out["torch"][1:] and tl[1:] == jl[1:]
    assert "DELTA1" in capsys.readouterr().out

    timer = tlog.StepTimer(10)
    timer.tick(2)
    assert timer.format().startswith("Step=     2/10 ")
    from riders_tpu_torch.core import tracing
    assert not tracing.RECORDER.enabled

    def other_thread():
        tracing.request(5)
        with tracing.span("io.side"):
            pass

    with tlog.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).add_(1)
        tracing.request(4)
        with tracing.span("io.block"):
            torch.ones(8).add_(1)
        side = threading.Thread(target=other_thread)
        side.start()
        side.join(timeout=10)
        assert not side.is_alive()
    tracing.request(None)
    assert prof is not None
    assert not tracing.RECORDER.enabled
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "Name" in (tmp_path / "trace" / "kernels.txt").read_text()
    profiled = json.loads((tmp_path / "trace" / "trace.json").read_text())
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans["baseTimeNanoseconds"] == profiled.get(
        "baseTimeNanoseconds", 0)
    events = {e["name"]: e for e in spans["traceEvents"]}
    assert set(events) == {"io.block", "io.side"}
    for e in events.values():
        assert e["ph"] == "X" and e["pid"] == os.getpid() and e["dur"] >= 0
    assert events["io.block"]["tid"] == threading.get_native_id()
    assert events["io.side"]["tid"] != threading.get_native_id()
    assert events["io.block"]["args"] == {"request": 4, "parent": None}
    assert events["io.side"]["args"] == {"request": 5, "parent": None}
    # the main thread's span inside the profiler's range of its name,
    # widened by 2 ms (microseconds here)
    ranges = [e for e in profiled["traceEvents"]
              if e.get("name") == "io.block" and e.get("ph") == "X"]
    assert len(ranges) == 1
    span, host = events["io.block"], ranges[0]
    assert host["ts"] - 2e3 <= span["ts"]
    assert span["ts"] + span["dur"] <= host["ts"] + host["dur"] + 2e3
    with tlog.trace(None) as prof:
        assert prof is None
