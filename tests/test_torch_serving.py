"""The port's serving loop (pipelines.serving.FusedServer) and its on-disk
frame loader (FusedInferenceDataset) on the CPU: served outputs equal
direct calls of the fused function bit for bit, the uploader thread is
joined after a full run, after an early close and after an error, and
the loader's compact and f32 samples equal the JAX package's, the
per-dataset 16-bit probe and its float32 fallback included."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from riders_tpu.io import depthio as jdepthio
from riders_tpu.pipelines.serving import \
    FusedInferenceDataset as JaxFusedInferenceDataset
from riders_tpu_torch.core.config import ntu_config
from riders_tpu_torch.io.input_pipeline import BatchLoader
from riders_tpu_torch.models.layers import init_random_
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.pipelines.fused import make_fused_fn
from riders_tpu_torch.pipelines.serving import (FusedInferenceDataset,
                                                FusedServer)
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS

FRAME, PATCH, K = (48, 64), (66, 34), 8


def write_frames(root, rng, n, mono_mode="I;16"):
    """n frames of <name>_image.png, <name>_mono.png (x256 PNG16, or an
    8-bit 'L' PNG for mono_mode 'L') and <name>_radar.npy."""
    from PIL import Image
    H, W = FRAME
    names = []
    for i in range(n):
        base = os.path.join(root, f"f{i:03d}")
        depth = (5.0 + 40.0 * rng.random((H, W))).astype(np.float32)
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)
                        ).save(base + "_image.png")
        mono = (1.0 / depth) / 0.05
        if mono_mode == "L" and i == n - 1:
            Image.fromarray((mono * 40).astype(np.uint8)).save(
                base + "_mono.png")
        else:
            jdepthio.save_depth(mono, base + "_mono.png")
        n_pts = int(rng.integers(3, K + 4))
        flat = rng.choice(H * W, n_pts, replace=False)
        v, u = np.divmod(flat, W)
        np.save(base + "_radar.npy", np.stack(
            [u, v, depth[v, u]], 1).astype(np.float32))
        names.append(os.path.basename(base))
    return names


@pytest.fixture(scope="module")
def fused_fn():
    cfg = ntu_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, image_shape=FRAME,
                                    max_points=K),
        sml=dataclasses.replace(cfg.sml, net_shape=(64, 96), features=8),
        rcnet=dataclasses.replace(cfg.rcnet, patch_size=PATCH,
                                  **NARROW_RCNET))
    rcnet = init_random_(RCNet(cfg.rcnet, device="cpu"), 0)
    sml = init_random_(ScaleMapLearner(
        cfg.sml, "cpu", backbone_stages=TINY_STAGES,
        backbone_taps=TINY_TAPS, backbone_stem=8), 1)
    return make_fused_fn(cfg, rcnet, sml, device="cpu")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("served"))
    return root, write_frames(root, np.random.default_rng(4), 8)


def _batches(root, names, compact=True, batch_size=2):
    ds = FusedInferenceDataset(names, root, max_points=K, compact=compact)
    loader = BatchLoader(ds, batch_size, shuffle=False, device_put=False)
    return list(loader.epoch())


@pytest.mark.parametrize("compact", [True, False])
def test_served_outputs_equal_direct_calls(fused_fn, frames, compact):
    root, names = frames
    batches = _batches(root, names, compact)
    assert len(batches) == 4
    if compact:
        assert batches[0]["image"].dtype == np.uint8
        assert batches[0]["mono_pred"].dtype == np.uint16
    direct = [fused_fn(b).numpy() for b in batches]
    server = FusedServer(fused_fn, depth=2, device="cpu")
    served = list(server.run(iter(batches)))
    assert len(served) == len(direct)
    for a, b in zip(served, direct):
        assert isinstance(a, np.ndarray) and a.shape == (2,) + FRAME
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(served[0]).all()
    server.uploader.join(timeout=10)
    assert not server.uploader.is_alive()


def test_uploader_joined_after_early_close(fused_fn, frames):
    root, names = frames
    batches = _batches(root, names)
    fed = []

    def feed():                     # an endless stream
        while True:
            fed.append(1)
            yield batches[len(fed) % len(batches)]

    server = FusedServer(fused_fn, depth=1, device="cpu")
    run = server.run(feed())
    first = next(run)
    np.testing.assert_array_equal(first, fused_fn(batches[1]).numpy())
    run.close()
    assert not server.uploader.is_alive()
    n = len(fed)
    assert n <= 4                   # the queue holds one, the put one more


def test_uploader_error_is_raised_and_joined(fused_fn, frames):
    root, names = frames
    batches = _batches(root, names)

    def feed():
        yield batches[0]
        raise OSError("decode failed")

    server = FusedServer(fused_fn, device="cpu")
    with pytest.raises(OSError, match="decode failed"):
        list(server.run(feed()))
    assert not server.uploader.is_alive()
    assert threading.active_count() < 50
    with pytest.raises(ValueError, match="depth"):
        FusedServer(fused_fn, depth=0, device="cpu")


def test_server_refuses_the_cpu_without_a_request(fused_fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedServer(fused_fn)


@pytest.mark.parametrize("mono_mode", ["I;16", "L"])
@pytest.mark.parametrize("compact", [True, False])
def test_fused_dataset_matches_jax(tmp_path, rng, compact, mono_mode):
    """With one prior that is not a 16-bit PNG (an 8-bit 'L' file here;
    older Pillow read 16-bit files as mode 'I') the compact loader stages
    every prior of the dataset as float32."""
    names = write_frames(str(tmp_path), rng, 3, mono_mode)
    a = JaxFusedInferenceDataset(names, str(tmp_path), K, compact)
    b = FusedInferenceDataset(names, str(tmp_path), K, compact)
    for i in range(len(b)):
        x, y = a[i], b[i]
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    want = (np.uint16 if compact and mono_mode == "I;16" else np.float32)
    assert all(b[i]["mono_pred"].dtype == want for i in range(3))
    assert b[0]["image"].dtype == (np.uint8 if compact else np.float32)
