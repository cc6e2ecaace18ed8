"""The port's parallel layer (riders_tpu_torch.parallel.sharding) on the
CPU: mesh shapes and their errors, the sharded fused path and the
data-parallel training steps in gloo jobs of 2 and 4 processes
(tests/torch_sharding_worker.py: one thread each, no JAX, a free port,
joined with a timeout).

* The sharded fused path on the tiny ZJU configuration of
  tests/test_sharding.py (narrow widths, f32, weights carried across
  from JAX's models by models.from_jax) on (data, points) meshes (2, 2)
  and (1, 2): against JAX's make_sharded_fused_fn on this process's 8
  virtual CPU devices at that test's bar (mean relative error < 1e-6,
  max < 5e-3), and against the port's unsharded path at rtol 1e-5.
* The RC-Net step on meshes (2, 1) and (1, 2) and the SML step on (2, 1)
  with w_unsupervised > 0 (the batch-wide median), each against the
  port's unsharded step at tests/test_torch_training.py's bar: the loss
  and aux to rtol 1e-4; every gradient to rtol 1e-4 with atol 1e-4 of
  the tensor's max abs; the parameters after two Adam steps to rtol 1e-4
  (atol 1e-4 of the max abs), or within 2 x the summed rates where the
  first gradient is within that atol of 0; the BN running statistics to
  rtol 1e-4 (atol 1e-4 of the max abs).  RC-Net in f32; SML in f32 for
  the loss and the statistics after one step and in f64 for the
  gradients and parameters, as that test does (ReLU masks flip on f32
  rounding).
"""

import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.pipelines.fused import (
    make_sharded_fused_fn as jax_sharded_fused_fn)
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.io.input_pipeline import BatchLoader
from riders_tpu_torch.models.from_jax import rcnet_from_jax, sml_from_jax
from riders_tpu_torch.models.layers import init_random_
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.parallel import sharding as sh
from riders_tpu_torch.pipelines import drivers
from riders_tpu_torch.pipelines.fused import make_fused_fn
from test_torch_fused import _batch as fused_batch
from test_torch_training import _configs as training_configs
from test_torch_training import _sml_batch
from torch_common import (NARROW_RCNET, TINY_STAGES, TINY_TAPS, perturbed,
                          rcnet_inputs)
from torch_sharding_worker import run_steps

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_sharding_worker.py"
BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)
RTOL = 1e-4
LR_SUM = {"rcnet": 2 * 2e-4, "sml": 5e-5 + 2e-5}


@contextlib.contextmanager
def _one_thread():
    """The workers' thread count for a reference computed here: CPU
    kernels sum in another order with another count of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _launch(tmp_path, world, job, timeout=300):
    """Run `job` on `world` worker processes (gloo on a free local port)
    and return each rank's results."""
    job_path = tmp_path / f"job{world}.pt"
    torch.save(job, job_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / f"out{world}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(job_path), str(out),
         f"127.0.0.1:{port}", str(world), str(rank)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return [torch.load(f"{out}.{rank}", weights_only=False)
            for rank in range(world)]


def test_mesh_shapes():
    assert sh.mesh_shape(-1, 1, 8) == (8, 1)
    assert sh.mesh_shape(4, 2, 8) == (4, 2)
    assert sh.mesh_shape(-1, 2, 8) == (4, 2)
    assert sh.mesh_shape(2, 2, 8) == (2, 2)          # a subset, as JAX
    mesh = sh.make_mesh()                            # no process group
    assert mesh.devices_shape == (1, 1) and mesh.size == 1
    cfg = tconfig.zju_config().mesh
    assert (cfg.data_parallel, cfg.points_parallel) == (-1, 1)
    assert sh.mesh_from_config(cfg).devices_shape == (1, 1)


def test_mesh_undersupply_raises():
    with pytest.raises(ValueError, match="have 8"):
        sh.mesh_shape(8, 2, 8)
    with pytest.raises(ValueError, match="have 1"):
        sh.make_mesh(n_data=4, n_points=2)
    with pytest.raises(ValueError, match="n_points"):
        sh.mesh_shape(-1, 16, 8)
    with pytest.raises(ValueError, match="n_points must be"):
        sh.make_mesh(n_data=1, n_points=0)


def test_initialize_multihost_needs_the_card_by_default(monkeypatch):
    """Without a card the default device raises before joining; a
    coordinator needs the process count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sh.initialize_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="go together"):
        sh.initialize_multihost("127.0.0.1:1", None, 0, device="cpu")
    with pytest.raises(ValueError, match="process id"):
        sh.initialize_multihost("127.0.0.1:1", 2, 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_maybe_shard_training_rules():
    """A world of one gets the step back; a configured data size that
    does not divide the batch raises."""
    cfg = tconfig.ntu_config()
    step = object()
    assert drivers._maybe_shard_training(cfg, step, 24) == (step, None)
    bad = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data_parallel=5))
    with pytest.raises(ValueError, match="data_parallel=5"):
        drivers._maybe_shard_training(bad, step, 24)


def test_cross_rank_batch_norm_matches_batch_norm_on_low_variance():
    """The cross-rank BatchNorm against torch's train-mode BatchNorm on
    channels whose variance is small against their mean (mean 100, std
    1e-3): outputs within 1e-4 of their max abs, input, weight and bias
    gradients within 1e-4 of theirs, and the statistics.  It centres
    before it scales: an eval-mode kernel given the same statistics
    folds the mean into the shift, which cancels here (8.5e-4 off)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 3, 8, 8, generator=g)
         * torch.tensor([1.0, 1e-3, 1e-2])[None, :, None, None]
         + torch.tensor([0.5, 100.0, -30.0])[None, :, None, None])
    w, b = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
    dy = torch.randn(x.shape, generator=g)
    leaves = [[t.clone().requires_grad_() for t in (x, w, b)]
              for _ in range(2)]
    want = torch.nn.functional.batch_norm(*leaves[0][:1], None, None,
                                          *leaves[0][1:], True, 0.0, 1e-5)
    got, mean, var = sh.cross_rank_batch_norm(
        *leaves[1], 1e-5, sh.make_mesh().axis(sh.DATA_AXIS))
    (want * dy).sum().backward()
    (got * dy).sum().backward()
    _close(got.detach(), want.detach(), "y")
    for a, c, name in zip(leaves[1], leaves[0], ("x", "weight", "bias")):
        _close(a.grad, c.grad, name)
    v, m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    np.testing.assert_allclose(mean, m, rtol=1e-6)
    np.testing.assert_allclose(var, v, rtol=1e-4)


def test_batch_loader_rows_are_the_whole_batches_rows():
    """A rank's loader yields its rows of each batch of the unsharded
    loader, in the same shuffle order."""
    data = [{"i": np.asarray(i)} for i in range(10)]
    whole = BatchLoader(data, 4, seed=3, device_put=False, num_threads=1)
    half = BatchLoader(data, 4, seed=3, device_put=False, num_threads=1,
                       rows=slice(2, 4))
    for _ in range(2):
        w = [b["i"] for b in whole.epoch()]
        h = [b["i"] for b in half.epoch()]
        assert len(w) == len(h) == 2
        for a, b in zip(w, h):
            np.testing.assert_array_equal(a[2:4], b)


# --- the gloo jobs ------------------------------------------------------

def _fused_configs():
    """tests/test_sharding.py's tiny ZJU configuration, narrow widths, in
    both packages, JAX's mesh (2, 2)."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config()
        out.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=(96, 128),
                                        max_points=8),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32),
                                      **NARROW_RCNET),
            mesh=dataclasses.replace(cfg.mesh, data_parallel=2,
                                     points_parallel=2)))
    return out


@pytest.fixture(scope="module")
def fused_setup():
    """JAX's sharded fused output on the (2, 2) virtual-device mesh, and
    the port's models on the same variables with its unsharded output."""
    rng = np.random.default_rng(7)
    jcfg, tcfg = _fused_configs()
    ph, pw = jcfg.rcnet.patch_size
    rcnet, sml = JaxRCNet(config=jcfg.rcnet), JaxSML(config=jcfg.sml,
                                                     **BACKBONE)
    rc_vars = perturbed(jax.jit(rcnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32 + ph, 32 + pw, 3)),
        jnp.asarray([[[pw / 2, ph / 2, 10.0]]], jnp.float32),
        jnp.asarray([[[0.0, 0.0, float(pw), float(ph)]]], jnp.float32),
        jnp.ones((1, 1))), rng)
    h, w = jcfg.sml.net_shape
    sml_vars = perturbed(jax.jit(sml.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3)),
        jnp.ones((1, h, w, 1))), rng)
    batch = fused_batch(rng, jcfg.dataset.image_shape, B=4, K=8, n_real=6)
    jax_depth = np.asarray(jax_sharded_fused_fn(jcfg, rcnet, sml)(
        rc_vars, sml_vars, batch))
    port_rcnet = rcnet_from_jax(tcfg.rcnet, rc_vars, device="cpu")
    port_sml = sml_from_jax(tcfg.sml, sml_vars, device="cpu", **BACKBONE)
    with _one_thread():
        unsharded = make_fused_fn(tcfg, port_rcnet, port_sml,
                                  device="cpu")(batch).numpy()
    task = dict(kind="fused", cfg=tcfg, rcnet=port_rcnet.state_dict(),
                sml=port_sml.state_dict(), backbone=BACKBONE, batch=batch)
    return task, jax_depth, unsharded


def _rcnet_task(mesh, B=2):
    """RC-Net at test_torch_training's sizes, K = 4 (the last slot
    masked) so that the points split in two."""
    rng = np.random.default_rng(10)
    _, tcfg = training_configs()
    image, pts, boxes, mask = rcnet_inputs(rng, (64, 32), B=B, K=4,
                                           H=40, W=56)
    gt = (pts[..., 2][:, :, None, None, None]
          + rng.normal(0.0, 0.6, (B, 4, 64, 32, 1))).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = 0.0
    model = init_random_(RCNet(tcfg.rcnet, "cpu"), 3)
    return dict(kind="step", model="rcnet", cfg=tcfg, mesh=mesh,
                state=model.state_dict(),
                batch=dict(image=image, points=pts, boxes=boxes,
                           gt_crops=gt, point_mask=mask))


def _sml_task(dtype):
    """SML at test_torch_training's sizes with w_unsupervised 0.5, its
    head scaled so the prediction stays inside the clamps."""
    rng = np.random.default_rng(11)
    _, tcfg = training_configs()
    tcfg = tcfg.replace(sml_train=dataclasses.replace(
        tcfg.sml_train, w_unsupervised=0.5))
    model = init_random_(ScaleMapLearner(tcfg.sml, "cpu", **BACKBONE), 4)
    with torch.no_grad():
        model.output_conv.conv3.weight.mul_(0.02)
        model.output_conv.conv3.bias.mul_(0.1)
    return dict(kind="step", model="sml", cfg=tcfg, mesh=(2, 1),
                backbone=BACKBONE, state=model.to(dtype).state_dict(),
                batch=_sml_batch(rng))


@pytest.fixture(scope="module")
def jobs(fused_setup, tmp_path_factory):
    """The 4-process job (the fused path on (2, 2), shard_batch's rows),
    the 2-process job (the fused path on (1, 2), the RC-Net step on
    (2, 1) and (1, 2), the SML step on (2, 1) in f32 and f64) and the
    3-process job (the trainers' mesh for batches of 4 and 5)."""
    tmp = tmp_path_factory.mktemp("sharding")
    fused = fused_setup[0]
    rng = np.random.default_rng(5)
    shard = dict(kind="shard", mesh=(2, 2), batch={
        "image": rng.random((4, 6, 6, 3)).astype(np.float32),
        "points": rng.random((4, 8, 3)).astype(np.float32),
        "point_mask": np.ones((4, 8), np.float32)})
    four = _launch(tmp, 4, {"fused": dict(fused, mesh=(2, 2)),
                            "shard": shard})
    tasks = {"fused": dict(fused, mesh=(1, 2)),
             "rcnet21": _rcnet_task((2, 1)), "rcnet12": _rcnet_task((1, 2)),
             "sml32": dict(_sml_task(torch.float32), steps=1),
             "sml64": _sml_task(torch.float64)}
    two = _launch(tmp, 2, tasks)
    trainer = dict(_rcnet_task(None, B=4), kind="trainer", roles=(4, 5))
    three = _launch(tmp, 3, {"trainer": trainer})
    return {4: four, 2: two, 3: three}, dict(tasks, shard=shard,
                                             trainer=trainer)


def test_shard_batch_rows(jobs):
    """On (2, 2), rank r = 2 d + p holds frames 2d, 2d + 1 of every key
    and, of the point keys, points 4p .. 4p + 3; a K that does not split
    raises."""
    results, tasks = jobs
    batch = tasks["shard"]["batch"]
    for rank, r in enumerate(results[4]):
        d, p = divmod(rank, 2)
        assert r["shard"]["coords"] == (d, p)
        local = r["shard"]["local"]
        np.testing.assert_array_equal(local["image"],
                                      batch["image"][2 * d:2 * d + 2])
        for k in ("points", "point_mask"):
            np.testing.assert_array_equal(
                local[k], batch[k][2 * d:2 * d + 2, 4 * p:4 * p + 4])
        assert "does not split" in r["shard"]["error"]


@pytest.mark.parametrize("world,mesh", [(4, (2, 2)), (2, (1, 2))])
def test_sharded_fused_matches_jax_and_unsharded(fused_setup, jobs, world,
                                                 mesh):
    """Every rank returns the global depth; its collectives ran."""
    _, jax_depth, unsharded = fused_setup
    results = jobs[0][world]
    depth = results[0]["fused"]["depth"].numpy()
    for r in results[1:]:
        np.testing.assert_array_equal(r["fused"]["depth"].numpy(), depth)
    assert depth.shape == jax_depth.shape == (4, 96, 128)
    assert np.isfinite(depth).all()
    err = np.abs(depth - jax_depth) / (np.abs(jax_depth) + 1e-3)
    assert np.mean(err) < 1e-6, float(np.mean(err))
    assert np.max(err) < 5e-3, float(np.max(err))
    np.testing.assert_allclose(depth, unsharded, rtol=1e-5)
    for r in results:
        assert r["fused"]["calls"] == {"all_gather:points": 1,
                                       "all_gather:data": 1}


def _close(got, want, what, scale=None):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _check_step(got, want, kind, grads=True, params=True):
    """The sharded step's results against the unsharded step's, by
    tests/test_torch_training.py's rules."""
    assert set(got["aux"]) == set(want["aux"])
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, rtol=RTOL, err_msg=k)
    state_g, state_w = got["state"], want["state"]
    for k, w in state_w.items():
        if "running" in k:
            _close(state_g[k], w, k)
    if grads:
        assert set(got["grads"]) == set(want["grads"])
        largest = max(float(g.abs().max()) for g in want["grads"].values())
        for k, w in want["grads"].items():
            _close(got["grads"][k], w, k,
                   max(float(w.abs().max()), 1e-6 * largest))
    if params:
        largest = max(float(g.abs().max()) for g in want["grads"].values())
        for k, g in want["grads"].items():
            g = g.abs().numpy()
            free = g <= RTOL * max(g.max(), 1e-6 * largest)
            w = state_w[k].numpy()
            diff = np.abs(state_g[k].numpy() - w)
            limit = np.where(free, 2 * LR_SUM[kind],
                             RTOL * np.abs(w) + RTOL * np.abs(w).max())
            assert (diff <= limit).all(), (k, float(diff.max()))


@pytest.mark.parametrize("name", ["rcnet21", "rcnet12"])
def test_sharded_rcnet_step_matches_unsharded(jobs, name):
    """Meshes (2, 1) and (1, 2): frames over `data` (the encoder's BN
    over the frames, the decoder's over every rank's patches), points
    over `points`; loss, aux, gradients, BN statistics and parameters
    after two Adam steps."""
    results, tasks = jobs
    with _one_thread():
        want = run_steps(tasks[name])
    for r in results[2]:
        _check_step(r[name], want, "rcnet")
        assert r[name]["calls"]["all_reduce:mesh"] > 0
    assert results[2][0][name]["state"].keys() == want["state"].keys()


def test_sharded_sml_step_with_median_matches_unsharded(jobs):
    """Mesh (2, 1) with w_unsupervised > 0, so the batch-wide median is
    taken over both ranks' frames: f32 loss, aux and BN statistics, then
    f64 gradients and parameters."""
    results, tasks = jobs
    with _one_thread():
        want32 = run_steps(tasks["sml32"])
        want64 = run_steps(tasks["sml64"])
    assert want32["aux"]["loss_unsupervised"] > 0
    for r in results[2]:
        _check_step(r["sml32"], want32, "sml", grads=False, params=False)
        _check_step(r["sml64"], want64, "sml")
        assert r["sml64"]["calls"]["all_gather:data"] > 0


def test_trainer_mesh_leaves_extra_ranks_out(jobs):
    """Three ranks, batch 4: the data size falls to 2, ranks 0 and 1 take
    rows 0-1 and 2-3 and step as the unsharded step on all four, rank 2
    sits out.  Batch 5: no data size above 1 divides it, so rank 0 trains
    the whole batch alone and ranks 1 and 2 sit out."""
    results, tasks = jobs
    roles = [r["trainer"]["roles"] for r in results[3]]
    assert roles == [{4: (0, 2), 5: "whole"}, {4: (2, 4), 5: "out"},
                     {4: "out", 5: "out"}]
    assert results[3][2]["trainer"]["steps"] is None
    task = dict(tasks["trainer"], kind="step")
    with _one_thread():
        want = run_steps(task)
    for r in results[3][:2]:
        _check_step(r["trainer"]["steps"], want, "rcnet")
