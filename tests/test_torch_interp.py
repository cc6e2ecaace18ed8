"""The port's densifiers (ops/interp.py, io/native.py) against the JAX
package's on seeded sparse maps.

* IDW (`idw_interpolate`, `idw_scale_map`): rtol 1e-5 (the two sum the
  K weighted terms in their own order); the knot indices are equal,
  also with more than 128 valid pixels, where both keep the first 128
  in row-major order; a frame with no knot is all ones.
* griddata (`interpolate_scale_knots`, `exact_scale_map`): bitwise (the
  same scipy call on the same float32 inputs).
* Delaunay (`delaunay_interpolate` native and scipy, `_windowed`):
  bitwise against JAX's same form (the same C++ source with the same
  flags, or the same scipy call).  The JAX side's library is loaded
  through `torch_common.jax_native_library`, so it never densifies on
  its quiet scipy fall-back; six processes released at once on a copy
  of native/ with no library all load it through that helper.
* Stage 1 with the 'interp' / 'interp-exact' sources: rtol 1e-5, atol
  1e-4, within the staged-SML bar of test_torch_inference.py (rtol 1e-3,
  atol 1e-4).  The aligned priors differ by about an ulp (1e-7), and
  the unit-range normalisation of a frame with 6 knots, then the
  standardisation (/ 0.117), takes that to ~4e-5 in the scales channel,
  as it does with the 'none' source on these frames.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.io import native as jnative
from riders_tpu.ops import interp as jinterp
from riders_tpu.pipelines.sml_inference import \
    prepare_sml_inputs as jax_prepare
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.io import native as tnative
from riders_tpu_torch.ops import interp as tinterp
from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs
from torch_common import jax_native_library

H, W = 40, 56


def knot_maps(rng, n, shape=(H, W)):
    """An inverse-depth prior, sparse inverse depth at n distinct pixels
    and their 0/1 validity."""
    prior = (0.05 + rng.random(shape)).astype(np.float32)
    sparse = np.zeros(shape, np.float32)
    valid = np.zeros(shape, np.float32)
    idx = rng.choice(prior.size, n, replace=False)
    valid.reshape(-1)[idx] = 1.0
    sparse.reshape(-1)[idx] = (0.02 + 0.3 * rng.random(n)).astype(
        np.float32)
    return prior, sparse, valid


def sparse_depth(rng, n, shape=(H, W), lo=1.0, span=40.0):
    depth = np.zeros(shape, np.float32)
    idx = rng.choice(depth.size, n, replace=False)
    depth.reshape(-1)[idx] = (lo + span * rng.random(n)).astype(np.float32)
    return depth


@pytest.mark.parametrize("n", [0, 2, 17, 128, 300])
def test_idw_scale_map_matches_jax(rng, n):
    maps = knot_maps(rng, n)
    want = np.asarray(jax.jit(jinterp.idw_scale_map)(
        *(jnp.asarray(m) for m in maps)))
    got = tinterp.idw_scale_map(*(torch.from_numpy(m)[None]
                                  for m in maps))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if n == 0:
        assert (got == 1.0).all()
    # the knots: JAX's top_k of the 0/1 mask (ties lowest index first)
    _, jidx = jax.lax.top_k(jnp.asarray(maps[2].reshape(-1)), 128)
    tidx = tinterp.knot_indices(torch.from_numpy(maps[2])[None])[0]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if n > 128:
        first = np.flatnonzero(maps[2].reshape(-1))[:128]
        np.testing.assert_array_equal(tidx.numpy(), first)


def test_idw_scale_map_batches_frames_independently(rng):
    frames = [knot_maps(rng, n) for n in (0, 40, 200)]
    stacked = [torch.from_numpy(np.stack(m)) for m in zip(*frames)]
    got = tinterp.idw_scale_map(*stacked).numpy()
    for b, maps in enumerate(frames):
        one = tinterp.idw_scale_map(*(torch.from_numpy(m)[None]
                                      for m in maps))[0].numpy()
        np.testing.assert_array_equal(got[b], one)


@pytest.mark.parametrize("power,n_valid", [(2.0, 9), (3.0, 9), (2.0, 0)])
def test_idw_interpolate_matches_jax(rng, monkeypatch, power, n_valid):
    K = 12
    uv = np.stack([rng.random(K) * (W - 1), rng.random(K) * (H - 1)],
                  -1).astype(np.float32)
    val = rng.random(K).astype(np.float32)
    mask = np.zeros(K, np.float32)
    mask[:n_valid] = 1.0
    want = np.asarray(jinterp.idw_interpolate(
        jnp.asarray(uv), jnp.asarray(val), jnp.asarray(mask), (H, W),
        power=power))
    # rows in chunks of 3 exercise the chunk seams
    monkeypatch.setattr(tinterp, "IDW_CHUNK_ELEMS", 3 * K * W)
    got = tinterp.idw_interpolate(
        torch.from_numpy(uv), torch.from_numpy(val), torch.from_numpy(mask),
        (H, W), power=power).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if n_valid == 0:
        assert (got == 0).all()


@pytest.mark.parametrize("n", [2, 3, 60])
def test_exact_scale_map_is_jax_bitwise(rng, n):
    frames = [knot_maps(rng, k) for k in (n, 25)]
    for maps in frames:
        np.testing.assert_array_equal(tinterp.interpolate_scale_knots(*maps),
                                      jinterp.interpolate_scale_knots(*maps))
    want = [np.asarray(jax.jit(jinterp.exact_scale_map)(
        *(jnp.asarray(m) for m in maps))) for maps in frames]
    got = tinterp.exact_scale_map(*(torch.from_numpy(np.stack(m))
                                    for m in zip(*frames)))
    assert got.dtype == torch.float32 and got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    if n < 3:
        assert (got[0] == 1.0).all()


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("n", [2, 80])
def test_delaunay_scipy_is_jax_bitwise(rng, n, log_space):
    depth = sparse_depth(rng, n)
    want = jinterp.delaunay_interpolate(depth, log_space=log_space,
                                        use_native=False)
    got = tinterp.delaunay_interpolate(depth, log_space=log_space,
                                       use_native=False)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def native_lib():
    """Both packages' native libraries, each built by its own loader;
    the JAX one through `jax_native_library`, so that JAX never runs on
    its quiet scipy fall-back."""
    jax_native_library()
    return tnative.load()


@pytest.mark.parametrize("n", [0, 2, 3, 250])
def test_delaunay_native_is_jax_bitwise(rng, native_lib, n):
    depth = sparse_depth(rng, n, (120, 160), span=60.0)
    want = jinterp.delaunay_interpolate(depth)
    got = tinterp.delaunay_interpolate(depth)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnative.delaunay_interpolate_native(depth),
                                  jnative.delaunay_interpolate_native(depth))
    if n >= 3:
        # the knots keep their values; scipy agrees but at cocircular
        # ties, where either triangulation is a Delaunay one
        r, c = np.where(depth > 0)
        np.testing.assert_allclose(got[r, c], depth[r, c], atol=1e-3)
        ref = tinterp.delaunay_interpolate(depth, use_native=False)
        inside = ref > 0
        assert np.mean(np.abs(got[inside] - ref[inside]) < 1e-3) > 0.99


def test_delaunay_native_degenerate_inputs(native_lib):
    collinear = np.zeros((16, 16), np.float32)
    for i in (2, 7, 12):
        collinear[i, i] = float(i)
    np.testing.assert_array_equal(
        tinterp.delaunay_interpolate(collinear),
        jinterp.delaunay_interpolate(collinear))
    with pytest.raises(ValueError, match="H, W"):
        tinterp.delaunay_interpolate(np.zeros((2, 8, 8), np.float32))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fall-back to scipy: a library that cannot be built
    raises, saying what failed."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        tinterp.delaunay_interpolate(sparse_depth(
            np.random.default_rng(1), 10))
    assert not list((tmp_path / "build").glob("*"))


# Each process, like a test worker that imported tests/test_native.py,
# first calls the JAX loader bare, then goes through the helper.
RACER = """
import os, sys, time
import numpy as np
from riders_tpu.io import native
native_dir, out = sys.argv[1], sys.argv[2]
native._NATIVE_DIR = native_dir
native._LIB_PATH = os.path.join(native_dir, "libriders_native.so")
from torch_common import jax_native_library
open(out + ".ready", "w").close()
while not os.path.exists(os.path.join(native_dir, "go")):
    time.sleep(0.005)
bare = native.load() is not None
lib = jax_native_library()
assert native.load() is lib
np.save(out, native.delaunay_interpolate_native(np.load(sys.argv[3])))
print("bare load", "ok" if bare else "failed")
"""


def test_jax_native_library_survives_a_concurrent_build(tmp_path):
    """Six processes released at once on a copy of native/ with no
    library: each loads the JAX package's library through
    `jax_native_library`, whatever its bare load met, and all six
    densify one seeded map alike (and as the port's build does)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in ("Makefile", "delaunay.cpp"):
        shutil.copy(os.path.join(repo, "native", name), native_dir)
    depth = sparse_depth(np.random.default_rng(5), 250, (120, 160),
                         span=60.0)
    np.save(tmp_path / "depth.npy", depth)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [repo, os.path.join(repo, "tests")]))
    outs = [str(tmp_path / f"out{i}.npy") for i in range(6)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACER, str(native_dir), out,
         str(tmp_path / "depth.npy")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for out in outs]
    try:
        deadline = time.monotonic() + 120
        while not all(os.path.exists(o + ".ready") for o in outs):
            assert time.monotonic() < deadline, "a racer did not start"
            assert all(p.poll() is None for p in procs), "a racer died"
            time.sleep(0.05)
        (native_dir / "go").touch()
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    print("".join(line for log in logs for line in log.splitlines(True)
                  if line.startswith("bare load")))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [np.load(o) for o in outs]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_array_equal(
        got[0], tnative.delaunay_interpolate_native(depth))


@pytest.mark.parametrize("window", [5, 12])
def test_delaunay_windowed_is_jax_bitwise(rng, native_lib, window):
    depth = sparse_depth(rng, 60)
    np.testing.assert_array_equal(
        tinterp.delaunay_interpolate_windowed(depth, window_size=window),
        jinterp.delaunay_interpolate_windowed(depth, window_size=window))


@pytest.mark.parametrize("source", ["interp", "interp-exact"])
def test_prepare_sml_inputs_interp_matches_jax(rng, source):
    """Stage 1 with the densified scale map: three frames with 0, 6 and
    200 radar returns (the last beyond the 128-knot bucket)."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.ntu_config()
        cfgs.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=(H, W)),
            sml=dataclasses.replace(cfg.sml, net_shape=(32, 64)),
            alignment=dataclasses.replace(cfg.alignment,
                                          max_valid_pixels=None),
            sml_train=dataclasses.replace(cfg.sml_train,
                                          rcnet_interp=source)))
    jcfg, tcfg = cfgs
    depth = (5.0 + 40.0 * rng.random((3, H, W))).astype(np.float32)
    radar = np.stack([sparse_depth(rng, n, span=0.0) for n in (0, 6, 200)])
    radar = np.where(radar > 0, depth, 0.0).astype(np.float32)
    image = rng.random((3, H, W, 3)).astype(np.float32)
    mono = ((1.0 / depth) / 0.05 * (0.9 + 0.2 * rng.random(depth.shape))
            ).astype(np.float32)
    want = jax.jit(jax.vmap(lambda *a: jax_prepare(jcfg, *a)))(
        jnp.asarray(image), jnp.asarray(mono), jnp.asarray(radar))
    got = prepare_sml_inputs(tcfg, *(torch.from_numpy(a)
                                     for a in (image, mono, radar)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
