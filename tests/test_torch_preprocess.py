"""The port's offline preprocessing, PFM IO and test-time transform
tables against the JAX package's.

* Projection helpers: bitwise on seeded clouds and calibrations.
* `read_pcd`: equal arrays on ascii and binary files (with an extra
  field, so the x, y, z columns are picked by name).
* PFM: the files each package writes are byte-identical, and each reads
  the other's.
* `process_frame` / `preprocess_dataset`: the output trees of a
  synthetic raw scene (16-bit thermal PNGs, binary lidar and radar
  .pcd files seen through the preset's calibration) are byte-identical.
* `test_time_transforms` for every predictor, VOID row and a few frame
  sizes, and `apply_to_config`: equal specs and configurations.
"""

import dataclasses
import os

import numpy as np
import pytest

from riders_tpu.core import config as jconfig
from riders_tpu.core import normalization as jnorm
from riders_tpu.io import native as jnative
from riders_tpu.io import pfm as jpfm
from riders_tpu.io.preprocess import project as jproject
from riders_tpu.io.preprocess import projection as jproj
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.core import normalization as tnorm
from riders_tpu_torch.io import pfm as tpfm
from riders_tpu_torch.io.preprocess import project as tproject
from riders_tpu_torch.io.preprocess import projection as tproj
from torch_common import jax_native_library


def write_pcd(path, xyz, binary=True, rng=None):
    """A .pcd of the points with an intensity field between y and z."""
    rng = rng or np.random.default_rng(0)
    rows = np.column_stack([xyz[:, 0], xyz[:, 1],
                            rng.random(len(xyz)), xyz[:, 2]]
                           ).astype(np.float32)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y intensity z\n"
              "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(rows)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(rows)}\nDATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rows.tobytes())
        else:
            for r in rows:
                f.write((" ".join(repr(float(v)) for v in r) + "\n"
                         ).encode("ascii"))


def camera_points(rng, n, calib, near=0.5, far=120.0):
    """n points in the camera frame, most inside the view frustum (some
    behind the camera, some beyond the distance window)."""
    H, W = calib.image_size
    P = calib.projection_matrix
    z = near + (far - near) * rng.random(n) ** 2
    u = rng.uniform(-20, W + 20, n)
    v = rng.uniform(-20, H + 20, n)
    x = (u - P[0, 2]) * z / P[0, 0]
    y = (v - P[1, 2]) * z / P[1, 1]
    pts = np.column_stack([x, y, z])
    pts[: n // 20, 2] *= -1.0
    return pts


def to_sensor(cam_pts, t_camera_sensor):
    homo = np.column_stack([cam_pts, np.ones(len(cam_pts))])
    return (homo @ np.linalg.inv(t_camera_sensor).T)[:, :3]


def write_raw_scene(root, scene, calib, n_frames, seed, n_lidar=6000,
                    n_radar=200):
    """A raw scene in the layout preprocess_scene reads: thermal_sync/
    16-bit PNGs, lidar/ and radar_sync/ binary .pcd files."""
    import cv2
    rng = np.random.default_rng(seed)
    H, W = calib.image_size
    for d in ("thermal_sync", "lidar", "radar_sync"):
        os.makedirs(os.path.join(root, scene, d), exist_ok=True)
    for f in range(n_frames):
        fid = f"{f:06d}"
        thermal = rng.integers(20000, 30000, (H, W), dtype=np.uint16)
        cv2.imwrite(os.path.join(root, scene, "thermal_sync", fid + ".png"),
                    thermal)
        for d, n, t in (("lidar", n_lidar, calib.t_camera_lidar),
                        ("radar_sync", n_radar, calib.t_camera_radar)):
            write_pcd(os.path.join(root, scene, d, fid + ".pcd"),
                      to_sensor(camera_points(rng, n, calib), t), rng=rng)


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_same_tree(a, b):
    files = tree_files(a)
    assert files and files == tree_files(b)
    for rel in files:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


# ---- projection -------------------------------------------------------------

def test_projection_helpers_are_jax_bitwise(rng):
    calib = tproject.ntu_calibration()
    cloud = to_sensor(camera_points(rng, 500, calib), calib.t_camera_lidar
                      ).astype(np.float32)
    homo = np.hstack([cloud, np.ones((len(cloud), 1), np.float32)])
    cam = tproj.homogeneous_transformation(homo, calib.t_camera_lidar)
    np.testing.assert_array_equal(
        cam, jproj.homogeneous_transformation(homo, calib.t_camera_lidar))
    uv = tproj.project_3d_to_2d(cam, calib.projection_matrix)
    np.testing.assert_array_equal(
        uv, jproj.project_3d_to_2d(cam, calib.projection_matrix))
    for depth in (None, cam[:, 2]):
        np.testing.assert_array_equal(
            tproj.canvas_crop(uv, calib.image_size, depth),
            jproj.canvas_crop(uv, calib.image_size, depth))
    np.testing.assert_array_equal(tproj.min_max_filter(cam[:, 2], 100, 1.5),
                                  jproj.min_max_filter(cam[:, 2], 100, 1.5))
    got = tproj.project_pcl_to_image(cloud, calib.t_camera_lidar,
                                     calib.projection_matrix,
                                     calib.image_size)
    want = jproj.project_pcl_to_image(cloud, calib.t_camera_lidar,
                                      calib.projection_matrix,
                                      calib.image_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) > 300 and (np.diff(got[1]) <= 0).all()
    np.testing.assert_array_equal(
        tproj.scatter_to_depth_map(*got, calib.image_size),
        jproj.scatter_to_depth_map(*want, calib.image_size))
    with pytest.raises(ValueError):
        tproj.homogeneous_transformation(homo, np.eye(3))
    with pytest.raises(ValueError):
        tproj.project_3d_to_2d(cloud, calib.projection_matrix)


def test_undistort_is_jax_bitwise(rng):
    calib = tproject.zju_calibration()
    image = rng.integers(0, 65535, calib.image_size, dtype=np.uint16)
    K = calib.projection_matrix[:3, :3]
    np.testing.assert_array_equal(
        tproj.undistort_image(image, K, calib.dist_coeffs),
        jproj.undistort_image(image, K, calib.dist_coeffs))


@pytest.mark.parametrize("binary", [True, False])
def test_read_pcd_matches_jax(rng, tmp_path, binary):
    xyz = (rng.standard_normal((50, 3)) * 20).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    write_pcd(path, xyz, binary=binary, rng=rng)
    got = tproj.read_pcd(path)
    np.testing.assert_array_equal(got, jproj.read_pcd(path))
    np.testing.assert_array_equal(got, xyz)


def test_calibrations_match_jax():
    for name in ("zju_calibration", "ntu_calibration"):
        got, want = getattr(tproject, name)(), getattr(jproject, name)()
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray) or b is None:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        np.testing.assert_array_equal(got.t_camera_radar,
                                      want.t_camera_radar)


# ---- PFM --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (5, 6, 3)])
def test_pfm_files_identical_both_ways(rng, tmp_path, shape):
    image = (rng.standard_normal(shape) * 10).astype(np.float32)
    paths = {k: str(tmp_path / f"{k}.pfm") for k in ("jax", "torch")}
    jpfm.write_pfm(paths["jax"], image, scale=2.5)
    tpfm.write_pfm(paths["torch"], image, scale=2.5)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    want = image.reshape(shape[:2]) if shape[-1] == 1 else image
    for path in paths.values():
        for reader in (tpfm.read_pfm, jpfm.read_pfm):
            data, scale = reader(path)
            np.testing.assert_array_equal(data, want)
            assert scale == 2.5
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P6\n1 1\n1.0\n")
    with pytest.raises(ValueError, match="Not a PFM"):
        tpfm.read_pfm(str(bad))
    with pytest.raises(ValueError):
        tpfm.write_pfm(str(bad), np.zeros((2, 2, 2), np.float32))


# ---- preprocessing driver ---------------------------------------------------

@pytest.mark.parametrize("preset", ["ntu", "zju"])
def test_process_frame_outputs_are_jax_bytes(tmp_path, preset):
    calib = getattr(tproject, f"{preset}_calibration")()
    raw = str(tmp_path / "raw")
    write_raw_scene(raw, "scene", calib, 1, seed=3)
    args = ("000000",
            os.path.join(raw, "scene", "thermal_sync", "000000.png"),
            os.path.join(raw, "scene", "lidar", "000000.pcd"),
            os.path.join(raw, "scene", "radar_sync", "000000.pcd"))
    out = {k: str(tmp_path / k) for k in ("jax", "torch")}
    # the JAX side densifies natively, never by its quiet scipy fall-back
    lib = jax_native_library()
    jproject.process_frame(*args, out["jax"],
                           getattr(jproject, f"{preset}_calibration")())
    assert jnative.load() is lib
    tproject.process_frame(*args, out["torch"], calib)
    assert_same_tree(out["jax"], out["torch"])
    assert len(tree_files(out["torch"])) == 5
    radar = np.load(os.path.join(out["torch"], "radar_npy", "000000.npy"))
    assert radar.shape[1] == 3 and 50 < len(radar) <= 200


def test_preprocess_dataset_is_jax_bytes(tmp_path, capsys):
    """Two scenes of two NTU frames each, through both packages' dataset
    drivers (and the port's with two spawned workers)."""
    raw = str(tmp_path / "raw")
    calib = tproject.ntu_calibration()
    for i, scene in enumerate(("scene-a", "scene-b")):
        write_raw_scene(raw, scene, calib, 2, seed=10 + i)
    out = {k: str(tmp_path / k) for k in ("jax", "torch", "workers")}
    # JAX's driver runs here, in this process, on its native library
    lib = jax_native_library()
    jproject.preprocess_dataset(jconfig.ntu_config(), raw, out["jax"])
    assert jnative.load() is lib
    tproject.preprocess_dataset(tconfig.ntu_config(), raw, out["torch"])
    tproject.preprocess_dataset(tconfig.ntu_config(), raw, out["workers"],
                                workers=2)
    assert_same_tree(out["jax"], out["torch"])
    assert_same_tree(out["jax"], out["workers"])
    assert len(tree_files(out["torch"])) == 2 * 2 * 5
    assert "scene-b: 2 frames" in capsys.readouterr().out


# ---- test-time transforms ---------------------------------------------------

def test_void_tables_match_jax():
    assert tnorm.VOID_INTERMEDIATE == jnorm.VOID_INTERMEDIATE
    for table in ("_IMAGE_MEAN", "_IMAGE_STD", "_RESIZE_METHOD",
                  "_RESIZE_TARGET"):
        assert getattr(tnorm, table) == getattr(jnorm, table), table


@pytest.mark.parametrize("predictor", sorted(jnorm.VOID_INTERMEDIATE))
def test_test_time_transforms_match_jax(predictor):
    for n in (150, 500, 1500):
        for shape in ((480, 640), (512, 640), (96, 128), (600, 400)):
            got = tnorm.test_time_transforms(predictor, "void", n, shape)
            want = jnorm.test_time_transforms(predictor, "void", n, shape)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    shape = tconfig.ntu_config().dataset.image_shape
    spec = tnorm.test_time_transforms(predictor, "void", 500, shape)
    port = tnorm.apply_to_config(tconfig.ntu_config(), spec)
    ref = jnorm.apply_to_config(
        jconfig.ntu_config(),
        jnorm.test_time_transforms(predictor, "void", 500, shape))
    for f in dataclasses.fields(port.sml):
        assert getattr(port.sml, f.name) == getattr(ref.sml, f.name), f.name
    assert port.sml.net_shape == spec.sml_net_shape
    with pytest.raises(KeyError, match="unknown depth predictor"):
        tnorm.test_time_transforms("nope", "void", 150, (480, 640))
