"""Offline preprocessing driver: raw sensor dumps -> training PNG trees.

Per frame: read the lidar and radar point clouds (.pcd), undistort the
thermal image, project both clouds to the camera plane, and write the
directory layout the pipelines consume:

    <scene>/thermal_undistort/<id>.png
    <scene>/radar_png/<id>.png      sparse radar depth
    <scene>/radar_npy/<id>.npy      radar (u, v, depth) point list
    <scene>/lidar_png/<id>.png      sparse lidar depth
    <scene>/lidar_png_int/<id>.png  Delaunay-densified lidar depth

Calibration (intrinsics, extrinsics, distortion) is a dataclass preset
per dataset; with `workers` > 1 the frames fan out over a pool of
spawned processes.  The files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

import numpy as np

from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.preprocess import projection
from riders_tpu_torch.ops.interp import delaunay_interpolate


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Camera intrinsics + sensor extrinsics for one rig.

    The radar extrinsic comes either via the lidar chain (ZJU:
    T_camera_radar = T_camera_lidar @ inv(T_radar_lidar)) or directly
    (NTU)."""

    image_size: Tuple[int, int]               # (H, W)
    projection_matrix: np.ndarray             # 4x4
    dist_coeffs: np.ndarray
    t_camera_lidar: np.ndarray                # 4x4
    t_radar_lidar: Optional[np.ndarray] = None
    t_camera_radar_direct: Optional[np.ndarray] = None
    min_distance: float = 1.5
    max_distance: float = 100.0

    @property
    def t_camera_radar(self) -> np.ndarray:
        if self.t_camera_radar_direct is not None:
            return self.t_camera_radar_direct
        return self.t_camera_lidar @ np.linalg.inv(self.t_radar_lidar)


def zju_calibration() -> Calibration:
    """ZJU-Multispectrum rig."""
    return Calibration(
        image_size=(480, 640),
        projection_matrix=np.array(
            [[1104.50195815164, 0, 281.815052848494, 0],
             [0, 1104.80247345753, 166.229103132276, 0],
             [0, 0, 1, 0],
             [0, 0, 0, 1]]),
        dist_coeffs=np.array(
            [-0.200600349900097, -0.045799082965466, 0, 0]),
        t_camera_lidar=np.array(
            [[0.0638225, -1.00202, 0.00135461, -0.02],
             [0.0982692, 0.000993459, -0.999507, -0.18],
             [0.997194, 0.0679671, 0.0940644, -0.23],
             [0, 0, 0, 1]]),
        t_radar_lidar=np.array(
            [[0.996455, -0.0836778, 0.00869593, 3.85],
             [0.0836747, 0.996493, 0.000730218, -0.02],
             [-0.00872654, 0, 0.999962, 0.3],
             [0, 0, 0, 1]]),
    )


def ntu_calibration() -> Calibration:
    """NTU4DRadLM rig."""
    return Calibration(
        image_size=(512, 640),
        projection_matrix=np.array(
            [[4.7196351324104091e+02, 0, 3.3903066128694218e+02, 0],
             [0, 4.7248642748309049e+02, 2.7774073717116710e+02, 0],
             [0, 0, 1, 0],
             [0, 0, 0, 1]]),
        dist_coeffs=np.array(
            [-1.8566954779749040e-01, 1.6745260846914475e-01,
             -1.8122010952647307e-04, 8.6534037842673963e-05,
             -1.0770856460153226e-01]),
        t_camera_lidar=np.array(
            [[-0.01577749, -0.99987429, -0.00055128, -0.17138222],
             [-0.00151076, 0.00057628, -0.99999762, 0.09600887],
             [0.99987328, -0.01577772, -0.00151857, -0.10307939],
             [0, 0, 0, 1]]),
        t_camera_radar_direct=np.array(
            [[-0.0241851, -0.999665, -0.00925436, -0.0248342],
             [0.0404891, 0.00826999, -0.999146, 0.09583170000000001],
             [0.998887, -0.0245392, 0.0402755, 0.0268037],
             [0, 0, 0, 1]]),
    )


def process_frame(frame_id: str,
                  thermal_path: str,
                  lidar_path: str,
                  radar_path: str,
                  scene_out: str,
                  calib: Calibration) -> None:
    """Project one frame's clouds and write all five outputs."""
    import cv2

    image = cv2.imread(thermal_path, cv2.IMREAD_UNCHANGED)
    if image is None:
        raise FileNotFoundError(thermal_path)
    image = projection.undistort_image(
        image, calib.projection_matrix[:3, :3], calib.dist_coeffs)
    tdir = depthio.ensure_dir(os.path.join(scene_out, "thermal_undistort"))
    cv2.imwrite(os.path.join(tdir, frame_id + ".png"), image)

    H, W = calib.image_size

    def project(cloud, t_camera_pcl):
        uvs, depth = projection.project_pcl_to_image(
            cloud, t_camera_pcl, calib.projection_matrix, (H, W))
        keep = projection.min_max_filter(
            depth, calib.max_distance, calib.min_distance)
        return uvs[keep], depth[keep]

    # Lidar -> sparse + Delaunay-densified GT.
    lidar = projection.read_pcd(lidar_path)
    uvs, depth = project(lidar, calib.t_camera_lidar)
    sparse = np.zeros((H, W), np.float32)
    # each written depth is clamped to >= 1 m
    sparse[uvs[:, 1], uvs[:, 0]] = np.maximum(depth, 1.0)
    ldir = depthio.ensure_dir(os.path.join(scene_out, "lidar_png"))
    depthio.save_depth(sparse, os.path.join(ldir, frame_id + ".png"))
    lint_dir = depthio.ensure_dir(os.path.join(scene_out, "lidar_png_int"))
    if (sparse > 0).sum() > 5:
        dense = delaunay_interpolate(sparse)
    else:
        dense = np.zeros((H, W), np.float32)
    depthio.save_depth(dense, os.path.join(lint_dir, frame_id + ".png"))

    # Radar -> sparse map + (u, v, z) npy list.
    radar = projection.read_pcd(radar_path)
    uvs, depth = project(radar, calib.t_camera_radar)
    rsparse = np.zeros((H, W), np.float32)
    rsparse[uvs[:, 1], uvs[:, 0]] = np.maximum(depth, 1.0)
    rdir = depthio.ensure_dir(os.path.join(scene_out, "radar_png"))
    depthio.save_depth(rsparse, os.path.join(rdir, frame_id + ".png"))
    ndir = depthio.ensure_dir(os.path.join(scene_out, "radar_npy"))
    np.save(os.path.join(ndir, frame_id + ".npy"),
            np.stack([uvs[:, 0], uvs[:, 1], depth], axis=1
                     ).astype(np.float32))


def preprocess_scene(scene_raw: str, scene_out: str, calib: Calibration,
                     lidar_dir: str = "lidar",
                     radar_dir: str = "radar_sync",
                     thermal_dir: str = "thermal_sync",
                     workers: int = 0) -> int:
    """Process every frame of one scene; returns the frame count."""
    names = sorted(os.listdir(os.path.join(scene_raw, lidar_dir)))
    jobs = []
    for name in names:
        fid = os.path.splitext(name)[0]
        jobs.append((fid,
                     os.path.join(scene_raw, thermal_dir, fid + ".png"),
                     os.path.join(scene_raw, lidar_dir, fid + ".pcd"),
                     os.path.join(scene_raw, radar_dir, fid + ".pcd"),
                     scene_out, calib))
    if workers > 1:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            list(pool.map(_process_star, jobs))
    else:
        for job in jobs:
            process_frame(*job)
    return len(jobs)


def _process_star(args):
    return process_frame(*args)


def preprocess_dataset(cfg, raw_root: str, output_root: str,
                       workers: int = 0) -> None:
    """Process every scene directory under raw_root."""
    calib = (zju_calibration() if cfg.dataset.name == "zju"
             else ntu_calibration())
    scenes = sorted(d for d in os.listdir(raw_root)
                    if os.path.isdir(os.path.join(raw_root, d)))
    for scene in scenes:
        n = preprocess_scene(os.path.join(raw_root, scene),
                             os.path.join(output_root, scene),
                             calib, workers=workers)
        print(f"{scene}: {n} frames")
