"""Point-cloud to image-plane projection (offline preprocessing, on the
host): homogeneous transforms, pinhole projection, canvas filtering, and
a depth-descending order so that nearer points overwrite farther ones
when scattered to a sparse depth map; plumb-bob undistortion and a .pcd
reader.  numpy, with cv2 imported only by the undistortion."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def homogeneous_transformation(points: np.ndarray,
                               transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to Nx4 points."""
    if transform.shape != (4, 4):
        raise ValueError(f"{transform.shape} must be 4x4")
    if points.shape[1] != 4:
        raise ValueError(f"points must be Nx4, got {points.shape}")
    return points @ transform.T


def project_3d_to_2d(points: np.ndarray,
                     projection_matrix: np.ndarray) -> np.ndarray:
    """Project homogeneous 3-D points with a 3x4/4x4 projection matrix,
    rounding to integer pixels."""
    if points.shape[-1] != 4:
        raise ValueError("points must be homogeneous Nx4")
    uvw = projection_matrix @ points.T
    uvw = uvw / uvw[2]
    return np.round(uvw[:2].T).astype(np.int32)


def canvas_crop(points: np.ndarray, image_size: Tuple[int, int],
                points_depth: Optional[np.ndarray] = None) -> np.ndarray:
    """Validity mask for pixels inside the frame, optionally requiring
    positive depth."""
    idx = (points[:, 0] > 0) & (points[:, 0] < image_size[1]) \
        & (points[:, 1] > 0) & (points[:, 1] < image_size[0])
    if points_depth is not None:
        idx &= points_depth > 0
    return idx


def min_max_filter(values: np.ndarray, max_value: float,
                   min_value: float) -> np.ndarray:
    """(min, max) open-interval mask."""
    return (values < max_value) & (values > min_value)


def project_pcl_to_image(point_cloud: np.ndarray,
                         t_camera_pcl: np.ndarray,
                         camera_projection_matrix: np.ndarray,
                         image_shape: Tuple[int, int]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Project a point cloud into the camera frame; returns (uvs, depths)
    sorted by depth DESCENDING so scattering writes near points last."""
    homo = np.hstack([point_cloud[:, :3],
                      np.ones((point_cloud.shape[0], 1), np.float32)])
    cam = homogeneous_transformation(homo, t_camera_pcl)
    depth = cam[:, 2]
    uvs = project_3d_to_2d(cam, camera_projection_matrix)
    keep = canvas_crop(uvs, image_shape, depth)
    uvs, depth = uvs[keep], depth[keep]
    order = np.argsort(depth)[::-1]
    return uvs[order], depth[order]


def scatter_to_depth_map(uvs: np.ndarray, depths: np.ndarray,
                         image_shape: Tuple[int, int]) -> np.ndarray:
    """Scatter projected points to a sparse depth map; input is
    depth-descending so nearer points win overlaps."""
    out = np.zeros(image_shape, np.float32)
    out[uvs[:, 1], uvs[:, 0]] = depths
    return out


def undistort_image(image: np.ndarray, intrinsics: np.ndarray,
                    dist_coeffs: np.ndarray) -> np.ndarray:
    """Plumb-bob undistortion with cv2."""
    import cv2
    return cv2.undistort(image, intrinsics, dist_coeffs)


def read_pcd(path: str) -> np.ndarray:
    """Minimal .pcd reader (ascii, and binary with 4-byte fields read as
    float32).  Returns the Nx3 x, y, z columns."""
    with open(path, "rb") as f:
        header = {}
        fields = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            key, _, rest = line.partition(" ")
            key = key.upper()
            header[key] = rest
            if key == "FIELDS":
                fields = rest.split()
            if key == "DATA":
                data_mode = rest.strip()
                break
        n = int(header.get("POINTS", header.get("WIDTH", "0")))
        sizes = [int(s) for s in header.get("SIZE", "4 4 4").split()]
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        if data_mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float32, max_rows=n)
            rows = np.atleast_2d(rows)
        elif data_mode == "binary":
            stride = sum(s * c for s, c in zip(sizes, counts))
            raw = f.read(n * stride)
            if all(s == 4 for s in sizes):
                rows = np.frombuffer(
                    raw, dtype=np.float32,
                    count=n * stride // 4).reshape(n, stride // 4)
            else:
                raise ValueError("Unsupported mixed-size binary .pcd")
        else:
            raise ValueError(f"Unsupported .pcd data mode: {data_mode}")
    xyz_idx = [fields.index(k) for k in ("x", "y", "z")]
    return rows[:, xyz_idx].astype(np.float32)
