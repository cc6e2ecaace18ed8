"""ctypes binding of the native (C++) Delaunay densifier.

`native/delaunay.cpp` triangulates the valid pixels of a sparse map
(Bowyer-Watson in double precision) and rasterises each triangle with
barycentric weights: the offline preprocessing's lidar densification,
at a fraction of scipy's cost.  The library is compiled from that source
at first use, with g++ and `native/Makefile`'s flags, into
`build/riders_tpu_torch/` at the root of the checkout (listed in
.gitignore); `native/` is never written.  The library's name carries a
hash of the source, so an edited source is never served by a stale
build, and each build goes through a temporary file, so concurrent
processes do not race on it.  A failed build raises, saying why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "delaunay.cpp"
BUILD_DIR = REPO_DIR / "build" / "riders_tpu_torch"
# native/Makefile's CXXFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fno-math-errno", "-std=c++17",
             "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libriders_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native Delaunay library "
                           f"({SOURCE}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.delaunay_interpolate.restype = ctypes.c_int
            lib.delaunay_interpolate.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
        return _lib


def delaunay_interpolate_native(depth_map: np.ndarray,
                                validity_map: Optional[np.ndarray] = None,
                                fill: float = 0.0) -> np.ndarray:
    """Barycentric densification of a sparse (H, W) map over the Delaunay
    triangulation of its valid pixels; `fill` outside their hull, and
    everywhere when fewer than 3 pixels are valid or all are collinear."""
    if depth_map.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {depth_map.shape}")
    lib = load()
    if validity_map is None:
        validity_map = depth_map > 0.0
    rows, cols = np.where(validity_map)
    values = np.ascontiguousarray(depth_map[rows, cols], np.float32)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    H, W = depth_map.shape
    out = np.empty((H, W), np.float32)
    ret = lib.delaunay_interpolate(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(values), H, W, ctypes.c_float(fill),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if ret != 0:
        return np.full((H, W), fill, np.float32)
    return out
