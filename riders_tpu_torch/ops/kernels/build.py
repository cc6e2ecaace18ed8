"""Build the CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles for sm_90a into its own shared library
with a plain C interface, under `build/riders_tpu_torch/` at the root of
the checkout (listed in .gitignore).  The library name carries a hash of
its source, so an edited source is never served by a stale build.  All
sources build in parallel, one nvcc process each, at first use; nothing
is compiled when the package is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "riders_tpu_torch"
KERNELS = ("stem", "stem_general", "roi_pool", "compose", "lane_decoder",
           "beit_attention", "golden_section", "swin2_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[Tuple[str, str], Callable] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha1((SOURCE_DIR / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> List[Path]:
    """Compile every missing library in parallel; return their paths.
    The compiler's report (registers, shared memory, spills) is kept in
    `<library>.log` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = [_library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    failed = []
    with contextlib.ExitStack() as stack:
        jobs = []
        for name, path in todo:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            log = stack.enter_context(open(path.with_suffix(".log"), "w"))
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(SOURCE_DIR / f"{name}.cu")]
            jobs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        for name, path, tmp, proc in jobs:
            if proc.wait() == 0:
                os.replace(tmp, path)
            else:
                tmp.unlink(missing_ok=True)
                failed.append((name, proc.returncode, path))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(
            f"{name} (nvcc exit {rc}): "
            + path.with_suffix(".log").read_text()[-4000:]
            for name, rc, path in failed))
    return paths


def kernel_function(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of kernel `name`, with its argument
    types declared and an int (cudaError_t) result.  Every kernel is
    built on the first call."""
    key = (name, symbol)
    if key not in _FUNCTIONS:
        if not _LIBS:
            for n, path in zip(KERNELS, build_all()):
                _LIBS[n] = ctypes.CDLL(str(path))
        fn = getattr(_LIBS[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[key] = fn
    return _FUNCTIONS[key]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
