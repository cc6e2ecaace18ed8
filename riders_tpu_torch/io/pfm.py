"""PFM (Portable Float Map) IO: the float maps in which MiDaS tooling
hands over relative depth priors."""

from __future__ import annotations

import re
import sys
from typing import Tuple

import numpy as np


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Read a PFM file; returns (data, scale).  Data is flipped to
    top-to-bottom row order (PFM stores bottom-up)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file: " + path)

        dims = f.readline().decode("ascii")
        match = re.match(r"^(\d+)\s(\d+)\s*$", dims)
        if not match:
            raise ValueError("Malformed PFM header: " + dims)
        width, height = map(int, match.groups())

        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = np.reshape(data, shape)
        return np.flipud(data), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 (H, W) or (H, W, 3) array as PFM."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("Image must be HxW, HxWx1 or HxWx3")

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode("ascii"))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode("ascii"))
        np.flipud(image).tofile(f)
