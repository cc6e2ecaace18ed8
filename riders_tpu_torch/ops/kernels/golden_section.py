"""Stage 1's bounded scale-only L1 solve, a golden-section search.

`golden_section` launches the CUDA kernel (csrc/golden_section.cu) for
CUDA tensors and runs its plain version, `golden_section_plain`, for CPU
tensors.  Both take (B, N) float32 rows p, t, m and return the (B,)
scales s in `bounds` that minimise sum(m * |s * p - t|) per row, after a
fixed number of iterations with the JAX package's update rule (`fc <
fd`) and carried point.  The kernel runs the whole search in one launch
and evaluates only the objective each step keeps; it sums each objective
in another order than `torch.sum`, and nothing else differs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

# 1/phi and 1/phi^2 for golden-section interval reduction.
_INVPHI = 0.6180339887498949
_INVPHI2 = 0.3819660112501051

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _l1_objective(s: torch.Tensor, p: torch.Tensor, t: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """sum(m * |s * p - t|) per frame; s is (B,), p/t/m are (B, N)."""
    return torch.sum(m * torch.abs(s[:, None] * p - t), dim=1)


def golden_section_plain(p, t, m, bounds, iterations) -> torch.Tensor:
    B = p.shape[0]
    lo = torch.full((B,), bounds[0], dtype=torch.float32, device=p.device)
    hi = torch.full((B,), bounds[1], dtype=torch.float32, device=p.device)
    c = lo + _INVPHI2 * (hi - lo)
    d = lo + _INVPHI * (hi - lo)
    fc = _l1_objective(c, p, t, m)
    fd = _l1_objective(d, p, t, m)
    for _ in range(iterations):
        left = fc < fd
        new_lo = torch.where(left, lo, c)
        new_hi = torch.where(left, d, hi)
        # One interior point carries over; the other is recomputed.
        new_d = torch.where(left, c, d)
        new_fd = torch.where(left, fc, fd)
        new_c = new_lo + _INVPHI2 * (new_hi - new_lo)
        new_fc = _l1_objective(new_c, p, t, m)
        # Keep c < d: after shrinking right the carried point is c.
        c_out = torch.where(left, new_c, new_d)
        fc_out = torch.where(left, new_fc, new_fd)
        d_probe = new_lo + _INVPHI * (new_hi - new_lo)
        fd_probe = _l1_objective(d_probe, p, t, m)
        d = torch.where(left, new_d, d_probe)
        fd = torch.where(left, new_fd, fd_probe)
        lo, hi, c, fc = new_lo, new_hi, c_out, fc_out
    return 0.5 * (lo + hi)


def golden_section(p: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
                   bounds: Tuple[float, float],
                   iterations: int) -> torch.Tensor:
    """See `golden_section_plain`.  On CUDA: p, t, m contiguous float32
    of one shape (B, N); any N, any iteration count >= 0."""
    if on_cpu(p, t, m):
        return golden_section_plain(p, t, m, bounds, iterations)
    if p.dim() != 2:
        raise ValueError(f"p: expected (B, N) rows, got {tuple(p.shape)}")
    B, N = p.shape
    for x, name in ((p, "p"), (t, "t"), (m, "m")):
        require(x, name, torch.float32, (B, N))
    if iterations < 0:
        raise ValueError(f"iterations {iterations} < 0")
    out = torch.empty((B,), dtype=torch.float32, device=p.device)
    fn = kernel_function("golden_section", "riders_golden_section",
                         _ARGTYPES)
    check(fn(p.data_ptr(), t.data_ptr(), m.data_ptr(), out.data_ptr(), B, N,
             bounds[0], bounds[1], iterations, stream_handle(p)),
          "golden_section")
    LAUNCHES["golden_section"] += 1
    return out
