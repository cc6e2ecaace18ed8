"""The yardstick's arithmetic: the H100's published peaks, the bytes and
operations the port's three hand kernels on the fused path need for a
batch, their least times, and the model's operations per frame.

The byte counts are frozen copies of `chip_smoke.py`'s (`bound_ms`,
`roi_read_bytes`, `compose_read_elems` and the stem's bytes), with the
box and patch rounding of `benchmark.reference.ops` in place of the
port's own: each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor rate
ENCODER_WIDTHS = (32, 64, 128, 128, 128)   # the stem's and stages' widths
STEM_TAPS = 7 * 7 * 3


def least_s(nbytes: float, flops: float = 0.0) -> float:
    """The larger of bytes at the memory rate and operations at the bf16
    rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def pyramid_shapes(frame, patch, widths=ENCODER_WIDTHS):
    """(H, W, C) of the RoI pool's maps, /2 .. /32 of the edge-padded
    frame (each stride-2 stage takes ceil)."""
    h = frame[0] + 2 * (patch[0] // 2)
    w = frame[1] + 2 * (patch[1] // 2)
    out = []
    for c in widths:
        h, w = -(-h // 2), -(-w // 2)
        out.append((h, w, c))
    return out


def roi_read_bytes(shapes, boxes: torch.Tensor, patch) -> int:
    """bf16 bytes of the maps the RoI pool must read for (B, K, 4)
    boxes: per frame and map the union of the boxes' clamped windows."""
    from benchmark.reference.ops import roi_bounds
    ph, pw = patch
    n = 0
    for i, (H, W, C) in enumerate(shapes):
        lo_h, hi_h, lo_w, hi_w = roi_bounds(
            boxes, 1.0 / 2 ** (i + 1), H, W, (ph >> (i + 1), pw >> (i + 1)))
        r, c = torch.arange(H), torch.arange(W)
        rows = (r >= lo_h[..., :1]) & (r < hi_h[..., -1:])
        cols = (c >= lo_w[..., :1]) & (c < hi_w[..., -1:])
        cover = torch.bmm(rows.transpose(1, 2).float(), cols.float()) > 0
        n += 2 * C * int(cover.sum())
    return n


def compose_read_elems(points: torch.Tensor, mask: torch.Tensor, frame,
                       patch) -> int:
    """Response elements compose must read: those of the real points'
    patches that land inside the frame."""
    from benchmark.reference.ops import patch_origins
    (H, W), (ph, pw) = frame, patch
    y0, x0 = patch_origins(points, frame, patch)
    rows = (y0 + ph).clamp(max=H + ph // 2) - y0.clamp(min=ph // 2)
    cols = (x0 + pw).clamp(max=W + pw // 2) - x0.clamp(min=pw // 2)
    return int((rows.clamp(min=0) * cols.clamp(min=0) * (mask > 0)).sum())


def kernel_least_s(cfg: dict, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, float]:
    """Least seconds of one fused call's stem, RoI pool and compose
    launch on this host batch at the configuration's shapes."""
    from benchmark.reference.ops import pyramid_levels, \
        shift_points_and_boxes
    frame = tuple(cfg["dataset"]["image_shape"])
    patch = tuple(cfg["rcnet"]["patch_size"])
    points = torch.from_numpy(batch["radar_points"]).float()
    mask = torch.from_numpy(batch["point_mask"]).float()
    B, K = mask.shape
    shifted, boxes = shift_points_and_boxes(points, patch)
    shapes = pyramid_shapes(frame, patch)
    # stem: the padded bf16 frame read, its conv map and pooled map
    # written, the f32 weights read; 2 operations per tap and output
    x = B * (frame[0] + 2 * (patch[0] // 2)) * (frame[1] + 2 * (
        patch[1] // 2)) * 3
    conv = B * shapes[0][0] * shapes[0][1] * shapes[0][2]
    pooled = B * shapes[1][0] * shapes[1][1] * shapes[0][2]
    stem = least_s(2 * (x + conv + pooled) + 4 * shapes[0][2] * STEM_TAPS,
                   2.0 * conv * STEM_TAPS)
    # RoI pool: the covered map bytes, the boxes, the bf16 outputs
    levels = pyramid_levels(len(shapes) - 1, patch)
    outs = sum(B * K * oh * ow * c for (_, (oh, ow)), (_, _, c)
               in zip(levels, shapes))
    roi = least_s(roi_read_bytes(shapes, boxes, patch) + 4 * boxes.numel()
                  + 2 * outs)
    # compose: the responses in the frame, points, masks, thresholds
    # read; the depth and response maps written
    compose = least_s(4 * (compose_read_elems(shifted, mask, frame, patch)
                           + shifted.numel() + mask.numel() + B
                           + 2 * B * frame[0] * frame[1]))
    return {"stem": stem, "roi_pool": roi, "compose": compose}


def model_flops_per_frame(reference, frames: Dict[str, np.ndarray]) -> float:
    """Matmul and convolution operations of the reference's chain on one
    frame (torch's FlopCounterMode: 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    one = {k: v[:1] for k, v in frames.items()}
    with FlopCounterMode(display=False) as counter:
        reference.depth(one)
    return float(counter.get_total_flops())
