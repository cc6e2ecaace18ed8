"""Lane-major decode paths of `MultiScaleDecoder` (inference only).

* ``decode_full``: every decoder stage in the lane kernels,
  `lane_upconv2x` (B8) for exact-x2 stages, a nearest resize +
  `lane_conv3x3` (B7) for the irregular ones, B7 for each fusion conv,
  and the deconv0 + output0 phase tail;
* ``decode_tail``: the literal decoder for deconv4..2, the lane kernels
  from deconv1 on.

`MultiScaleDecoder`'s default (``lane_mode=None``) runs ``decode_full``
where `default_path` says so: bf16 on a CUDA device, in eval with grad
disabled, on a decoder of the structure the lane paths decode (the
single-resolution batch-norm leaky-relu decoder of depth 5 with one
linear output channel, no skip at full resolution, its output exactly x2
of skips[0]; `unsupported` says why not).  The JAX package's None runs
the literal decoder.  ``lane_mode="full"`` or ``"tail"`` asks for a path
explicitly; `check_eligible` raises where that structure is missing and,
as the JAX package does, where the patch batch is no multiple of 128 (a
TPU layout rule; the CUDA kernels take any batch).  Maps are NHWC bf16;
weights are packed once per module and re-packed only when a parameter or
statistic changes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from riders_tpu_torch.models.layers import (bn_fold, cached_weights,
                                            depth_to_space2, hwio,
                                            nearest2x_phase_kernel,
                                            phase_compose_3x3)
from riders_tpu_torch.ops.kernels.lane_decoder import (lane_conv3x3,
                                                       lane_upconv2x,
                                                       pack_conv,
                                                       pack_upconv)
from riders_tpu_torch.ops.resize import nearest_indices

SLOPE = 0.2


def unsupported(dec, n_skips: int, skip1_hw) -> Optional[str]:
    """Why the lane paths do not compute what the literal decoder `dec`
    computes on `n_skips` skips, the first `skip1_hw` in size, or None
    where they do: batch-norm leaky-relu stages, depth 5, one resolution,
    one linear output channel, a skip at each of the four coarser scales
    and none at full resolution, and the output exactly x2 of skips[0]."""
    act = dec.activation_name
    if (not dec.use_batch_norm or "leaky_relu" not in act
            or "linear" in act):
        return "lane_mode requires the batch-norm leaky-relu decoder"
    if dec.depth != 5:
        return (f"lane_mode only supports the depth-5 decoder, got depth "
                f"{dec.depth}")
    if (dec.n_resolution != 1 or not dec.linear_output
            or dec.output0.conv.out_channels != 1):
        return ("lane_mode decodes the single-resolution decoder with one "
                "linear output channel only")
    if n_skips != dec.depth - 1:
        return (f"lane_mode requires a skip at each of the {dec.depth - 1} "
                f"coarser scales and none at full resolution, got "
                f"{n_skips} skips")
    if tuple(dec.output_shape) != (2 * skip1_hw[0], 2 * skip1_hw[1]):
        return "lane_mode requires an exact-x2 full-resolution output"
    return None


def check_eligible(dec, n_batch: int, skips: Sequence[torch.Tensor]
                   ) -> None:
    """Raises where an explicit lane_mode cannot run: `unsupported`, and
    the JAX package's patch batch, a multiple of 128 (a TPU layout rule);
    `MultiScaleDecoder` refuses lane_mode with several resolutions or
    output channels when built, as the JAX package does."""
    reason = unsupported(dec, len(skips),
                         tuple(skips[0].shape[-2:]) if skips else None)
    if reason:
        raise ValueError(reason)
    if n_batch % 128:
        raise ValueError(f"patch batch {n_batch} is not a multiple of 128")


def default_path(dtype: torch.dtype, device_type: str, training: bool,
                 grad_enabled: bool, dec, n_skips: int, skip1_hw) -> str:
    """The path `MultiScaleDecoder`'s default takes: "full" for a bf16
    input on a CUDA device, in eval with grad disabled, on a decoder the
    lane paths decode (`unsupported` finds nothing); "literal" for every
    other input."""
    full = (dtype == torch.bfloat16 and device_type == "cuda"
            and not training and not grad_enabled
            and unsupported(dec, n_skips, skip1_hw) is None)
    return "full" if full else "literal"


def _lane(t: torch.Tensor) -> torch.Tensor:
    """NCHW map -> contiguous NHWC bf16 (free for channels_last)."""
    return t.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def _upsample(dec, d: int, h: torch.Tensor, target) -> torch.Tensor:
    """deconv{d}'s upconv: B8 when the target is exactly x2, else the
    nearest resize and B7."""
    block = getattr(dec, f"deconv{d}").deconv.conv
    exact = tuple(target) == (2 * h.shape[1], 2 * h.shape[2])
    w, g, b = cached_weights(
        dec._lane_packed, f"deconv{d}.up.{exact}", [block],
        lambda: ((pack_upconv if exact else pack_conv)(hwio(block.conv)),
                 *bn_fold(block.bn)))
    if exact:
        return lane_upconv2x(h, w, g, b, SLOPE)
    return lane_conv3x3([_nearest(h, target)], [w], g, b, SLOPE)


def _nearest(h: torch.Tensor, target) -> torch.Tensor:
    """The nearest resize of an NHWC map to `target` in one gather pass,
    rows and columns picked as `ops.resize.resize2d` picks them."""
    iy = nearest_indices(h.shape[1], target[0], h.device)
    ix = nearest_indices(h.shape[2], target[1], h.device)
    return h[:, iy[:, None], ix[None, :]].contiguous()


def _fuse(dec, d: int, up: torch.Tensor, skip: torch.Tensor
          ) -> torch.Tensor:
    """deconv{d}'s fusion conv over [up, skip], its weights split at the
    upconv's width."""
    block = getattr(dec, f"deconv{d}").conv
    f = up.shape[3]
    w_up, w_skip, g, b = cached_weights(
        dec._lane_packed, f"deconv{d}.fuse", [block],
        lambda: (pack_conv(hwio(block.conv)[:, :, :f]),
                 pack_conv(hwio(block.conv)[:, :, f:]), *bn_fold(block.bn)))
    return lane_conv3x3([up, skip], [w_up, w_skip], g, b, SLOPE)


def decode_full(dec, x: torch.Tensor, skips: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """The whole decoder in the lane kernels.  x (N, C, h, w) and skips
    NCHW, shallow to deep; returns (N, 1, H, W) logits in the decoder's
    dtype."""
    h = _lane(x)
    for i in range(dec.depth - 1):
        d = 4 - i
        skip = skips[len(skips) - 1 - i]
        up = _upsample(dec, d, h, skip.shape[-2:])
        h = _fuse(dec, d, up, _lane(skip))
    return _lane_phase_tail(dec, h)


def decode_tail(dec, h: torch.Tensor, skip1: torch.Tensor) -> torch.Tensor:
    """The lane kernels from deconv1 on.  h: the literal deconv2 output
    (N, C, h2, w2); skip1: the pooled /2 skip (N, C1, 2 h2', 2 w2')."""
    up = _upsample(dec, 1, _lane(h), skip1.shape[-2:])
    return _lane_phase_tail(dec, _fuse(dec, 1, up, _lane(skip1)))


def _lane_phase_tail(dec, h1: torch.Tensor) -> torch.Tensor:
    """deconv0 + output0 as three B7 convs on the phase tensor (quarter
    spatial size; nearest x2 and depth-to-space composed into the
    weights), then one depth_to_space2."""
    p0 = dec.deconv0

    def make():
        tile = (lambda gb: (gb[0].repeat(4), gb[1].repeat(4)))
        return (pack_conv(nearest2x_phase_kernel(hwio(p0.deconv.conv.conv))),
                *tile(bn_fold(p0.deconv.conv.bn)),
                pack_conv(phase_compose_3x3(hwio(p0.conv.conv))),
                *tile(bn_fold(p0.conv.bn)),
                pack_conv(phase_compose_3x3(hwio(dec.output0.conv))))

    w_up, g_up, b_up, w_f, g_f, b_f, w_o = cached_weights(
        dec._lane_packed, "tail", [p0, dec.output0], make)
    u = lane_conv3x3([h1], [w_up], g_up, b_up, SLOPE)
    m = lane_conv3x3([u], [w_f], g_f, b_f, SLOPE)
    o = lane_conv3x3([m], [w_o], None, None, None)        # (N, h, w, 4)
    out = depth_to_space2(o, 1).permute(0, 3, 1, 2)
    return out.to(dec.output0.conv.weight.dtype)
