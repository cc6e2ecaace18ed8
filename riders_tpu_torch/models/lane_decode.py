"""The lane-major decode of `MultiScaleDecoder` (inference only).

``decode_full`` runs every decoder stage in the hand-written kernels:
`lane_upconv2x` (B8) for exact-x2 stages, a nearest resize +
`lane_conv3x3` (B7) for the irregular ones, B7 for each fusion conv, and
the deconv0 + output0 phase tail.  `MultiScaleDecoder.forward` runs it
where `decode_path` says so: bf16 on a CUDA device, in eval with grad
disabled, on a decoder of the structure it decodes (`unsupported` says
why not); everywhere else the decoder's `literal` form, as the JAX
package's default does everywhere.  The CUDA kernels take any patch
batch.  Maps are NHWC bf16; weights are packed once per module and
re-packed only when a parameter or statistic changes.
"""

from __future__ import annotations

from collections import Counter
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

# MultiScaleDecoder calls per path ("full", "literal"; `decode_path`);
# reset with DECODES.clear()
DECODES: Counter = Counter()


def unsupported(dec, n_skips: int, skip1_hw) -> Optional[str]:
    """Why `decode_full` does not compute what the literal decoder `dec`
    computes on `n_skips` skips, the first `skip1_hw` in size, or None
    where it does: leaky-relu stages, depth 5, a skip at each of the four
    coarser scales, what its phase tail needs
    (`MultiScaleDecoder.phase_tail_unsupported`) and one output
    channel."""
    act = dec.activation_name
    if "leaky_relu" not in act or "linear" in act:
        return "the lane decode requires the leaky-relu decoder"
    if dec.depth != 5:
        return (f"the lane decode only supports the depth-5 decoder, got "
                f"depth {dec.depth}")
    if n_skips != dec.depth - 1:
        return (f"the lane decode requires a skip at each of the "
                f"{dec.depth - 1} coarser scales, got {n_skips} skips")
    reason = dec.phase_tail_unsupported(n_skips, skip1_hw)
    if reason is None and dec.output0.conv.out_channels != 1:
        reason = "the lane decode requires one output channel"
    return reason


def decode_path(dtype: torch.dtype, device_type: str, training: bool,
                grad_enabled: bool, dec, n_skips: int, skip1_hw) -> str:
    """The path `MultiScaleDecoder.forward` takes: "full" for a bf16 input
    on a CUDA device, in eval with grad disabled, on a decoder
    `decode_full` decodes (`unsupported` finds nothing); "literal" for
    every other input."""
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
    dtype.  Raises ValueError on a decoder it does not decode
    (`unsupported`)."""
    reason = unsupported(dec, len(skips),
                         tuple(skips[0].shape[-2:]) if skips else None)
    if reason:
        raise ValueError(reason)
    h = _lane(x)
    for i in range(dec.depth - 1):
        d = 4 - i
        skip = skips[len(skips) - 1 - i]
        up = _upsample(dec, d, h, skip.shape[-2:])
        h = _fuse(dec, d, up, _lane(skip))
    return _lane_phase_tail(dec, h)


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
