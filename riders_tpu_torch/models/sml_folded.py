"""W-folded SML forward: the opt-in folded path of the fused pipeline for
midas-small (`RIDERS_SML_FOLD=1`).

Computes the function of `ScaleMapLearner.forward` in eval, on the same
module and weights, but runs the large, narrow front of the network -
the learned 3->3 stem, the EfficientNet-Lite3 conv_stem and stages 0-2 -
on a W-folded (B, H, W/4, 4C) NHWC canvas (`ops.fold`): every conv
there reads and writes 4x wider channels, the same products plus exact
zeros.  The deep stages (3-6), the reassembly and fusion blocks and the
head run through the module's own submodules (`ScaleMapLearner.decode`).
BatchNorms apply their running statistics folded to an f32 affine.

The JAX package keeps this path opt-in because it measured slower than
the literal module on its own hardware; on the card it is measured by
`chip_smoke.py` phase 14.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as F

from riders_tpu_torch.models.efficientnet import (LITE3_STAGES, LITE3_TAPS,
                                                  relu6)
from riders_tpu_torch.models.layers import bn_fold
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.ops import fold


def supports_folding(sml, net_shape: Tuple[int, int]) -> bool:
    """The folded forward covers the production midas-small
    configuration (the lite3 stage plan, 3 input channels, net W a
    multiple of 32), and runs only with RIDERS_SML_FOLD=1."""
    return (isinstance(sml, ScaleMapLearner)
            and sml.backbone_stages == LITE3_STAGES
            and sml.backbone_taps == LITE3_TAPS
            and sml.backbone_stem == 32
            and sml.config.in_channels == 3
            and net_shape[1] % 32 == 0
            and os.environ.get("RIDERS_SML_FOLD", "0") == "1")


def _bn(x: torch.Tensor, bn, F_: int) -> torch.Tensor:
    """An eval BatchNorm on an F-folded NHWC tensor: its running
    statistics as an f32 affine tiled over the phase groups."""
    g, b = bn_fold(bn)
    return (x.float() * g.repeat(F_) + b.repeat(F_)).to(x.dtype)


def _dw_pads(h: int, w: int, conv) -> dict:
    k, s = conv.kernel_size[0], conv.stride[0]
    return dict(stride=(s, s), pad_h=fold.tf_same_pads(h, k, s),
                pad_w_left=fold.tf_same_pads(w, k, s)[0])


def _folded_block(h: torch.Tensor, block, hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """A DepthwiseSeparable or MBConv block on a 4-folded canvas; a
    stride-2 depthwise reads an 8-folded canvas, so the output stays
    4-folded."""
    x_in = h
    if hasattr(block, "conv_pwl"):                  # MBConv
        h = relu6(_bn(fold.folded_pointwise(
            h, block.conv_pw.weight[:, :, 0, 0], 4), block.bn1, 4))
        dw_bn, pw, pw_bn = block.bn2, block.conv_pwl, block.bn3
    else:                                           # DepthwiseSeparable
        dw_bn, pw, pw_bn = block.bn1, block.conv_pw, block.bn2
    stride = block.conv_dw.stride[1]
    h = fold.refold_w(h, 4, 4 * stride)
    h = relu6(_bn(fold.folded_depthwise(
        h, block.conv_dw.weight, F_in=4 * stride, F_out=4,
        **_dw_pads(*hw, block.conv_dw)), dw_bn, 4))
    h = _bn(fold.folded_pointwise(h, pw.weight[:, :, 0, 0], 4), pw_bn, 4)
    return h + x_in if block.residual else h


def folded_sml_apply(sml: ScaleMapLearner, x: torch.Tensor,
                     d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``sml(x, d)`` of a model in eval: (pred, scales)."""
    dtype = sml.first_conv.weight.dtype
    net = sml.pretrained
    B, H, W, _ = x.shape

    h = fold.folded_conv(fold.fold_w(x.to(dtype), 4), sml.first_conv.weight,
                         F_in=4, F_out=4, stride=(1, 1), pad_h=(1, 1),
                         pad_w_left=1)
    h = h + sml.first_conv.bias.repeat(4)
    h = F.relu(_bn(h, sml.first_bn, 4))
    h = fold.folded_conv(fold.refold_w(h, 4, 8), net.conv_stem.weight,
                         F_in=8, F_out=4, stride=(2, 2),
                         pad_h=fold.tf_same_pads(H, 3, 2),
                         pad_w_left=fold.tf_same_pads(W, 3, 2)[0])
    h = relu6(_bn(h, net.bn_stem, 4))

    hw = (H // 2, W // 2)
    taps = []
    for si, names in enumerate(net.stage_blocks):
        if si == 3:
            h = fold.unfold_w(h, 4).permute(0, 3, 1, 2)
        for name in names:
            block = getattr(net, name)
            if si < 3:
                h = _folded_block(h, block, hw)
                s = block.conv_dw.stride[0]
                hw = (hw[0] // s, hw[1] // s)
            else:
                h = block(h)
        if si in net.taps:
            taps.append(h if si >= 3 else
                        fold.unfold_w(h, 4).permute(0, 3, 1, 2))
    return sml.decode(taps, d)
