"""Scale Map Learner (SML): MiDaS-small-style scale regression network.

A learned 3->3 stem, the EfficientNet-Lite3 encoder, four RefineNet-style
fusion blocks (bilinear x2, align_corners=True) and the output head
(bilinear x2, align_corners=False).
The network regresses a multiplicative scale map:

    scales = relu(1 + out);  pred = d * scales          (scale mode)

then clamps pred <= 1/min_pred and pred >= 1/max_pred.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from riders_tpu_torch.core.config import SMLConfig
from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.models.efficientnet import (EfficientNetLite3,
                                                  LITE3_STAGES, LITE3_TAPS)
from riders_tpu_torch.models.layers import BatchNorm2d, place
from riders_tpu_torch.ops.resize import resize_nchw


def _conv3(in_ch: int, out_ch: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=bias)


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv residual unit; convs have bias, no BN."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv3(features, features)
        self.conv2 = _conv3(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Optional skip through a residual unit, a residual unit, bilinear x2
    upsample, 1x1 out conv (halving channels when `expand`)."""

    def __init__(self, features: int, expand: bool = False,
                 align_corners: bool = True, has_skip: bool = True):
        super().__init__()
        self.align_corners = align_corners
        self.res_conf_unit1 = ResidualConvUnit(features) if has_skip else None
        self.res_conf_unit2 = ResidualConvUnit(features)
        out_features = features // 2 if expand else features
        self.out_conv = nn.Conv2d(features, out_features, 1, bias=True)

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = x
        if skip is not None:
            out = out + self.res_conf_unit1(skip)
        out = self.res_conf_unit2(out)
        out = resize_nchw(out, (2 * out.shape[-2], 2 * out.shape[-1]),
                          "bilinear", self.align_corners)
        return self.out_conv(out)


class OutputConv(nn.Module):
    """conv3 -> bilinear x2 (align_corners=False) -> conv3 -> relu -> conv1.
    The JAX package's bf16 default composes the upsample into the second
    conv; on the H100 that saves no device time and costs host time
    (PERF.md §6), so the port keeps the literal head."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv3(features, features // 2)
        self.conv2 = _conv3(features // 2, 32)
        self.conv3 = nn.Conv2d(32, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        up = resize_nchw(h, (2 * h.shape[-2], 2 * h.shape[-1]), "bilinear",
                         False)
        return self.conv3(F.relu(self.conv2(up)))


class ScaleMapLearner(nn.Module):
    """The SML network.

    forward(x, d):
      x: (N, H, W, in_channels) network input (int_depth_norm,
         int_scales_norm, gray), NHWC;
      d: (N, H, W, 1) unnormalized aligned inverse depth.
    Returns (pred, scales), both (N, H, W, 1) float32.
    """

    def __init__(self, config: SMLConfig = SMLConfig(), device=None,
                 dtype: torch.dtype = torch.float32,
                 backbone_stages: Tuple = LITE3_STAGES,
                 backbone_taps: Tuple = LITE3_TAPS,
                 backbone_stem: int = 32):
        super().__init__()
        cfg = self.config = config
        f = cfg.features
        widths = (f, 2 * f, 4 * f, 8 * f) if cfg.expand else (f, f, f, f)
        self.backbone_stages = tuple(backbone_stages)
        self.backbone_taps = tuple(backbone_taps)
        self.backbone_stem = backbone_stem
        self.first_conv = _conv3(cfg.in_channels, 3)
        self.first_bn = BatchNorm2d(3)
        self.pretrained = EfficientNetLite3(3, backbone_stages,
                                            backbone_taps, backbone_stem)
        taps = [backbone_stages[t][3] for t in backbone_taps]
        for i, (tap, width) in enumerate(zip(taps, widths)):
            self.add_module(f"layer{i + 1}_rn", _conv3(tap, width, False))
        ac = cfg.align_corners
        self.refinenet4 = FeatureFusionBlock(widths[3], cfg.expand, ac,
                                             has_skip=False)
        self.refinenet3 = FeatureFusionBlock(widths[2], cfg.expand, ac)
        self.refinenet2 = FeatureFusionBlock(widths[1], cfg.expand, ac)
        self.refinenet1 = FeatureFusionBlock(widths[0], False, ac)
        self.output_conv = OutputConv(f)
        place(self, resolve_device(device), dtype)

    def forward(self, x: torch.Tensor, d: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.first_conv.weight.dtype
        h = F.relu(self.first_bn(self.first_conv(
            x.to(dtype).permute(0, 3, 1, 2))))
        return self.decode(self.pretrained(h), d)

    def decode(self, taps, d: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`forward` from the backbone's four NCHW taps on: reassembly,
        fusion, the head and the scale regression."""
        cfg = self.config
        l1, l2, l3, l4 = taps
        p4 = self.refinenet4(self.layer4_rn(l4))
        p3 = self.refinenet3(p4, self.layer3_rn(l3))
        p2 = self.refinenet2(p3, self.layer2_rn(l2))
        p1 = self.refinenet1(p2, self.layer1_rn(l1))
        out = self.output_conv(p1).float().permute(0, 2, 3, 1)

        scales = F.relu(1.0 + out)
        pred = scales if cfg.regress_mode == "depth" else d.float() * scales
        if cfg.min_pred is not None and cfg.min_pred > 0:
            pred = torch.clamp(pred, max=1.0 / cfg.min_pred)
        if cfg.max_pred is not None:
            pred = torch.clamp(pred, min=1.0 / cfg.max_pred)
        return pred, scales
