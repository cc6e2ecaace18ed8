"""SML model selection by `cfg.sml.model_type`: midas-small, its
direct-depth variant, and the DPT family table.

`DPT_FAMILIES` has every row of the JAX package's table; the swin2,
levit and next_vit rows raise NotImplementedError until their backbones
are ported (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.models.dpt import (UNPORTED, DPTConfig,
                                         DPTScaleMapLearner)
from riders_tpu_torch.models.sml import ScaleMapLearner

# Per-family DPT settings: embed / depth / heads, hooks, reassemble
# channels.
_VIT_L = dict(embed_dim=1024, depth=24, num_heads=16,
              hooks=(5, 11, 17, 23),
              reassemble_channels=(256, 512, 1024, 1024))
_VIT_B = dict(embed_dim=768, depth=12, num_heads=12,
              hooks=(2, 5, 8, 11),
              reassemble_channels=(96, 192, 384, 768))

DPT_FAMILIES = {
    # model_type            backbone   dims     pretrained_grid
    "dpt-large":           ("vit", _VIT_L, 24, None),   # vitl16_384
    "dpt-vit-base":        ("vit", _VIT_B, 24, None),   # vitb16_384
    "dpt-beit-large":      ("beit", _VIT_L, 32, None),  # beitl16_512
    "dpt-beit-large-384":  ("beit", _VIT_L, 24, None),  # beitl16_384
    "dpt-beit-base":       ("beit", _VIT_B, 24, None),  # beitb16_384
    "dpt-swin2-large":     ("swin2", None, 24, "large"),    # swin2l24_384
    "dpt-swin2-base":      ("swin2", None, 24, "base"),     # swin2b24_384
    "dpt-swin2-tiny":      ("swin2", None, 16, "tiny"),     # swin2t16_256
    "dpt-swin-large":      ("swin2", None, 12, "v1-large"), # swinl12_384
    "dpt-levit-224":       ("levit", None, 14, None),       # levit_384
    "dpt-next-vit-large":  ("next_vit", None, 24, None),    # next_vit_large_6m
}

# dpt_hybrid (vitb_rn50_384): ResNet50 stages + ViT-B, hooks [0, 1, 8, 11]
HYBRID = dict(backbone="vit_hybrid", embed_dim=768, depth=12, num_heads=12,
              hooks=(0, 1, 8, 11), reassemble_channels=(256, 512, 768, 768),
              pretrained_grid=24)


def dpt_config(cfg: RidersConfig) -> DPTConfig:
    """The DPTConfig of a 'dpt-*' model_type; raises NotImplementedError
    for the families not ported yet."""
    sml = cfg.sml
    common = dict(net_shape=sml.net_shape, in_channels=sml.in_channels,
                  min_pred=sml.min_pred, max_pred=sml.max_pred)
    if sml.model_type == "dpt-hybrid":
        return DPTConfig(**HYBRID, **common)
    if sml.model_type not in DPT_FAMILIES:
        raise ValueError(f"Unknown SML model_type: {sml.model_type}")
    backbone, dims, grid, _ = DPT_FAMILIES[sml.model_type]
    if backbone in UNPORTED:
        raise NotImplementedError(
            f"SML model_type {sml.model_type!r}: the {UNPORTED[backbone]} "
            "backbone is not ported yet (ROADMAP.md A6)")
    return DPTConfig(backbone=backbone, pretrained_grid=grid, **dims,
                     **common)


def build_sml_model(cfg: RidersConfig, device=None,
                    dtype: torch.dtype = torch.float32) -> nn.Module:
    """The configured Scale Map Learner on `device` (the card unless
    device='cpu'):

    'midas-small'       -> ScaleMapLearner (scale regression)
    'midas-small-depth' -> ScaleMapLearner with direct depth regression
    'dpt-*'             -> DPTScaleMapLearner; see DPT_FAMILIES (ViT-L/B,
                           BEiT-L-512 / L-384 / B) and 'dpt-hybrid'
                           (ResNet50 + ViT-B).
    """
    sml = cfg.sml
    if sml.model_type in ("midas-small", "midas-small-depth"):
        if sml.model_type == "midas-small-depth":
            sml = dataclasses.replace(sml, regress_mode="depth")
        return ScaleMapLearner(sml, device, dtype)
    return DPTScaleMapLearner(dpt_config(cfg), device, dtype)
