"""SML model selection by `cfg.sml.model_type`: midas-small, its
direct-depth variant, and the DPT family table (every row of the JAX
package's, and 'dpt-hybrid').
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.models.dpt import DPTConfig, DPTScaleMapLearner
from riders_tpu_torch.models.levit import LeViTConfig
from riders_tpu_torch.models.next_vit import NextViTConfig
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.models.swin2 import SWIN1_LARGE, Swin2Config

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


def _swin_plan(name: str):
    """A swin row's backbone plan and its stage widths."""
    if name == "large":
        return Swin2Config(), (192, 384, 768, 1536)
    if name == "base":
        return Swin2Config(embed_dim=128, num_heads=(4, 8, 16, 32)), \
            (128, 256, 512, 1024)
    if name == "tiny":
        return Swin2Config(embed_dim=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24), window_size=16,
                           pretrained_window_sizes=(8, 8, 8, 4)), \
            (96, 192, 384, 768)
    if name == "v1-large":
        return SWIN1_LARGE, (192, 384, 768, 1536)
    raise ValueError(name)


# dpt_hybrid (vitb_rn50_384): ResNet50 stages + ViT-B, hooks [0, 1, 8, 11]
HYBRID = dict(backbone="vit_hybrid", embed_dim=768, depth=12, num_heads=12,
              hooks=(0, 1, 8, 11), reassemble_channels=(256, 512, 768, 768),
              pretrained_grid=24)


def dpt_config(cfg: RidersConfig) -> DPTConfig:
    """The DPTConfig of a 'dpt-*' model_type."""
    sml = cfg.sml
    common = dict(net_shape=sml.net_shape, in_channels=sml.in_channels,
                  min_pred=sml.min_pred, max_pred=sml.max_pred)
    if sml.model_type == "dpt-hybrid":
        return DPTConfig(**HYBRID, **common)
    if sml.model_type not in DPT_FAMILIES:
        raise ValueError(f"Unknown SML model_type: {sml.model_type}")
    backbone, dims, grid, swin = DPT_FAMILIES[sml.model_type]
    kw = dict(dims) if dims else {}
    if swin is not None:
        kw["swin2"], kw["reassemble_channels"] = _swin_plan(swin)
    if backbone == "next_vit":
        # 4 conv-map hooks, the scratch widths of the reference's row
        kw.update(next_vit=NextViTConfig(), hooks=(2, 6, 36, 39),
                  reassemble_channels=(96, 256, 512, 1024))
    if backbone == "levit":
        # 3-hook decode with the narrow head
        kw.update(levit=LeViTConfig(), hooks=(3, 11, 21),
                  reassemble_channels=(384, 512, 768), head_features_1=64,
                  head_features_2=8)
    return DPTConfig(backbone=backbone, pretrained_grid=grid, **kw,
                     **common)


def build_sml_model(cfg: RidersConfig, device=None,
                    dtype: torch.dtype = torch.float32) -> nn.Module:
    """The configured Scale Map Learner on `device` (the card unless
    device='cpu'):

    'midas-small'       -> ScaleMapLearner (scale regression)
    'midas-small-depth' -> ScaleMapLearner with direct depth regression
    'dpt-*'             -> DPTScaleMapLearner; see DPT_FAMILIES (ViT-L/B,
                           BEiT-L-512 / L-384 / B, SwinV2-L/B/T,
                           Swin-V1-L, LeViT-384, Next-ViT-L) and
                           'dpt-hybrid' (ResNet50 + ViT-B).
    """
    sml = cfg.sml
    if sml.model_type in ("midas-small", "midas-small-depth"):
        if sml.model_type == "midas-small-depth":
            sml = dataclasses.replace(sml, regress_mode="depth")
        return ScaleMapLearner(sml, device, dtype)
    return DPTScaleMapLearner(dpt_config(cfg), device, dtype)
