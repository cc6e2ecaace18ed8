"""Reference torch checkpoints -> the port's state dicts.

One-time converters so that reference-trained weights run in the port:
each takes the reference model's state dict ({key: numpy array}, as
`load_torch_checkpoint` returns it) and gives {port key: numpy array}
for `models.from_jax.load_state`:

    sd = load_torch_checkpoint("dpt_sml.pth")
    model = factory.build_sml_model(cfg, device="cpu")
    from_jax.load_state(model, convert_dpt_state_dict(sd, model.config))

Supported checkpoints:
* SML `.pth` - MidasNet_small_videpth (efficientnet-lite3 backbone):
  `convert_sml_state_dict`;
* RC-Net `.pth` - the `radarnet_encoder_state_dict` /
  `radarnet_decoder_state_dict` pair: `convert_rcnet_state_dict`;
* DPT SML `.pth` - DPTDepthModel with a ViT (`vitl16_384`,
  `vitb16_384`), BEiT (`beitl16_512`, `beitl16_384`, `beitb16_384`),
  hybrid (`vitb_rn50_384`), Swin V2 (`swin2l24_384`, `swin2b24_384`,
  `swin2t16_256`) or Swin V1 (`swinl12_384`) backbone:
  `convert_dpt_state_dict`; LeViT-384 (`levit_384`):
  `convert_levit_state_dict`; Next-ViT-L (`next_vit_large_6m`):
  `convert_next_vit_state_dict` (`convert_dpt_state_dict` passes these
  two on).

The port keeps torch layouts, so conv, linear and transposed-conv
weights pass through unchanged.  What changes is the naming (the port's
modules mirror the JAX package's flax tree), the split of timm's fused
ViT qkv projection into query / key / value, the order of BEiT's three
cls rows of the relative-position table, and, for LeViT and Next-ViT,
every BatchNorm folded into the conv or linear before it (or into an
`Affine` where it stands alone), as timm's own `fuse()` does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch.nn as nn

from riders_tpu_torch.models.dpt import DPTConfig
from riders_tpu_torch.models.efficientnet import LITE3_STAGES
from riders_tpu_torch.models.levit import (LeViTConfig, _bias_idxs,
                                           _grid_points, stem_grid,
                                           sub_grid)
from riders_tpu_torch.models.next_vit import (NextViTConfig, mhsa_channels,
                                              stage_plan)

State = Dict[str, np.ndarray]


def load_torch_checkpoint(path: str) -> State:
    """Load a reference .pth into {key: numpy}, tolerating its wrapper
    formats: a bare state dict, {"model": state dict}, lightning's
    `model.` prefixes, DataParallel's `module.` prefixes, and RC-Net's
    encoder / decoder pair (prefixed `encoder.` / `decoder.`)."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "radarnet_encoder_state_dict" in blob:
        sd = {}
        for prefix, sub in (("encoder.", "radarnet_encoder_state_dict"),
                            ("decoder.", "radarnet_decoder_state_dict")):
            for k, v in blob[sub].items():
                sd[prefix + k.removeprefix("module.")] = v
    else:
        sd = blob.get("model", blob) if isinstance(blob, dict) else blob
        if any(k.startswith("model.") for k in sd):
            sd = {k.removeprefix("model."): v for k, v in sd.items()}
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()}


def _copy(out: State, key: str, sd: Mapping, prefix: str,
          bias: bool = True) -> None:
    """A conv / linear: `<prefix>.weight` (and `.bias` when present)."""
    out[key + ".weight"] = sd[prefix + ".weight"]
    if bias and prefix + ".bias" in sd:
        out[key + ".bias"] = sd[prefix + ".bias"]


def _bn(out: State, key: str, sd: Mapping, prefix: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{key}.{leaf}"] = sd[f"{prefix}.{leaf}"]


def _effnet_block_map(stages=LITE3_STAGES):
    """(reference prefix, port name) of every lite3 block under the MiDaS
    layer slicing: layer1 = [conv_stem, bn1, act, blocks0, blocks1];
    layer2 = [blocks2]; layer3 = [blocks3, blocks4]; layer4 = [blocks5,
    blocks6]."""
    layer_of_stage = {0: ("layer1", 3), 1: ("layer1", 4), 2: ("layer2", 0),
                      3: ("layer3", 0), 4: ("layer3", 1), 5: ("layer4", 0),
                      6: ("layer4", 1)}
    pairs = []
    for si, stage in enumerate(stages):
        layer, seq_idx = layer_of_stage[si]
        for bi in range(stage[4]):
            pairs.append((f"pretrained.{layer}.{seq_idx}.{bi}",
                          f"stage{si}_block{bi}"))
    return pairs


def _fusion(out: State, key: str, sd: Mapping, prefix: str,
            has_skip: bool) -> None:
    """A refinenet: out_conv and the residual units (the deepest one takes
    no skip, so its resConfUnit1 is dead weight and skipped)."""
    _copy(out, f"{key}.out_conv", sd, f"{prefix}.out_conv")
    units = (1, 2) if has_skip else (2,)
    for u in units:
        for c in ("conv1", "conv2"):
            _copy(out, f"{key}.res_conf_unit{u}.{c}", sd,
                  f"{prefix}.resConfUnit{u}.{c}")


def convert_sml_state_dict(sd: Mapping, stages=LITE3_STAGES) -> State:
    """MidasNet_small_videpth state dict -> ScaleMapLearner state."""
    out: State = {}
    _copy(out, "first_conv", sd, "first.0")
    _bn(out, "first_bn", sd, "first.1")
    _copy(out, "pretrained.conv_stem", sd, "pretrained.layer1.0")
    _bn(out, "pretrained.bn_stem", sd, "pretrained.layer1.1")
    for ref, name in _effnet_block_map(stages):
        is_ds = f"{ref}.conv_pwl.weight" not in sd
        convs = (("conv_dw", "conv_pw") if is_ds
                 else ("conv_pw", "conv_dw", "conv_pwl"))
        for c in convs:
            _copy(out, f"pretrained.{name}.{c}", sd, f"{ref}.{c}")
        for b in (("bn1", "bn2") if is_ds else ("bn1", "bn2", "bn3")):
            _bn(out, f"pretrained.{name}.{b}", sd, f"{ref}.{b}")
    for i in (1, 2, 3, 4):
        _copy(out, f"layer{i}_rn", sd, f"scratch.layer{i}_rn")
        _fusion(out, f"refinenet{i}", sd, f"scratch.refinenet{i}", i != 4)
    # MidasNet_small_videpth's OutputConv nests a second `output_conv`
    # Sequential; vanilla MiDaS-small checkpoints use the flat one.
    oc = ("scratch.output_conv.output_conv"
          if "scratch.output_conv.output_conv.0.weight" in sd
          else "scratch.output_conv")
    for name, idx in (("conv1", 0), ("conv2", 2), ("conv3", 4)):
        _copy(out, f"output_conv.{name}", sd, f"{oc}.{idx}")
    return out


def _convblock(out: State, key: str, sd: Mapping, prefix: str,
               use_bn: bool) -> None:
    out[f"{key}.conv.weight"] = sd[f"{prefix}.conv.weight"]
    if use_bn and f"{prefix}.batch_norm.weight" in sd:
        _bn(out, f"{key}.bn", sd, f"{prefix}.batch_norm")


def convert_rcnet_state_dict(sd: Mapping) -> State:
    """RCNetEncoder + MultiScaleDecoder state dicts (keys prefixed
    `encoder.` / `decoder.`) -> RCNet state."""
    out: State = {}
    enc = "encoder.encoder_image"
    _convblock(out, "encoder_image.conv1", sd, f"{enc}.conv1", True)
    for stage in (2, 3, 4, 5):
        for bi in (0, 1):
            ref = f"{enc}.blocks{stage}.{bi}"
            key = f"encoder_image.blocks{stage}_{bi}"
            for c in ("conv1", "conv2"):
                _convblock(out, f"{key}.{c}", sd, f"{ref}.{c}", True)
            # the reference creates a projection in every block but
            # applies it only in a stage's first
            if bi == 0 and f"{ref}.projection.conv.weight" in sd:
                _convblock(out, f"{key}.projection", sd,
                           f"{ref}.projection", False)
    for i in range(6):
        name = f"fc{i}" if i < 5 else "fc_out"
        _copy(out, f"encoder_depth.{name}.linear", sd,
              f"encoder.encoder_depth.mlp.{i}.fully_connected")
    i = 0
    while f"encoder.attention.layers.{i}.q_proj.weight" in sd:
        ref, key = f"encoder.attention.layers.{i}", f"attention.layer{i}"
        for name, src in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                          ("v_proj", "v_proj"), ("merge", "merge"),
                          ("mlp1", "mlp.0"), ("mlp2", "mlp.2")):
            _copy(out, f"{key}.{name}", sd, f"{ref}.{src}", bias=False)
        for norm in ("norm1", "norm2"):
            _copy(out, f"{key}.{norm}", sd, f"{ref}.{norm}")
        i += 1
    out.update(convert_rcnet_decoder_state_dict(sd))
    return out


def convert_rcnet_decoder_state_dict(sd: Mapping) -> State:
    """The decoder's part (`decoder.*` keys) of convert_rcnet_state_dict,
    with the multi-resolution output convs when present."""
    out: State = {}
    for d in (6, 5, 4, 3, 2, 1, 0):
        ref = f"decoder.deconv{d}"
        if d > 4 and f"{ref}.conv.conv.weight" not in sd:
            continue            # a decoder shallower than d + 1
        _convblock(out, f"decoder.deconv{d}.deconv.conv", sd,
                   f"{ref}.deconv.conv", True)
        _convblock(out, f"decoder.deconv{d}.conv", sd, f"{ref}.conv", True)
    _convblock(out, "decoder.output0", sd, "decoder.output0", False)
    for r in (1, 2, 3):
        if f"decoder.output{r}.conv.weight" in sd:
            _convblock(out, f"decoder.output{r}", sd, f"decoder.output{r}",
                       False)
    return out


def _vit_block(out: State, key: str, sd: Mapping, ref: str,
               backbone: str) -> None:
    """One timm ViT / BEiT block."""
    for name, src in (("norm1", "norm1"), ("norm2", "norm2"),
                      ("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2")):
        _copy(out, f"{key}.{name}", sd, f"{ref}.{src}")
    if backbone == "beit":
        table = sd[f"{ref}.attn.relative_position_bias_table"]
        out[f"{key}.attn.qkv_kernel"] = sd[f"{ref}.attn.qkv.weight"]
        out[f"{key}.attn.q_bias"] = sd[f"{ref}.attn.q_bias"]
        out[f"{key}.attn.v_bias"] = sd[f"{ref}.attn.v_bias"]
        # timm orders the cls rows (cls->tok, tok->cls, cls<->cls); the
        # port's index (dpt.beit_rel_pos_index) (cls<->cls, cls->tok,
        # tok->cls)
        out[f"{key}.attn.rel_pos_bias_table"] = np.concatenate(
            [table[:-3], table[[-1, -3, -2]]], axis=0)
        _copy(out, f"{key}.attn.proj", sd, f"{ref}.attn.proj")
        out[f"{key}.gamma_1"] = sd[f"{ref}.gamma_1"]
        out[f"{key}.gamma_2"] = sd[f"{ref}.gamma_2"]
        return
    # timm's fused qkv (3C, C) -> query / key / value; proj -> out
    w, b = sd[f"{ref}.attn.qkv.weight"], sd[f"{ref}.attn.qkv.bias"]
    C = w.shape[1]
    for row, name in enumerate(("query", "key", "value")):
        out[f"{key}.attn.{name}.weight"] = w[row * C:(row + 1) * C]
        out[f"{key}.attn.{name}.bias"] = b[row * C:(row + 1) * C]
    _copy(out, f"{key}.attn.out", sd, f"{ref}.attn.proj")


def _reassemble(out: State, n: int, sd: Mapping, resize: bool) -> None:
    """act_postprocess{n}: readout projection, 1x1 projection and the
    resize (a ConvTranspose's (in, out, kh, kw) weight is the port's)."""
    ap = f"pretrained.act_postprocess{n}"
    _copy(out, f"reassemble{n}.readout_project", sd, f"{ap}.0.project.0")
    _copy(out, f"reassemble{n}.project", sd, f"{ap}.3")
    if resize:
        _copy(out, f"reassemble{n}.resize", sd, f"{ap}.4")


def _hybrid_backbone(out: State, sd: Mapping, p: str) -> None:
    """timm `vit_base_resnet50_384` ResNetV2 stages under
    pretrained.backbone (StdConv weights, GroupNorms)."""
    bb, key = p + "patch_embed.backbone.", "pretrained.backbone."
    out[key + "stem_conv.weight"] = sd[bb + "stem.conv.weight"]
    _copy(out, key + "stem_norm.gn", sd, bb + "stem.norm")
    si = 0
    while bb + f"stages.{si}.blocks.0.conv1.weight" in sd:
        bi = 0
        while bb + f"stages.{si}.blocks.{bi}.conv1.weight" in sd:
            ref = bb + f"stages.{si}.blocks.{bi}."
            blk = key + f"stage{si}_block{bi}."
            for j in (1, 2, 3):
                out[blk + f"conv{j}.weight"] = sd[ref + f"conv{j}.weight"]
                _copy(out, blk + f"norm{j}.gn", sd, ref + f"norm{j}")
            if ref + "downsample.conv.weight" in sd:
                out[blk + "downsample_conv.weight"] = sd[
                    ref + "downsample.conv.weight"]
                _copy(out, blk + "downsample_norm.gn", sd,
                      ref + "downsample.norm")
            bi += 1
        si += 1


def _dpt_scratch(out: State, sd: Mapping, levels: int = 4) -> None:
    """scratch.*: the layer_rn convs, the refinenets (the deepest takes
    no skip) and the output head, shared by every DPT family."""
    for n in range(1, levels + 1):
        _copy(out, f"layer{n}_rn", sd, f"scratch.layer{n}_rn")
        _fusion(out, f"refinenet{n}", sd, f"scratch.refinenet{n}",
                n != levels)
    for j, idx in ((1, 0), (2, 2), (3, 4)):
        _copy(out, f"head_conv{j}", sd, f"scratch.output_conv.{idx}")


def _swin2_backbone(out: State, sd: Mapping, p: str) -> None:
    """timm 0.6.12 swin_transformer(_v2) keys under `p`: V2 blocks (q / v
    biases, logit scales, cpb MLPs) and V1 blocks (full qkv bias, learned
    relative-position tables), told apart per block by
    `attn.logit_scale`."""
    key = "pretrained."
    _copy(out, key + "patch_embed", sd, p + "patch_embed.proj")
    _copy(out, key + "patch_norm", sd, p + "patch_embed.norm")
    si = 0
    while p + f"layers.{si}.blocks.0.norm1.weight" in sd:
        bi = 0
        while p + f"layers.{si}.blocks.{bi}.norm1.weight" in sd:
            ref = p + f"layers.{si}.blocks.{bi}."
            blk = key + f"stage{si}_block{bi}."
            for name, src in (("norm1", "norm1"), ("norm2", "norm2"),
                              ("mlp_fc1", "mlp.fc1"),
                              ("mlp_fc2", "mlp.fc2"),
                              ("attn.proj", "attn.proj")):
                _copy(out, blk + name, sd, ref + src)
            if ref + "attn.logit_scale" in sd:               # V2
                out[blk + "attn.qkv_kernel"] = sd[ref + "attn.qkv.weight"]
                for leaf in ("q_bias", "v_bias", "logit_scale"):
                    out[blk + "attn." + leaf] = sd[ref + "attn." + leaf]
                _copy(out, blk + "attn.cpb_fc1", sd, ref + "attn.cpb_mlp.0")
                _copy(out, blk + "attn.cpb_fc2", sd, ref + "attn.cpb_mlp.2")
            else:                                            # V1
                _copy(out, blk + "attn.qkv", sd, ref + "attn.qkv")
                out[blk + "attn.rel_pos_bias_table"] = sd[
                    ref + "attn.relative_position_bias_table"]
            bi += 1
        ds = p + f"layers.{si}.downsample"
        if ds + ".reduction.weight" in sd:
            _copy(out, key + f"downsample{si}.reduction", sd,
                  ds + ".reduction")
            _copy(out, key + f"downsample{si}.norm", sd, ds + ".norm")
        si += 1


def convert_dpt_state_dict(sd: Mapping, cfg: DPTConfig) -> State:
    """DPTDepthModel state dict -> DPTScaleMapLearner state.

    `cfg` is the model's DPTConfig; its backbone, depth and pretrained
    grid must be the checkpoint's (beitl16_512 -> 'beit', grid 32;
    vitl16_384 -> 'vit', grid 24; vitb_rn50_384 -> 'vit_hybrid';
    swin2l24_384 -> 'swin2').  A 'levit' or 'next_vit' config goes to
    its own converter."""
    if cfg.backbone == "levit":
        return convert_levit_state_dict(sd, cfg)
    if cfg.backbone == "next_vit":
        return convert_next_vit_state_dict(sd, cfg)
    p = "pretrained.model."
    out: State = {}
    if cfg.backbone == "swin2":
        _swin2_backbone(out, sd, p)
        _dpt_scratch(out, sd)
        return out
    hybrid = cfg.backbone == "vit_hybrid"
    if hybrid:
        _hybrid_backbone(out, sd, p)
    _copy(out, "pretrained.patch_embed", sd, p + "patch_embed.proj")
    out["pretrained.cls_token"] = sd[p + "cls_token"]
    if cfg.backbone != "beit":
        out["pretrained.pos_embed"] = sd[p + "pos_embed"]
    for i in range(cfg.depth):
        _vit_block(out, f"pretrained.block{i}", sd, p + f"blocks.{i}",
                   "vit" if hybrid else cfg.backbone)
    # hybrid: taps 1-2 are the resnet maps; 3 is identity, 4 a /2 conv
    for n in ((3, 4) if hybrid else (1, 2, 3, 4)):
        _reassemble(out, n, sd, resize=n != 3)
    _dpt_scratch(out, sd)
    return out


def _fold_bn(w: np.ndarray, sd: Mapping, bn: str, out_axis: int = 0,
             eps: float = 1e-5):
    """Fold an eval-mode BatchNorm into the weight before it (timm's
    `fuse()`): w * gamma / sqrt(var + eps) along the output channels,
    and the bias beta - mean * gamma / sqrt(var + eps)."""
    s = sd[bn + ".weight"] / np.sqrt(sd[bn + ".running_var"] + eps)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    return (w * s.reshape(shape),
            sd[bn + ".bias"] - sd[bn + ".running_mean"] * s)


def _folded(out: State, key: str, sd: Mapping, prefix: str,
            conv: str = ".c", norm: str = ".bn", out_axis: int = 0) -> None:
    """A conv / linear without bias and its BatchNorm -> `key` with the BN
    folded in (out_axis 1 for a ConvTranspose2d's (in, out, kh, kw))."""
    w, b = _fold_bn(sd[prefix + conv + ".weight"], sd, prefix + norm,
                    out_axis)
    out[key + ".weight"], out[key + ".bias"] = w, b


def _bn_affine(out: State, key: str, sd: Mapping, prefix: str,
               eps: float = 1e-5) -> None:
    """A standalone eval-mode BatchNorm -> an Affine: weight gamma /
    sqrt(var + eps), bias beta - mean * weight."""
    s = sd[prefix + ".weight"] / np.sqrt(sd[prefix + ".running_var"] + eps)
    out[key + ".weight"] = s
    out[key + ".bias"] = sd[prefix + ".bias"] - sd[
        prefix + ".running_mean"] * s


def convert_levit_state_dict(sd: Mapping, cfg: DPTConfig) -> State:
    """DPT levit_384 state dict -> DPTScaleMapLearner('levit') state.

    Every LinearNorm / ConvNorm / ConvTransposeNorm BatchNorm is folded
    into its weight; the block walk follows timm levit_384's flat
    nn.Sequential numbering.  Each attention-bias table holds one entry
    per offset of the token grid it was trained at (14x14 at 224x224),
    and the model gathers it by the grid of `cfg.net_shape`, so a table
    of another width raises ValueError."""
    lcfg = cfg.levit or LeViTConfig()
    grid = stem_grid(cfg.net_shape)

    def checked_bias(key: str, n_off: int) -> np.ndarray:
        table = sd[key]
        if table.shape[-1] != n_off:
            raise ValueError(
                f"levit checkpoint table {key!r} holds {table.shape[-1]} "
                f"attention-bias offsets, but net_shape="
                f"{tuple(cfg.net_shape)} implies a {grid} token grid "
                f"needing {n_off}: the checkpoint was trained at a "
                "different input resolution (timm levit_384 ships "
                "14x14 = 224x224 tables); pick the matching net_shape")
        return table

    p, key = "pretrained.model.", "pretrained."
    out: State = {}
    for j in (0, 2, 4, 6):          # the stem convs' Sequential slots
        _folded(out, key + f"stem_conv{j}", sd, p + f"patch_embed.{j}")
    i = 0
    for si in range(3):
        _, n_off = _bias_idxs(_grid_points(*grid), _grid_points(*grid))
        for _ in range(lcfg.depths[si]):
            ref, blk = p + f"blocks.{i}.m.", key + f"blocks_{i}."
            _folded(out, blk + "qkv", sd, ref + "qkv")
            _folded(out, blk + "proj", sd, ref + "proj.1")
            out[blk + "attention_biases"] = checked_bias(
                ref + "attention_biases", n_off)
            i += 1
            _folded(out, key + f"blocks_{i}.fc1", sd, p + f"blocks.{i}.m.0")
            _folded(out, key + f"blocks_{i}.fc2", sd, p + f"blocks.{i}.m.2")
            i += 1
        if si < 2:
            sub = sub_grid(grid)
            _, n_off_sub = _bias_idxs(_grid_points(*sub),
                                      _grid_points(*grid), stride=2)
            ref, blk = p + f"blocks.{i}.", key + f"blocks_{i}."
            _folded(out, blk + "kv", sd, ref + "kv")
            _folded(out, blk + "q", sd, ref + "q.1")
            _folded(out, blk + "proj", sd, ref + "proj.1")
            out[blk + "attention_biases"] = checked_bias(
                ref + "attention_biases", n_off_sub)
            grid = sub
            i += 1
            _folded(out, key + f"blocks_{i}.fc1", sd, p + f"blocks.{i}.m.0")
            _folded(out, key + f"blocks_{i}.fc2", sd, p + f"blocks.{i}.m.2")
            i += 1
    _dpt_scratch(out, sd, levels=3)
    for j, slot in enumerate((0, 2)):   # hard-swish at slots 1 and 3
        _folded(out, f"stem_transpose_conv{j}", sd,
                f"scratch.stem_transpose.{slot}", out_axis=1)
    return out


def _nv_mhca(out: State, key: str, sd: Mapping, prefix: str) -> None:
    """Next-ViT MHCA: the grouped 3x3 conv and its BN, folded; the
    biasless 1x1 projection."""
    _folded(out, key + ".group_conv", sd, prefix, ".group_conv3x3",
            ".norm")
    out[key + ".projection.weight"] = sd[prefix + ".projection.weight"]


def _nv_mlp(out: State, key: str, sd: Mapping, prefix: str) -> None:
    """Next-ViT Mlp: two 1x1 convs with bias -> (out, in) weights."""
    for c in ("conv1", "conv2"):
        out[f"{key}.{c}.weight"] = sd[f"{prefix}.{c}.weight"][:, :, 0, 0]
        out[f"{key}.{c}.bias"] = sd[f"{prefix}.{c}.bias"]


def convert_next_vit_state_dict(sd: Mapping, cfg: DPTConfig) -> State:
    """DPT next_vit_large_6m state dict (timm nextvit_large keys: stem.N,
    features.N) -> DPTScaleMapLearner('next_vit') state.

    Every BatchNorm is folded: the biasless conv + BN pairs (stem,
    patch embeddings, MHCA's grouped conv) into the conv, the standalone
    norms (NCB's `norm`, NTB's `norm1` / `norm2`, E-MHSA's BatchNorm1d)
    into Affines.  An NTB's E-MHSA width is the model's,
    `next_vit.mhsa_channels` (the JAX converter floors the product one
    step later; ROADMAP.md C)."""
    nvcfg = cfg.next_vit or NextViTConfig()
    types, chans = stage_plan(nvcfg)
    p, key = "pretrained.model.", "pretrained."
    out: State = {}
    for j in range(4):
        _folded(out, key + f"stem_conv{j}", sd, p + f"stem.{j}", ".conv",
                ".norm")
    i, in_ch = 0, nvcfg.stem_chs[-1]
    for si in range(4):
        for bi, (bt, c) in enumerate(zip(types[si], chans[si])):
            stride = nvcfg.strides[si] if bi == 0 else 1
            ref, blk = p + f"features.{i}", key + f"blocks_{i}"
            embed_ch = (c if bt == "ncb"
                        else mhsa_channels(c, nvcfg.mix_block_ratio))
            if stride == 2 or in_ch != embed_ch:
                _folded(out, blk + ".patch_embed.conv", sd,
                        ref + ".patch_embed", ".conv", ".norm")
            _nv_mhca(out, blk + ".mhca", sd, ref + ".mhca")
            _nv_mlp(out, blk + ".mlp", sd, ref + ".mlp")
            if bt == "ncb":
                _bn_affine(out, blk + ".norm", sd, ref + ".norm")
            else:
                _bn_affine(out, blk + ".norm1", sd, ref + ".norm1")
                _bn_affine(out, blk + ".norm2", sd, ref + ".norm2")
                for k in ("q", "k", "v", "proj"):
                    _copy(out, f"{blk}.e_mhsa.{k}", sd, f"{ref}.e_mhsa.{k}")
                if nvcfg.sr_ratios[si] > 1:
                    _bn_affine(out, blk + ".e_mhsa.norm", sd,
                               ref + ".e_mhsa.norm")
                if 2 * embed_ch != c:       # else an identity
                    _folded(out, blk + ".projection.conv", sd,
                            ref + ".projection", ".conv", ".norm")
            in_ch = c
            i += 1
    _dpt_scratch(out, sd)
    return out


def check_state_matches(state: Mapping, module: nn.Module) -> List[str]:
    """Compare a converted state with a model's own: every missing or
    extra key and every shape that differs (empty = exact match)."""
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    problems = [f"missing {k}" for k in own if k not in state]
    problems += [f"extra {k}" for k in state if k not in own]
    problems += [f"shape {k}: {tuple(np.shape(state[k]))} vs {s}"
                 for k, s in own.items()
                 if k in state and tuple(np.shape(state[k])) != s]
    return problems
