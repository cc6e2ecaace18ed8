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
  `vitb16_384`), BEiT (`beitl16_512`, `beitl16_384`, `beitb16_384`) or
  hybrid (`vitb_rn50_384`) backbone: `convert_dpt_state_dict`.  The
  Swin2, LeViT and Next-ViT rows raise NotImplementedError.

The port keeps torch layouts, so conv, linear and transposed-conv
weights pass through unchanged.  What changes is the naming (the port's
modules mirror the JAX package's flax tree), the split of timm's fused
ViT qkv projection into query / key / value, and the order of BEiT's
three cls rows of the relative-position table.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch.nn as nn

from riders_tpu_torch.models.dpt import UNPORTED, DPTConfig
from riders_tpu_torch.models.efficientnet import LITE3_STAGES

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


def convert_dpt_state_dict(sd: Mapping, cfg: DPTConfig) -> State:
    """DPTDepthModel state dict -> DPTScaleMapLearner state.

    `cfg` is the model's DPTConfig; its backbone, depth and pretrained
    grid must be the checkpoint's (beitl16_512 -> 'beit', grid 32;
    vitl16_384 -> 'vit', grid 24; vitb_rn50_384 -> 'vit_hybrid')."""
    if cfg.backbone in UNPORTED:
        raise NotImplementedError(
            f"the DPT {UNPORTED[cfg.backbone]} converter is not ported yet "
            "(ROADMAP.md A6)")
    p = "pretrained.model."
    out: State = {}
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
    for n in (1, 2, 3, 4):
        _copy(out, f"layer{n}_rn", sd, f"scratch.layer{n}_rn")
        _fusion(out, f"refinenet{n}", sd, f"scratch.refinenet{n}", n != 4)
    for j, idx in ((1, 0), (2, 2), (3, 4)):
        _copy(out, f"head_conv{j}", sd, f"scratch.output_conv.{idx}")
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
