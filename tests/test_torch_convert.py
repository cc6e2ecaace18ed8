"""The port's reference-checkpoint converters (riders_tpu_torch.models.
convert) against the JAX package's, on the state dicts of the torch
twins that the JAX converter tests define (tests/test_convert_{sml,
rcnet,dpt,hybrid,swin2,levit,next_vit}.py, imported, not copied; the
swin2 twin is a backbone, given a DPT scratch here from
test_convert_dpt.py's fusion blocks).

For each of the SML, RC-Net and DPT vit / beit / vit_hybrid / swin2 /
levit / next_vit converters:
* the port's state dict equals `torch_state_from_jax` of JAX's
  converted variables bit for bit, key for key (same dtype and shape);
* the port's model loaded with it reproduces the twin's forward at
  rtol 1e-4 (atol 1e-4 on the DPT's inverse depth; the SML and RC-Net
  maps are held at atol 1e-4 of their max abs);
and the full-size beitl16_512 key map converts, with zero-stride
stand-ins of the real shapes, onto a model built on the meta device.

The Swin V1 blocks, which no twin has, convert bit for bit as JAX's
do from a seeded synthetic state dict.  The Next-ViT converter sizes an
NTB's E-MHSA as the model does, where JAX's converter floors one step
later and asks for a patch embedding the model does not have.

Then the factory (riders_tpu_torch.models.factory): all twelve rows,
and each of them at full size, BEiT-L/16-512 and SwinV2-L included,
against JAX's variables by key, shape and parameter count
(`jax.eval_shape`; the port's model on the meta device, so nothing
full-size runs here)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import test_convert_dpt as tcd
import test_convert_hybrid as tch
import test_convert_levit as tcl
import test_convert_next_vit as tcn
import test_convert_rcnet as tcr
import test_convert_sml as tcs
import test_convert_swin2 as tcsw
from riders_tpu.core import config as jconfig
from riders_tpu.models import convert as jconvert
from riders_tpu.models import factory as jfactory
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.core.config import RCNetConfig, SMLConfig
from riders_tpu_torch.models import convert
from riders_tpu_torch.models import factory as tfactory
from riders_tpu_torch.models.dpt import DPTConfig, DPTScaleMapLearner
from riders_tpu_torch.models.from_jax import (load_state,
                                              torch_state_from_jax)
from riders_tpu_torch.models.levit import LeViTConfig
from riders_tpu_torch.models.next_vit import NextViTConfig
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.models.swin2 import Swin2Config

RTOL = 1e-4


def _numpy_sd(model):
    return {k: np.asarray(v.detach().numpy())
            for k, v in model.state_dict().items()}


def _perturb_norms(model, seed):
    """BatchNorm statistics and norm affine terms away from 0 / 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.num_features, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(
                    m.num_features, generator=g))
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.GroupNorm,
                              nn.LayerNorm)):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape,
                                                       generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return model


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def test_sml_converter_matches_jax_and_twin(rng):
    torch.manual_seed(0)
    twin = _perturb_norms(tcs.TSML().eval(), 1)
    sd = _numpy_sd(twin)
    model = ScaleMapLearner(
        SMLConfig(net_shape=(64, 96), features=tcs.FEATURES), "cpu",
        backbone_stages=tcs.TINY_STAGES, backbone_stem=tcs.STEM)
    state = convert.convert_sml_state_dict(sd, stages=tcs.TINY_STAGES)
    assert convert.check_state_matches(state, model) == []
    _assert_bitwise(state, torch_state_from_jax(
        jconvert.convert_sml_state_dict(sd, stages=tcs.TINY_STAGES),
        model))

    load_state(model, state)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    d = (rng.random((2, 64, 96, 1)) * 5).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(d).permute(0, 3, 1, 2))
        pred, _ = model(torch.from_numpy(x), torch.from_numpy(d))
    _assert_close(pred.numpy(), ref.permute(0, 2, 3, 1).numpy())


def test_sml_converter_reads_the_flat_output_conv():
    """Vanilla MiDaS-small checkpoints key the head
    `scratch.output_conv.N`; MidasNet_small_videpth's nest it once
    more."""
    sd = _numpy_sd(tcs.TSML())
    nested = {k.replace("scratch.output_conv.",
                        "scratch.output_conv.output_conv."): v
              for k, v in sd.items()}
    flat = convert.convert_sml_state_dict(sd, stages=tcs.TINY_STAGES)
    _assert_bitwise(convert.convert_sml_state_dict(
        nested, stages=tcs.TINY_STAGES), flat)


def test_rcnet_converter_matches_jax_and_twin(rng):
    torch.manual_seed(0)
    twin = _perturb_norms(tcr.TRCNet().eval(), 2)
    sd = {}
    for prefix, sub in (("encoder.", twin.encoder),
                        ("decoder.", twin.decoder)):
        sd.update({prefix + k: v for k, v in _numpy_sd(sub).items()})
    cfg = RCNetConfig(patch_size=tcr.PATCH,
                      n_filters_encoder_image=tcr.FILTERS,
                      n_neurons_encoder_depth=(8, 16, 32, 32, tcr.D_MODEL),
                      n_filters_decoder=tcr.DEC_FILTERS,
                      attention_layers=tcr.N_ATT, attention_heads=4)
    model = RCNet(cfg, "cpu")
    state = convert.convert_rcnet_state_dict(sd)
    assert convert.check_state_matches(state, model) == []
    _assert_bitwise(state, torch_state_from_jax(
        jconvert.convert_rcnet_state_dict(sd), model))

    load_state(model, state)
    H, W, K = 128, 160, 3
    image = rng.random((H, W, 3)).astype(np.float32)
    cx, cy = rng.integers(16, W - 16, K), rng.integers(32, H - 32, K)
    boxes = np.stack([cx - 16, cy - 32, cx + 16, cy + 32], 1
                     ).astype(np.float32)
    points = np.stack([cx, cy, rng.random(K) * 40 + 1], 1
                      ).astype(np.float32)
    ref = tcr.torch_rcnet_forward(twin, image, points, boxes)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a)[None]
                      for a in (image, points, boxes)))
    _assert_close(got[0].numpy(), ref)


def _twin_dpt(twin, cfg, rng, seed,
              jax_converter=jconvert.convert_dpt_state_dict):
    """The port's model from the twin's converted state against the
    twin's forward, and the converter against JAX's (`jax_converter`,
    given the port's config: it reads only its fields)."""
    sd = _numpy_sd(twin)
    model = DPTScaleMapLearner(cfg, "cpu")
    state = convert.convert_dpt_state_dict(sd, cfg)
    assert convert.check_state_matches(state, model) == []
    _assert_bitwise(state, torch_state_from_jax(jax_converter(sd, cfg),
                                                model))

    load_state(model, state)
    H, W = cfg.net_shape
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    d = (rng.random((2, H, W, 1)) * 5).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(d).permute(0, 3, 1, 2))
        pred, scales = model(torch.from_numpy(x), torch.from_numpy(d))
    assert float(scales.std()) > 1e-3        # the head is not all clamped
    np.testing.assert_allclose(pred.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=RTOL, atol=RTOL)


def _random_twin(twin, seed):
    """Weights N(0, 1 / fan_in), vectors N(0, 0.05), norms perturbed, and
    the head's last bias at 0.3, so that its relu passes a varied map."""
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in twin.parameters():
            p.normal_(0, p[0].numel() ** -0.5 if p.ndim > 1 else 0.05)
        twin.scratch.output_conv[4].bias.fill_(0.3)
    return _perturb_norms(twin, seed)


@pytest.mark.parametrize("backbone,net", [
    ("vit", (64, 64)), ("beit", (64, 64)), ("beit", (48, 80))],
    ids=["vit", "beit", "beit-48x80"])
def test_dpt_converter_matches_jax_and_twin(rng, backbone, net):
    """tests/test_convert_dpt.py's twins; at net 48x80 the runtime window
    (3, 5) differs from the pretrained grid (4, 4) and is not square, so
    both sides resize the relative-position table."""
    twin = _random_twin(tcd.TDPT(beit=backbone == "beit").eval(), 1)
    _twin_dpt(twin, DPTConfig(
        net_shape=net, backbone=backbone, embed_dim=tcd.DIM, depth=tcd.DEPTH,
        num_heads=tcd.HEADS, hooks=tcd.HOOKS,
        reassemble_channels=tcd.REASSEMBLE, features=tcd.FEATURES,
        pretrained_grid=tcd.GRID), rng, 1)


def test_dpt_hybrid_converter_matches_jax_and_twin(rng, monkeypatch):
    """tests/test_convert_hybrid.py's twin (the full ResNetV2-50 stages)
    with a narrow 4-block ViT at net 96x96: grid 6x6 against the
    pretrained 4x4, so the position embedding resizes on both sides."""
    dims = dict(DIM=32, HEADS=2, DEPTH=4, GRID=4,
                REASSEMBLE=(256, 512, 32, 32), FEATURES=8, HOOKS=(0, 1, 2, 3))
    for k, v in dims.items():
        monkeypatch.setattr(tcd, k, v)
    twin = _random_twin(tch.THybridDPT().eval(), 3)
    cfg = DPTConfig(net_shape=(96, 96), backbone="vit_hybrid", embed_dim=32,
                    depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                    reassemble_channels=dims["REASSEMBLE"], features=8,
                    pretrained_grid=4)
    _twin_dpt(twin, cfg, rng, 3)


def _beitl16_512_stand_ins(cfg):
    """A beitl16_512 state dict with the real key names and shapes, each
    entry a zero-stride view of one zero (no memory)."""
    def z(*shape):
        return np.broadcast_to(np.zeros((), np.float32), shape)

    D, H4, f = cfg.embed_dim, 4 * cfg.embed_dim, cfg.features
    p = "pretrained.model."
    sd = {p + "cls_token": z(1, 1, D),
          p + "patch_embed.proj.weight": z(D, 3, 16, 16),
          p + "patch_embed.proj.bias": z(D)}
    for i in range(cfg.depth):
        b = p + f"blocks.{i}."
        sd.update({b + "norm1.weight": z(D), b + "norm1.bias": z(D),
                   b + "norm2.weight": z(D), b + "norm2.bias": z(D),
                   b + "attn.qkv.weight": z(3 * D, D),
                   b + "attn.q_bias": z(D), b + "attn.v_bias": z(D),
                   b + "attn.relative_position_bias_table":
                       z((2 * 32 - 1) ** 2 + 3, cfg.num_heads),
                   b + "attn.proj.weight": z(D, D),
                   b + "attn.proj.bias": z(D),
                   b + "mlp.fc1.weight": z(H4, D), b + "mlp.fc1.bias": z(H4),
                   b + "mlp.fc2.weight": z(D, H4), b + "mlp.fc2.bias": z(D),
                   b + "gamma_1": z(D), b + "gamma_2": z(D)})
    for n, c in enumerate(cfg.reassemble_channels, start=1):
        ap = f"pretrained.act_postprocess{n}"
        sd.update({ap + ".0.project.0.weight": z(D, 2 * D),
                   ap + ".0.project.0.bias": z(D),
                   ap + ".3.weight": z(c, D, 1, 1), ap + ".3.bias": z(c)})
        k = {1: 4, 2: 2, 4: 3}.get(n)
        if k is not None:
            sd.update({ap + ".4.weight": z(c, c, k, k), ap + ".4.bias": z(c)})
        sd[f"scratch.layer{n}_rn.weight"] = z(f, c, 3, 3)
        rn = f"scratch.refinenet{n}"
        for u in (("resConfUnit1", "resConfUnit2") if n != 4
                  else ("resConfUnit2",)):
            for cv in ("conv1", "conv2"):
                sd[f"{rn}.{u}.{cv}.weight"] = z(f, f, 3, 3)
                sd[f"{rn}.{u}.{cv}.bias"] = z(f)
        sd[f"{rn}.out_conv.weight"] = z(f, f, 1, 1)
        sd[f"{rn}.out_conv.bias"] = z(f)
    for idx, (o, i, k) in ((0, (f // 2, f, 3)), (2, (32, f // 2, 3)),
                           (4, (1, 32, 1))):
        sd[f"scratch.output_conv.{idx}.weight"] = z(o, i, k, k)
        sd[f"scratch.output_conv.{idx}.bias"] = z(o)
    return sd


def test_dpt_full_size_beitl16_512_key_map():
    """Every key of a full-size beitl16_512 checkpoint lands on the
    full-size model (built on the meta device), shape for shape, with the
    same keys and shapes as JAX's converter gives through
    torch_state_from_jax."""
    cfg = DPTConfig(backbone="beit", pretrained_grid=32,
                    net_shape=(288, 352))
    with torch.device("meta"):
        model = DPTScaleMapLearner(cfg, "meta")
    sd = _beitl16_512_stand_ins(cfg)
    state = convert.convert_dpt_state_dict(sd, cfg)
    assert convert.check_state_matches(state, model) == []
    want = torch_state_from_jax(jconvert.convert_dpt_state_dict(sd, cfg),
                                model)
    assert {k: np.shape(v) for k, v in state.items()} == {
        k: np.shape(v) for k, v in want.items()}
    assert len(state) == sum(1 for _ in model.state_dict())


class TSwin2DPT(nn.Module):
    """tests/test_convert_swin2.py's TSwin2 (timm swin_transformer_v2
    keys) under pretrained.model, its four NHWC taps into a DPT scratch
    of test_convert_dpt.py's fusion blocks (no reassembly)."""

    def __init__(self, features=8):
        super().__init__()
        self.pretrained = nn.Module()
        self.pretrained.model = tcsw.TSwin2()
        f = features
        scratch = nn.Module()
        for i in range(4):
            setattr(scratch, f"layer{i + 1}_rn", nn.Conv2d(
                tcsw.EMBED * 2 ** i, f, 3, 1, 1, bias=False))
            setattr(scratch, f"refinenet{i + 1}", tcd.TFusion(f, i != 3))
        scratch.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, 1, 1),
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(f // 2, 32, 3, 1, 1), nn.ReLU(True),
            nn.Conv2d(32, 1, 1), nn.ReLU(True))
        self.scratch = scratch

    def forward(self, x, d):
        sc = self.scratch
        r = [getattr(sc, f"layer{i + 1}_rn")(t.permute(0, 3, 1, 2))
             for i, t in enumerate(self.pretrained.model(x))]
        p = sc.refinenet4(r[3], size=r[2].shape[2:])
        p = sc.refinenet3(p, r[2], size=r[1].shape[2:])
        p = sc.refinenet2(p, r[1], size=r[0].shape[2:])
        scales = F.relu(1.0 + sc.output_conv(sc.refinenet1(p, r[0])))
        return torch.clamp(torch.clamp(d * scales, max=10.0), min=1 / 255.0)


def _swin2_config():
    return DPTConfig(
        net_shape=(tcsw.IMG, tcsw.IMG), backbone="swin2", features=8,
        reassemble_channels=tuple(tcsw.EMBED * 2 ** i for i in range(4)),
        swin2=Swin2Config(embed_dim=tcsw.EMBED, depths=tcsw.DEPTHS,
                          num_heads=tcsw.HEADS, window_size=tcsw.WINDOW,
                          pretrained_window_sizes=tcsw.PRETRAINED))


def _levit_config(net=(tcl.IMG, tcl.IMG)):
    j = tcl.tiny_config()
    return DPTConfig(
        net_shape=net, backbone="levit", hooks=j.hooks,
        reassemble_channels=j.reassemble_channels, features=j.features,
        head_features_1=j.head_features_1,
        head_features_2=j.head_features_2,
        levit=LeViTConfig(**dataclasses.asdict(j.levit)))


def _next_vit_config():
    j = tcn.tiny_config()
    return DPTConfig(
        net_shape=j.net_shape, backbone="next_vit", hooks=j.hooks,
        reassemble_channels=j.reassemble_channels, features=j.features,
        head_features_2=j.head_features_2,
        next_vit=NextViTConfig(**dataclasses.asdict(j.next_vit)))


def test_dpt_swin2_converter_matches_jax_and_twin(rng):
    """The V2 twin at net 64x64 with window 4: grids 16, 8, 4, 2 (stage 2
    unshifted, stage 3's window clamped to 2)."""
    _twin_dpt(_random_twin(TSwin2DPT().eval(), 4), _swin2_config(), rng, 4)


def test_dpt_levit_converter_matches_jax_and_twin(rng):
    """Every BatchNorm (1-D and 2-D, and the ConvTranspose ones on the
    output axis) folded; the head's 58x58 map resized to the 64x64
    prior."""
    _twin_dpt(_random_twin(tcl.TDPTLevit().eval(), 5), _levit_config(), rng,
              5, jconvert.convert_levit_state_dict)


def test_dpt_next_vit_converter_matches_jax_and_twin(rng):
    """At net 48x48 the first NTB's 144 tokens are not a multiple of its
    sr^2 = 64."""
    _twin_dpt(_random_twin(tcn.TDPTNextViT().eval(), 6), _next_vit_config(),
              rng, 6, jconvert.convert_next_vit_state_dict)


def test_next_vit_converter_sizes_e_mhsa_as_the_model(rng, monkeypatch):
    """With mix_block_ratio 0.56 an NTB of 128 channels gives its E-MHSA
    _make_divisible(int(71.68)) = 64 channels in the model (and in the
    twin), where JAX's converter computes _make_divisible(71.68) = 96:
    it asks for a 96 -> 32 projection where the model's 64 -> 64 one is
    the identity, and for a patch embedding of the stage-2 NTB (64
    channels in) that neither has, and raises.  The port's converter
    follows the model and reproduces the twin."""
    nv = dataclasses.replace(tcn.tiny_nv_config(), mix_block_ratio=0.56)
    monkeypatch.setattr(tcn, "tiny_nv_config", lambda: nv)
    twin = _random_twin(tcn.TDPTNextViT().eval(), 7)
    cfg = dataclasses.replace(_next_vit_config(), next_vit=NextViTConfig(
        **dataclasses.asdict(nv)))
    sd = _numpy_sd(twin)
    with pytest.raises(KeyError, match="features.2.projection.conv"):
        jconvert.convert_next_vit_state_dict(sd, cfg)
    model = DPTScaleMapLearner(cfg, "cpu")
    assert model.pretrained.blocks_7.e_mhsa.q.in_features == 64
    assert model.pretrained.blocks_7.patch_embed.conv is None
    assert model.pretrained.blocks_2.projection.conv is None
    state = convert.convert_dpt_state_dict(sd, cfg)
    assert convert.check_state_matches(state, model) == []
    load_state(model, state)
    x = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    d = (rng.random((2, 48, 48, 1)) * 5).astype(np.float32)
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(d).permute(0, 3, 1, 2))
        pred, _ = model(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(pred.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=RTOL, atol=RTOL)


def _swin_v1_stand_ins(rng, cfg, p="pretrained.model."):
    """A timm swin V1 state dict (full qkv bias, learned relative-position
    tables, norm-first merging) for `cfg`'s stages, seeded values."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    E, sd = cfg.embed_dim, {}
    sd.update({p + "patch_embed.proj.weight": r(E, 3, 4, 4),
               p + "patch_embed.proj.bias": r(E),
               p + "patch_embed.norm.weight": r(E),
               p + "patch_embed.norm.bias": r(E)})
    res = tcsw.IMG // 4
    for si, depth in enumerate(cfg.depths):
        dim, window = E * 2 ** si, min(cfg.window_size, res)
        for bi in range(depth):
            b = p + f"layers.{si}.blocks.{bi}."
            for n, shape in (("norm1", (dim,)), ("norm2", (dim,)),
                             ("attn.qkv", (3 * dim, dim)),
                             ("attn.proj", (dim, dim)),
                             ("mlp.fc1", (4 * dim, dim)),
                             ("mlp.fc2", (dim, 4 * dim))):
                sd[b + n + ".weight"] = r(*shape)
                sd[b + n + ".bias"] = r(shape[0])
            sd[b + "attn.relative_position_bias_table"] = r(
                (2 * window - 1) ** 2, cfg.num_heads[si])
        if si < len(cfg.depths) - 1:
            ds = p + f"layers.{si}.downsample."
            sd[ds + "reduction.weight"] = r(2 * dim, 4 * dim)
            sd[ds + "norm.weight"] = r(4 * dim)
            sd[ds + "norm.bias"] = r(4 * dim)
            res //= 2
    return sd


def test_swin_v1_converter_matches_jax(rng):
    """V1 blocks are told from V2 ones by their missing logit scale; the
    backbone's keys convert bit for bit as JAX's do and fill the port's
    V1 backbone exactly."""
    cfg = dataclasses.replace(_swin2_config(), swin2=dataclasses.replace(
        _swin2_config().swin2, version=1))
    sd = _swin_v1_stand_ins(rng, cfg.swin2)
    model = DPTScaleMapLearner(cfg, "cpu")
    state = {}
    convert._swin2_backbone(state, sd, "pretrained.model.")
    backbone = {k: v for k, v in model.state_dict().items()
                if k.startswith("pretrained.")}
    assert sorted(state) == sorted(backbone)
    assert all(state[k].shape == tuple(v.shape) for k, v in backbone.items())
    _assert_bitwise(state, torch_state_from_jax({"params": {
        "pretrained": jconvert._convert_swin2_backbone(
            sd, "pretrained.model.")}}, model))


def test_dpt_converter_refuses_unported_families():
    """Each hierarchical family converts through convert_dpt_state_dict
    onto its model exactly (the levit and next_vit configs go to their own
    converters); a LeViT checkpoint whose bias tables were made at
    another resolution raises, as in JAX."""
    twins = ((TSwin2DPT(), _swin2_config()),
             (tcl.TDPTLevit(), _levit_config()),
             (tcn.TDPTNextViT(), _next_vit_config()))
    for twin, cfg in twins:
        state = convert.convert_dpt_state_dict(_numpy_sd(twin), cfg)
        model = DPTScaleMapLearner(cfg, "cpu")
        assert convert.check_state_matches(state, model) == [], cfg.backbone
    sd = _numpy_sd(tcl.TDPTLevit())
    wrong = _levit_config(net=(2 * tcl.IMG, 2 * tcl.IMG))
    for converter in (convert.convert_dpt_state_dict,
                      convert.convert_levit_state_dict,
                      jconvert.convert_levit_state_dict):
        with pytest.raises(ValueError, match="different input resolution"):
            converter(sd, wrong)


def test_load_torch_checkpoint_wrappers(tmp_path):
    """The wrapper formats: a lightning dict with `model.` prefixes,
    DataParallel's `module.`, and RC-Net's encoder / decoder pair."""
    sd = {"a.weight": torch.arange(3.0), "b.bias": torch.ones(2)}
    lightning = {"model": {"model.module." + k: v for k, v in sd.items()}}
    rc = {"train_step": 7, "radarnet_encoder_state_dict": {
        "module.x": torch.zeros(1)}, "radarnet_decoder_state_dict": {
        "y": torch.ones(1)}}
    for name, blob in (("l.pth", lightning), ("r.pth", rc)):
        torch.save(blob, tmp_path / name)
    got = convert.load_torch_checkpoint(str(tmp_path / "l.pth"))
    assert sorted(got) == sorted(sd)
    assert np.array_equal(got["a.weight"], np.arange(3.0, dtype=np.float32))
    got = convert.load_torch_checkpoint(str(tmp_path / "r.pth"))
    assert sorted(got) == ["decoder.y", "encoder.x"]
    want = jconvert.load_torch_checkpoint(str(tmp_path / "r.pth"))
    _assert_bitwise(got, want)


# ---- the factory at full size -----------------------------------------------

FULL_SIZE = ("dpt-beit-large", "dpt-large", "dpt-vit-base",
             "dpt-beit-large-384", "dpt-beit-base", "dpt-hybrid",
             "dpt-swin2-large", "dpt-swin2-base", "dpt-swin2-tiny",
             "dpt-swin-large", "dpt-levit-224", "dpt-next-vit-large")
# the nets of the rows whose variables depend on it: Swin V1's tables
# on its (clamped) windows, LeViT's on its token grid; the reference's
# own nets (the other rows' variables do not depend on it)
NETS = {"dpt-swin2-large": (384, 384), "dpt-swin2-base": (384, 384),
        "dpt-swin2-tiny": (256, 256), "dpt-swin-large": (384, 384),
        "dpt-levit-224": (224, 224)}


def _configs_for(model_type, net=(64, 64)):
    """Both packages' ZJU presets with `model_type` at net `net`."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config()
        out.append(cfg.replace(sml=dataclasses.replace(
            cfg.sml, model_type=model_type, net_shape=net)))
    return out


def test_factory_builds_jax_s_ported_rows(monkeypatch):
    """The port's table is JAX's; it builds all twelve rows (the eleven
    of DPT_FAMILIES and 'dpt-hybrid'; each is held at full size below)
    on the meta device at the row's net; an unknown type raises
    ValueError; with no card and no device the build raises."""
    rows = jfactory.DPT_FAMILIES
    assert rows == tfactory.DPT_FAMILIES
    assert sorted(FULL_SIZE) == sorted(list(rows) + ["dpt-hybrid"])
    for model_type in FULL_SIZE:
        _, tcfg = _configs_for(model_type, NETS.get(model_type, (64, 64)))
        with torch.device("meta"):
            model = tfactory.build_sml_model(tcfg, device="meta")
        backbone = rows.get(model_type, ("vit_hybrid",))[0]
        assert model.config.backbone == backbone, model_type
    _, tcfg = _configs_for("dpt-nonesuch")
    with pytest.raises(ValueError, match="dpt-nonesuch"):
        tfactory.build_sml_model(tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs_for("dpt-vit-base")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfactory.build_sml_model(tcfg)


@pytest.mark.parametrize("model_type", FULL_SIZE)
def test_full_size_models_match_jax_variables(model_type):
    """Each row at full size, at its net: JAX's variables
    (`jax.eval_shape`, as zero-stride stand-ins) map through
    torch_state_from_jax onto the port's model (built on the meta device)
    key for key and shape for shape, so the parameter counts are equal
    (BEiT-L/16-512: 342,807,233)."""
    net = NETS.get(model_type, (64, 64))
    jcfg, tcfg = _configs_for(model_type, net)
    jmodel = jfactory.build_sml_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + net + (3,)),
                            jnp.zeros((1,) + net + (1,)))
    stand_ins = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    with torch.device("meta"):
        model = tfactory.build_sml_model(tcfg, device="meta")
    assert model.config == tfactory.dpt_config(tcfg)
    mapped = torch_state_from_jax(stand_ins, model)
    assert {k: np.shape(v) for k, v in mapped.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_jax == sum(p.numel() for p in model.parameters())
    if model_type == "dpt-beit-large":
        assert n_jax == 342_807_233
