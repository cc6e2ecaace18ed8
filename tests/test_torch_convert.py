"""The port's reference-checkpoint converters (riders_tpu_torch.models.
convert) against the JAX package's, on the state dicts of the torch
twins that the JAX converter tests define (tests/test_convert_{sml,
rcnet,dpt,hybrid}.py, imported, not copied).

For each of the SML, RC-Net and DPT vit / beit / vit_hybrid converters:
* the port's state dict equals `torch_state_from_jax` of JAX's
  converted variables bit for bit, key for key (same dtype and shape);
* the port's model loaded with it reproduces the twin's forward at
  rtol 1e-4 (atol 1e-4 on the DPT's inverse depth; the SML and RC-Net
  maps are held at atol 1e-4 of their max abs);
and the full-size beitl16_512 key map converts, with zero-stride
stand-ins of the real shapes, onto a model built on the meta device.

Then the factory (riders_tpu_torch.models.factory): JAX's ported rows,
and each of them at full size, BEiT-L/16-512 included, against JAX's
variables by key, shape and parameter count (`jax.eval_shape`; the
port's model on the meta device, so nothing full-size runs here)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

import test_convert_dpt as tcd
import test_convert_hybrid as tch
import test_convert_rcnet as tcr
import test_convert_sml as tcs
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
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner

RTOL = 1e-4


def _numpy_sd(model):
    return {k: np.asarray(v.detach().numpy())
            for k, v in model.state_dict().items()}


def _perturb_norms(model, seed):
    """BatchNorm statistics and norm affine terms away from 0 / 1."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.num_features, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(
                    m.num_features, generator=g))
            if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
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


def _twin_dpt(twin, cfg, rng, seed):
    """The port's model from the twin's converted state against the
    twin's forward, and the converter against JAX's."""
    sd = _numpy_sd(twin)
    model = DPTScaleMapLearner(cfg, "cpu")
    state = convert.convert_dpt_state_dict(sd, cfg)
    assert convert.check_state_matches(state, model) == []
    _assert_bitwise(state, torch_state_from_jax(
        jconvert.convert_dpt_state_dict(sd, cfg), model))

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


def test_dpt_converter_refuses_unported_families():
    for backbone in ("swin2", "levit", "next_vit"):
        with pytest.raises(NotImplementedError, match="A6"):
            convert.convert_dpt_state_dict({}, DPTConfig(backbone=backbone))


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

UNPORTED_BACKBONES = ("swin2", "levit", "next_vit")
FULL_SIZE = ("dpt-beit-large", "dpt-large", "dpt-vit-base",
             "dpt-beit-large-384", "dpt-beit-base", "dpt-hybrid")


def _configs_for(model_type, net=(64, 64)):
    """Both packages' ZJU presets with `model_type` at net `net` (the
    variables do not depend on it)."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config()
        out.append(cfg.replace(sml=dataclasses.replace(
            cfg.sml, model_type=model_type, net_shape=net)))
    return out


def test_factory_builds_jax_s_ported_rows(monkeypatch):
    """The port's table is JAX's; it builds every row but the Swin2,
    LeViT and Next-ViT families, which raise (the rows it builds are
    held at full size below); an unknown type raises ValueError; with no
    card and no device the build raises."""
    rows = jfactory.DPT_FAMILIES
    assert rows == tfactory.DPT_FAMILIES
    unported = [k for k, row in rows.items()
                if row[0] in UNPORTED_BACKBONES]
    assert len(unported) == 6
    assert len(rows) - len(unported) == len(FULL_SIZE) - 1     # + hybrid
    for model_type in unported:
        _, tcfg = _configs_for(model_type)
        with pytest.raises(NotImplementedError, match=model_type):
            tfactory.build_sml_model(tcfg, device="cpu")
    _, tcfg = _configs_for("dpt-nonesuch")
    with pytest.raises(ValueError, match="dpt-nonesuch"):
        tfactory.build_sml_model(tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs_for("dpt-vit-base")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfactory.build_sml_model(tcfg)


@pytest.mark.parametrize("model_type", FULL_SIZE)
def test_full_size_models_match_jax_variables(model_type):
    """Each ported row at full size: JAX's variables (`jax.eval_shape`,
    as zero-stride stand-ins) map through torch_state_from_jax onto the
    port's model (built on the meta device) key for key and shape for
    shape, so the parameter counts are equal (BEiT-L/16-512:
    342,807,233)."""
    jcfg, tcfg = _configs_for(model_type)
    jmodel = jfactory.build_sml_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64, 1)))
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
