"""The port's fused three-stage path (riders_tpu_torch.pipelines.fused)
against riders_tpu.pipelines.fused on the CPU, on the same weights (the
JAX models' random variables, loaded through models.from_jax) and the
same batch.

Tolerance rtol 1e-3: the golden-section `fc < fd` branch and the bicubic
tap sums run on objective values that differ at f32 noise between the two
frameworks.  Radar pixels are distinct, since a scatter with duplicate
indices has no defined winner in either framework."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.pipelines.fused import make_fused_fn as jax_make_fused_fn
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.models.from_jax import rcnet_from_jax, sml_from_jax
from riders_tpu_torch.pipelines.fused import make_fused_fn
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS, perturbed

BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)
# (preset, frame, patch): the presets' thresholds and alignment at small
# frames; patches keep roughly the ZJU (2.4:1) and NTU (3:1) aspect with
# both sides >= 32 (the latent is patch // 32) and not multiples of 32
CASES = {"zju": ("zju_config", (96, 128), (76, 34)),
         "ntu": ("ntu_config", (80, 96), (99, 33))}


def _configs(case):
    preset, frame, patch = CASES[case]
    out = []
    for mod in (jconfig, tconfig):
        cfg = getattr(mod, preset)()
        out.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=frame,
                                        max_points=8),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=patch,
                                      **NARROW_RCNET)))
    return out


def _batch(rng, frame, B=2, K=8, n_real=6):
    H, W = frame
    depth = (5.0 + 40.0 * rng.random((B, H, W))).astype(np.float32)
    pts = np.zeros((B, K, 3), np.float32)
    mask = np.zeros((B, K), np.float32)
    for b in range(B):
        flat = rng.choice(H * W, n_real, replace=False)   # distinct pixels
        v, u = np.divmod(flat, W)
        pts[b, :n_real] = np.stack([u, v, depth[b, v, u]], axis=1)
        mask[b, :n_real] = 1.0
    return {"image": rng.random((B, H, W, 3)).astype(np.float32),
            "mono_pred": ((1.0 / depth) / 0.05).astype(np.float32),
            "radar_points": pts, "point_mask": mask}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_jax(rng, case):
    jcfg, tcfg = _configs(case)
    H, W = jcfg.dataset.image_shape
    ph, pw = jcfg.rcnet.patch_size
    rcnet = JaxRCNet(config=jcfg.rcnet)
    sml = JaxSML(config=jcfg.sml, **BACKBONE)
    tiny_img = jnp.zeros((1, 32 + ph, 32 + pw, 3))
    rc_vars = perturbed(jax.jit(rcnet.init)(
        jax.random.PRNGKey(0), tiny_img,
        jnp.asarray([[[pw / 2, ph / 2, 10.0]]], jnp.float32),
        jnp.asarray([[[0.0, 0.0, float(pw), float(ph)]]], jnp.float32),
        jnp.ones((1, 1))), rng)
    h, w = jcfg.sml.net_shape
    sml_vars = perturbed(jax.jit(sml.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3)),
        jnp.ones((1, h, w, 1))), rng)
    ref_fn = jax_make_fused_fn(jcfg, rcnet, sml)

    fn = make_fused_fn(
        tcfg, rcnet_from_jax(tcfg.rcnet, rc_vars, device="cpu"),
        sml_from_jax(tcfg.sml, sml_vars, device="cpu", **BACKBONE),
        device="cpu")

    batch = _batch(rng, (H, W))
    compact = dict(batch,
                   image=(batch["image"] * 255).round().astype(np.uint8),
                   mono_pred=(batch["mono_pred"] * 256).astype(np.uint16))
    for inputs in (batch, compact):
        ref = np.asarray(ref_fn(rc_vars, sml_vars,
                                {k: jnp.asarray(v)
                                 for k, v in inputs.items()}))
        got = fn({k: torch.from_numpy(v) for k, v in inputs.items()})
        assert isinstance(got, torch.Tensor) and got.shape == (2, H, W)
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
