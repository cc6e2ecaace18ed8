"""The port's staged inference against the JAX package on the CPU: the
threshold-decay retry (ops.patches.adaptive_compose), staged RC-Net
(make_rcnet_infer_fn) and staged SML (make_infer_fn) on the same
converted weights, the depth metrics and their vote, and the stage-1
solvers (scale_shift_ls, alignment mode 'st', RANSAC on JAX's own Gumbel
draws).

Tolerances: the retry's response maps and final thresholds are bitwise;
its depth is held at rtol 1e-6, the one-ulp deviation of the
composition sums (ROADMAP C: XLA fuses them into FMAs).  Staged RC-Net:
threshold bitwise, response and depth rtol 1e-4 (the converter tests'
bar), depth outside the pixels whose max response lies within 1e-5 of
the final threshold, which may compose on one side in one package and
on the other in the other; the test counts them.  Staged SML: rtol 1e-3, the bar of
test_torch_fused.py.  Metrics: rtol 1e-5 (the two frameworks sum the
masked means in different orders)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.core import metrics as jmetrics
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.ops import alignment as jalign
from riders_tpu.ops import patches as jpatches
from riders_tpu.pipelines import rcnet_inference as jrc_inf
from riders_tpu.pipelines import sml_inference as jsml_inf
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.core import metrics as tmetrics
from riders_tpu_torch.models.from_jax import rcnet_from_jax, sml_from_jax
from riders_tpu_torch.ops import alignment as talign
from riders_tpu_torch.ops import patches as tpatches
from riders_tpu_torch.pipelines.rcnet_inference import (
    make_rcnet_infer_fn, pad_image_for_patches)
from riders_tpu_torch.pipelines.sml_inference import make_infer_fn
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS, perturbed

THR0, DECAY, RETRIES = 0.4, 0.05, 8
FRAME, PATCH, K = (24, 32), (8, 6), 5


def jax_thresholds(thr0=THR0, decay=DECAY, n=RETRIES + 2):
    """JAX's f32 threshold sequence: f32(thr0), f32(thr0 - decay) in
    doubles, then minus f32(decay) in f32."""
    seq = [np.float32(thr0), np.float32(thr0 - decay)]
    while len(seq) < n:
        seq.append(np.float32(seq[-1] - np.float32(decay)))
    return seq


def retry_inputs(rng, tops, masked=False, thr0=THR0):
    """(B, K, ph, pw) responses whose masked maximum of frame b is
    tops[b] (a value, or the index of the threshold of the sequence to
    sit on exactly), points in padded coordinates, and the point mask
    (the last point masked, or every point with `masked`)."""
    B = len(tops)
    (H, W), (ph, pw) = FRAME, PATCH
    seq = jax_thresholds(thr0)
    resp = rng.random((B, K, ph, pw)).astype(np.float32)
    u = rng.integers(0, W, (B, K)) + pw // 2
    v = rng.integers(0, H, (B, K)) + ph // 2
    z = 1 + 40 * rng.random((B, K))
    pts = np.stack([u, v, z], -1).astype(np.float32)
    mask = np.ones((B, K), np.float32)
    mask[:, -1] = 0.0
    if masked:
        mask[:] = 0.0
    for b, top in enumerate(tops):
        top = seq[top] if isinstance(top, int) else np.float32(top)
        resp[b] *= np.float32(0.9) * top / resp[b].max()
        # the maximum at a pixel of a real point, exactly `top`
        resp[b, 0, ph // 2, pw // 2] = top
    return resp, pts, mask


def run_both(resp, pts, mask, thr0=THR0):
    jfn = jax.jit(jax.vmap(lambda r, p, m: jpatches.adaptive_compose(
        r, p, m, FRAME, PATCH, thr0, DECAY, RETRIES)))
    jd, jr, jt = (np.asarray(a) for a in jfn(resp, pts, mask))
    td, tr, tt, tk = tpatches.adaptive_compose(
        *(torch.from_numpy(a) for a in (resp, pts, mask)), FRAME, PATCH,
        thr0, DECAY, RETRIES)
    return (jd, jr, jt), (td.numpy(), tr.numpy(), tt.numpy(), tk.numpy())


# per case: each frame's masked maximum (a value, or the index of the
# threshold of the sequence it sits on exactly), whether every point is
# masked, the first threshold, and the retries each frame must take
SEQ = jax_thresholds()
RETRY_CASES = {
    "no_retry": ([0.9, 0.7], False, THR0, [0, 0]),
    "three_retries": ([float(SEQ[3]) + 0.01] * 2, False, THR0, [3, 3]),
    "exhausted": ([0.3, 0.45], False, 0.9, [8, 8]),
    "all_masked": ([0.9, 0.9], True, THR0, [8, 8]),
    "mixed": ([0.9, float(SEQ[2]) + 0.01, float(SEQ[5]) + 0.001],
              False, THR0, [0, 2, 5]),
    "on_threshold": ([3, 6], False, THR0, [3, 6]),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_adaptive_compose_matches_jax_loop(rng, case):
    tops, masked, thr0, expect = RETRY_CASES[case]
    resp, pts, mask = retry_inputs(rng, tops, masked, thr0)
    (jd, jr, jt), (td, tr, tt, tk) = run_both(resp, pts, mask, thr0)
    np.testing.assert_array_equal(tk, expect)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    # the threshold returned is the next one of the sequence plus
    # f32(decay), in f32: not always the one the depth was composed at
    seq = jax_thresholds(thr0)
    np.testing.assert_array_equal(
        tt, [np.float32(seq[k + 1] + np.float32(DECAY)) for k in expect])
    composed = [not masked and k < RETRIES for k in expect]
    np.testing.assert_array_equal(
        td.reshape(len(tops), -1).sum(1) > 0, composed)


def test_adaptive_compose_kernel_route_matches_plain(rng):
    """The default route (the kernel wrapper, which runs the plain
    composition on CPU tensors) and an explicit plain `compose` agree
    bit for bit."""
    resp, pts, mask = (torch.from_numpy(a) for a in retry_inputs(
        rng, [0.9, float(SEQ[4]) + 0.001]))
    a = tpatches.adaptive_compose(resp, pts, mask, FRAME, PATCH, THR0,
                                  DECAY, RETRIES)
    b = tpatches.adaptive_compose(resp, pts, mask, FRAME, PATCH, THR0,
                                  DECAY, RETRIES,
                                  compose=tpatches.compose_patches)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[3].tolist() == [0, 4]


# ---- staged RC-Net ---------------------------------------------------------

RC_FRAME, RC_PATCH, RC_B, RC_K = (48, 64), (66, 34), 3, 6


def _rc_configs(threshold, decay=0.004):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config()
        out.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=RC_FRAME,
                                        max_points=RC_K),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=RC_PATCH,
                                      response_threshold=threshold,
                                      threshold_decay=decay,
                                      **NARROW_RCNET),
            compute_dtype="float32"))
    return out


@pytest.fixture(scope="module")
def rc_setup():
    rng = np.random.default_rng(11)
    jcfg, _ = _rc_configs(0.1)
    ph, pw = RC_PATCH
    model = JaxRCNet(config=jcfg.rcnet)
    variables = perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32 + ph, 32 + pw, 3)),
        jnp.asarray([[[pw / 2, ph / 2, 10.0]]], jnp.float32),
        jnp.asarray([[[0.0, 0.0, float(pw), float(ph)]]], jnp.float32),
        jnp.ones((1, 1))), rng)
    H, W = RC_FRAME
    frames = rng.random((RC_B, H, W, 3)).astype(np.float32)
    image = np.stack([pad_image_for_patches(f, RC_PATCH) for f in frames])
    pts = np.zeros((RC_B, RC_K, 3), np.float32)
    mask = np.zeros((RC_B, RC_K), np.float32)
    for b in range(RC_B):
        n = RC_K - b
        flat = rng.choice(H * W, n, replace=False)
        v, u = np.divmod(flat, W)
        pts[b, :n] = np.stack([u, v, 2 + 40 * rng.random(n)], 1)
        mask[b, :n] = 1.0
    batch = {"image": image, "points": pts, "point_mask": mask}
    return model, variables, batch


def _run_rc(rc_setup, threshold):
    model, variables, batch = rc_setup
    jcfg, tcfg = _rc_configs(threshold)
    ref = jax.device_get(jrc_inf.make_rcnet_infer_fn(jcfg, model)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    fn = make_rcnet_infer_fn(
        tcfg, rcnet_from_jax(tcfg.rcnet, variables, device="cpu"),
        device="cpu")
    got = {k: v.numpy() for k, v in fn(
        {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
    return ref, got


def test_rcnet_infer_matches_jax(rc_setup):
    # the frames' maximum responses at threshold 0 (0.559, 0.563 and
    # 0.569 on these random weights) place the real threshold so that
    # the frames, with a decay of 0.004, retry different numbers of times
    ref0, _ = _run_rc(rc_setup, 0.0)
    tops = np.sort(ref0["response"].reshape(RC_B, -1).max(1))
    assert tops[-1] - tops[0] > 0.008, tops
    threshold = float(tops[-1]) + 0.006
    ref, got = _run_rc(rc_setup, threshold)

    np.testing.assert_array_equal(got["threshold"], ref["threshold"])
    assert len(set(got["retries"].tolist())) >= 2, got["retries"]
    np.testing.assert_allclose(got["response"], ref["response"],
                               rtol=1e-4, atol=1e-6)
    thr = ref["threshold"][:, None, None]
    near = np.abs(ref["response"] - thr) < 1e-5
    # the pixels whose max response sits within 1e-5 of the threshold
    assert int(near.sum()) == 0
    np.testing.assert_allclose(np.where(near, 0, got["depth"]),
                               np.where(near, 0, ref["depth"]),
                               rtol=1e-4, atol=1e-4)
    assert (ref["depth"] > 0).any()


# ---- staged SML ------------------------------------------------------------

BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)
SML_FRAME = (60, 80)


def _sml_configs(interp):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.ntu_config()
        out.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=SML_FRAME),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            sml_train=dataclasses.replace(cfg.sml_train,
                                          rcnet_interp=interp)))
    return out


def sml_batch(rng, B=2, frame=SML_FRAME, n_radar=30, n_gt=300):
    H, W = frame
    depth = (5.0 + 40.0 * rng.random((B, H, W))).astype(np.float32)

    def sparse(n):
        out = np.zeros((B, H, W), np.float32)
        for b in range(B):
            flat = rng.choice(H * W, n, replace=False)
            out[b].reshape(-1)[flat] = depth[b].reshape(-1)[flat]
        return out

    return {"image": rng.random((B, H, W, 3)).astype(np.float32),
            "mono_pred": ((1.0 / depth) / 0.05).astype(np.float32),
            "radar": sparse(n_radar), "rcnet": sparse(600),
            "gt_sparse": sparse(n_gt)}


@pytest.mark.parametrize("interp", ["rcnet_0.4", "none"])
def test_sml_infer_matches_jax(rng, interp):
    jcfg, tcfg = _sml_configs(interp)
    model = JaxSML(config=jcfg.sml, **BACKBONE)
    h, w = jcfg.sml.net_shape
    variables = perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, h, w, 3)),
        jnp.ones((1, h, w, 1))), rng)
    batch = sml_batch(rng)
    ref = jax.device_get(jsml_inf.make_infer_fn(jcfg, model)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    fn = make_infer_fn(
        tcfg, sml_from_jax(tcfg.sml, variables, device="cpu", **BACKBONE),
        device="cpu")
    got = fn({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("depth", "int_depth", "scales"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-3,
                                   atol=1e-4, err_msg=key)
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), v,
                                   rtol=1e-3, err_msg=k)
    no_gt = {k: v for k, v in batch.items() if k != "gt_sparse"}
    assert "metrics" not in fn(no_gt)


# ---- metrics ---------------------------------------------------------------

def metric_inputs(rng, shape):
    pred = (1.0 + 80.0 * rng.random(shape)).astype(np.float32)
    gt = (1.0 + 80.0 * rng.random(shape)).astype(np.float32)
    gt[rng.random(shape) < 0.6] = 0.0
    pred[..., :2, :] = gt[..., :2, :]       # exact hits: delta ratio 1
    return pred, gt


@pytest.mark.parametrize("shape", [(20, 30), (3, 20, 30)])
def test_metrics_match_jax(rng, shape):
    pred, gt = metric_inputs(rng, shape)
    got = tmetrics.compute_depth_metrics(torch.from_numpy(pred),
                                         torch.from_numpy(gt), 0.0, 70.0)
    fn = lambda p, g: jmetrics.compute_depth_metrics(p, g, 0.0, 70.0)
    if len(shape) == 3:
        fn = jax.vmap(fn)
    ref = jax.device_get(fn(jnp.asarray(pred), jnp.asarray(gt)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == np.shape(v), k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5, err_msg=k)


def test_metrics_empty_mask_is_zero():
    z = torch.zeros((2, 8, 8))
    m = tmetrics.compute_depth_metrics(torch.ones((2, 8, 8)), z, 0.0, 50.0)
    for k, v in m.items():
        assert torch.equal(v, torch.zeros(2)), k


def test_improves_best_matches_jax(rng):
    keys = tmetrics.METRIC_KEYS
    n_true = 0
    for _ in range(300):
        best = {k: float(rng.random()) for k in keys}
        res = {}
        for k in keys:
            r = rng.random()
            # ties at 4 decimals, small and large moves
            res[k] = (best[k] + (1e-5 if r < 0.3 else 0.0) if r < 0.5
                      else best[k] + rng.normal(0, 0.01))
        assert (tmetrics.improves_best(res, best)
                == jmetrics.improves_best(res, best))
        n_true += tmetrics.improves_best(res, best)
    assert 0 < n_true < 300
    inf = {k: np.inf for k in keys} | {"delta1": 0.0}
    assert tmetrics.improves_best({k: 1.0 for k in keys}, inf)


# ---- stage-1 solvers -------------------------------------------------------

def test_scale_shift_ls_and_mode_st_match_jax(rng):
    B, H, W = 3, 24, 32
    mono = (0.5 + rng.random((B, H, W))).astype(np.float32)
    target = (0.3 * mono + 0.05
              + 0.01 * rng.standard_normal((B, H, W))).astype(np.float32)
    valid = (rng.random((B, H, W)) < 0.1).astype(np.float32)
    valid[2] = 0.0                  # singular normal matrix: (0, 0)
    target *= valid
    s, t = talign.scale_shift_ls(*(torch.from_numpy(a)
                                   for a in (mono, target, valid)))
    js, jt = jax.vmap(jalign.scale_shift_ls)(mono, target, valid)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    # the shift is a difference of sums that cancel: atol 5e-6 of a
    # target range of 0.5 holds the sums' f32 rounding, not more
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                               atol=5e-6)
    assert s[2] == 0 and t[2] == 0

    got = talign.align_mono_prior(*(torch.from_numpy(a)
                                    for a in (mono, target, valid)),
                                  mode="st")
    ref = jax.vmap(lambda m, x, v: jalign.align_mono_prior(
        m, x, v, mode="st"))(mono, target, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        talign.align_mono_prior(*(torch.from_numpy(a)
                                  for a in (mono, target, valid)),
                                mode="x")


@pytest.mark.parametrize("n_valid", [40, 3])
def test_ransac_matches_jax_on_its_draws(rng, n_valid):
    """With fewer valid pixels than the sample size, every hypothesis
    fills its sample with the first invalid pixels (ties at -inf go to
    the lower index in both packages)."""
    H, W = 16, 20
    pred = (0.5 + rng.random((H, W))).astype(np.float32)
    target = 0.4 * pred + 0.1
    flat = rng.choice(H * W, n_valid, replace=False)
    mask = np.zeros(H * W, np.float32)
    mask[flat] = 1.0
    mask = mask.reshape(H, W)
    outliers = rng.random((H, W)) < 0.25
    target = np.where(outliers, target + 0.5 * rng.random((H, W)),
                      target).astype(np.float32)

    key = jax.random.PRNGKey(3)
    js, jt = jalign.scale_shift_ransac(*(jnp.asarray(a) for a in (
        pred, target, mask)), key)
    keys = jax.random.split(key, 60)
    draws = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (H * W,)))(keys))
    s, t = talign.scale_shift_ransac(*(torch.from_numpy(a)
                                       for a in (pred, target, mask)),
                                     gumbel=draws)
    # the same hypothesis wins (the same inlier count).  Its 5-point
    # normal equations are ill-conditioned (the winning sample's
    # predictions span 1.41-1.48), and each package's f32 solve lies
    # ~4e-4 of the scale off the f64 one: held at rtol 1e-3, the fitted
    # lines within 5e-4
    count = lambda a, b: int(((np.abs(pred * a + b - target) < 0.02)
                              * mask).sum())
    assert count(float(s), float(t)) == count(float(js), float(jt))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-3)
    np.testing.assert_allclose(pred * float(s) + float(t),
                               pred * float(js) + float(jt), atol=5e-4)
    if n_valid >= 5:
        assert abs(float(s) - 0.4) < 1e-3 and abs(float(t) - 0.1) < 1e-3

    g = torch.Generator().manual_seed(0)
    s2, t2 = talign.scale_shift_ransac(*(torch.from_numpy(a)
                                         for a in (pred, target, mask)),
                                       generator=g)
    assert np.isfinite([float(s2), float(t2)]).all()
    with pytest.raises(ValueError, match="gumbel"):
        talign.scale_shift_ransac(*(torch.from_numpy(a)
                                    for a in (pred, target, mask)),
                                  gumbel=draws[:5])
