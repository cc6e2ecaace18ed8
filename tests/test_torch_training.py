"""The port's RC-Net and SML training steps against the JAX package's on
the CPU, from the same variables (the JAX model's own, BatchNorm
statistics moved away from 0 / 1) and the same numpy batch: RC-Net in
f32; SML in f32 for the loss and statistics and with both networks in
f64 for the gradients and parameters (`test_sml_step_matches_jax` says
why).

The JAX step is the package's own `make_*_train_step`, run once with an
optimizer that stores the gradients in its state and leaves the
parameters alone, which gives its gradients exactly, and once more with
Adam.  Held: the loss and aux to rtol 1e-4; every gradient by key to
rtol 1e-4 with atol 1e-4 of the tensor's max abs; the BatchNorm running
statistics after the step to rtol 1e-4 (flax takes the variance as
E[x^2] - E[x]^2, so f32 cancellation sets that bar); the parameters
after two Adam steps to rtol 1e-4, except where the gradient is too
small for its sign to be fixed (`_check_params_after_adam`); the second
step crosses a schedule boundary for SML.  Then the schedules, a
checkpoint round trip and the RC-Net summary."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.models.rcnet import RCNet as JaxRCNet
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.pipelines import rcnet_training as jrt
from riders_tpu.pipelines import sml_training as jst
from riders_tpu.pipelines.sml_inference import (
    prepare_sml_inputs as jax_prepare)
from riders_tpu_torch.core import checkpoint
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.models.from_jax import (rcnet_from_jax, sml_from_jax,
                                              torch_state_from_jax)
from riders_tpu_torch.pipelines import rcnet_training as trt
from riders_tpu_torch.pipelines import sml_training as tst
from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs
from torch_common import (NARROW_RCNET, TINY_STAGES, TINY_TAPS, perturbed,
                          rcnet_inputs)

RTOL = 1e-4
PATCH = (64, 32)
FRAME = (40, 56)
NET = (64, 96)
BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)
# SML's preset schedule (10, 80) epochs: at 0.1 steps per epoch its
# boundary falls on step 1, so the second step runs at the second rate.
STEPS_PER_EPOCH = 0.1


def _configs():
    """NTU presets of both packages cut to the test's widths and sizes."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.ntu_config()
        out.append(cfg.replace(
            dataset=dataclasses.replace(cfg.dataset, image_shape=FRAME),
            sml=dataclasses.replace(cfg.sml, net_shape=NET, features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=PATCH,
                                      **NARROW_RCNET)))
    return out


def _grad_stash():
    """An optax transformation whose state becomes the gradients and whose
    updates are zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_state(variables, tx):
    return jst.TrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))


def _check_aux(port_aux, jax_aux):
    assert set(port_aux) == set(jax_aux)
    for k in port_aux:
        np.testing.assert_allclose(float(port_aux[k]), float(jax_aux[k]),
                                   rtol=RTOL, err_msg=k)


def _torch_keys(params_tree):
    """A tree shaped like flax `params` -> {torch key: array}."""
    return torch_state_from_jax({"params": jax.device_get(params_tree)})


def _check_grads(model, jax_grads):
    """Every gradient by key, at rtol 1e-4 with atol 1e-4 of the tensor's
    max abs.  A tensor whose gradient is 0 up to rounding (the bias of a
    conv that a train-mode BatchNorm follows) is held at atol 1e-10 of the
    largest gradient instead: both sides are noise there."""
    want = _torch_keys(jax_grads)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    largest = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for key, p in got.items():
        w = np.asarray(want[key])
        scale = max(float(np.abs(w).max()), 1e-6 * largest)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=key)


def _check_state(model, variables, collections=("params", "batch_stats")):
    want = torch_state_from_jax({c: jax.device_get(variables[c])
                                 for c in collections})
    got = model.state_dict()
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()),
                                   err_msg=key)


def _check_params_after_adam(model, state, grads, lr_sum):
    """Parameters and BN statistics after Adam steps.  Adam moves an
    element by about lr * sign(g) whatever |g|, so where the first
    step's gradient lies within the gradient check's own tolerance of 0
    (`_check_grads`' atol) its sign, and so its update, is not determined
    by the reference: there the bar is 2 * sum(lr); elsewhere rtol 1e-4
    with atol 1e-4 of the tensor's max abs."""
    _check_state(model, {"batch_stats": state.batch_stats}, ("batch_stats",))
    want = _torch_keys(state.params)
    g = _torch_keys(grads)
    largest = max(float(np.abs(np.asarray(v)).max()) for v in g.values())
    got = model.state_dict()
    for key, w in want.items():
        w, gk = np.asarray(w), np.abs(np.asarray(g[key]))
        free = gk <= RTOL * max(gk.max(), 1e-6 * largest)
        diff = np.abs(got[key].numpy() - w)
        limit = np.where(free, 2 * lr_sum,
                         RTOL * np.abs(w) + RTOL * np.abs(w).max())
        assert (diff <= limit).all(), (key, float(diff.max()),
                                       int((diff > limit).sum()))


def _rcnet_batch(rng):
    """Padded frames, K=3 points (the last one masked) with their boxes
    and GT crops of a depth field near each point's depth, with holes."""
    image, pts, boxes, mask = rcnet_inputs(rng, PATCH, B=2, K=3,
                                           H=FRAME[0], W=FRAME[1])
    gt = (pts[..., 2][:, :, None, None, None]
          + rng.normal(0.0, 0.6, (2, 3) + PATCH + (1,))).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = 0.0
    return dict(image=image, points=pts, boxes=boxes, gt_crops=gt,
                point_mask=mask)


def _sml_batch(rng, B=2):
    H, W = FRAME
    depth = (5.0 + 40.0 * rng.random((B, H, W))).astype(np.float32)
    radar = np.zeros((B, H, W), np.float32)
    gt_sparse = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for target, n in ((radar, 30), (gt_sparse, 200)):
            idx = rng.integers(0, H * W, n)
            target[b].reshape(-1)[idx] = depth[b].reshape(-1)[idx]
    gt_interp = depth * (rng.random((B, H, W)) > 0.2)
    rcnet = depth * (rng.random((B, H, W)) > 0.7)
    return dict(image=rng.random((B, H, W, 3)).astype(np.float32),
                mono_pred=((1.0 / depth) / 0.05).astype(np.float32),
                radar=radar, gt_interp=gt_interp.astype(np.float32),
                gt_sparse=gt_sparse, rcnet=rcnet.astype(np.float32))


@pytest.fixture(scope="module")
def rcnet_setup():
    rng = np.random.default_rng(10)
    jcfg, tcfg = _configs()
    model = JaxRCNet(config=jcfg.rcnet)
    batch = _rcnet_batch(rng)
    args = [jnp.asarray(batch[k])
            for k in ("image", "points", "boxes", "point_mask")]
    variables = perturbed(jax.jit(model.init)(jax.random.PRNGKey(0), *args),
                          rng)
    return jcfg, tcfg, model, variables, batch


@pytest.fixture(scope="module")
def sml_setup():
    rng = np.random.default_rng(11)
    jcfg, tcfg = _configs()
    model = JaxSML(config=jcfg.sml, **BACKBONE)
    x = jnp.zeros((1,) + NET + (3,))
    variables = perturbed(jax.jit(model.init)(
        jax.random.PRNGKey(1), x, jnp.ones((1,) + NET + (1,))), rng)
    # A small head keeps scales = relu(1 + out) near 1, so the prediction
    # stays inside its clamps.  Clamped pixels would make the depth map
    # flat, where the Sobel terms' |.| sees only rounding noise whose sign
    # (and so the gradient) depends on the order of the sums.
    head = variables["params"]["output_conv"]["conv3"]
    head["kernel"] = (0.02 * head["kernel"]).astype(np.float32)
    head["bias"] = (0.1 * head["bias"]).astype(np.float32)
    return jcfg, tcfg, model, variables, _sml_batch(rng)


def _jax_steps(jax_step, tx_of, variables, batch, adam_steps=True):
    """The JAX aux, gradients and BN statistics of one step (through the
    stashing optimizer), and the JAX state after two steps with the real
    optimizer `tx_of()` (None without `adam_steps`)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    stash = _grad_stash()
    new, aux = jax.jit(jax_step(stash))(_jax_state(variables, stash),
                                        jbatch)
    if not adam_steps:
        return aux, new.opt_state, new.batch_stats, None
    adam = tx_of()
    step2 = jax.jit(jax_step(adam))
    two = _jax_state(variables, adam)
    for _ in range(2):
        two, _ = step2(two, jbatch)
    return aux, new.opt_state, new.batch_stats, two


def test_rcnet_step_matches_jax(rcnet_setup):
    """Loss, aux, every gradient, the BN statistics after the step (the
    masked slot's patch included in them) and the parameters after two
    Adam steps."""
    jcfg, tcfg, model, variables, batch = rcnet_setup
    aux, grads, stats, two = _jax_steps(
        lambda tx: jrt.make_rcnet_train_step(jcfg, model, tx),
        lambda: optax.adam(jrt.make_rcnet_lr_schedule(jcfg,
                                                      STEPS_PER_EPOCH)),
        variables, batch)
    port = rcnet_from_jax(tcfg.rcnet, variables, device="cpu")
    state = trt.init_rcnet_train_state(tcfg, port, STEPS_PER_EPOCH)
    step = trt.make_rcnet_train_step(tcfg)
    state, port_aux = step(state, batch)
    _check_aux(port_aux, aux)
    _check_grads(port, grads)
    _check_state(port, {"batch_stats": stats}, ("batch_stats",))
    state, _ = step(state, batch)
    assert state.step == 2
    _check_params_after_adam(port, two, grads, 2 * 2e-4)


def test_sml_step_matches_jax(sml_setup):
    """In f32: the loss and its terms, and the BN statistics after the
    step.  With both networks in f64 (their variables and activations;
    stage 1 and the loss stay f32, where both packages cast): every
    gradient, the BN statistics, and the parameters after two Adam steps.

    In f32 the gradients of this ReLU network agree only to percents of
    a tensor's max abs: ReLU masks flip on f32 rounding, and the
    zero-mean cotangents that train-mode BatchNorm passes back sum to a
    small fraction of their terms, so each flip shows.  Each package's
    f32 gradients differ from its own f64 ones by as much; in f64 the
    packages agree to ~5e-7."""
    jcfg, tcfg, model, variables, batch = sml_setup
    step = tst.make_train_step(tcfg)
    aux, _, stats, _ = _jax_steps(
        lambda tx: jst.make_train_step(jcfg, model, tx), None, variables,
        batch, adam_steps=False)
    port = sml_from_jax(tcfg.sml, variables, device="cpu", **BACKBONE)
    state, port_info = step(tst.init_train_state(tcfg, port,
                                                 STEPS_PER_EPOCH), batch)
    _check_aux(port_info, aux)
    _check_state(port, {"batch_stats": stats}, ("batch_stats",))

    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax.enable_x64(True):
        model64 = JaxSML(config=jcfg.sml, dtype=jnp.float64, **BACKBONE)
        aux, grads, stats, two = _jax_steps(
            lambda tx: jst.make_train_step(jcfg, model64, tx),
            lambda: jst.make_optimizer(jcfg, STEPS_PER_EPOCH), v64, batch)
        port = sml_from_jax(tcfg.sml, v64, device="cpu",
                            dtype=torch.float64, **BACKBONE)
        state = tst.init_train_state(tcfg, port, STEPS_PER_EPOCH)
        state, port_info = step(state, batch)
        _check_aux(port_info, aux)
        _check_grads(port, grads)
        _check_state(port, {"batch_stats": stats}, ("batch_stats",))
        state, _ = step(state, batch)
        assert state.step == 2
        _check_params_after_adam(port, two, grads, 5e-5 + 2e-5)


@pytest.mark.parametrize("source",
                         ["rcnet_0.4", "none", "interp", "interp-exact"])
def test_stage1_inputs_match_jax(sml_setup, source):
    """The SML step's stage 1 for every scale-map source: the
    quasi-dense RC-Net depth, the raw radar knots alone ('none'), and
    the knots densified by IDW ('interp') or griddata ('interp-exact')."""
    jcfg, tcfg, _, _, batch = sml_setup
    jcfg, tcfg = (c.replace(sml_train=dataclasses.replace(
        c.sml_train, rcnet_interp=source)) for c in (jcfg, tcfg))
    keys = ["image", "mono_pred", "radar"] + (["rcnet"] if source != "none"
                                              else [])
    want = jax.jit(jax.vmap(lambda *a: jax_prepare(jcfg, *a)))(
        *[jnp.asarray(batch[k]) for k in keys])
    got = prepare_sml_inputs(tcfg, *[torch.from_numpy(batch[k])
                                     for k in keys])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["rcnet", "sml"])
def test_lr_schedules_match_optax(kind):
    """Piecewise-constant rates with multiplicative boundaries at
    int(bound * steps_per_epoch), around every boundary."""
    jcfg, tcfg = _configs()
    rates, bounds = (0.3, 0.1, 0.02), (2, 5, 9)
    if kind == "rcnet":
        jcfg = jcfg.replace(rcnet_train=dataclasses.replace(
            jcfg.rcnet_train, learning_rates=rates, learning_schedule=bounds))
        tcfg = tcfg.replace(rcnet_train=dataclasses.replace(
            tcfg.rcnet_train, learning_rates=rates, learning_schedule=bounds))
        want = jrt.make_rcnet_lr_schedule(jcfg, 3)
        got = trt.make_rcnet_lr_schedule(tcfg, 3)
    else:
        want = jst.make_lr_schedule(jcfg, 7)
        got = tst.make_lr_schedule(tcfg, 7)
    for s in range(0, 80):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   err_msg=str(s))
    # the optimizer runs update t at schedule(t)
    model = torch.nn.Linear(2, 1)
    state = tst.adam_state(model, got)
    for s in range(12):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
            got(s), rel=1e-12)
        tst.apply_update(state, model(torch.ones(1, 2)).sum())


def test_adamw_when_weight_decay_is_set():
    _, tcfg = _configs()
    tcfg = tcfg.replace(sml_train=dataclasses.replace(
        tcfg.sml_train, w_weight_decay=0.01))
    state = tst.init_train_state(tcfg, torch.nn.Linear(2, 1), 10)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert state.optimizer.param_groups[0]["weight_decay"] == 0.01


def test_checkpoint_round_trip(sml_setup, tmp_path):
    """Model, BN statistics, optimizer, scheduler and step survive
    save / restore into a fresh template; the restored state's next step
    equals the original's bitwise.  Also latest_step, max_to_keep and
    weights-only save / restore."""
    _, tcfg, _, variables, batch = sml_setup

    def fresh():
        port = sml_from_jax(tcfg.sml, variables, device="cpu", **BACKBONE)
        return tst.init_train_state(tcfg, port, STEPS_PER_EPOCH)

    step = tst.make_train_step(tcfg)
    state, _ = step(fresh(), batch)
    assert checkpoint.latest_step(tmp_path) is None
    checkpoint.save_train_state(tmp_path, state)
    restored = checkpoint.restore_train_state(tmp_path, fresh())
    assert restored.step == 1
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k
    assert (restored.scheduler.state_dict()["last_epoch"]
            == state.scheduler.state_dict()["last_epoch"])
    state, info = step(state, batch)
    restored, info2 = step(restored, batch)
    assert torch.equal(info["loss"], info2["loss"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k

    for _ in range(2):
        state, _ = step(state, batch)
        checkpoint.save_train_state(tmp_path, state, max_to_keep=2)
    assert checkpoint.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4"]
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(tmp_path / "none", fresh())

    checkpoint.save_params(tmp_path / "w.pt", state.model)
    model = checkpoint.restore_params(tmp_path / "w.pt", fresh().model)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    torch.save({"model": state.model.state_dict()}, tmp_path / "n.pt")
    checkpoint.restore_params(tmp_path / "n.pt", fresh().model)


def test_rcnet_summary(rcnet_setup):
    """The summary's panels on the first valid slots, and the model back
    in train mode after its eval forward."""
    _, tcfg, _, variables, batch = rcnet_setup
    port = rcnet_from_jax(tcfg.rcnet, variables, device="cpu")
    state = trt.init_rcnet_train_state(tcfg, port, STEPS_PER_EPOCH)
    out = trt.make_rcnet_summary_fn(tcfg, n_display=3)(state, batch)
    assert port.training
    assert out["image_patch"].shape == (3,) + PATCH + (3,)
    for k in ("response", "output_label", "label", "label_error",
              "validity", "gt_depth"):
        assert out[k].shape == (3,) + PATCH, k
        assert bool(torch.isfinite(out[k]).all()), k
    # slots 0, 1 of frame 0 then slot 0 of frame 1 (slot 2 is masked)
    np.testing.assert_allclose(out["gt_depth"].numpy() * 100.0,
                               batch["gt_crops"][[0, 0, 1], [0, 1, 0],
                                                 ..., 0], rtol=1e-6)
