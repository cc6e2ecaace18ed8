"""The port's training drivers (pipelines.drivers.train_sml /
train_rcnet) and RCNetTrainDataset against the JAX package's, on the
synthetic mini-dataset of tests/test_drivers.py with its mini
configuration (narrow RC-Net widths and a tiny SML backbone here).

* RCNetTrainDataset: samples byte-identical to JAX's at several (seed,
  epoch, index), with pseudo-radar on every sample, both flip types and
  gaussian / uniform point noise; where JAX's loader raises (a flipped
  pseudo-radar point at x = -1, whose crop it slices empty), the port
  returns the sample with that crop zero-bordered.
* train_sml: JAX's PRNGKey(0) initial SML state, converted and saved as
  the port's step-0 checkpoint, then two steps of each package's driver
  on the same batches (the loaders' streams are byte-identical).  The
  port's driver is bitwise its step function on those batches.  Each
  step's loss is held to rtol 1e-4 (step 1) and 1e-3 (step 2, after one
  Adam update), or to 3x the loss's own f32 spread on these frames,
  where that is larger: the largest relative change of the port's loss
  when a random half of the mono prior's pixels moves by one ulp (two
  draws).  Stage 1's golden-section alignment turns such a nudge into a
  scale a few ulps away, and at flax's initial weights the SML loss
  moves by ~2e-4 with it; JAX's own step loss moves by 2e-5 to 2e-4
  under the same nudges.  The packages measure ~2e-4 apart.
* train_rcnet: the files JAX's driver writes at a checkpoint step
  (summaries/step2.png, precision / recall scalars, histograms, the
  checkpoint), as tests/test_drivers.py checks of JAX's.
* The loop: a resumed run advances from step 2 to 4, and a dataset with
  no full batch raises.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from riders_tpu.core import config as jconfig
from riders_tpu.io.input_pipeline import RCNetTrainDataset as JaxRCNetData
from riders_tpu.io.manifest import build_manifest as jax_manifest
from riders_tpu.models.sml import ScaleMapLearner as JaxSML
from riders_tpu.pipelines import drivers as jdrivers
from riders_tpu.pipelines import sml_training as jsml_train
from riders_tpu_torch.core import checkpoint as tckpt
from riders_tpu_torch.core import config as tconfig
from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.input_pipeline import (BatchLoader,
                                                RCNetTrainDataset,
                                                SMLFrameDataset)
from riders_tpu_torch.io.manifest import build_manifest
from riders_tpu_torch.models.from_jax import sml_from_jax
from riders_tpu_torch.pipelines import drivers as tdrivers
from riders_tpu_torch.pipelines.sml_training import (init_train_state,
                                                     make_train_step)
from test_drivers import make_mini_dataset
from torch_common import NARROW_RCNET, TINY_STAGES, TINY_TAPS

BACKBONE = dict(backbone_stages=TINY_STAGES, backbone_taps=TINY_TAPS,
                backbone_stem=8)


def mini_configs(root):
    """tests/test_drivers.py's mini configuration in each package, with
    the tiny SML width and narrow RC-Net."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.zju_config(root=root)
        out.append(cfg.replace(
            dataset=dataclasses.replace(
                cfg.dataset, image_shape=(96, 128), max_points=16,
                train_scenes=("scene-a",), val_scenes=("scene-b",)),
            sml=dataclasses.replace(cfg.sml, net_shape=(64, 96),
                                    features=8),
            rcnet=dataclasses.replace(cfg.rcnet, patch_size=(48, 32),
                                      **NARROW_RCNET),
            sml_train=dataclasses.replace(
                cfg.sml_train, batch_size=2, n_step_per_checkpoint=2,
                n_step_per_summary=1, learning_schedule=(1, 2)),
            rcnet_train=dataclasses.replace(
                cfg.rcnet_train, batch_size=1, points_per_frame=4,
                n_step_per_checkpoint=2, n_step_per_summary=1,
                learning_schedule=(1,)),
            compute_dtype="float32"))
    return out


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    """The mini dataset, its mono priors given 10% multiplicative noise.
    make_mini_dataset writes the exact inverse depth, so every radar
    knot's observed / prior ratio is the same number up to the PNG
    codec, and the unit-range normalisation of the scale map divides
    ulp-level differences of the two packages' alignments by that
    near-zero spread (a 5e-3 gap in the scales channel and 1% in the
    loss on these frames; with JAX's own stage-1 inputs the port's step
    loss is within 2e-5 of JAX's)."""
    root = str(tmp_path_factory.mktemp("mini_train"))
    make_mini_dataset(root, ["scene-a", "scene-b"])
    rng = np.random.default_rng(5)
    for scene in ("scene-a", "scene-b"):
        d = os.path.join(root, scene, "any")
        for name in sorted(os.listdir(d)):
            prior = depthio.load_depth(os.path.join(d, name))
            depthio.save_depth(prior * (0.9 + 0.2 * rng.random(
                prior.shape)).astype(np.float32), os.path.join(d, name))
    return root


@pytest.fixture
def tiny_sml(monkeypatch):
    """Both packages' drivers build the tiny-backbone SML."""
    monkeypatch.setattr(jdrivers, "build_sml_model",
                        lambda cfg, dtype=jnp.float32: JaxSML(
                            config=cfg.sml, dtype=dtype, **BACKBONE))
    monkeypatch.setattr(tdrivers, "build_sml_model",
                        lambda cfg, device, dtype: tdrivers.ScaleMapLearner(
                            cfg.sml, device, dtype, **BACKBONE))


def _scalars(ckpt_dir):
    with open(os.path.join(ckpt_dir, "scalars-train.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return ([r for r in lines if "histograms" not in r],
            [r["histograms"] for r in lines if "histograms" in r])


@pytest.mark.parametrize("flip,noise,seed", [
    (("horizontal",), "gaussian", 0),
    (("vertical",), "uniform", 1),
    (("horizontal", "vertical"), "gaussian", 7),
    (("horizontal",), "none", 3)])
def test_rcnet_train_dataset_is_jax_bytes(mini_root, flip, noise, seed):
    jcfg, tcfg = mini_configs(mini_root)
    lidar = 1.0 if noise != "none" else 0.1
    jcfg, tcfg = (c.replace(rcnet_train=dataclasses.replace(
        c.rcnet_train, sample_probability_of_lidar=lidar,
        random_flip_type=flip, random_noise_type=noise,
        random_noise_spread=2.0)) for c in (jcfg, tcfg))
    ours = RCNetTrainDataset(
        tcfg, build_manifest(tcfg.dataset, ("scene-a", "scene-b")), seed)
    ref = JaxRCNetData(
        jcfg, jax_manifest(jcfg.dataset, ("scene-a", "scene-b")), seed)
    assert len(ours) == len(ref) == 6
    noised = repaired = 0
    for epoch in (0, 1, 5):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in range(len(ours)):
            got = ours[index]
            noised += not np.array_equal(
                got["boxes"][:, :2] + [16, 24], got["points"][:, :2])
            try:
                want = ref[index]
            except ValueError:
                # JAX's loader cannot crop a flipped pseudo-radar point
                # at x = -1; the port crops it with a zero border
                assert (got["boxes"][:, 0] == -1).any()
                repaired += 1
                continue
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), (epoch, index,
                                                               k)
    # these draws put a flipped pseudo-radar point at x = -1 once (seed
    # 0) and three times (seed 7)
    assert repaired == {0: 1, 7: 3}.get(seed, 0)
    assert got["image"].shape == (96 + 48, 128 + 32, 3)
    assert got["gt_crops"].shape == (4, 48, 32, 1)
    assert (noised > 0) == (noise != "none")


def _nudged(batch, seed):
    """The batch with a random half of the mono prior's pixels moved up
    by one f32 ulp."""
    prior = batch["mono_pred"]
    pick = np.random.default_rng(seed).random(prior.shape) < 0.5
    return dict(batch, mono_pred=np.where(
        pick, np.nextafter(prior, np.float32(np.inf)), prior))


def test_train_sml_matches_jax(mini_root, tiny_sml, tmp_path):
    jcfg, tcfg = mini_configs(mini_root)
    dirs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    # the JAX driver's own initial state, as the port's step 0
    jstate, _ = jsml_train.init_train_state(
        jcfg, jdrivers.build_sml_model(jcfg), jax.random.PRNGKey(0), 1)
    variables = jax.device_get({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})

    def initial_state():
        return init_train_state(tcfg, sml_from_jax(
            tcfg.sml, variables, device="cpu", **BACKBONE), 1)

    tckpt.save_train_state(dirs["torch"], initial_state())
    assert tckpt.all_steps(dirs["torch"]) == [0]
    logs = {k: str(tmp_path / f"{k}.log") for k in dirs}
    jdrivers.train_sml(jcfg, dirs["jax"], max_steps=2, log_path=logs["jax"])
    tdrivers.train_sml(tcfg, dirs["torch"], resume=True, max_steps=2,
                       log_path=logs["torch"], device="cpu")
    params = {}
    for k, path in logs.items():
        with open(path) as f:
            params[k] = [line for line in f
                         if line.split("=")[0] in dataclasses.asdict(tcfg)]
    assert params["torch"] == params["jax"] and len(params["jax"]) == 9
    want, _ = _scalars(dirs["jax"])
    got, _ = _scalars(dirs["torch"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    assert set(got[0]) == set(want[0])
    assert tckpt.all_steps(dirs["torch"]) == [0, 2]

    # the same two steps outside the driver, on the loader's batches:
    # bitwise the driver's; then with the prior nudged by one ulp, the
    # f32 spread of the loss on these frames
    records = build_manifest(tcfg.dataset, tcfg.dataset.train_scenes,
                             rcnet_interp="rcnet_0.1")
    loader = BatchLoader(SMLFrameDataset(tcfg, records, train=True), 2,
                         device="cpu", device_put=False)
    batches = [list(loader.epoch())[0] for _ in range(2)]

    def losses(nudge=None):
        state, step, out = initial_state(), make_train_step(tcfg), []
        for b in batches:
            state, info = step(state, b if nudge is None
                               else _nudged(b, nudge))
            out.append(float(info["loss"]))
        return out

    direct = losses()
    assert direct == [r["loss"] for r in got]
    spread = np.max([np.abs(np.subtract(losses(s), direct)) / direct
                     for s in (1, 2)], axis=0)
    err = [abs(g["loss"] - w["loss"]) / w["loss"] for g, w in zip(got, want)]
    print(f"train_sml loss rel. error vs JAX {err}, f32 spread {spread}")
    assert err[0] <= max(1e-4, 3 * spread[0])
    assert err[1] <= max(1e-3, 3 * spread[1])


def test_train_rcnet_writes_summaries(mini_root, tmp_path, capsys):
    _, tcfg = mini_configs(mini_root)
    ckpt_dir = str(tmp_path / "rc_ckpt")
    log = str(tmp_path / "train.log")
    tdrivers.train_rcnet(tcfg, ckpt_dir, max_steps=2, log_path=log,
                         device="cpu")
    assert os.path.exists(os.path.join(ckpt_dir, "summaries",
                                       "step2.png"))
    scalars, hists = _scalars(ckpt_dir)
    assert [r["step"] for r in scalars] == [1, 2, 2]
    assert "precision" in scalars[-1] and "recall" in scalars[-1]
    assert "n_predicted_label_per_point" in scalars[-1]
    assert all(np.isfinite(r["loss"]) for r in scalars)
    assert hists and set(hists[-1]) == {"step", "response", "output_label",
                                        "label", "gt_depth"}
    assert 0.0 <= hists[-1]["response"]["median"] <= 1.0
    assert tckpt.all_steps(ckpt_dir) == [2]
    with open(log) as f:
        text = f.read()
    assert "Training RC-Net: 3 samples, 3 steps/epoch, 1 epochs" in text
    assert "Loss=" in text and " P=" in text
    assert "Training RC-Net" in capsys.readouterr().out


def test_train_sml_resumes_from_its_checkpoint(mini_root, tiny_sml,
                                               tmp_path):
    _, tcfg = mini_configs(mini_root)
    # 4 epochs x 1 step each, so the resumed run has room to advance
    tcfg = tcfg.replace(sml_train=dataclasses.replace(
        tcfg.sml_train, learning_schedule=(1, 4)))
    ckpt_dir = str(tmp_path / "resume_ckpt")
    tdrivers.train_sml(tcfg, ckpt_dir, max_steps=2, device="cpu")
    assert tckpt.latest_step(ckpt_dir) == 2
    tdrivers.train_sml(tcfg, ckpt_dir, resume=True, max_steps=4,
                       device="cpu")
    assert tckpt.all_steps(ckpt_dir) == [2, 4]
    scalars, _ = _scalars(ckpt_dir)
    assert [r["step"] for r in scalars] == [1, 2, 3, 4]


@pytest.mark.parametrize("trainer", ["sml", "rcnet"])
def test_trainers_refuse_a_dataset_without_a_full_batch(mini_root, tmp_path,
                                                        trainer):
    _, tcfg = mini_configs(mini_root)
    sub = f"{trainer}_train"
    tcfg = tcfg.replace(**{sub: dataclasses.replace(getattr(tcfg, sub),
                                                    batch_size=4)})
    with pytest.raises(ValueError, match="no full batch"):
        getattr(tdrivers, f"train_{trainer}")(tcfg, str(tmp_path),
                                              device="cpu")
