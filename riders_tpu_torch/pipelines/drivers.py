"""Training, inference and validation drivers over the on-disk dataset
layout.

* ``train_sml``      - the stage-3 training loop;
* ``train_rcnet``    - the stage-2 training loop, with visual summaries;
* ``run_rcnet``      - stage-2 generation: quasi-dense depth PNGs;
* ``validate_rcnet`` - stage-2 checkpoint sweep against the interpolated
                       lidar GT, with its best-results vote;
* ``validate_sml``   - stage-3 checkpoint sweep with the seven metrics
                       and the best-results vote;
* ``evaluate_results_dir`` - scores any directory of predicted depth PNGs.

They read and write the 16-bit PNG trees of the JAX package's drivers
(x256 codec, the same directory names), so a tree written by either
package is read by the other.  Checkpoints are the port's
`<dir>/<step>/state.pt` (`core/checkpoint.py`); a training run starts
from `models.layers.init_training_` weights (seed 0) unless it resumes.
Each driver runs on `device`: the card unless device='cpu'.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from riders_tpu_torch.core import checkpoint as ckpt_lib
from riders_tpu_torch.core import logging as log_lib
from riders_tpu_torch.core import metrics as metrics_lib
from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.io import depthio
from riders_tpu_torch.io.input_pipeline import (BatchLoader,
                                                RCNetInferenceDataset,
                                                RCNetTrainDataset,
                                                SMLFrameDataset)
from riders_tpu_torch.io.manifest import build_manifest
from riders_tpu_torch.models.factory import build_sml_model
from riders_tpu_torch.models.layers import init_training_
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.pipelines import rcnet_training, sml_training
from riders_tpu_torch.pipelines.rcnet_inference import make_rcnet_infer_fn
from riders_tpu_torch.pipelines.sml_inference import make_infer_fn


def _dtype(cfg: RidersConfig) -> torch.dtype:
    return (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
            else torch.float32)


def _rcnet_dir(rcnet_interp: Optional[str]) -> Optional[str]:
    """The stage-2 directory of an 'rcnet_*' knot source; the 'none' and
    'interp' sources read no stage-2 maps."""
    return (rcnet_interp
            if rcnet_interp and "rcnet" in rcnet_interp else None)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _train_loader(dataset, batch_size: int, what: str,
                  device: torch.device) -> BatchLoader:
    loader = BatchLoader(dataset, batch_size, shuffle=True, device=device)
    if len(loader) == 0:
        raise ValueError(
            f"{len(dataset)} samples < batch size {batch_size}: no full "
            f"batch to train on (reduce {what}.batch_size)")
    return loader


def _train_loop(cfg: RidersConfig, t, state, step_fn, loader: BatchLoader,
                checkpoint_dir: str, what: str, log_path: Optional[str],
                resume: bool, max_steps: Optional[int],
                on_checkpoint: Callable) -> None:
    """The loop both trainers share.  With `resume`, the latest
    checkpoint (model, optimizer, scheduler, step) is restored first.
    Epochs run from step // steps_per_epoch + 1 to the schedule's last;
    every n_step_per_summary steps the step's scalars are written, every
    n_step_per_checkpoint steps `on_checkpoint(state, info, batch, timer,
    writer)` logs and the state is saved; at `max_steps` the state is
    saved and the loop returns.  The loss is read on the host only at
    those steps."""
    if resume and ckpt_lib.latest_step(checkpoint_dir) is not None:
        ckpt_lib.restore_train_state(checkpoint_dir, state)
        log_lib.log(f"Resumed from step {state.step}", log_path)
    steps_per_epoch = len(loader)
    n_epochs = t.learning_schedule[-1]
    writer = log_lib.ScalarWriter(checkpoint_dir, "train")
    timer = log_lib.StepTimer(steps_per_epoch * n_epochs)
    log_lib.log_params(log_path, dataclasses.asdict(cfg))
    log_lib.log(f"Training {what}: {len(loader.dataset)} samples, "
                f"{steps_per_epoch} steps/epoch, {n_epochs} epochs",
                log_path)
    try:
        for _ in range(state.step // steps_per_epoch + 1, n_epochs + 1):
            for batch in loader.epoch():
                state, info = step_fn(state, batch)
                timer.tick()
                if state.step % t.n_step_per_summary == 0:
                    writer.write(state.step, info)
                if state.step % t.n_step_per_checkpoint == 0:
                    on_checkpoint(state, info, batch, timer, writer)
                    ckpt_lib.save_train_state(checkpoint_dir, state)
                if max_steps is not None and state.step >= max_steps:
                    ckpt_lib.save_train_state(checkpoint_dir, state)
                    return
        ckpt_lib.save_train_state(checkpoint_dir, state)
    finally:
        writer.close()
        loader.close()


def train_sml(cfg: RidersConfig, checkpoint_dir: str, resume: bool = False,
              log_path: Optional[str] = None,
              max_steps: Optional[int] = None, device=None) -> None:
    """Stage-3 training on the training scenes (SMLFrameDataset with its
    augmentations), f32, checkpoints under `checkpoint_dir`."""
    device = resolve_device(device)
    t = cfg.sml_train
    records = build_manifest(cfg.dataset, cfg.dataset.train_scenes,
                             rcnet_interp=_rcnet_dir(t.rcnet_interp))
    loader = _train_loader(SMLFrameDataset(cfg, records, train=True),
                           t.batch_size, "sml_train", device)
    model = init_training_(build_sml_model(cfg, device, torch.float32))
    state = sml_training.init_train_state(cfg, model, len(loader))

    def on_checkpoint(state, info, batch, timer, writer):
        log_lib.log(f"{timer.format()} Loss={float(info['loss']):.5f}",
                    log_path)

    _train_loop(cfg, t, state, sml_training.make_train_step(cfg), loader,
                checkpoint_dir, "SML", log_path, resume, max_steps,
                on_checkpoint)


def train_rcnet(cfg: RidersConfig, checkpoint_dir: str,
                resume: bool = False, log_path: Optional[str] = None,
                max_steps: Optional[int] = None, device=None) -> None:
    """Stage-2 training on the training scenes (RCNetTrainDataset), f32,
    checkpoints under `checkpoint_dir`.  At each checkpoint step it also
    writes `summaries/step<n>.png` (one row per displayed point: patch |
    response | output label | GT label | label error | validity | GT
    depth), the histograms of those panels and the label counts."""
    device = resolve_device(device)
    t = cfg.rcnet_train
    records = build_manifest(cfg.dataset, cfg.dataset.train_scenes)
    loader = _train_loader(RCNetTrainDataset(cfg, records), t.batch_size,
                           "rcnet_train", device)
    model = init_training_(RCNet(cfg.rcnet, device, torch.float32))
    state = rcnet_training.init_rcnet_train_state(cfg, model, len(loader))
    summary_fn = rcnet_training.make_rcnet_summary_fn(cfg)

    def on_checkpoint(state, info, batch, timer, writer):
        log_lib.log(f"{timer.format()} Loss={float(info['loss']):.5f} "
                    f"P={float(info['precision']):.3f} "
                    f"R={float(info['recall']):.3f}", log_path)
        panels = {k: _numpy(v) for k, v in summary_fn(state, batch).items()}
        grid = [[panels[k][i] for k in (
            "image_patch", "response", "output_label", "label",
            "label_error", "validity", "gt_depth")]
            for i in range(panels["response"].shape[0])]
        log_lib.save_image_mosaic(os.path.join(
            checkpoint_dir, "summaries", f"step{state.step}.png"), grid,
            max_depth=1.0)
        writer.write_histograms(state.step, {
            k: panels[k] for k in ("response", "output_label", "label",
                                   "gt_depth")})
        writer.write(state.step, {
            **info, **{k: panels[k] for k in (
                "n_ground_truth_label_per_point",
                "n_predicted_label_per_point")}})

    _train_loop(cfg, t, state, rcnet_training.make_rcnet_train_step(cfg),
                loader, checkpoint_dir, "RC-Net", log_path, resume,
                max_steps, on_checkpoint)


def run_rcnet(cfg: RidersConfig, checkpoint_dir: str, output_root: str,
              scenes=None, save_color: bool = True,
              log_path: Optional[str] = None, device=None) -> None:
    """Stage-2 inference with the latest checkpoint; writes
        <output_root>/rcnet_<thr>/<scene>/depth_predicted/<frame>.png
    (and a viridis picture under depth_predicted_colors/)."""
    device = resolve_device(device)
    scenes = scenes or (cfg.dataset.train_scenes + cfg.dataset.val_scenes)
    records = build_manifest(cfg.dataset, scenes, require_all=False)
    dataset = RCNetInferenceDataset(cfg, records)
    model = ckpt_lib.restore_model(
        checkpoint_dir, RCNet(cfg.rcnet, device, _dtype(cfg)))
    infer = make_rcnet_infer_fn(cfg, model, device)

    thr_tag = f"rcnet_{cfg.rcnet.response_threshold}"
    loader = BatchLoader(dataset, batch_size=1, shuffle=False,
                         drop_last=False, device=device)
    for idx, batch in enumerate(loader.epoch()):
        depth = _numpy(infer(batch)["depth"][0])
        rec = records[idx]
        scene_dir = os.path.join(output_root, thr_tag, rec.scene)
        out_dir = depthio.ensure_dir(os.path.join(scene_dir,
                                                  "depth_predicted"))
        depthio.save_depth(depth, os.path.join(out_dir,
                                               rec.frame_id + ".png"))
        if save_color:
            cdir = depthio.ensure_dir(os.path.join(
                scene_dir, "depth_predicted_colors"))
            depthio.save_color_depth(
                depth, os.path.join(cdir, rec.frame_id + ".png"))
        if idx % 50 == 0:
            log_lib.log(f"rcnet {idx + 1}/{len(dataset)}", log_path)


def validate_rcnet(cfg: RidersConfig, checkpoint_dir: str,
                   log_path: Optional[str] = None,
                   device=None) -> Dict[str, float]:
    """Stage-2 validation over every checkpoint, newest first: MAE, RMSE,
    iMAE and iRMSE of the quasi-dense depth against the interpolated
    lidar GT where both are positive, averaged over frames; a step is
    best when at least 3 of the 4 improve.  Returns the best bundle and
    its step."""
    device = resolve_device(device)
    records = build_manifest(cfg.dataset, cfg.dataset.val_scenes,
                             require_all=False)
    dataset = RCNetInferenceDataset(cfg, records)
    gt_maps = [depthio.load_depth(r.gt_interp) for r in records]
    model = RCNet(cfg.rcnet, device, _dtype(cfg))
    infer = make_rcnet_infer_fn(cfg, model, device)

    best = {"step": -1, "mae": np.inf, "rmse": np.inf,
            "imae": np.inf, "irmse": np.inf}
    for step in sorted(ckpt_lib.all_steps(checkpoint_dir), reverse=True):
        ckpt_lib.restore_model(checkpoint_dir, model, step)
        loader = BatchLoader(dataset, batch_size=1, shuffle=False,
                             drop_last=False, device=device)
        acc = {k: [] for k in ("mae", "rmse", "imae", "irmse")}
        for idx, batch in enumerate(loader.epoch()):
            pred = _numpy(infer(batch)["depth"][0])
            gt = gt_maps[idx]
            mask = (pred > 0) & (gt > 0)
            if mask.sum() == 0:
                continue
            p, g = pred[mask], gt[mask]
            acc["mae"].append(np.mean(np.abs(1000 * p - 1000 * g)))
            acc["rmse"].append(
                np.sqrt(np.mean((1000 * p - 1000 * g) ** 2)))
            acc["imae"].append(np.mean(np.abs(1 / (0.001 * g)
                                              - 1 / (0.001 * p))))
            acc["irmse"].append(np.sqrt(np.mean(
                (1 / (0.001 * g) - 1 / (0.001 * p)) ** 2)))
        results = {k: float(np.mean(v)) for k, v in acc.items() if v}
        log_lib.log(f"RC-Net validation step {step}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in results.items()), log_path)
        if sum(results[k] < best[k] for k in results) >= 3:
            best.update(results)
            best["step"] = step
    log_lib.log(f"RC-Net best: {best}", log_path)
    return best


def _aggregate(per_frame: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.mean(v)) for k, v in per_frame.items()
            if k != "n_valid"}


def validate_sml(cfg: RidersConfig, checkpoint_dir: str,
                 output_path: Optional[str] = None,
                 save_output: bool = False,
                 log_path: Optional[str] = None,
                 batch_size: int = 8, device=None) -> Dict[str, float]:
    """Stage-3 validation over every checkpoint, newest first, on the
    validation scenes: the seven metrics averaged over frames; a step is
    best when more than 3 of them improve (`metrics.improves_best`).
    With `save_output`, writes <output_path>/SML/<scene>/sml_depth/*.png
    and one mosaic per step (image | aligned prior | prediction).
    Returns the best bundle and its step."""
    device = resolve_device(device)
    t = cfg.sml_train
    records = build_manifest(
        cfg.dataset, cfg.dataset.val_scenes,
        rcnet_interp=_rcnet_dir(t.rcnet_interp_val or t.rcnet_interp))
    dataset = SMLFrameDataset(cfg, records, train=False)
    loader = BatchLoader(dataset, batch_size, shuffle=False,
                         drop_last=False, device=device)
    model = build_sml_model(cfg, device, _dtype(cfg))
    infer = make_infer_fn(cfg, model, with_metrics=True, device=device)

    best = {"step": -1, "mae": np.inf, "rmse": np.inf, "imae": np.inf,
            "irmse": np.inf, "abs_rel": np.inf, "sq_rel": np.inf,
            "delta1": 0.0}
    for step in sorted(ckpt_lib.all_steps(checkpoint_dir), reverse=True):
        ckpt_lib.restore_model(checkpoint_dir, model, step)
        per_frame: Dict[str, list] = {}
        frame_idx = 0
        for batch in loader.epoch():
            out = infer(batch)
            for k, v in out["metrics"].items():
                per_frame.setdefault(k, []).append(_numpy(v))
            n = batch["image"].shape[0]
            if save_output and output_path:
                depths = _numpy(out["depth"])
                for i in range(n):
                    rec = records[frame_idx + i]
                    ddir = depthio.ensure_dir(os.path.join(
                        output_path, "SML", rec.scene, "sml_depth"))
                    depthio.save_depth(depths[i], os.path.join(
                        ddir, rec.frame_id + ".png"))
                if frame_idx == 0:
                    log_lib.save_image_mosaic(
                        os.path.join(output_path, "SML",
                                     f"mosaic-step{step}.png"),
                        [_numpy(batch["image"][0]),
                         1.0 / np.maximum(_numpy(out["int_depth"][0]),
                                          1e-3),
                         depths[0]],
                        max_depth=cfg.eval.max_depth_val)
            frame_idx += n
        results = _aggregate(
            {k: np.concatenate(v) for k, v in per_frame.items()})
        log_lib.log_evaluation_results("Validation results", results,
                                       step, log_path)
        if metrics_lib.improves_best(results, best):
            best.update(results)
            best["step"] = step
        log_lib.log_evaluation_results(
            "Best results", {k: best[k] for k in results}, best["step"],
            log_path)
    return best


def evaluate_results_dir(cfg: RidersConfig, result_root: str,
                         depth_subdir: str = "sml_depth",
                         log_path: Optional[str] = None,
                         device=None) -> Dict[str, float]:
    """Score the depth PNGs <result_root>/<scene>/<depth_subdir>/ of the
    validation scenes against their sparse lidar GT: the seven metrics
    averaged over the frames that have a prediction."""
    device = resolve_device(device)
    records = build_manifest(cfg.dataset, cfg.dataset.val_scenes,
                             require_all=False)
    ev = cfg.eval
    per_frame: Dict[str, list] = {}
    n_scored = 0
    for rec in records:
        pred_path = os.path.join(result_root, rec.scene, depth_subdir,
                                 rec.frame_id + ".png")
        if not os.path.exists(pred_path) or rec.gt_sparse is None:
            continue
        pred, gt = (torch.from_numpy(depthio.load_depth(p)).to(device)
                    for p in (pred_path, rec.gt_sparse))
        m = metrics_lib.compute_depth_metrics(
            pred, gt, ev.min_depth_val, ev.max_depth_val,
            ev.delta_threshold)
        for k, v in m.items():
            per_frame.setdefault(k, []).append(float(v))
        n_scored += 1
    results = _aggregate({k: np.asarray(v) for k, v in per_frame.items()})
    log_lib.log(f"Scored {n_scored} frames", log_path)
    log_lib.log_evaluation_results("Results", results, -1, log_path)
    return results
