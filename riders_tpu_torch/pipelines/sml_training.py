"""Stage-3 (SML) training step: batched stage 1, forward, loss, Adam.

One call of the step takes a batch of frames through stage 1 (scale
alignment and scale-map synthesis, no gradient), the Scale Map Learner
in train mode, the SML loss against the nearest-resized ground truth,
the backward and one optimizer update.  `TrainState`, the schedule and
the optimizer are shared with the RC-Net step (rcnet_training.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.ops import losses as losses_lib
from riders_tpu_torch.ops import outlier
from riders_tpu_torch.ops.resize import resize2d
from riders_tpu_torch.parallel import sharding
from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs


@dataclasses.dataclass
class TrainState:
    """A model in train mode, its optimizer and learning-rate scheduler,
    and the number of steps taken."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def piecewise_constant_schedule(rates: Sequence[float],
                                bounds: Sequence[int],
                                steps_per_epoch: int
                                ) -> Callable[[int], float]:
    """Learning rate i until epoch bounds[i], as optax's piecewise
    constant schedule with multiplicative boundaries at
    int(bound * steps_per_epoch): at step t the rate is rates[0] times
    every factor rates[i + 1] / rates[i] whose boundary is <= t."""
    rates = list(rates)
    boundaries = {int(b * steps_per_epoch):
                  rates[min(i + 1, len(rates) - 1)] / max(rates[i], 1e-30)
                  for i, b in enumerate(list(bounds)[:-1])}

    def schedule(step: int) -> float:
        v = rates[0]
        for boundary, factor in sorted(boundaries.items()):
            if step >= boundary:
                v *= factor
        return v

    return schedule


def make_lr_schedule(cfg: RidersConfig, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """SML rate i applies until epoch learning_schedule[i]."""
    t = cfg.sml_train
    return piecewise_constant_schedule(t.learning_rates, t.learning_schedule,
                                       steps_per_epoch)


def adam_state(model: nn.Module, schedule: Callable[[int], float],
               weight_decay: float = 0.0) -> TrainState:
    """A TrainState at step 0 with the model in train mode, Adam (AdamW
    with decoupled decay when weight_decay > 0; optax's formula: eps
    outside the square root, bias correction) and `schedule` as the
    learning rate of update t (0-based)."""
    params = [p for p in model.parameters() if p.requires_grad]
    if weight_decay > 0:
        opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    return TrainState(step=0, model=model.train(), optimizer=opt,
                      scheduler=sched)


def init_train_state(cfg: RidersConfig, model: nn.Module,
                     steps_per_epoch: int) -> TrainState:
    """The SML model (already built on its device) in train mode with
    its optimizer: Adam, or AdamW when sml_train.w_weight_decay > 0."""
    return adam_state(model, make_lr_schedule(cfg, steps_per_epoch),
                      cfg.sml_train.w_weight_decay)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def batch_to(batch: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """Numpy arrays or tensors -> tensors on `device`."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                ).to(device) for k, v in batch.items()}


def apply_update(state: TrainState, loss: torch.Tensor) -> TrainState:
    """Backward of `loss` into fresh `.grad`s, one optimizer update and
    one scheduler step.  The gradients stay on the parameters until the
    next step.  The backward is `parallel.sharding.backward`'s: inside a
    sharded step every rank holds the global batch's gradients."""
    state.optimizer.zero_grad(set_to_none=True)
    sharding.backward(loss, list(state.model.parameters()))
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state


def make_train_step(cfg: RidersConfig
                    ) -> Callable[[TrainState, Mapping],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Build step(state, batch) -> (state, info); the state is updated
    in place.

    batch: (B, H, W[, C]) frames - image in [0, 1], mono_pred, radar,
    gt_interp, gt_sparse and, when sml_train.rcnet_interp names an
    'rcnet_*' source, rcnet (quasi-dense stage-2 depth); numpy arrays or
    tensors, moved to the model's device.  info holds 0-d tensors: the
    loss and its terms."""
    t = cfg.sml_train
    net_shape = cfg.sml.net_shape
    use_rcnet = "rcnet" in (t.rcnet_interp or "")

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            rcnet = batch.get("rcnet") if use_rcnet else None
            x, d = prepare_sml_inputs(cfg, batch["image"],
                                      batch["mono_pred"], batch["radar"],
                                      rcnet)
        dtype = next(model.parameters()).dtype
        pred_inv, _ = model(x.to(dtype), d)
        depth_pred = 1.0 / pred_inv
        d_depth = 1.0 / d

        gt_interp = resize2d(batch["gt_interp"][..., None].float(),
                             net_shape, "nearest")
        gt_sparse = resize2d(batch["gt_sparse"][..., None].float(),
                             net_shape, "nearest")
        invalid_map_gt = gt_interp <= 0
        if t.gt_dilation_kernel_size > 1:
            gt_interp = outlier.dilate_max(
                gt_interp[..., 0], t.gt_dilation_kernel_size)[..., None]
        if (t.gt_outlier_removal_kernel_size > 1
                and t.gt_outlier_removal_threshold > 0):
            gt_interp = outlier.remove_outliers(
                gt_interp[..., 0], t.gt_outlier_removal_kernel_size,
                t.gt_outlier_removal_threshold)[..., None]

        return losses_lib.sml_loss(
            image=d_depth, output_depth=depth_pred, gt_interp=gt_interp,
            gt_sparse=gt_sparse, loss_func=t.loss_func,
            w_smoothness=t.w_smoothness,
            sobel_filter_size=t.sobel_filter_size,
            validity_map_loss_smoothness=torch.ones_like(d_depth),
            w_lidar_loss=t.w_lidar_loss, w_edge=t.w_edge,
            invalid_map_gt=invalid_map_gt,
            w_unsupervised=t.w_unsupervised)

    def train_step(state: TrainState, batch: Mapping):
        model = state.model.train()
        loss, info = loss_fn(model, batch_to(batch, model_device(model)))
        apply_update(state, loss)
        return state, {k: v.detach() for k, v in info.items()}

    return train_step
