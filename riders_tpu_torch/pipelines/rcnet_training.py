"""Stage-2 (RC-Net) training step: label synthesis and weighted BCE.

The batch carries edge-padded frames, the K-point bucket with its patch
boxes and per-patch GT depth crops.  The correspondence labels
(|gt - radar z| < max_distance and gt > 0) and the validity map are
synthesized on the device; the positive-class-weighted BCE also masks
padded bucket slots.  The RoI pool's backward is a CUDA kernel on the
card (ops/kernels/roi_pool.py).  Under `parallel.sharding.
with_data_sharding` the loss and the aux sums span the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.ops.losses import weighted_bce_with_logits
from riders_tpu_torch.parallel.sharding import batch_sum
from riders_tpu_torch.pipelines.sml_training import (
    TrainState, adam_state, apply_update, batch_to, model_device,
    piecewise_constant_schedule)


def synthesize_labels(gt_crops: torch.Tensor, radar_z: torch.Tensor,
                      max_distance: float,
                      set_invalid_to_negative: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correspondence labels and validity.

    gt_crops: (B, K, ph, pw, 1) GT depth crops; radar_z: (B, K).  A pixel
    is positive iff |gt - z| < max_distance and gt > 0; pixels without
    GT are invalid (out of the loss) unless `set_invalid_to_negative`."""
    z = radar_z[:, :, None, None, None]
    labels = ((torch.abs(gt_crops - z) < max_distance)
              & (gt_crops > 0)).float()
    if set_invalid_to_negative:
        validity = torch.ones_like(gt_crops)
    else:
        validity = (gt_crops > 0).float()
    return labels, validity


def make_rcnet_lr_schedule(cfg: RidersConfig, steps_per_epoch: int
                           ) -> Callable[[int], float]:
    t = cfg.rcnet_train
    return piecewise_constant_schedule(t.learning_rates, t.learning_schedule,
                                       steps_per_epoch)


def init_rcnet_train_state(cfg: RidersConfig, model: nn.Module,
                           steps_per_epoch: int) -> TrainState:
    """RC-Net (already built on its device) in train mode with Adam on
    its schedule."""
    return adam_state(model, make_rcnet_lr_schedule(cfg, steps_per_epoch))


def make_rcnet_train_step(cfg: RidersConfig
                          ) -> Callable[[TrainState, Mapping],
                                        Tuple[TrainState,
                                              Dict[str, torch.Tensor]]]:
    """Build step(state, batch) -> (state, aux); the state is updated in
    place.

    batch: image (B, Hp, Wp, 3) padded frames, points (B, K, 3) in padded
    coordinates, boxes (B, K, 4), gt_crops (B, K, ph, pw, 1), point_mask
    (B, K); numpy arrays or tensors, moved to the model's device.  aux
    holds 0-d tensors: loss, n_positive, n_valid, precision, recall."""
    t = cfg.rcnet_train

    def train_step(state: TrainState, batch: Mapping):
        model = state.model.train()
        batch = batch_to(batch, model_device(model))
        mask = batch["point_mask"].float()
        logits = model(batch["image"], batch["points"], batch["boxes"],
                       mask, return_logits=True)
        labels, validity = synthesize_labels(
            batch["gt_crops"], batch["points"][..., 2],
            t.max_distance_correspondence, t.set_invalid_to_negative_class)
        validity = validity * mask[:, :, None, None, None]
        loss = weighted_bce_with_logits(logits, labels, validity,
                                        t.w_positive_class)
        apply_update(state, loss)
        with torch.no_grad():
            # correspondence-classifier quality scalars
            pred_pos = (logits > 0).float() * validity
            true_pos = batch_sum(pred_pos * labels)
            n_positive = batch_sum(labels * validity)
            aux = {
                "loss": loss.detach(),
                "n_positive": n_positive,
                "n_valid": batch_sum(validity),
                "precision": true_pos / torch.clamp(batch_sum(pred_pos),
                                                    min=1.0),
                "recall": true_pos / torch.clamp(n_positive, min=1.0),
            }
        return state, aux

    return train_step


def make_rcnet_summary_fn(cfg: RidersConfig, n_display: int = 4
                          ) -> Callable[[TrainState, Mapping],
                                        Dict[str, torch.Tensor]]:
    """Visual training summaries: one eval-mode forward on the batch and,
    for the first `n_display` valid bucket slots in batch order, the
    image patch (mapped back to [0, 1]), the sigmoid response, the
    thresholded label (response > 0.5), the synthesized GT label, the
    relative label error on valid pixels, the validity map and the GT
    depth / 100, each (n, ph, pw[, 3]); plus the mean GT and predicted
    label counts per point.  The model goes back to its mode after."""
    t = cfg.rcnet_train
    ph, pw = cfg.rcnet.patch_size
    lo, hi = cfg.rcnet.normalized_image_range

    @torch.no_grad()
    def summarize(state: TrainState, batch: Mapping
                  ) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        batch = batch_to(batch, model_device(model))
        try:
            response = model.eval()(
                batch["image"], batch["points"], batch["boxes"],
                batch["point_mask"].float(), return_logits=False)[..., 0]
        finally:
            model.train(was_training)
        response = response.float()
        labels, validity = synthesize_labels(
            batch["gt_crops"], batch["points"][..., 2],
            t.max_distance_correspondence, t.set_invalid_to_negative_class)

        B, K = batch["points"].shape[:2]
        n = min(n_display, B * K)
        mask = batch["point_mask"].reshape(-1).float()
        # first n valid slots in batch order
        order_bias = torch.arange(mask.numel(), 0, -1, dtype=torch.float32,
                                  device=mask.device)
        idx = torch.topk(mask * mask.numel() + order_bias, n).indices
        bi, ki = idx // K, idx % K

        image = batch["image"]
        Hp, Wp = image.shape[1:3]
        y1 = batch["boxes"][bi, ki, 1].to(torch.int64).clamp(0, Hp - ph)
        x1 = batch["boxes"][bi, ki, 0].to(torch.int64).clamp(0, Wp - pw)
        rows = y1[:, None, None] + torch.arange(ph, device=image.device)[
            None, :, None]
        cols = x1[:, None, None] + torch.arange(pw, device=image.device)[
            None, None, :]
        patch = image[bi[:, None, None], rows, cols].float()

        flat = lambda a: a.reshape((B * K,) + a.shape[2:])[idx]
        resp = flat(response)
        lab = flat(labels[..., 0])
        val = flat(validity[..., 0])
        gtd = flat(batch["gt_crops"][..., 0])
        out_label = (resp > 0.5).float()
        err = torch.where(val == 1.0,
                          (torch.abs(out_label - lab) + 1e-8) / (lab + 1e-8),
                          val)
        return {
            "image_patch": (patch - lo) / (hi - lo),
            "response": resp,
            "output_label": out_label,
            "label": lab,
            "label_error": err,
            "validity": val,
            "gt_depth": gtd / 100.0,
            "n_ground_truth_label_per_point": torch.mean(
                torch.sum(labels[..., 0], dim=(-2, -1))),
            "n_predicted_label_per_point": torch.mean(torch.sum(
                (response > 0.5).float(), dim=(-2, -1))),
        }

    return summarize
