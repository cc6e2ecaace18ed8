"""Fused three-stage inference: radar points -> metric depth.

  edge-pad frame -> RC-Net (full-image encode, K-patch decode) ->
  closed-form adaptive threshold -> patch composition (quasi-dense radar
  depth) -> raw-radar scatter -> bounded scale alignment of the mono
  prior -> scale-map synthesis -> SML forward -> bicubic upsample of
  1 / pred -> dense metric depth

The stem, the RoI pool and the composition run as CUDA kernels on the
card (their plain versions on the CPU); the rest is PyTorch.
`make_sharded_fused_fn` runs the same path over a mesh of ranks
(`parallel.sharding`).  Each call is the span `fused.call`, holding the
spans `fused.inputs`, `fused.rcnet`, `fused.compose`, `fused.stage1`,
`fused.sml` and `fused.upsample` in that order (`core.tracing`).  Only
the two stages between the networks, `fused.compose` and
`fused.stage1`, are mirrored on the device under a profiler: the call's
first and last kernels and the networks' stay with the caller's own
ranges, around the call or around a network's forward, whose mirrors
would otherwise lose them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from riders_tpu_torch.core.config import RidersConfig
from riders_tpu_torch.core.device import (check_model_device,
                                          resolve_device, to_device)
from riders_tpu_torch.core.tracing import span
from riders_tpu_torch.models import sml_folded
from riders_tpu_torch.models.rcnet import RCNet
from riders_tpu_torch.models.sml import ScaleMapLearner
from riders_tpu_torch.ops.kernels.compose import compose_patches
from riders_tpu_torch.ops.patches import adaptive_threshold_value
from riders_tpu_torch.ops.resize import edge_pad2d, resize2d
from riders_tpu_torch.pipelines.rcnet_inference import shift_points_and_boxes
from riders_tpu_torch.pipelines.sml_inference import prepare_sml_inputs


def _scatter_points(points: torch.Tensor, mask: torch.Tensor,
                    shape) -> torch.Tensor:
    """Scatter (B, K, 3) (u, v, z) points to sparse (B, H, W) depth maps;
    u, v truncate toward zero and clamp to the frame."""
    H, W = shape
    B, K = mask.shape
    u = points[..., 0].to(torch.int64).clamp(0, W - 1)
    v = points[..., 1].to(torch.int64).clamp(0, H - 1)
    z = points[..., 2] * mask
    bi = torch.arange(B, device=points.device)[:, None].expand(B, K)
    out = torch.zeros((B, H, W), dtype=torch.float32, device=points.device)
    return out.index_put_((bi, v, u), z.float())


class _Stages:
    """The fused path's stages around RC-Net, shared by the unsharded and
    sharded forms: the batch's decoding, RC-Net's inputs, and everything
    after the responses."""

    def __init__(self, cfg: RidersConfig, rcnet: RCNet,
                 sml: ScaleMapLearner, device: torch.device):
        check_model_device("rcnet", rcnet, device)
        check_model_device("sml", sml, device)
        self.cfg, self.rcnet, self.sml, self.device = cfg, rcnet, sml, device
        self.rc_dtype = next(rcnet.parameters()).dtype
        self.sml_dtype = next(sml.parameters()).dtype
        # the W-folded SML forward, opt-in (models/sml_folded.py)
        self.fold = (self.sml_dtype == torch.bfloat16
                     and cfg.sml.model_type == "midas-small"
                     and sml_folded.supports_folding(sml, cfg.sml.net_shape))

    def inputs(self, batch: Dict):
        """(image, mono, radar_points, mask) on the device, decoded."""
        with span("fused.inputs"):
            image = to_device(batch["image"], self.device)
            if image.dtype == torch.uint8:
                image = image.float() * (1.0 / 255.0)
            mono = to_device(batch["mono_pred"], self.device)
            if mono.dtype == torch.uint16:
                # through int16 bits: CUDA's uint16 support is bare
                codes = mono.view(torch.int16).int() & 0xFFFF
                mono = codes.float() * (1.0 / 256.0)
            radar_points = to_device(batch["radar_points"],
                                     self.device).float()
            mask = to_device(batch["point_mask"], self.device).float()
            return image, mono, radar_points, mask.contiguous()

    def rcnet_inputs(self, image: torch.Tensor, radar_points: torch.Tensor):
        """The edge-padded frame and the points and boxes in its
        coordinates."""
        patch = self.cfg.rcnet.patch_size
        padded = edge_pad2d(image.to(self.rc_dtype), patch[0] // 2,
                            patch[1] // 2)
        points, boxes = shift_points_and_boxes(radar_points, patch)
        return padded, points, boxes

    def depth(self, image, mono, radar_points, mask, points,
              responses: torch.Tensor) -> torch.Tensor:
        """Threshold, composition, scatter, stage 1, SML and the bicubic
        upsample of 1 / pred: (B, H, W) metric depth."""
        cfg = self.cfg
        H, W = cfg.dataset.image_shape
        with span("fused.compose", mirror=True):
            if cfg.rcnet.adaptive_composition:
                thr = adaptive_threshold_value(
                    responses, mask, cfg.rcnet.response_threshold,
                    cfg.rcnet.threshold_decay,
                    cfg.rcnet.max_threshold_retries)
            else:
                thr = cfg.rcnet.response_threshold
            quasi_depth, _ = compose_patches(
                responses, points.contiguous(), mask, (H, W),
                cfg.rcnet.patch_size, thr)
            # Raw radar returns on the frame grid: the alignment target.
            radar_sparse = _scatter_points(radar_points, mask, (H, W))
        with span("fused.stage1", mirror=True):
            x, d = prepare_sml_inputs(cfg, image, mono, radar_sparse,
                                      quasi_depth)
            x = x.to(self.sml_dtype)
        with span("fused.sml"):
            pred_inv, _ = (sml_folded.folded_sml_apply(self.sml, x, d)
                           if self.fold else self.sml(x, d))
        with span("fused.upsample"):
            return resize2d(1.0 / pred_inv, (H, W), "bicubic",
                            align_corners=False)[..., 0]


def make_fused_fn(cfg: RidersConfig, rcnet: RCNet, sml: ScaleMapLearner,
                  device=None) -> Callable[[Dict], torch.Tensor]:
    """Build fn(batch) -> (B, H, W) metric depth on `device` (the card
    unless device='cpu'; without a card and without that request this
    raises).

    batch:
      image: (B, H, W, 3) frames in [0, 1], or uint8 (decoded x / 255);
      mono_pred: (B, H, W) relative inverse-depth prior, or uint16 PNG16
        codes (decoded x / 256);
      radar_points: (B, K, 3) (u, v, z) in unpadded pixel coordinates;
      point_mask: (B, K).
    Tensors or numpy arrays; they are moved to the device.  With
    RIDERS_SML_FOLD=1, a bf16 midas-small SML runs its W-folded forward
    (`models.sml_folded`).
    """
    stages = _Stages(cfg, rcnet, sml, resolve_device(device))

    @torch.inference_mode()
    def fused(batch: Dict) -> torch.Tensor:
        with span("fused.call"):
            image, mono, radar_points, mask = stages.inputs(batch)
            with span("fused.rcnet"):
                padded, points, boxes = stages.rcnet_inputs(image,
                                                            radar_points)
                responses = rcnet(padded, points, boxes, mask,
                                  return_logits=False)[..., 0]
                responses = responses.float().contiguous()
            return stages.depth(image, mono, radar_points, mask, points,
                                responses)

    return fused


def make_sharded_fused_fn(cfg: RidersConfig, rcnet: RCNet,
                          sml: ScaleMapLearner, mesh=None, device=None
                          ) -> Callable[[Dict], torch.Tensor]:
    """The fused path over the (data, points) mesh of
    `parallel.sharding` (`mesh_from_config(cfg.mesh)` by default): every
    rank calls fn(batch) with the same global batch and gets the global
    (B, H, W) depth back.

    Each rank takes its frames over `data` and encodes them; of each
    frame it decodes its K / n_points points over `points` (RoI pool,
    point MLP, attention and decoder: in eval each point's response
    depends on its frame's maps and itself alone); the responses are
    gathered over `points`, since the threshold and the composition need
    every point of a frame; the threshold, composition, stage 1 and the
    SML run on the rank's frames, and the depths are gathered over
    `data`.  B must divide over `data` and K over `points`."""
    from riders_tpu_torch.parallel import sharding as sh

    stages = _Stages(cfg, rcnet, sml, resolve_device(device))
    if mesh is None:
        mesh = sh.mesh_from_config(cfg.mesh)
    by_point = sh.Sharding(mesh, (None, sh.POINTS_AXIS))

    @torch.inference_mode()
    def sharded(batch: Dict) -> torch.Tensor:
        with span("fused.call"):
            image, mono, radar_points, mask = stages.inputs(
                sh.shard_batch(mesh, batch, point_keys=()))
            with span("fused.rcnet"):
                padded, points, boxes = stages.rcnet_inputs(image,
                                                            radar_points)
                latent, skips = rcnet.encode(padded)
                mine = rcnet.decode_points(
                    latent, skips, by_point.local(points),
                    by_point.local(boxes), by_point.local(mask),
                    return_logits=False)[..., 0].float()
            responses = mesh.axis(sh.POINTS_AXIS).gather(mine, dim=1)
            depth = stages.depth(image, mono, radar_points, mask, points,
                                 responses.contiguous())
            return mesh.axis(sh.DATA_AXIS).gather(depth, dim=0)

    return sharded
