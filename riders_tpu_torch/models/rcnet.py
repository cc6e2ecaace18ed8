"""RC-Net: radar-pixel correspondence network.

* ``ResNetEncoder``: full-image encoder whose 7x7/s2 stem and 3x3 max
  pool run as one fused kernel; skips at /2, /4, /8, /16, latent at /32;
* ``PointEncoder``: MLP lifting each radar (u, v, z) to a token grid;
* ``MultiScaleDecoder``: U-Net decoder from the fused latent back to a
  per-pixel logit map over the patch, at one or several resolutions
  (its `literal` form, or `lane_decode.decode_full` on the hand-written
  kernels for bf16 inference on the card);
* ``RCNet``: encode once per frame, RoI-pool every scale around each
  point (one kernel launch per scale), LoFTR self / cross attention
  between point and patch tokens, concat fusion, decode the B*K patches.

In train mode the stem runs the library conv with batch BatchNorm, and
the RoI pool carries its backward kernel.  Masked bucket slots are
decoded like real ones, so they enter the BatchNorm batch statistics, as
in the JAX model: the mask only sets their logits to -1e4.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from riders_tpu_torch.core.config import RCNetConfig
from riders_tpu_torch.core.device import resolve_device
from riders_tpu_torch.models import lane_decode
from riders_tpu_torch.models.attention import LocalFeatureTransformer
from riders_tpu_torch.models.layers import (
    ConvBlock, DecoderBlock, FullyConnected, FusedStemConv, ResNetBlock,
    activation_fn, bn_fold, cached_weights, hwio, nearest2x_phase_kernel,
    oihw, phase_compose_3x3, phase_conv, phase_form_on, phases_to_space,
    place)
from riders_tpu_torch.ops.kernels.roi_pool import roi_pool_pyramid
from riders_tpu_torch.ops.resize import resize_nchw


class ResNetEncoder(nn.Module):
    """ResNet-18-style encoder, `n_blocks_per_stage` residual blocks per
    stage; forward takes the NHWC image and returns (latent, [skips at
    /2, /4, ..]) as NCHW tensors."""

    def __init__(self, n_filters: Sequence[int] = (32, 64, 128, 128, 128),
                 activation: str = "leaky_relu", use_batch_norm: bool = True,
                 in_ch: int = 3, n_blocks_per_stage: int = 2):
        super().__init__()
        act = activation_fn(activation)
        self.n_stages = len(n_filters)
        self.conv1 = FusedStemConv(in_ch, n_filters[0], activation,
                                   use_batch_norm, fuse_pool=True)
        self.stage_blocks: List[List[str]] = []
        prev = n_filters[0]
        for si, feat in enumerate(n_filters[1:]):
            names = []
            for bi in range(n_blocks_per_stage):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                name = f"blocks{si + 2}_{bi}"
                self.add_module(name, ResNetBlock(prev, feat, stride, act,
                                                  use_batch_norm))
                names.append(name)
                prev = feat
            self.stage_blocks.append(names)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h, pooled = self.conv1(x)
        skips = [h]
        h = pooled
        for si, names in enumerate(self.stage_blocks):
            for name in names:
                h = getattr(self, name)(h)
            if si < self.n_stages - 2:
                skips.append(h)
        return h, skips


class PointEncoder(nn.Module):
    """MLP radar-point encoder; every layer has the activation."""

    def __init__(self, n_neurons: Sequence[int] = (32, 64, 128, 128, 128),
                 latent_size: int = 128 * 7 * 3,
                 activation: str = "leaky_relu", in_features: int = 3):
        super().__init__()
        act = activation_fn(activation)
        self.n_layers = len(n_neurons)
        prev = in_features
        for i, feat in enumerate(n_neurons):
            self.add_module(f"fc{i}", FullyConnected(prev, feat, act))
            prev = feat
        self.fc_out = FullyConnected(prev, latent_size, act)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        h = points
        for i in range(self.n_layers):
            h = getattr(self, f"fc{i}")(h)
        return self.fc_out(h)


class MultiScaleDecoder(nn.Module):
    """U-Net decoder, n_resolution 1 .. depth - 1.

    Walks the skips deep -> shallow; the last block upsamples to
    `output_shape` (with skips[0] when the pyramid is as deep as the
    decoder), then a 3x3 conv emits `output_channels` logits.  With
    ``n_resolution > 1`` an `output{d}` conv taps each of the last
    `n_resolution - 1` scales (d = 3, 2, 1 at most); its bilinear
    align_corners x2 upsample is concatenated after the next block's
    encoder skip, deconv0 takes the upsampled 1/2-scale output as its
    skip (after skips[0] when the pyramid is as deep as the decoder), and
    the return value is the deep -> shallow list of outputs.  An
    `output_func` containing "upsample" forces n_resolution >= 2 and
    returns, as the last output, the bilinear x2 of output1 (no deconv0 /
    output0).  Output convs are linear for "upsample" and any name with
    "linear", else they take that activation.

    `forward` runs `lane_decode.decode_full`, every stage on the
    hand-written kernels B7 / B8, for a bf16 input on a CUDA device in eval
    with grad disabled on a decoder it decodes (`lane_decode.decode_path`),
    and `literal`, the decoder in PyTorch ops, for every other input; the
    JAX package's default is the literal decoder everywhere.  Each call
    counts its path in `lane_decode.DECODES`.

    ``phase_tail`` runs the full-resolution tail (deconv0's nearest
    x2 + conv, its fusion conv and output0) in phase space at a quarter
    of the pixels, as the JAX decoder's phase tail: the upsample composes
    into the upconv (`layers.nearest2x_phase_kernel`), each following 3x3
    conv composes with the depth-to-space (`layers.phase_compose_3x3`),
    exact with the BNs' running statistics, and one depth-to-space of
    the logits ends it.  It applies in eval where
    `phase_tail_unsupported` finds nothing.  True forces it, False keeps
    the literal path, and None (the default) chooses by
    `layers.phase_form_on`."""

    def __init__(self, in_ch: int, skip_channels: Sequence[int],
                 n_filters: Sequence[int] = (256, 128, 64, 32, 16),
                 output_shape: Tuple[int, int] = (240, 100),
                 activation: str = "leaky_relu",
                 use_batch_norm: bool = True, n_resolution: int = 1,
                 output_func: str = "linear", output_channels: int = 1,
                 phase_tail: Optional[bool] = None):
        super().__init__()
        depth = len(n_filters)
        if depth >= 8:
            raise ValueError("the decoder supports depths up to 7")
        self.upsample_out = "upsample" in output_func
        n_res = max(n_resolution, 2) if self.upsample_out else n_resolution
        if not 1 <= n_res < depth:
            raise ValueError(f"n_resolution {n_resolution}: 1 .. "
                             f"{depth - 1} for a depth-{depth} decoder")
        act = activation_fn(activation)
        out_act = (None if output_func == "upsample"
                   or "linear" in output_func
                   else activation_fn(output_func))
        self.depth = depth
        self.n_resolution = n_res
        self.activation_name = activation
        self.use_batch_norm = use_batch_norm
        self.phase_tail = phase_tail
        self.linear_output = out_act is None
        self._lane_packed = {}      # packed / composed weights, by stage
        self.output_shape = tuple(output_shape)
        self.n_skips = len(skip_channels)
        prev, up_ch = in_ch, 0
        for i, feat in enumerate(n_filters[:-1]):
            d = depth - 1 - i
            si = self.n_skips - 1 - i
            skip_ch = (skip_channels[si] if si >= 0 else 0) + up_ch
            self.add_module(f"deconv{d}", DecoderBlock(
                prev, skip_ch, feat, act, use_batch_norm))
            prev = feat
            up_ch = 0
            if d in (3, 2, 1) and n_res > d:
                self.add_module(f"output{d}", ConvBlock(
                    feat, output_channels, 3, 1, out_act))
                up_ch = output_channels
        if not self.upsample_out:
            skip0 = (skip_channels[0] if self.n_skips == depth else 0)
            self.deconv0 = DecoderBlock(prev, skip0 + up_ch, n_filters[-1],
                                        act, use_batch_norm)
            self.output0 = ConvBlock(n_filters[-1], output_channels, 3, 1,
                                     out_act)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]):
        """The logits (N, output_channels, *output_shape), or with
        n_resolution > 1 the deep -> shallow list of outputs; by
        `decode_full` or `literal`, as `lane_decode.decode_path` says."""
        path = lane_decode.decode_path(
            x.dtype, x.device.type, self.training, torch.is_grad_enabled(),
            self, len(skips),
            tuple(skips[0].shape[-2:]) if len(skips) else None)
        lane_decode.DECODES[path] += 1
        if path == "full":
            return lane_decode.decode_full(self, x, skips)
        return self.literal(x, skips)

    def literal(self, x: torch.Tensor, skips: Sequence[torch.Tensor]):
        """`forward` in PyTorch ops, the phase tail where `phase_tail`
        allows it: the plain form beside B7 / B8, and the only one on the
        CPU, in f32, in training, with grad and on every decoder that
        `lane_decode.unsupported` names."""
        h = x
        outputs: List[torch.Tensor] = []
        up_prev = None
        for i in range(self.depth - 1):
            d = self.depth - 1 - i
            si = len(skips) - 1 - i
            skip = skips[si] if si >= 0 else None
            if up_prev is not None:
                # encoder skip first, then the upsampled coarser output
                skip = (up_prev.to(h.dtype) if skip is None else
                        torch.cat([skip, up_prev.to(skip.dtype)], 1))
            h = getattr(self, f"deconv{d}")(h, skip=skip)
            up_prev = None
            if d in (3, 2, 1) and self.n_resolution > d:
                out = getattr(self, f"output{d}")(h)
                outputs.append(out)
                up_prev = resize_nchw(out, (2 * out.shape[-2],
                                            2 * out.shape[-1]),
                                      "bilinear", align_corners=True)
        if self.upsample_out:
            return outputs + [up_prev]
        if (phase_form_on(self.phase_tail, h) and not self.training
                and self.phase_tail_unsupported(
                    len(skips), tuple(h.shape[-2:])) is None):
            return self._phase_tail(h)
        if up_prev is not None:
            skip0 = (up_prev if len(skips) != self.depth else
                     torch.cat([skips[0], up_prev.to(skips[0].dtype)], 1))
            h = self.deconv0(h, skip=skip0)
        elif len(skips) == self.depth:
            h = self.deconv0(h, skip=skips[0])
        else:
            h = self.deconv0(h, shape=self.output_shape)
        out0 = self.output0(h)
        return outputs + [out0] if self.n_resolution > 1 else out0

    def phase_tail_unsupported(self, n_skips: int, half_hw) -> Optional[str]:
        """Why deconv0 + output0 cannot run in phase space (the literal
        `phase_tail`, and `decode_full`'s tail) on `n_skips` skips with
        deconv0's input `half_hw` in size, or None where they can: one
        resolution, a linear output, batch norm, no skip at full
        resolution, and the output exactly x2 of `half_hw`."""
        if self.n_resolution != 1:
            return "the phase tail requires the single-resolution decoder"
        if not self.linear_output:
            return "the phase tail requires a linear output"
        if not self.use_batch_norm:
            return "the phase tail requires the batch-norm decoder"
        if n_skips == self.depth:
            return "the phase tail takes no skip at full resolution"
        if self.output_shape != (2 * half_hw[0], 2 * half_hw[1]):
            return "the phase tail requires an exact-x2 output"
        return None

    def _phase_tail(self, h: torch.Tensor) -> torch.Tensor:
        up, fuse, out = self.deconv0.deconv.conv, self.deconv0.conv, \
            self.output0
        w_up, f_up, w_fuse, f_fuse, w_out = cached_weights(
            self._lane_packed, "phase_tail", [up, fuse, out], lambda: (
                oihw(nearest2x_phase_kernel(hwio(up.conv))), bn_fold(up.bn),
                oihw(phase_compose_3x3(hwio(fuse.conv))), bn_fold(fuse.bn),
                oihw(phase_compose_3x3(hwio(out.conv)))))
        z = phase_conv(h, w_up, f_up)
        if up.activation is not None:
            z = up.activation(z)
        z = phase_conv(z, w_fuse, f_fuse)
        if fuse.activation is not None:
            z = fuse.activation(z)
        return phases_to_space(phase_conv(z, w_out), out.conv.out_channels)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW tensor, contiguous (free for channels_last)."""
    return t.permute(0, 2, 3, 1).contiguous()


class RCNet(nn.Module):
    """End-to-end RC-Net over a padded point bucket.

    forward(image, points, boxes, point_mask):
      image: (B, H, W, 3) edge-padded frame, NHWC;
      points: (B, K, 3) radar (u, v, z) in padded-image coordinates;
      boxes: (B, K, 4) [x1, y1, x2, y2] patch boxes, float32;
      point_mask: (B, K) validity of the bucket.
    Returns logits (B, K, ph, pw, 1), or masked sigmoid responses with
    ``return_logits=False``; with ``return_all_scales=True`` the deep ->
    shallow list of every output scale of a multi-resolution decoder
    (the full-resolution map last).
    """

    def __init__(self, config: RCNetConfig = RCNetConfig(), device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        lh, lw = cfg.latent_shape
        d_model = cfg.n_neurons_encoder_depth[-1]
        filters = cfg.n_filters_encoder_image
        if filters[-1] != d_model:
            raise ValueError("the shared attention layers need the image "
                             "latent width to equal the point width")
        self.encoder_image = ResNetEncoder(
            filters, cfg.activation, cfg.use_batch_norm,
            in_ch=cfg.input_channels_image)
        self.encoder_depth = PointEncoder(
            cfg.n_neurons_encoder_depth, d_model * lh * lw, cfg.activation,
            in_features=cfg.input_channels_depth)
        self.attention = LocalFeatureTransformer(
            d_model, cfg.attention_heads, ("self", "cross"),
            cfg.attention_layers)
        self.decoder = MultiScaleDecoder(
            filters[-1] + d_model, filters[:-1], cfg.n_filters_decoder,
            cfg.patch_size, cfg.activation, cfg.use_batch_norm,
            cfg.n_resolution)
        place(self, resolve_device(device), dtype)

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                boxes: torch.Tensor,
                point_mask: Optional[torch.Tensor] = None,
                return_logits: bool = True,
                return_all_scales: bool = False):
        latent, skips = self.encode(image)
        return self.decode_points(latent, skips, points, boxes, point_mask,
                                  return_logits, return_all_scales)

    def encode(self, image: torch.Tensor
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The frames' encoder maps: (latent, skips), NCHW."""
        dtype = self.encoder_image.conv1.conv.weight.dtype
        return self.encoder_image(image.to(dtype))

    def decode_points(self, latent: torch.Tensor,
                      skips: Sequence[torch.Tensor], points: torch.Tensor,
                      boxes: torch.Tensor,
                      point_mask: Optional[torch.Tensor] = None,
                      return_logits: bool = True,
                      return_all_scales: bool = False):
        """The per-point half of `forward` on `encode`'s maps: RoI pool,
        point MLP, attention and decoder.  In eval each point's output
        depends on its frame's maps and on itself alone, so any subset of
        a frame's points decodes to the same outputs."""
        cfg = self.config
        B, K = points.shape[:2]
        lh, lw = cfg.latent_shape
        dtype = self.encoder_image.conv1.conv.weight.dtype

        pooled_latent, pooled_skips = roi_pool_pyramid(
            _nhwc(latent), [_nhwc(s) for s in skips],
            boxes.float().contiguous(), cfg.patch_size)
        # (B, K, h, w, C) -> (B*K, C, h, w) views of NHWC memory
        flat = lambda t: t.reshape((B * K,) + t.shape[2:]).permute(0, 3, 1, 2)
        pooled_skips = [flat(s) for s in pooled_skips]

        # Point branch: MLP -> (B*K, lh*lw, d) tokens, channel-major.
        point_latent = self.encoder_depth(
            points.reshape(B * K, points.shape[-1]).to(dtype))
        d_model = cfg.n_neurons_encoder_depth[-1]
        point_tokens = point_latent.reshape(B * K, d_model,
                                            lh * lw).transpose(1, 2)
        image_tokens = pooled_latent.reshape(B * K, lh * lw, -1)
        point_tokens, image_tokens = self.attention(point_tokens,
                                                    image_tokens)

        # Concat fusion: image features first.
        fused = torch.cat([image_tokens.reshape(B * K, lh, lw, -1),
                           point_tokens.reshape(B * K, lh, lw, -1)], dim=-1)
        outs = self.decoder(fused.permute(0, 3, 1, 2), pooled_skips)
        if not isinstance(outs, list):
            outs = [outs]

        def finalize(logits: torch.Tensor) -> torch.Tensor:
            logits = logits.permute(0, 2, 3, 1).reshape(
                (B, K) + tuple(logits.shape[-2:]) + (logits.shape[1],))
            if point_mask is None:
                return logits if return_logits else torch.sigmoid(logits)
            keep = point_mask[:, :, None, None, None] > 0
            fill = -1e4 if return_logits else 0.0
            logits = torch.where(keep, logits,
                                 torch.full_like(logits, fill))
            if return_logits:
                return logits
            return torch.sigmoid(logits) * point_mask[
                :, :, None, None, None].to(logits.dtype)

        if return_all_scales:
            return [finalize(o) for o in outs]
        # the full-resolution output, as the reference wrapper's `[-1]`
        return finalize(outs[-1])
