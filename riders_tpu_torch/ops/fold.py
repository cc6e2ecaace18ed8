"""W-folded (space-to-depth along W) convolution primitives.

Folding W by F re-expresses the same linear ops on a (B, H, W/F, F*C)
canvas whose channel dimension is F times wider:

    x_f[b, h, w', f*C + c] = x[b, h, F*w' + f, c]

which for a channels-last (NHWC) tensor is exactly ``x.reshape(B, H,
W // F, F * C)``: fold and unfold are free reshapes.  Activations here
are NHWC (the SML's input layout, and the memory layout of the port's
channels_last maps); weights are the port's: conv OIHW (Co, Ci, Kh, Kw),
depthwise (C, 1, Kh, Kw), pointwise (Co, Ci).

A conv with W-stride s maps an F_in-folded input to an (F_in / s)-folded
output.  With t = s * f_out + kw - pad_left and (q, r) = divmod(t, F_in),
tap kw seen from output phase f_out reads folded column w' + q at input
phase r, so the folded kernel

    K_f[f_out*Co + co, r*Ci + ci, kh, q - q_min] += K[co, ci, kh, kw]

is block-sparse, one entry per (kh, kw, f_out).  Zero padding of the
folded W axis is exactly zero padding of the original one when W % F ==
0, so a folded conv is an exact re-layout of the original op: the same
products plus exact zeros.  Used by `models.sml_folded`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tf_same_pads(in_size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF 'SAME' asymmetric padding (left, right) of one axis."""
    out = -(-in_size // stride)
    total = max((out - 1) * stride + kernel - in_size, 0)
    return total // 2, total - total // 2


def fold_w(x: torch.Tensor, F_: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., H, W // F, F * C); lane f * C + c is
    column F * w' + f."""
    if F_ == 1:
        return x
    *lead, H, W, C = x.shape
    if W % F_:
        raise ValueError(f"width {W} does not fold by {F_}")
    return x.reshape(*lead, H, W // F_, F_ * C)


def unfold_w(x: torch.Tensor, F_: int) -> torch.Tensor:
    """Inverse of fold_w."""
    if F_ == 1:
        return x
    *lead, H, Wf, FC = x.shape
    return x.reshape(*lead, H, Wf * F_, FC // F_)


def refold_w(x: torch.Tensor, f_from: int, f_to: int) -> torch.Tensor:
    """Change the fold factor (either way); a reshape of the trailing
    dimensions."""
    if f_from == f_to:
        return x
    *lead, H, Wf, FC = x.shape
    return x.reshape(*lead, H, Wf * f_from // f_to, f_to * (FC // f_from))


@functools.lru_cache(maxsize=None)
def _scatter_on(device: torch.device, *key) -> torch.Tensor:
    """_fold_scatter's S on `device`, copied there once."""
    return torch.from_numpy(_fold_scatter(*key)[0]).to(device)


@functools.lru_cache(maxsize=None)
def _fold_scatter(F_in: int, F_out: int, Kw: int, stride_w: int,
                  pad_w_left: int) -> Tuple[np.ndarray, int, int]:
    """The constant scatter S[q - q_min, r, f_out, kw] and (q_min, q_max)."""
    if F_in != stride_w * F_out:
        raise ValueError(f"F_in {F_in} != stride {stride_w} x F_out "
                         f"{F_out}")
    qs = [divmod(stride_w * fo + kw - pad_w_left, F_in)
          for fo in range(F_out) for kw in range(Kw)]
    q_min = min(q for q, _ in qs)
    q_max = max(q for q, _ in qs)
    S = np.zeros((q_max - q_min + 1, F_in, F_out, Kw), np.float32)
    for i, (q, r) in enumerate(qs):
        S[q - q_min, r, i // Kw, i % Kw] = 1.0
    return S, q_min, q_max


def fold_conv_kernel(weight: torch.Tensor, F_in: int, F_out: int,
                     stride_w: int, pad_w_left: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Fold an OIHW conv weight (Co, Ci, Kh, Kw) for an F_in-folded input
    and an F_out-folded output (F_in == stride_w * F_out; the folded
    conv has W-stride 1).  Returns the folded weight (F_out * Co,
    F_in * Ci, Kh, Kw') and the folded axis's (left, right) zero pad."""
    Co, Ci, Kh, Kw = weight.shape
    key = (F_in, F_out, Kw, stride_w, pad_w_left)
    _, q_min, q_max = _fold_scatter(*key)
    S = _scatter_on(weight.device, *key)
    Kf = torch.einsum("qrfk,oihk->forihq", S, weight.float())
    Kf = Kf.reshape(F_out * Co, F_in * Ci, Kh, q_max - q_min + 1)
    return Kf.to(weight.dtype), (-q_min, q_max)


def folded_conv(x_f: torch.Tensor, weight: torch.Tensor, *, F_in: int,
                F_out: int, stride: Tuple[int, int], pad_h: Tuple[int, int],
                pad_w_left: int, dtype=None) -> torch.Tensor:
    """The original conv (OIHW `weight`, `stride`, top / bottom pad
    `pad_h`, left pad `pad_w_left`) applied to an F_in-folded NHWC input;
    returns the F_out-folded NHWC output in `dtype` (x_f's by default)."""
    Kf, (pad_l, pad_r) = fold_conv_kernel(weight, F_in, F_out, stride[1],
                                          pad_w_left)
    dt = dtype or x_f.dtype
    x = F.pad(x_f.to(dt).permute(0, 3, 1, 2), (pad_l, pad_r) + tuple(pad_h))
    return F.conv2d(x, Kf.to(dt), stride=(stride[0], 1)).permute(0, 2, 3, 1)


def fold_pw_kernel(weight: torch.Tensor, F_: int) -> torch.Tensor:
    """A 1x1 weight (Co, Ci) -> block-diagonal (F * Co, F * Ci): each
    phase group maps to itself."""
    return torch.block_diag(*([weight] * F_))


def folded_pointwise(x_f: torch.Tensor, weight: torch.Tensor, F_: int,
                     dtype=None) -> torch.Tensor:
    """A 1x1 conv (Co, Ci) on an F-folded NHWC input: one matmul over
    the F-times wider channels."""
    dt = dtype or x_f.dtype
    return F.linear(x_f.to(dt), fold_pw_kernel(weight, F_).to(dt))


def folded_depthwise(x_f: torch.Tensor, weight: torch.Tensor, *, F_in: int,
                     F_out: int, stride: Tuple[int, int],
                     pad_h: Tuple[int, int], pad_w_left: int
                     ) -> torch.Tensor:
    """A depthwise conv (weight (C, 1, Kh, Kw)) on an F_in-folded NHWC
    input.  Output phase f_out's tap kw reads input phase (stride *
    f_out + kw - pad) % F_in, across phase groups, which a grouped conv
    cannot express in the phase-major channel order; so each (f_out, kh,
    kw) tap is a slice of the zero-padded canvas times the per-channel
    weight, accumulated in f32: the original op count."""
    C, _, Kh, Kw = weight.shape
    sh, sw = stride
    if F_in != sw * F_out:
        raise ValueError(f"F_in {F_in} != stride {sw} x F_out {F_out}")
    B, H, Wf, FC = x_f.shape
    if FC != F_in * C:
        raise ValueError(f"{FC} channels are not {F_in} x {C}")
    _, q_min, q_max = _fold_scatter(F_in, F_out, Kw, sw, pad_w_left)
    x_p = F.pad(x_f, (0, 0, -q_min, q_max) + tuple(pad_h))
    H_out = (H + pad_h[0] + pad_h[1] - Kh) // sh + 1
    rows = [x_p[:, p::sh] for p in range(sh)]
    kf = weight[:, 0].float().permute(1, 2, 0)          # (Kh, Kw, C)
    outs = []
    for fo in range(F_out):
        acc = None
        for kh in range(Kh):
            base, row0 = rows[kh % sh], kh // sh
            for kw in range(Kw):
                q, r = divmod(sw * fo + kw - pad_w_left, F_in)
                tap = base[:, row0:row0 + H_out, q - q_min:q - q_min + Wf,
                           r * C:(r + 1) * C].float() * kf[kh, kw]
                acc = tap if acc is None else acc + tap
        outs.append(acc)
    return torch.cat(outs, -1).to(x_f.dtype)
