"""Swin V2 window attention: scaled cosine logits, the continuous position
bias and the shift mask.

`swin2_attention` launches the CUDA kernel (csrc/swin2_attention.cu) for
CUDA tensors and runs its plain version, `swin2_attention_plain`, for CPU
tensors.  Both take the qkv projection's output (Bw, N, 3C) of Bw windows
of N = w^2 tokens, the block's position-bias MLP output over the (2w-1)^2
relative coordinates, (H, (2w-1)^2) float32 before its 16 sigmoid, and the
per-head logit scale exp(min(logit_scale, log 100)), (H,) float32, and
return the input of the output projection, (Bw, N, C).  A shifted block's
windows (`shift` > 0) tile the rolled (gh, gw) `grid` row major, a frame
after another, and attend across `shift_mask`'s regions at -100.  The
kernel never writes the (Bw, H, N, N) logits, the (H, N, N) bias or the
(nW, N, N) mask: it gathers each logit's bias from the table in shared
memory and computes the regions from the window's place in the grid.

The plain version applies the sigmoid after the gather, as the block
did before the table was split from it: the CPU's sigmoid rounds its
vector body and its scalar tail differently, so only that order keeps the
plain path bitwise what it was.  The kernel applies it as it stages the
table.

`swin2_attention_path` says which of the two a Swin V2 block runs: the
kernel for bf16 inference on the card at head width 32 and windows of up
to 576 tokens, the plain version elsewhere (the CPU, training, float32,
other widths).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
HEAD_DIM = 32               # the kernel's head width (swin2_attention.cu: D)
MAX_TOKENS = 576            # the largest window, 24 x 24


def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """Swin's relative position index of a (wh, ww) window, (wh*ww,
    wh*ww), into a table of (2wh-1)(2ww-1) rows."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


def shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, win^2, win^2) additive mask of the shifted windows: 0 within
    a region, -100 across regions."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


def masked_softmax(attn: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Add the (nW, N, N) window mask to (Bw, heads, N, N) logits, then
    softmax over the last axis."""
    if mask is not None:
        Bw, nh, N, _ = attn.shape
        nW = mask.shape[0]
        attn = (attn.reshape(Bw // nW, nW, nh, N, N)
                + mask[None, :, None]).reshape(Bw, nh, N, N)
    return attn.softmax(-1)


# the constants below, shared by the V1 and V2 attentions, are made outside
# inference mode: a later call under autograd saves the index for backward


@functools.lru_cache(maxsize=16)
def pair_index(window: int, device: torch.device) -> torch.Tensor:
    """`rel_pos_index` of a square window flattened, int64 on `device`."""
    with torch.inference_mode(False):
        return torch.from_numpy(rel_pos_index(window, window).reshape(
            -1).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=16)
def grid_mask(grid: Tuple[int, int], window: int, shift: int,
              device: torch.device) -> Optional[torch.Tensor]:
    """`shift_mask` of a (gh, gw) grid on `device`; None unshifted."""
    if not shift:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(shift_mask(*grid, window, shift)).to(device)


def swin2_attention_path(dtype: torch.dtype, device_type: str,
                         training: bool, grad_enabled: bool, head_dim: int,
                         tokens: int) -> str:
    """"kernel" for bf16 inference on the card with grad disabled at head
    width 32 and windows of at most 576 tokens, else "plain"."""
    if (dtype == torch.bfloat16 and device_type == "cuda" and not training
            and not grad_enabled and head_dim == HEAD_DIM
            and tokens <= MAX_TOKENS):
        return "kernel"
    return "plain"


def split_heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """(Bw, N, C) -> (Bw, nh, N, C // nh)."""
    Bw, N, C = t.shape
    return t.reshape(Bw, N, nh, C // nh).transpose(1, 2)


def l2_normalize(t: torch.Tensor) -> torch.Tensor:
    """t / max(|t|, 1e-12) over the last axis in float32, rounded back to
    t's dtype."""
    t32 = t.to(torch.float32)
    n = torch.sqrt((t32 * t32).sum(-1, keepdim=True))
    return (t32 / torch.clamp(n, min=1e-12)).to(t.dtype)


def swin2_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                          scale: torch.Tensor, window: int, shift: int,
                          grid: Tuple[int, int], heads: int) -> torch.Tensor:
    """q and k L2-normalised in float32 and rounded back, q k^T in the
    input's dtype, then in float32 scaled per head, biased by 16 sigmoid
    of the table gathered to (heads, N, N), masked across a shifted
    grid's regions and softmaxed, rounded back to the input's dtype for
    attn v; (Bw, N, C) in the input's dtype."""
    Bw, N, C3 = qkv.shape
    q, k, v = (split_heads(t, heads) for t in qkv.chunk(3, dim=-1))
    attn = (l2_normalize(q) @ l2_normalize(k).transpose(-2, -1)).to(torch.float32)
    bias = table.t()[pair_index(window, table.device)].reshape(N, N, heads)
    bias = (16.0 * torch.sigmoid(bias)).permute(2, 0, 1)
    attn = attn * scale.reshape(-1, 1, 1)[None] + bias[None]
    mask = grid_mask(tuple(grid), window, shift, qkv.device)
    attn = masked_softmax(attn, mask).to(qkv.dtype)
    return (attn @ v).transpose(1, 2).reshape(Bw, N, C3 // 3)


def swin2_attention(qkv: torch.Tensor, table: torch.Tensor,
                    scale: torch.Tensor, window: int, shift: int,
                    grid: Tuple[int, int], heads: int) -> torch.Tensor:
    """See `swin2_attention_plain`.  On CUDA: qkv contiguous bf16 of head
    width 32 and N = window^2 <= 576 tokens, table contiguous float32
    (heads, (2 window - 1)^2), scale contiguous float32 (heads,); a
    shifted block's Bw a multiple of the grid's windows."""
    if on_cpu(qkv, table, scale):
        return swin2_attention_plain(qkv, table, scale, window, shift, grid,
                                     heads)
    Bw, N, C3 = qkv.shape
    gh, gw = grid
    if C3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"qkv {tuple(qkv.shape)}: the kernel takes "
                         f"{heads} heads of {HEAD_DIM}")
    if N != window * window or N > MAX_TOKENS:
        raise ValueError(f"qkv has {N} tokens: the kernel takes a "
                         f"{window}x{window} window of at most "
                         f"{MAX_TOKENS}")
    if shift and not (0 < shift < window and gh % window == 0
                      and gw % window == 0
                      and Bw % ((gh // window) * (gw // window)) == 0):
        raise ValueError(f"{Bw} windows of {window} shifted by {shift} do "
                         f"not tile {grid} grids")
    require(qkv, "qkv", torch.bfloat16)
    require(table, "table", torch.float32, (heads, (2 * window - 1) ** 2))
    require(scale, "scale", torch.float32, (heads,))
    if qkv.data_ptr() % 16:
        raise ValueError("qkv: expected a 16-byte aligned tensor")
    out = torch.empty((Bw, N, C3 // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    fn = kernel_function("swin2_attention", "riders_swin2_attention",
                         _ARGTYPES)
    check(fn(qkv.data_ptr(), table.data_ptr(), scale.data_ptr(),
             out.data_ptr(), Bw, N, heads, window, shift, gh, gw,
             stream_handle(qkv)), "swin2_attention")
    LAUNCHES["swin2_attention"] += 1
    return out
