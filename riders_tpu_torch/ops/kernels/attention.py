"""BEiT attention with its relative position bias.

`beit_attention` launches the CUDA kernel (csrc/beit_attention.cu) for
CUDA tensors and runs its plain version, `beit_attention_plain`, for CPU
tensors.  Both take the qkv projection's output (B, N, 3C) and the
block's relative position table resized to the window, (H, R) float32,
and return the input of the output projection, (B, N, C).  The kernel
never writes the (B, H, N, N) logits or the (H, N, N) bias: it gathers
each logit's bias from the table in shared memory, by the index that
`beit_rel_pos_index` lays out.

`attention_path` says which of the two a BEiT block runs: the kernel for
bf16 inference on the card at head width 64, the plain version
elsewhere (the CPU, training, float32, other widths).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from riders_tpu_torch.ops.kernels import (LAUNCHES, on_cpu, require,
                                          stream_handle)
from riders_tpu_torch.ops.kernels.build import check, kernel_function

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
HEAD_DIM = 64               # the kernel's head width (beit_attention.cu: D)


def beit_rel_pos_index(gh: int, gw: int) -> np.ndarray:
    """Relative position index of a (gh, gw) window plus cls token, of
    shape (gh*gw+1, gh*gw+1), into a table of (2gh-1)*(2gw-1) + 3 rows:
    the spatial offsets, then cls<->cls, cls->token, token->cls."""
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    n = gh * gw
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel + 1     # cls -> token
    idx[0:, 0] = num_rel + 2     # token -> cls
    idx[0, 0] = num_rel          # cls -> cls
    return idx


def table_rows(grid: Tuple[int, int]) -> int:
    """R, the rows of a (gh, gw) window's table."""
    gh, gw = grid
    return (2 * gh - 1) * (2 * gw - 1) + 3


@functools.lru_cache(maxsize=8)
def _rel_index(grid: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """`beit_rel_pos_index` flattened, on `device` (read only)."""
    return torch.from_numpy(beit_rel_pos_index(*grid).reshape(-1)).to(device)


def attention_path(dtype: torch.dtype, device_type: str, training: bool,
                   grad_enabled: bool, head_dim: int) -> str:
    """"kernel" for bf16 inference on the card with grad disabled at head
    width 64, else "plain"."""
    if (dtype == torch.bfloat16 and device_type == "cuda" and not training
            and not grad_enabled and head_dim == HEAD_DIM):
        return "kernel"
    return "plain"


def beit_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                         grid: Tuple[int, int], num_heads: int
                         ) -> torch.Tensor:
    """The bias gathered to (H, N, N), q k^T in the input's dtype, then in
    float32 scaled and biased and softmaxed, rounded back to the input's
    dtype for attn v; (B, N, C) in the input's dtype."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    bias = table[:, _rel_index(tuple(grid), table.device)].reshape(
        num_heads, N, N)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(
        2, 0, 3, 1, 4).unbind(0)
    attn = (q @ k.transpose(-2, -1)).float() / math.sqrt(hd)
    attn = (attn + bias[None]).softmax(-1)
    return (attn.to(qkv.dtype) @ v).transpose(1, 2).reshape(B, N, C)


def beit_attention(qkv: torch.Tensor, table: torch.Tensor,
                   grid: Tuple[int, int], num_heads: int) -> torch.Tensor:
    """See `beit_attention_plain`.  On CUDA: qkv contiguous bf16 of head
    width 64 and N = gh gw + 1 tokens, table contiguous float32 (H, R); a
    window whose table and keys do not fit in a block's shared memory
    fails the launch."""
    if on_cpu(qkv, table):
        return beit_attention_plain(qkv, table, grid, num_heads)
    B, N, C3 = qkv.shape
    gh, gw = grid
    C = C3 // 3
    if C3 != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv {tuple(qkv.shape)}: the kernel takes "
                         f"{num_heads} heads of {HEAD_DIM}")
    if N != gh * gw + 1:
        raise ValueError(f"qkv has {N} tokens, the {grid} window "
                         f"{gh * gw + 1}")
    require(qkv, "qkv", torch.bfloat16)
    require(table, "table", torch.float32, (num_heads, table_rows(grid)))
    if qkv.data_ptr() % 16:
        raise ValueError("qkv: expected a 16-byte aligned tensor")
    out = torch.empty((B, N, C), dtype=torch.bfloat16, device=qkv.device)
    fn = kernel_function("beit_attention", "riders_beit_attention",
                         _ARGTYPES)
    check(fn(qkv.data_ptr(), table.data_ptr(), out.data_ptr(), B, N,
             num_heads, gh, gw, 1.0 / math.sqrt(HEAD_DIM),
             stream_handle(qkv)), "beit_attention")
    LAUNCHES["beit_attention"] += 1
    return out
