"""Linear and softmax attention and the LoFTR self / cross encoder stack.

The O(N) elu+1 feature-map linear attention, the softmax ("full")
attention, and the QKV / merge / MLP / LayerNorm encoder layer of the
JAX package, with its optional query / key masks.  Flax's LayerNorm
default eps is 1e-6 (torch's is 1e-5), so it is set explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x) + 1.0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_mask: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """q: (N, L, H, D); k, v: (N, S, H, D); masks (N, L) / (N, S), which
    zero the masked queries' features and the masked keys' features and
    values.  Returns (N, L, H, D)."""
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
        v = v * kv_mask[:, :, None, None].to(v.dtype)
    v_length = v.shape[1]
    v = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_mask: Optional[torch.Tensor] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention at temperature 1 / sqrt(D); q: (N, L, H, D); k,
    v: (N, S, H, D).  Where both masks are given, the logits of a masked
    query or key are -inf, so a query row with no valid key is NaN, as
    in the JAX package.  Returns (N, L, H, D)."""
    qk = torch.einsum("nlhd,nshd->nlsh", q, k)
    if kv_mask is not None and q_mask is not None:
        keep = (q_mask[:, :, None, None] * kv_mask[:, None, :, None]) > 0
        qk = torch.where(keep, qk, torch.full_like(qk, float("-inf")))
    attn = torch.softmax(qk * (1.0 / q.shape[-1] ** 0.5), dim=2)
    return torch.einsum("nlsh,nshd->nlhd", attn, v)


class LoFTREncoderLayer(nn.Module):
    """Projected linear ("linear") or softmax ("full") attention +
    concat-MLP residual update."""

    def __init__(self, d_model: int, nhead: int = 8,
                 attention: str = "linear"):
        super().__init__()
        if attention not in ("linear", "full"):
            raise ValueError(f"attention: 'linear' or 'full', got "
                             f"{attention!r}")
        self.nhead = nhead
        self.attention = attention
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp1 = nn.Linear(2 * d_model, 2 * d_model, bias=False)
        self.mlp2 = nn.Linear(2 * d_model, d_model, bias=False)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, source: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, l, c = x.shape
        s = source.shape[1]
        h = self.nhead
        q = self.q_proj(x).reshape(n, l, h, c // h)
        k = self.k_proj(source).reshape(n, s, h, c // h)
        v = self.v_proj(source).reshape(n, s, h, c // h)
        attend = (linear_attention if self.attention == "linear"
                  else full_attention)
        message = attend(q, k, v, x_mask, source_mask)
        message = self.norm1(self.merge(message.reshape(n, l, c)))
        message = self.mlp2(F.relu(self.mlp1(torch.cat([x, message], -1))))
        return x + self.norm2(message)


class LocalFeatureTransformer(nn.Module):
    """`layer_types` x `n_layers` layers: 'self' updates each stream with
    itself, 'cross' attends each stream to the other (the second stream
    sees the first stream's update); `mask0` / `mask1` mask each
    stream's tokens."""

    def __init__(self, d_model: int = 128, nhead: int = 8,
                 layer_types: Sequence[str] = ("self", "cross"),
                 n_layers: int = 4, attention: str = "linear"):
        super().__init__()
        self.kinds = list(layer_types) * n_layers
        for i, kind in enumerate(self.kinds):
            if kind not in ("self", "cross"):
                raise KeyError(kind)
            self.add_module(f"layer{i}",
                            LoFTREncoderLayer(d_model, nhead, attention))

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor,
                mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, kind in enumerate(self.kinds):
            layer = getattr(self, f"layer{i}")
            if kind == "self":
                feat0 = layer(feat0, feat0, mask0, mask0)
                feat1 = layer(feat1, feat1, mask1, mask1)
            else:
                feat0 = layer(feat0, feat1, mask0, mask1)
                feat1 = layer(feat1, feat0, mask1, mask0)
        return feat0, feat1
