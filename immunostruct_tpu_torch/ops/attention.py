"""Attention (counterpart of ``immunostruct_tpu/ops/attention.py``).

Plain products and softmax, as in the JAX package: scores and the weighted
sum accumulate in f32, the softmax runs in f32 and its weights are cast to
the input's dtype and returned.

- ``SelfAttention``: single-head QKV without an output projection.
- ``MultiHeadAttention``: split/concat heads and an output projection. With
  ``input_dim != feature_dim`` it is the "fusion attention" that treats a
  D-wide vector as a length-D sequence of scalars.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from immunostruct_tpu_torch.ops.nnp import Linear, linear_apply


class SelfAttention(nn.Module):
    def __init__(self, feature_dim: int, *, generator: torch.Generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.query = Linear(feature_dim, feature_dim, **kw)
        self.key = Linear(feature_dim, feature_dim, **kw)
        self.value = Linear(feature_dim, feature_dim, **kw)


class MultiHeadAttention(nn.Module):
    def __init__(self, feature_dim: int, n_head: int,
                 input_dim: Optional[int] = None, *,
                 generator: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        if feature_dim % n_head:
            raise ValueError("feature_dim must be divisible by n_head")
        input_dim = input_dim or feature_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.w_q = Linear(input_dim, feature_dim, **kw)
        self.w_k = Linear(input_dim, feature_dim, **kw)
        self.w_v = Linear(input_dim, feature_dim, **kw)
        self.w_concat = Linear(feature_dim, feature_dim, **kw)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def self_attention_apply(p: SelfAttention, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, D] -> (output [B, L, D], weights [B, L, L])."""
    q = linear_apply(p.query, x)
    k = linear_apply(p.key, x)
    v = linear_apply(p.value, x)
    scores = _scores(q, k, 1.0 / k.shape[-1] ** 0.5)
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(weights.float(), v.float())
    return out.to(x.dtype), weights


def mha_apply(p: MultiHeadAttention, x: torch.Tensor, n_head: int = 1,
              mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, input_dim] -> (output [B, L, feature_dim],
    weights [B, n_head, L, L]). Positions where ``mask == 0`` get the score
    -10000 before the softmax."""
    q = linear_apply(p.w_q, x)
    k = linear_apply(p.w_k, x)
    v = linear_apply(p.w_v, x)
    b, l, d = q.shape
    d_head = d // n_head

    def split(t):
        return t.reshape(b, l, n_head, d_head).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = _scores(q, k, 1.0 / d_head ** 0.5)
    if mask is not None:
        scores = scores.masked_fill(mask == 0, -10000.0)
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(weights.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, l, d)
    return linear_apply(p.w_concat, out), weights
