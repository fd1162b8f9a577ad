"""Linear layers and dropout (counterpart of ``immunostruct_tpu/ops/nnp.py``).

``Linear`` keeps the JAX package's parameter layout: ``w`` is ``[in, out]``
and ``b`` is ``[out]``, so a checkpoint's arrays copy over unchanged.
``linear_apply`` has the JAX package's numerics: the weight is cast to the
input's dtype, the product accumulates in f32, the bias is added in f32 and
the result is cast back to the input's dtype. Under bf16 the product runs
on f32 copies of the bf16 operands, which gives exactly that single
rounding at the end.

Initialisation is torch ``nn.Linear``-style, U(-1/sqrt(in), 1/sqrt(in)) for
weight and bias, drawn on the CPU from an explicit ``torch.Generator`` (so a
seed gives the same weights on every device). It does not reproduce the
JAX package's draws; parity tests copy weights over with
``utils/checkpoint.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _uniform(shape, bound: float, generator: torch.Generator,
             device, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device=device, dtype=dtype)


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w [in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 generator: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        bound = 1.0 / in_dim ** 0.5
        self.w = nn.Parameter(_uniform((in_dim, out_dim), bound, generator,
                                       device, dtype))
        if bias:
            self.b = nn.Parameter(_uniform((out_dim,), bound, generator,
                                           device, dtype))
        else:
            self.register_parameter("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_apply(self, x)


def linear_apply(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x.float(), p.w.to(x.dtype).float())
    if p.b is not None:
        y = y + p.b.float()
    return y.to(x.dtype)


def draw(fn, shape, generator: Optional[torch.Generator], device,
         dtype=torch.float32) -> torch.Tensor:
    """Random tensor from ``fn`` (``torch.rand`` / ``torch.randn``) drawn on
    the generator's device, then moved to ``device``."""
    if generator is None:
        raise ValueError("a torch.Generator is required for random draws")
    t = fn(shape, generator=generator, device=generator.device,
           dtype=torch.float32)
    return t.to(device=device, dtype=dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout; a no-op when deterministic or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)
