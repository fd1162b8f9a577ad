"""Linear layers and dropout (counterpart of ``immunostruct_tpu/ops/nnp.py``).

``Linear`` keeps the JAX package's parameter layout: ``w`` is ``[in, out]``
and ``b`` is ``[out]``, so a checkpoint's arrays copy over unchanged.
``linear_apply`` has the JAX package's numerics: the weight is cast to the
input's dtype, the product accumulates in f32, the bias is added in f32 and
the result is cast back to the input's dtype. Under bf16 the product runs
on f32 copies of the bf16 operands, which gives exactly that single
rounding at the end. ``silu`` is ``jax.nn.silu``'s, with its rounding points
in bf16.

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

from immunostruct_tpu_torch.parallel.mesh import current_batch_shard


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


class _Silu(torch.autograd.Function):
    """silu in a floating dtype narrower than f32, op by op in that dtype as
    ``jax.nn.silu`` runs there: x * s with s = 1 / (1 + exp(-x)) (XLA's
    logistic), each of exp, the sum, the reciprocal and the product rounded
    (four roundings, where ``torch.nn.functional.silu`` rounds once); the
    backward as JAX's transpose of its JVP: g * s + (x * g) * (s * (1 - s)),
    each product, the difference and the sum rounded."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s values and gradients: in f32 (and f64) torch's silu,
    which agrees with JAX's to f32 rounding; in a narrower dtype JAX's
    rounding points (``_Silu``), forward and backward."""
    if x.dtype in (torch.float32, torch.float64):
        return nn.functional.silu(x)
    return _Silu.apply(x)


def draw(fn, shape, generator: Optional[torch.Generator], device,
         dtype=torch.float32) -> torch.Tensor:
    """Random tensor from ``fn`` (``torch.rand`` / ``torch.randn``) drawn on
    the generator's device, then moved to ``device``. Under a data-parallel
    ``batch_shard`` (``parallel/mesh.py``) it is drawn at the global
    batch's shape and this rank's rows are kept."""
    if generator is None:
        raise ValueError("a torch.Generator is required for random draws")
    shard = current_batch_shard()
    if shard is not None:
        t = shard.draw(fn, shape, generator)
    else:
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
