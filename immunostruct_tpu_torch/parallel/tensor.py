"""Tensor parallelism: Megatron-style split linear layers over the 'model'
axis (counterpart of ``immunostruct_tpu/parallel/tensor.py``).

A ~6M-parameter model needs no intra-model parallelism (data parallelism
is the production configuration); these exist so that the framework scales
past that point: column- then row-parallel linear pairs with one sum over
the axis per pair.

Contract, on each rank of the axis:

  column-parallel:  w [in, out] split on OUT; y_shard = x @ w_shard + b_shard
                    (features leave split: feed them straight into a
                    row-parallel layer, no collective)
  row-parallel:     w [in, out] split on IN; takes feature-split x,
                    y = sum_model(x_shard @ w_shard) + b
                    (one all-reduce restores the replicated activation)

Weights stay unsharded in the module (the checkpoint layout is unchanged
and one rank is the identity); ``shard_column``/``shard_row`` slice them by
the rank's coordinate, so a weight's gradient lands on the rank's slice
and the rest of it stays zero: summing the gradients over the axis
reassembles it (``parallel/trainer.py::make_mp_train_step``). The input of
a column-parallel layer passes ``copy_to_group`` (its adjoint sums the
ranks' partial input gradients) and the row-parallel sum is
``sum_over_group`` (its adjoint is the identity), so every activation
gradient upstream of a pair is the replicated, whole one.
"""

from __future__ import annotations

from typing import Optional

import torch

from immunostruct_tpu_torch.parallel.collectives import (
    copy_to_group, sum_over_group,
)
from immunostruct_tpu_torch.parallel.mesh import Mesh, current_mesh


def _coord(axis_name: str, mesh: Optional[Mesh]):
    mesh = mesh if mesh is not None else current_mesh()
    return mesh, mesh.size(axis_name), mesh.index(axis_name)


def shard_column(w: torch.Tensor, b: Optional[torch.Tensor], axis_name: str,
                 mesh: Optional[Mesh] = None):
    """This rank's slice of [in, out] weights on OUT (and of the bias)."""
    _, n, i = _coord(axis_name, mesh)
    out = w.shape[1]
    assert out % n == 0, f"out dim {out} not divisible by mesh axis {n}"
    per = out // n
    return (w[:, i * per:(i + 1) * per],
            b[i * per:(i + 1) * per] if b is not None else None)


def shard_row(w: torch.Tensor, axis_name: str, mesh: Optional[Mesh] = None):
    """This rank's slice of [in, out] weights on IN."""
    _, n, i = _coord(axis_name, mesh)
    in_dim = w.shape[0]
    assert in_dim % n == 0, f"in dim {in_dim} not divisible by mesh axis {n}"
    per = in_dim // n
    return w[i * per:(i + 1) * per]


def column_parallel_apply(w, b, x, axis_name: str = "model",
                          mesh: Optional[Mesh] = None):
    """x [B, in] (replicated) -> y_shard [B, out/n] (feature-split); the
    product accumulates in f32 and is cast back to x's dtype."""
    mesh = mesh if mesh is not None else current_mesh()
    w_s, b_s = shard_column(w, b, axis_name, mesh)
    if x.requires_grad:
        x = copy_to_group(x, axis_name, mesh)
    y = torch.matmul(x.float(), w_s.to(x.dtype).float())
    if b_s is not None:
        y = y + b_s.float()
    return y.to(x.dtype)


def row_parallel_apply(w, b, x_shard, axis_name: str = "model",
                       mesh: Optional[Mesh] = None):
    """x_shard [B, in/n] (feature-split) -> y [B, out] (replicated). The
    pair's one sum over the axis happens here, in f32."""
    mesh = mesh if mesh is not None else current_mesh()
    w_s = shard_row(w, axis_name, mesh)
    y = torch.matmul(x_shard.float(), w_s.to(x_shard.dtype).float())
    y = sum_over_group(y, axis_name, mesh)
    if b is not None:
        y = y + b.float()
    return y.to(x_shard.dtype)


def tp_mlp_apply(params, x, activation=torch.relu, axis_name: str = "model",
                 mesh: Optional[Mesh] = None):
    """Two linear layers, column- then row-parallel: one collective.

    ``params``: two layers with ``w [in, out]`` and ``b`` (``ops/nnp.py``'s
    ``Linear``, or mappings with "w" and "b"), unsharded."""
    def wb(p):
        return (p["w"], p.get("b")) if isinstance(p, dict) else (p.w, p.b)

    h = column_parallel_apply(*wb(params[0]), x, axis_name, mesh)
    h = activation(h)
    return row_parallel_apply(*wb(params[1]), h, axis_name, mesh)
