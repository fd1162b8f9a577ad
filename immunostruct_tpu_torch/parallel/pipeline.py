"""Pipeline parallelism: the GPipe schedule over the 'pipe' axis
(counterpart of ``immunostruct_tpu/parallel/pipeline.py``).

As with ``parallel/tensor.py``, this exists so that the framework scales
past the flagship's size: a stack of shape-homogeneous layers (the EGNN
hidden convs) split over ranks, one stage a rank.

The schedule, on stage s of S for M microbatches, is JAX's: S + M - 1
ticks; at tick t stage 0 feeds microbatch t and every other stage the
activation it received at the end of tick t - 1, so stage s works on
microbatch t - s; then every activation hops one stage right; the last
stage's outputs are collected, and the final window is summed over the
axis to every stage (the other stages contribute zeros). Per-microbatch
``aux`` (the edge data) does not hop: each stage reads the rows of the
microbatch it works on. Bubbles carry zeros, and a stage runs its layer
only on real microbatches (the layer's output in a bubble is masked in
JAX; here it is never computed), so a stage runs its layer M times a
pass. The pipe is a chain: the last stage's activation does not wrap
round to stage 0, which would ignore it.

The backward is the schedule reversed, written out in ``_GPipe``: the
adjoint of a hop is the reverse hop (the gradient of the activation a
stage received goes back to the stage that sent it), the adjoint of the
final sum hands the gradient to the last stage, and the gradient of the
input, which only stage 0 reads, is summed over the axis so that every
rank holds it. Autograd's engine orders its nodes by readiness, not by
tick, so the hops' adjoints run inside the schedule's own backward, which
keeps every pair of stages' messages in one order (NCCL matches
point-to-point messages by order). A stage's gradients land on its own
layer's parameters; summing the parameters' gradients over the axis
reassembles the stack's (``parallel/trainer.py::make_mp_train_step``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from immunostruct_tpu_torch.parallel.collectives import exchange, psum
from immunostruct_tpu_torch.parallel.mesh import Mesh, current_mesh


def stage_params(stacked, axis_name: str = "pipe",
                 mesh: Optional[Mesh] = None):
    """This rank's stage of ``stacked``: a sequence of per-stage parameters
    (a ``ModuleList``, a list) or a tensor, or a mapping of tensors,
    stacked on a leading [S] axis."""
    mesh = mesh if mesh is not None else current_mesh()
    i = mesh.index(axis_name)
    if isinstance(stacked, dict):
        return {k: stage_params(v, axis_name, mesh) for k, v in
                stacked.items()}
    return stacked[i]


def _leaves(params) -> list:
    """The tensors of a stage's parameters that take a gradient."""
    if params is None:
        return []
    if isinstance(params, torch.nn.Module):
        out = list(params.parameters())
    elif isinstance(params, torch.Tensor):
        out = [params]
    elif isinstance(params, dict):
        out = [t for v in params.values() for t in _leaves(v)]
    elif isinstance(params, (list, tuple)):
        out = [t for v in params for t in _leaves(v)]
    else:
        out = []
    return [t for t in out if t.requires_grad]


class _Schedule:
    """One GPipe pass on this rank: the forward ticks, and the backward
    ticks in reverse."""

    def __init__(self, layer_fn, params, aux, n_micro, axis_name, mesh):
        self.layer_fn, self.params, self.aux = layer_fn, params, aux
        self.m, self.axis, self.mesh = n_micro, axis_name, mesh
        self.s = mesh.index(axis_name)
        self.n = mesh.size(axis_name)
        self.ranks = mesh.ranks(axis_name)
        self.group = mesh.group(axis_name)
        self.saved = {}

    def _call(self, cur, m):
        if self.aux is None:
            return self.layer_fn(self.params, cur)
        aux_m = tuple(a[m] for a in self.aux)
        return self.layer_fn(self.params, cur, aux_m)

    def forward(self, x: torch.Tensor, record: bool) -> torch.Tensor:
        s, n, m_count = self.s, self.n, self.m
        micro = x.reshape((m_count, -1) + tuple(x.shape[1:]))
        like = micro[0]
        finals = torch.zeros_like(micro)
        recv = None
        for t in range(n + m_count - 1):
            m = t - s
            out = None
            if 0 <= m < m_count:
                cur = micro[m] if s == 0 else recv
                if record:
                    with torch.enable_grad():
                        cur = cur.detach().requires_grad_(True)
                        out = self._call(cur, m)
                    self.saved[t] = (cur, out)
                else:
                    out = self._call(cur, m)
                if s == n - 1:
                    finals[m] = out.detach()
            send = out is not None and s < n - 1
            recv_from = s > 0 and 0 <= t - (s - 1) < m_count
            recv = exchange(out.detach() if send else None,
                            self.ranks[s + 1] if send else None,
                            self.ranks[s - 1] if recv_from else None,
                            self.group, like=like)
        return psum(finals, self.axis, self.mesh).reshape(x.shape)

    def backward(self, g: torch.Tensor, want_x: bool):
        s, n, m_count = self.s, self.n, self.m
        gm = g.reshape((m_count, -1) + tuple(g.shape[1:]))
        like = gm[0]
        grad_x = torch.zeros_like(gm) if want_x else None
        grads = [None] * len(_leaves(self.params))
        for t in reversed(range(n + m_count - 1)):
            m = t - s
            if not 0 <= m < m_count:
                continue
            if s == n - 1:
                g_out = gm[m]
            else:
                g_out = exchange(None, None, self.ranks[s + 1], self.group,
                                 like=like)
            cur, out = self.saved.pop(t)
            inputs = [cur] + _leaves(self.params)
            got = torch.autograd.grad(out, inputs, g_out.to(out.dtype),
                                      allow_unused=True)
            for k, gk in enumerate(got[1:]):
                if gk is not None:
                    grads[k] = gk if grads[k] is None else grads[k] + gk
            g_cur = got[0] if got[0] is not None else torch.zeros_like(cur)
            if s == 0:
                if want_x:
                    grad_x[m] = g_cur
            else:
                exchange(g_cur, self.ranks[s - 1], None, self.group,
                         like=like)
        if want_x:
            grad_x = psum(grad_x, self.axis, self.mesh)
        return grad_x, grads


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, schedule, anchor, *params):
        ctx.schedule = schedule
        return schedule.forward(x, record=True)

    @staticmethod
    def backward(ctx, g):
        grad_x, grads = ctx.schedule.backward(g.contiguous(),
                                              ctx.needs_input_grad[0])
        if grad_x is not None:
            grad_x = grad_x.reshape(g.shape)
        return (grad_x, None, None, *grads)


def gpipe_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                n_microbatches: int, axis_name: str = "pipe", aux=None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run ``layer_fn`` S times (one stage a rank of ``axis_name``) over
    ``x``.

    ``layer_fn(params_s, act) -> act`` keeps the activation's shape.
    ``x`` [B, ...] is the same on every rank, B % n_microbatches == 0;
    returns, on every rank, the [B, ...] output of the S stages in turn.
    ``aux``: a tuple of [B, ...] tensors of per-example data every stage
    needs for the microbatch it works on (the EGNN edge lists and masks);
    then ``layer_fn(params_s, act, aux_microbatch)``."""
    mesh = mesh if mesh is not None else current_mesh()
    b = x.shape[0]
    assert b % n_microbatches == 0, (b, n_microbatches)
    mb = b // n_microbatches
    my_params = stage_params(stacked_params, axis_name, mesh)
    aux_micro = None if aux is None else tuple(
        a.reshape((n_microbatches, mb) + tuple(a.shape[1:])) for a in aux)
    schedule = _Schedule(layer_fn, my_params, aux_micro, n_microbatches,
                         axis_name, mesh)
    if torch.is_grad_enabled():
        # every stage takes part in the backward's hops, a stage without
        # parameters too: the anchor makes the output require a gradient
        anchor = torch.empty(0, requires_grad=True)
        return _GPipe.apply(x, schedule, anchor, *_leaves(my_params))
    return schedule.forward(x, record=False)
