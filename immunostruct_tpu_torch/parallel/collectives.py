"""Collectives over a named mesh axis, and the hand-written ring all-reduce
(counterpart of ``immunostruct_tpu/parallel/collectives.py``).

Two tiers, as in JAX:

1. ``psum``/``pmean``/``pmax``/``all_gather``/``ppermute_ring`` over the
   process group of an axis of the active ``Mesh`` (``with mesh:``, or
   ``mesh=``): ``torch.distributed``'s all-reduce, all-gather and
   point-to-point hops.
2. ``ring_all_reduce``: the reduce-scatter then all-gather ring built from
   ``ppermute_ring`` hops alone, on JAX's schedule step for step (pad to a
   multiple of n; at round t send chunk (i - t) mod n and accumulate chunk
   (i - t - 1) mod n; then circulate ownership). f32 addition is
   commutative and the association order is the schedule's, so it gives
   the JAX ring's bits on the same per-shard inputs.

gloo's collectives take CUDA tensors, but its point-to-point ops hand the
device pointer to the TCP transport, which fails ("Bad address", or the
process aborts) (``GLOO_CUDA_OPS``, read on the H100 under torch 2.11
with ``scripts/gloo_cuda_ops.py``, PERF.md). For an op outside that set on a
gloo group this module copies a CUDA tensor into pinned host memory, runs
the op there and copies the result back; it decides from the group's
backend and the tensor's device, and says so once an op.

The autograd ``Function``s the model-parallel and data-parallel paths
differentiate through: ``copy_to_group`` (identity; its adjoint sums over
the axis), ``sum_over_group`` (sums over the axis; its adjoint is the
identity), the Megatron pair's f and g, and ``gather_rows`` (all-gather of
the batch rows; its adjoint sums the ranks' gradients and keeps this
rank's rows).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from immunostruct_tpu_torch.parallel.mesh import Mesh, current_mesh

# the ops of this module that gloo runs on CUDA tensors (PERF.md:
# scripts/gloo_cuda_ops.py on the H100, torch 2.11); send/recv is staged
# through host memory
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather"})
_SAID: set = set()


def _axis(axis_name: str, mesh: Optional[Mesh]):
    mesh = mesh if mesh is not None else current_mesh()
    return mesh, mesh.group(axis_name), mesh.size(axis_name)


def staged(op: str, group, tensor: torch.Tensor) -> bool:
    """Whether ``op`` on ``tensor`` runs through host memory: a CUDA tensor
    on a gloo group, for an op outside ``GLOO_CUDA_OPS``."""
    if not (tensor.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_OPS):
        return False
    if op not in _SAID:
        _SAID.add(op)
        print(f"collectives: gloo has no CUDA {op}; staging it through "
              "pinned host buffers", flush=True)
    return True


def _host_buffer(t: torch.Tensor) -> torch.Tensor:
    """A host tensor shaped like ``t``, pinned when ``t`` is on a CUDA
    device (a CPU tensor staged on purpose has no device to pin for)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    buf = _host_buffer(t)
    buf.copy_(t)
    return buf


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In place over ``group``."""
    dist.all_reduce(t, op=op, group=group)


def psum(x: torch.Tensor, axis_name: str = "data",
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum across the named axis (a new tensor; no gradient)."""
    _, group, n = _axis(axis_name, mesh)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if n > 1 or dist.is_initialized():
        _all_reduce(out, group)
    return out


def pmean(x: torch.Tensor, axis_name: str = "data",
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    _, _, n = _axis(axis_name, mesh)
    return psum(x, axis_name, mesh) / n


def pmax(x: torch.Tensor, axis_name: str = "data",
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    _, group, n = _axis(axis_name, mesh)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if n > 1 or dist.is_initialized():
        _all_reduce(out, group, dist.ReduceOp.MAX)
    return out


def all_gather(x: torch.Tensor, axis_name: str = "data", axis: int = 0,
               tiled: bool = True, mesh: Optional[Mesh] = None,
               stage: Optional[bool] = None) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along ``axis``
    (``tiled``) or stacked on a new one. ``stage`` forces (True) or
    forbids (False) the trip through host memory; None decides from the
    group and the tensor."""
    _, group, n = _axis(axis_name, mesh)
    x = x.detach().contiguous()
    if n == 1 and not dist.is_initialized():
        parts = [x]
    else:
        if stage is None:
            stage = staged("all_gather", group, x)
        src = _to_host(x) if stage else x
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        if stage:
            parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, axis)


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             src: Optional[int], group, like: torch.Tensor,
             stage: Optional[bool] = None) -> Optional[torch.Tensor]:
    """Send ``send`` to global rank ``dst`` and receive a tensor shaped
    like ``like`` from global rank ``src`` (None: no send, no receive), as
    one batch of point-to-point ops. Returns the received tensor (None
    without ``src``)."""
    if stage is None:
        stage = staged("send/recv", group, like)
    ops, recv = [], None
    if dst is not None:
        send = send.contiguous()
        buf = _to_host(send) if stage else send
        ops.append(dist.P2POp(dist.isend, buf, dst, group))
    if src is not None:
        recv = (_host_buffer(like) if stage
                else torch.empty(like.shape, dtype=like.dtype,
                                 device=like.device))
        ops.append(dist.P2POp(dist.irecv, recv, src, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if recv is not None and stage:
        recv = recv.to(like.device)
    return recv


def ppermute_ring(x: torch.Tensor, axis_name: str = "data", shift: int = 1,
                  mesh: Optional[Mesh] = None,
                  stage: Optional[bool] = None) -> torch.Tensor:
    """Rotate values around the axis's ring: rank i's ``x`` goes to rank
    (i + shift) mod n (one hop of the ring schedule)."""
    mesh, group, n = _axis(axis_name, mesh)
    if n == 1:
        return x.clone()
    i, ranks = mesh.index(axis_name), mesh.ranks(axis_name)
    return exchange(x, ranks[(i + shift) % n], ranks[(i - shift) % n],
                    group, like=x, stage=stage)


def ring_all_reduce(x: torch.Tensor, axis_name: str = "data",
                    mesh: Optional[Mesh] = None,
                    stage: Optional[bool] = None) -> torch.Tensor:
    """All-reduce (sum) over an explicit unidirectional ring.

    Reduce-scatter: after n-1 hops rank i holds the reduced chunk
    (i + 1) mod n. All-gather: n-1 more hops circulate the reduced chunks.
    Each hop moves size/n elements: 2(n-1)/n of the tensor on the wire per
    rank, the bandwidth-optimal schedule."""
    mesh, _, n = _axis(axis_name, mesh)
    if n == 1:
        return x
    idx = mesh.index(axis_name)
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(n, -1).clone()

    for t in range(n - 1):
        send_i, recv_i = (idx - t) % n, (idx - t - 1) % n
        sent = ppermute_ring(chunks[send_i], axis_name, mesh=mesh,
                             stage=stage)
        chunks[recv_i] = chunks[recv_i] + sent

    for t in range(n - 1):
        send_i, recv_i = (idx + 1 - t) % n, (idx - t) % n
        chunks[recv_i] = ppermute_ring(chunks[send_i], axis_name, mesh=mesh,
                                       stage=stage)

    out = chunks.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def ring_pmean(x: torch.Tensor, axis_name: str = "data",
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    return ring_all_reduce(x, axis_name, mesh) / _axis(axis_name, mesh)[2]


# --------------------------------------------------------------------------
# collectives that autograd differentiates through
# --------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity; the adjoint sums the gradient over the axis (Megatron's
    f: a replicated input whose consumers are split over the axis)."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        ctx.axis = (axis_name, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, *ctx.axis), None, None


class _SumOverGroup(torch.autograd.Function):
    """Sum over the axis; the adjoint is the identity (Megatron's g: every
    rank goes on with the same replicated sum)."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        return psum(x, axis_name, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRows(torch.autograd.Function):
    """All-gather along the leading axis; the adjoint sums the ranks'
    gradients of the gathered tensor and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, axis_name, mesh):
        m, _, _ = _axis(axis_name, mesh)
        ctx.axis, ctx.rows = (axis_name, m), x.shape[0]
        ctx.index = m.index(axis_name)
        return all_gather(x, axis_name, mesh=m)

    @staticmethod
    def backward(ctx, g):
        g = psum(g, *ctx.axis)
        i, r = ctx.index, ctx.rows
        return g[i * r:(i + 1) * r], None, None


def copy_to_group(x, axis_name: str, mesh: Optional[Mesh] = None):
    return _CopyToGroup.apply(x, axis_name, mesh if mesh is not None
                              else current_mesh())


def sum_over_group(x, axis_name: str, mesh: Optional[Mesh] = None):
    return _SumOverGroup.apply(x, axis_name, mesh if mesh is not None
                               else current_mesh())


def gather_rows(x, axis_name: str = "data", mesh: Optional[Mesh] = None):
    return _GatherRows.apply(x, axis_name, mesh if mesh is not None
                             else current_mesh())


# --------------------------------------------------------------------------
# gradient reductions of a training step: one flat buffer each
# --------------------------------------------------------------------------

def _flat(tensors: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: list) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def mean_gradients(params, loss: torch.Tensor, axis_name: str = "data",
                   mesh: Optional[Mesh] = None,
                   reduce: str = "psum") -> torch.Tensor:
    """Mean the parameters' gradients (those that have one) and ``loss``
    over the axis, in place: one flat buffer, all-reduced ('psum') or sent
    round the ring ('ring'), then divided by the axis size. Returns the
    mean loss."""
    mesh, group, n = _axis(axis_name, mesh)
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 and not dist.is_initialized():
        return loss
    with torch.no_grad():
        flat = _flat(grads + [loss.detach().to(grads[0].dtype)]
                     if grads else [loss.detach()])
        if reduce == "ring":
            flat = ring_all_reduce(flat, axis_name, mesh)
        elif reduce == "psum":
            _all_reduce(flat, group)
        else:
            raise ValueError(f"reduce must be 'psum' or 'ring', not "
                             f"{reduce!r}")
        flat /= n
        _unflat(flat[:-1], grads)
    return flat[-1].to(loss.dtype)


def sum_gradients(params, axis_name: str, mesh: Optional[Mesh] = None
                  ) -> None:
    """Sum the parameters' gradients over the axis, in place, a missing
    gradient counting as zeros (each rank then holds every parameter's
    gradient): reassembles what the axis split (``parallel/mp.py``)."""
    mesh, group, n = _axis(axis_name, mesh)
    params = list(params)
    if not params or (n == 1 and not dist.is_initialized()):
        return
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        flat = _flat(grads)
        _all_reduce(flat, group)
        _unflat(flat, grads)
