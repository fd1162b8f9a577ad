"""Masked segment scatter and gather, B8 (counterpart of
``immunostruct_tpu/ops/experimental/pallas_segment.py``): the aggregation
of ``aggregation='pallas'`` (ops/egnn.py) and its backward.

With ``valid[b, e] = mask[b, e] and 0 <= idx[b, e] < N``:

    scatter  out[b, n] = sum of m[b, e] over the valid e with idx[b, e] == n
             [B, E, C] -> [B, N, C]; summed in f32, rounded once to m's dtype
    gather   out[b, e] = h[b, idx[b, e]] where valid, else 0
             [B, N, C] -> [B, E, C]; exact (one non-zero term)

Each is the other's transpose, so each is the other's VJP
(``SegmentScatter``, ``SegmentGather``), as in ``pallas_segment.py``'s
custom VJPs. An index outside [0, N) contributes nothing, masked or not: on
the TPU no one-hot row matches it; on the card it would address memory out
of bounds, so the kernels test it before any load or store.

``segment_scatter`` and ``segment_gather`` are the launch wrappers: a CUDA
tensor launches csrc/segment.cu or raises, a CPU tensor takes the plain
version (``segment_scatter_reference``, ``segment_gather_reference``).
Their ``.launches`` count the kernels' launches. The JAX wrappers take E as
a multiple of 128 (``_pick_tile``); the kernels take any E, and the EGNN
stack keeps JAX's admission rule (``ops/egnn.py::check_pallas``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from immunostruct_tpu_torch.ops.edge import _on_cuda, hopper


def _valid(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    return mask & (idx >= 0) & (idx < n)


def _rows(idx: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E] node indices -> [B*E] rows of a [B*N, C] view; an edge that is
    not valid points at row 0 of its graph (and is masked by the caller)."""
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (torch.where(valid, idx, 0).long() + offs).reshape(-1)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def segment_scatter_reference(idx: torch.Tensor, mask: torch.Tensor,
                              m: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain PyTorch version of the scatter: [B, N, C] in m's dtype, the
    valid edges' rows summed in f32 (``index_add_``; in edge order on the
    CPU) and rounded once."""
    b, e, c = m.shape
    valid = _valid(idx, mask, num_nodes)
    msgs = torch.where(valid[..., None], m.float(), 0.0)
    acc = torch.zeros(b * num_nodes, c, dtype=torch.float32, device=m.device)
    acc.index_add_(0, _rows(idx, valid, num_nodes), msgs.reshape(b * e, c))
    return acc.reshape(b, num_nodes, c).to(m.dtype)


def segment_gather_reference(idx: torch.Tensor, mask: torch.Tensor,
                             h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather: [B, E, C] in h's dtype."""
    b, n, c = h.shape
    valid = _valid(idx, mask, n)
    rows = h.reshape(b * n, c).index_select(0, _rows(idx, valid, n))
    out = rows.reshape(b, idx.shape[1], c)
    return torch.where(valid[..., None], out,
                       torch.zeros((), dtype=h.dtype, device=h.device))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("segment")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.segment_scatter, lib.segment_gather):
        fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.segment_scatter_smem_bytes.argtypes = [i32]
    lib.segment_scatter_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(name: str, idx, mask, data, rows: int):
    """Raise ValueError unless idx [B, E] int32, mask [B, E] bool and data
    [B, rows, C] f32 or bf16 are contiguous and on one device."""
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} kernel takes float32 or bfloat16 data, "
                         f"got {data.dtype}")
    if data.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"{name}: idx [B, E] and data [B, {rows}, C] "
                         f"expected, got {tuple(idx.shape)} and "
                         f"{tuple(data.shape)}")
    b, e = idx.shape
    want = {"idx": (idx, torch.int32, (b, e)),
            "mask": (mask, torch.bool, (b, e)),
            "data": (data, data.dtype, (b, rows, data.shape[2]))}
    for arg, (t, dt, shape) in want.items():
        if t.device != data.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the data on "
                             f"{data.device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, the kernel "
                             f"takes {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if b == 0 or data.shape[2] == 0:
        raise ValueError(f"{name}: empty batch or channels")


def _scatter_launch(idx, mask, m, num_nodes: int) -> torch.Tensor:
    """Check the operands and launch the scatter kernel on m's card; raise
    if it does not fit or does not launch. Counts nothing."""
    _check("segment_scatter", idx, mask, m, idx.shape[1])
    b, e, c = m.shape
    lib = _lib()
    with torch.cuda.device(m.device):
        props = hopper(m.device, "segment")
        smem = lib.segment_scatter_smem_bytes(num_nodes)
        if num_nodes < 1 or smem > props.shared_memory_per_block_optin:
            raise ValueError(
                f"segment_scatter kernel needs {smem} B of shared memory for "
                f"N={num_nodes}; the card allows "
                f"{props.shared_memory_per_block_optin} B per block")
        out = torch.empty(b, num_nodes, c, dtype=m.dtype, device=m.device)
        stream = torch.cuda.current_stream(m.device).cuda_stream
        rc = lib.segment_scatter(
            idx.data_ptr(), mask.data_ptr(), m.data_ptr(), out.data_ptr(), b,
            e, num_nodes, c, int(m.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"segment_scatter launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, N={num_nodes}, C={c})")
    return out


def _gather_launch(idx, mask, h) -> torch.Tensor:
    """Check the operands and launch the gather kernel on h's card; raise
    if it does not launch. Counts nothing."""
    b, n, c = h.shape
    _check("segment_gather", idx, mask, h, n)
    e = idx.shape[1]
    lib = _lib()
    with torch.cuda.device(h.device):
        hopper(h.device, "segment")
        out = torch.empty(b, e, c, dtype=h.dtype, device=h.device)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.segment_gather(
            idx.data_ptr(), mask.data_ptr(), h.data_ptr(), out.data_ptr(), b,
            e, n, c, int(h.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"segment_gather launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, N={n}, C={c})")
    return out


def segment_scatter(idx: torch.Tensor, mask: torch.Tensor, m: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """B8's scatter: [B, N, C] in m's dtype (module docstring).

    CUDA tensors launch csrc/segment.cu or raise; CPU tensors go through
    ``segment_scatter_reference``. ``segment_scatter.launches`` counts the
    kernel's launches."""
    if not _on_cuda("segment_scatter", m):
        return segment_scatter_reference(idx, mask, m, num_nodes)
    out = _scatter_launch(idx, mask, m, num_nodes)
    segment_scatter.launches += 1
    return out


segment_scatter.launches = 0


def segment_gather(idx: torch.Tensor, mask: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """B8's gather: [B, E, C] in h's dtype (module docstring).

    CUDA tensors launch csrc/segment.cu or raise; CPU tensors go through
    ``segment_gather_reference``. ``segment_gather.launches`` counts the
    kernel's launches."""
    if not _on_cuda("segment_gather", h):
        return segment_gather_reference(idx, mask, h)
    out = _gather_launch(idx, mask, h)
    segment_gather.launches += 1
    return out


segment_gather.launches = 0


class SegmentScatter(torch.autograd.Function):
    """``segment_scatter`` with its VJP: the gather of the cotangent
    (``pallas_segment.py:_segment_scatter_bwd``). Gradient for m only."""

    @staticmethod
    def forward(ctx, idx, mask, m, num_nodes):
        ctx.save_for_backward(idx, mask)
        return segment_scatter(idx, mask, m, num_nodes)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return None, None, segment_gather(idx, mask, g.contiguous()), None


class SegmentGather(torch.autograd.Function):
    """``segment_gather`` with its VJP: the scatter of the cotangent into
    N rows (``pallas_segment.py:_segment_gather_bwd``). Gradient for h
    only."""

    @staticmethod
    def forward(ctx, idx, mask, h):
        ctx.save_for_backward(idx, mask)
        ctx.num_nodes = h.shape[1]
        return segment_gather(idx, mask, h)

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        return None, None, segment_scatter(idx, mask, g.contiguous(),
                                           ctx.num_nodes)
