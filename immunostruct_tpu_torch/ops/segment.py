"""Masked segment scatter and gather, B8 (counterpart of
``immunostruct_tpu/ops/experimental/pallas_segment.py``): the aggregation
of ``aggregation='pallas'`` (ops/egnn.py) and its backward.

With ``valid[b, e] = mask[b, e] and 0 <= idx[b, e] < N``:

    scatter  out[b, n] = sum of m[b, e] over the valid e with idx[b, e] == n
             [B, E, C] -> [B, N, C]; summed in f32, rounded once to m's dtype
             (``segment_scatter_rounded``: in edge order, each add rounded
             to m's dtype, as XLA sums the transpose of a row gather; the
             backward of 'pallas''s gathers, ops/egnn.py)
    gather   out[b, e] = h[b, idx[b, e]] where valid, else 0
             [B, N, C] -> [B, E, C]; exact (one non-zero term)

Each is the other's transpose, so each is the other's VJP
(``SegmentScatter``, ``SegmentGather``), as in ``pallas_segment.py``'s
custom VJPs. An index outside [0, N) contributes nothing, masked or not: on
the TPU no one-hot row matches it; on the card it would address memory out
of bounds, so the kernels test it before any load or store.

``segment_scatter`` and ``segment_gather`` are the launch wrappers, each a
``torch.library`` op (``immunostruct::segment_scatter``,
``immunostruct::segment_gather``) that ``torch.export`` traces: a CUDA
tensor launches csrc/segment.cu or raises, a CPU tensor takes the plain
version (``segment_scatter_reference``, ``segment_gather_reference``).
Their ``.launches`` count the kernels' launches, inside the ops. The JAX
wrappers take E as a multiple of 128 (``_pick_tile``); the kernels take any
E, and the EGNN stack keeps JAX's admission rule
(``ops/egnn.py::check_pallas``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from immunostruct_tpu_torch.ops.edge import _on_cuda, define_op, hopper


def _valid(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    return mask & (idx >= 0) & (idx < n)


def _rows(idx: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E] node indices -> [B*E] rows of a [B*N, C] view; an edge that is
    not valid points at row 0 of its graph (and is masked by the caller)."""
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (torch.where(valid, idx, 0).long() + offs).reshape(-1)


def narrow(dtype: torch.dtype) -> bool:
    """A floating dtype narrower than f32 (bf16, f16): one in which the JAX
    package's scatter sums round at every add."""
    return dtype not in (torch.float32, torch.float64)


def row_passes(idx: torch.Tensor, num: int) -> tuple:
    """The passes of ``sum_rows_in_order`` for idx [R] (a row with idx < 0
    left out): (the rows in pass order, the rows of each pass, left-out
    rows first). Pass k holds each index's k-th row in row order. The
    counts are read on the host (one sync)."""
    r = idx.shape[0]
    key = torch.where(idx >= 0, idx, num)        # left-out rows sort last
    order = torch.argsort(key, stable=True)
    ranked = key[order]
    at = torch.arange(r, device=idx.device)
    first = torch.ones_like(ranked, dtype=torch.bool)
    first[1:] = ranked[1:] != ranked[:-1]
    rank = torch.empty_like(at)
    rank[order] = at - torch.cummax(torch.where(first, at, 0), 0).values
    rank = torch.where(idx >= 0, rank, -1)
    return torch.argsort(rank, stable=True), torch.bincount(rank + 1).tolist()


def sum_rows_in_order(idx: torch.Tensor, rows: torch.Tensor, num: int,
                      passes: Optional[tuple] = None) -> torch.Tensor:
    """[num, C]: rows [R, C] summed at idx [R] (a row with idx < 0 left
    out) in row order from +0, each add rounded to rows' dtype: XLA's
    scatter-add on the CPU (JAX's ``.at[].add`` and the transpose of
    ``take_along_axis``). torch's ``index_add_`` in bf16 sums in f32 on the
    CPU and by atomics on the card. Pass k adds each index's k-th row: no
    two rows of a pass meet at one index, so each add is one rounding and
    the passes keep row order on any device. ``passes``: ``row_passes(idx,
    num)``, computed here where not given; its counts are read on the host,
    so a CUDA graph cannot hold this (``ops/egnn.py::host_counted_sums``)."""
    r, c = rows.shape
    out = torch.zeros(num, c, dtype=rows.dtype, device=rows.device)
    if r == 0:
        return out
    by_pass, sizes = passes if passes is not None else row_passes(idx, num)
    idx, rows = idx[by_pass], rows[by_pass]
    start = sizes[0]
    for size in sizes[1:]:
        out.index_add_(0, idx[start:start + size], rows[start:start + size])
        start += size
    return out


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


def segment_scatter_rounded_reference(idx: torch.Tensor, mask: torch.Tensor,
                                      m: torch.Tensor,
                                      num_nodes: int) -> torch.Tensor:
    """Plain PyTorch version of the rounded scatter: [B, N, C] in m's dtype,
    the valid edges' rows summed in edge order from +0, each add rounded to
    m's dtype (``sum_rows_in_order``). In f32 on the CPU that is
    ``segment_scatter_reference``'s sum (``index_add_`` adds in edge order
    there), which it takes."""
    if m.device.type == "cpu" and not narrow(m.dtype):
        return segment_scatter_reference(idx, mask, m, num_nodes)
    b, e, c = m.shape
    valid = _valid(idx, mask, num_nodes)
    rows = torch.where(valid, _rows(idx, valid, num_nodes).reshape(b, e),
                       -1).reshape(-1)
    return sum_rows_in_order(rows, m.reshape(b * e, c),
                             b * num_nodes).reshape(b, num_nodes, c)


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

# csrc/segment.cu's limits: nodes a scatter CTA (kMaxRange), edges a gather
# CTA (kMaxChunk)
SCATTER_MAX_RANGE = 1024
GATHER_MAX_CHUNK = 2048


@functools.lru_cache(maxsize=None)
def scatter_range_nodes(n: int, b: int, slots: int) -> int:
    """Nodes a scatter CTA takes (one CTA per (graph, node range)): as many
    ranges as the card's ``slots`` (CTAs it holds at once) take in one wave,
    each at least 8 nodes (one a warp) where the graph has them and at most
    SCATTER_MAX_RANGE. A CTA sorts its graph's whole edge list whatever its
    range, so a second wave would cost that sort again."""
    ranges = min(max(1, n // 8), max(1, slots // b))
    return min(-(-n // ranges), SCATTER_MAX_RANGE)


@functools.lru_cache(maxsize=None)
def gather_chunk_edges(e: int, b: int, sms: int) -> int:
    """Edges a gather CTA writes (one CTA per (graph, edge chunk)): as many
    chunks as give four CTAs an SM, each at least 32 edges where the graph
    has them, a multiple of 8 (so that a chunk's run starts on 16 bytes in
    bf16 where its graph's does) and at most GATHER_MAX_CHUNK."""
    chunks = min(-(-4 * sms // b), max(1, e // 32))
    size = max(1, -(-e // chunks))
    return min(-(-size // 8) * 8, GATHER_MAX_CHUNK)


@functools.lru_cache(maxsize=None)
def _lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("segment")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.segment_scatter, lib.segment_scatter_rounded,
               lib.segment_gather):
        fn.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        fn.restype = i32
    lib.segment_scatter_smem_bytes.argtypes = [i32, i32]
    lib.segment_scatter_smem_bytes.restype = ctypes.c_longlong
    lib.segment_set_smem_limit.argtypes = [i32]
    lib.segment_scatter_ctas_per_sm.argtypes = [i32, i32, i32]
    for fn in (lib.segment_set_smem_limit, lib.segment_scatter_ctas_per_sm):
        fn.restype = i32
    lib.devices, lib.answers = {}, {}
    return lib


def _device(lib, device: int) -> tuple:
    """(SMs, shared memory a block may opt in to) of card ``device`` (the
    current one), which must be a Hopper; the first time for this library
    and card, also lets the scatter kernels take that much shared
    memory."""
    got = lib.devices.get(device)
    if got is None:
        props = hopper(device, "segment")
        optin = props.shared_memory_per_block_optin
        rc = lib.segment_set_smem_limit(optin)
        if rc != 0:
            raise RuntimeError(f"segment: cudaFuncSetAttribute failed with "
                               f"CUDA error {rc}")
        got = lib.devices[device] = (props.multi_processor_count, optin)
    return got


def _stream(card: int) -> int:
    """The current CUDA stream of ``card``, as the raw handle a launch
    takes: PyTorch's own getter, which builds no Stream object as
    ``torch.cuda.current_stream(...).cuda_stream`` does on every call."""
    return torch._C._cuda_getCurrentRawStream(card)


def _query(lib, entry: str, *args, card=None) -> int:
    """The C helper ``entry``'s answer for ``args`` (shared-memory bytes,
    CTAs an SM), cached, per ``card`` where the answer depends on it."""
    key = (entry, card, *args)
    got = lib.answers.get(key)
    if got is None:
        got = lib.answers[key] = getattr(lib, entry)(*args)
    return got


def _check(name: str, idx, mask, data, rows: int):
    """Raise ValueError, naming the first fault, unless idx [B, E] int32,
    mask [B, E] bool and data [B, rows, C] f32 or bf16 are contiguous and
    on one device, with B and C at least 1."""
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} kernel takes float32 or bfloat16 data, "
                         f"got {data.dtype}")
    if data.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"{name}: idx [B, E] and data [B, {rows}, C] "
                         f"expected, got {tuple(idx.shape)} and "
                         f"{tuple(data.shape)}")
    b, e = idx.shape
    want = (("idx", idx, torch.int32, (b, e)),
            ("mask", mask, torch.bool, (b, e)),
            ("data", data, data.dtype, (b, rows, data.shape[2])))
    for arg, t, dt, shape in want:
        if t.device != data.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, the data on "
                             f"{data.device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, the kernel "
                             f"takes {dt}")
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if b == 0 or data.shape[2] == 0:
        raise ValueError(f"{name}: empty batch or channels")


def _scatter_launch(idx, mask, m, num_nodes: int,
                    rounded: bool = False) -> torch.Tensor:
    """Check the operands and launch the scatter kernel (``rounded``: each
    add rounded to m's dtype) on m's card; raise if it does not fit or
    does not launch. Counts nothing."""
    _check("segment_scatter", idx, mask, m, idx.shape[1])
    b, e, c = m.shape
    lib = _lib()
    card = m.device.index
    with torch.cuda._DeviceGuard(card):
        sms, optin = _device(lib, card)
        if num_nodes < 1:
            raise ValueError(f"segment_scatter: N={num_nodes} nodes")
        bf16 = m.dtype == torch.bfloat16
        # CTAs an SM at the smallest range (shared memory grows little with R)
        ctas = _query(lib, "segment_scatter_ctas_per_sm", e, 8, bf16,
                      card=card)
        if ctas < 0:
            raise RuntimeError(f"segment_scatter: the occupancy query failed "
                               f"with CUDA error {-ctas}")
        r = scatter_range_nodes(num_nodes, b, max(1, ctas) * sms)
        smem = _query(lib, "segment_scatter_smem_bytes", e, r)
        if smem > optin:
            raise ValueError(
                f"segment_scatter kernel needs {smem} B of shared memory for "
                f"E={e} (R={r} nodes a CTA); the card allows {optin} B per "
                "block")
        out = m.new_empty((b, num_nodes, c))
        entry = (lib.segment_scatter_rounded if rounded
                 else lib.segment_scatter)
        rc = entry(idx.data_ptr(), mask.data_ptr(), m.data_ptr(),
                   out.data_ptr(), b, e, num_nodes, c, r, bf16, _stream(card))
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
    bf16 = h.dtype == torch.bfloat16
    card = h.device.index
    with torch.cuda._DeviceGuard(card):
        sms, _ = _device(lib, card)
        out = h.new_empty((b, e, c))
        rc = lib.segment_gather(
            idx.data_ptr(), mask.data_ptr(), h.data_ptr(), out.data_ptr(), b,
            e, n, c, gather_chunk_edges(e, b, sms), bf16, _stream(card))
    if rc != 0:
        raise RuntimeError(f"segment_gather launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, N={n}, C={c})")
    return out


def _count_scatter_launch() -> None:
    """One more launch of B8's scatter kernel, either instance (the op's
    and ``segment_scatter_rounded``'s): ``segment_scatter.launches``."""
    segment_scatter.launches += 1


def _scatter_cuda(idx, mask, m, num_nodes):
    out = _scatter_launch(idx, mask, m, num_nodes)
    _count_scatter_launch()
    return out


def _scatter_fake(idx, mask, m, num_nodes):
    return m.new_empty((m.shape[0], num_nodes, m.shape[2]))


def _gather_cuda(idx, mask, h):
    out = _gather_launch(idx, mask, h)
    segment_gather.launches += 1
    return out


def _gather_fake(idx, mask, h):
    return h.new_empty((h.shape[0], idx.shape[1], h.shape[2]))


# the two kernels as ``torch.library`` ops: the plain version on CPU
# tensors, the kernel on CUDA tensors (any other device has no kernel), a
# fake that ``torch.export`` traces with. The counts sit in the CUDA
# implementations, so an exported program's launches are counted too.
_SCATTER_OP = define_op(
    "segment_scatter(Tensor idx, Tensor mask, Tensor m, SymInt num_nodes) "
    "-> Tensor",
    cpu=segment_scatter_reference, cuda=_scatter_cuda, fake=_scatter_fake)
_GATHER_OP = define_op(
    "segment_gather(Tensor idx, Tensor mask, Tensor h) -> Tensor",
    cpu=segment_gather_reference, cuda=_gather_cuda, fake=_gather_fake)


def segment_scatter(idx: torch.Tensor, mask: torch.Tensor, m: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """B8's scatter: [B, N, C] in m's dtype (module docstring), the op
    ``immunostruct::segment_scatter``.

    CUDA tensors launch csrc/segment.cu or raise; CPU tensors go through
    ``segment_scatter_reference``. ``segment_scatter.launches`` counts the
    kernel's launches."""
    _on_cuda("segment_scatter", m)
    return _SCATTER_OP(idx, mask, m, num_nodes)


segment_scatter.launches = 0


def segment_scatter_rounded(idx: torch.Tensor, mask: torch.Tensor,
                            m: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """B8's scatter with each add rounded to m's dtype (module docstring).
    CUDA tensors launch csrc/segment.cu's ``segment_scatter_rounded`` (the
    scatter kernel's other instance: counted in
    ``segment_scatter.launches``) or raise; CPU tensors go through
    ``segment_scatter_rounded_reference``. Not an op: only the backward of
    'pallas''s gathers calls it."""
    if not _on_cuda("segment_scatter_rounded", m):
        return segment_scatter_rounded_reference(idx, mask, m, num_nodes)
    out = _scatter_launch(idx, mask, m, num_nodes, rounded=True)
    _count_scatter_launch()
    return out


def segment_gather(idx: torch.Tensor, mask: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """B8's gather: [B, E, C] in h's dtype (module docstring), the op
    ``immunostruct::segment_gather``.

    CUDA tensors launch csrc/segment.cu or raise; CPU tensors go through
    ``segment_gather_reference``. ``segment_gather.launches`` counts the
    kernel's launches."""
    _on_cuda("segment_gather", h)
    return _GATHER_OP(idx, mask, h)


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
