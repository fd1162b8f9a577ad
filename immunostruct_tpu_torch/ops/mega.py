"""One EGNN layer's edge half from raw edge indices, forward and backward:
the counterpart of ``immunostruct_tpu/ops/pallas_mega.py`` (``edge_mega``,
its custom VJP ``_edge_mega_fwd``/``_edge_mega_bwd``) and of the shared math
in ``immunostruct_tpu/ops/pallas_edge.py``.

For each graph b and each real edge (s -> d):

    pa, pb  = h @ W1a, h @ W1b                       node-level projections
    xd      = x[s] - x[d];  radial = |xd|^2;  x_hat = xd / (sqrt(radial) + 1e-30)
    a1      = pa[s] + pb[d] + w1r*radial + w1e*ef + b1
    m       = silu(silu(a1) @ W2 + b2)
    cw      = silu(m @ Wc1 + bc1) @ wc2
    out[d] += [m ++ cw * x_hat]                      f32 sum, [B, N, H+3]

Two hand-written Hopper kernels carry it by default (three more carry the
variants below), each with its plain PyTorch version beside it in this
module; the kernels share their device code (csrc/egnn_common.cuh):

  B1  ``edge_mega_fwd``  -> csrc/egnn_mega_fwd.cu  (plain: ``edge_mega_fwd_reference``)
      the forward; for training it also writes the residuals a1 [B,H,E] and
      xd [B,3,E] in the compute dtype. In bf16 its products run on the
      tensor cores and a graph's edges over ``fwd_chunks`` CTAs. Its sums
      at dst are in a fixed order, without atomics: the same bits every
      run.
  B2  ``tail_bwd``       -> csrc/egnn_tail_bwd.cu  (plain: ``tail_bwd_reference``)
      the backward of the edge/coordinate MLP chain from a1/xd and the
      cotangent d_both = g[dst]: d_cat = [d_a1 ; d_xd], d_ef, and the f32
      weight gradients dW2, dWc1, dsmall summed over all edges.

``edge_half_bwd`` finishes the backward at node level in PyTorch (the
gathers' transposes by src/dst, d_h, d_x, dW1ab), as the JAX package
leaves it to XLA einsums. ``EdgeMega`` is the ``torch.autograd.Function``
and ``edge_mega`` the op. B1 is the ``torch.library`` op
``immunostruct::edge_mega_fwd``, which ``torch.export`` traces; the other
kernels are direct launches. A CUDA tensor launches the kernels or raises;
a CPU tensor takes the plain versions. A forward that needs no gradient
(inference) skips the residual stores.

The JAX package's kernel variants, each reached there through a module
global, are per-call options here (``mega_variant``, ``MEGA_VARIANTS``):

  'hybrid'   B1 forward; B2 backward with PyTorch's gather of d_both and
             the node sums by src and by dst through B8's scatter
             (ops/segment.py ``segment_scatter``: f32, in edge order, no
             atomics) (the defaults).
  'dboth'    B1 forward; B5a ``tail_bwd_db`` -> csrc/egnn_tail_bwd_db.cu
             (plain: ``tail_bwd_db_reference``), B2 with d_both = g[dst]
             read in the kernel (JAX ``BWD_DBOTH_INKERNEL``).
  'inkernel' B1 forward; B5b ``tail_bwd_nodes`` -> csrc/egnn_tail_bwd_nodes.cu
             (plain: ``tail_bwd_nodes_reference``), B5a that also sums d_cat
             into node space by src and by dst in f32 (d_nodes [B,N,2(H+3)]),
             so no [B,C,E] cotangent reaches device memory
             (``BWD_INKERNEL_NODES``).
  'paired'   B4 ``edge_mega_paired_fwd`` -> csrc/egnn_mega_paired_fwd.cu
             (plain: ``edge_mega_paired_fwd_reference``): B1 on the
             mirror-paired layout, edge k + E/2 the reverse of edge k. The
             kernel reads the arc half's indices and mask only; one xd and
             one geometry serve both directions. In bf16 it is B1's
             tensor-core kernel with tiles of 32 arcs and their mirrors,
             over ``paired_fwd_chunks`` CTAs per graph. The backward is
             'hybrid''s (``MEGA_PAIRED``). ``check_paired`` tests the
             layout on the host.
  'stack'    B6, all layers in one kernel (ops/stack.py; ``STACK_ENABLE``),
             taken by ``egnn_stack_apply``, not by this per-layer op.

The JAX package falls back silently where its TPU lowering cannot take a
variant (lane alignment, the VMEM budget); the Hopper kernels have neither
gate, so a variant runs wherever its semantics hold and raises elsewhere.

Rounding points under bf16 are the TPU kernels'. Forward: the weights
W1ab/W2/Wc1 are rounded to the compute dtype; pa and pb are rounded, then
summed in f32; ``xd`` and ``radial`` are rounded (with the ``radial > 0``
guard); silu(a1), m and the coordinate MLP's hidden layer are rounded;
``cw`` is rounded before ``cw * x_hat``; the residual a1 is rounded after
the f32 sum. Backward (``_chain_bwd``, ``_edge_half_bwd``): g is rounded
before the gather; the chain is recomputed from the rounded a1 with the
forward's rounding points; d_p3, d_p2, d_a1, d_xd and d_ef are rounded;
d_m and d_a1s are f32 sums of products of rounded values with the rounded
weights; the node sums d_src/d_dst are f32 and d_pa/d_pb are rounded before
the node contractions; weight gradients are f32 sums of products of
rounded values.

Padded edges (``mask`` False) are skipped. An edge whose index lies outside
[0, N) is skipped too (the TPU kernel's one-hot matches no node for it on
the gather side and drops it on the aggregation side). A skipped edge has
zero residuals and zero cotangents, and adds nothing to any gradient.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from immunostruct_tpu_torch.ops.edge import (  # noqa: F401 (pack_params re-exported)
    B1, B2, BC1, HOPPER_SMEM_OPTIN, KERNEL_HIDDEN, KERNEL_MAX_F, W1E, W1R,
    WC2, _on_cuda, check_cuda_args, chunks_per_graph, define_op, hopper,
    pack_params, silu_grad,
)
from immunostruct_tpu_torch.ops import segment as _segment


MEGA_VARIANTS = ("hybrid", "dboth", "inkernel", "paired", "stack")
# the backward of one layer's edge half under each per-layer variant
_BACKWARD = {"hybrid": "hybrid", "dboth": "dboth", "inkernel": "inkernel",
             "paired": "hybrid"}


def check_variant(mega_variant: str, aggregation: str = "mega") -> None:
    """Raise unless ``mega_variant`` is one of MEGA_VARIANTS and, when it is
    not 'hybrid', the aggregation is 'mega'."""
    if mega_variant not in MEGA_VARIANTS:
        raise ValueError(f"unknown mega_variant '{mega_variant}'; choose "
                         f"from {MEGA_VARIANTS}")
    if mega_variant != "hybrid" and aggregation != "mega":
        raise ValueError(f"mega_variant='{mega_variant}' is a form of "
                         f"aggregation 'mega', not of '{aggregation}'")


def fwd_smem_bytes(n: int, hid: int) -> int:
    """Shared memory of one B1 block in its f32 form (csrc/egnn_common.cuh
    ``fwd_smem_floats``): acc N*(H+3), W2 and Wc1, small^T, two edge-tile
    buffers of 64 rows of H+1, the tile's geometry (9*64), in f32. The bf16
    form, and B4's two forms, need no more (``egnn_mega_fwd_smem_bytes``,
    ``egnn_mega_paired_fwd_smem_bytes``; a card test holds them
    together)."""
    return 4 * (n * (hid + 3) + 2 * hid * hid + 6 * hid
                + 2 * 64 * (hid + 1) + 9 * 64)


def mega_admits(nodes: int, features: int, hidden: int,
                edge_feat_size: int) -> bool:
    """Whether B1 takes these shapes: 1-dim edge features, H =
    KERNEL_HIDDEN, 1 <= F <= KERNEL_MAX_F, and the block's shared memory
    within the card's opt-in limit (JAX's ``mega_pick_tile`` asks the same
    of the TPU's VMEM). B1 takes any E."""
    return (edge_feat_size == 1 and hidden == KERNEL_HIDDEN
            and 1 <= features <= KERNEL_MAX_F
            and fwd_smem_bytes(nodes, hidden) <= HOPPER_SMEM_OPTIN)


def valid_edges(src, dst, mask, n: int) -> torch.Tensor:
    """[B, E] bool: the edges the kernels compute (mask True, both indices
    in [0, N))."""
    return mask & (src >= 0) & (src < n) & (dst >= 0) & (dst < n)


def mirror_edges(src, dst, mask):
    """(src, dst, mask) [B, E] of the mirror-paired layout that the arc half
    (edges 0 .. E/2-1) implies: edge k + E/2 is the reverse of edge k with
    its mask. What B4 computes on, whatever the second half holds."""
    half = src.shape[1] // 2
    s, d, m = src[:, :half], dst[:, :half], mask[:, :half]
    return (torch.cat([s, d], 1).contiguous(), torch.cat([d, s], 1).contiguous(),
            torch.cat([m, m], 1).contiguous())


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def check_paired(src, dst, mask) -> None:
    """Raise unless the batch holds the mirror-paired layout: E even,
    src[:, k+E/2] == dst[:, k], dst[:, k+E/2] == src[:, k] and
    mask[:, k+E/2] == mask[:, k] for every k (padding mirrored too).

    A check on the host: numpy arrays or CPU tensors, where a batch is
    built (``request_to_args``, the race CLI). Device tensors are copied
    to the host, a round trip that the per-forward path never makes: on
    CUDA tensors B4 computes on the mirror the arc half implies."""
    src, dst, mask = _host(src), _host(dst), _host(mask)
    e = src.shape[1]
    if e % 2:
        raise ValueError(f"mega_variant='paired' needs an even edge count "
                         f"(the mirror-paired layout), got E={e}")
    half = e // 2
    ok = ((src[:, half:] == dst[:, :half]).all()
          and (dst[:, half:] == src[:, :half]).all()
          and (mask[:, half:] == mask[:, :half]).all())
    if not ok:
        raise ValueError(
            "mega_variant='paired' needs the mirror-paired edge layout (edge "
            "k + E/2 the reverse of edge k, masks mirrored; "
            "GraphCorpus.stack(paired=True) or build_batch(paired=True)); "
            "this batch breaks it")


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def projection_in_order(h, w):
    """h [B, N, F] @ w [F, H] in f32 as B1's projections sum it (csrc/
    egnn_mega.cuh proj_block): each output an f32 sum over the features in
    order from +0. Each step adds one product; the product of two values of
    the compute dtype bf16 is exact in f32, so each step is that kernel's
    one fused multiply-add, and the sum the CPU's matmul gives."""
    acc = torch.zeros(*h.shape[:-1], w.shape[1], dtype=torch.float32,
                      device=h.device)
    for f in range(h.shape[-1]):
        acc = torch.addcmul(acc, h[..., f, None], w[f])
    return acc


def cw_in_order(c1, wc2):
    """cw = c1 [..., H] . wc2 [H] in f32 as B1's body sums it (csrc/
    egnn_mega.cuh): columns j = 8n + 2q + c (c < 2) belong to lane q of four;
    each lane sums its columns in column order from +0, each product and
    sum rounded on its own, and the four sums are added as (0 + 1) +
    (2 + 3). H not a multiple of 8 (no kernel takes it): column order.
    This order is the body's fragment-lane layout: a change to the one is a
    change to the other. On the CPU too (where ``.sum`` took another order
    before), so the CPU's cw is the kernels' bit for bit."""
    prod = c1 * wc2
    hid = prod.shape[-1]
    if hid % 8:
        acc = torch.zeros_like(prod[..., :1])
        for j in range(hid):
            acc = acc + prod[..., j:j + 1]
        return acc
    prod = prod.unflatten(-1, (hid // 8, 4, 2))
    part = torch.zeros_like(prod[..., 0, :, 0])
    for n in range(hid // 8):
        for c in range(2):
            part = part + prod[..., n, :, c]
    return ((part[..., 0] + part[..., 1])
            + (part[..., 2] + part[..., 3]))[..., None]


def sum_at_dst_in_edge_order(d, both, valid, n):
    """[B, N, C] f32: the valid edges' rows of both [B, E, C] summed at d
    [B, E] in edge order from +0, as the kernels sum them. On the CPU
    scatter_add_ adds in that order; elsewhere (where it takes atomics) pass
    k adds each node's k-th incoming edge: no two rows of a pass meet at
    one node, so the passes add in edge order whatever order the device
    takes each pass in."""
    b, e, c = both.shape
    if both.device.type == "cpu":   # scatter_add_ adds in edge order there
        out = torch.zeros(b, n, c, dtype=torch.float32)
        return out.scatter_add_(1, d.long()[..., None].expand(-1, -1, c),
                                torch.where(valid[..., None], both, 0.0))
    node = torch.arange(b, device=d.device)[:, None] * n + d.long()
    node = torch.where(valid, node, -1).reshape(-1)
    order = torch.argsort(node, stable=True)
    ranked = node[order]
    at = torch.arange(ranked.numel(), device=d.device)
    first = torch.ones_like(ranked, dtype=torch.bool)
    first[1:] = ranked[1:] != ranked[:-1]
    rank = torch.empty_like(at)
    rank[order] = at - torch.cummax(torch.where(first, at, 0), 0).values
    v = valid.reshape(-1)
    rank = torch.where(v, rank, -1)
    out = torch.zeros(b * n, c, dtype=torch.float32, device=both.device)
    rows = both.reshape(-1, c)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = (rank == k).nonzero().flatten()
        out = out.index_add(0, node[sel], rows[sel])
    return out.view(b, n, c)


def edge_mega_fwd_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """Plain PyTorch version of B1, with the same rounding points.

    src/dst [B, E] int, mask [B, E] bool, ef [B, E, 1], h [B, N, F] and
    x [B, N, 3] in the compute dtype, weights as ``pack_params`` returns
    them. Returns (out [B, N, H+3] f32, a1 [B, H, E], xd [B, 3, E]), the
    residuals in the compute dtype and zero on skipped edges.

    pa/pb, cw and the sums at dst are taken in the order the kernels take
    them (``projection_in_order``, ``cw_in_order``,
    ``sum_at_dst_in_edge_order``; pa/pb and the sums in the order the CPU's
    matmul and scatter_add_ take too). On the card cuBLAS sums pa/pb at
    small M out of k order and scatter_add_ sums with atomics, so the
    card's plain version was the odd one out of the three (PERF.md §6)."""
    dt = h.dtype
    f32 = torch.float32
    b, n, f = h.shape
    hid = w2.shape[1]

    def rnd(t):
        return t.to(dt).to(f32)

    valid = valid_edges(src, dst, mask, n)
    s = torch.where(valid, src, 0).long()
    d = torch.where(valid, dst, 0).long()
    vf = valid[..., None].to(f32)

    def gather(t, idx):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    w1 = rnd(w1ab)
    hf = h.to(f32)
    pa = rnd(projection_in_order(hf, w1[:f]))
    pb = rnd(projection_in_order(hf, w1[f:]))
    xf = x.to(f32)
    xd = rnd(gather(xf, s) - gather(xf, d)) * vf                # [B, E, 3]
    rad = rnd((xd * xd).sum(-1, keepdim=True))
    safe = torch.where(rad > 0, rad, torch.ones_like(rad))
    x_hat = xd * (1.0 / (torch.sqrt(safe) + 1e-30))
    sm = small.to(f32)
    a1 = (gather(pa, s) + gather(pb, d) + sm[:, W1R] * rad
          + sm[:, W1E] * rnd(ef) + sm[:, B1])
    a1s = rnd(a1 * torch.sigmoid(a1))
    p2 = torch.matmul(a1s, rnd(w2)) + sm[:, B2]
    m = rnd(p2 * torch.sigmoid(p2))
    p3 = torch.matmul(m, rnd(wc1)) + sm[:, BC1]
    c1 = rnd(p3 * torch.sigmoid(p3))
    cw = cw_in_order(c1, sm[:, WC2])
    msgx = rnd(rnd(cw) * x_hat)
    both = torch.cat([m, msgx], dim=-1) * vf
    out = sum_at_dst_in_edge_order(d, both, valid, n)
    return (out, (a1 * vf).to(dt).transpose(1, 2).contiguous(),
            xd.to(dt).transpose(1, 2).contiguous())


def edge_mega_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """``edge_mega_fwd_reference`` without the residuals: [B, N, H+3] f32.
    Differentiable by autograd, which does NOT round where the JAX backward
    rounds; ``EdgeMega`` does."""
    return edge_mega_fwd_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1,
                                   small)[0]


def tail_bwd_reference(ef, w2, wc1, small, a1, xd, d_both, valid=None):
    """Plain PyTorch version of B2, with ``_tail_bwd_call``'s contract.

    ef [B, E, 1]; a1 [B, H, E], xd [B, 3, E] and d_both [B, H+3, E] in the
    compute dtype; weights as ``pack_params`` returns them. ``valid``
    [B, E] bool (None: every edge) marks the edges to compute; the others
    get d_cat = d_ef = 0 and add nothing, whatever their residuals hold.
    Returns (d_cat [B, H+3, E], d_ef [B, 1, E] in the compute dtype,
    dW2 [H, H], dWc1 [H, H], dsmall [H, 6] in f32)."""
    return _tail_bwd_plain(ef, w2, wc1, small, a1, xd, d_both, valid, True)


def tail_d_p3_unrounded_sum(ef, w2, wc1, small, a1, xd, d_both, valid=None):
    """dsmall's bc1 column [H] as ``tail_bwd_reference`` sums it, but with
    d_p3 not rounded to the compute dtype first: what a B2 that leaves out
    that rounding point gives (B3's counterpart:
    ``ops/edge.py::d_p3_unrounded_sum``). The card tests and chip_smoke.py
    hold B2's dbc1 nearer the plain version's than this (no bound on
    dsmall's rows sees the rounding)."""
    return _tail_bwd_plain(ef, w2, wc1, small, a1, xd, d_both, valid,
                           False)[4][:, BC1]


def _tail_bwd_plain(ef, w2, wc1, small, a1, xd, d_both, valid, round_d_p3):
    dt = a1.dtype
    f32 = torch.float32
    hid = w2.shape[1]

    def rnd(t):
        return t.to(dt).to(f32)

    a1f = a1.transpose(1, 2).to(f32)                            # [B, E, H]
    xdf = xd.transpose(1, 2).to(f32)                            # [B, E, 3]
    db = d_both.transpose(1, 2).to(f32)                         # [B, E, C]
    eff = ef.to(dt).to(f32)                                     # [B, E, 1]
    if valid is not None:
        v = valid[..., None]
        a1f, xdf, db, eff = (torch.where(v, t, 0.0)
                             for t in (a1f, xdf, db, eff))
    sm = small.to(f32)
    rad = rnd((xdf * xdf).sum(-1, keepdim=True))
    safe = torch.where(rad > 0, rad, torch.ones_like(rad))
    inv_s = 1.0 / (torch.sqrt(safe) + 1e-30)
    w2b, wc1b = rnd(w2), rnd(wc1)
    # the chain, recomputed from the rounded residual
    s1 = torch.sigmoid(a1f)
    a1s = rnd(a1f * s1)
    p2 = torch.matmul(a1s, w2b) + sm[:, B2]
    s2 = torch.sigmoid(p2)
    m = rnd(p2 * s2)
    p3 = torch.matmul(m, wc1b) + sm[:, BC1]
    s3 = torch.sigmoid(p3)
    c1 = rnd(p3 * s3)
    cw = (c1 * sm[:, WC2]).sum(-1, keepdim=True)
    x_hat = xdf * inv_s
    cw_b = rnd(cw)
    # back through it
    d_m_in, d_msgx = db[..., :hid], db[..., hid:]
    d_cw = (d_msgx * x_hat).sum(-1, keepdim=True)
    d_xhat = d_msgx * cw_b
    d_p3 = sm[:, WC2] * d_cw * silu_grad(p3, s3)
    d_p3 = rnd(d_p3) if round_d_p3 else d_p3
    d_m = d_m_in + torch.matmul(d_p3, wc1b.T)
    d_p2 = rnd(d_m * silu_grad(p2, s2))
    d_a1 = rnd(torch.matmul(d_p2, w2b.T) * silu_grad(a1f, s1))
    d_rad_chain = (sm[:, W1R] * d_a1).sum(-1, keepdim=True)
    sum_dxh_xd = (d_xhat * xdf).sum(-1, keepdim=True)
    d_safe = sum_dxh_xd * (-0.5) * inv_s * inv_s / torch.sqrt(safe)
    d_rad = d_rad_chain + torch.where(rad > 0, d_safe, 0.0)
    d_xd = rnd(d_xhat * inv_s + 2.0 * xdf * d_rad)
    d_ef = (sm[:, W1E] * d_a1).sum(-1, keepdim=True)
    d_cat = torch.cat([d_a1, d_xd], dim=-1).to(dt).transpose(1, 2)
    dw2 = torch.einsum("bei,bej->ij", a1s, d_p2)
    dwc1 = torch.einsum("bei,bej->ij", m, d_p3)
    dsmall = torch.stack([
        (d_a1 * rad).sum((0, 1)), (d_a1 * eff).sum((0, 1)), d_a1.sum((0, 1)),
        d_p2.sum((0, 1)), d_p3.sum((0, 1)), (c1 * d_cw).sum((0, 1)),
    ], dim=1)
    return (d_cat.contiguous(), d_ef.to(dt).transpose(1, 2).contiguous(),
            dw2, dwc1, dsmall)


def edge_mega_paired_fwd_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1,
                                   small):
    """Plain PyTorch version of B4: B1 on ``mirror_edges(src, dst, mask)``.
    The mirror's xd is -xd exactly (rounding is symmetric), so this is the
    paired kernel's arithmetic."""
    if src.shape[1] % 2:
        raise ValueError(f"the paired layout needs an even edge count, got "
                         f"E={src.shape[1]}")
    return edge_mega_fwd_reference(*mirror_edges(src, dst, mask), ef, h, x,
                                   w1ab, w2, wc1, small)


def _gather_rows(g, idx, valid):
    """[B, E, C]: row idx[b, e] of g[b], zero where ``valid`` is False."""
    d = torch.where(valid, idx, 0).long()[..., None].expand(-1, -1,
                                                           g.shape[-1])
    return torch.where(valid[..., None], torch.gather(g, 1, d), 0.0)


def tail_bwd_db_reference(dst, valid, ef, w2, wc1, small, a1, xd, g):
    """Plain PyTorch version of B5a: B2 with d_both = g[dst] formed from
    g [B, N, H+3] in the compute dtype. Returns B2's outputs."""
    d_both = _gather_rows(g, dst, valid).transpose(1, 2).contiguous()
    return tail_bwd_reference(ef, w2, wc1, small, a1, xd, d_both, valid)


def tail_bwd_nodes_reference(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """Plain PyTorch version of B5b: B5a, then d_cat summed in f32 into node
    space by src and by dst. Returns (d_nodes [B, N, 2(H+3)] f32 = [d_src |
    d_dst], d_ef [B, 1, E], dW2, dWc1, dsmall)."""
    d_cat, d_ef, dw2, dwc1, dsmall = tail_bwd_db_reference(
        dst, valid, ef, w2, wc1, small, a1, xd, g)
    b, n, c = g.shape
    dcf = d_cat.transpose(1, 2).float()                        # [B, E, C]
    d_nodes = torch.zeros(b, n, 2 * c, dtype=torch.float32, device=g.device)
    for side, idx in enumerate((src, dst)):
        i = torch.where(valid, idx, 0).long()[..., None].expand(-1, -1, c)
        part = torch.zeros(b, n, c, dtype=torch.float32, device=g.device)
        part.scatter_add_(1, i, torch.where(valid[..., None], dcf, 0.0))
        d_nodes[..., side * c:(side + 1) * c] = part
    return d_nodes, d_ef, dw2, dwc1, dsmall


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fwd_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_mega_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_mega_fwd.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
    lib.egnn_mega_fwd.restype = i32
    lib.egnn_mega_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.egnn_mega_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_mega_fwd_ctas_per_sm.argtypes = [i32, i32, i32]
    lib.egnn_mega_fwd_ctas_per_sm.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _tail_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_tail_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_tail_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
    lib.egnn_tail_bwd.restype = i32
    lib.egnn_tail_bwd_smem_bytes.argtypes = [i32, i32]
    lib.egnn_tail_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _paired_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_mega_paired_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_mega_paired_fwd.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
    lib.egnn_mega_paired_fwd.restype = i32
    lib.egnn_mega_paired_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.egnn_mega_paired_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_mega_paired_fwd_ctas_per_sm.argtypes = [i32, i32, i32]
    lib.egnn_mega_paired_fwd_ctas_per_sm.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _tail_db_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_tail_bwd_db")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_tail_bwd_db.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
    lib.egnn_tail_bwd_db.restype = i32
    lib.egnn_tail_bwd_db_smem_bytes.argtypes = [i32, i32]
    lib.egnn_tail_bwd_db_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _tail_nodes_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_tail_bwd_nodes")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_tail_bwd_nodes.argtypes = [ptr] * 15 + [i32] * 6 + [ptr]
    lib.egnn_tail_bwd_nodes.restype = i32
    lib.egnn_tail_bwd_nodes_smem_bytes.argtypes = [i32, i32]
    lib.egnn_tail_bwd_nodes_smem_bytes.restype = ctypes.c_longlong
    return lib


def _kernel_libs():
    """Build (at first use) and load every kernel library of this module."""
    return (_fwd_lib(), _tail_lib(), _paired_lib(), _tail_db_lib(),
            _tail_nodes_lib())


def _check_smem(props, smem: int, name: str, shape: str) -> None:
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(
            f"{name} kernel needs {smem} B of shared memory for {shape}; "
            f"the card allows {props.shared_memory_per_block_optin} B per "
            "block")


def _mega_fwd_launch(args, residuals):
    """Check the operands and launch B1 on h's card: (out, a1, xd), a1 and
    xd None without ``residuals``; raise if it does not fit or does not
    launch. Counts nothing."""
    h = args[4]
    out, a1, xd, proj, ptrs, sizes = _fwd_operands("edge_mega", args,
                                                   residuals)
    b, n, e, _, hid = sizes[2:]
    bf16 = int(h.dtype == torch.bfloat16)
    lib = _fwd_lib()
    with torch.cuda.device(h.device):
        props = hopper(h.device, "edge_mega")
        _check_smem(props, lib.egnn_mega_fwd_smem_bytes(n, hid, bf16),
                    "edge_mega", f"N={n}, H={hid}")
        chunks = fwd_chunks(e, b, props.multi_processor_count) if bf16 else 1
        nodes = (torch.empty(b * chunks, n, hid + 3, dtype=torch.float32,
                             device=h.device) if chunks > 1 else None)
        rc = lib.egnn_mega_fwd(
            *ptrs, None if nodes is None else nodes.data_ptr(), *sizes,
            chunks, bf16, torch.cuda.current_stream(h.device).cuda_stream)
    _fwd_rc("egnn_mega_fwd", rc, sizes)
    return out, a1, xd


def _mega_fwd_cpu(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                  residuals):
    out, a1, xd = edge_mega_fwd_reference(src, dst, mask, ef, h, x, w1ab,
                                          w2, wc1, small)
    if residuals:
        return out, a1, xd
    return out, h.new_empty(0), h.new_empty(0)


def _mega_fwd_cuda(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                   residuals):
    out, a1, xd = _mega_fwd_launch(
        (src, dst, mask, ef, h, x, w1ab, w2, wc1, small), residuals)
    edge_mega.launches += 1
    if residuals:
        return out, a1, xd
    return out, h.new_empty(0), h.new_empty(0)


def _mega_fwd_fake(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                   residuals):
    b, n, _ = h.shape
    e, hid = src.shape[1], w2.shape[1]
    out = h.new_empty((b, n, hid + 3), dtype=torch.float32)
    if residuals:
        return out, h.new_empty((b, hid, e)), h.new_empty((b, 3, e))
    return out, h.new_empty(0), h.new_empty(0)


# B1 as a ``torch.library`` op (what ``torch.export`` traces): the plain
# version on CPU tensors, the kernel on CUDA tensors, counted there. An op
# returns tensors, so the form without residuals gives empty ones for a1
# and xd.
_MEGA_FWD_OP = define_op(
    "edge_mega_fwd(Tensor src, Tensor dst, Tensor mask, Tensor ef, "
    "Tensor h, Tensor x, Tensor w1ab, Tensor w2, Tensor wc1, Tensor small, "
    "bool residuals) -> (Tensor, Tensor, Tensor)",
    cpu=_mega_fwd_cpu, cuda=_mega_fwd_cuda, fake=_mega_fwd_fake)


def edge_mega_fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                  residuals: bool = True):
    """B1: (out [B, N, H+3] f32, a1 [B, H, E], xd [B, 3, E]); a1 and xd are
    None when ``residuals`` is False (the kernel then skips their stores).
    The op ``immunostruct::edge_mega_fwd``.

    CUDA tensors launch csrc/egnn_mega_fwd.cu or raise (bf16: the node
    projections, ``fwd_chunks`` CTAs per graph and, with more than one, the
    chunks' sum, all counted as one launch); CPU tensors go through
    ``edge_mega_fwd_reference``. ``edge_mega.launches`` counts the kernel's
    launches."""
    _on_cuda("edge_mega", h)
    out, a1, xd = _MEGA_FWD_OP(src, dst, mask, ef, h, x, w1ab, w2, wc1,
                               small, residuals)
    return (out, a1, xd) if residuals else (out, None, None)


def edge_mega_paired_fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                         residuals: bool = True):
    """B4: B1's outputs on the mirror-paired layout, from the arc half's
    indices and mask (edges 0 .. E/2-1; ``mirror_edges`` says what the
    kernel computes on). E must be even.

    CUDA tensors launch csrc/egnn_mega_paired_fwd.cu or raise (bf16: B1's
    projections, ``paired_fwd_chunks`` CTAs per graph and, with more than
    one, the chunks' sum, all counted as one launch); CPU tensors go
    through ``edge_mega_paired_fwd_reference``.
    ``edge_mega_paired_fwd.launches`` counts the kernel's launches."""
    if src.shape[1] % 2:
        raise ValueError(f"the paired layout needs an even edge count, got "
                         f"E={src.shape[1]}")
    args = (src, dst, mask, ef, h, x, w1ab, w2, wc1, small)
    if h.device.type == "cpu":
        return _fwd_cpu(edge_mega_paired_fwd_reference, args, residuals)
    out, a1, xd, proj, ptrs, sizes = _fwd_operands("edge_mega_paired",
                                                   args, residuals)
    b, n, e, _, hid = sizes[2:]
    bf16 = int(h.dtype == torch.bfloat16)
    lib = _paired_lib()
    with torch.cuda.device(h.device):
        props = hopper(h.device, "edge_mega")
        _check_smem(props, lib.egnn_mega_paired_fwd_smem_bytes(n, hid, bf16),
                    "edge_mega_paired", f"N={n}, H={hid}")
        chunks = (paired_fwd_chunks(e, b, props.multi_processor_count)
                  if bf16 else 1)
        nodes = (torch.empty(b * chunks, n, hid + 3, dtype=torch.float32,
                             device=h.device) if chunks > 1 else None)
        rc = lib.egnn_mega_paired_fwd(
            *ptrs, None if nodes is None else nodes.data_ptr(), *sizes,
            chunks, bf16, torch.cuda.current_stream(h.device).cuda_stream)
    _fwd_rc("egnn_mega_paired_fwd", rc, sizes)
    edge_mega_paired_fwd.launches += 1
    return out, a1, xd


edge_mega_paired_fwd.launches = 0


def fwd_chunks(e: int, b: int, sms: int) -> int:
    """Edge chunks per graph of B1's bf16 form (one CTA per (graph,
    chunk), one CTA an SM): as many as fill the SMs in one wave, at least
    two 64-edge tiles a chunk."""
    tiles = max(1, -(-e // 64))
    return min(-(-tiles // 2), max(1, sms // b))


def paired_fwd_chunks(e: int, b: int, sms: int) -> int:
    """Arc chunks per graph of B4's bf16 form (one CTA per (graph, chunk),
    one CTA an SM): ``fwd_chunks``' rule on the E/2 arcs, in tiles of 32
    arcs (each tile also computes their 32 mirrors), then as few chunks as
    keep that many tiles a chunk, so that none is empty. The kernel gives
    each chunk ceil(ceil(E/2 / chunks) / 32) tiles."""
    tiles = max(1, -(-(e // 2) // 32))
    chunks = min(-(-tiles // 2), max(1, sms // b))
    return -(-tiles // -(-tiles // chunks))


def _fwd_cpu(reference, args, residuals):
    out, a1, xd = reference(*args)
    return (out, a1, xd) if residuals else (out, None, None)


def _fwd_operands(name, args, residuals):
    """The checks B1 and B4 share, and their buffers on the card: (out, a1,
    xd, proj, the C entry's pointers from src to proj, its arguments from
    a1 to H); a1 and xd are None without ``residuals``. The caller holds
    proj, the projections' scratch, until it has launched the kernel: freed
    earlier, its memory would go to the next allocation (the chunks' node
    blocks) and the two would overwrite each other."""
    src, dst, mask, ef, h, x, w1ab, w2, wc1, small = args
    if h.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"not {h.device.type}")
    b, n, f = h.shape
    e = src.shape[1]
    hid = w2.shape[1]
    check_cuda_args(name, {
        "h": (h, h.dtype, (b, n, f)),
        "src": (src, torch.int32, (b, e)),
        "dst": (dst, torch.int32, (b, e)),
        "mask": (mask, torch.bool, (b, e)),
        "ef": (ef, h.dtype, (b, e, 1)),
        "x": (x, h.dtype, (b, n, 3)),
        "w1ab": (w1ab, torch.float32, (2 * f, hid)),
        "w2": (w2, torch.float32, (hid, hid)),
        "wc1": (wc1, torch.float32, (hid, hid)),
        "small": (small, torch.float32, (hid, 6)),
    }, h.dtype, hid)
    if not 1 <= f <= KERNEL_MAX_F:
        raise ValueError(f"{name} kernel takes 1 <= F <= {KERNEL_MAX_F}, "
                         f"got F={f}; aggregation 'onehot' or 'scatter' "
                         "takes any F")
    if b == 0 or n == 0:
        raise ValueError(f"{name}: empty batch or graph")
    out = torch.empty(b, n, hid + 3, dtype=torch.float32, device=h.device)
    proj = torch.empty(b, n, 2 * hid, dtype=torch.float32, device=h.device)
    a1 = xd = None
    if residuals:
        a1 = torch.empty(b, hid, e, dtype=h.dtype, device=h.device)
        xd = torch.empty(b, 3, e, dtype=h.dtype, device=h.device)
    ptrs = [t.data_ptr() for t in (*args[:7], w2, wc1, small, out, proj)]
    sizes = [a1.data_ptr() if residuals else None,
             xd.data_ptr() if residuals else None, b, n, e, f, hid]
    return out, a1, xd, proj, ptrs, sizes


def _fwd_rc(entry, rc, sizes):
    if rc != 0:
        b, n, e, f, hid = sizes[2:]
        raise RuntimeError(f"{entry} launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, E={e}, F={f}, H={hid})")


def tail_bwd(ef, w2, wc1, small, a1, xd, d_both, valid):
    """B2: (d_cat [B, H+3, E], d_ef [B, 1, E], dW2, dWc1, dsmall), the
    contract of ``tail_bwd_reference`` with ``valid`` [B, E] bool required.

    CUDA tensors launch csrc/egnn_tail_bwd.cu (its per-block partial
    weight gradients and their fixed-order reduction) or raise; CPU
    tensors go through ``tail_bwd_reference``. ``tail_bwd.launches``
    counts the kernel's launches."""
    if a1.device.type == "cpu":
        return tail_bwd_reference(ef, w2, wc1, small, a1, xd, d_both, valid)
    b, hid, e = a1.shape
    c = hid + 3
    dt = a1.dtype
    lib, props = _tail_checks("tail_bwd", _tail_lib, "egnn_tail_bwd", ef,
                              w2, wc1, small, a1, xd, valid, {
                                  "d_both": (d_both, dt, (b, c, e))})
    with torch.cuda.device(a1.device):
        # one CTA per (graph, edge chunk): at least one CTA per SM
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        d_cat = torch.empty(b, c, e, dtype=dt, device=a1.device)
        d_ef = torch.empty(b, 1, e, dtype=dt, device=a1.device)
        partial, grads = _grad_buffers(b * chunks, hid, a1.device)
        rc = lib.egnn_tail_bwd(
            valid.data_ptr(), ef.data_ptr(), w2.data_ptr(), wc1.data_ptr(),
            small.data_ptr(), a1.data_ptr(), xd.data_ptr(),
            d_both.data_ptr(), d_cat.data_ptr(), d_ef.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), b, e, hid, chunks,
            int(dt == torch.bfloat16), _stream(a1))
    _raise_on("egnn_tail_bwd", rc, b, e, hid)
    tail_bwd.launches += 1
    return (d_cat, d_ef, *_split_grads(grads, hid))


tail_bwd.launches = 0


def tail_bwd_db(dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B5a: B2's outputs with d_both = g[dst] read in the kernel from
    g [B, N, H+3] in the compute dtype (``tail_bwd_db_reference``'s
    contract). Its block partition and its fixed-order reduction are B2's.

    CUDA tensors launch csrc/egnn_tail_bwd_db.cu or raise; CPU tensors go
    through ``tail_bwd_db_reference``. ``tail_bwd_db.launches`` counts the
    kernel's launches."""
    if a1.device.type == "cpu":
        return tail_bwd_db_reference(dst, valid, ef, w2, wc1, small, a1, xd,
                                     g)
    b, hid, e = a1.shape
    n = g.shape[1]
    dt = a1.dtype
    lib, props = _tail_checks("tail_bwd_db", _tail_db_lib,
                              "egnn_tail_bwd_db", ef, w2, wc1, small, a1,
                              xd, valid, {
                                  "dst": (dst, torch.int32, (b, e)),
                                  "g": (g, dt, (b, n, hid + 3))})
    with torch.cuda.device(a1.device):
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        d_cat = torch.empty(b, hid + 3, e, dtype=dt, device=a1.device)
        d_ef = torch.empty(b, 1, e, dtype=dt, device=a1.device)
        partial, grads = _grad_buffers(b * chunks, hid, a1.device)
        rc = lib.egnn_tail_bwd_db(
            dst.data_ptr(), valid.data_ptr(), ef.data_ptr(), w2.data_ptr(),
            wc1.data_ptr(), small.data_ptr(), a1.data_ptr(), xd.data_ptr(),
            g.data_ptr(), d_cat.data_ptr(), d_ef.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), b, n, e, hid, chunks,
            int(dt == torch.bfloat16), _stream(a1))
    _raise_on("egnn_tail_bwd_db", rc, b, e, hid)
    tail_bwd_db.launches += 1
    return (d_cat, d_ef, *_split_grads(grads, hid))


tail_bwd_db.launches = 0


def tail_bwd_nodes(src, dst, valid, ef, w2, wc1, small, a1, xd, g):
    """B5b: the whole edge-half backward up to node space
    (``tail_bwd_nodes_reference``'s contract): (d_nodes [B, N, 2(H+3)] f32,
    d_ef [B, 1, E], dW2, dWc1, dsmall). B2's grid, one CTA per (graph,
    edge chunk) (``chunks_per_graph``): each chunk sums its edges' d_cat
    into a node block of its own in a fixed order, and a second kernel sums
    a graph's chunks in chunk order, so every output is the same from run
    to run.

    CUDA tensors launch csrc/egnn_tail_bwd_nodes.cu or raise; CPU tensors
    go through ``tail_bwd_nodes_reference``. ``tail_bwd_nodes.launches``
    counts the kernel's launches."""
    if a1.device.type == "cpu":
        return tail_bwd_nodes_reference(src, dst, valid, ef, w2, wc1, small,
                                        a1, xd, g)
    b, hid, e = a1.shape
    n = g.shape[1]
    dt = a1.dtype
    lib, props = _tail_checks("tail_bwd_nodes", _tail_nodes_lib,
                              "egnn_tail_bwd_nodes", ef, w2, wc1, small, a1,
                              xd, valid, {
                                  "src": (src, torch.int32, (b, e)),
                                  "dst": (dst, torch.int32, (b, e)),
                                  "g": (g, dt, (b, n, hid + 3))})
    with torch.cuda.device(a1.device):
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        d_nodes = torch.empty(b, n, 2 * (hid + 3), dtype=torch.float32,
                              device=a1.device)
        # one chunk: the kernel writes d_nodes itself, no scratch is read
        node_partial = (d_nodes if chunks == 1 else
                        torch.empty(b * chunks, n, 2 * (hid + 3),
                                    dtype=torch.float32, device=a1.device))
        d_ef = torch.empty(b, 1, e, dtype=dt, device=a1.device)
        partial, grads = _grad_buffers(b * chunks, hid, a1.device)
        rc = lib.egnn_tail_bwd_nodes(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), ef.data_ptr(),
            w2.data_ptr(), wc1.data_ptr(), small.data_ptr(), a1.data_ptr(),
            xd.data_ptr(), g.data_ptr(), d_nodes.data_ptr(),
            node_partial.data_ptr(), d_ef.data_ptr(), partial.data_ptr(),
            grads.data_ptr(), b, n, e, hid, chunks,
            int(dt == torch.bfloat16), _stream(a1))
    _raise_on("egnn_tail_bwd_nodes", rc, b, e, hid)
    tail_bwd_nodes.launches += 1
    return (d_nodes, d_ef, *_split_grads(grads, hid))


tail_bwd_nodes.launches = 0


def _tail_checks(name, lib_fn, entry, ef, w2, wc1, small, a1, xd, valid,
                 extra: dict):
    """The checks B2, B5a and B5b share; (library, card properties)."""
    if a1.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"not {a1.device.type}")
    b, hid, e = a1.shape
    dt = a1.dtype
    check_cuda_args(name, {
        "a1": (a1, dt, (b, hid, e)),
        "ef": (ef, dt, (b, e, 1)),
        "xd": (xd, dt, (b, 3, e)),
        **extra,
        "valid": (valid, torch.bool, (b, e)),
        "w2": (w2, torch.float32, (hid, hid)),
        "wc1": (wc1, torch.float32, (hid, hid)),
        "small": (small, torch.float32, (hid, 6)),
    }, dt, hid)
    if b == 0:
        raise ValueError(f"{name}: empty batch")
    lib = lib_fn()
    with torch.cuda.device(a1.device):
        props = hopper(a1.device, "edge_mega")
    _check_smem(props, getattr(lib, f"{entry}_smem_bytes")(
        hid, int(dt == torch.bfloat16)), name, f"H={hid}, {dt}")
    return lib, props


def _grad_buffers(blocks: int, hid: int, device):
    """(per-block partial weight gradients, their sum): f32 scratch of
    width 2H^2 + 6H."""
    width = 2 * hid * hid + 6 * hid
    return (torch.empty(blocks, width, dtype=torch.float32, device=device),
            torch.empty(width, dtype=torch.float32, device=device))


def _split_grads(grads, hid: int):
    """dW2 [H, H], dWc1 [H, H], dsmall [H, 6] views of the summed buffer."""
    hh = hid * hid
    return (grads[:hh].view(hid, hid), grads[hh:2 * hh].view(hid, hid),
            grads[2 * hh:].view(hid, 6))


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(entry: str, rc: int, b: int, e: int, hid: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc} "
                           f"(B={b}, E={e}, H={hid})")


# --------------------------------------------------------------------------
# backward at node level, and the autograd Function
# --------------------------------------------------------------------------

def edge_half_bwd(src, dst, valid, ef, h, x, w1ab, w2, wc1, small, a1, xd,
                  g, backward: str = "hybrid", plain: bool = False):
    """Backward of one edge half-layer from the forward's residuals and the
    cotangent g [B, N, H+3] of its output: the counterpart of
    ``_edge_half_bwd`` + ``_finish_node_grads``. ``backward`` names the
    variant: 'hybrid' (PyTorch's gather of d_both, B2, the node sums by src
    and by dst through B8's ``segment_scatter``), 'dboth' (B5a, then the
    two scatters) or 'inkernel' (B5b, which returns the node sums). ``plain`` takes the
    kernels' plain versions whatever the device. Returns (d_ef [B, E, 1],
    d_h [B, N, F], d_x [B, N, 3], dw1ab [2F, H], dw2, dwc1, dsmall),
    node-level gradients in f32, d_ef in the compute dtype."""
    dt = h.dtype
    f32 = torch.float32
    b, n, f = h.shape
    hid = w2.shape[1]
    c = hid + 3
    gd = g.to(dt).contiguous()
    if backward == "inkernel":
        fn = tail_bwd_nodes_reference if plain else tail_bwd_nodes
        d_nodes, d_ef, dw2, dwc1, dsmall = fn(src, dst, valid, ef, w2, wc1,
                                              small, a1, xd, gd)
        d_src, d_dst = d_nodes[..., :c], d_nodes[..., c:]
    else:
        if backward == "dboth":
            fn = tail_bwd_db_reference if plain else tail_bwd_db
            d_cat, d_ef, dw2, dwc1, dsmall = fn(dst, valid, ef, w2, wc1,
                                                small, a1, xd, gd)
        elif backward == "hybrid":
            fn = tail_bwd_reference if plain else tail_bwd
            d_both = _gather_rows(gd, dst, valid)               # [B, E, C]
            d_cat, d_ef, dw2, dwc1, dsmall = fn(
                ef, w2, wc1, small, a1, xd,
                d_both.transpose(1, 2).contiguous(), valid)
        else:
            raise ValueError(f"unknown backward '{backward}'")
        # the node sums through B8's scatter: f32, each (n, c) in edge
        # order, the same bits every run
        dcf = d_cat.transpose(1, 2).to(f32).contiguous()        # [B, E, C]
        d_src = _segment.segment_scatter(src.to(torch.int32).contiguous(),
                                         valid.contiguous(), dcf, n)
        d_dst = _segment.segment_scatter(dst.to(torch.int32).contiguous(),
                                         valid.contiguous(), dcf, n)
    d_pa = d_src[..., :hid].to(dt).to(f32)
    d_pb = d_dst[..., :hid].to(dt).to(f32)
    d_x = d_src[..., hid:] - d_dst[..., hid:]
    w1 = w1ab.to(dt).to(f32)
    d_h = (torch.matmul(d_pa, w1[:f].T) + torch.matmul(d_pb, w1[f:].T))
    hf = h.to(f32)
    dw1ab = torch.cat([torch.einsum("bnf,bnh->fh", hf, d_pa),
                       torch.einsum("bnf,bnh->fh", hf, d_pb)], dim=0)
    return (d_ef.transpose(1, 2), d_h, d_x, dw1ab, dw2, dwc1, dsmall)


class EdgeMega(torch.autograd.Function):
    """``edge_mega`` with its backward: B1 (B4 under 'paired') with
    residuals forward; ``edge_half_bwd`` with the variant's backward.
    Gradients for ef, h, x, w1ab, w2, wc1 and small, each in its input's
    dtype. Under 'paired' the forward reads the arc half only, and the
    backward takes the layout ``mirror_edges`` derives from it."""

    @staticmethod
    def forward(ctx, src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                mega_variant="hybrid"):
        fwd = (edge_mega_paired_fwd if mega_variant == "paired"
               else edge_mega_fwd)
        out, a1, xd = fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                          residuals=True)
        if mega_variant == "paired":
            src, dst, mask = mirror_edges(src, dst, mask)
        valid = valid_edges(src, dst, mask, h.shape[1])
        ctx.save_for_backward(src, dst, valid, ef, h, x, w1ab, w2, wc1,
                              small, a1, xd)
        ctx.backward_variant = _BACKWARD[mega_variant]
        return out

    @staticmethod
    def backward(ctx, g):
        src, dst, valid, ef, h, x, w1ab, w2, wc1, small, a1, xd = \
            ctx.saved_tensors
        grads = edge_half_bwd(src, dst, valid, ef, h, x, w1ab, w2, wc1,
                              small, a1, xd, g, ctx.backward_variant)
        inputs = (ef, h, x, w1ab, w2, wc1, small)
        return (None, None, None) + tuple(
            gr.to(t.dtype) if need else None
            for gr, t, need in zip(grads, inputs,
                                   ctx.needs_input_grad[3:10])) + (None,)


def edge_mega(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
              mega_variant: str = "hybrid"):
    """EGNN edge half-layer: [B, N, H+3] f32 per-node sums of messages
    (columns 0..H-1) and coordinate messages (columns H..H+2).

    ``mega_variant``: 'hybrid', 'dboth', 'inkernel' or 'paired' (module
    docstring; 'paired' computes on ``mirror_edges(src, dst, mask)``, which
    ``check_paired`` holds to the batch). Differentiable (``EdgeMega``) when
    gradients are enabled and an input requires one; otherwise the forward
    kernel runs without its residual stores. CUDA tensors launch the Hopper
    kernels or raise; CPU tensors take the plain versions.
    ``edge_mega.launches`` counts B1's launches, ``tail_bwd.launches`` B2's,
    and each variant's wrapper its own kernel's."""
    if mega_variant not in _BACKWARD:
        raise ValueError(f"edge_mega takes mega_variant in "
                         f"{tuple(_BACKWARD)}, got '{mega_variant}'")
    ef = ef.to(h.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ef, h, x, w1ab, w2, wc1, small)):
        return EdgeMega.apply(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                              mega_variant)
    fwd = edge_mega_paired_fwd if mega_variant == "paired" else edge_mega_fwd
    return fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
               residuals=False)[0]


edge_mega.launches = 0
