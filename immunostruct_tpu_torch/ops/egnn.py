"""E(n)-equivariant graph convolution over padded edge lists (counterpart of
``immunostruct_tpu/ops/egnn.py``).

Same math as the JAX package (EGNN of Satorras et al. 2021 as DGL's
EGNNConv implements it): messages flow src -> dst and are summed at the
destination; padded edges contribute nothing; padded nodes still flow
through the node MLP.

Every strategy is differentiable: gradients flow through the node update
and the coordinate update to every layer's parameters.

Aggregation strategies:
  'scatter'  ``index_select`` gathers and ``index_add_`` aggregation (sums
             in f32) with the radial guard of the JAX package. The CPU path
             and the plain reference for the kernel path.
  'mega'     the edge half of every layer in hand-written Hopper kernels
             from the raw edge indices (ops/mega.py): B1 forward, B2 in the
             backward; the node MLP stays in PyTorch. On CPU tensors
             ``edge_mega`` runs their plain versions. ``mega_variant`` picks
             the JAX package's kernel variants per call ('hybrid', the
             default; 'dboth' B5a and 'inkernel' B5b in the backward;
             'paired' B4 on the mirror-paired layout, checked once before
             the first layer; 'stack' B6, the whole stack in one kernel,
             ops/stack.py). Any other aggregation raises with a variant
             other than 'hybrid'.
  'fused'    [h ++ x] bundles gathered by src and by dst into the transposed
             edge layout [B, F+3, E], the edge program in hand-written Hopper
             kernels (ops/edge.py: B3 forward, B3 backward recomputing the
             chain), and the destination aggregation as an f32
             ``index_add_`` rounded to the compute dtype. The JAX package's
             numerics: coordinates are cast to h's dtype before the gather,
             a masked edge (or an index outside [0, N)) gathers zeros on
             that side and is left out of the aggregation, and the gathers'
             backward sums in f32 and rounds once, as the JAX one-hot
             einsums do. JAX's admission rule holds: E a multiple of 128 and
             1-dim edge features; where JAX would fall back to 'onehot' (not
             ported), this raises.
  'pallas'   gathers and the edge/coord MLP as 'scatter', then [m ++
             msg_x] in the compute dtype summed at the destination by B8's
             scatter kernel (ops/segment.py: ``SegmentScatter``, f32 sums
             rounded once; its backward is B8's gather kernel). The JAX
             package's numerics: the gathers do not mask the index, the
             aggregation leaves out a masked edge or an index outside [0,
             N). JAX's admission rule holds: E a multiple of 128; where JAX
             would fall back to 'onehot' (not ported), this raises.
  'auto'     'mega' for CUDA tensors, 'scatter' for CPU tensors.
The JAX package's other names ('onehot', 'onehot_remat') are not ported yet
and raise (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from immunostruct_tpu_torch.ops.edge import (
    EDGE_MULTIPLE, edge_program, pack_params,
)
from immunostruct_tpu_torch.ops.mega import (
    check_paired, check_variant, edge_mega,
)
from immunostruct_tpu_torch.ops.nnp import Linear, linear_apply
from immunostruct_tpu_torch.ops.segment import SegmentScatter
from immunostruct_tpu_torch.ops.stack import apply_stack

NOT_PORTED = ("onehot", "onehot_remat")


class EGNNLayer(nn.Module):
    """One EGNN layer; parameter names match the JAX package's
    ``egnn_init`` (edge_mlp / node_mlp / coord_mlp lists of linears)."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 edge_feat_size: int = 1, *, generator: torch.Generator,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.edge_mlp = nn.ModuleList([
            Linear(in_size * 2 + edge_feat_size + 1, hidden_size, **kw),
            Linear(hidden_size, hidden_size, **kw)])
        self.node_mlp = nn.ModuleList([
            Linear(in_size + hidden_size, hidden_size, **kw),
            Linear(hidden_size, out_size, **kw)])
        self.coord_mlp = nn.ModuleList([
            Linear(hidden_size, hidden_size, **kw),
            Linear(hidden_size, 1, bias=False, **kw)])


def egnn_stack(num_layers: int, in_size: int, hidden_size: int,
               edge_feat_size: int = 1, *, generator: torch.Generator,
               device=None, dtype=torch.float32) -> nn.ModuleList:
    """Input layer (in_size -> hidden) plus ``num_layers`` hidden convs."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    return nn.ModuleList(
        [EGNNLayer(in_size, hidden_size, hidden_size, edge_feat_size, **kw)]
        + [EGNNLayer(hidden_size, hidden_size, hidden_size, edge_feat_size,
                     **kw) for _ in range(num_layers)])


def resolve_aggregation(aggregation: str, device: torch.device) -> str:
    if aggregation == "auto":
        return "mega" if device.type == "cuda" else "scatter"
    if aggregation in ("scatter", "mega", "fused", "pallas"):
        return aggregation
    if aggregation in NOT_PORTED:
        raise ValueError(
            f"aggregation '{aggregation}' is not ported to PyTorch yet "
            "(see ROADMAP.md, kernels still to port); use 'scatter', "
            "'mega', 'fused', 'pallas' or 'auto'")
    raise ValueError(f"unknown aggregation '{aggregation}'")


def _node_update(p: EGNNLayer, h, x, h_agg, x_agg):
    """h' = node_mlp([h ++ h_agg]); x' = x + x_agg."""
    hn = linear_apply(p.node_mlp[0], torch.cat([h, h_agg], dim=-1))
    hn = linear_apply(p.node_mlp[1], nn.functional.silu(hn))
    return hn, x + x_agg


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E] per-graph node indices -> [B*E] rows of a [B*N, C] view."""
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (idx.long() + offs).reshape(-1)


def _edge_messages(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat):
    """The gathers (the index not masked) and the edge/coord MLP: (m [B, E,
    H], msg_x [B, E, 3]) and the flat destination rows."""
    b, n, f = h.shape
    e = edge_src.shape[1]
    src = _flat_index(edge_src, n)
    dst = _flat_index(edge_dst, n)
    hf = h.reshape(b * n, f)
    xf = x.reshape(b * n, 3)
    h_src = hf.index_select(0, src).reshape(b, e, f)
    h_dst = hf.index_select(0, dst).reshape(b, e, f)
    x_diff = (xf.index_select(0, src) - xf.index_select(0, dst)
              ).reshape(b, e, 3)
    radial = (x_diff * x_diff).sum(-1, keepdim=True)
    # radial = 0 (self-loops) keeps x_hat = 0 and the sqrt finite
    radial_safe = torch.where(radial > 0, radial, torch.ones_like(radial))
    x_hat = x_diff / (torch.sqrt(radial_safe) + 1e-30)

    feat = torch.cat([h_src, h_dst, radial.to(h.dtype),
                      edge_feat.to(h.dtype)], dim=-1)
    silu = nn.functional.silu
    m = silu(linear_apply(p.edge_mlp[0], feat))
    m = silu(linear_apply(p.edge_mlp[1], m))                    # [B, E, H]
    cw = silu(linear_apply(p.coord_mlp[0], m))
    cw = linear_apply(p.coord_mlp[1], cw)                       # [B, E, 1]
    msg_x = cw.to(x_hat.dtype) * x_hat                          # [B, E, 3]
    return m, msg_x, dst


def _egnn_apply_scatter(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                        edge_mask):
    b, n, _ = h.shape
    e = edge_src.shape[1]
    m, msg_x, dst = _edge_messages(p, h, x, edge_src, edge_dst, edge_feat)
    hid = m.shape[-1]
    both = torch.cat([m.float(), msg_x.float()], dim=-1)
    both = both * edge_mask.reshape(b, e, 1).to(both.dtype)
    agg = torch.zeros(b * n, hid + 3, dtype=torch.float32, device=h.device)
    agg.index_add_(0, dst, both.reshape(b * e, hid + 3))
    agg = agg.reshape(b, n, hid + 3)
    return _node_update(p, h, x, agg[..., :hid].to(m.dtype),
                        agg[..., hid:].to(x.dtype))


def _egnn_apply_mega(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                     edge_mask, mega_variant: str = "hybrid"):
    if edge_feat.shape[-1] != 1:
        raise ValueError("aggregation 'mega' takes 1-dim edge features, got "
                         f"{edge_feat.shape[-1]}")
    w1ab, w2, wc1, small = pack_params(p.edge_mlp, p.coord_mlp)
    agg = edge_mega(edge_src, edge_dst, edge_mask, edge_feat,
                    h.contiguous(), x.to(h.dtype).contiguous(), w1ab, w2,
                    wc1, small, mega_variant).to(h.dtype)
    c = agg.shape[-1] - 3
    return _node_update(p, h, x, agg[..., :c], agg[..., c:].to(x.dtype))


def check_fused(edge_count: int, edge_feat_size: int) -> None:
    """JAX's admission rule for 'fused' (``_fused_or_fallback``): raise
    where the JAX package would warn and fall back to 'onehot'."""
    if (edge_count < EDGE_MULTIPLE or edge_count % EDGE_MULTIPLE
            or edge_feat_size != 1):
        raise ValueError(
            f"aggregation='fused' takes a multiple of {EDGE_MULTIPLE} edges "
            f"and 1-dim edge features, got E={edge_count} and edge_feat "
            f"size {edge_feat_size} (the JAX package falls back to "
            "'onehot' there, which is not ported yet, see ROADMAP.md); use "
            "'mega' or 'scatter'")


class _GatherEdges(torch.autograd.Function):
    """rows [B*N, C] -> [B, C, E]: column (b, :, e) is row ``flat[b, e]``,
    or zeros where ``ok`` is False. The backward sums the cotangent into
    the rows in f32 and rounds once to the rows' dtype (the transpose of
    the JAX package's one-hot einsum with f32 accumulation)."""

    @staticmethod
    def forward(ctx, rows, flat, ok):
        b, e = ok.shape
        out = rows.index_select(0, flat.reshape(-1)).reshape(b, e, -1)
        out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))
        ctx.save_for_backward(flat, ok)
        ctx.rows = rows.shape[0]
        return out.transpose(1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        flat, ok = ctx.saved_tensors
        gf = torch.where(ok[..., None], g.transpose(1, 2).float(), 0.0)
        acc = torch.zeros(ctx.rows, g.shape[1], dtype=torch.float32,
                          device=g.device)
        acc.index_add_(0, flat.reshape(-1), gf.reshape(-1, g.shape[1]))
        return acc.to(g.dtype), None, None


def _egnn_apply_fused(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                      edge_mask):
    b, n, f = h.shape
    e = edge_src.shape[1]
    check_fused(e, edge_feat.shape[-1])
    dt = h.dtype
    src_ok = edge_mask & (edge_src >= 0) & (edge_src < n)
    dst_ok = edge_mask & (edge_dst >= 0) & (edge_dst < n)
    # in range before any CUDA indexing: an out-of-range index on the card
    # is a fault, not a zero
    src = _flat_index(torch.where(src_ok, edge_src, 0), n)
    dst = _flat_index(torch.where(dst_ok, edge_dst, 0), n)
    rows = torch.cat([h, x.to(dt)], dim=-1).reshape(b * n, f + 3)
    hsx = _GatherEdges.apply(rows, src, src_ok)               # [B, F+3, E]
    hdx = _GatherEdges.apply(rows, dst, dst_ok)
    ef = edge_feat.to(dt).transpose(1, 2).contiguous()        # [B, 1, E]
    w1ab, w2, wc1, small = pack_params(p.edge_mlp, p.coord_mlp)
    both = edge_program(hsx, hdx, ef, w1ab, w2, wc1, small)   # [B, H+3, E]
    c = both.shape[1]
    msgs = torch.where(dst_ok[..., None], both.transpose(1, 2).float(), 0.0)
    agg = torch.zeros(b * n, c, dtype=torch.float32, device=h.device)
    agg.index_add_(0, dst, msgs.reshape(b * e, c))
    agg = agg.reshape(b, n, c).to(dt)
    return _node_update(p, h, x, agg[..., :c - 3], agg[..., c - 3:].to(x.dtype))


def check_pallas(edge_count: int) -> None:
    """JAX's admission rule for 'pallas' (``egnn_stack_apply``: E a
    multiple of 128, ``_pick_tile``): raise where the JAX package would
    fall back to 'onehot'."""
    if edge_count < EDGE_MULTIPLE or edge_count % EDGE_MULTIPLE:
        raise ValueError(
            f"aggregation='pallas' takes a multiple of {EDGE_MULTIPLE} "
            f"edges, got E={edge_count} (the JAX package falls back to "
            "'onehot' there, which is not ported yet, see ROADMAP.md); use "
            "'mega' or 'scatter'")


def _egnn_apply_pallas(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                       edge_mask):
    check_pallas(edge_src.shape[1])
    m, msg_x, _ = _edge_messages(p, h, x, edge_src, edge_dst, edge_feat)
    hid = m.shape[-1]
    both = torch.cat([m, msg_x.to(m.dtype)], dim=-1)          # compute dtype
    agg = SegmentScatter.apply(edge_dst.to(torch.int32).contiguous(),
                               edge_mask.contiguous(), both.contiguous(),
                               h.shape[1])                    # [B, N, H+3]
    return _node_update(p, h, x, agg[..., :hid], agg[..., hid:].to(x.dtype))


def egnn_apply(p: EGNNLayer, h: torch.Tensor, x: torch.Tensor,
               edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_feat: torch.Tensor, edge_mask: torch.Tensor,
               aggregation: str = "scatter", mega_variant: str = "hybrid"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EGNN layer. h [B,N,F], x [B,N,3], edge_src/edge_dst [B,E],
    edge_feat [B,E,1], edge_mask [B,E]. Returns (h', x'). ``mega_variant``
    is a per-layer variant of 'mega' ('stack' spans the whole stack:
    ``egnn_stack_apply``); under 'paired' the caller holds the batch to
    ``check_paired``."""
    aggregation = resolve_aggregation(aggregation, h.device)
    check_variant(mega_variant, aggregation)
    if mega_variant == "stack":
        raise ValueError("mega_variant='stack' runs the whole conv stack "
                         "in one kernel: call egnn_stack_apply")
    if aggregation == "mega":
        return _egnn_apply_mega(p, h, x, edge_src, edge_dst, edge_feat,
                                edge_mask, mega_variant)
    if aggregation == "fused":
        return _egnn_apply_fused(p, h, x, edge_src, edge_dst, edge_feat,
                                 edge_mask)
    if aggregation == "pallas":
        return _egnn_apply_pallas(p, h, x, edge_src, edge_dst, edge_feat,
                                  edge_mask)
    return _egnn_apply_scatter(p, h, x, edge_src, edge_dst, edge_feat,
                               edge_mask)


def egnn_stack_apply(layers: Sequence[EGNNLayer], h, x, edge_src, edge_dst,
                     edge_feat, edge_mask, aggregation: str = "auto",
                     mega_variant: str = "hybrid"):
    """Run the conv stack. Returns (h, x). ``mega_variant`` (aggregation
    'mega' only): 'stack' runs every layer in B6 (``apply_stack``);
    'paired' checks the mirror-paired layout once, here, before the first
    layer; the others pick each layer's kernels."""
    aggregation = resolve_aggregation(aggregation, h.device)
    check_variant(mega_variant, aggregation)
    if mega_variant == "stack":
        return apply_stack(layers, h, x, edge_src, edge_dst, edge_feat,
                           edge_mask)
    if mega_variant == "paired":
        check_paired(edge_src, edge_dst, edge_mask)
    for p in layers:
        h, x = egnn_apply(p, h, x, edge_src, edge_dst, edge_feat, edge_mask,
                          aggregation, mega_variant)
    return h, x
