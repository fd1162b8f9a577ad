"""E(n)-equivariant graph convolution over padded edge lists (counterpart of
``immunostruct_tpu/ops/egnn.py``).

Same math as the JAX package (EGNN of Satorras et al. 2021 as DGL's
EGNNConv implements it): messages flow src -> dst and are summed at the
destination; padded edges contribute nothing; padded nodes still flow
through the node MLP.

Every strategy is differentiable: gradients flow through the node update
and the coordinate update to every layer's parameters. The glue rounds
where the JAX package's XLA program rounds, forward and backward, in bf16
as in f32: its silu (``nnp.silu``), the radial, x_hat and msg_x chain
(``_Geometry``, ``_CoordMessage``) and, under 'scatter' and 'pallas', the
order in which h's and x's three cotangents are added (``_Fanout``).

Aggregation strategies:
  'scatter'  ``index_select`` gathers and sums at dst with the radial guard
             of the JAX package. The CPU path and the plain reference for
             the kernel path. In f32 the sums run in f32 (``index_add_``);
             in a narrow dtype (bf16) as JAX's ``.at[].add`` and the
             transpose of its ``take_along_axis`` run: in that dtype, in
             edge order, each add rounded (``sum_rows_in_order``; the rows
             are counted on the host, so on the card such a step runs
             eagerly: ``host_counted_sums``).
  'onehot'   gathers and aggregation as batched products with masked
             [B, N, E] one-hot matrices (JAX ``build_scatter_matrix``; an
             index outside [0, N) gives a zero column, a masked edge a zero
             column on both sides). The matrices hold 0 and 1 (the
             difference matrix -1, 0 and 1), exact in any dtype, so they are
             built in f32 and every product accumulates in f32 and is
             rounded once to its operand's dtype, on the CPU and the card
             alike (with TF32 off, the card's default for matmul).
             ``x_diff`` is one product of the difference matrix with x,
             promoted against x: f32 coordinates stay f32 under bf16
             features (the only path that keeps them). The stack builds the
             matrices once and shares them across layers. Plain PyTorch:
             the JAX package runs these as XLA einsums, outside any Pallas
             kernel.
  'onehot_remat' the same values; each layer rebuilds the matrices inside
             ``torch.utils.checkpoint`` (non-reentrant), so they never
             outlive the layer's forward or its recompute in the backward.
  'mega'     the edge half of every layer in hand-written Hopper kernels
             from the raw edge indices (ops/mega.py): B1 forward, B2 in the
             backward; the node MLP stays in PyTorch. On CPU tensors
             ``edge_mega`` runs their plain versions. ``mega_variant`` picks
             the JAX package's kernel variants per call ('hybrid', the
             default; 'dboth' B5a and 'inkernel' B5b in the backward;
             'paired' B4 on the mirror-paired layout; 'stack' B6, the whole
             stack in one kernel, ops/stack.py). Any other aggregation
             raises with a variant other than 'hybrid'. Under 'paired' the
             layout is checked on the host where the batch is built
             (``check_paired``); on CPU tensors the stack checks it too, on
             CUDA tensors it computes on the mirror that the arc half
             implies, as the JAX kernel does, with no host round trip.
  'fused'    [h ++ x] bundles gathered by src and by dst into the transposed
             edge layout [B, F+3, E], the edge program in hand-written Hopper
             kernels (ops/edge.py: B3 forward, B3 backward recomputing the
             chain), and the destination aggregation summed in f32 by B8's
             scatter (ops/segment.py: each (n, c) in edge order, no
             atomics) and rounded to the compute dtype. The JAX package's
             numerics: coordinates are cast to h's dtype before the gather,
             a masked edge (or an index outside [0, N)) gathers zeros on
             that side and is left out of the aggregation, and the gathers'
             backward sums in f32 and rounds once, as the JAX one-hot
             einsums do. JAX's admission rule holds: E a multiple of 128 and
             1-dim edge features; where JAX would fall back to 'onehot',
             this raises and names it.
  'pallas'   gathers and the edge/coord MLP as 'scatter', then [m ++
             msg_x] in the compute dtype summed at the destination by B8's
             scatter kernel (ops/segment.py: ``SegmentScatter``, f32 sums
             rounded once; its backward is B8's gather kernel). The
             gathers' backward is B8's scatter too, each add rounded to the
             compute dtype as XLA transposes JAX's ``take_along_axis``
             (``segment_scatter_rounded``), so a step gives the same bits
             every run. The JAX package's numerics: the gathers do not
             mask the index, the aggregation leaves out a masked edge or an
             index outside [0, N). JAX's admission rule holds: E a multiple
             of 128; where JAX would fall back to 'onehot', this raises and
             names it.
  'auto'     'scatter' for CPU tensors. For CUDA tensors the JAX package's
             chain (``_mega_or_fallback``, ``_fused_or_fallback``), decided
             from the shapes before any launch, with its warnings: 'mega'
             where B1 takes the shapes, else 'fused' where B3 takes them,
             else 'onehot'.

``fused_stack=True`` (``egnn_stack_apply``, forward only) runs the whole
conv stack through B7, one kernel per layer (ops/fused_layer.py, the
counterpart of ``ops/experimental/pallas_egnn.py``). Like the JAX kernel
it reads no edge features: they must be all ones. On CPU tensors the stack
checks that; on CUDA tensors it is the caller's contract (the request and
batch builders check it on the host), as it is the JAX wrapper's.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from immunostruct_tpu_torch.ops.edge import (
    EDGE_MULTIPLE, edge_program, fused_admits, pack_params,
)
from immunostruct_tpu_torch.ops.fused_layer import fused_egnn_stack
from immunostruct_tpu_torch.ops.mega import (
    check_paired, check_variant, edge_mega, mega_admits,
)
from immunostruct_tpu_torch.ops.nnp import Linear, linear_apply, silu
from immunostruct_tpu_torch.ops import segment as _segment
from immunostruct_tpu_torch.ops.segment import (
    SegmentScatter, narrow, row_passes, sum_rows_in_order,
)
from immunostruct_tpu_torch.ops.stack import apply_stack

AGGREGATIONS = ("auto", "scatter", "onehot", "onehot_remat", "mega", "fused",
                "pallas")


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


def resolve_aggregation(aggregation: str, device: torch.device, *,
                        edges: int, nodes: int, features: int, hidden: int,
                        edge_feat_size: int) -> str:
    """The aggregation that runs. 'auto' is 'scatter' on the CPU; on CUDA it
    follows the JAX package's chain from the shapes alone (E edges, N
    nodes, the input width F, the hidden width H, the edge-feature width):
    'mega' where B1 takes them (``mega_admits``), else 'fused' where B3 does
    (``fused_admits``), else 'onehot', warning at each step as JAX does."""
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation '{aggregation}'; choose from "
                         f"{AGGREGATIONS}")
    if aggregation != "auto":
        return aggregation
    if device.type != "cuda":
        return "scatter"
    if mega_admits(nodes, features, hidden, edge_feat_size):
        return "mega"
    warnings.warn(
        f"aggregation='mega' unsupported for edge count {edges} / {nodes} "
        f"nodes / edge_feat size {edge_feat_size}; falling back to 'fused'",
        stacklevel=3)
    if fused_admits(edges, features, hidden, edge_feat_size):
        return "fused"
    warnings.warn(
        f"aggregation='fused' unsupported for edge count {edges} / "
        f"edge_feat size {edge_feat_size} (needs a 128-multiple edge pad "
        "and 1-dim edge features); falling back to 'onehot'", stacklevel=3)
    return "onehot"


def stack_aggregation(aggregation: str, p: EGNNLayer, h, edge_src,
                      edge_feat) -> str:
    """The aggregation a conv stack whose first layer is ``p`` runs on
    these operands (their shapes and device; ``resolve_aggregation``)."""
    return resolve_aggregation(
        aggregation, h.device, edges=edge_src.shape[1], nodes=h.shape[1],
        features=h.shape[-1], hidden=p.edge_mlp[1].w.shape[1],
        edge_feat_size=edge_feat.shape[-1])


def _node_update(p: EGNNLayer, h, x, h_agg, x_agg):
    """h' = node_mlp([h ++ h_agg]); x' = x + x_agg. The silu is
    ``jax.nn.silu``'s (``ops/nnp.py::silu``)."""
    hn = linear_apply(p.node_mlp[0], torch.cat([h, h_agg], dim=-1))
    hn = linear_apply(p.node_mlp[1], silu(hn))
    return hn, x + x_agg


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E] per-graph node indices -> [B*E] rows of a [B*N, C] view."""
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (idx.long() + offs).reshape(-1)


def _sum_last(t):
    """t [..., 3] summed over its last axis in order, each add rounded to
    t's dtype ([..., 1]): XLA's reduce_sum in that dtype, as JAX's
    transposes of a broadcast sum."""
    return (t[..., 0:1] + t[..., 1:2]) + t[..., 2:3]


class _Geometry(torch.autograd.Function):
    """x_diff [B, E, 3] -> (radial [B, E, 1], x_hat [B, E, 3]) with the JAX
    package's radial guard: radial = |x_diff|^2 (the products rounded, the
    sum as ``jnp.sum`` takes it, in f32 rounded once); x_hat = x_diff /
    (sqrt(radial, or 1 where it is 0) + 1e-30). Each op rounds in x_diff's
    dtype. The backward is JAX's transpose of that chain, at its rounding
    points and in its order of sums: sqrt's derivative as g * (0.5 / root),
    the quotient's as g / den and -g * den^-2 * x_diff (den^-2 = 1 / (den *
    den)), the broadcast sums over the three components in order, and the
    three terms of x_diff's cotangent added as ((g / den + x_diff * c) + c
    * x_diff), c the radial's whole cotangent. Autograd rounds each of
    these at other points."""

    @staticmethod
    def forward(ctx, xd):
        radial = (xd * xd).sum(-1, keepdim=True)
        positive = radial > 0
        root = torch.sqrt(torch.where(positive, radial,
                                      torch.ones_like(radial)))
        den = root + 1e-30
        ctx.save_for_backward(xd, positive, root, den)
        return radial, xd / den

    @staticmethod
    def backward(ctx, g_radial, g_hat):
        xd, positive, root, den = ctx.saved_tensors
        zero = torch.zeros((), dtype=xd.dtype, device=xd.device)
        if g_hat is None:
            g_hat = torch.zeros_like(xd)
        d_root = -_sum_last((g_hat * torch.reciprocal(den * den)) * xd)
        c = torch.where(positive, d_root * (0.5 / root), zero)
        if g_radial is not None:
            c = g_radial + c
        return (g_hat / den + xd * c) + c * xd


class _CoordMessage(torch.autograd.Function):
    """msg_x = cw [B, E, 1] * x_hat [B, E, 3] in x_hat's dtype; the backward
    as JAX's: cw's cotangent the sum of g * x_hat over the three components
    in order, each add rounded (autograd sums them in f32 and rounds
    once)."""

    @staticmethod
    def forward(ctx, cw, x_hat):
        ctx.save_for_backward(cw, x_hat)
        return cw * x_hat

    @staticmethod
    def backward(ctx, g):
        cw, x_hat = ctx.saved_tensors
        return _sum_last(g * x_hat), cw * g


def _edge_mlp(p: EGNNLayer, h_src, h_dst, x_diff, edge_feat):
    """The edge/coord MLP on gathered values: (m [B, E, H], msg_x [B, E, 3]
    in x_diff's dtype), with the JAX package's radial guard, rounding
    points and silu (``_Geometry``, ``_CoordMessage``, ``nnp.silu``)."""
    radial, x_hat = _Geometry.apply(x_diff)
    dt = h_src.dtype
    feat = torch.cat([h_src, h_dst, radial.to(dt), edge_feat.to(dt)], dim=-1)
    m = silu(linear_apply(p.edge_mlp[0], feat))
    m = silu(linear_apply(p.edge_mlp[1], m))                    # [B, E, H]
    cw = silu(linear_apply(p.coord_mlp[0], m))
    cw = linear_apply(p.coord_mlp[1], cw)                       # [B, E, 1]
    return m, _CoordMessage.apply(cw.to(x_hat.dtype), x_hat)    # [B, E, 3]


def ordered_scatter(h, x) -> bool:
    """Whether 'scatter' sums in the compute dtype in edge order
    (``_egnn_apply_scatter_narrow``): h and x in one narrow dtype."""
    return narrow(h.dtype) and h.dtype == x.dtype


def host_counted_sums(aggregation: str, dtype: torch.dtype
                      ) -> Optional[str]:
    """Why a program whose conv stack runs ``aggregation`` (resolved) in
    ``dtype`` runs eagerly on the card, if it must: 'scatter' in a narrow
    dtype counts the rows of its ordered sums on the host
    (``sum_rows_in_order``), which a CUDA graph cannot hold."""
    if aggregation == "scatter" and narrow(dtype):
        return "ordered sums"
    return None


def _edge_rows(idx, ok, n):
    """[B*E] rows of a [B*N, C] view, -1 where ``ok`` [B, E] is False."""
    return torch.where(ok.reshape(-1), _flat_index(idx, n), -1)


def scatter_passes(edge_src, edge_dst, edge_mask, n: int) -> dict:
    """The ordered sums' passes (``row_passes``) of a graph batch's src and
    dst rows, masked edges left out: computed once for a conv stack under
    'scatter' in a narrow dtype, two host syncs a forward."""
    ok = edge_mask.bool()
    b = edge_src.shape[0]
    return {"src": row_passes(_edge_rows(edge_src, ok, n), b * n),
            "dst": row_passes(_edge_rows(edge_dst, ok, n), b * n)}


def _ordered_sums(idx, ok, g, n, passes=None):
    """g [B, E, C] summed at idx [B, E] into [B, N, C] by
    ``sum_rows_in_order``, the rows where ``ok`` [B, E] is False left out."""
    b, e, c = g.shape
    return sum_rows_in_order(_edge_rows(idx, ok, n), g.reshape(b * e, c),
                             b * n, passes).reshape(b, n, c)


def _rounded_sums(idx, ok, g, n):
    """``_ordered_sums``'s values through B8's rounded scatter."""
    return _segment.segment_scatter_rounded(
        idx.to(torch.int32).contiguous(), ok.contiguous(), g.contiguous(), n)


class _Fanout(torch.autograd.Function):
    """t [B, N, C] -> (t, t at src, t at dst) (src, dst [B, E]): a layer's
    three uses of h (or x) under 'scatter' and 'pallas', the node update's
    and the two gathers'. The backward is JAX's transpose of the three:
    ((g + sum_dst(the dst rows' cotangent)) + sum_src(the src rows')), each
    add rounded; ``sum_src`` and ``sum_dst`` map a cotangent [B, E, C] to
    its sums at src or dst [B, N, C] (XLA's transpose of
    ``take_along_axis``: in the cotangent's dtype, in edge order, each add
    rounded, by ``_ordered_sums`` or ``_rounded_sums``). Autograd would add
    the three in another order."""

    @staticmethod
    def forward(ctx, t, src, dst, sum_src, sum_dst):
        b, n, c = t.shape
        ctx.sums = (sum_dst, sum_src)
        rows = t.reshape(b * n, c)

        def take(idx):
            return rows.index_select(0, _flat_index(idx, n)).reshape(
                b, idx.shape[1], c)
        return t.clone(), take(src), take(dst)

    @staticmethod
    def backward(ctx, g, g_src, g_dst):
        out = g
        for sums, rows in zip(ctx.sums, (g_dst, g_src)):
            if rows is not None:
                part = sums(rows)
                out = part if out is None else out + part
        return out, None, None, None, None


class _GatherRows(torch.autograd.Function):
    """rows [B*N, C] -> [B, E, C]: row ``idx[b, e]`` of graph b (idx int32
    [B, E]), ``index_select``'s values, or zeros where ``ok`` [B, E] (None:
    everywhere) is False. The backward sums the cotangent of the edges where
    ``ok`` into the rows through B8's scatter (f32, each (n, c) in edge
    order, rounded once to the cotangent's dtype: the transpose of the JAX
    package's one-hot einsum with f32 accumulation); ``index_select``'s own
    backward (``index_add_``) sums with atomics on the card, in no fixed
    order."""

    @staticmethod
    def forward(ctx, rows, idx, ok):
        b, e = idx.shape
        n = rows.shape[0] // b
        out = rows.index_select(0, _flat_index(idx, n)).reshape(b, e, -1)
        if ok is not None:
            out = torch.where(ok[..., None], out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        ctx.save_for_backward(idx, ok)
        ctx.nodes = n
        return out

    @staticmethod
    def backward(ctx, g):
        idx, ok = ctx.saved_tensors
        if ok is None:
            ok = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        acc = _segment.segment_scatter(idx, ok, g.contiguous(), ctx.nodes)
        return acc.reshape(-1, g.shape[-1]), None, None


def _edge_messages(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat):
    """'scatter''s gathers in f32 (``index_select``, the index not masked)
    and the edge/coord MLP: (m [B, E, H], msg_x [B, E, 3]) and the flat
    destination rows."""
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
    m, msg_x = _edge_mlp(p, h_src, h_dst, x_diff, edge_feat)
    return m, msg_x, dst


def _fanned_messages(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                     sum_src, sum_dst):
    """The gathers through ``_Fanout`` (the index not masked; the
    cotangents summed by ``sum_src`` and ``sum_dst``) and the edge/coord
    MLP: (h and x for the node update, m [B, E, H], msg_x [B, E, 3]). h and
    x fan out apart: under 'pallas' each of their four sums is one launch of
    B8's rounded scatter. The sums may leave out a masked edge's rows: the
    aggregation drops its message, so its cotangents are zero."""
    h, h_src, h_dst = _Fanout.apply(h, edge_src, edge_dst, sum_src, sum_dst)
    x, x_src, x_dst = _Fanout.apply(x, edge_src, edge_dst, sum_src, sum_dst)
    m, msg_x = _edge_mlp(p, h_src, h_dst, x_src - x_dst, edge_feat)
    return h, x, m, msg_x


def _egnn_apply_scatter_narrow(p: EGNNLayer, h, x, edge_src, edge_dst,
                               edge_feat, edge_mask, passes=None):
    """'scatter' in a narrow dtype, as the JAX package's runs: the gathers'
    backward and the sums at dst in that dtype, in edge order, each add
    rounded (``_fanned_messages`` with ``_ordered_sums``); the rows of
    masked edges, zero in JAX's sum, left out. ``passes``: the stack's
    ``scatter_passes``."""
    n = h.shape[1]
    passes = passes or scatter_passes(edge_src, edge_dst, edge_mask, n)
    ok = edge_mask.bool()
    h, x, m, msg_x = _fanned_messages(
        p, h, x, edge_src, edge_dst, edge_feat,
        lambda g: _ordered_sums(edge_src, ok, g, n, passes["src"]),
        lambda g: _ordered_sums(edge_dst, ok, g, n, passes["dst"]))
    hid = m.shape[-1]
    agg = _ordered_sums(edge_dst, ok, torch.cat([m, msg_x], dim=-1), n,
                        passes["dst"])
    return _node_update(p, h, x, agg[..., :hid], agg[..., hid:])


def _egnn_apply_scatter(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                        edge_mask, passes=None):
    """'scatter'. In f32 the sums at dst run in f32 (``index_add_``: in edge
    order on the CPU, by atomics on the card unless torch's deterministic
    algorithms are on); in a narrow dtype (h and x alike) as the JAX
    package's do (``_egnn_apply_scatter_narrow``)."""
    if ordered_scatter(h, x):
        return _egnn_apply_scatter_narrow(p, h, x, edge_src, edge_dst,
                                          edge_feat, edge_mask, passes)
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


# --------------------------------------------------------------------------
# 'onehot' and 'onehot_remat'
# --------------------------------------------------------------------------

def one_hot_matrix(idx: torch.Tensor, mask: torch.Tensor,
                   n: int) -> torch.Tensor:
    """[B, E] node indices -> the [B, N, E] masked one-hot matrix in f32
    (JAX ``build_scatter_matrix``): column e is node idx[b, e]'s unit
    vector, or zeros where the edge is masked or the index lies outside
    [0, N)."""
    nodes = torch.arange(n, device=idx.device)
    hit = nodes[None, :, None] == idx[:, None, :].long()
    return (hit & mask[:, None, :].bool()).float()


def one_hot_matrices(edge_src, edge_dst, edge_mask, n: int):
    """(dst matrix, src matrix, src - dst): the three [B, N, E] matrices
    of a 'onehot' layer."""
    sm = one_hot_matrix(edge_dst, edge_mask, n)
    srcm = one_hot_matrix(edge_src, edge_mask, n)
    return sm, srcm, srcm - sm


def _gather_product(onehot, t):
    """[B, N, E] x [B, N, C] -> [B, E, C] in t's dtype, summed in f32."""
    return torch.matmul(onehot.transpose(1, 2), t.float()).to(t.dtype)


def _egnn_apply_onehot(p: EGNNLayer, h, x, edge_feat, matrices):
    """One layer on prebuilt ``one_hot_matrices`` (JAX ``egnn_apply`` with
    scatter/src/diff matrices)."""
    sm, srcm, diff = matrices
    h_src = _gather_product(srcm, h)
    h_dst = _gather_product(sm, h)
    x_diff = _gather_product(diff, x)                        # x's dtype
    m, msg_x = _edge_mlp(p, h_src, h_dst, x_diff, edge_feat)
    both = torch.cat([m, msg_x.to(m.dtype)], dim=-1)
    agg = torch.matmul(sm, both.float()).to(both.dtype)      # [B, N, H+3]
    hid = m.shape[-1]
    return _node_update(p, h, x, agg[..., :hid], agg[..., hid:].to(x.dtype))


def _egnn_apply_onehot_remat(p: EGNNLayer, h, x, edge_src, edge_dst,
                             edge_feat, edge_mask):
    """'onehot' with the matrices built inside a non-reentrant checkpoint:
    the backward rebuilds them with the rest of the layer."""
    def layer(h, x):
        mats = one_hot_matrices(edge_src, edge_dst, edge_mask, h.shape[1])
        return _egnn_apply_onehot(p, h, x, edge_feat, mats)

    return checkpoint(layer, h, x, use_reentrant=False)


# --------------------------------------------------------------------------
# the kernel paths
# --------------------------------------------------------------------------

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
            "'onehot' there); use 'onehot', 'mega' or 'scatter'")


def _egnn_apply_fused(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                      edge_mask):
    b, n, f = h.shape
    e = edge_src.shape[1]
    check_fused(e, edge_feat.shape[-1])
    dt = h.dtype
    src_ok = (edge_mask & (edge_src >= 0) & (edge_src < n)).contiguous()
    dst_ok = (edge_mask & (edge_dst >= 0) & (edge_dst < n)).contiguous()
    # in range before any CUDA indexing: an out-of-range index on the card
    # is a fault, not a zero
    src = torch.where(src_ok, edge_src, 0).to(torch.int32).contiguous()
    dst = torch.where(dst_ok, edge_dst, 0).to(torch.int32).contiguous()
    rows = torch.cat([h, x.to(dt)], dim=-1).reshape(b * n, f + 3)
    hsx = _GatherRows.apply(rows, src, src_ok).transpose(1, 2).contiguous()
    hdx = _GatherRows.apply(rows, dst, dst_ok).transpose(1, 2).contiguous()
    ef = edge_feat.to(dt).transpose(1, 2).contiguous()        # [B, 1, E]
    w1ab, w2, wc1, small = pack_params(p.edge_mlp, p.coord_mlp)
    both = edge_program(hsx, hdx, ef, w1ab, w2, wc1, small)   # [B, H+3, E]
    c = both.shape[1]
    # the aggregation through B8's scatter in f32 (each (n, c) in edge
    # order), rounded once to the compute dtype
    msgs = both.transpose(1, 2).float().contiguous()          # [B, E, H+3]
    agg = SegmentScatter.apply(dst, dst_ok, msgs, n).to(dt)
    return _node_update(p, h, x, agg[..., :c - 3], agg[..., c - 3:].to(x.dtype))


def check_pallas(edge_count: int) -> None:
    """JAX's admission rule for 'pallas' (``egnn_stack_apply``: E a
    multiple of 128, ``_pick_tile``): raise where the JAX package would
    fall back to 'onehot'."""
    if edge_count < EDGE_MULTIPLE or edge_count % EDGE_MULTIPLE:
        raise ValueError(
            f"aggregation='pallas' takes a multiple of {EDGE_MULTIPLE} "
            f"edges, got E={edge_count} (the JAX package falls back to "
            "'onehot' there); use 'onehot', 'mega' or 'scatter'")


def _egnn_apply_pallas(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                       edge_mask):
    check_pallas(edge_src.shape[1])
    n = h.shape[1]
    ok = edge_mask.bool()
    h, x, m, msg_x = _fanned_messages(
        p, h, x, edge_src, edge_dst, edge_feat,
        lambda g: _rounded_sums(edge_src, ok, g, n),
        lambda g: _rounded_sums(edge_dst, ok, g, n))
    hid = m.shape[-1]
    both = torch.cat([m, msg_x.to(m.dtype)], dim=-1)          # compute dtype
    agg = SegmentScatter.apply(edge_dst.to(torch.int32).contiguous(),
                               edge_mask.contiguous(), both.contiguous(),
                               h.shape[1])                    # [B, N, H+3]
    return _node_update(p, h, x, agg[..., :hid], agg[..., hid:].to(x.dtype))


def _apply_layer(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                 edge_mask, aggregation: str, mega_variant: str,
                 matrices=None):
    """One layer under a resolved aggregation; ``matrices``: the stack's
    shared ``one_hot_matrices`` under 'onehot', its ``scatter_passes``
    under 'scatter' in a narrow dtype (None: built here)."""
    if aggregation == "mega":
        return _egnn_apply_mega(p, h, x, edge_src, edge_dst, edge_feat,
                                edge_mask, mega_variant)
    if aggregation == "fused":
        return _egnn_apply_fused(p, h, x, edge_src, edge_dst, edge_feat,
                                 edge_mask)
    if aggregation == "pallas":
        return _egnn_apply_pallas(p, h, x, edge_src, edge_dst, edge_feat,
                                  edge_mask)
    if aggregation == "onehot":
        if matrices is None:
            matrices = one_hot_matrices(edge_src, edge_dst, edge_mask,
                                        h.shape[1])
        return _egnn_apply_onehot(p, h, x, edge_feat, matrices)
    if aggregation == "onehot_remat":
        return _egnn_apply_onehot_remat(p, h, x, edge_src, edge_dst,
                                        edge_feat, edge_mask)
    return _egnn_apply_scatter(p, h, x, edge_src, edge_dst, edge_feat,
                               edge_mask, matrices)


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
    aggregation = stack_aggregation(aggregation, p, h, edge_src, edge_feat)
    check_variant(mega_variant, aggregation)
    if mega_variant == "stack":
        raise ValueError("mega_variant='stack' runs the whole conv stack "
                         "in one kernel: call egnn_stack_apply")
    return _apply_layer(p, h, x, edge_src, edge_dst, edge_feat, edge_mask,
                        aggregation, mega_variant)


def check_fused_stack(aggregation: str, mega_variant: str, tensors) -> None:
    """Raise unless ``fused_stack`` can run: aggregation 'auto', variant
    'hybrid', and no gradient needed (B7 is forward only)."""
    if aggregation != "auto":
        raise ValueError("fused_stack runs every layer through B7, not "
                         f"through aggregation '{aggregation}'; leave "
                         "aggregation at 'auto'")
    if mega_variant != "hybrid":
        raise ValueError(f"fused_stack takes no mega_variant "
                         f"('{mega_variant}'): B7 is not a form of 'mega'")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("fused_stack is forward only (B7 has no backward): "
                         "call it under torch.no_grad() or "
                         "torch.inference_mode(), with no input that "
                         "requires a gradient")


def egnn_stack_apply(layers: Sequence[EGNNLayer], h, x, edge_src, edge_dst,
                     edge_feat, edge_mask, aggregation: str = "auto",
                     mega_variant: str = "hybrid", fused_stack: bool = False):
    """Run the conv stack. Returns (h, x). ``mega_variant`` (aggregation
    'mega' only): 'stack' runs every layer in B6 (``apply_stack``);
    'paired' holds the batch to ``check_paired`` here on CPU tensors (on
    CUDA tensors, where that would stall the host, B4 computes on the
    mirror its arc half implies); the others pick each layer's kernels.
    'onehot' builds its matrices once for every layer, 'scatter' in a
    narrow dtype its sums' passes. ``fused_stack``
    (forward only, aggregation 'auto', variant 'hybrid') runs every layer
    in B7 (``fused_egnn_stack``); edge features must be all ones, which is
    checked on CPU tensors."""
    if fused_stack:
        params = [t for p in layers for t in p.parameters()]
        check_fused_stack(aggregation, mega_variant, [h, x, *params])
        if edge_feat.device.type == "cpu" and not bool(
                (edge_feat[edge_mask.bool()] == 1).all()):
            raise ValueError("fused_stack reads no edge features (B7 folds "
                             "an all-ones feature into the bias), and this "
                             "batch has features other than 1")
        return fused_egnn_stack(layers, h, x, edge_src, edge_dst, edge_mask)
    aggregation = stack_aggregation(aggregation, layers[0], h, edge_src,
                                    edge_feat)
    check_variant(mega_variant, aggregation)
    if mega_variant == "stack":
        return apply_stack(layers, h, x, edge_src, edge_dst, edge_feat,
                           edge_mask)
    if mega_variant == "paired" and edge_src.device.type == "cpu":
        check_paired(edge_src, edge_dst, edge_mask)
    matrices = None
    if aggregation == "onehot":
        matrices = one_hot_matrices(edge_src, edge_dst, edge_mask,
                                    h.shape[1])
    elif aggregation == "scatter" and ordered_scatter(h, x):
        matrices = scatter_passes(edge_src, edge_dst, edge_mask, h.shape[1])
    for p in layers:
        h, x = _apply_layer(p, h, x, edge_src, edge_dst, edge_feat,
                            edge_mask, aggregation, mega_variant, matrices)
    return h, x
