"""E(n)-equivariant graph convolution over padded edge lists (counterpart of
``immunostruct_tpu/ops/egnn.py``).

Same math as the JAX package (EGNN of Satorras et al. 2021 as DGL's
EGNNConv implements it): messages flow src -> dst and are summed at the
destination; padded edges contribute nothing; padded nodes still flow
through the node MLP.

Aggregation strategies:
  'scatter'  ``index_select`` gathers and ``index_add_`` aggregation (sums
             in f32) with the radial guard of the JAX package. The CPU path
             and the plain reference for the kernel path.
  'mega'     the edge half of every layer in one hand-written Hopper kernel
             from the raw edge indices (ops/mega.py); the node MLP stays in
             PyTorch. On CPU tensors ``edge_mega`` runs its plain version.
  'auto'     'mega' for CUDA tensors, 'scatter' for CPU tensors.
The JAX package's other names ('onehot', 'fused', 'onehot_remat', 'pallas')
are not ported yet and raise (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from immunostruct_tpu_torch.ops.mega import edge_mega, pack_params
from immunostruct_tpu_torch.ops.nnp import Linear, linear_apply

NOT_PORTED = ("onehot", "fused", "onehot_remat", "pallas")


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
    if aggregation in ("scatter", "mega"):
        return aggregation
    if aggregation in NOT_PORTED:
        raise ValueError(
            f"aggregation '{aggregation}' is not ported to PyTorch yet "
            "(see ROADMAP.md, kernels still to port); use 'scatter', "
            "'mega' or 'auto'")
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


def _egnn_apply_scatter(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                        edge_mask):
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

    hid = m.shape[-1]
    both = torch.cat([m.float(), msg_x.float()], dim=-1)
    both = both * edge_mask.reshape(b, e, 1).to(both.dtype)
    agg = torch.zeros(b * n, hid + 3, dtype=torch.float32, device=h.device)
    agg.index_add_(0, dst, both.reshape(b * e, hid + 3))
    agg = agg.reshape(b, n, hid + 3)
    return _node_update(p, h, x, agg[..., :hid].to(m.dtype),
                        agg[..., hid:].to(x.dtype))


def _egnn_apply_mega(p: EGNNLayer, h, x, edge_src, edge_dst, edge_feat,
                     edge_mask):
    if edge_feat.shape[-1] != 1:
        raise ValueError("aggregation 'mega' takes 1-dim edge features, got "
                         f"{edge_feat.shape[-1]}")
    w1ab, w2, wc1, small = pack_params(p.edge_mlp, p.coord_mlp)
    agg = edge_mega(edge_src, edge_dst, edge_mask, edge_feat, h,
                    x.to(h.dtype), w1ab, w2, wc1, small).to(h.dtype)
    c = agg.shape[-1] - 3
    return _node_update(p, h, x, agg[..., :c], agg[..., c:].to(x.dtype))


def egnn_apply(p: EGNNLayer, h: torch.Tensor, x: torch.Tensor,
               edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_feat: torch.Tensor, edge_mask: torch.Tensor,
               aggregation: str = "scatter"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EGNN layer. h [B,N,F], x [B,N,3], edge_src/edge_dst [B,E],
    edge_feat [B,E,1], edge_mask [B,E]. Returns (h', x')."""
    aggregation = resolve_aggregation(aggregation, h.device)
    if aggregation == "mega":
        return _egnn_apply_mega(p, h, x, edge_src, edge_dst, edge_feat,
                                edge_mask)
    return _egnn_apply_scatter(p, h, x, edge_src, edge_dst, edge_feat,
                               edge_mask)


def egnn_stack_apply(layers: Sequence[EGNNLayer], h, x, edge_src, edge_dst,
                     edge_feat, edge_mask, aggregation: str = "auto"):
    """Run the conv stack. Returns (h, x)."""
    aggregation = resolve_aggregation(aggregation, h.device)
    for p in layers:
        h, x = egnn_apply(p, h, x, edge_src, edge_dst, edge_feat, edge_mask,
                          aggregation)
    return h, x
