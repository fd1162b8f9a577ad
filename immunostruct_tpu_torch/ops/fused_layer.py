"""One whole EGNN layer in one kernel, forward only (counterpart of
``immunostruct_tpu/ops/experimental/pallas_egnn.py``: ``fused_egnn_layer``,
``fused_egnn_stack``).

One hand-written Hopper kernel carries it, with its plain PyTorch version
beside it:

  B7  ``fused_egnn_layer`` -> csrc/egnn_layer_fwd.cu  (plain: ``fused_egnn_layer_reference``)
      per graph: the gathers by src and dst, ``x_diff``, the edge and
      coordinate MLPs, the f32 sums at dst, the node MLP and ``x' = x +
      x_agg``. h' [B, N, H] in the compute dtype (h's), x' [B, N, 3] in x's
      dtype. With bf16 h every product runs on the tensor cores and a graph
      spans a thread-block cluster of ``layer_cluster_size`` CTAs; the sums
      take no atomics and the cluster's partial sums meet in rank order, so
      a forward gives the same bits every run.

The kernel reads no edge features: like the JAX kernel it takes them to be
all ones and folds their weight row into the first bias, so the layer's
edge-feature width must be 1 (its first weight has 2F+2 rows). Whether the
features are ones is the caller's contract, as in JAX
(``egnn_stack_apply(fused_stack=True)`` checks it on CPU tensors, the
request builder on the host).

Rounding points under bf16 are those of the 'mega' forward that B7 serves
in place of (``edge_mega_fwd_reference``'s, then ``egnn._node_update``'s),
not those of ``_fused_layer_kernel`` (pallas_egnn.py:56-125): on trained
weights the TPU kernel's roundings (the projections, x_diff, cw and the
coordinate sum kept in f32, the biases rounded) part the served
probabilities from the 'mega' forward's by up to 0.085 in bf16 (PERF.md
§6). The weight matrices are rounded to the compute dtype, the biases,
w_rad, wc2 and w_ef = we1[2F+1] stay f32; x is cast to the compute dtype;
x_diff and radial are rounded, x_hat is f32; each projection h_src @ W_src
and h_dst @ W_dst is rounded before they are summed in f32 with radial *
w_rad, then w_ef (the all-ones feature's row), then be1, in B1's order (a
bias folded as be1 + w_ef moved trained models' served probabilities by up
to 1.4e-3 from 'mega''s); silu(z1), m and the coordinate MLP's hidden c1
are rounded, and so are cw and msg_x = cw * x_hat; every product of the
edge chain is summed in k order (``projection_in_order``: the kernel
recomputes a projection, m or c1 near a bf16 tie in that order) and cw in
B1's order (``cw_in_order``); the sums at dst are f32
and rounded before the node update; zn = [h ++ agg] @ Wn1 + bn1 (the
product summed in k order, as ``projection_in_order`` sums it, so that the
kernel can recompute a zn near a bf16 tie in the same order) is rounded
before its silu; the node MLP's silu a = zn * s, s = 1 / (1 + exp(-zn)),
rounds exp, the sum, the quotient and the product, as the node update's
(``nnp.silu``, ``jax.nn.silu``'s points); h' is rounded; x' = x + x_agg in
x's dtype. In f32 every rounding is exact and B7 computes what the TPU kernel
computes.

Masking (``_fused_layer_kernel``'s and the JAX 'mega' layer's, not the
port's B1, which skips such an edge): a masked edge gathers zeros on both
sides and is summed nowhere; an unmasked edge whose src lies outside [0, N)
gathers zeros on that side (x_diff = -x[dst]) and is still summed at its
dst; a dst outside [0, N) is summed nowhere.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. ``fused_egnn_layer.launches`` counts the kernel's launches. The
wrapper raises where a gradient would be needed (B7 has no backward, as
the JAX kernel has no VJP), for E not a multiple of 128 (JAX asserts it),
for an edge-feature width other than 1, and on the card for H other than
64, F above 64 or a shared-memory need above the card's per-block limit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from immunostruct_tpu_torch.ops.edge import (
    EDGE_MULTIPLE, KERNEL_MAX_F, check_cuda_args, hopper,
)
from immunostruct_tpu_torch.ops.mega import cw_in_order, projection_in_order


def _layer_tensors(layer):
    """The layer's weights in the kernel's packed order: we1 [2F+2, H], be1,
    we2 [H, H], be2, wc1 [H, H], bc1, wc2 [H, 1], wn1 [F+H, H], bn1, wn2
    [H, H], bn2."""
    (e0, e1), (n0, n1), (c0, c1) = (layer.edge_mlp, layer.node_mlp,
                                    layer.coord_mlp)
    return (e0.w, e0.b, e1.w, e1.b, c0.w, c0.b, c1.w, n0.w, n0.b, n1.w,
            n1.b)


def fused_egnn_layer_reference(layer, h, x, edge_src, edge_dst, edge_mask):
    """Plain PyTorch version of B7, with its rounding points and masking
    (module docstring). h [B, N, F] in the compute dtype, x [B, N, 3],
    edge_src/edge_dst [B, E] int, edge_mask [B, E] bool. Returns (h'
    [B, N, H] in h's dtype, x' [B, N, 3] in x's dtype)."""
    dt = h.dtype
    f32 = torch.float32
    b, n, f = h.shape

    def rnd(t):
        return t.to(dt).to(f32)

    def silu(t):
        return t * torch.sigmoid(t)

    raw = [t.detach().float() for t in _layer_tensors(layer)]
    we1, be1, we2, be2, wc1, bc1, wc2, wn1, bn1, wn2, bn2 = raw
    w_ef = we1[2 * f + 1]                            # f32
    w_rad = we1[2 * f]
    we1, we2, wc1, wn1, wn2 = (rnd(t) for t in (we1, we2, wc1, wn1, wn2))
    edge_mask = edge_mask.bool()
    src_ok = edge_mask & (edge_src >= 0) & (edge_src < n)
    dst_ok = edge_mask & (edge_dst >= 0) & (edge_dst < n)
    s = torch.where(src_ok, edge_src, 0).long()
    d = torch.where(dst_ok, edge_dst, 0).long()

    def gather(t, idx, ok):
        rows = torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
        return torch.where(ok[..., None], rows, 0.0)

    hf = h.float()
    xc = rnd(x)
    x_diff = rnd(gather(xc, s, src_ok) - gather(xc, d, dst_ok))
    radial = rnd((x_diff * x_diff).sum(-1, keepdim=True))
    safe = torch.where(radial > 0, radial, torch.ones_like(radial))
    x_hat = x_diff / (torch.sqrt(safe) + 1e-30)
    pa = rnd(projection_in_order(gather(hf, s, src_ok), we1[:f]))
    pb = rnd(projection_in_order(gather(hf, d, dst_ok), we1[f:2 * f]))
    z1 = pa + pb + radial * w_rad + w_ef + be1       # B1's order
    m1 = rnd(silu(z1))
    m = rnd(silu(projection_in_order(m1, we2) + be2))
    c1 = rnd(silu(projection_in_order(m, wc1) + bc1))
    cw = rnd(cw_in_order(c1, wc2[:, 0]))                        # [B, E, 1]
    msg_x = rnd(cw * x_hat)
    both = torch.where(dst_ok[..., None], torch.cat([m, msg_x], dim=-1), 0.0)
    hid = m.shape[-1]
    agg = torch.zeros(b, n, hid + 3, dtype=f32, device=h.device)
    agg.scatter_add_(1, d[..., None].expand(-1, -1, hid + 3), both)
    agg = rnd(agg)
    zn = rnd(projection_in_order(torch.cat([hf, agg[..., :hid]], dim=-1), wn1)
             + bn1)
    a = rnd(zn * rnd(torch.reciprocal(rnd(1 + rnd(torch.exp(-zn))))))
    h_new = (torch.matmul(a, wn2) + bn2).to(dt)
    x_new = (x.float() + agg[..., hid:]).to(x.dtype)
    return h_new, x_new


@functools.lru_cache(maxsize=None)
def _lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_layer_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_layer_fwd.argtypes = [ptr] * 8 + [i32] * 8 + [ptr]
    lib.egnn_layer_fwd.restype = i32
    lib.egnn_layer_fwd_ctas_per_sm.argtypes = [i32] * 3
    lib.egnn_layer_fwd_ctas_per_sm.restype = i32
    lib.egnn_layer_fwd_max_clusters.argtypes = [i32] * 3
    lib.egnn_layer_fwd_max_clusters.restype = i32
    lib.egnn_layer_fwd_smem_bytes.argtypes = [i32] * 4
    lib.egnn_layer_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_layer_fwd_weight_count.argtypes = [i32, i32]
    lib.egnn_layer_fwd_weight_count.restype = ctypes.c_longlong
    return lib


MAX_CLUSTER = 8  # the portable thread-block cluster size


def layer_cluster_size(e: int, b: int, sms: int) -> int:
    """CTAs a graph of B7's bf16 form (a thread-block cluster a graph, one
    CTA an SM): as many as fill the card's ``sms`` SMs in one wave, at least
    two 64-edge tiles a CTA, at most MAX_CLUSTER."""
    tiles = max(1, -(-e // 64))
    return max(1, min(MAX_CLUSTER, sms // b, tiles // 2))


def _check(layer, h, x, edge_src) -> None:
    """The raises the wrapper owes on every device."""
    params = _layer_tensors(layer)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, x, *params)):
        raise ValueError("fused_egnn_layer (B7) is forward only: it has no "
                         "backward, as the JAX kernel has no VJP; call it "
                         "under torch.no_grad() or torch.inference_mode()")
    e = edge_src.shape[1]
    if e < EDGE_MULTIPLE or e % EDGE_MULTIPLE:
        raise ValueError(f"fused_egnn_layer takes a multiple of "
                         f"{EDGE_MULTIPLE} edges, got E={e}")
    f = h.shape[-1]
    if params[0].shape[0] != 2 * f + 2:
        raise ValueError(
            "fused_egnn_layer takes edge features of width 1 (all ones, "
            f"folded into the bias): the layer's first weight has "
            f"{params[0].shape[0]} rows, not 2F+2 = {2 * f + 2}")


def fused_egnn_layer(layer, h, x, edge_src, edge_dst, edge_mask):
    """B7: one EGNN layer, (h' [B, N, H] in h's dtype, x' [B, N, 3] in x's
    dtype). ``layer`` an ``EGNNLayer`` of edge-feature width 1; the edge
    features are taken as all ones.

    CUDA tensors launch csrc/egnn_layer_fwd.cu or raise; CPU tensors go
    through ``fused_egnn_layer_reference``. Forward only: raises when a
    gradient would be needed."""
    _check(layer, h, x, edge_src)
    if h.device.type == "cpu":
        return fused_egnn_layer_reference(layer, h, x, edge_src, edge_dst,
                                          edge_mask)
    if h.device.type != "cuda":
        raise ValueError(f"fused_egnn_layer runs on cuda or cpu tensors, "
                         f"not {h.device.type}")
    b, n, f = h.shape
    e = edge_src.shape[1]
    dt = h.dtype
    hid = layer.edge_mlp[1].w.shape[1]
    h_out = layer.node_mlp[1].w.shape[1]
    if h_out != hid:
        raise ValueError(f"fused_egnn_layer kernel writes H={hid} columns; "
                         f"the node MLP's output width is {h_out}")
    if not 1 <= f <= KERNEL_MAX_F:
        raise ValueError(f"fused_egnn_layer kernel takes 1 <= F <= "
                         f"{KERNEL_MAX_F}, got F={f}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_egnn_layer kernel takes float32 or "
                         f"bfloat16 coordinates, got {x.dtype}")
    src = edge_src.to(torch.int32).contiguous()
    dst = edge_dst.to(torch.int32).contiguous()
    mask = edge_mask.to(torch.bool).contiguous()
    h, x = h.contiguous(), x.contiguous()
    if h.data_ptr() % 16:
        h = h.clone()  # the kernel copies rows of h in 16-byte pieces
    check_cuda_args("fused_egnn_layer", {
        "h": (h, dt, (b, n, f)),
        "x": (x, x.dtype, (b, n, 3)),
        "src": (src, torch.int32, (b, e)),
        "dst": (dst, torch.int32, (b, e)),
        "mask": (mask, torch.bool, (b, e)),
    }, dt, hid)
    lib = _lib()
    bf16 = int(dt == torch.bfloat16)
    with torch.cuda.device(h.device):
        props = hopper(h.device, "fused_egnn_layer")
        smem = lib.egnn_layer_fwd_smem_bytes(n, f, hid, bf16)
        if smem > props.shared_memory_per_block_optin:
            raise ValueError(
                f"fused_egnn_layer kernel needs {smem} B of shared memory "
                f"for N={n}, F={f}, H={hid} in {dt}; the card allows "
                f"{props.shared_memory_per_block_optin} B per block")
        weights = torch.cat([t.detach().reshape(-1).to(h.device,
                                                       torch.float32)
                             for t in _layer_tensors(layer)])
        assert weights.numel() == lib.egnn_layer_fwd_weight_count(f, hid)
        cluster = (layer_cluster_size(e, b, props.multi_processor_count)
                   if bf16 else 1)
        h_new = torch.empty(b, n, hid, dtype=dt, device=h.device)
        x_new = torch.empty(b, n, 3, dtype=x.dtype, device=h.device)
        rc = lib.egnn_layer_fwd(
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), h.data_ptr(),
            x.data_ptr(), weights.data_ptr(), h_new.data_ptr(),
            x_new.data_ptr(), b, n, e, f, hid, bf16,
            int(x.dtype == torch.bfloat16), cluster,
            torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"egnn_layer_fwd launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, E={e}, F={f}, H={hid}, "
                           f"cluster={cluster})")
    fused_egnn_layer.launches += 1
    return h_new, x_new


fused_egnn_layer.launches = 0


def fused_egnn_stack(layers, h, x, edge_src, edge_dst, edge_mask):
    """Forward-only stack: ``fused_egnn_layer`` per layer, in order.
    Returns (h, x)."""
    for layer in layers:
        h, x = fused_egnn_layer(layer, h, x, edge_src, edge_dst, edge_mask)
    return h, x
