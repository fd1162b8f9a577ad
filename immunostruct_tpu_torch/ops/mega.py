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

Two hand-written Hopper kernels carry it, each with its plain PyTorch
version beside it in this module:

  B1  ``edge_mega_fwd``  -> csrc/egnn_mega_fwd.cu  (plain: ``edge_mega_fwd_reference``)
      the forward; for training it also writes the residuals a1 [B,H,E] and
      xd [B,3,E] in the compute dtype.
  B2  ``tail_bwd``       -> csrc/egnn_tail_bwd.cu  (plain: ``tail_bwd_reference``)
      the backward of the edge/coordinate MLP chain from a1/xd and the
      cotangent d_both = g[dst]: d_cat = [d_a1 ; d_xd], d_ef, and the f32
      weight gradients dW2, dWc1, dsmall summed over all edges.

``edge_half_bwd`` finishes the backward at node level in PyTorch (the
gathers' transposes by src/dst, d_h, d_x, dW1ab), as the JAX package
leaves it to XLA einsums. ``EdgeMega`` is the ``torch.autograd.Function``
and ``edge_mega`` the op. A CUDA tensor launches the kernels or raises; a
CPU tensor takes the plain versions. A forward that needs no gradient
(inference) skips the residual stores.

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

import torch

from immunostruct_tpu_torch.ops.edge import (  # noqa: F401 (pack_params re-exported)
    B1, B2, BC1, KERNEL_MAX_F, W1E, W1R, WC2, check_cuda_args,
    chunks_per_graph, hopper, pack_params, silu_grad,
)


def valid_edges(src, dst, mask, n: int) -> torch.Tensor:
    """[B, E] bool: the edges the kernels compute (mask True, both indices
    in [0, N))."""
    return mask & (src >= 0) & (src < n) & (dst >= 0) & (dst < n)


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def edge_mega_fwd_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """Plain PyTorch version of B1, with the same rounding points.

    src/dst [B, E] int, mask [B, E] bool, ef [B, E, 1], h [B, N, F] and
    x [B, N, 3] in the compute dtype, weights as ``pack_params`` returns
    them. Returns (out [B, N, H+3] f32, a1 [B, H, E], xd [B, 3, E]), the
    residuals in the compute dtype and zero on skipped edges."""
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
    pa = rnd(torch.matmul(hf, w1[:f]))
    pb = rnd(torch.matmul(hf, w1[f:]))
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
    cw = (c1 * sm[:, WC2]).sum(-1, keepdim=True)
    msgx = rnd(rnd(cw) * x_hat)
    both = torch.cat([m, msgx], dim=-1) * vf
    out = torch.zeros(b, n, hid + 3, dtype=f32, device=h.device)
    out.scatter_add_(1, d[..., None].expand(-1, -1, hid + 3), both)
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
    d_p3 = rnd(sm[:, WC2] * d_cw * silu_grad(p3, s3))
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


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fwd_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_mega_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_mega_fwd.argtypes = [ptr] * 14 + [i32] * 6 + [ptr]
    lib.egnn_mega_fwd.restype = i32
    lib.egnn_mega_fwd_smem_bytes.argtypes = [i32, i32]
    lib.egnn_mega_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _tail_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_tail_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_tail_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
    lib.egnn_tail_bwd.restype = i32
    lib.egnn_tail_bwd_smem_bytes.argtypes = [i32]
    lib.egnn_tail_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def _kernel_libs():
    """Build (at first use) and load both kernels' libraries."""
    return _fwd_lib(), _tail_lib()


def edge_mega_fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                  residuals: bool = True):
    """B1: (out [B, N, H+3] f32, a1 [B, H, E], xd [B, 3, E]); a1 and xd are
    None when ``residuals`` is False (the kernel then skips their stores).

    CUDA tensors launch csrc/egnn_mega_fwd.cu or raise; CPU tensors go
    through ``edge_mega_fwd_reference``. ``edge_mega.launches`` counts the
    kernel's launches."""
    if h.device.type == "cpu":
        out, a1, xd = edge_mega_fwd_reference(src, dst, mask, ef, h, x,
                                              w1ab, w2, wc1, small)
        return (out, a1, xd) if residuals else (out, None, None)
    if h.device.type != "cuda":
        raise ValueError(f"edge_mega runs on cuda or cpu tensors, "
                         f"not {h.device.type}")
    b, n, f = h.shape
    e = src.shape[1]
    hid = w2.shape[1]
    check_cuda_args("edge_mega", {
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
        raise ValueError(f"edge_mega kernel takes 1 <= F <= {KERNEL_MAX_F}, "
                         f"got F={f}")
    if b == 0 or n == 0:
        raise ValueError("edge_mega: empty batch or graph")
    lib = _fwd_lib()
    with torch.cuda.device(h.device):
        props = hopper(h.device, "edge_mega")
        smem = lib.egnn_mega_fwd_smem_bytes(n, hid)
        if smem > props.shared_memory_per_block_optin:
            raise ValueError(
                f"edge_mega kernel needs {smem} B of shared memory for "
                f"N={n}, H={hid}; the card allows "
                f"{props.shared_memory_per_block_optin} B per block")
        out = torch.empty(b, n, hid + 3, dtype=torch.float32,
                          device=h.device)
        proj = torch.empty(b, n, 2 * hid, dtype=torch.float32,
                           device=h.device)
        a1 = xd = None
        if residuals:
            a1 = torch.empty(b, hid, e, dtype=h.dtype, device=h.device)
            xd = torch.empty(b, 3, e, dtype=h.dtype, device=h.device)
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.egnn_mega_fwd(
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), ef.data_ptr(),
            h.data_ptr(), x.data_ptr(), w1ab.data_ptr(), w2.data_ptr(),
            wc1.data_ptr(), small.data_ptr(), out.data_ptr(),
            proj.data_ptr(), a1.data_ptr() if residuals else None,
            xd.data_ptr() if residuals else None, b, n, e, f, hid,
            int(h.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_mega_fwd launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, E={e}, F={f}, H={hid})")
    edge_mega.launches += 1
    return out, a1, xd


def tail_bwd(ef, w2, wc1, small, a1, xd, d_both, valid):
    """B2: (d_cat [B, H+3, E], d_ef [B, 1, E], dW2, dWc1, dsmall), the
    contract of ``tail_bwd_reference`` with ``valid`` [B, E] bool required.

    CUDA tensors launch csrc/egnn_tail_bwd.cu (its per-block partial
    weight gradients and their fixed-order reduction) or raise; CPU
    tensors go through ``tail_bwd_reference``. ``tail_bwd.launches``
    counts the kernel's launches."""
    if a1.device.type == "cpu":
        return tail_bwd_reference(ef, w2, wc1, small, a1, xd, d_both, valid)
    if a1.device.type != "cuda":
        raise ValueError(f"tail_bwd runs on cuda or cpu tensors, "
                         f"not {a1.device.type}")
    b, hid, e = a1.shape
    c = hid + 3
    dt = a1.dtype
    check_cuda_args("tail_bwd", {
        "a1": (a1, dt, (b, hid, e)),
        "ef": (ef, dt, (b, e, 1)),
        "xd": (xd, dt, (b, 3, e)),
        "d_both": (d_both, dt, (b, c, e)),
        "valid": (valid, torch.bool, (b, e)),
        "w2": (w2, torch.float32, (hid, hid)),
        "wc1": (wc1, torch.float32, (hid, hid)),
        "small": (small, torch.float32, (hid, 6)),
    }, dt, hid)
    if b == 0:
        raise ValueError("tail_bwd: empty batch")
    lib = _tail_lib()
    with torch.cuda.device(a1.device):
        props = hopper(a1.device, "edge_mega")
        smem = lib.egnn_tail_bwd_smem_bytes(hid)
        if smem > props.shared_memory_per_block_optin:
            raise ValueError(
                f"tail_bwd kernel needs {smem} B of shared memory for "
                f"H={hid}; the card allows "
                f"{props.shared_memory_per_block_optin} B per block")
        # one CTA per (graph, edge chunk): at least one CTA per SM
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        width = 2 * hid * hid + 6 * hid
        d_cat = torch.empty(b, c, e, dtype=dt, device=a1.device)
        d_ef = torch.empty(b, 1, e, dtype=dt, device=a1.device)
        grads = torch.empty(width, dtype=torch.float32, device=a1.device)
        partial = torch.empty(b * chunks, width, dtype=torch.float32,
                              device=a1.device)
        stream = torch.cuda.current_stream(a1.device).cuda_stream
        rc = lib.egnn_tail_bwd(
            valid.data_ptr(), ef.data_ptr(), w2.data_ptr(), wc1.data_ptr(),
            small.data_ptr(), a1.data_ptr(), xd.data_ptr(),
            d_both.data_ptr(), d_cat.data_ptr(), d_ef.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), b, e, hid, chunks,
            int(dt == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_tail_bwd launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, H={hid})")
    tail_bwd.launches += 1
    hh = hid * hid
    return (d_cat, d_ef, grads[:hh].view(hid, hid),
            grads[hh:2 * hh].view(hid, hid), grads[2 * hh:].view(hid, 6))


tail_bwd.launches = 0


# --------------------------------------------------------------------------
# backward at node level, and the autograd Function
# --------------------------------------------------------------------------

def edge_half_bwd(src, dst, valid, ef, h, x, w1ab, w2, wc1, small, a1, xd,
                  g, tail=tail_bwd):
    """Backward of one edge half-layer from the forward's residuals and the
    cotangent g [B, N, H+3] of its output: the counterpart of
    ``_edge_half_bwd`` + ``_finish_node_grads``. ``tail`` is B2 (``tail_bwd``
    or ``tail_bwd_reference``). Returns (d_ef [B, E, 1], d_h [B, N, F],
    d_x [B, N, 3], dw1ab [2F, H], dw2, dwc1, dsmall), node-level gradients
    in f32, d_ef in the compute dtype."""
    dt = h.dtype
    f32 = torch.float32
    b, n, f = h.shape
    hid = w2.shape[1]
    c = hid + 3
    s = torch.where(valid, src, 0).long()[..., None].expand(-1, -1, c)
    d = torch.where(valid, dst, 0).long()[..., None].expand(-1, -1, c)
    d_both = torch.gather(g.to(dt), 1, d)                       # [B, E, C]
    d_both = torch.where(valid[..., None], d_both, 0.0)
    d_cat, d_ef, dw2, dwc1, dsmall = tail(
        ef, w2, wc1, small, a1, xd, d_both.transpose(1, 2).contiguous(),
        valid)
    dcf = d_cat.transpose(1, 2).to(f32)                         # [B, E, C]
    d_src = torch.zeros(b, n, c, dtype=f32, device=h.device)
    d_src.scatter_add_(1, s, dcf)
    d_dst = torch.zeros(b, n, c, dtype=f32, device=h.device)
    d_dst.scatter_add_(1, d, dcf)
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
    """``edge_mega`` with its backward: B1 with residuals forward; B2 and
    ``edge_half_bwd`` backward. Gradients for ef, h, x, w1ab, w2, wc1 and
    small, each in its input's dtype."""

    @staticmethod
    def forward(ctx, src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
        out, a1, xd = edge_mega_fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1,
                                    small, residuals=True)
        valid = valid_edges(src, dst, mask, h.shape[1])
        ctx.save_for_backward(src, dst, valid, ef, h, x, w1ab, w2, wc1,
                              small, a1, xd)
        return out

    @staticmethod
    def backward(ctx, g):
        src, dst, valid, ef, h, x, w1ab, w2, wc1, small, a1, xd = \
            ctx.saved_tensors
        grads = edge_half_bwd(src, dst, valid, ef, h, x, w1ab, w2, wc1,
                              small, a1, xd, g)
        inputs = (ef, h, x, w1ab, w2, wc1, small)
        return (None, None, None) + tuple(
            gr.to(t.dtype) if need else None
            for gr, t, need in zip(grads, inputs, ctx.needs_input_grad[3:]))


def edge_mega(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """EGNN edge half-layer: [B, N, H+3] f32 per-node sums of messages
    (columns 0..H-1) and coordinate messages (columns H..H+2).

    Differentiable (``EdgeMega``) when gradients are enabled and an input
    requires one; otherwise B1 runs without its residual stores. CUDA
    tensors launch the Hopper kernels or raise; CPU tensors take the plain
    versions. ``edge_mega.launches`` counts B1's launches,
    ``tail_bwd.launches`` B2's."""
    ef = ef.to(h.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ef, h, x, w1ab, w2, wc1, small)):
        return EdgeMega.apply(src, dst, mask, ef, h, x, w1ab, w2, wc1, small)
    return edge_mega_fwd(src, dst, mask, ef, h, x, w1ab, w2, wc1, small,
                         residuals=False)[0]


edge_mega.launches = 0
