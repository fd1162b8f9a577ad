"""The whole EGNN conv stack in one kernel (counterpart of
``immunostruct_tpu/ops/experimental/pallas_stack.py``: ``edge_mega_stack``,
its custom VJP, ``pack_layer`` and ``apply_stack``).

One hand-written Hopper kernel carries the forward, with its plain PyTorch
version beside it:

  B6  ``stack_fwd`` -> csrc/egnn_stack_fwd.cu  (plain: ``stack_fwd_reference``)
      all L layers of one graph in one CTA: per layer B1's edge half, the
      aggregate rounded to the compute dtype, the node MLP and x += agg_x,
      with h and x resident. For training it also returns, per layer, h and
      x after the layer (hs, xs), the aggregate (aggs) and the edge half's
      residuals (a1s, xds).

Rounding points under bf16 are ``_stack_fwd_kernel``'s: B1's in the edge
half; agg rounded; p1 = [h ++ agg_h] @ nm0w + nm0b summed in f32 with the
f32 bias, silu in f32, then rounded (the per-layer path rounds p1 before
the silu as well); h rounded after the second product and its f32 bias;
x + agg_x in the compute dtype.

``StackMega`` is the ``torch.autograd.Function``: its backward is
``_stack_bwd``'s, per layer in reverse autograd through ``ops/egnn.py``'s
``_node_update`` from the saved h, x and agg, then ``edge_half_bwd`` from
the saved residuals through B2. ``apply_stack`` is ``egnn_stack_apply``'s
``mega_variant='stack'``. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain version. The JAX package falls back to the per-layer
path where the stack does not fit its VMEM budget; here a shape the kernel
cannot take raises: edge features of size other than 1, fewer than two
layers, layers that are not one input layer and identical hidden ones, or a
shared-memory need above the card's per-block limit.
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from immunostruct_tpu_torch.ops.edge import (
    KERNEL_HIDDEN, check_cuda_args, hopper, pack_params,
)
from immunostruct_tpu_torch.ops.mega import (
    _check_smem, edge_half_bwd, edge_mega_fwd_reference, valid_edges,
)

_PER_LAYER = 8  # tensors per layer in pack_layer's order


def pack_layer(layer):
    """One EGNN layer's weights as the stack kernel takes them: (w1ab, w2,
    wc1, small) of ``pack_params``, then nm0w [F+H, H], nm0b [H], nm1w
    [H, H], nm1b [H] of the node MLP. Differentiable views of the layer's
    parameters."""
    nm0, nm1 = layer.node_mlp
    return (*pack_params(layer.edge_mlp, layer.coord_mlp),
            nm0.w, nm0.b, nm1.w, nm1.b)


def stack_fwd_reference(src, dst, mask, ef, h0, x0, layers,
                        residuals: bool = True):
    """Plain PyTorch version of B6, with its rounding points.

    src/dst [B, E] int, mask [B, E] bool, ef [B, E, 1], h0 [B, N, F0] and
    x0 [B, N, 3] in the compute dtype; ``layers`` a list of ``pack_layer``
    tuples. Returns (h [B, N, H], x [B, N, 3], hs [B, L, N, H], xs
    [B, L, N, 3], aggs [B, L, N, H+3], a1s [B, L, H, E], xds [B, L, 3, E]),
    all in the compute dtype; the last five are None unless
    ``residuals``."""
    dt = h0.dtype
    f32 = torch.float32
    h, x = h0, x0
    kept = []
    for w1ab, w2, wc1, small, nm0w, nm0b, nm1w, nm1b in layers:
        hid = w2.shape[1]
        out, a1, xd = edge_mega_fwd_reference(src, dst, mask, ef, h, x,
                                              w1ab, w2, wc1, small)
        agg = out.to(dt)
        cat = torch.cat([h, agg[..., :hid]], dim=-1).to(f32)
        p1 = torch.matmul(cat, nm0w.to(dt).to(f32)) + nm0b.to(f32)
        hmid = (p1 * torch.sigmoid(p1)).to(dt).to(f32)
        h = (torch.matmul(hmid, nm1w.to(dt).to(f32)) + nm1b.to(f32)).to(dt)
        x = (x.to(f32) + agg[..., hid:].to(f32)).to(dt)
        kept.append((h, x, agg, a1, xd))
    if not residuals:
        return h, x, None, None, None, None, None
    return (h, x, *(torch.stack(ts, dim=1) for ts in zip(*kept)))


@functools.lru_cache(maxsize=None)
def _lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_stack_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_stack_fwd.argtypes = [ptr] * 15 + [i32] * 7 + [ptr]
    lib.egnn_stack_fwd.restype = i32
    lib.egnn_stack_fwd_smem_bytes.argtypes = [i32, i32]
    lib.egnn_stack_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_stack_fwd_weight_floats.argtypes = [i32, i32, i32]
    lib.egnn_stack_fwd_weight_floats.restype = ctypes.c_longlong
    return lib


def stack_fwd(src, dst, mask, ef, h0, x0, layers, residuals: bool = True):
    """B6: ``stack_fwd_reference``'s outputs (the residuals None unless
    ``residuals``; without them the kernel skips their stores).

    CUDA tensors launch csrc/egnn_stack_fwd.cu or raise; CPU tensors go
    through ``stack_fwd_reference``. ``stack_fwd.launches`` counts the
    kernel's launches."""
    if h0.device.type == "cpu":
        return stack_fwd_reference(src, dst, mask, ef, h0, x0, layers,
                                   residuals)
    if h0.device.type != "cuda":
        raise ValueError(f"stack_fwd runs on cuda or cpu tensors, "
                         f"not {h0.device.type}")
    b, n, f0 = h0.shape
    e = src.shape[1]
    nl = len(layers)
    hid = layers[0][1].shape[1]
    dt = h0.dtype
    check_cuda_args("stack_fwd", {
        "h0": (h0, dt, (b, n, f0)),
        "src": (src, torch.int32, (b, e)),
        "dst": (dst, torch.int32, (b, e)),
        "mask": (mask, torch.bool, (b, e)),
        "ef": (ef, dt, (b, e, 1)),
        "x0": (x0, dt, (b, n, 3)),
    }, dt, hid)
    if not 1 <= f0 <= KERNEL_HIDDEN:
        raise ValueError(f"stack_fwd kernel takes 1 <= F0 <= {KERNEL_HIDDEN},"
                         f" got F0={f0}")
    if b == 0 or n == 0:
        raise ValueError("stack_fwd: empty batch or graph")
    lib = _lib()
    weights = torch.cat([t.detach().reshape(-1).to(h0.device, torch.float32)
                         for layer in layers for t in layer])
    if weights.numel() != lib.egnn_stack_fwd_weight_floats(f0, hid, nl):
        raise ValueError("stack_fwd: the layers' weights do not have the "
                         f"shapes of one input layer (F0={f0}) and "
                         f"{nl - 1} hidden layers of width H={hid}")
    with torch.cuda.device(h0.device):
        props = hopper(h0.device, "stack_fwd")
        _check_smem(props, lib.egnn_stack_fwd_smem_bytes(n, hid), "stack_fwd",
                    f"N={n}, H={hid}")

        def empty(*shape):
            return torch.empty(*shape, dtype=dt, device=h0.device)

        h_out, x_out = empty(b, n, hid), empty(b, n, 3)
        res = (empty(b, nl, n, hid), empty(b, nl, n, 3),
               empty(b, nl, n, hid + 3), empty(b, nl, hid, e),
               empty(b, nl, 3, e)) if residuals else (None,) * 5
        proj = torch.empty(b, n, 2 * hid, dtype=torch.float32,
                           device=h0.device)
        rc = lib.egnn_stack_fwd(
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), ef.data_ptr(),
            h0.data_ptr(), x0.data_ptr(), weights.data_ptr(),
            proj.data_ptr(), h_out.data_ptr(), x_out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in res),
            b, n, e, f0, hid, nl, int(dt == torch.bfloat16),
            torch.cuda.current_stream(h0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"egnn_stack_fwd launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, E={e}, F0={f0}, H={hid}, "
                           f"L={nl})")
    stack_fwd.launches += 1
    return (h_out, x_out, *res)


stack_fwd.launches = 0


def _node_update_grads(h_in, x_in, agg, nm0w, nm0b, nm1w, nm1b, d_h, d_x):
    """Autograd through ``ops/egnn.py``'s ``_node_update`` (the per-layer
    path's node MLP and coordinate update) from the saved inputs: the
    gradients of h_in, x_in, agg and the four node-MLP weights."""
    from immunostruct_tpu_torch.ops.egnn import _node_update

    leaves = [t.detach().requires_grad_(True)
              for t in (h_in, x_in, agg, nm0w, nm0b, nm1w, nm1b)]
    h_in, x_in, agg, nm0w, nm0b, nm1w, nm1b = leaves
    hid = nm1w.shape[0]
    p = types.SimpleNamespace(node_mlp=[
        types.SimpleNamespace(w=nm0w, b=nm0b),
        types.SimpleNamespace(w=nm1w, b=nm1b)])
    with torch.enable_grad():
        hn, xn = _node_update(p, h_in, x_in, agg[..., :hid],
                              agg[..., hid:].to(x_in.dtype))
        return torch.autograd.grad((hn, xn), leaves, (d_h, d_x))


class StackMega(torch.autograd.Function):
    """``apply_stack``'s differentiable core: B6 with its residuals forward;
    per layer in reverse, the node update by autograd and the edge half by
    ``edge_half_bwd`` (B2) backward. Inputs: src, dst, mask, ef, h0, x0,
    then the layers' ``pack_layer`` tensors in order. Outputs: h and x after
    the last layer."""

    @staticmethod
    def forward(ctx, src, dst, mask, ef, h0, x0, *flat):
        layers = [flat[i:i + _PER_LAYER]
                  for i in range(0, len(flat), _PER_LAYER)]
        h, x, hs, xs, aggs, a1s, xds = stack_fwd(src, dst, mask, ef, h0, x0,
                                                 layers, residuals=True)
        valid = valid_edges(src, dst, mask, h0.shape[1])
        ctx.save_for_backward(src, dst, valid, ef, h0, x0, hs, xs, aggs,
                              a1s, xds, *flat)
        return h, x

    @staticmethod
    def backward(ctx, d_h, d_x):
        (src, dst, valid, ef, h0, x0, hs, xs, aggs, a1s, xds,
         *flat) = ctx.saved_tensors
        nl = len(flat) // _PER_LAYER
        d_ef = None
        d_flat = [None] * len(flat)
        for layer in reversed(range(nl)):
            w1ab, w2, wc1, small, nm0w, nm0b, nm1w, nm1b = \
                flat[layer * _PER_LAYER:(layer + 1) * _PER_LAYER]
            h_in = h0 if layer == 0 else hs[:, layer - 1]
            x_in = x0 if layer == 0 else xs[:, layer - 1]
            (d_h_in, d_x_in, d_agg, d_nm0w, d_nm0b, d_nm1w,
             d_nm1b) = _node_update_grads(h_in, x_in, aggs[:, layer], nm0w,
                                          nm0b, nm1w, nm1b, d_h, d_x)
            d_ef_l, d_he, d_xe, dw1ab, dw2, dwc1, dsmall = edge_half_bwd(
                src, dst, valid, ef, h_in, x_in, w1ab, w2, wc1, small,
                a1s[:, layer].contiguous(), xds[:, layer].contiguous(), d_agg)
            d_h = d_h_in + d_he.to(d_h_in.dtype)
            d_x = d_x_in + d_xe.to(d_x_in.dtype)
            d_ef = d_ef_l if d_ef is None else d_ef + d_ef_l
            grads = (dw1ab, dw2, dwc1, dsmall, d_nm0w, d_nm0b, d_nm1w,
                     d_nm1b)
            for i, (gr, t) in enumerate(zip(grads, flat[layer * _PER_LAYER:
                                                         (layer + 1)
                                                         * _PER_LAYER])):
                d_flat[layer * _PER_LAYER + i] = gr.to(t.dtype)
        return (None, None, None, d_ef.to(ef.dtype), d_h.to(h0.dtype),
                d_x.to(x0.dtype), *d_flat)


def check_stack(layers, edge_feat_size: int) -> None:
    """Raise unless the stack kernel takes these layers: 1-dim edge
    features, at least two layers, one input layer and hidden layers of
    one shape (the JAX package's ``stack_supported`` without its VMEM
    budget, which the wrapper's shared-memory check replaces)."""
    if edge_feat_size != 1:
        raise ValueError("mega_variant='stack' takes 1-dim edge features, "
                         f"got {edge_feat_size}")
    if len(layers) < 2:
        raise ValueError("mega_variant='stack' needs at least two layers, "
                         f"got {len(layers)}")
    hid = layers[0].edge_mlp[1].w.shape[1]
    for i, layer in enumerate(layers):
        shapes = [tuple(t.shape) for t in pack_layer(layer)]
        f = hid if i else shapes[0][0] // 2
        want = [(2 * f, hid), (hid, hid), (hid, hid), (hid, 6),
                (f + hid, hid), (hid,), (hid, hid), (hid,)]
        if shapes != want:
            raise ValueError(
                f"mega_variant='stack' needs an input layer and hidden "
                f"layers of width {hid} (the node MLP's output feeding the "
                f"next layer); layer {i} has weights of shapes {shapes}")


def apply_stack(layers, h, x, edge_src, edge_dst, edge_feat, edge_mask):
    """``egnn_stack_apply`` under ``mega_variant='stack'``: the whole conv
    stack in B6. Returns (h, x) in h's dtype. Differentiable
    (``StackMega``) when gradients are enabled and a weight or input
    requires one; otherwise B6 runs without its residual stores."""
    check_stack(layers, edge_feat.shape[-1])
    flat = [t for layer in layers for t in pack_layer(layer)]
    ef = edge_feat.to(h.dtype).contiguous()
    h, x = h.contiguous(), x.to(h.dtype).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (ef, h, x, *flat)):
        return StackMega.apply(edge_src, edge_dst, edge_mask, ef, h, x,
                               *flat)
    return stack_fwd(edge_src, edge_dst, edge_mask, ef, h, x,
                     [flat[i:i + _PER_LAYER]
                      for i in range(0, len(flat), _PER_LAYER)],
                     residuals=False)[:2]
