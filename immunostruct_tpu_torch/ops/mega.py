"""One EGNN layer's edge half from raw edge indices: the counterpart of
``immunostruct_tpu/ops/pallas_mega.py`` (``edge_mega``) and of the shared
math in ``immunostruct_tpu/ops/pallas_edge.py``.

For each graph b and each real edge (s -> d):

    pa, pb  = h @ W1a, h @ W1b                       node-level projections
    xd      = x[s] - x[d];  radial = |xd|^2;  x_hat = xd / (sqrt(radial) + 1e-30)
    a1      = pa[s] + pb[d] + w1r*radial + w1e*ef + b1
    m       = silu(silu(a1) @ W2 + b2)
    cw      = silu(m @ Wc1 + bc1) @ wc2
    out[d] += [m ++ cw * x_hat]                      f32 sum, [B, N, H+3]

``edge_mega`` launches the hand-written Hopper kernel
``csrc/egnn_mega_fwd.cu`` for CUDA tensors and uses ``edge_mega_reference``,
the plain PyTorch version, only for CPU tensors. Forward only: the
residuals ``a1``/``xd`` that the TPU kernel saves for training are not
produced yet.

Rounding points under bf16 are the TPU kernel's: the weights W1ab/W2/Wc1
are rounded to the compute dtype; pa and pb are rounded, then summed in
f32; ``xd`` and ``radial`` are rounded (with the ``radial > 0`` guard);
silu(a1), m and the coordinate MLP's hidden layer are rounded; ``cw`` is
rounded before ``cw * x_hat``; sigmoids, silu and the sums run in f32.

Padded edges (``mask`` False) are skipped. An edge whose index lies outside
[0, N) is skipped too (the TPU kernel's one-hot matches no node for it on
the gather side and drops it on the aggregation side).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

# columns of the packed "small" parameter matrix [H, 6]
W1R, W1E, B1, B2, BC1, WC2 = range(6)

# the head width the kernel is built for (every zoo model's
# gat_hidden_channels), and the widest node feature it takes (F <= its
# 64-edge tile, whose buffers hold W1ab during the projection phase)
KERNEL_HIDDEN = 64
KERNEL_MAX_F = 64


def pack_params(edge_mlp: Sequence, coord_mlp: Sequence):
    """Split one EGNN layer's weights into the kernel's operands.

    edge_mlp: [Linear(2F+2, H), Linear(H, H)];
    coord_mlp: [Linear(H, H), Linear(H, 1, bias=False)].
    Returns (w1ab [2F, H], w2 [H, H], wc1 [H, H], small [H, 6] f32) with the
    columns of ``small`` = (w1r, w1e, b1, b2, bc1, wc2), the layout of
    ``pallas_edge.pack_params``. Weights stay in their master dtype; the
    kernel rounds them to the compute dtype at use."""
    w1 = edge_mlp[0].w
    f2 = w1.shape[0] - 2
    small = torch.stack([
        w1[f2], w1[f2 + 1], edge_mlp[0].b, edge_mlp[1].b,
        coord_mlp[0].b, coord_mlp[1].w[:, 0],
    ], dim=1).float().contiguous()
    return w1[:f2], edge_mlp[1].w, coord_mlp[0].w, small


def edge_mega_reference(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """Plain PyTorch version of the kernel, with the same rounding points.

    src/dst [B, E] int, mask [B, E] bool, ef [B, E, 1], h [B, N, F] and
    x [B, N, 3] in the compute dtype, weights as ``pack_params`` returns
    them. Returns [B, N, H+3] f32."""
    dt = h.dtype
    f32 = torch.float32
    b, n, f = h.shape
    hid = w2.shape[1]

    def rnd(t):
        return t.to(dt).to(f32)

    valid = mask & (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    s = torch.where(valid, src, 0).long()
    d = torch.where(valid, dst, 0).long()

    def gather(t, idx):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    w1 = rnd(w1ab)
    hf = h.to(f32)
    pa = rnd(torch.matmul(hf, w1[:f]))
    pb = rnd(torch.matmul(hf, w1[f:]))
    xf = x.to(f32)
    xd = rnd(gather(xf, s) - gather(xf, d))                     # [B, E, 3]
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
    both = torch.cat([m, msgx], dim=-1) * valid[..., None].to(f32)
    out = torch.zeros(b, n, hid + 3, dtype=f32, device=h.device)
    return out.scatter_add_(1, d[..., None].expand(-1, -1, hid + 3), both)


def _check_cuda_args(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    b, n, f = h.shape
    e = src.shape[1]
    hid = w2.shape[1]
    want = {
        "src": (src, torch.int32, (b, e)),
        "dst": (dst, torch.int32, (b, e)),
        "mask": (mask, torch.bool, (b, e)),
        "ef": (ef, h.dtype, (b, e, 1)),
        "h": (h, h.dtype, (b, n, f)),
        "x": (x, h.dtype, (b, n, 3)),
        "w1ab": (w1ab, torch.float32, (2 * f, hid)),
        "w2": (w2, torch.float32, (hid, hid)),
        "wc1": (wc1, torch.float32, (hid, hid)),
        "small": (small, torch.float32, (hid, 6)),
    }
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"edge_mega kernel takes float32 or bfloat16 "
                         f"features, got {h.dtype}")
    for name, (t, dtype, shape) in want.items():
        if t.device != h.device:
            raise ValueError(f"edge_mega: {name} is on {t.device}, "
                             f"h on {h.device}")
        if t.dtype != dtype:
            raise ValueError(f"edge_mega: {name} has dtype {t.dtype}, "
                             f"the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"edge_mega: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"edge_mega: {name} is not contiguous")
    if hid != KERNEL_HIDDEN:
        raise ValueError(f"edge_mega kernel is built for H={KERNEL_HIDDEN}, "
                         f"got H={hid}; aggregation='scatter' takes any H")
    if not 1 <= f <= KERNEL_MAX_F:
        raise ValueError(f"edge_mega kernel takes 1 <= F <= {KERNEL_MAX_F}, "
                         f"got F={f}")
    if b == 0 or n == 0:
        raise ValueError("edge_mega: empty batch or graph")


def _kernel_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_mega_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_mega_fwd.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
    lib.egnn_mega_fwd.restype = i32
    lib.egnn_mega_fwd_smem_bytes.argtypes = [i32, i32]
    lib.egnn_mega_fwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def edge_mega(src, dst, mask, ef, h, x, w1ab, w2, wc1, small):
    """EGNN edge half-layer: [B, N, H+3] f32 per-node sums of messages
    (columns 0..H-1) and coordinate messages (columns H..H+2).

    CUDA tensors go through the Hopper kernel, which either launches or
    raises; CPU tensors go through ``edge_mega_reference``.
    ``edge_mega.launches`` counts kernel launches."""
    if h.device.type == "cpu":
        return edge_mega_reference(src, dst, mask, ef, h, x,
                                   w1ab, w2, wc1, small)
    if h.device.type != "cuda":
        raise ValueError(f"edge_mega runs on cuda or cpu tensors, "
                         f"not {h.device.type}")
    ef = ef.to(h.dtype)
    _check_cuda_args(src, dst, mask, ef, h, x, w1ab, w2, wc1, small)
    b, n, f = h.shape
    e = src.shape[1]
    hid = w2.shape[1]
    lib = _kernel_lib()
    with torch.cuda.device(h.device):
        props = torch.cuda.get_device_properties(h.device)
        if props.major != 9:
            raise RuntimeError(f"edge_mega kernel is built for sm_90a "
                               f"(Hopper); {props.name} is "
                               f"sm_{props.major}{props.minor}")
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
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.egnn_mega_fwd(
            src.data_ptr(), dst.data_ptr(), mask.data_ptr(), ef.data_ptr(),
            h.data_ptr(), x.data_ptr(), w1ab.data_ptr(), w2.data_ptr(),
            wc1.data_ptr(), small.data_ptr(), out.data_ptr(),
            proj.data_ptr(), b, n, e, f, hid,
            int(h.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_mega_fwd launch failed with CUDA error "
                           f"{rc} (B={b}, N={n}, E={e}, F={f}, H={hid})")
    edge_mega.launches += 1
    return out


edge_mega.launches = 0
