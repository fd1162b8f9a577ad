"""The EGNN edge program over pre-gathered edge bundles, forward and
backward: the counterpart of ``immunostruct_tpu/ops/pallas_edge.py``
(``edge_program``, its custom VJP, ``pack_params`` and the shared math
``_geometry``/``_chain_from_a1``), and the home of what the mega kernels'
wrappers (ops/mega.py) share with it.

For each graph b and each edge e of the transposed bundles hsx, hdx
[B, F+3, E] (rows 0..F-1 node features, F..F+2 coordinates, of the edge's
source and destination node):

    xd     = hsx[F:] - hdx[F:];  radial = |xd|^2;  x_hat = xd / (sqrt(radial) + 1e-30)
    a1     = W1ab^T [hs ; hd] + w1r*radial + w1e*ef + b1
    m      = silu(silu(a1) @ W2 + b2)
    cw     = silu(m @ Wc1 + bc1) @ wc2
    out    = [m ; cw * x_hat]                          [B, H+3, E]

Two hand-written Hopper kernels carry it, each with its plain PyTorch
version beside it in this module:

  B3 fwd ``edge_program_fwd`` -> csrc/egnn_edge_fwd.cu (plain: ``edge_program_reference``)
         in bf16 on the tensor cores, with B3 bwd's chain steps.
  B3 bwd ``edge_program_bwd`` -> csrc/egnn_edge_bwd.cu (plain: ``edge_program_bwd_reference``)
         recomputes the chain from hsx/hdx/ef (nothing is saved from the
         forward) and returns dhsx, dhdx [B, F+3, E] and def [B, 1, E] in
         the compute dtype, and dW1ab, dW2, dWc1, dsmall summed in f32 over
         every edge.

``EdgeProgram`` is the ``torch.autograd.Function`` and ``edge_program`` the
op. The forward is the ``torch.library`` op
``immunostruct::edge_program_fwd``, which ``torch.export`` traces; the
backward is a direct launch. A CUDA tensor launches the kernels or raises;
a CPU tensor takes the plain versions. The kernels compute every edge: the
bundles carry no mask (the caller gathers zeros for a masked edge and masks
its output out of the aggregation, ops/egnn.py).

Rounding points under bf16 are the TPU kernel's. Forward: the weights
W1ab/W2/Wc1 are rounded to the compute dtype (``small`` stays f32); xd is
the difference in the compute dtype; radial is summed in f32 and rounded;
silu(a1), m and the coordinate MLP's hidden layer c1 are rounded; cw is an
f32 dot with wc2, rounded before it multiplies x_hat; the output is
rounded. Backward: the cotangent is rounded; the chain is recomputed with
the forward's rounding points; d_p3, d_p2 and d_a1 are rounded; d_m and
W2 @ d_p2 are f32 sums of products of rounded values; d_hsd = W1ab @ d_a1,
d_xd and d_ef are rounded; the weight gradients are f32 sums of products of
rounded values, the radial column of dsmall against the rounded radial.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

# columns of the packed "small" parameter matrix [H, 6]
W1R, W1E, B1, B2, BC1, WC2 = range(6)

# the head width the kernels are built for (every zoo model's
# gat_hidden_channels), and the widest node feature they take
KERNEL_HIDDEN = 64
KERNEL_MAX_F = 64

# JAX's admission rule for aggregation='fused' (ops/egnn.py
# _fused_or_fallback): the edge pad is a multiple of the TPU's 128-lane tile
EDGE_MULTIPLE = 128

# shared memory one block may opt into on sm_90 (the H100's 227 KB); what
# ``mega_admits`` holds B1's need to, without asking a card
HOPPER_SMEM_OPTIN = 232_448


def pack_params(edge_mlp: Sequence, coord_mlp: Sequence):
    """Split one EGNN layer's weights into the kernels' operands.

    edge_mlp: [Linear(2F+2, H), Linear(H, H)];
    coord_mlp: [Linear(H, H), Linear(H, 1, bias=False)].
    Returns (w1ab [2F, H], w2 [H, H], wc1 [H, H], small [H, 6] f32) with the
    columns of ``small`` = (w1r, w1e, b1, b2, bc1, wc2), the layout of
    ``pallas_edge.pack_params``. Weights stay in their master dtype; the
    kernels round them to the compute dtype at use. Autograd carries the
    operands' gradients back through the slices and the stack."""
    w1 = edge_mlp[0].w
    f2 = w1.shape[0] - 2
    small = torch.stack([
        w1[f2], w1[f2 + 1], edge_mlp[0].b, edge_mlp[1].b,
        coord_mlp[0].b, coord_mlp[1].w[:, 0],
    ], dim=1).float().contiguous()
    return w1[:f2], edge_mlp[1].w, coord_mlp[0].w, small


def fused_admits(edges: int, features: int, hidden: int,
                 edge_feat_size: int) -> bool:
    """Whether B3 takes these shapes: JAX's rule for 'fused' (a multiple of
    128 edges, 1-dim edge features) and the kernel's widths (H =
    KERNEL_HIDDEN, 1 <= F <= KERNEL_MAX_F; its shared memory does not grow
    with E or N)."""
    return (edges >= EDGE_MULTIPLE and edges % EDGE_MULTIPLE == 0
            and edge_feat_size == 1 and hidden == KERNEL_HIDDEN
            and 1 <= features <= KERNEL_MAX_F)


def silu_grad(x, s):
    """d silu / dx from the pre-activation x and its sigmoid s."""
    return s * (1.0 + x * (1.0 - s))


def check_cuda_args(name: str, want: dict, dtype, hid: int):
    """Raise ValueError unless every tensor of ``want`` (name -> (tensor,
    dtype, shape)) is on one device, of its dtype and shape, and
    contiguous, the features are f32 or bf16 and H is the kernels'."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} kernel takes float32 or bfloat16 "
                         f"features, got {dtype}")
    device = next(iter(want.values()))[0].device
    for arg, (t, dt, shape) in want.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, "
                             f"the others on {device}")
        if t.dtype != dt:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, "
                             f"the kernel takes {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if hid != KERNEL_HIDDEN:
        raise ValueError(f"{name} kernel is built for H={KERNEL_HIDDEN}, "
                         f"got H={hid}; aggregation 'onehot' or 'scatter' "
                         "takes any H")


def hopper(device, name: str):
    """The card's properties; raises unless it is a Hopper (sm_90)."""
    props = torch.cuda.get_device_properties(device)
    if props.major != 9:
        raise RuntimeError(f"the {name} kernels are built for sm_90a "
                           f"(Hopper); {props.name} is "
                           f"sm_{props.major}{props.minor}")
    return props


def chunks_per_graph(e: int, b: int, tile: int, sms: int) -> int:
    """Edge chunks per graph for a kernel with one CTA per (graph, chunk):
    enough CTAs to give every SM one, each chunk a whole number of tiles."""
    tiles = max(1, -(-e // tile))
    return min(tiles, max(1, -(-sms // b)))


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _rounder(dt):
    def rnd(t):
        return t.to(dt).to(torch.float32)
    return rnd


def _recompute(hsx, hdx, ef, w1ab, w2, wc1, small):
    """The forward chain in f32 on [B, E, C] views, with the kernels'
    rounding points (module docstring)."""
    dt = hsx.dtype
    rnd = _rounder(dt)
    f = hsx.shape[1] - 3
    hs = hsx.transpose(1, 2).float()                            # [B, E, F+3]
    hd = hdx.transpose(1, 2).float()
    xd = rnd(hs[..., f:] - hd[..., f:])                         # [B, E, 3]
    rad = rnd((xd * xd).sum(-1, keepdim=True))
    safe = torch.where(rad > 0, rad, torch.ones_like(rad))
    inv_s = 1.0 / (torch.sqrt(safe) + 1e-30)
    hsd = torch.cat([hs[..., :f], hd[..., :f]], dim=-1)         # [B, E, 2F]
    eff = ef.transpose(1, 2).float()                            # [B, E, 1]
    sm = small.float()
    w1b, w2b, wc1b = rnd(w1ab), rnd(w2), rnd(wc1)
    a1 = (torch.matmul(hsd, w1b) + sm[:, W1R] * rad + sm[:, W1E] * eff
          + sm[:, B1])
    s1 = torch.sigmoid(a1)
    a1s = rnd(a1 * s1)
    p2 = torch.matmul(a1s, w2b) + sm[:, B2]
    s2 = torch.sigmoid(p2)
    m = rnd(p2 * s2)
    p3 = torch.matmul(m, wc1b) + sm[:, BC1]
    s3 = torch.sigmoid(p3)
    c1 = rnd(p3 * s3)
    cw = (c1 * sm[:, WC2]).sum(-1, keepdim=True)                # [B, E, 1]
    return dict(xd=xd, rad=rad, safe=safe, inv_s=inv_s, hsd=hsd, eff=eff,
                sm=sm, w1b=w1b, w2b=w2b, wc1b=wc1b, a1=a1, s1=s1, a1s=a1s,
                p2=p2, s2=s2, m=m, p3=p3, s3=s3, c1=c1, cw=cw)


def edge_program_reference(hsx, hdx, ef, w1ab, w2, wc1, small):
    """Plain PyTorch version of B3's forward, with the same rounding points.

    hsx/hdx [B, F+3, E] and ef [B, 1, E] in the compute dtype; weights as
    ``pack_params`` returns them. Returns [B, H+3, E] in the compute
    dtype."""
    dt = hsx.dtype
    ch = _recompute(hsx, hdx, ef, w1ab, w2, wc1, small)
    x_hat = ch["xd"] * ch["inv_s"]
    msgx = ch["cw"].to(dt).float() * x_hat
    out = torch.cat([ch["m"], msgx], dim=-1).to(dt)
    return out.transpose(1, 2).contiguous()


def edge_program_bwd_reference(hsx, hdx, ef, w1ab, w2, wc1, small, dout,
                               weight_sums=torch.float32):
    """Plain PyTorch version of B3's backward, written out by hand with the
    kernel's rounding points (autograd through the plain forward misses
    them). ``dout`` [B, H+3, E] is the cotangent of the output.

    Returns (dhsx [B, F+3, E], dhdx [B, F+3, E], def [B, 1, E] in the
    compute dtype, dw1ab [2F, H], dw2 [H, H], dwc1 [H, H], dsmall [H, 6]).
    The weight gradients are summed over the edges in ``weight_sums``: f32
    as the kernel sums them, or float64 for the exact sums of the same
    per-edge terms, the yardstick of both f32 orders."""
    dt = hsx.dtype
    rnd = _rounder(dt)
    f = hsx.shape[1] - 3
    hid = w2.shape[1]
    ch = _recompute(hsx, hdx, ef, w1ab, w2, wc1, small)
    sm, xd, inv_s = ch["sm"], ch["xd"], ch["inv_s"]
    x_hat = xd * inv_s
    cw_b = rnd(ch["cw"])
    db = dout.to(dt).transpose(1, 2).float()                    # [B, E, H+3]
    d_m_in, d_msgx = db[..., :hid], db[..., hid:]
    d_cw = (d_msgx * x_hat).sum(-1, keepdim=True)
    d_xhat = d_msgx * cw_b
    d_p3 = rnd(sm[:, WC2] * d_cw * silu_grad(ch["p3"], ch["s3"]))
    d_m = d_m_in + torch.matmul(d_p3, ch["wc1b"].T)
    d_p2 = rnd(d_m * silu_grad(ch["p2"], ch["s2"]))
    d_a1 = rnd(torch.matmul(d_p2, ch["w2b"].T)
               * silu_grad(ch["a1"], ch["s1"]))
    d_hsd = rnd(torch.matmul(d_a1, ch["w1b"].T))                # [B, E, 2F]
    d_rad_chain = (sm[:, W1R] * d_a1).sum(-1, keepdim=True)
    sum_dxh_xd = (d_xhat * xd).sum(-1, keepdim=True)
    d_safe = sum_dxh_xd * (-0.5) * inv_s * inv_s / torch.sqrt(ch["safe"])
    d_rad = d_rad_chain + torch.where(ch["rad"] > 0, d_safe, 0.0)
    d_xd = rnd(d_xhat * inv_s + 2.0 * xd * d_rad)
    d_ef = (sm[:, W1E] * d_a1).sum(-1, keepdim=True)
    dhsx = torch.cat([d_hsd[..., :f], d_xd], dim=-1)
    dhdx = torch.cat([d_hsd[..., f:], -d_xd], dim=-1)
    hsd, a1s, m, c1, rad, eff, d_a1, d_p2, d_p3, d_cw = (
        t.to(weight_sums) for t in (ch["hsd"], ch["a1s"], ch["m"], ch["c1"],
                                    ch["rad"], ch["eff"], d_a1, d_p2, d_p3,
                                    d_cw))
    dw1ab = torch.einsum("bei,bej->ij", hsd, d_a1)
    dw2 = torch.einsum("bei,bej->ij", a1s, d_p2)
    dwc1 = torch.einsum("bei,bej->ij", m, d_p3)
    dsmall = torch.stack([
        (d_a1 * rad).sum((0, 1)), (d_a1 * eff).sum((0, 1)),
        d_a1.sum((0, 1)), d_p2.sum((0, 1)), d_p3.sum((0, 1)),
        (c1 * d_cw).sum((0, 1)),
    ], dim=1)

    def cbe(t):
        return t.to(dt).transpose(1, 2).contiguous()

    return (cbe(dhsx), cbe(dhdx), cbe(d_ef), dw1ab, dw2, dwc1, dsmall)


def d_p3_unrounded_sum(hsx, hdx, ef, w1ab, w2, wc1, small, dout):
    """dsmall's bc1 column [H] as ``edge_program_bwd_reference`` sums it,
    but with d_p3 not rounded to the compute dtype first: what a backward
    that leaves out that rounding point gives. The card tests and
    chip_smoke.py hold the kernel's dbc1 nearer the plain version's than
    this (no bound on dsmall's rows sees the rounding)."""
    hid = w2.shape[1]
    ch = _recompute(hsx, hdx, ef, w1ab, w2, wc1, small)
    db = dout.to(hsx.dtype).transpose(1, 2).float()
    d_cw = (db[..., hid:] * ch["xd"] * ch["inv_s"]).sum(-1, keepdim=True)
    return (ch["sm"][:, WC2] * d_cw
            * silu_grad(ch["p3"], ch["s3"])).sum((0, 1))


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fwd_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_edge_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_edge_fwd.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.egnn_edge_fwd.restype = i32
    lib.egnn_edge_fwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.egnn_edge_fwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_edge_fwd_ctas_per_sm.argtypes = [i32, i32, i32]
    lib.egnn_edge_fwd_ctas_per_sm.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    from immunostruct_tpu_torch.ops._build import load_library

    lib = load_library("egnn_edge_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_edge_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [ptr]
    lib.egnn_edge_bwd.restype = i32
    lib.egnn_edge_bwd_smem_bytes.argtypes = [i32, i32, i32]
    lib.egnn_edge_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.egnn_edge_bwd_ctas_per_sm.argtypes = [i32, i32, i32]
    lib.egnn_edge_bwd_ctas_per_sm.restype = i32
    return lib


def _kernel_libs():
    """Build (at first use) and load both kernels' libraries."""
    return _fwd_lib(), _bwd_lib()


def _check_bundles(name, hsx, hdx, ef, w1ab, w2, wc1, small, extra=None):
    b, f3, e = hsx.shape
    f, hid = f3 - 3, w2.shape[1]
    want = {
        "hsx": (hsx, hsx.dtype, (b, f3, e)),
        "hdx": (hdx, hsx.dtype, (b, f3, e)),
        "ef": (ef, hsx.dtype, (b, 1, e)),
        "w1ab": (w1ab, torch.float32, (2 * f, hid)),
        "w2": (w2, torch.float32, (hid, hid)),
        "wc1": (wc1, torch.float32, (hid, hid)),
        "small": (small, torch.float32, (hid, 6)),
    }
    want.update(extra or {})
    check_cuda_args(name, want, hsx.dtype, hid)
    if not 1 <= f <= KERNEL_MAX_F:
        raise ValueError(f"{name} kernel takes 1 <= F <= {KERNEL_MAX_F}, "
                         f"got F={f}; aggregation 'onehot' or 'scatter' "
                         "takes any F")
    if b == 0:
        raise ValueError(f"{name}: empty batch")
    return b, f, e, hid


def _smem_ok(name, smem, props, f, hid):
    if smem > props.shared_memory_per_block_optin:
        raise ValueError(
            f"{name} kernel needs {smem} B of shared memory for F={f}, "
            f"H={hid}; the card allows "
            f"{props.shared_memory_per_block_optin} B per block")


def _on_cuda(name, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"not {t.device.type}")
    return True


# The package's ``torch.library`` namespace. B1, B3's forward and B8 are its
# ops (``define_op``); the registrations last as long as this object.
OPS_LIBRARY = torch.library.Library("immunostruct", "FRAGMENT")


def define_op(schema: str, *, cpu, cuda, fake):
    """Define ``immunostruct::<schema>``: ``cpu`` runs on CPU tensors (the
    plain version), ``cuda`` on CUDA tensors (the launch, counted there),
    ``fake`` gives the output's shape and dtype for tracing. Returns the
    op's overload, which the wrappers call. Registered on the dispatcher
    directly, not through ``torch.library.custom_op``, whose Python layers
    around each implementation cost the eager path tens of microseconds a
    call."""
    name = schema.split("(", 1)[0]
    OPS_LIBRARY.define(schema)
    OPS_LIBRARY.impl(name, cpu, "CPU")
    OPS_LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"immunostruct::{name}", fake,
                                lib=OPS_LIBRARY)
    return getattr(torch.ops.immunostruct, name).default


def _edge_fwd_launch(hsx, hdx, ef, w1ab, w2, wc1, small):
    """Check the operands and launch B3's forward on hsx's card; raise if
    it does not fit or does not launch. Counts nothing."""
    b, f, e, hid = _check_bundles("edge_program", hsx, hdx, ef, w1ab, w2,
                                  wc1, small)
    lib = _fwd_lib()
    with torch.cuda.device(hsx.device):
        props = hopper(hsx.device, "edge_program")
        _smem_ok("edge_program",
                 lib.egnn_edge_fwd_smem_bytes(
                     f, hid, int(hsx.dtype == torch.bfloat16)),
                 props, f, hid)
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        out = torch.empty(b, hid + 3, e, dtype=hsx.dtype, device=hsx.device)
        stream = torch.cuda.current_stream(hsx.device).cuda_stream
        rc = lib.egnn_edge_fwd(
            hsx.data_ptr(), hdx.data_ptr(), ef.data_ptr(), w1ab.data_ptr(),
            w2.data_ptr(), wc1.data_ptr(), small.data_ptr(), out.data_ptr(),
            b, e, f, hid, chunks, int(hsx.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_edge_fwd launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, F={f}, H={hid})")
    return out


def _edge_fwd_cuda(hsx, hdx, ef, w1ab, w2, wc1, small):
    out = _edge_fwd_launch(hsx, hdx, ef, w1ab, w2, wc1, small)
    edge_program.launches += 1
    return out


def _edge_fwd_fake(hsx, hdx, ef, w1ab, w2, wc1, small):
    return hsx.new_empty((hsx.shape[0], w2.shape[1] + 3, hsx.shape[2]))


# B3's forward as a ``torch.library`` op (what ``torch.export`` traces): the
# plain version on CPU tensors, the kernel on CUDA tensors, counted there.
_EDGE_FWD_OP = define_op(
    "edge_program_fwd(Tensor hsx, Tensor hdx, Tensor ef, Tensor w1ab, "
    "Tensor w2, Tensor wc1, Tensor small) -> Tensor",
    cpu=edge_program_reference, cuda=_edge_fwd_cuda, fake=_edge_fwd_fake)


def edge_program_fwd(hsx, hdx, ef, w1ab, w2, wc1, small):
    """B3's forward: [B, H+3, E] in the compute dtype, the op
    ``immunostruct::edge_program_fwd``.

    CUDA tensors launch csrc/egnn_edge_fwd.cu (f32 on the CUDA cores, bf16
    on the tensor cores) or raise; CPU tensors go through
    ``edge_program_reference``. ``edge_program.launches`` counts the
    kernel's launches."""
    _on_cuda("edge_program", hsx)
    return _EDGE_FWD_OP(hsx, hdx, ef, w1ab, w2, wc1, small)


def edge_program_bwd(hsx, hdx, ef, w1ab, w2, wc1, small, dout):
    """B3's backward: the contract of ``edge_program_bwd_reference``.

    CUDA tensors launch csrc/egnn_edge_bwd.cu (f32 on the CUDA cores, bf16
    on the tensor cores; per-block partial weight gradients and their
    fixed-order reduction) or raise; CPU tensors go
    through ``edge_program_bwd_reference``. ``edge_program_bwd.launches``
    counts the kernel's launches."""
    if not _on_cuda("edge_program_bwd", hsx):
        return edge_program_bwd_reference(hsx, hdx, ef, w1ab, w2, wc1, small,
                                          dout)
    b, f3, e = hsx.shape
    hid = w2.shape[1]
    b, f, e, hid = _check_bundles(
        "edge_program_bwd", hsx, hdx, ef, w1ab, w2, wc1, small,
        {"dout": (dout, hsx.dtype, (b, hid + 3, e))})
    dt = hsx.dtype
    lib = _bwd_lib()
    with torch.cuda.device(hsx.device):
        props = hopper(hsx.device, "edge_program")
        _smem_ok("edge_program_bwd",
                 lib.egnn_edge_bwd_smem_bytes(f, hid,
                                              int(dt == torch.bfloat16)),
                 props, f, hid)
        chunks = chunks_per_graph(e, b, 64, props.multi_processor_count)
        width = 2 * f * hid + 2 * hid * hid + 6 * hid
        dhsx = torch.empty(b, f + 3, e, dtype=dt, device=hsx.device)
        dhdx = torch.empty(b, f + 3, e, dtype=dt, device=hsx.device)
        d_ef = torch.empty(b, 1, e, dtype=dt, device=hsx.device)
        grads = torch.empty(width, dtype=torch.float32, device=hsx.device)
        partial = torch.empty(b * chunks, width, dtype=torch.float32,
                              device=hsx.device)
        stream = torch.cuda.current_stream(hsx.device).cuda_stream
        rc = lib.egnn_edge_bwd(
            hsx.data_ptr(), hdx.data_ptr(), ef.data_ptr(), w1ab.data_ptr(),
            w2.data_ptr(), wc1.data_ptr(), small.data_ptr(), dout.data_ptr(),
            dhsx.data_ptr(), dhdx.data_ptr(), d_ef.data_ptr(),
            partial.data_ptr(), grads.data_ptr(), b, e, f, hid, chunks,
            int(dt == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"egnn_edge_bwd launch failed with CUDA error "
                           f"{rc} (B={b}, E={e}, F={f}, H={hid})")
    edge_program_bwd.launches += 1
    n1, hh = 2 * f * hid, hid * hid
    return (dhsx, dhdx, d_ef, grads[:n1].view(2 * f, hid),
            grads[n1:n1 + hh].view(hid, hid),
            grads[n1 + hh:n1 + 2 * hh].view(hid, hid),
            grads[n1 + 2 * hh:].view(hid, 6))


edge_program_bwd.launches = 0


class EdgeProgram(torch.autograd.Function):
    """``edge_program`` with its backward: B3's forward, and B3's backward
    from the saved inputs. Gradients for every input, each in its input's
    dtype."""

    @staticmethod
    def forward(ctx, hsx, hdx, ef, w1ab, w2, wc1, small):
        ctx.save_for_backward(hsx, hdx, ef, w1ab, w2, wc1, small)
        return edge_program_fwd(hsx, hdx, ef, w1ab, w2, wc1, small)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        grads = edge_program_bwd(*inputs,
                                 g.to(inputs[0].dtype).contiguous())
        return tuple(gr.to(t.dtype) if need else None
                     for gr, t, need in zip(grads, inputs,
                                            ctx.needs_input_grad))


def edge_program(hsx, hdx, ef, w1ab, w2, wc1, small):
    """The EGNN edge program over gathered [h ++ x] bundles: [B, H+3, E] in
    the compute dtype, rows 0..H-1 the messages and H..H+2 the coordinate
    messages (the operand of the destination aggregation).

    Differentiable (``EdgeProgram``) when gradients are enabled and an
    input requires one. CUDA tensors launch the Hopper kernels or raise;
    CPU tensors take the plain versions. ``edge_program.launches`` counts
    the forward kernel's launches, ``edge_program_bwd.launches`` the
    backward's."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (hsx, hdx, ef, w1ab, w2, wc1, small)):
        return EdgeProgram.apply(hsx, hdx, ef, w1ab, w2, wc1, small)
    return edge_program_fwd(hsx, hdx, ef, w1ab, w2, wc1, small)


edge_program.launches = 0
