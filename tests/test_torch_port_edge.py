"""The PyTorch port's edge program (immunostruct_tpu_torch/ops/edge.py, B3's
plain versions and ``EdgeProgram``) and aggregation 'fused'
(immunostruct_tpu_torch/ops/egnn.py) against the JAX package's
(ops/pallas_edge.py ``edge_program`` and its custom VJP, run in interpret
mode as tests/test_pallas_edge.py runs it on the CPU; ops/egnn.py
``egnn_stack_apply(aggregation='fused')``).

The same numpy inputs, made from a seed, go through both. B=2, N=16,
E=256 (two 128-edge tiles per graph), F=8 and 16, H=16. The JAX side is
compiled with ``xla_allow_excess_precision`` off: XLA on the CPU otherwise
keeps bf16 intermediates in f32 and skips rounding points that the TPU
kernel has (with it off, the bf16 forward and edge cotangents agree bit
for bit). Tolerances:

- f32: atol=1e-5, rtol=1e-4 (roundoff of a different summation order),
  the f32 weight gradients summed over every tile and graph included.
- bf16, the edge program's outputs and gradients: per row (one channel
  over graphs and edges, or one weight gradient), mean|diff| <= 1e-4 *
  mean|JAX|, the bound the EdgeMega gradient tests use. Both round at the
  same points, so only an f32 sum in another order can flip a rounding
  (measured: the output and the edge cotangents equal bit for bit, the
  weight gradients within 1e-7 of their mean).
- 'fused' through two EGNN layers: f32 outputs and ``jax.grad`` of a scalar
  within atol=1e-5 * max|JAX| + rtol=1e-4. bf16, per tensor: mean|port -
  JAX| <= 2 * mean|JAX bf16 - JAX f32|, twice JAX's own bf16 noise, the
  bound chip_smoke.py holds the twin step to. The node MLP and its
  backward round at other points in the two packages (PyTorch's bf16 silu
  and matmul backward keep f32 inside, XLA's round), so the outputs and
  gradients differ by 0.3-1% of their mean, about as much as bf16 moves
  JAX from its f32 result (measured: 0.1 to 1.6 times that noise). The
  edge program's own rounding points are held bit for bit above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu.ops.pallas_edge import edge_program as jax_edge_program
from immunostruct_tpu.ops.pallas_edge import pack_params as jax_pack_params
from immunostruct_tpu_torch.ops import edge
from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_stack_apply
from immunostruct_tpu_torch.utils.checkpoint import load_params

B, N, E, H = 2, 16, 256, 16
BF16_MEAN = 1e-4              # edge program, bf16: per-row mean ratio
LAYER_BF16_NOISE = 2.0        # two 'fused' layers, bf16: x JAX's bf16 noise
GRAD_NAMES = ("hsx", "hdx", "ef", "w1ab", "w2", "wc1", "small")


def _f32(x):
    """numpy f32 of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _mean_ratio_rows(got, want):
    """The worst row's mean|got - want| / mean|want|, rows over dim 1 of a
    [B, C, E] tensor, or the whole of any other."""
    g, w = _f32(got), _f32(want)
    if g.ndim == 3:
        g = np.moveaxis(g, 1, 0).reshape(g.shape[1], -1)
        w = np.moveaxis(w, 1, 0).reshape(w.shape[1], -1)
    else:
        g, w = g.reshape(1, -1), w.reshape(1, -1)
    mag = np.maximum(np.abs(w).mean(1), np.finfo(np.float32).tiny)
    return float((np.abs(g - w).mean(1) / mag).max())


def _rounding(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision, so that every
    cast to bf16 rounds, as it does in the TPU kernel."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_layer(f, seed):
    return jax_egnn.egnn_init(jax.random.key(seed), f, H, H)


def _port_layer(p, f):
    layer = EGNNLayer(f, H, H, generator=torch.Generator().manual_seed(0))
    flat = {}
    for group in ("edge_mlp", "node_mlp", "coord_mlp"):
        for i, lin in enumerate(p[group]):
            for k, v in lin.items():
                flat[f"{group}.{i}.{k}"] = np.asarray(v)
    return load_params(layer, flat, verbose=False)


def _bundles(f, seed, mask_rate=0.1):
    """Bundles as 'fused' gathers them: [h ++ x] of each edge's source and
    destination in the [B, F+3, E] layout, zeros for a masked edge; the
    first edges self-loops (xd = 0)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((B, N, f + 3)).astype(np.float32)
    src = rng.integers(0, N, (B, E))
    dst = rng.integers(0, N, (B, E))
    src[:, :6] = dst[:, :6]
    keep = (rng.random((B, E)) >= mask_rate)[..., None]
    take = np.take_along_axis
    hsx = np.where(keep, take(rows, src[..., None], 1), 0.0)
    hdx = np.where(keep, take(rows, dst[..., None], 1), 0.0)
    ef = rng.standard_normal((B, 1, E)).astype(np.float32)
    dout = rng.standard_normal((B, H + 3, E)).astype(np.float32)
    return (np.ascontiguousarray(hsx.transpose(0, 2, 1), np.float32),
            np.ascontiguousarray(hdx.transpose(0, 2, 1), np.float32), ef,
            dout)


def _operands(f, seed, dtype):
    """(JAX operands, port operands, JAX cotangent, port cotangent)."""
    hsx, hdx, ef, dout = _bundles(f, seed)
    p = _jax_layer(f, seed)
    jdt = jnp.dtype(dtype)
    jw = jax_pack_params(p["edge_mlp"], p["coord_mlp"])
    jargs = (*(jnp.asarray(a).astype(jdt) for a in (hsx, hdx, ef)), *jw)
    tdt = getattr(torch, dtype)
    layer = _port_layer(p, f)
    targs = (*(torch.from_numpy(a).to(tdt) for a in (hsx, hdx, ef)),
             *(w.detach().contiguous()
               for w in edge.pack_params(layer.edge_mlp, layer.coord_mlp)))
    return (jargs, targs, jnp.asarray(dout).astype(jdt),
            torch.from_numpy(dout).to(tdt))


def _assert_close(got, want, dtype, name):
    assert tuple(got.shape) == tuple(want.shape), name
    assert np.isfinite(_f32(got)).all(), name
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    else:
        assert _mean_ratio_rows(got, want) <= BF16_MEAN, name


@pytest.mark.parametrize("f", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_program_forward_matches_jax(f, dtype):
    jargs, targs, _, _ = _operands(f, f, dtype)
    want = _rounding(lambda *a: jax_edge_program(*a, True), *jargs)
    got = edge.edge_program_reference(*targs)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, H + 3, E)
    _assert_close(got, want, dtype, "out")


@pytest.mark.parametrize("f", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_program_backward_matches_jax_vjp(f, dtype):
    """The hand-written plain backward against ``jax.vjp`` of the custom
    VJP (B3's backward kernel in interpret mode), every output; and
    ``EdgeProgram`` through autograd, which on CPU tensors runs it."""
    jargs, targs, jcot, tcot = _operands(f, f + 1, dtype)
    def vjp(cot, *a):
        return jax.vjp(lambda *a: jax_edge_program(*a, True), *a)[1](cot)

    want = _rounding(vjp, jcot, *jargs)
    got = edge.edge_program_bwd_reference(*targs, tcot)
    for name, g, w in zip(GRAD_NAMES, got, want):
        # the edge cotangents in the compute dtype, weight gradients in f32
        assert g.dtype == (getattr(torch, dtype) if g.dim() == 3
                           else torch.float32), name
        _assert_close(g, w, dtype, name)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    (edge.edge_program(*leaves).float() * tcot.float()).sum().backward()
    for name, leaf, g in zip(GRAD_NAMES, leaves, got):
        assert leaf.grad.dtype == leaf.dtype, name
        torch.testing.assert_close(leaf.grad, g.to(leaf.dtype), atol=0.0,
                                   rtol=0.0)


def test_edge_program_weight_gradients_sum_every_tile():
    """The weight gradients of two graphs (four 128-edge tiles in the JAX
    grid) are the sums of each graph's own."""
    _, targs, _, tcot = _operands(8, 3, "float32")
    whole = edge.edge_program_bwd_reference(*targs, tcot)
    parts = [edge.edge_program_bwd_reference(
        *(t[i:i + 1] for t in targs[:3]), *targs[3:], tcot[i:i + 1])
        for i in range(B)]
    for k in range(3, 7):
        torch.testing.assert_close(whole[k], parts[0][k] + parts[1][k],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_program_weight_sums_in_float64(dtype):
    """weight_sums=float64 sums the same per-edge terms exactly: the edge
    cotangents are the same bits, the weight gradients float64 and within
    f32 roundoff of the f32 sums (|diff| <= 1e-6 * max|exact|)."""
    _, targs, _, tcot = _operands(16, 5, dtype)
    f32 = edge.edge_program_bwd_reference(*targs, tcot)
    f64 = edge.edge_program_bwd_reference(*targs, tcot,
                                          weight_sums=torch.float64)
    for g, x in zip(f32[:3], f64[:3]):
        assert torch.equal(g, x)
    for g, x in zip(f32[3:], f64[3:]):
        assert g.dtype == torch.float32 and x.dtype == torch.float64
        assert ((g.double() - x).abs() <= 1e-6 * x.abs().max()).all()


def test_edge_program_on_cpu_launches_nothing():
    _, targs, _, tcot = _operands(8, 4, "float32")
    before = edge.edge_program.launches, edge.edge_program_bwd.launches
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out = edge.edge_program(*leaves)
    assert type(out.grad_fn).__name__ == "EdgeProgramBackward"
    (out * tcot).sum().backward()
    assert edge.edge_program(*targs).grad_fn is None
    assert (edge.edge_program.launches,
            edge.edge_program_bwd.launches) == before


def test_pack_params_matches_jax_layout():
    p = _jax_layer(8, 1)
    layer = _port_layer(p, 8)
    for got, want in zip(edge.pack_params(layer.edge_mlp, layer.coord_mlp),
                         jax_pack_params(p["edge_mlp"], p["coord_mlp"])):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# aggregation 'fused' through egnn_stack_apply
# --------------------------------------------------------------------------

def _graph(f, seed, e=E, out_of_range=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, (B, e)).astype(np.int32)
    dst = rng.integers(0, N, (B, e)).astype(np.int32)
    src[:, 0] = dst[:, 0]                                     # a self-loop
    mask = rng.random((B, e)) >= 0.15
    mask[:, -40:] = False                                     # a padded tail
    if out_of_range:
        src[:, -20:] = N + 3                                  # out of range
    return dict(h=rng.standard_normal((B, N, f)).astype(np.float32),
                x=rng.standard_normal((B, N, 3)).astype(np.float32),
                src=src, dst=dst, mask=mask,
                ef=rng.standard_normal((B, e, 1)).astype(np.float32),
                ch=rng.standard_normal((B, N, H)).astype(np.float32),
                cx=rng.standard_normal((B, N, 3)).astype(np.float32))


def _jax_stack(f, seed):
    return [_jax_layer(f, seed), _jax_layer(H, seed + 1)]


def _jax_named(params, g, dtype):
    """{name: array}: the stack's outputs and ``jax.grad`` of a scalar for
    h, x and every parameter (named as the port names them)."""
    jdt = jnp.dtype(dtype)

    def loss(params, h, x):
        hn, xn = jax_egnn.egnn_stack_apply(
            params, h, x, jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
            jnp.asarray(g["ef"]).astype(jdt), jnp.asarray(g["mask"]),
            aggregation="fused")
        val = (jnp.sum(hn.astype(jnp.float32) * g["ch"])
               + jnp.sum(xn.astype(jnp.float32) * g["cx"]))
        return val, (hn, xn)

    h = jnp.asarray(g["h"]).astype(jdt)
    x = jnp.asarray(g["x"]).astype(jdt)
    (_, (hn, xn)), (gp, gh, gx) = _rounding(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True), params, h, x)
    named = {"h": hn, "x": xn, "dh": gh, "dx": gx}
    for i, layer in enumerate(gp):
        for group, lins in layer.items():
            for j, lin in enumerate(lins):
                for k, v in lin.items():
                    named[f"{i}.{group}.{j}.{k}"] = v
    return {k: _f32(v) for k, v in named.items()}


def _port_named(params, g, f, dtype):
    """The port's counterpart of ``_jax_named``."""
    tdt = getattr(torch, dtype)
    layers = [_port_layer(params[0], f), _port_layer(params[1], H)]
    h = torch.from_numpy(g["h"]).to(tdt).requires_grad_(True)
    x = torch.from_numpy(g["x"]).to(tdt).requires_grad_(True)
    hn, xn = egnn_stack_apply(
        layers, h, x, torch.from_numpy(g["src"]), torch.from_numpy(g["dst"]),
        torch.from_numpy(g["ef"]).to(tdt), torch.from_numpy(g["mask"]),
        aggregation="fused")
    ((hn.float() * torch.from_numpy(g["ch"])).sum()
     + (xn.float() * torch.from_numpy(g["cx"])).sum()).backward()
    named = {"h": hn, "x": xn, "dh": h.grad, "dx": x.grad}
    for i, layer in enumerate(layers):
        for name, prm in layer.named_parameters():
            named[f"{i}.{name}"] = prm.grad
    return named


@pytest.mark.parametrize("f", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stack_matches_jax(f, dtype):
    """Two EGNN layers under 'fused', with masked edges, a self-loop and
    out-of-range indices on padded edges: outputs and ``jax.grad`` of a
    scalar for h, x and every parameter."""
    params = _jax_stack(f, 20 + f)
    g = _graph(f, 20 + f)
    want = _jax_named(params, g, dtype)
    got = _port_named(params, g, f, dtype)
    assert sorted(got) == sorted(want)
    # bf16: within twice JAX's own bf16 noise (module docstring)
    noise = (None if dtype == "float32" else
             {k: np.abs(want[k] - v).mean()
              for k, v in _jax_named(params, g, "float32").items()})
    for name, w in want.items():
        t = got[name]
        assert t.dtype == (torch.float32 if name[0].isdigit()
                           else getattr(torch, dtype)), name
        t = _f32(t)
        assert t.shape == w.shape and np.isfinite(t).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(t, w, atol=1e-5 * np.abs(w).max(),
                                       rtol=1e-4, err_msg=name)
        else:
            diff = np.abs(t - w).mean()
            assert diff <= LAYER_BF16_NOISE * noise[name], (
                name, diff, noise[name])


def test_fused_matches_scatter_in_the_port():
    """'fused' and 'scatter' compute one function: f32 outputs within
    roundoff (both are plain PyTorch on CPU tensors)."""
    params = _jax_stack(8, 5)
    g = _graph(8, 5, out_of_range=False)
    layers = [_port_layer(params[0], 8), _port_layer(params[1], H)]
    args = [torch.from_numpy(g[k]) for k in ("h", "x", "src", "dst", "ef",
                                              "mask")]
    outs = [egnn_stack_apply(layers, *args, aggregation=agg)
            for agg in ("fused", "scatter")]
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("e,ef_width", [(200, 1), (128, 2)])
def test_fused_admission_rule_raises(e, ef_width):
    """Where the JAX package falls back to 'onehot' (E not a multiple of
    128, or edge features wider than 1), the port raises: 'onehot' is not
    ported."""
    g = _graph(8, 6, e=e)
    layer = _port_layer(_jax_layer(8, 6), 8)
    ef = torch.randn(B, e, ef_width)
    with pytest.raises(ValueError, match="multiple of 128"):
        egnn_stack_apply([layer], torch.from_numpy(g["h"]),
                         torch.from_numpy(g["x"]), torch.from_numpy(g["src"]),
                         torch.from_numpy(g["dst"]), ef,
                         torch.from_numpy(g["mask"]), aggregation="fused")
