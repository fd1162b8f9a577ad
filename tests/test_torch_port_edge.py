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
from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.models import build_model
from immunostruct_tpu_torch.ops import edge, segment
from immunostruct_tpu_torch.ops.egnn import EGNNLayer, egnn_stack_apply
from immunostruct_tpu_torch.procedures.train import Trainer, make_optimizer
from immunostruct_tpu_torch.utils.losses import LossConfig
from immunostruct_tpu_torch.utils.schedule import constant_lr
from immunostruct_tpu_torch.utils.checkpoint import load_params
from tests.torch_threads import one_torch_thread  # noqa: F401

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
    _check_fused_stack(f, 20 + f, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sums_go_through_segment_scatter(dtype, monkeypatch):
    """'fused' sums its aggregation and its two gathers' backward through
    B8's scatter (``segment_scatter``: each (n, c) in edge order, in f32,
    as on the card): three calls a layer, six for two layers, the
    aggregation's on f32 messages, the gathers' on the cotangent in the
    compute dtype; outputs and gradients held against JAX as
    ``test_fused_stack_matches_jax`` holds them, on its inputs at F=8."""
    calls = []
    real = segment.segment_scatter

    def counted(idx, mask, m, num_nodes):
        calls.append(m.dtype)
        return real(idx, mask, m, num_nodes)

    monkeypatch.setattr(segment, "segment_scatter", counted)
    _check_fused_stack(8, 28, dtype)
    tdt = getattr(torch, dtype)
    assert sorted(map(str, calls)) == sorted(
        map(str, [torch.float32] * 2 + [tdt] * 4))


def test_fused_train_step_repeats_on_the_cpu():
    """Two trainers from the same seed take one bf16 'fused' step each on
    the same batch: the same loss, parameters and Adam moments, bit for
    bit."""
    runs = []
    for _ in range(2):
        _, model = build_model("HybridModelv2", 8 * 21,
                               torch.Generator().manual_seed(4),
                               gcn_layers=2, gat_hidden_channels=H,
                               vae_hidden_dim=32, vae_latent_dim=8)
        trainer = Trainer(model.spec, LossConfig(8 * 21, 1.0), binary=True,
                          optimizer=make_optimizer("adam", constant_lr(1e-3)),
                          aggregation="fused", compute_dtype=torch.bfloat16)
        state = trainer.init_state(model)
        batch = random_sample_batch(B, N, E, 8, seed=4)
        state, loss = trainer.train_step(state, batch, seed=0)
        params = list(model.parameters())
        runs.append([loss] + [p.detach() for p in params] + [
            state.optimizer.state[p][k] for p in params
            for k in ("exp_avg", "exp_avg_sq")])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _check_fused_stack(f, seed, dtype):
    params = _jax_stack(f, seed)
    g = _graph(f, seed)
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
    128, or edge features wider than 1), the port raises and names it."""
    g = _graph(8, 6, e=e)
    layer = _port_layer(_jax_layer(8, 6), 8)
    ef = torch.randn(B, e, ef_width)
    with pytest.raises(ValueError, match="multiple of 128"):
        egnn_stack_apply([layer], torch.from_numpy(g["h"]),
                         torch.from_numpy(g["x"]), torch.from_numpy(g["src"]),
                         torch.from_numpy(g["dst"]), ef,
                         torch.from_numpy(g["mask"]), aggregation="fused")


def _xla_cpu_silu(z):
    """silu as XLA's CPU lowering computes it in bf16: x * 1 / (1 +
    exp(-x)), each step rounded to bf16."""
    return z * torch.reciprocal(1 + torch.exp(-z))


def test_bf16_fused_layers_part_from_jax_at_the_node_mlp_silu(monkeypatch):
    """Where the bf16 two-layer parity against JAX parts (ROADMAP §C: F=8,
    seed 31 reads past ``test_fused_stack_matches_jax``'s bound on
    ``0.coord_mlp.0.w``, so the test keeps its seeds 28 and 36).

    ``jax.nn.silu`` in bf16 on the CPU rounds exp(-x), 1 + exp(-x), its
    reciprocal and the product, each to bf16, with the test's compile
    options and with XLA's defaults alike; the port's node MLP computes
    silu in f32 and rounds once, as the kernels round the edge chain's
    silu (ops/edge.py). Held here: JAX's silu is that four-step rounding
    bit for bit on seeded bf16 values, and the port's differs from it in
    many entries; with the port's node-MLP silu replaced by the four steps,
    the two layers' forward (h, x) is JAX's bit for bit at seed 31. The
    gradients then still differ: each autodiff rounds the backward of the
    expansion at its own points."""
    rng = np.random.default_rng(31)
    z = torch.from_numpy((4 * rng.standard_normal(4096)).astype(
        np.float32)).bfloat16()
    zj = jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)
    jax_default = _f32(jax.jit(jax.nn.silu)(zj))
    jax_rounding = _f32(_rounding(jax.nn.silu, zj))
    four = _f32(_xla_cpu_silu(z))
    assert np.array_equal(jax_default, four)
    assert np.array_equal(jax_rounding, four)
    port = _f32(torch.nn.functional.silu(z))
    assert np.array_equal(port, _f32(torch.nn.functional.silu(z.float())
                                     .bfloat16()))
    differ = (port != four).mean()
    print(f"bf16 silu: the port's single rounding and XLA's four differ "
          f"in {differ:.3f} of {z.numel()} seeded entries")
    assert differ > 0.05

    f, seed = 8, 31
    params = _jax_stack(f, seed)
    g = _graph(f, seed)
    want = _jax_named(params, g, "bfloat16")
    monkeypatch.setattr(torch.nn.functional, "silu", _xla_cpu_silu)
    got = _port_named(params, g, f, "bfloat16")
    for name in ("h", "x"):
        assert np.array_equal(_f32(got[name]), want[name]), name
