"""The PyTorch port's segment scatter and gather (immunostruct_tpu_torch/ops/
segment.py: B8's plain versions and the autograd Functions
``SegmentScatter``/``SegmentGather``) and aggregation 'pallas'
(immunostruct_tpu_torch/ops/egnn.py) against the JAX package's
(ops/experimental/pallas_segment.py ``segment_scatter``/``segment_gather``
and their custom VJPs, run in interpret mode as tests/test_pallas_segment.py
runs them on the CPU; ops/egnn.py ``egnn_apply``/``egnn_stack_apply`` with
``aggregation='pallas'``).

The same numpy inputs, made from a seed, go through both; the JAX side is
compiled with ``xla_allow_excess_precision`` off, so that every cast to
bf16 rounds as on the TPU. B=2, N=24, C=16, E = 128, 256, 512 and 1280 (each
of the JAX wrapper's tiles, 1280 in 256-edge tiles), and at B=1, C=1 and
C=3, with masked edges and indices at -1 and N on masked and unmasked edges.
Tolerances:

- the gather and the scatter's VJP (a gather): bit for bit in f32 and bf16
  (one non-zero term);
- the scatter and the gather's VJP (a scatter): f32 atol=1e-6, rtol=1e-5
  (another summation order); bf16 within one bf16 step of the larger
  magnitude, or of 2^-10 below that (near a cancellation the f32
  roundoff of a sum of terms of size ~1 can exceed a step there): both sum
  in f32 and round once;
- 'pallas' through one and two EGNN layers: f32 outputs and ``jax.grad``
  of a scalar within atol=1e-5 * max|JAX| + rtol=1e-4, as
  tests/test_torch_port_edge.py holds 'fused'. bf16, per tensor:
  mean|port - JAX| <= 2 * mean|JAX bf16 - JAX f32|, twice JAX's own bf16
  noise (the node MLP and the gathers' backward round at other points in
  the two packages; tests/test_torch_port_edge.py's bound for 'fused').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu.ops.experimental.pallas_segment import (
    segment_gather as jax_gather, segment_scatter as jax_scatter,
)
from immunostruct_tpu_torch.ops import segment
from immunostruct_tpu_torch.ops.egnn import (
    EGNNLayer, egnn_apply, egnn_stack_apply,
)
from immunostruct_tpu_torch.utils.checkpoint import load_params
from tests.torch_threads import one_torch_thread  # noqa: F401

B, N, C, H = 2, 24, 16, 16
LAYER_BF16_NOISE = 2.0


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _rounding(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _inputs(e, seed, b=B, c=C):
    """idx, mask [b, E] with indices -1 and N on masked and unmasked edges;
    m [b, E, c], h [b, N, c] and the cotangents of the scatter [b, N, c] and
    of the gather [b, E, c]."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (b, e)).astype(np.int32)
    mask = rng.random((b, e)) >= 0.1
    idx[:, 0:4], idx[:, 4:8] = -1, N
    mask[:, 0:8:2] = False
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, e, c), (b, N, c), (b, N, c), (b, e, c))]
    return idx, mask, arrays


def _within_one_bf16_step(got, want):
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -10)
    step = np.exp2(np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= step).all(), np.abs(got - want).max()


def _jax_side(idx, mask, arrays, dtype):
    """(scatter, gather, scatter's VJP, gather's VJP) of the JAX kernels."""
    jdt = jnp.dtype(dtype)
    m, h, cot_n, cot_e = (jnp.asarray(a).astype(jdt) for a in arrays)

    def fn(idx, mask, m, h, cot_n, cot_e):
        s, s_vjp = jax.vjp(lambda m: jax_scatter(idx, mask, m, N, True), m)
        g, g_vjp = jax.vjp(lambda h: jax_gather(idx, mask, h, True), h)
        return s, g, s_vjp(cot_n)[0], g_vjp(cot_e)[0]

    return [_f32(t) for t in _rounding(fn, jnp.asarray(idx),
                                       jnp.asarray(mask), m, h, cot_n,
                                       cot_e)]


@pytest.mark.parametrize("e", [128, 256, 512, 1280])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_ops_match_jax(e, dtype):
    _check_segment_ops(*_inputs(e, seed=e), dtype)


@pytest.mark.parametrize("b,c,e", [(1, 16, 128), (2, 1, 128), (2, 3, 128),
                                   (1, 3, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_ops_match_jax_narrow(b, c, e, dtype):
    """The kernels' small grids: one graph (B=1), one and three channels
    (C=1, 3), the smallest E the JAX wrapper takes."""
    _check_segment_ops(*_inputs(e, seed=b + c + e, b=b, c=c), dtype)


def _check_segment_ops(idx, mask, arrays, dtype):
    """The plain versions and the autograd Functions against the JAX
    kernels in interpret mode (module docstring)."""
    want = _jax_side(idx, mask, arrays, dtype)
    tdt = getattr(torch, dtype)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    m, h, cot_n, cot_e = (torch.from_numpy(a).to(tdt) for a in arrays)
    plain = [segment.segment_scatter_reference(ti, tm, m, N),
             segment.segment_gather_reference(ti, tm, h)]
    # the autograd Functions: forward, and backward through the other op
    m_leaf, h_leaf = m.clone().requires_grad_(), h.clone().requires_grad_()
    s = segment.SegmentScatter.apply(ti, tm, m_leaf, N)
    g = segment.SegmentGather.apply(ti, tm, h_leaf)
    s.backward(cot_n)
    g.backward(cot_e)
    for got, ref in zip((s, g), plain):
        assert got.dtype == tdt and torch.equal(got, ref)
    got = [_f32(t) for t in (*plain, m_leaf.grad, h_leaf.grad)]
    assert m_leaf.grad.dtype == h_leaf.grad.dtype == tdt
    for name, gt, w in zip(("scatter", "gather", "scatter_vjp", "gather_vjp"),
                           got, want):
        assert gt.shape == w.shape, name
        if name in ("gather", "scatter_vjp"):
            np.testing.assert_array_equal(gt, w, err_msg=name)
        elif dtype == "float32":
            np.testing.assert_allclose(gt, w, atol=1e-6, rtol=1e-5,
                                       err_msg=name)
        else:
            _within_one_bf16_step(gt, w)
    # an out-of-range or masked edge gathers zeros and adds nothing
    assert not got[1][:, :8].any()
    assert not got[2][:, :8].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_plain_version_sums_in_edge_order(dtype):
    """On CPU tensors the scatter's plain version is each element's f32 sum
    of its valid edges' messages in edge order from +0, rounded once: the
    bits the scatter kernel gives (csrc/segment.cu sums in that order), which
    the card tests and chip_smoke.py assert. A sequential numpy sum here."""
    idx, mask, arrays = _inputs(512, seed=3)
    idx[:, -100:], mask[:, -100:] = 0, False        # the corpus's padding
    tdt = getattr(torch, dtype)
    m = torch.from_numpy(arrays[0]).to(tdt)
    got = segment.segment_scatter_reference(torch.from_numpy(idx),
                                            torch.from_numpy(mask), m, N)
    msgs = m.float().numpy()
    want = np.zeros((B, N, C), np.float32)
    for b in range(B):
        for e in range(idx.shape[1]):
            if mask[b, e] and 0 <= idx[b, e] < N:
                want[b, idx[b, e]] += msgs[b, e]
    assert torch.equal(got, torch.from_numpy(want).to(tdt))


@pytest.mark.parametrize("n,b,nodes", [(288, 128, 58), (288, 25, 12),
                                       (288, 1, 8), (288, 200, 96),
                                       (1, 25, 1), (2048, 2, 8),
                                       (5000, 200, 1024), (50000, 200, 1024),
                                       (7, 1, 7), (288, 700, 288)])
def test_scatter_range_nodes(n, b, nodes):
    """The scatter's grid (one CTA per (graph, node range)) on a card that
    holds 660 CTAs at once (5 an SM on 132 SMs): ranges of at least 8 nodes
    (one a warp) where the graph has them and at most SCATTER_MAX_RANGE, as
    many as fit in one wave, at least one a graph."""
    got = segment.scatter_range_nodes(n, b, 660)
    assert got == nodes
    ranges = -(-n // got)
    assert min(n, 8) <= got <= segment.SCATTER_MAX_RANGE
    assert b * ranges <= max(660, b) or got == segment.SCATTER_MAX_RANGE
    # the smallest such range: one node fewer would not fit or be too small
    if 1 < got < segment.SCATTER_MAX_RANGE:
        more = -(-n // (got - 1))
        assert b * more > max(660, b) or more > max(1, n // 8)


@pytest.mark.parametrize("e,b,edges", [(2560, 128, 512), (1280, 25, 64),
                                       (1280, 77, 184), (2560, 1, 32),
                                       (1283, 8, 40), (128, 200, 48),
                                       (0, 4, 8), (100000, 1, 192)])
def test_gather_chunk_edges(e, b, edges):
    """The gather's grid on a 132-SM card (one CTA per (graph, edge
    chunk)): chunks of a multiple of 8 edges (so that each chunk's run
    starts on 16 bytes in bf16 where its graph's does), at least 32 where
    the graph has them and at most GATHER_MAX_CHUNK, as many as give every
    SM two CTAs (the rule asks four; a chunk's size is rounded up)."""
    got = segment.gather_chunk_edges(e, b, 132)
    assert got == edges
    assert got % 8 == 0 and 8 <= got <= segment.GATHER_MAX_CHUNK
    chunks = -(-e // got)
    assert b * chunks >= 2 * 132 or chunks >= max(1, e // 32) or e == 0


def test_segment_ops_on_cpu_launch_nothing():
    idx, mask, arrays = _inputs(128, seed=1)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    m = torch.from_numpy(arrays[0]).requires_grad_()
    before = segment.segment_scatter.launches, segment.segment_gather.launches
    out = segment.SegmentScatter.apply(ti, tm, m, N)
    assert type(out.grad_fn).__name__ == "SegmentScatterBackward"
    out.sum().backward()
    assert segment.segment_gather(ti, tm, out.detach()).shape == (B, 128, C)
    assert (segment.segment_scatter.launches,
            segment.segment_gather.launches) == before


def _bad_operands(fault):
    """(idx, mask, data) for the kernels' operand check, with one fault."""
    idx = torch.zeros(B, 128, dtype=torch.int32)
    mask = torch.ones(B, 128, dtype=torch.bool)
    data = torch.zeros(B, 128, C)
    if fault == "data dtype":
        data = data.half()
    elif fault == "data rank":
        data = data[0]
    elif fault == "idx dtype":
        idx = idx.long()
    elif fault == "mask dtype":
        mask = mask.to(torch.uint8)
    elif fault == "mask shape":
        mask = mask[:, :64]
    elif fault == "data rows":
        data = data[:, :100]
    elif fault == "idx contiguous":
        idx = torch.zeros(128, B, dtype=torch.int32).T
    elif fault == "data contiguous":
        data = torch.zeros(B, C, 128).transpose(1, 2)
    elif fault == "mask device":
        mask = torch.ones(B, 128, dtype=torch.bool, device="meta")
    elif fault == "empty batch":
        idx, mask, data = idx[:0], mask[:0], data[:0]
    elif fault == "no channels":
        data = data[..., :0]
    return idx, mask, data


@pytest.mark.parametrize("fault,message", [
    (None, None), ("data dtype", "float32 or bfloat16 data"),
    ("data rank", r"idx \[B, E\] and data \[B, 128, C\] expected"),
    ("idx dtype", "idx has dtype torch.int64"),
    ("mask dtype", "mask has dtype torch.uint8"),
    ("mask shape", r"mask has shape \(2, 64\), expected \(2, 128\)"),
    ("data rows", r"data has shape \(2, 100, 16\), expected \(2, 128, 16\)"),
    ("idx contiguous", "idx is not contiguous"),
    ("data contiguous", "data is not contiguous"),
    ("mask device", "mask is on meta"),
    ("empty batch", "empty batch or channels"),
    ("no channels", "empty batch or channels")])
def test_operand_check_names_each_fault(fault, message):
    """The kernels' operand check (``_check``, run before any launch on the
    card) passes good operands and names the first fault of bad ones."""
    idx, mask, data = _bad_operands(fault)
    if message is None:
        segment._check("segment_gather", idx, mask, data, 128)
        return
    with pytest.raises(ValueError, match="segment_gather.*" + message):
        segment._check("segment_gather", idx, mask, data, 128)


# --------------------------------------------------------------------------
# aggregation 'pallas' through egnn_apply and egnn_stack_apply
# --------------------------------------------------------------------------

def _jax_layer(f, seed):
    return jax_egnn.egnn_init(jax.random.key(seed), f, H, H)


def _port_layer(p, f):
    layer = EGNNLayer(f, H, H, generator=torch.Generator().manual_seed(0))
    flat = {f"{group}.{i}.{k}": np.asarray(v)
            for group in ("edge_mlp", "node_mlp", "coord_mlp")
            for i, lin in enumerate(p[group]) for k, v in lin.items()}
    return load_params(layer, flat, verbose=False)


def _graph(f, seed, e=256):
    """In-range indices (the 'pallas' gathers, as JAX's, do not mask the
    index), a self-loop, masked edges and a padded tail."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, (B, e)).astype(np.int32)
    dst = rng.integers(0, N, (B, e)).astype(np.int32)
    src[:, 0] = dst[:, 0]
    mask = rng.random((B, e)) >= 0.15
    mask[:, -40:] = False
    return dict(h=rng.standard_normal((B, N, f)).astype(np.float32),
                x=rng.standard_normal((B, N, 3)).astype(np.float32),
                src=src, dst=dst, mask=mask,
                ef=rng.standard_normal((B, e, 1)).astype(np.float32),
                ch=rng.standard_normal((B, N, H)).astype(np.float32),
                cx=rng.standard_normal((B, N, 3)).astype(np.float32))


def _jax_named(params, g, dtype):
    """{name: array}: the layers' outputs and ``jax.grad`` of a scalar for h,
    x and every parameter; one layer through ``egnn_apply``, more through
    ``egnn_stack_apply``."""
    jdt = jnp.dtype(dtype)
    args = (jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
            jnp.asarray(g["ef"]).astype(jdt), jnp.asarray(g["mask"]))

    def loss(params, h, x):
        if len(params) == 1:
            hn, xn = jax_egnn.egnn_apply(params[0], h, x, *args,
                                         aggregation="pallas")
        else:
            hn, xn = jax_egnn.egnn_stack_apply(params, h, x, *args,
                                               aggregation="pallas")
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
    tdt = getattr(torch, dtype)
    layers = [_port_layer(p, f if i == 0 else H) for i, p in enumerate(params)]
    h = torch.from_numpy(g["h"]).to(tdt).requires_grad_(True)
    x = torch.from_numpy(g["x"]).to(tdt).requires_grad_(True)
    args = (torch.from_numpy(g["src"]), torch.from_numpy(g["dst"]),
            torch.from_numpy(g["ef"]).to(tdt), torch.from_numpy(g["mask"]))
    if len(layers) == 1:
        hn, xn = egnn_apply(layers[0], h, x, *args, aggregation="pallas")
    else:
        hn, xn = egnn_stack_apply(layers, h, x, *args, aggregation="pallas")
    ((hn.float() * torch.from_numpy(g["ch"])).sum()
     + (xn.float() * torch.from_numpy(g["cx"])).sum()).backward()
    named = {"h": hn, "x": xn, "dh": h.grad, "dx": x.grad}
    for i, layer in enumerate(layers):
        for name, prm in layer.named_parameters():
            named[f"{i}.{name}"] = prm.grad
    return named


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_layers_match_jax(layers, dtype):
    """'pallas' through one layer (``egnn_apply``) and a two-layer stack,
    with masked edges and a self-loop: outputs and ``jax.grad`` of a scalar
    for h, x and every parameter."""
    f = 8
    params = [_jax_layer(f, 30)] + [_jax_layer(H, 31)] * (layers - 1)
    g = _graph(f, 30 + layers)
    want = _jax_named(params, g, dtype)
    got = _port_named(params, g, f, dtype)
    assert sorted(got) == sorted(want)
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


def test_pallas_matches_scatter_in_the_port():
    """'pallas' and 'scatter' compute one function: f32 outputs within
    roundoff (both are plain PyTorch on CPU tensors)."""
    params = [_jax_layer(8, 5), _jax_layer(H, 6)]
    g = _graph(8, 5)
    layers = [_port_layer(params[0], 8), _port_layer(params[1], H)]
    args = [torch.from_numpy(g[k]) for k in ("h", "x", "src", "dst", "ef",
                                              "mask")]
    outs = [egnn_stack_apply(layers, *args, aggregation=agg)
            for agg in ("pallas", "scatter")]
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_pallas_admission_rule_raises():
    """E=1000 is not a multiple of 128: the JAX package falls back to
    'onehot'; the port raises and names it."""
    g = _graph(8, 6, e=1000)
    layer = _port_layer(_jax_layer(8, 6), 8)
    with pytest.raises(ValueError, match="use 'onehot'"):
        egnn_stack_apply([layer], *(torch.from_numpy(g[k]) for k in (
            "h", "x", "src", "dst", "ef", "mask")), aggregation="pallas")
