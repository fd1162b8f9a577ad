"""Aggregations 'onehot' and 'onehot_remat' of the PyTorch port
(immunostruct_tpu_torch/ops/egnn.py) against the JAX package's
(ops/egnn.py ``egnn_stack_apply(aggregation='onehot')``), and the 'auto'
chain on CUDA tensors, decided from the shapes alone.

Three EGNN layers (F=20 in, H=16), B=2, N=16, E=128, 20% of the edges
masked, self-loops, seeded edge features. The loss is sum(h' * ch) +
sum(x' * cx) for seeded cotangents; its gradients with respect to h, x and
every weight are held against ``jax.grad``. Tolerances:

- f32: outputs atol=1e-5, rtol=1e-4; gradients |port - JAX| <= 1e-5 *
  max|JAX| + 1e-4 * |JAX| (other f32 summation orders).
- bf16, per tensor: mean|port - JAX| <= 3 * mean|JAX bf16 - JAX f32|,
  three times JAX's own bf16 noise: the node MLP and its backward round
  at other points in the two packages (PyTorch's bf16 silu and matmul
  backward keep f32 inside). Measured: at most 1.2 times the noise with
  bf16 coordinates; with f32 coordinates under bf16 features (x' stays f32
  on both sides) the first layer's coordinate-MLP weight gradients read
  up to 2.5 times it, every other tensor at most 1.7.
- 'onehot_remat' equals 'onehot' bit for bit, outputs and gradients.
- One Trainer step under 'onehot' (HybridModelv2, the bounds of
  tests/test_torch_port_train.py).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu_torch.ops import egnn
from immunostruct_tpu_torch.ops.egnn import (
    egnn_stack_apply, resolve_aggregation,
)
from immunostruct_tpu_torch.structs import SampleBatch
from tests.test_torch_port_edge import H, _port_layer
from tests.test_torch_port_train import (
    _arrays, _jax_batch, _plain_eps, _run_steps, _setup,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

B, N, E, F = 2, 16, 128, 20
NOISE = 3.0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N, (B, E)).astype(np.int32)
    src[:, :4] = dst[:, :4]
    return dict(h=rng.standard_normal((B, N, F)).astype(np.float32),
                x=rng.standard_normal((B, N, 3)).astype(np.float32),
                src=src, dst=dst,
                ef=rng.standard_normal((B, E, 1)).astype(np.float32),
                mask=rng.random((B, E)) >= 0.2,
                ch=rng.standard_normal((B, N, H)).astype(np.float32),
                cx=rng.standard_normal((B, N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def stack():
    params = jax_egnn.egnn_stack_init(jax.random.key(5), 2, F, H)
    layers = [_port_layer(p, F if i == 0 else H)
              for i, p in enumerate(params)]
    return params, layers


def _jax_run(params, g, dtype, x_dtype):
    def loss(p, h, x):
        ho, xo = jax_egnn.egnn_stack_apply(
            p, h, x, jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
            jnp.asarray(g["ef"]), jnp.asarray(g["mask"]),
            aggregation="onehot")
        val = ((ho.astype(jnp.float32) * g["ch"]).sum()
               + (xo.astype(jnp.float32) * g["cx"]).sum())
        return val, (ho, xo)

    h = jnp.asarray(g["h"]).astype(dtype)
    x = jnp.asarray(g["x"]).astype(x_dtype)
    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(params, h, x)
    dp, dh, dx = grads
    flat = [np.array(jnp.asarray(t).astype(jnp.float32))
            for t in jax.tree.leaves(dp)]
    return ([np.array(t.astype(jnp.float32)) for t in outs],
            [np.array(dh.astype(jnp.float32)),
             np.array(dx.astype(jnp.float32))], flat)


def _port_run(layers, g, dtype, x_dtype, aggregation="onehot"):
    for p in layers:
        p.zero_grad()
    h = torch.from_numpy(g["h"]).to(dtype).requires_grad_(True)
    x = torch.from_numpy(g["x"]).to(x_dtype).requires_grad_(True)
    ho, xo = egnn_stack_apply(
        layers, h, x, *(torch.from_numpy(g[k]) for k in ("src", "dst", "ef",
                                                          "mask")),
        aggregation=aggregation)
    ((ho.float() * torch.from_numpy(g["ch"])).sum()
     + (xo.float() * torch.from_numpy(g["cx"])).sum()).backward()
    # the JAX leaves' order: per layer coord_mlp, edge_mlp, node_mlp (keys
    # sorted), each linear's b before w
    flat = []
    for p in layers:
        for group in ("coord_mlp", "edge_mlp", "node_mlp"):
            for lin in getattr(p, group):
                flat += [t.grad.float().numpy().copy()
                         for t in (lin.b, lin.w) if t is not None]
    return ([ho.detach().float().numpy(), xo.detach().float().numpy()],
            [h.grad.float().numpy(), x.grad.float().numpy()], flat, xo.dtype)


def test_onehot_f32_matches_jax(stack):
    params, layers = stack
    g = _inputs()
    outs, ins, flat = _jax_run(params, g, jnp.float32, jnp.float32)
    pouts, pins, pflat, _ = _port_run(layers, g, torch.float32,
                                      torch.float32)
    for got, want in zip(pouts, outs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    assert len(pflat) == len(flat)
    for got, want in zip(pins + pflat, ins + flat):
        assert got.shape == want.shape
        assert (np.abs(got - want)
                <= 1e-5 * np.abs(want).max() + 1e-4 * np.abs(want)).all()


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_onehot_bf16_matches_jax(stack, x_dtype):
    """bf16 features, coordinates in bf16 or in f32 (which 'onehot' keeps:
    x' comes back f32)."""
    params, layers = stack
    g = _inputs(seed=1)
    ref = _jax_run(params, g, jnp.float32, jnp.float32)
    want = _jax_run(params, g, jnp.bfloat16, getattr(jnp, x_dtype))
    *got, xo_dtype = _port_run(layers, g, torch.bfloat16,
                               getattr(torch, x_dtype))
    assert xo_dtype == getattr(torch, x_dtype)
    for gs, ws, rs in zip(got, want, ref):
        for gt, wt, rt in zip(gs, ws, rs):
            noise = np.abs(wt - rt).mean()
            assert np.abs(gt - wt).mean() <= NOISE * noise + 1e-12, (
                np.abs(gt - wt).mean(), noise)


def test_onehot_remat_equals_onehot_under_checkpoint(stack, monkeypatch):
    _, layers = stack
    g = _inputs(seed=2)
    calls = []
    real = egnn.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(egnn, "checkpoint", counted)
    for dtype in (torch.float32, torch.bfloat16):
        plain = _port_run(layers, g, dtype, dtype, "onehot")
        remat = _port_run(layers, g, dtype, dtype, "onehot_remat")
        for a, b in zip(plain[:3], remat[:3]):
            for s, t in zip(a, b):
                np.testing.assert_array_equal(s, t)
    assert calls == [False] * 6            # 3 layers x 2 dtypes, non-reentrant


def test_onehot_matrices_mask_and_range():
    """An index outside [0, N) or a masked edge gives a zero column."""
    idx = torch.tensor([[0, 2, -1, 3, 1]])
    mask = torch.tensor([[True, True, True, True, False]])
    m = egnn.one_hot_matrix(idx, mask, 3)
    want = torch.zeros(1, 3, 5)
    want[0, 0, 0] = want[0, 2, 1] = 1.0
    assert m.dtype == torch.float32 and torch.equal(m, want)


def test_trainer_step_onehot_matches_jax(tmp_path):
    a = _arrays(3, seed=4)
    jt, js, pt, ps = _setup("HybridModelv2", tmp_path, "onehot")
    _run_steps(jt, js, pt, ps, _jax_batch(a), SampleBatch.from_numpy(a, "cpu"),
               lambda rng: _plain_eps(rng, 3))


# --------------------------------------------------------------------------
# 'auto' on CUDA tensors: JAX's chain, from the shapes (no card needed)
# --------------------------------------------------------------------------

CUDA = torch.device("cuda")


def _auto(**kw):
    shape = dict(edges=2560, nodes=288, features=20, hidden=64,
                 edge_feat_size=1)
    shape.update(kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = resolve_aggregation("auto", CUDA, **shape)
    return got, [str(w.message) for w in caught]


def test_auto_chain_mega_where_b1_takes_the_shapes():
    assert _auto() == ("mega", [])
    assert _auto(edges=1000)[0] == "mega"          # B1 takes any E
    assert _auto(nodes=606)[0] == "mega"           # B1's shared memory


@pytest.mark.parametrize("kw", [dict(nodes=700), dict(nodes=700, edges=128)])
def test_auto_chain_fused_where_b1_refuses(kw):
    got, said = _auto(**kw)
    assert got == "fused"
    assert len(said) == 1 and said[0].startswith(
        "aggregation='mega' unsupported") and "falling back to 'fused'" in \
        said[0]


@pytest.mark.parametrize("kw", [dict(hidden=32), dict(edge_feat_size=2),
                                dict(features=80),
                                dict(nodes=700, edges=1000)])
def test_auto_chain_onehot_where_b3_refuses_too(kw):
    got, said = _auto(**kw)
    assert got == "onehot"
    assert len(said) == 2 and "falling back to 'onehot'" in said[1]
    assert "(needs a 128-multiple edge pad and 1-dim edge features)" in \
        said[1]


def test_auto_on_the_cpu_is_scatter_and_names_pass_through():
    shape = dict(edges=100, nodes=16, features=20, hidden=16,
                 edge_feat_size=1)
    assert resolve_aggregation("auto", torch.device("cpu"), **shape) == \
        "scatter"
    for name in ("mega", "fused", "pallas", "onehot", "onehot_remat"):
        assert resolve_aggregation(name, CUDA, **shape) == name
    with pytest.raises(ValueError, match="unknown aggregation"):
        resolve_aggregation("nope", CUDA, **shape)


@pytest.mark.parametrize("name", ["fused", "pallas"])
def test_explicit_kernel_paths_raise_naming_onehot(stack, name):
    _, layers = stack
    g = _inputs()
    args = [torch.from_numpy(g[k]) for k in ("h", "x")]
    args += [torch.from_numpy(g[k][:, :100]) for k in ("src", "dst", "ef",
                                                       "mask")]
    with pytest.raises(ValueError, match="use 'onehot'"):
        egnn_stack_apply(layers, *args, aggregation=name)
