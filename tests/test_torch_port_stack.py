"""The whole-stack EGNN kernel's port (immunostruct_tpu_torch/ops/stack.py:
B6's plain version ``stack_fwd_reference``, ``StackMega`` and
``egnn_stack_apply(mega_variant='stack')``) against the JAX package's
(ops/experimental/pallas_stack.py: ``_stack_fwd_call`` and
``edge_mega_stack``, reached through ``egnn_stack_apply`` when its global
``STACK_ENABLE`` is set, here inside each test and restored after it). The
JAX kernels run in interpret mode, as the JAX package's own tests run them.

The same numpy inputs, made from a seed, go through both: B=2, N=16,
E=256, three layers (F0=20, H=16). Tolerances:

- B6's plain version against ``_stack_fwd_call`` (h, x and agg after each
  layer, the edge residuals on the computed edges), f32: atol=1e-5,
  rtol=1e-4; bf16 (the JAX side compiled without XLA's excess precision):
  each element within one bf16 step, at most 1% of them differing.
- the stack through ``egnn_stack_apply``: the bounds of
  tests/test_torch_port_variants.py (f32 roundoff; bf16: h and x within one
  bf16 step, measured equal; the gradients within BF16_GRAD_TOL of the mean
  plus STACK_BF16_NOISE times JAX's own bf16 noise). The per-layer node
  update's backward rounds at other points in the two packages, as for
  every 'mega' variant, and ``_stack_bwd`` runs it once per layer from the
  saved values: over four seeds the worst gradient read 1.1-4.1 times JAX's
  noise under the stack, against 0.9-1.6 on the per-layer path (the
  medians 0.5-0.8 on both); with the forward equal, the spread is in the
  backward's rounding, and 5 holds the worst with room.
- three Adam steps of the Trainer: tests/test_torch_port_train.py's bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops.experimental import pallas_stack as pstk
from immunostruct_tpu_torch.ops import stack
from immunostruct_tpu_torch.ops.egnn import egnn_stack_apply
from immunostruct_tpu_torch.structs import SampleBatch
from tests.test_torch_port_edge import _rounding
from tests.test_torch_port_mega import _assert_bf16_close, _f32, _port_layer
from tests.test_torch_port_train import (
    _arrays, _jax_batch, _plain_eps, _run_steps, _setup,
)
from tests.test_torch_port_variants import (
    H, N, _graph, _jax_stack, assert_stack_matches, jax_flag, jax_named,
    port_named,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

STACK_BF16_NOISE = 5.0        # the stack's gradients, bf16: x JAX's noise


def _port_stack(params):
    return [_port_layer(params[0], 20, H)] + [
        _port_layer(p, H, H) for p in params[1:]]


def _jax_packed(params):
    """``_stack_fwd_call``'s l0 and hs (the hidden layers stacked)."""
    l0 = pstk.pack_layer(params[0])
    hs = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0),
                      *[pstk.pack_layer(p) for p in params[1:]])
    return l0, hs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_fwd_reference_matches_jax(dtype):
    params = _jax_stack(50)
    g = _graph(50)
    g["src"][:, :3] = g["dst"][:, :3]                          # self-loops
    jdt = jnp.dtype(dtype)
    l0, hs = _jax_packed(params)

    def fwd(src, dst, mask, ef, h0, x0, l0, hs):
        return pstk._stack_fwd_call(src, dst, mask, ef, h0, x0, l0, hs, True)

    want = _rounding(fwd, *(jnp.asarray(g[k]) for k in ("src", "dst",
                                                         "mask")),
                     *(jnp.asarray(g[k]).astype(jdt) for k in ("ef", "h",
                                                               "x")),
                     l0, hs)
    tdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(g[k]) for k in ("src", "dst", "mask")}
    t.update({k: torch.from_numpy(g[k]).to(tdt) for k in ("ef", "h", "x")})
    layers = [tuple(w.detach() for w in stack.pack_layer(p))
              for p in _port_stack(params)]
    got = stack.stack_fwd_reference(t["src"], t["dst"], t["mask"], t["ef"],
                                    t["h"], t["x"], layers)
    h, x, *res = got
    assert all(r.dtype == tdt for r in got)
    torch.testing.assert_close(h, res[0][:, -1], atol=0.0, rtol=0.0)
    torch.testing.assert_close(x, res[1][:, -1], atol=0.0, rtol=0.0)
    valid = (t["mask"] & (t["src"] < N) & (t["dst"] < N)).numpy()
    for name, r, w in zip(("hs", "xs", "aggs", "a1s", "xds"), res, want):
        assert tuple(r.shape) == tuple(w.shape), name
        r, w = _f32(r), _f32(w)
        if name in ("a1s", "xds"):
            r = np.where(valid[:, None, None], r, 0.0)
            w = np.where(valid[:, None, None], w, 0.0)
        if dtype == "float32":
            np.testing.assert_allclose(r, w, atol=1e-5, rtol=1e-4,
                                       err_msg=name)
        else:
            _assert_bf16_close(r, w)


def test_stack_fwd_reference_without_residuals():
    params = _port_stack(_jax_stack(51))
    g = _graph(51)
    args = [torch.from_numpy(g[k]) for k in ("src", "dst", "mask", "ef",
                                              "h", "x")]
    layers = [tuple(w.detach() for w in stack.pack_layer(p)) for p in params]
    full = stack.stack_fwd(*args, layers)
    bare = stack.stack_fwd(*args, layers, residuals=False)
    assert bare[2:] == (None,) * 5
    for a, b in zip(full[:2], bare[:2]):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


@functools.lru_cache(maxsize=None)
def _jax_named(dtype):
    return jax_named(_jax_stack(30), _graph(30), dtype,
                     jax_flag(pstk, "STACK_ENABLE"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_apply_matches_jax(dtype):
    """egnn_stack_apply(mega_variant='stack') against JAX's with
    STACK_ENABLE: outputs and ``jax.grad`` of a scalar for h, x and every
    parameter."""
    want = _jax_named(dtype)
    got = port_named(_jax_stack(30), _graph(30), dtype, "stack")
    noise = None
    if dtype == "bfloat16":
        noise = {k: np.abs(want[k] - v).mean()
                 for k, v in _jax_named("float32").items()}
    assert_stack_matches(got, want, dtype, noise, STACK_BF16_NOISE,
                         steps=True)


def test_stack_equals_per_layer_path_in_f32():
    """The stack and the per-layer 'hybrid' path compute one function: f32
    outputs and gradients within roundoff."""
    params = _jax_stack(52)
    g = _graph(52)
    want = port_named(params, g, "float32", "hybrid")
    got = port_named(params, g, "float32", "stack")
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-5 * np.abs(w).max(),
                                   rtol=1e-4, err_msg=name)


def test_stack_is_differentiable_only_when_needed():
    layers = _port_stack(_jax_stack(53))
    g = _graph(53)
    args = [torch.from_numpy(g[k]) for k in ("h", "x", "src", "dst", "ef",
                                              "mask")]
    with torch.no_grad():
        h0, x0 = egnn_stack_apply(layers, *args, aggregation="mega",
                                  mega_variant="stack")
    assert h0.grad_fn is None
    h1, x1 = egnn_stack_apply(layers, *args, aggregation="mega",
                              mega_variant="stack")
    assert type(h1.grad_fn).__name__ == "StackMegaBackward"
    torch.testing.assert_close(h1.detach(), h0, atol=0.0, rtol=0.0)
    torch.testing.assert_close(x1.detach(), x0, atol=0.0, rtol=0.0)


def test_stack_shapes_it_cannot_take_raise():
    """JAX's stack_supported falls back to the per-layer path; the port
    raises: one layer, 2-dim edge features, unequal hidden layers."""
    layers = _port_stack(_jax_stack(54))
    g = _graph(54)
    args = [torch.from_numpy(g[k]) for k in ("h", "x", "src", "dst", "ef",
                                              "mask")]
    with pytest.raises(ValueError, match="at least two layers"):
        egnn_stack_apply(layers[:1], *args, aggregation="mega",
                         mega_variant="stack")
    wide = list(args)
    wide[4] = torch.cat([args[4], args[4]], dim=-1)
    with pytest.raises(ValueError, match="1-dim edge features"):
        egnn_stack_apply(layers, *wide, aggregation="mega",
                         mega_variant="stack")
    odd = [_port_layer(_jax_stack(55)[0], 20, H), layers[0]]
    with pytest.raises(ValueError, match="hidden layers of width"):
        egnn_stack_apply(odd, *args, aggregation="mega",
                         mega_variant="stack")


def test_trainer_matches_jax(tmp_path):
    """Three Adam steps of ``Trainer(mega_variant='stack')`` against the
    JAX Trainer with STACK_ENABLE (f32, HybridModelv2 at gcn_layers=2,
    gat_hidden_channels=16)."""
    a = _arrays(3, seed=8)
    with jax_flag(pstk, "STACK_ENABLE"):
        jt, js, pt, ps = _setup("HybridModelv2", tmp_path, "mega")
        pt.mega_variant = "stack"
        _run_steps(jt, js, pt, ps, _jax_batch(a),
                   SampleBatch.from_numpy(a, "cpu"),
                   lambda rng: _plain_eps(rng, 3))
