"""The kernel variants of aggregation 'mega' in the PyTorch port
(immunostruct_tpu_torch/ops/mega.py: B4 paired forward, B5a and B5b in-kernel
backwards; the ``mega_variant`` keyword; the paired layout; the race CLI)
against the JAX package's, whose counterparts are module globals of
ops/pallas_mega.py (``MEGA_PAIRED``, ``BWD_DBOTH_INKERNEL``,
``BWD_INKERNEL_NODES``), flipped inside each test and restored after it.

The same numpy inputs, made from a seed, go through both; the JAX kernels
run in interpret mode, as the JAX package's own tests run them on the CPU.
B=2-3, N=16, E=256 (the paired kernel needs its arc half to be one
128-lane tile on the TPU, or JAX falls back to B1), H=16. Tolerances:

- the plain versions against the JAX kernels' wrappers, f32: atol=1e-5,
  rtol=1e-4; bf16: each element within one bf16 step, at most 1% of them
  differing (``test_torch_port_mega.py``'s rule); B5b's node sums are f32
  sums of the same bf16 terms, so f32's bounds hold for them in bf16 too.
- three EGNN layers through ``egnn_stack_apply``: f32 outputs and
  ``jax.grad`` of a scalar within atol=1e-5 * max|JAX| + rtol=1e-4. bf16:
  each variant's gradients against JAX's with the same flag, per tensor,
  mean|port - JAX| <= BF16_GRAD_TOL * mean|JAX| plus the bound of
  ``test_torch_port_edge.py`` for whole layers, twice JAX's own bf16 noise
  (mean|JAX bf16 - JAX f32|): the node MLP's backward rounds at other
  points in the two packages (measured: up to 2.9% of the mean, on a
  node-MLP bias, at 1.45 times JAX's noise, the same for 'hybrid' as for
  every variant; 0.9-1.6 times over four seeds). The
  variants' plain paths are held tighter: in bf16 each equals the port's
  'hybrid' path bit for bit on the CPU (B5a and B4 change no arithmetic,
  and the plain B5b sums the node cotangents in the same order).
- three Adam steps of the Trainer against the JAX Trainer with the flag:
  ``test_torch_port_train.py``'s bounds (f32).
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.data.graphs import GraphCorpus as JaxGraphCorpus
from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu.ops import pallas_mega as pm
from immunostruct_tpu.structs import (
    mirror_pair_edge_index as jax_mirror_pair_edge_index,
)
from immunostruct_tpu_torch.cli import race_kernel_variants
from immunostruct_tpu_torch.data.graphs import GraphCorpus
from immunostruct_tpu_torch.data.synthetic import (
    build_batch, random_sample_arrays,
)
from immunostruct_tpu_torch.ops import mega
from immunostruct_tpu_torch.ops.edge import chunks_per_graph
from immunostruct_tpu_torch.ops.egnn import egnn_apply, egnn_stack_apply
from immunostruct_tpu_torch.structs import SampleBatch, mirror_pair_edge_index
from scripts.perf_sweep import build_batch as jax_build_batch
from tests.test_torch_port_edge import _rounding
from tests.test_torch_port_mega import (
    BF16_GRAD_TOL, _assert_bf16_close, _f32, _jax_args, _jax_layer,
    _port_args, _port_layer,
)
from tests.test_torch_port_train import (
    _jax_batch, _plain_eps, _run_steps, _setup,
)

B, N, E, H = 3, 16, 256, 16
LAYER_BF16_NOISE = 2.0        # whole layers, bf16: x JAX's own bf16 noise
# the JAX global of each variant
FLAGS = {"dboth": "BWD_DBOTH_INKERNEL", "inkernel": "BWD_INKERNEL_NODES",
         "paired": "MEGA_PAIRED"}


@contextlib.contextmanager
def jax_flag(module, name, value=True):
    """Set a JAX module global for the block and restore it after."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _jax_variant(variant):
    if variant == "hybrid":
        return contextlib.nullcontext()
    return jax_flag(pm, FLAGS[variant])


def _paired_inputs(f, seed, b=B, e=E, n=N):
    """A mirror-paired toy batch (arcs without self loops, masks and edge
    features mirrored), as the JAX package's ``_toy_paired``."""
    rng = np.random.default_rng(seed)
    half = e // 2
    s0 = rng.integers(0, n, (b, half)).astype(np.int32)
    d0 = ((s0 + rng.integers(1, n, (b, half))) % n).astype(np.int32)
    m0 = rng.random((b, half)) >= 0.2
    ef0 = rng.standard_normal((b, half, 1)).astype(np.float32)
    return dict(src=np.concatenate([s0, d0], 1),
                dst=np.concatenate([d0, s0], 1),
                mask=np.concatenate([m0, m0], 1),
                ef=np.concatenate([ef0, ef0], 1),
                h=rng.standard_normal((b, n, f)).astype(np.float32),
                x=rng.standard_normal((b, n, 3)).astype(np.float32))


def _close(got, want, dtype, name=""):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    else:
        _assert_bf16_close(got, want)


# --------------------------------------------------------------------------
# the plain versions against the JAX kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paired_fwd_reference_matches_jax(f, dtype):
    """B4's plain version against ``_mega_fwd_kernel_paired``: the output
    and, on the computed edges, the residuals (the mirror's xd is -xd)."""
    a = _paired_inputs(f, seed=f)
    p = _jax_layer(f, H, seed=f)
    with jax_flag(pm, "MEGA_PAIRED"):
        out_ref, a1_ref, xd_ref = pm._mega_fwd_call(
            *_jax_args(a, p, jnp.dtype(dtype)), True)
    args = _port_args(a, _port_layer(p, f, H), getattr(torch, dtype))
    out, a1, xd = mega.edge_mega_paired_fwd_reference(*args)
    assert out.dtype == torch.float32 and out.shape == (B, N, H + 3)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(out_ref), atol=1e-5,
                                   rtol=1e-4)
    else:
        _assert_bf16_close(out.bfloat16(), out_ref)
    valid = mega.valid_edges(*args[:3], N).numpy()[:, None, :]
    for got, want in ((a1, a1_ref), (xd, xd_ref)):
        _close(np.where(valid, _f32(got), 0.0),
               np.where(valid, _f32(want), 0.0), dtype)
    half = E // 2
    torch.testing.assert_close(xd[..., half:], -xd[..., :half], atol=0.0,
                               rtol=0.0)
    # the same function as B1's plain version on the paired batch
    for g, w in zip((out, a1, xd), mega.edge_mega_fwd_reference(*args)):
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)


def test_paired_fwd_reads_the_arc_half_only():
    """B4 computes on the layout the arc half implies: garbage in the
    second half of src, dst and mask changes nothing."""
    a = _paired_inputs(20, seed=3)
    args = _port_args(a, _port_layer(_jax_layer(20, H, seed=3), 20, H),
                      torch.float32)
    base = mega.edge_mega_paired_fwd_reference(*args)
    spoiled = list(args)
    for i in range(3):
        spoiled[i] = args[i].clone()
        spoiled[i][:, E // 2:] = spoiled[i][:, E // 2:].flip(1)
    for g, w in zip(mega.edge_mega_paired_fwd_reference(*spoiled), base):
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)


def _tail_inputs(f, seed, dtype):
    """B5's operands: the residuals of the JAX forward (B1), a seeded node
    cotangent g [B, N, H+3] in the compute dtype."""
    a = _paired_inputs(f, seed)
    a["src"][:, :4] = a["dst"][:, :4]                          # self-loops
    p = _jax_layer(f, H, seed)
    jdt = jnp.dtype(dtype)
    jargs = _jax_args(a, p, jdt)
    _, a1, xd = pm._mega_fwd_call(*jargs, True)
    g = np.random.default_rng(seed + 1).standard_normal(
        (B, N, H + 3)).astype(np.float32)
    jax_in = (*jargs[:4], *jargs[7:], a1, xd,
              jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    targs = _port_args(a, _port_layer(p, f, H), tdt)
    valid = mega.valid_edges(*targs[:3], N)
    port_in = (targs[0], targs[1], valid, targs[3], *targs[7:],
               torch.from_numpy(_f32(a1)).to(tdt),
               torch.from_numpy(_f32(xd)).to(tdt),
               torch.from_numpy(g).to(tdt))
    return jax_in, port_in


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_db_reference_matches_jax(f, dtype):
    """B5a's plain version against ``_tail_bwd_kernel_db``, and against B2's
    plain version with PyTorch's gather (bit for bit)."""
    (src, dst, emask, ef, w2, wc1, small, a1, xd, g), port_in = \
        _tail_inputs(f, f + 1, dtype)
    with jax_flag(pm, "BWD_DBOTH_INKERNEL"):
        want = pm._tail_bwd_call_db(dst, emask, ef, w2, wc1, small, a1, xd,
                                    g, True)
    psrc, pdst, valid, pef, pw2, pwc1, psmall, pa1, pxd, pg = port_in
    got = mega.tail_bwd_db_reference(pdst, valid, pef, pw2, pwc1, psmall,
                                     pa1, pxd, pg)
    for name, t, w in zip(("d_cat", "d_ef", "dw2", "dwc1", "dsmall"), got,
                          want):
        assert tuple(t.shape) == tuple(w.shape), name
        _close(t, w, "float32" if name[1] in "ws" else dtype, name)
    d_both = mega._gather_rows(pg, pdst, valid).transpose(1, 2).contiguous()
    for t, w in zip(got, mega.tail_bwd_reference(pef, pw2, pwc1, psmall,
                                                 pa1, pxd, d_both, valid)):
        torch.testing.assert_close(t, w, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_nodes_reference_matches_jax(f, dtype):
    """B5b's plain version against ``_tail_bwd_kernel_v7``: the node sums
    d_nodes [B, N, 2(H+3)] in f32, d_ef and the weight gradients."""
    (src, dst, emask, ef, w2, wc1, small, a1, xd, g), port_in = \
        _tail_inputs(f, f + 2, dtype)
    with jax_flag(pm, "BWD_INKERNEL_NODES"):
        want = pm._tail_bwd_call_v7(src, dst, emask, ef, w2, wc1, small, a1,
                                    xd, g, True)
    got = mega.tail_bwd_nodes_reference(*port_in)
    assert got[0].dtype == torch.float32 and got[0].shape == (B, N,
                                                              2 * (H + 3))
    np.testing.assert_allclose(_f32(got[0]), _f32(want[0]),
                               atol=1e-5 * np.abs(_f32(want[0])).max(),
                               rtol=1e-4)
    for name, t, w in zip(("d_ef", "dw2", "dwc1", "dsmall"), got[1:],
                          want[1:]):
        assert tuple(t.shape) == tuple(w.shape), name
        _close(t, w, "float32" if name[1] in "ws" else dtype, name)


# --------------------------------------------------------------------------
# three layers through egnn_stack_apply
# --------------------------------------------------------------------------

def _jax_stack(seed):
    return [_jax_layer(20, H, seed), _jax_layer(H, H, seed + 1),
            _jax_layer(H, H, seed + 2)]


def _graph(seed, b=2):
    a = _paired_inputs(20, seed, b=b)
    rng = np.random.default_rng(seed + 50)
    a["ch"] = rng.standard_normal((b, N, H)).astype(np.float32)
    a["cx"] = rng.standard_normal((b, N, 3)).astype(np.float32)
    return a


def jax_named(params, g, dtype, variant):
    """{name: array}: the stack's outputs under aggregation 'mega' with the
    variant's JAX global set, and ``jax.grad`` of a scalar for h, x and
    every parameter (named as the port names them)."""
    jdt = jnp.dtype(dtype)

    def loss(params, h, x):
        hn, xn = jax_egnn.egnn_stack_apply(
            params, h, x, jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
            jnp.asarray(g["ef"]).astype(jdt), jnp.asarray(g["mask"]),
            aggregation="mega")
        val = (jnp.sum(hn.astype(jnp.float32) * g["ch"])
               + jnp.sum(xn.astype(jnp.float32) * g["cx"]))
        return val, (hn, xn)

    h = jnp.asarray(g["h"]).astype(jdt)
    x = jnp.asarray(g["x"]).astype(jdt)
    with variant:
        (_, (hn, xn)), (gp, gh, gx) = _rounding(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True), params, h, x)
    named = {"h": hn, "x": xn, "dh": gh, "dx": gx}
    for i, layer in enumerate(gp):
        for group, lins in layer.items():
            for j, lin in enumerate(lins):
                for k, v in lin.items():
                    named[f"{i}.{group}.{j}.{k}"] = v
    return {k: _f32(v) for k, v in named.items()}


def port_named(params, g, dtype, variant):
    """The port's counterpart of ``jax_named``."""
    tdt = getattr(torch, dtype)
    layers = [_port_layer(params[0], 20, H)] + [
        _port_layer(p, H, H) for p in params[1:]]
    h = torch.from_numpy(g["h"]).to(tdt).requires_grad_(True)
    x = torch.from_numpy(g["x"]).to(tdt).requires_grad_(True)
    hn, xn = egnn_stack_apply(
        layers, h, x, torch.from_numpy(g["src"]), torch.from_numpy(g["dst"]),
        torch.from_numpy(g["ef"]).to(tdt), torch.from_numpy(g["mask"]),
        aggregation="mega", mega_variant=variant)
    ((hn.float() * torch.from_numpy(g["ch"])).sum()
     + (xn.float() * torch.from_numpy(g["cx"])).sum()).backward()
    named = {"h": hn, "x": xn, "dh": h.grad, "dx": x.grad}
    for i, layer in enumerate(layers):
        for name, prm in layer.named_parameters():
            named[f"{i}.{name}"] = prm.grad
    return {k: _f32(v) for k, v in named.items()}


def assert_stack_matches(got, want, dtype, noise=None,
                         factor=LAYER_BF16_NOISE, steps=False):
    """f32 within roundoff; bf16: within BF16_GRAD_TOL of the mean plus
    ``factor`` times JAX's own bf16 noise (module docstring), and with
    ``steps`` the outputs h and x within one bf16 step (at most 1% of them
    differing)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        t = got[name]
        assert t.shape == w.shape and np.isfinite(t).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(t, w, atol=1e-5 * np.abs(w).max(),
                                       rtol=1e-4, err_msg=name)
        elif steps and name in ("h", "x"):
            _assert_bf16_close(t, w)
        else:
            diff = np.abs(t - w).mean()
            bound = (BF16_GRAD_TOL * np.abs(w).mean()
                     + factor * noise[name])
            assert diff <= bound, (name, diff, bound)


@functools.lru_cache(maxsize=None)
def _jax_stack_named(variant, dtype):
    return jax_named(_jax_stack(30), _graph(30), dtype, _jax_variant(variant))


@pytest.mark.parametrize("variant", ["dboth", "inkernel", "paired"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_apply_variant_matches_jax(variant, dtype):
    want = _jax_stack_named(variant, dtype)
    got = port_named(_jax_stack(30), _graph(30), dtype, variant)
    noise = None
    if dtype == "bfloat16":
        noise = {k: np.abs(want[k] - v).mean()
                 for k, v in _jax_stack_named(variant, "float32").items()}
    assert_stack_matches(got, want, dtype, noise)


@pytest.mark.parametrize("variant", ["dboth", "inkernel", "paired"])
def test_variant_equals_hybrid_in_bf16(variant):
    """The variant's plain path against the port's 'hybrid' path, bf16:
    the same bits."""
    params = _jax_stack(31)
    g = _graph(31)
    want = port_named(params, g, "bfloat16", "hybrid")
    got = port_named(params, g, "bfloat16", variant)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)


# --------------------------------------------------------------------------
# what raises
# --------------------------------------------------------------------------

def _port_stack(seed=40):
    params = _jax_stack(seed)
    return [_port_layer(params[0], 20, H)] + [
        _port_layer(p, H, H) for p in params[1:]]


def _tensors(a):
    return [torch.from_numpy(a[k]) for k in ("h", "x", "src", "dst", "ef",
                                              "mask")]


def test_paired_on_an_unpaired_batch_raises():
    """E=384 random edges: JAX's MEGA_PAIRED falls back to B1 there
    (pallas_mega.py:663-669); the port checks the layout and raises."""
    rng = np.random.default_rng(9)
    a = _paired_inputs(20, 9, b=2, e=384)
    a["src"] = rng.integers(0, N, (2, 384)).astype(np.int32)
    with pytest.raises(ValueError, match="mirror-paired"):
        egnn_stack_apply(_port_stack(), *_tensors(a), aggregation="mega",
                         mega_variant="paired")
    # a mask that is not mirrored breaks it too
    b = _paired_inputs(20, 9, b=2, e=384)
    b["mask"][0, 0] = not b["mask"][0, 384 // 2]
    with pytest.raises(ValueError, match="mirror-paired"):
        egnn_stack_apply(_port_stack(), *_tensors(b), aggregation="mega",
                         mega_variant="paired")


def test_paired_on_an_odd_edge_count_raises():
    a = _paired_inputs(20, 10, b=2, e=256)
    for k in ("src", "dst", "mask", "ef"):
        a[k] = np.ascontiguousarray(a[k][:, :255])
    with pytest.raises(ValueError, match="even edge count"):
        egnn_stack_apply(_port_stack(), *_tensors(a), aggregation="mega",
                         mega_variant="paired")
    args = _port_args(a, _port_layer(_jax_layer(20, H, 10), 20, H),
                      torch.float32)
    with pytest.raises(ValueError, match="even edge count"):
        mega.edge_mega_paired_fwd(*args)


@pytest.mark.parametrize("aggregation", ["scatter", "fused", "pallas"])
@pytest.mark.parametrize("variant", ["dboth", "inkernel", "paired", "stack"])
def test_variant_under_another_aggregation_raises(aggregation, variant):
    a = _paired_inputs(20, 11, b=2)
    with pytest.raises(ValueError, match="form of aggregation 'mega'"):
        egnn_stack_apply(_port_stack(), *_tensors(a),
                         aggregation=aggregation, mega_variant=variant)


def test_unknown_variant_and_per_layer_stack_raise():
    a = _paired_inputs(20, 12, b=2)
    layers = _port_stack()
    with pytest.raises(ValueError, match="unknown mega_variant"):
        egnn_stack_apply(layers, *_tensors(a), aggregation="mega",
                         mega_variant="v9")
    with pytest.raises(ValueError, match="egnn_stack_apply"):
        egnn_apply(layers[0], *_tensors(a), aggregation="mega",
                   mega_variant="stack")


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors every variant takes the plain versions."""
    counted = race_kernel_variants.counters()
    before = {k: fn.launches for k, fn in counted.items()}
    for variant in ("dboth", "inkernel", "paired", "stack"):
        port_named(_jax_stack(41), _graph(41), "float32", variant)
    assert {k: fn.launches for k, fn in counted.items()} == before


@pytest.mark.parametrize("b,e,chunks", [
    (128, 2560, 2), (132, 2560, 1), (200, 2560, 1), (1, 2560, 40),
    (1, 100, 2), (25, 2560, 6), (66, 1408, 2), (3, 0, 1)])
def test_chunks_per_graph(b, e, chunks):
    """The grid of B2, B5a and B5b (and B3) on a 132-SM card: at least one
    CTA per SM while a graph has 64-edge tiles to split, no chunk without
    a tile."""
    got = chunks_per_graph(e, b, 64, 132)
    assert got == chunks
    tiles = max(1, -(-e // 64))
    assert got <= tiles
    assert b * got >= 132 or got == tiles


# --------------------------------------------------------------------------
# the paired layout and the race's batch
# --------------------------------------------------------------------------

def _symmetric_list(rng):
    """tests/test_misc.py ``test_pairs_symmetric_list``'s input."""
    s0 = rng.permutation(40)[:12]
    d0 = (s0 + 1 + rng.integers(0, 38, 12)) % 40
    keep = s0 != d0
    s0, d0 = s0[keep], d0[keep]
    seen, arcs = set(), []
    for a, b in zip(s0, d0):
        k = (min(a, b), max(a, b))
        if k not in seen:
            seen.add(k)
            arcs.append((a, b))
    s0 = np.array([a for a, _ in arcs])
    d0 = np.array([b for _, b in arcs])
    ei = np.stack([np.concatenate([s0, d0]), np.concatenate([d0, s0])])
    return ei[:, rng.permutation(ei.shape[1])]


@pytest.mark.parametrize("case", ["symmetric", "missing_reverse",
                                  "self_loop", "odd", "duplicate"])
def test_mirror_pair_edge_index_matches_jax(case):
    ei = {"symmetric": _symmetric_list(np.random.default_rng(0)),
          "missing_reverse": np.array([[0, 1], [1, 2]]),
          "self_loop": np.array([[0, 1, 1, 0], [1, 0, 1, 1]]),
          "odd": np.array([[0], [1]]),
          "duplicate": np.array([[0, 0, 1, 1], [1, 1, 0, 0]])}[case]
    got, want = mirror_pair_edge_index(ei), jax_mirror_pair_edge_index(ei)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _corpus_graphs(rng):
    """tests/test_misc.py ``test_stack_paired_layout``'s graphs."""
    graphs = []
    for g in range(3):
        nn = 10 + g
        s0 = np.array([0, 1, 2, 5]) % nn
        d0 = np.array([3, 4, 6, 7]) % nn
        ei = np.stack([np.concatenate([s0, d0]),
                       np.concatenate([d0, s0])]).astype(np.int32)
        ei = ei[:, rng.permutation(ei.shape[1])]
        graphs.append((np.eye(20, dtype=np.float32)[rng.integers(0, 20, nn)],
                       rng.standard_normal((nn, 3)).astype(np.float32), ei))
    return dict(keys=[f"g{i}" for i in range(3)],
                node_onehot=[g[0] for g in graphs],
                coords=[g[1] for g in graphs],
                edge_index=[g[2] for g in graphs])


@pytest.mark.parametrize("kw", [{}, {"max_edges": 300}, {"max_edges": 10},
                                {"edges_multiple": 8}])
def test_stack_paired_matches_jax(kw):
    fields = _corpus_graphs(np.random.default_rng(5))
    got = GraphCorpus(**fields).stack(paired=True, **kw)
    want = JaxGraphCorpus(**fields).stack(paired=True, **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # and unpaired as before
    plain = GraphCorpus(**fields).stack(**kw)
    for k, w in JaxGraphCorpus(**fields).stack(**kw).items():
        np.testing.assert_array_equal(plain[k], w, err_msg=k)


def test_stack_paired_rejects_unpairable_graphs_as_jax_does():
    fields = _corpus_graphs(np.random.default_rng(6))
    fields["edge_index"][1] = fields["edge_index"][1][:, 1:]
    for corpus in (GraphCorpus(**fields), JaxGraphCorpus(**fields)):
        with pytest.raises(ValueError, match="graph g1: edge list not"):
            corpus.stack(paired=True)


@pytest.mark.parametrize("paired", [False, True])
def test_build_batch_matches_perf_sweep(paired):
    """``build_batch`` makes scripts/perf_sweep.py's arrays bit for bit."""
    got = build_batch(3, 16, 64, 10, paired=paired)
    want = jax_build_batch(3, 16, 64, 10, paired=paired)
    for k in ("node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
              "edge_mask", "node_mask", "num_nodes"):
        w = np.asarray(getattr(want.graph, k))
        g = getattr(got.graph, k).numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("seq_onehot", "props", "target"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    if paired:
        mega.check_paired(got.graph.edge_src, got.graph.edge_dst,
                          got.graph.edge_mask)


# --------------------------------------------------------------------------
# the Trainer and the race
# --------------------------------------------------------------------------

def _paired_arrays(b, seed):
    """The train tests' batch (N=16, L=6) with E=256 mirror-paired edges."""
    a = random_sample_arrays(b, N, E, 6, seed=seed)
    p = _paired_inputs(20, seed, b=b)
    for k in ("src", "dst", "mask", "ef"):
        a[f"edge_{k}" if k != "ef" else "edge_feat"] = p[k]
    a["target"] = (np.arange(b) % 2 == 0).astype(np.float32)
    return a


@pytest.mark.parametrize("variant", ["dboth", "inkernel", "paired"])
def test_trainer_matches_jax(tmp_path, variant):
    """Three Adam steps of ``Trainer(mega_variant=...)`` against the JAX
    Trainer with the variant's global set (f32, HybridModelv2 at
    gcn_layers=2, gat_hidden_channels=16)."""
    a = _paired_arrays(3, seed=7)
    with _jax_variant(variant):
        jt, js, pt, ps = _setup("HybridModelv2", tmp_path, "mega")
        pt.mega_variant = variant
        _run_steps(jt, js, pt, ps, _jax_batch(a),
                   SampleBatch.from_numpy(a, "cpu"),
                   lambda rng: _plain_eps(rng, 3))


def test_race_cli_on_the_cpu(capsys):
    """``cli.race_kernel_variants --device cpu`` at B=2, one step per
    variant: one JSON line, every variant with a finite loss."""
    out = race_kernel_variants.main([
        "--device", "cpu", "--batch", "2", "--edges", "256", "--windows",
        "1", "--steps", "1", "--burnin", "0", "--paired-batch"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    assert list(out) == ["diff16", "dboth", "inkernel", "paired", "stack",
                         "fused"]
    for v, r in out.items():
        assert len(r["windows_ms"]) == 1 and r["p50_ms"] == r["best_ms"], v
        assert np.isfinite(r["loss0"]) and np.isfinite(r["min_loss"]), v
        assert len(r["windows_loss"]) == 1, v
        assert r["windows_loss"][0] == r["min_loss"], v    # one step
        assert r["launches_per_step"] == {}, v     # plain versions on CPU


@pytest.mark.parametrize("name", ["base", "cast", "stacked", "split",
                                  "concat", "inner2", "tinner4", "combo22",
                                  "combo4x2", "skipprobe"])
def test_race_cli_refuses_tpu_lowering_forms(name):
    with pytest.raises(ValueError, match="TPU lowering form"):
        race_kernel_variants.check_variants([name], False)


def test_race_cli_paired_needs_the_paired_batch():
    with pytest.raises(ValueError, match="--paired-batch"):
        race_kernel_variants.check_variants(["paired"], False)
