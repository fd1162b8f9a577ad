"""B7's plain version (immunostruct_tpu_torch/ops/fused_layer.py) and the
served forward with ``fused_stack=True`` against the JAX package: in f32
against ``ops/experimental/pallas_egnn.py`` (``fused_egnn_layer`` and
``fused_egnn_stack`` in interpret mode, as tests/test_pallas_egnn.py runs
them on the CPU); in bf16 against the JAX 'mega' layer
(``ops/egnn.py::_egnn_apply_mega``: pallas_mega's kernel in interpret mode,
then the node update), whose rounding points B7 takes, since it serves in
place of the 'mega' forward (ops/fused_layer.py; the TPU kernel's own bf16
roundings part a trained model's served probabilities from the 'mega'
forward's by up to 0.085).

The same numpy inputs, made from a seed, go through both: B=2, N=16, E=128
and 256, F=20 and 16, H=16, 30% of the edges masked, self-loops, and
unmasked edges whose src or dst is -1 or N. The JAX side is compiled with
``xla_allow_excess_precision`` off, so every cast to bf16 rounds as it does
in the TPU kernel. Tolerances:

- f32: atol=1e-5, rtol=1e-4 (JAX's own test allows 2e-5/2e-4); measured
  1.2e-7 at most.
- bf16 (and bf16 features over f32 coordinates): every element of h' and
  x' within one bf16 step of the JAX 'mega' layer's, at most 1% of them
  different; the two round at the same points (the node MLP's silu at
  ``jax.nn.silu``'s four, as the port's node update), so only
  an f32 sum in another order can flip one.
- Three layers (``fused_egnn_stack``): f32 atol=1e-5, rtol=1e-4 of
  ``fused_egnn_stack``; bf16 as one layer, against the 'mega' layer three
  times.
- The slice as a whole, HybridModelv2 at small width with all-ones edge
  features: ``model_apply(fused_stack=True)`` in f32 against JAX's
  ``model_apply`` under 'onehot' (B7 equals it in f32, as JAX's test
  shows) within atol=1e-5, rtol=1e-4; in bf16 against JAX's ``model_apply``
  under 'mega': logits, mu, logvar, recon and the attention weights within
  one bf16 step element by element, at most 1% different, the embedding
  within 1e-3 * max|JAX| (the bounds of tests/test_torch_port_model.py's
  bf16 forward, which holds the port's 'mega' forward to the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.models import build_model as jax_build_model
from immunostruct_tpu.models import trunk as jax_trunk
from immunostruct_tpu.ops import egnn as jax_egnn
from immunostruct_tpu.ops.experimental.pallas_egnn import (
    fused_egnn_layer as jax_fused_layer,
    fused_egnn_stack as jax_fused_stack,
)
from immunostruct_tpu.structs import GraphBatch as JaxGraphBatch
from immunostruct_tpu.utils.checkpoint import save_checkpoint
from immunostruct_tpu_torch.data.synthetic import random_sample_arrays
from immunostruct_tpu_torch.models import build_model, model_apply
from immunostruct_tpu_torch.ops import fused_layer
from immunostruct_tpu_torch.ops.egnn import (
    EGNNLayer, egnn_stack, egnn_stack_apply,
)
from immunostruct_tpu_torch.structs import GraphBatch
from immunostruct_tpu_torch.utils.checkpoint import load_jax_checkpoint
from tests.test_torch_port_edge import H, _port_layer, _rounding
from tests.test_torch_port_model import _jax_eps, _within_one_bf16_step

B, N = 2, 16
F32_TOL = dict(atol=1e-5, rtol=1e-4)
SMALL = dict(gcn_layers=2, gat_hidden_channels=16, vae_hidden_dim=32,
             vae_latent_dim=8)
L = 6
FIELDS = ("logits", "mu", "logvar", "recon", "embedding", "attention")


def _graph(e, f, seed):
    """Seeded h, x, src, dst, mask: 30% masked, self-loops, and unmasked
    edges with src or dst at -1 and N."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, N, f)).astype(np.float32)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    src = rng.integers(0, N, (B, e)).astype(np.int32)
    dst = rng.integers(0, N, (B, e)).astype(np.int32)
    mask = rng.random((B, e)) >= 0.3
    src[:, :4] = dst[:, :4]                                  # self-loops
    src[:, 4:6], src[:, 6:8] = -1, N
    dst[:, 8:10], dst[:, 10:12] = -1, N
    mask[:, 4:12] = True
    return h, x, src, dst, mask


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.array(jnp.asarray(t).astype(jnp.float32))


def _compare(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(_f32(g), _f32(w), **F32_TOL)
        else:
            _within_one_bf16_step(_f32(g), _f32(w), 0.01)


def _jax_mega_layers(params, h, x, src, dst, mask):
    """The JAX 'mega' layer over ``params`` (a list: one layer each), as
    B7's bf16 reference: XLA without excess precision."""
    ef = jnp.ones(src.shape + (1,), jnp.float32)

    def stack(ps, h, x, *a):
        for p in ps:
            h, x = jax_egnn._egnn_apply_mega(p, h, x, *a)
        return h, x
    return _rounding(stack, params, h, x, jnp.asarray(src), jnp.asarray(dst),
                     ef, jnp.asarray(mask))


def _both_sides(h, x, dtype, x_dtype):
    jx = (jnp.asarray(h).astype(getattr(jnp, dtype)),
          jnp.asarray(x).astype(getattr(jnp, x_dtype)))
    tx = (torch.from_numpy(h).to(getattr(torch, dtype)),
          torch.from_numpy(x).to(getattr(torch, x_dtype)))
    return jx, tx


@pytest.mark.parametrize("e,f,dtype,x_dtype", [
    (128, 20, "float32", "float32"), (256, 16, "float32", "float32"),
    (128, 20, "bfloat16", "bfloat16"), (256, 16, "bfloat16", "bfloat16"),
    (256, 20, "bfloat16", "float32"),
])
def test_plain_version_matches_jax_kernel(e, f, dtype, x_dtype):
    h, x, src, dst, mask = _graph(e, f, seed=e + f)
    params = jax_egnn.egnn_init(jax.random.key(e + f), f, H, H)
    (jh, jx), (th, tx) = _both_sides(h, x, dtype, x_dtype)
    if dtype == "float32":
        want = _rounding(
            lambda p, *a: jax_fused_layer(p, *a, interpret=True), params,
            jh, jx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    else:
        want = _jax_mega_layers([params], jh, jx, src, dst, mask)
    layer = _port_layer(params, f)
    with torch.no_grad():
        got = fused_layer.fused_egnn_layer(
            layer, th, tx, torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask))
    assert got[0].dtype == th.dtype and got[1].dtype == tx.dtype
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stack_matches_jax_over_three_layers(dtype):
    h, x, src, dst, mask = _graph(128, 20, seed=3)
    params = jax_egnn.egnn_stack_init(jax.random.key(7), 2, 20, H)
    (jh, jx), (th, tx) = _both_sides(h, x, dtype, dtype)
    if dtype == "float32":
        want = _rounding(
            lambda p, *a: jax_fused_stack(p, *a, interpret=True), params,
            jh, jx, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    else:
        want = _jax_mega_layers(params, jh, jx, src, dst, mask)
    layers = [_port_layer(p, 20 if i == 0 else H)
              for i, p in enumerate(params)]
    with torch.no_grad():
        got = fused_layer.fused_egnn_stack(
            layers, th, tx, torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask))
    _compare(got, want, dtype)


def _small_args(e=128, f=8, edge_feat_size=1):
    h, x, src, dst, mask = _graph(e, f, seed=1)
    layer = EGNNLayer(f, H, H, edge_feat_size,
                      generator=torch.Generator().manual_seed(0))
    return layer, [torch.from_numpy(t) for t in (h, x, src, dst, mask)]


@pytest.mark.parametrize("case,match", [
    ("edges", "multiple of 128"), ("edge_feat", "width 1"),
    ("grad_input", "forward only"), ("grad_weight", "forward only"),
])
def test_wrapper_raises(case, match):
    layer, (h, x, src, dst, mask) = _small_args(
        e=100 if case == "edges" else 128,
        edge_feat_size=2 if case == "edge_feat" else 1)
    if case == "grad_input":
        h.requires_grad_(True)
    ctx = torch.no_grad() if case in ("edges", "edge_feat") else \
        torch.enable_grad()
    with ctx, pytest.raises(ValueError, match=match):
        fused_layer.fused_egnn_layer(layer, h, x, src, dst, mask)


def test_launch_count_stays_put_on_the_cpu():
    layer, args = _small_args()
    before = fused_layer.fused_egnn_layer.launches
    with torch.no_grad():
        fused_layer.fused_egnn_layer(layer, *args)
    assert fused_layer.fused_egnn_layer.launches == before


@pytest.mark.parametrize("kw,match", [
    (dict(mega_variant="paired"), "mega_variant"),
    (dict(aggregation="mega"), "aggregation 'mega'"),
    (dict(aggregation="onehot"), "aggregation 'onehot'"),
])
def test_fused_stack_route_raises(kw, match):
    _, (h, x, src, dst, mask) = _small_args(f=20)
    layers = egnn_stack(1, 20, H, generator=torch.Generator().manual_seed(0))
    ef = torch.ones(B, src.shape[1], 1)
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        egnn_stack_apply(layers, h, x, src, dst, ef, mask, fused_stack=True,
                         **kw)


def test_fused_stack_route_refuses_edge_features_other_than_one():
    _, (h, x, src, dst, mask) = _small_args(f=20)
    layers = egnn_stack(1, 20, H, generator=torch.Generator().manual_seed(0))
    ef = torch.ones(B, src.shape[1], 1)
    with torch.no_grad():
        egnn_stack_apply(layers, h, x, src, dst, ef, mask, fused_stack=True)
        ef[0, int(mask[0].nonzero()[0])] = 2.0
        with pytest.raises(ValueError, match="other than 1"):
            egnn_stack_apply(layers, h, x, src, dst, ef, mask,
                             fused_stack=True)


def test_fused_stack_route_raises_under_a_gradient():
    _, (h, x, src, dst, mask) = _small_args(f=20)
    layers = egnn_stack(1, 20, H, generator=torch.Generator().manual_seed(0))
    ef = torch.ones(B, src.shape[1], 1)
    with pytest.raises(ValueError, match="forward only"):
        egnn_stack_apply(layers, h, x, src, dst, ef, mask, fused_stack=True)


# --------------------------------------------------------------------------
# the slice as a whole: model_apply(fused_stack=True)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    spec, params = jax_build_model("HybridModelv2", L * 21,
                                   jax.random.key(3), **SMALL)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    save_checkpoint(path, params)
    _, model = build_model("HybridModelv2", L * 21,
                           torch.Generator().manual_seed(0), **SMALL)
    load_jax_checkpoint(path, model, verbose=False)
    return spec, params, model


def _arrays():
    a = random_sample_arrays(3, N, 128, L, seed=0)
    rng = np.random.default_rng(100)
    a["edge_mask"] = rng.random((3, 128)) >= 0.2
    a["edge_src"][:, :4] = a["edge_dst"][:, :4]
    a["edge_feat"] = np.ones((3, 128, 1), np.float32)       # B7's contract
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_apply_fused_stack_matches_jax(models, dtype):
    spec, params, model = models
    a = _arrays()
    key = jax.random.key(11)
    jdt = getattr(jnp, dtype)
    graph = JaxGraphBatch(**{k: jnp.asarray(a[k]) for k in (
        "node_feat", "coords", "edge_src", "edge_dst", "edge_feat",
        "edge_mask", "node_mask", "num_nodes")})
    ref = jax_trunk.model_apply(params, spec, graph,
                                jnp.asarray(a["seq_onehot"]),
                                jnp.asarray(a["props"]), key,
                                deterministic=True,
                                aggregation=("onehot" if dtype == "float32"
                                             else "mega"),
                                compute_dtype=jdt)
    eps = _jax_eps(key, (3, SMALL["vae_latent_dim"]), jdt)
    with torch.no_grad():
        out = model_apply(model, GraphBatch.from_numpy(a, "cpu"),
                          torch.from_numpy(a["seq_onehot"]),
                          torch.from_numpy(a["props"]), deterministic=True,
                          eps=eps, compute_dtype=getattr(torch, dtype),
                          fused_stack=True)
    for name in FIELDS:
        got, want = getattr(out, name), getattr(ref, name)
        assert tuple(got.shape) == want.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL,
                                       err_msg=name)
        elif name == "embedding":
            assert (np.abs(_f32(got) - _f32(want)).max()
                    <= 1e-3 * np.abs(_f32(want)).max())
        else:
            _within_one_bf16_step(_f32(got), _f32(want), 0.01)


@pytest.mark.parametrize("b,e,sms,cluster", [
    (128, 2560, 132, 1), (200, 2560, 132, 1), (1, 2560, 132, 8),
    (8, 2560, 132, 8), (16, 2560, 132, 8), (32, 2560, 132, 4),
    (64, 2560, 132, 2), (20, 1408, 132, 6), (1, 256, 132, 2),
    (1, 128, 132, 1), (4, 512, 132, 4), (1, 2560, 16, 8), (3, 2560, 16, 5),
    (128, 1408, 132, 1), (66, 2560, 132, 2)])
def test_layer_cluster_size(b, e, sms, cluster):
    """B7's bf16 grid (a cluster of CTAs a graph, one CTA an SM): one wave
    of CTAs on ``sms`` SMs, at least two 64-edge tiles a CTA, at most the
    portable cluster size of 8; one CTA a graph at B=128 on 132 SMs, more
    than one at B=1 where the graph has four tiles or more."""
    got = fused_layer.layer_cluster_size(e, b, sms)
    assert got == cluster
    tiles = -(-e // 64)
    assert 1 <= got <= fused_layer.MAX_CLUSTER
    assert b * got <= max(sms, b)
    assert got == 1 or tiles // got >= 2
    if b == 1 and tiles >= 4 and sms >= 2:
        assert got > 1
