"""The PyTorch port's edge_mega (immunostruct_tpu_torch/ops/mega.py) against
the JAX package's mega kernels (ops/pallas_mega.py: edge_mega and its VJP,
_mega_fwd_call, _tail_bwd_call, run in interpret mode as the JAX package's
own tests run them on the CPU).

The same numpy inputs, made from a seed, go through both. Tolerances:

- f32: atol=1e-5, rtol=1e-4 (roundoff of a different summation order).
- bf16 values (the aggregate, which the JAX kernel rounds to bf16 and the
  port returns in f32 and rounds where the model does; the residuals;
  B2's outputs): each element within one bf16 step of JAX's, and at most
  1% of them differ at all (measured: none).
- bf16 gradients, per input: mean|diff| <= 1e-4 * mean|JAX|, and for the
  bf16-typed ones (ef, h, x) at most 5% of the entries differ. Measured
  over 40 seeds: mean ratios <= 1.3e-5 and shares <= 0.7%; where a
  summation order flips one rounding upstream, single entries move by up
  to 9e-4 of max, which is why the bound is on the mean. Autograd through
  the forward's plain version misses the JAX backward's rounding points:
  mean ratios >= 1.4e-3 and 45-68% of the bf16 entries differ. It fails
  the bound for every input, which a test shows.

The Hopper kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops.egnn import egnn_init
from immunostruct_tpu.ops.pallas_edge import pack_params as jax_pack_params
from immunostruct_tpu.ops.pallas_mega import _mega_fwd_call, _tail_bwd_call
from immunostruct_tpu.ops.pallas_mega import edge_mega as jax_edge_mega
from immunostruct_tpu_torch.ops import mega
from immunostruct_tpu_torch.ops.egnn import EGNNLayer
from immunostruct_tpu_torch.utils.checkpoint import load_params

B, N, H = 3, 16, 16
BF16_GRAD_TOL = 1e-4          # mean|diff| / mean|JAX| per gradient, bf16
BF16_GRAD_SHARE = 0.05        # share of bf16-typed gradient entries differing
GRAD_NAMES = ("ef", "h", "x", "w1ab", "w2", "wc1", "small")


def _inputs(f, e, seed, mask_rate=0.2, n=N, b=B):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, (b, e)).astype(np.int32)
    dst = rng.integers(0, n, (b, e)).astype(np.int32)
    src[:, :6] = dst[:, :6]                                 # self-loops
    return dict(
        src=src, dst=dst,
        mask=rng.random((b, e)) >= mask_rate,
        ef=rng.standard_normal((b, e, 1)).astype(np.float32),
        h=rng.standard_normal((b, n, f)).astype(np.float32),
        x=rng.standard_normal((b, n, 3)).astype(np.float32),
    )


def _jax_layer(f, hid, seed):
    return egnn_init(jax.random.key(seed), f, hid, hid)


def _jax_args(a, p, dtype):
    return (jnp.asarray(a["src"]), jnp.asarray(a["dst"]),
            jnp.asarray(a["mask"]), jnp.asarray(a["ef"]).astype(dtype),
            jnp.asarray(a["h"]).astype(dtype),
            jnp.asarray(a["x"]).astype(dtype),
            *jax_pack_params(p["edge_mlp"], p["coord_mlp"]))


def _jax_out(a, p, dtype):
    out = jax_edge_mega(*_jax_args(a, p, dtype), True)
    return np.asarray(out.astype(jnp.float32))


def _f32(x):
    """numpy f32 of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_close(got, want, share=0.01) -> bool:
    """Each element within one bf16 step (the spacing at the larger of the
    two magnitudes) of ``want``, and at most ``share`` of them differ."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 0.0)
    return bool((np.abs(got - want) <= step).all()
                and (got != want).mean() <= share)


def _assert_bf16_close(got, want):
    assert _bf16_close(got, want), (np.abs(_f32(got) - _f32(want)).max(),
                                    (_f32(got) != _f32(want)).mean())


def _bf16_grad_close(g, w) -> bool:
    """The bf16 gradient bound (module docstring)."""
    share = (_f32(g) != _f32(w)).mean() if g.dtype == torch.bfloat16 else 0
    g, w = _f32(g), _f32(w)
    return bool(np.abs(g - w).mean() <= BF16_GRAD_TOL * np.abs(w).mean()
                and share <= BF16_GRAD_SHARE)


def _port_layer(p, f, hid):
    layer = EGNNLayer(f, hid, hid, generator=torch.Generator().manual_seed(0))
    flat = {}
    for group in ("edge_mlp", "node_mlp", "coord_mlp"):
        for i, lin in enumerate(p[group]):
            for k, v in lin.items():
                flat[f"{group}.{i}.{k}"] = np.asarray(v)
    return load_params(layer, flat, verbose=False)


def _port_args(a, layer, dtype, device="cpu"):
    def t(k, dt=None):
        v = torch.from_numpy(a[k]).to(device)
        return v if dt is None else v.to(dt)

    return (t("src"), t("dst"), t("mask"), t("ef", dtype), t("h", dtype),
            t("x", dtype),
            *(w.detach().to(device).contiguous()
              for w in mega.pack_params(layer.edge_mlp, layer.coord_mlp)))


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_mega_reference_matches_jax(f, dtype):
    a = _inputs(f, 128, seed=f)
    p = _jax_layer(f, H, seed=f)
    ref = _jax_out(a, p, jnp.dtype(dtype))
    layer = _port_layer(p, f, H)
    out = mega.edge_mega_reference(
        *_port_args(a, layer, getattr(torch, dtype))).numpy()
    assert out.shape == (B, N, H + 3) and out.dtype == np.float32
    assert np.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    else:
        # the model rounds the aggregate to the compute dtype, as the JAX
        # kernel does in its single-tile output (ops/egnn.py)
        _assert_bf16_close(torch.from_numpy(out).bfloat16(), ref)


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residuals_match_jax(f, dtype):
    """B1's a1/xd against _mega_fwd_call's, on the computed edges; zero on
    the skipped ones (the JAX kernel holds w1e*ef + b1 in a1 there)."""
    a = _inputs(f, 128, seed=f)
    p = _jax_layer(f, H, seed=f)
    _, a1_ref, xd_ref = _mega_fwd_call(*_jax_args(a, p, jnp.dtype(dtype)),
                                       True)
    args = _port_args(a, _port_layer(p, f, H), getattr(torch, dtype))
    _, a1, xd = mega.edge_mega_fwd_reference(*args)
    assert a1.dtype == xd.dtype == getattr(torch, dtype)
    assert a1.shape == (B, H, 128) and xd.shape == (B, 3, 128)
    valid = mega.valid_edges(*args[:3], N).numpy()[:, None, :]
    assert (~valid).any()
    for got, want in ((a1, a1_ref), (xd, xd_ref)):
        assert (_f32(got)[np.broadcast_to(~valid, got.shape)] == 0).all()
        got = np.where(valid, _f32(got), 0.0)
        want = np.where(valid, _f32(want), 0.0)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        else:
            _assert_bf16_close(got, want)


def _tail_inputs(f, seed, dtype):
    """B2's operands from the JAX forward, with a seeded cotangent."""
    a = _inputs(f, 128, seed=seed)
    p = _jax_layer(f, H, seed=seed)
    jargs = _jax_args(a, p, jnp.dtype(dtype))
    _, a1, xd = _mega_fwd_call(*jargs, True)
    d_both = np.random.default_rng(seed + 1).standard_normal(
        (B, H + 3, 128)).astype(np.float32)
    jax_in = (jargs[3], *jargs[7:], a1, xd,
              jnp.asarray(d_both).astype(jnp.dtype(dtype)))
    tdt = getattr(torch, dtype)
    port_in = (torch.from_numpy(a["ef"]).to(tdt),
               *_port_args(a, _port_layer(p, f, H), tdt)[7:],
               torch.from_numpy(_f32(a1)).to(tdt),
               torch.from_numpy(_f32(xd)).to(tdt),
               torch.from_numpy(d_both).to(tdt))
    return jax_in, port_in


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_bwd_reference_matches_jax(f, dtype):
    jax_in, port_in = _tail_inputs(f, f + 1, dtype)
    want = _tail_bwd_call(*jax_in, True)
    got = mega.tail_bwd_reference(*port_in)
    names = ("d_cat", "d_ef", "dw2", "dwc1", "dsmall")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        if dtype == "float32" or name.startswith("dw") or name == "dsmall":
            # f32 outputs: the weight gradients are f32 sums in both dtypes
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5,
                                       rtol=1e-4, err_msg=name)
        else:
            assert g.dtype == torch.bfloat16, name
            _assert_bf16_close(g, w)


def test_tail_bwd_reference_skips_invalid_edges():
    """An edge marked invalid gets d_cat = d_ef = 0 and adds nothing, even
    with NaN residuals and a nonzero cotangent: the same as a valid edge
    with d_both = 0 (the JAX contract)."""
    _, (ef, w2, wc1, small, a1, xd, d_both) = _tail_inputs(20, 5, "float32")
    valid = torch.ones(B, 128, dtype=torch.bool)
    valid[:, 100:] = False
    zeroed = d_both.clone()
    zeroed[:, :, 100:] = 0.0
    want = mega.tail_bwd_reference(ef, w2, wc1, small, a1, xd, zeroed)
    a1, xd = a1.clone(), xd.clone()
    a1[:, :, 100:] = float("nan")
    xd[:, :, 100:] = float("nan")
    got = mega.tail_bwd_reference(ef, w2, wc1, small, a1, xd, d_both, valid)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)
    assert torch.count_nonzero(got[0][:, :, 100:]) == 0


def _grads(fn, args, cot):
    """Gradients of sum(fn(...) * cot) for the differentiable inputs."""
    leaves = [t.detach().clone().requires_grad_(True) for t in args[3:]]
    (fn(*args[:3], *leaves) * cot).sum().backward()
    return [t.grad for t in leaves]


def _jax_grads(jargs, cot):
    def loss(*diff):
        out = jax_edge_mega(*jargs[:3], *diff, True)
        return jnp.sum(out.astype(jnp.float32) * cot)

    return jax.grad(loss, argnums=tuple(range(7)))(*jargs[3:])


@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_mega_gradients_match_jax(f, dtype):
    a = _inputs(f, 128, seed=f + 2)
    p = _jax_layer(f, H, seed=f + 2)
    cot = np.random.default_rng(f).standard_normal(
        (B, N, H + 3)).astype(np.float32)
    want = _jax_grads(_jax_args(a, p, jnp.dtype(dtype)), cot)
    args = _port_args(a, _port_layer(p, f, H), getattr(torch, dtype))
    got = _grads(mega.EdgeMega.apply, args, torch.from_numpy(cot))
    for name, g, w, t in zip(GRAD_NAMES, got, want, args[3:]):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5,
                                       rtol=1e-4, err_msg=name)
        else:
            assert _bf16_grad_close(g, w), name
    if dtype == "bfloat16":
        # autograd through the forward's plain version fails the bound
        plain = _grads(mega.edge_mega_reference, args, torch.from_numpy(cot))
        for name, g, w in zip(GRAD_NAMES, plain, want):
            assert not _bf16_grad_close(g, w), name


def test_edge_mega_gradients_ragged_edge_count():
    """E=100 (a ragged last 64-edge tile on the card) equals the JAX kernel
    at E=128 with the extra 28 edges padded out."""
    a = _inputs(20, 128, seed=8)
    a["mask"][:, 100:] = False
    p = _jax_layer(20, H, seed=8)
    cot = np.random.default_rng(8).standard_normal(
        (B, N, H + 3)).astype(np.float32)
    want = _jax_grads(_jax_args(a, p, jnp.float32), cot)
    cut = {k: (v[:, :100] if k in ("src", "dst", "mask", "ef") else v)
           for k, v in a.items()}
    args = _port_args(cut, _port_layer(p, 20, H), torch.float32)
    got = _grads(mega.EdgeMega.apply, args, torch.from_numpy(cot))
    want = list(want)
    want[0] = want[0][:, :100]
    for name, g, w in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_masked_batch_gives_zero_gradients(dtype):
    a = _inputs(20, 128, seed=4, mask_rate=1.0)
    args = _port_args(a, _port_layer(_jax_layer(20, H, seed=4), 20, H),
                      getattr(torch, dtype))
    cot = torch.randn(B, N, H + 3, generator=torch.Generator().manual_seed(0))
    for name, g in zip(GRAD_NAMES, _grads(mega.EdgeMega.apply, args, cot)):
        assert torch.count_nonzero(g) == 0, name


def test_edge_mega_is_differentiable_only_when_needed():
    """Under no_grad the op runs the forward without residuals; with an
    input that requires a gradient it is an EdgeMega node."""
    a = _inputs(20, 64, seed=6)
    args = _port_args(a, _port_layer(_jax_layer(20, H, seed=6), 20, H),
                      torch.float32)
    out = mega.edge_mega(*args)
    assert out.grad_fn is None
    leaf = args[4].clone().requires_grad_(True)
    out2 = mega.edge_mega(*args[:4], leaf, *args[5:])
    assert type(out2.grad_fn).__name__ == "EdgeMegaBackward"
    torch.testing.assert_close(out2.detach(), out, atol=0.0, rtol=0.0)


def test_edge_count_not_multiple_of_128():
    """E=100 in the port equals the JAX kernel at E=128 with the extra 28
    edges padded out (mask False): padding is exactly inert."""
    a = _inputs(20, 128, seed=7)
    a["mask"][:, 100:] = False
    p = _jax_layer(20, H, seed=7)
    ref = _jax_out(a, p, jnp.float32)
    cut = {k: (v[:, :100] if k in ("src", "dst", "mask", "ef") else v)
           for k, v in a.items()}
    layer = _port_layer(p, 20, H)
    out = mega.edge_mega_reference(*_port_args(cut, layer,
                                               torch.float32)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_masked_edges_and_out_of_range_indices_are_inert():
    a = _inputs(20, 64, seed=3, mask_rate=0.0)
    layer = _port_layer(_jax_layer(20, H, seed=3), 20, H)
    base = mega.edge_mega_reference(*_port_args(a, layer, torch.float32))
    # an extra masked edge with garbage indices changes nothing
    b = {k: v.copy() for k, v in a.items()}
    for k in ("src", "dst", "mask", "ef"):
        b[k] = np.concatenate([b[k], b[k][:, :2]], axis=1)
    b["src"][:, -2:] = N + 5
    b["dst"][:, -2:] = -1
    b["mask"][:, -2] = False
    out = mega.edge_mega_reference(*_port_args(b, layer, torch.float32))
    torch.testing.assert_close(out, base, atol=0.0, rtol=0.0)


def test_pack_params_matches_jax_layout():
    p = _jax_layer(20, H, seed=1)
    layer = _port_layer(p, 20, H)
    for got, want in zip(mega.pack_params(layer.edge_mlp, layer.coord_mlp),
                         jax_pack_params(p["edge_mlp"], p["coord_mlp"])):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_cpu_tensors_use_plain_version_without_launch():
    a = _inputs(20, 64, seed=2)
    layer = _port_layer(_jax_layer(20, H, seed=2), 20, H)
    args = _port_args(a, layer, torch.float32)
    before = mega.edge_mega.launches, mega.tail_bwd.launches
    out = mega.edge_mega(*args)
    _grads(mega.EdgeMega.apply, args, torch.ones_like(out))
    assert (mega.edge_mega.launches, mega.tail_bwd.launches) == before
    torch.testing.assert_close(out, mega.edge_mega_reference(*args))


def test_other_devices_raise():
    a = _inputs(20, 64, seed=2)
    layer = _port_layer(_jax_layer(20, H, seed=2), 20, H)
    args = [t.to("meta") for t in _port_args(a, layer, torch.float32)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        mega.edge_mega(*args)
    _, tail_in = _tail_inputs(20, 3, "float32")
    valid = torch.ones(B, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mega.tail_bwd(*[t.to("meta") for t in tail_in], valid.to("meta"))


@pytest.mark.parametrize("b,e,chunks", [
    (128, 2560, 1), (200, 2560, 1), (1, 2560, 20), (1, 100, 1),
    (16, 1408, 8), (26, 1280, 5), (66, 2560, 2), (3, 0, 1)])
def test_fwd_chunks(b, e, chunks):
    """B1's bf16 grid on a 132-SM card (one CTA an SM): one wave of CTAs,
    at least two 64-edge tiles a chunk where the graph has them."""
    got = mega.fwd_chunks(e, b, 132)
    assert got == chunks
    assert b * got <= max(132, b)
    assert 2 * got - 1 <= max(1, -(-e // 64))
