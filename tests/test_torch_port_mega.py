"""The PyTorch port's edge_mega (immunostruct_tpu_torch/ops/mega.py) against
the JAX package's mega kernel (ops/pallas_mega.py::edge_mega, run in
interpret mode as the JAX package's own tests run it on the CPU).

The same numpy inputs, made from a seed, go through both. Tolerances:
f32 within atol=1e-5, rtol=1e-4 (roundoff of a different summation order);
bf16 within max|diff| <= 2e-2 * max|ref| (the JAX kernel rounds its
single-tile aggregate to bf16, the port returns it in f32).

The Hopper kernel itself is held against this plain version on the card by
tests/test_torch_port_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immunostruct_tpu.ops.egnn import egnn_init
from immunostruct_tpu.ops.pallas_edge import pack_params as jax_pack_params
from immunostruct_tpu.ops.pallas_mega import edge_mega as jax_edge_mega
from immunostruct_tpu_torch.ops import mega
from immunostruct_tpu_torch.ops.egnn import EGNNLayer
from immunostruct_tpu_torch.utils.checkpoint import load_params

B, N, H = 3, 16, 16


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


def _jax_out(a, p, dtype):
    w1ab, w2, wc1, small = jax_pack_params(p["edge_mlp"], p["coord_mlp"])
    out = jax_edge_mega(jnp.asarray(a["src"]), jnp.asarray(a["dst"]),
                        jnp.asarray(a["mask"]), jnp.asarray(a["ef"]),
                        jnp.asarray(a["h"]).astype(dtype),
                        jnp.asarray(a["x"]).astype(dtype),
                        w1ab, w2, wc1, small, True)
    return np.asarray(out.astype(jnp.float32))


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
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


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
    before = mega.edge_mega.launches
    out = mega.edge_mega(*args)
    assert mega.edge_mega.launches == before
    torch.testing.assert_close(out, mega.edge_mega_reference(*args))


def test_other_devices_raise():
    a = _inputs(20, 64, seed=2)
    layer = _port_layer(_jax_layer(20, H, seed=2), 20, H)
    args = [t.to("meta") for t in _port_args(a, layer, torch.float32)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        mega.edge_mega(*args)
