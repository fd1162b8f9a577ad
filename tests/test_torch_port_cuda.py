"""The Hopper kernel behind ``edge_mega`` (immunostruct_tpu_torch/csrc/
egnn_mega_fwd.cu) against its plain PyTorch version, on the card.

This file imports no JAX, so it also runs on a GPU machine without JAX.
There ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

The tests marked ``cuda`` skip on a host without a CUDA device. Tolerances:
f32 (TF32 off) within atol=1e-5, rtol=1e-4, the roundoff of a different
summation order (the kernel sums with shared-memory atomics). bf16, per
output column over all graphs and nodes: max|diff| <= 4e-3 * max|plain| (one
bf16 step at the column's largest value) and mean|diff| <= 1e-4 *
mean|plain|. The kernel and the plain version round at the same points, so
they differ only where a summation order flips one rounding; a kernel that
leaves out any one rounding point fails the mean bound, which
``test_bf16_bound_sees_every_rounding_point`` checks by building such
kernels.
"""

import re

import pytest
import torch

from immunostruct_tpu_torch.data.synthetic import random_sample_batch
from immunostruct_tpu_torch.models import build_model, model_apply
from immunostruct_tpu_torch.ops import _build, mega
from immunostruct_tpu_torch.ops.egnn import EGNNLayer

N = 288


def _args(b, e, f, hid, dtype, device, seed, mask_rate=0.1):
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (b, e), generator=gen, dtype=torch.int32)
    src[:, :8] = dst[:, :8]                                  # self-loops
    mask = torch.rand(b, e, generator=gen) >= mask_rate
    ef = torch.randn(b, e, 1, generator=gen)
    h = torch.randn(b, N, f, generator=gen)
    x = torch.randn(b, N, 3, generator=gen)
    layer = EGNNLayer(f, hid, hid, generator=gen, device=device)
    weights = [w.detach().contiguous()
               for w in mega.pack_params(layer.edge_mlp, layer.coord_mlp)]
    return [src.to(device), dst.to(device), mask.to(device),
            ef.to(device, dtype), h.to(device, dtype), x.to(device, dtype),
            *weights]


def _assert_close(out, ref, dtype):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)
    else:
        diff = (out - ref).abs().flatten(0, 1)
        mag = ref.abs().flatten(0, 1)
        assert (diff.amax(0) <= 4e-3 * mag.amax(0)).all()
        assert (diff.mean(0) <= 1e-4 * mag.mean(0)).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_plain_version_on_cpu_is_finite():
    args = _args(2, 100, 20, 16, torch.float32, "cpu", seed=0)
    out = mega.edge_mega(*args)
    assert out.shape == (2, N, 19) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2560, 1408, 100])
@pytest.mark.parametrize("f", [20, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, e, f, dtype):
    args = _args(8, e, f, 64, dtype, cuda, seed=e + f)
    before = mega.edge_mega.launches
    out = mega.edge_mega(*args)
    torch.cuda.synchronize()
    assert mega.edge_mega.launches == before + 1
    _assert_close(out, mega.edge_mega_reference(*args), dtype)


# the kernel source with one bf16 rounding point left out: (pattern,
# replacement) pairs applied to csrc/egnn_mega_fwd.cu
_MUTANTS = {
    "weights": [(r"(w2s\[i\] = )rnd<T>\((w2\[i\])\)", r"\1\2"),
                (r"(wc1s\[i\] = )rnd<T>\((wc1\[i\])\)", r"\1\2"),
                (r"(w1s\[i\] = )rnd<T>\((w1ab\[i\])\)", r"\1\2")],
    "pa_pb": [(r"(pab\[i\] = )rnd<T>\((s)\)", r"\1\2")],
    "xd": [(r"rnd<T>\((to_f\(xb\[s \* 3 \+ \d\]\) - to_f\(xb\[d \* 3 \+ "
            r"\d\]\))\)", r"(\1)")],
    "radial": [(r"(r = )rnd<T>\((d0 \* d0 \+ d1 \* d1 \+ d2 \* d2)\)",
                r"\1\2")],
    "silu_a1": [(r"(v = )rnd<T>\((silu\(a1\))\)", r"\1\2")],
    "m": [(r"(mv = )rnd<T>\((silu\(r\[i\]\[c\] \+ sms\[3 \* H \+ j\]\))\)",
           r"\1\2")],
    "coord_hidden": [(r"(c1 = )rnd<T>\((silu\(r\[i\]\[c\] \+ "
                      r"sms\[4 \* H \+ j\]\))\)", r"\1\2")],
    "cw": [(r"(cwb = )rnd<T>\((part)\)", r"\1\2")],
    "cw_xhat": [(r"rnd<T>\((cwb \* xh\[t \* 3 \+ \d\])\)", r"(\1)")],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_MUTANTS))
def test_bf16_bound_sees_every_rounding_point(cuda, name, tmp_path,
                                              monkeypatch):
    text = (_build.CSRC / "egnn_mega_fwd.cu").read_text()
    for pattern, repl in _MUTANTS[name]:
        text, n = re.subn(pattern, repl, text)
        assert n >= 1, f"{name}: {pattern} matches nothing in the source"
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "egnn_mega_fwd.cu").write_text(text)
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        for e, f in ((2560, 20), (1408, 64)):
            args = _args(8, e, f, 64, torch.bfloat16, cuda, seed=e + f)
            out = mega.edge_mega(*args)
            with pytest.raises(AssertionError):
                _assert_close(out, mega.edge_mega_reference(*args),
                              torch.bfloat16)
    finally:
        _build.load_library.cache_clear()


@pytest.mark.cuda
def test_kernel_all_edges_masked_gives_zeros(cuda):
    args = _args(2, 256, 20, 64, torch.float32, cuda, seed=1, mask_rate=1.0)
    out = mega.edge_mega(*args)
    assert torch.count_nonzero(out) == 0


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = _args(2, 128, 20, 64, torch.float32, cuda, seed=2)
    half = list(args)
    half[4], half[5] = half[4].half(), half[5].half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mega.edge_mega(*half)
    strided = list(args)
    strided[4] = args[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        mega.edge_mega(*strided)
    for hid in (32, 48):
        narrow = _args(2, 128, 20, hid, torch.float32, cuda, seed=3)
        with pytest.raises(ValueError, match="H=64"):
            mega.edge_mega(*narrow)


@pytest.mark.cuda
def test_model_mega_matches_scatter_on_card(cuda):
    _, model = build_model("HybridModelv2", 20 * 21,
                           torch.Generator().manual_seed(0), device=cuda)
    b = random_sample_batch(16, N, 1408, 20, seed=1, device=cuda)
    eps = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    outs = {}
    for agg in ("mega", "scatter"):
        before = mega.edge_mega.launches
        with torch.inference_mode():
            outs[agg] = model_apply(model, b.graph, b.seq_onehot, b.props,
                                    deterministic=True, aggregation=agg,
                                    eps=eps.to(cuda))
        launched = mega.edge_mega.launches - before
        assert launched == (len(model.gcn) if agg == "mega" else 0)
    for name in ("logits", "embedding", "attention"):
        torch.testing.assert_close(getattr(outs["mega"], name),
                                   getattr(outs["scatter"], name),
                                   atol=1e-4, rtol=1e-3)
